"""Continuous-batching serve engine over the block-paged packed-F2P KV pool
(port of ``repro.serve.batched``, DESIGN.md §12, §14), for the families
of :mod:`repro_torch.serve.arch` (llama-dense, MoE, the mamba hybrid and
xLSTM).

The engine admits a dynamic set of requests into a fixed number of decode
**slots**; every step serves every live request at its own position.

* decode: one step over ``[slots]`` (per-slot token, position and request
  id vectors); retired slots keep stepping into a clamped dead position
  until a new request joins (their output is discarded host-side).
* prefill: prompts padded to a shape **bucket**; compatible queued prompts
  are grouped into ONE ``[N, bucket]`` call (N a power-of-two group size).
  A family's ``prefill_buckets`` (or no buckets at all) turns grouping off:
  each prompt is then prefilled alone, at its exact length with the family
  override (the reference's admission rule, kept because MoE routing sees
  every padded position).
* **paged decode** (default): prefill KV lands in
  :class:`~repro_torch.serve.paging.PagedKVPool` pages and the slot ADOPTS
  the page table; decode attends the pool slabs in place through a
  ``[slots, max_pages]`` table (``attention_paged``), so no dense
  ``[slots, max_seq]`` KV row exists. Pages are allocated lazily just ahead
  of the write position each round (the lazy table growth); page 0 is a
  reserved dump page that retired rows point at. Each round attends only
  the smallest power-of-two span bucket of the table covering every live
  slot. ``paged_decode=False`` keeps the copy-in engine (pages word-copied
  into a dense slot row and freed) as the bitwise comparator.
* admission is SLO-scored (queue-wait age normalised by min(SLO, the
  queue-wait histogram's p50) minus a projected-tail penalty) with the FIFO
  starvation bound as a hard floor; starvation preempts the longest-tail
  slot, whose KV is parked (evicted to host numpy by default) and readmitted
  later.
* ``kv_policy`` (a :class:`~repro_torch.autotune.FormatPolicy`) picks the
  F2P format of each attention position's KV pages, copy-in and prefill
  caches through its ``kv/b<i>`` rule (``models.kv_format``); host
  eviction and readmission move the words of those formats unchanged.
* The engine is family-blind apart from ``arch_for(cfg)``'s flags. With
  MoE FFs (``exact_cobatch=False``) every co-scheduled token, a bucket's
  padding and an idle slot's dead-position step included, competes for
  expert capacity, so tokens depend on the co-scheduled set, as in the
  reference.
* **Recurrent state** (``recurrent_state``: mamba, mLSTM, sLSTM): each
  slot owns a row of every recurrent cache leaf ``[G, slots, ...]``
  beside the KV. A prompt is prefilled alone, at its exact length, from a
  fresh zero-state cache every time (a prefill starts from its cache's
  state, so a reused one would carry the last request's state into the
  next), and its final state is copied into the slot's row. Parking a
  slot copies its rows to host memory (``[G, 1, ...]`` CPU tensors:
  numpy has no bf16) and readmission writes them back, host eviction or
  not. A family without attention (xLSTM) has no pool: its caches hold
  only the recurrent rows.

The reference jits one round (``sync_every`` steps under ``lax.scan``);
here a round is a loop of ``sync_every`` eager steps followed by ONE host
sync of the ``[slots, sync_every]`` token chunk. Host mirrors of the per-
slot inputs are uploaded as deltas: only slots whose bookkeeping changed
overwrite the device vectors.

Observability is the reference's (DESIGN.md §13): an engine-owned
``obs.MetricsRegistry("serve.batched")`` holds the step / round / slot /
token / event counters and the ``ttft_ms``, ``tbt_ms`` and
``queue_wait_ms`` histograms (bucketed on the host); ``stats`` is a view
over the registry's exact shadows. The trace sites (``obs.span``,
``obs.instant``, ``obs.counter_event`` and per-request rows at retirement)
are no-ops unless ``obs.enable()``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import init_caches
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serve.arch import SupportedArchitecture, arch_for
from repro_torch.serve.paging import HostKV, PagedKVPool, PageTable

__all__ = ["BatchedServeConfig", "BatchedEngine", "Request"]


@dataclasses.dataclass(frozen=True)
class BatchedServeConfig:
    slots: int                    # decode lanes (the fixed device batch)
    max_seq: int                  # per-slot cache length (multiple of page)
    eos: int = -1                 # per-request EOS (chunk-synced)
    temperature: float = 0.0      # 0 = greedy
    seed: int = 0                 # sampling stream root
    kv_policy: Any = None         # per-layer KV formats (FormatPolicy|None)
    page_tokens: int | None = None     # None = family default
    n_pages: int | None = None         # None = mode-dependent default
    prefill_buckets: tuple[int, ...] | None = None  # None = family default
    sync_every: int = 8           # decode steps per host sync
    preempt_patience: int = 2     # sync rounds a ready request starves
    evict_parked_to_host: bool = True  # parked KV goes to host numpy
    paged_decode: bool | None = None   # attend page tables in place
    io_upload: str = "delta"      # "delta" | "full" boundary mirror upload
    scheduler: str = "slo"        # "slo" | "fifo" admission ordering
    slo_ttft_ms: float = 1000.0   # admission score: target queue-wait norm
    sched_tail_weight: float = 0.25    # projected-tail penalty weight
    prefill_group: int = 4        # max prompts fused per prefill call
    defrag_every: int = 0         # compact the pool every N rounds (0=never)


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray            # prompt [L]
    max_new: int
    arrival: int = 0              # global decode-step index of visibility


@dataclasses.dataclass
class _Slot:
    uid: int
    prompt_len: int
    max_new: int
    tokens: list[int]


@dataclasses.dataclass
class _Parked:
    uid: int
    prompt_len: int
    max_new: int
    tokens: list[int]
    pos: int                      # next decode write position
    last_tok: int
    table: PageTable | None = None
    host: HostKV | None = None
    state: dict | None = None     # recurrent rows on the host, [G, 1, ...]


class BatchedEngine:
    """Continuous-batching engine; see module docstring. ``run(requests)``
    returns {uid: np.int32 tokens} and fills ``self.stats``. Runs on the
    model's device."""

    def __init__(self, cfg: ModelConfig, bscfg: BatchedServeConfig,
                 model: Model):
        self.arch: SupportedArchitecture = arch_for(cfg)
        if not cfg.fused_attention:
            cfg = dataclasses.replace(cfg, fused_attention=True)
        self.cfg, self.bscfg, self.model = cfg, bscfg, model
        self.device = dev = model.device
        B, S = bscfg.slots, bscfg.max_seq
        T = bscfg.page_tokens or self.arch.page_tokens
        if S % T:
            raise ValueError(f"max_seq {S} not a multiple of page_tokens {T}")
        self.page_tokens = T
        self.paged = self.arch.paged_kv and (
            bscfg.paged_decode is None or bool(bscfg.paged_decode))
        self._dump = 0
        self._tables: list[PageTable | None] = [None] * B
        maxp = S // T
        self.pool = None
        if self.arch.paged_kv:
            n_pages = bscfg.n_pages
            if n_pages is None:
                # paged: the pool is the only KV home — every slot full
                # length, one staging admission, plus the dump page;
                # copy-in: every slot plus one transit request
                n_pages = (B + 1) * maxp + 1 if self.paged \
                    else B * maxp + maxp
            self.pool = PagedKVPool(cfg, T, n_pages,
                                    kv_policy=bscfg.kv_policy, device=dev)
            if self.paged:
                (self._dump,) = self.pool.alloc(1)
        # the slots' caches: the pool slabs (paged) or dense rows at the
        # attention positions, beside every recurrent position's rows
        self.caches = init_caches(cfg, B, S, quantized_kv=True,
                                  kv_policy=bscfg.kv_policy,
                                  attn_kv=not self.paged, device=dev)
        if self.paged:
            self.caches.update(self.pool.slabs)
        self._recurrent = [f"b{i}" for i in cfg.recurrent_positions]
        self.tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.req = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._tok_h = np.zeros((B,), np.int64)
        self._pos_h = np.zeros((B,), np.int64)
        self._req_h = np.zeros((B,), np.int64)
        self._pages_h = np.full((B, maxp), self._dump, np.int32)
        self._dirty = np.zeros((B,), bool)
        self._pages_dirty = np.zeros((B,), bool)
        self.pages = (torch.as_tensor(self._pages_h, device=dev)
                      if self.paged else None)
        bk, b = [], 2
        while b < maxp:
            bk.append(b)
            b *= 2
        self._span_buckets = tuple(bk) + (maxp,)
        self.slots: list[_Slot | None] = [None] * B
        self._step = self.arch.step_factory(cfg, temperature=bscfg.temperature,
                                            seed=bscfg.seed, max_seq=S)
        self._prefill = self.arch.prefill_factory(cfg)
        self._pf_caches: dict[tuple[int, int], Any] = {}
        if bscfg.prefill_buckets is not None:
            self.buckets = tuple(bscfg.prefill_buckets)
        elif self.arch.prefill_buckets is not None:
            self.buckets = tuple(self.arch.prefill_buckets)
        else:
            self.buckets = tuple(b for b in (2 * T, 4 * T, 8 * T, 16 * T)
                                 if b <= S)
        gs, g = [], 1
        while g < max(1, bscfg.prefill_group):
            gs.append(g)
            g *= 2
        self._group_sizes = tuple(gs) + (max(1, bscfg.prefill_group),)
        self._parked: deque[_Parked] = deque()
        self._sched_skips: dict[int, int] = {}
        # the engine-owned registry (always on: counters buffer host
        # floats, the histograms bucket on the host, the F2P fold runs at
        # sync / export); tracing is the global opt-in obs.enable()
        self.metrics = obs.MetricsRegistry("serve.batched", seed=bscfg.seed)
        m = self.metrics
        self._c_prefills = m.counter("prefills")
        self._c_prefill_calls = m.counter("prefill_calls")
        self._c_readmits = m.counter("readmits")
        self._c_preempt = m.counter("preemptions")
        self._c_evict = m.counter("host_evictions")
        self._c_rounds = m.counter("rounds")
        self._c_prod = m.counter("productive_slot_steps")
        self._c_emitted = m.counter("emitted_tokens")
        self._g_steps = m.gauge("steps")
        self._g_occ = m.gauge("slot_occupancy")
        self._g_active = m.gauge("slots_active")
        self._h_ttft = m.histogram("ttft_ms", 1e-2, 1e6)
        self._h_tbt = m.histogram("tbt_ms", 1e-3, 1e5)
        self._h_queue = m.histogram("queue_wait_ms", 1e-3, 1e6)
        # per-request wall-clock samples (perf_counter_ns) keyed by uid:
        # visible (first admissible), first_tok
        self._rt: dict[int, dict[str, int]] = {}

    # -- stats ---------------------------------------------------------------
    @property
    def stats(self) -> dict[str, Any]:
        """The reference's stats dict, a view over the registry's exact
        shadows: event keys (prefills, readmits, ...) appear only once
        nonzero; counts are exact ints, never F2P estimates."""
        d: dict[str, Any] = {
            "steps": int(self._g_steps.value),
            "rounds": self._c_rounds.exact,
            "productive_slot_steps": self._c_prod.exact,
            "emitted_tokens": self._c_emitted.exact,
            "slot_occupancy": self._g_occ.value,
        }
        for key, c in (("prefills", self._c_prefills),
                       ("prefill_calls", self._c_prefill_calls),
                       ("readmits", self._c_readmits),
                       ("preemptions", self._c_preempt),
                       ("host_evictions", self._c_evict)):
            if c.exact:
                d[key] = c.exact
        if self.pool is not None:
            d["pool"] = self.pool.stats()
            d["reserved_pages"] = 1 if self.paged else 0
        return d

    def state_bytes_per_slot(self) -> int:
        """Bytes of one slot's recurrent state (every recurrent leaf's
        row, all groups)."""
        return sum(leaf[:, 0].nbytes for key in self._recurrent
                   for leaf in self.caches[key].values())

    # -- admission ---------------------------------------------------------
    def _bucket_for(self, L: int) -> int:
        for b in self.buckets:
            if L <= b:
                return b
        return -(-L // self.page_tokens) * self.page_tokens

    def _group_size(self, n: int) -> int:
        for g in self._group_sizes:
            if n <= g:
                return g
        return self._group_sizes[-1]

    def _pf_template(self, N: int, S_pf: int):
        """Prefill caches per (N, bucket), reused: a prefill call writes
        every position of every row, so no stale KV survives. A recurrent
        family gets fresh zero-state caches every time: its prefill starts
        from the cache's state, which the last prefill left behind."""
        caches = self._pf_caches.get((N, S_pf))
        if caches is None:
            caches = init_caches(self.cfg, N, S_pf, quantized_kv=True,
                                 kv_policy=self.bscfg.kv_policy,
                                 device=self.device)
            if not self.arch.recurrent_state:
                self._pf_caches[(N, S_pf)] = caches
        return caches

    def _exact_prefill(self) -> bool:
        """Prompts go in at their exact length (no bucket padding): no
        buckets, or the family's own override, as the reference."""
        return not self.buckets or self.arch.prefill_buckets is not None

    def _run_prefill(self, prompts: list[np.ndarray], N: int, bucket: int):
        """One ``[N, bucket]`` prefill (rows past the prompts zero). An
        exact-length prefill passes the prompt's own length as ``bucket``
        and gets a cache of whole pages."""
        toks = np.zeros((N, bucket), np.int64)
        last = np.zeros((N,), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
            last[i] = len(p) - 1
        T = self.page_tokens
        caches = self._pf_template(N, -(-bucket // T) * T)
        logits = self._prefill(self.model,
                               torch.as_tensor(toks, device=self.device),
                               caches, torch.as_tensor(last,
                                                       device=self.device))
        self._c_prefill_calls.inc()
        tok0 = torch.argmax(logits, -1).cpu().numpy()
        return tok0[:len(prompts)], caches

    def _copy_recurrent(self, src: dict, slot: int, row: int = 0):
        """Slot ``slot``'s recurrent rows <- row ``row`` of ``src`` (a
        prefill cache, or a parked request's host rows), in place."""
        for key in self._recurrent:
            for name, leaf in self.caches[key].items():
                leaf[:, slot].copy_(src[key][name][:, row])

    def _set_slot_io(self, slot: int, tok0: int, pos: int, uid: int):
        self._tok_h[slot] = tok0
        self._pos_h[slot] = pos
        self._req_h[slot] = uid
        self._dirty[slot] = True

    def _adopt_table(self, slot: int, table: PageTable):
        """Paged admission: the slot takes ownership of the page table — a
        host-side pointer update, no KV copy."""
        self._tables[slot] = table
        row = self._pages_h[slot]
        row[:] = self._dump
        row[:len(table.pages)] = table.pages
        self._pages_dirty[slot] = True

    def _release_slot(self, slot: int):
        """Retire a paged slot: free its pages, point its table row at the
        dump page so the clamped dead-position writes land in garbage."""
        t = self._tables[slot]
        if t is not None:
            self.pool.free(t.pages)
            self._tables[slot] = None
        self._pages_h[slot] = self._dump
        self._pages_dirty[slot] = True

    def _check_fits(self, r: Request):
        if len(r.tokens) + r.max_new > self.bscfg.max_seq:
            raise ValueError(
                f"request {r.uid}: prompt {len(r.tokens)} + max_new "
                f"{r.max_new} exceeds max_seq {self.bscfg.max_seq}")

    def _place(self, r: Request, slot: int, first: int, L: int,
               table: PageTable, results: dict):
        """Admission tail: bind the KV (adopt or copy in) and register the
        slot, or retire at once when the first token finishes it."""
        rt = self._rt[r.uid]
        t1 = time.perf_counter_ns()
        rt["first_tok"] = t1
        self._h_ttft.observe((t1 - rt["visible"]) / 1e6)
        self._set_slot_io(slot, first, L, r.uid)
        self._c_prefills.inc()
        if r.max_new == 1 or (self.bscfg.eos >= 0
                              and first == self.bscfg.eos):
            results[r.uid] = np.asarray([first], np.int32)
            if table is not None:
                self.pool.free(table.pages)
            self._retire(r.uid, 1)
            return
        if self.paged:
            self._adopt_table(slot, table)
        elif table is not None:
            self.pool.load_into_slot(table, self.caches, slot)
            self.pool.free(table.pages)
        self.slots[slot] = _Slot(uid=r.uid, prompt_len=L, max_new=r.max_new,
                                 tokens=[first])

    def _note_admission(self, r: Request):
        t0 = time.perf_counter_ns()
        rt = self._rt.setdefault(r.uid, {"visible": t0})
        self._h_queue.observe((t0 - rt["visible"]) / 1e6)

    def _admit_batch(self, pairs: list[tuple[Request, int]], results: dict):
        """Admit requests into slots, fusing compatible prompts into
        bucketed batch-N prefill calls."""
        for r, _ in pairs:
            self._check_fits(r)
        chunks: list[tuple[list[tuple[Request, int]], int]] = []
        if self.bscfg.prefill_group <= 1 or self._exact_prefill():
            # one prefill per request, in admission order
            exact = self._exact_prefill()
            chunks = [([(r, s)], len(r.tokens) if exact else
                       self._bucket_for(len(r.tokens))) for r, s in pairs]
        else:
            by_bucket: dict[int, list[tuple[Request, int]]] = {}
            for r, s in pairs:
                by_bucket.setdefault(self._bucket_for(len(r.tokens)),
                                     []).append((r, s))
            cap = max(1, self.bscfg.prefill_group)
            for bucket in sorted(by_bucket):
                grp = by_bucket[bucket]
                while grp:
                    chunks.append((grp[:cap], bucket))
                    grp = grp[cap:]
        for chunk, bucket in chunks:
            for r, s in chunk:
                self._note_admission(r)
                obs.instant("admit", uid=r.uid, slot=s)
            prompts = [np.asarray(r.tokens) for r, _ in chunk]
            # the reference's trace names: a batch-1 "prefill" span, a
            # "prefill_group" span for a fused group
            span = (obs.span("prefill", uid=chunk[0][0].uid,
                             L=len(prompts[0])) if len(chunk) == 1 else
                    obs.span("prefill_group", n=len(chunk),
                             bucket=bucket))
            with span:
                tok0, pf = self._run_prefill(prompts, self._group_size(
                    len(chunk)), bucket)
                for i, (r, s) in enumerate(chunk):
                    L = len(prompts[i])
                    table = (None if self.pool is None else
                             self.pool.store_prefill(pf, L, row=i))
                    self._copy_recurrent(pf, s, row=i)
                    self._place(r, s, int(tok0[i]), L, table, results)

    def _retire(self, uid: int, n_tokens: int):
        """Fold a finished request's timing into the histograms and, when
        tracing is armed, emit its trace row: a ``ttft`` span from first
        visibility to the prefill token and a ``decode`` span from first
        token to retirement carrying the mean TBT."""
        rt = self._rt.pop(uid, None)
        self._sched_skips.pop(uid, None)
        if rt is None:
            return
        now = time.perf_counter_ns()
        ft = rt.get("first_tok", now)
        tbt_ms = ((now - ft) / 1e6) / (n_tokens - 1) if n_tokens > 1 else 0.0
        if n_tokens > 1:
            self._h_tbt.observe(tbt_ms)
        s = obs.get()
        if s is None or s.tracer is None:
            return
        tr = s.tracer
        tid = uid + 1                       # row per request; engine row = 0
        tr.thread_name(tid, f"req {uid}")
        tr.complete("ttft", tr.ts_of(rt["visible"]),
                    (ft - rt["visible"]) / 1e3, tid=tid, uid=uid)
        tr.complete("decode", tr.ts_of(ft), (now - ft) / 1e3, tid=tid,
                    uid=uid, tokens=n_tokens, tbt_ms=round(tbt_ms, 4))
        tr.instant("retire", uid=uid)

    def _readmit(self, p: _Parked, slot: int):
        if self.pool is not None:
            table = p.table if p.table is not None \
                else self.pool.restore_from_host(p.host)
            if self.paged:
                self._adopt_table(slot, table)
            else:
                self.pool.load_into_slot(table, self.caches, slot)
                self.pool.free(table.pages)
        if p.state is not None:
            self._copy_recurrent(p.state, slot)
        self._set_slot_io(slot, int(p.last_tok), p.pos, p.uid)
        self.slots[slot] = _Slot(uid=p.uid, prompt_len=p.prompt_len,
                                 max_new=p.max_new, tokens=p.tokens)
        self._c_readmits.inc()
        obs.instant("readmit", uid=p.uid, slot=slot, pos=p.pos)

    # -- preemption --------------------------------------------------------
    def _park_slot(self, slot: int) -> _Parked:
        st = self.slots[slot]
        pos = st.prompt_len + len(st.tokens) - 1   # next write position
        parked = _Parked(uid=st.uid, prompt_len=st.prompt_len,
                         max_new=st.max_new, tokens=st.tokens, pos=pos,
                         last_tok=st.tokens[-1])
        if self.paged:
            # the live pages ARE the request's KV: hand the table over,
            # trimming look-ahead growth pages beyond the live length
            table = self._tables[slot]
            self._tables[slot] = None
            self.pool.trim(table, pos)
            parked.table = table
            self._pages_h[slot] = self._dump
            self._pages_dirty[slot] = True
        elif self.pool is not None:
            parked.table = self.pool.store_from_slot(self.caches, slot, pos)
        if self.pool is not None and self.bscfg.evict_parked_to_host:
            parked.host = self.pool.evict_to_host(parked.table)
            parked.table = None
            self._c_evict.inc()
            obs.instant("evict", uid=st.uid, slot=slot)
        if self._recurrent:
            parked.state = {key: {name: leaf[:, slot:slot + 1].to(
                "cpu", copy=True) for name, leaf in self.caches[key].items()}
                for key in self._recurrent}
        self.slots[slot] = None
        self._c_preempt.inc()
        obs.instant("preempt", uid=st.uid, slot=slot, pos=pos)
        return parked

    def preempt(self, uid: int) -> _Parked:
        """Forcibly park the slot serving ``uid`` (test/chaos hook)."""
        for s, st in enumerate(self.slots):
            if st is not None and st.uid == uid:
                p = self._park_slot(s)
                self._parked.append(p)
                return p
        raise KeyError(f"request {uid} not active")

    # -- pool maintenance (paged) ------------------------------------------
    def _grow_tables(self) -> int:
        """Lazy page growth: extend every live table to cover the positions
        this round writes (pos .. pos+sync_every-1, clamped like the
        device). Returns the max page count any live slot needs — the
        round's attended span."""
        S, T = self.bscfg.max_seq, self.page_tokens
        maxp = S // T
        need_max = 1
        for s, st in enumerate(self.slots):
            if st is None:
                continue
            pos = st.prompt_len + len(st.tokens) - 1
            end = min(pos + self.bscfg.sync_every - 1, S - 1)
            need = min(end // T + 1, maxp)
            need_max = max(need_max, need)
            t = self._tables[s]
            if need > len(t.pages):
                have = len(t.pages)
                new = self.pool.extend(t, need - have)
                self._pages_h[s, have:need] = new
                self._pages_dirty[s] = True
        return need_max

    def relocate_slot(self, slot: int):
        """Move a live slot's pages to fresh pool pages mid-decode."""
        if not self.paged or self._tables[slot] is None:
            return
        t = self.pool.relocate(self._tables[slot])
        self._tables[slot] = t
        self._pages_h[slot, :len(t.pages)] = t.pages
        self._pages_dirty[slot] = True

    def compact_pool(self):
        """Defragment the pool under every live owner: the dump page first
        (pinning it at page 0), then live slot tables, then parked ones."""
        if not self.paged:
            return
        dump_t = PageTable(pages=[self._dump], length=0)
        live = [(s, t) for s, t in enumerate(self._tables) if t is not None]
        tables = [dump_t] + [t for _, t in live] \
            + [p.table for p in self._parked if p.table is not None]
        self.pool.compact(tables)
        self._dump = dump_t.pages[0]
        for s, t in live:
            self._pages_h[s, :len(t.pages)] = t.pages
            self._pages_h[s, len(t.pages):] = self._dump
        for s in range(self.bscfg.slots):
            if self._tables[s] is None:
                self._pages_h[s] = self._dump
        self._pages_dirty[:] = True

    # -- the run loop ------------------------------------------------------
    def _n_active(self) -> int:
        return sum(st is not None for st in self.slots)

    def _free_slots(self):
        return [s for s, st in enumerate(self.slots) if st is None]

    def _upload_io(self):
        io, pg = self._dirty, self._pages_dirty
        pg_any = self.paged and pg.any()
        if not (io.any() or pg_any):
            return
        dev = self.device

        def up(x):
            return torch.as_tensor(x, device=dev)

        if self.bscfg.io_upload == "full":
            self.tok = up(self._tok_h[:, None])
            self.pos = up(self._pos_h)
            self.req = up(self._req_h)
            if self.paged:
                self.pages = up(self._pages_h)
        else:
            # only dirty rows overwrite the device vectors
            if io.any():
                m = up(io)
                self.tok = torch.where(m[:, None], up(self._tok_h)[:, None],
                                       self.tok)
                self.pos = torch.where(m, up(self._pos_h), self.pos)
                self.req = torch.where(m, up(self._req_h), self.req)
            if pg_any:
                self.pages = torch.where(up(pg)[:, None], up(self._pages_h),
                                         self.pages)
        io[:] = False
        pg[:] = False

    @torch.inference_mode()
    def _rounds(self) -> np.ndarray:
        """``sync_every`` decode steps; ONE ``[slots, sync_every]`` sync."""
        need = self._grow_tables() if self.paged else 0
        self._upload_io()
        pages = self.pages
        if self.paged:
            # attend only the live span: slice the page TABLE to the
            # smallest bucket covering every live slot
            span = next((b for b in self._span_buckets if b >= need),
                        self._span_buckets[-1])
            if span < pages.shape[1]:
                pages = pages[:, :span].contiguous()
        sync = self.bscfg.sync_every
        toks = torch.empty((self.bscfg.slots, sync), dtype=torch.int64,
                           device=self.device)
        tok, pos = self.tok, self.pos
        for k in range(sync):
            tok, pos = self._step(self.model, self.caches, tok, pos,
                                  self.req, pages)
            toks[:, k] = tok[:, 0]
        self.tok, self.pos = tok, pos
        chunk = toks.cpu().numpy()
        # keep the mirrors in lockstep with the device clamp
        self._tok_h[:] = chunk[:, -1]
        np.minimum(self._pos_h + sync, self.bscfg.max_seq - 1,
                   out=self._pos_h)
        return chunk

    def _harvest(self, chunk: np.ndarray, results: dict):
        for s, st in enumerate(self.slots):
            if st is None:
                continue
            for k in range(chunk.shape[1]):
                t = int(chunk[s, k])
                st.tokens.append(t)
                done = len(st.tokens) >= st.max_new or \
                    (self.bscfg.eos >= 0 and t == self.bscfg.eos)
                if done:
                    results[st.uid] = np.asarray(st.tokens[:st.max_new],
                                                 np.int32)
                    self.slots[s] = None
                    if self.paged:
                        self._release_slot(s)
                    self._retire(st.uid, len(results[st.uid]))
                    break

    def _select_admissions(self, pending: list[Request], step_no: int,
                           k: int) -> list[Request]:
        """Pick up to ``k`` admissible requests: FIFO, or (``"slo"``) by
        queue-wait age normalised by min(slo_ttft_ms, the p50 of the
        queue-wait histogram, log-linear inside its bucket) minus a
        projected-tail penalty; a request passed over ``preempt_patience``
        times scores +inf (the starvation floor)."""
        adm = [r for r in pending if r.arrival <= step_no]
        if not adm or k <= 0:
            return []
        if self.bscfg.scheduler == "fifo" or len(adm) <= k:
            chosen = adm[:k]
        else:
            now = time.perf_counter_ns()
            slo = max(float(self.bscfg.slo_ttft_ms), 1e-3)
            q50 = float(self._h_queue.quantile(0.5, exact=True))
            norm = min(slo, q50) if np.isfinite(q50) and q50 > 0 else slo
            floor = max(1, self.bscfg.preempt_patience)

            def score(r: Request) -> float:
                if self._sched_skips.get(r.uid, 0) >= floor:
                    return float("inf")
                vis = self._rt.get(r.uid, {}).get("visible", now)
                return ((now - vis) / 1e6 / norm - self.bscfg.sched_tail_weight
                        * r.max_new / self.bscfg.max_seq)

            chosen = sorted(adm, key=lambda r: (-score(r), r.arrival,
                                                r.uid))[:k]
        taken = {r.uid for r in chosen}
        for r in adm:
            if r.uid not in taken:
                self._sched_skips[r.uid] = self._sched_skips.get(r.uid, 0) + 1
        pending[:] = [r for r in pending if r.uid not in taken]
        return chosen

    def run(self, requests: list[Request]) -> dict[int, np.ndarray]:
        self.metrics.reset()
        self._rt = {}
        self._sched_skips = {}
        pending = sorted(requests, key=lambda r: (r.arrival, r.uid))
        self._parked = deque()
        parked = self._parked
        results: dict[int, np.ndarray] = {}
        step_no = 0
        starve_rounds = 0
        tracing = obs.get() is not None and obs.get().tracer is not None
        if tracing:
            obs.get().tracer.thread_name(0, "engine")
        while pending or parked or self._n_active():
            now = time.perf_counter_ns()
            for r in pending:
                if r.arrival > step_no:
                    break
                self._rt.setdefault(r.uid, {"visible": now})
            # admit: parked first (they hold evicted state), then arrivals
            new_slots = []
            for s in self._free_slots():
                if parked:
                    self._readmit(parked.popleft(), s)
                else:
                    new_slots.append(s)
            if new_slots and pending:
                chosen = self._select_admissions(pending, step_no,
                                                 len(new_slots))
                if chosen:
                    self._admit_batch(list(zip(chosen, new_slots)), results)
            if not self._n_active():
                if pending:     # idle: fast-forward to the next arrival
                    step_no = max(step_no, pending[0].arrival)
                    continue
                break
            with obs.span("round", step=step_no):
                chunk = self._rounds()
            n_act = self._n_active()
            step_no += self.bscfg.sync_every
            self._g_steps.set(step_no)
            self._g_active.set(n_act)
            self._c_rounds.inc()
            self._c_prod.inc(n_act * self.bscfg.sync_every)
            if tracing:
                series = {"active": n_act}
                if self.pool is not None:
                    series["pool_used"] = self.pool.stats()["used"]
                obs.counter_event("slots", **series)
            before = len(results)
            self._harvest(chunk, results)
            if self.bscfg.defrag_every and \
                    self._c_rounds.exact % self.bscfg.defrag_every == 0:
                self.compact_pool()
            # starvation -> preempt the longest-remaining-tail slot
            waiting = (any(r.arrival <= step_no for r in pending)
                       and not self._free_slots())
            retired = len(results) > before
            starve_rounds = starve_rounds + 1 if (waiting and not retired) \
                else 0
            if waiting and starve_rounds >= self.bscfg.preempt_patience:
                victim = max(
                    (s for s, st in enumerate(self.slots) if st is not None),
                    key=lambda s: self.slots[s].max_new
                    - len(self.slots[s].tokens))
                parked.append(self._park_slot(victim))
                chosen = self._select_admissions(pending, step_no, 1)
                if chosen:
                    self._admit_batch([(chosen[0], victim)], results)
                starve_rounds = 0
        for s, st in enumerate(self.slots):
            if st is not None:
                results[st.uid] = np.asarray(st.tokens[:st.max_new], np.int32)
                if self.paged:
                    self._release_slot(s)
                self._retire(st.uid, len(results[st.uid]))
        self.slots = [None] * self.bscfg.slots
        self._c_emitted.inc(sum(len(v) for v in results.values()))
        denom = self.bscfg.slots * self._c_rounds.exact \
            * self.bscfg.sync_every
        self._g_occ.set(self._c_prod.exact / denom if denom else 0.0)
        return results
