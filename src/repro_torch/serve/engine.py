"""Sequential serving engine and the sketch ingest front end (port of
``repro.serve.engine``: ``ServeConfig``, the step factories
``make_prefill_step`` / ``make_serve_step``, ``Engine.generate`` with the
periodic EOS sync, and ``SketchIngestEngine``).

One fixed-shape request batch runs start to finish: prefill the prompts,
then decode until ``max_new`` or EOS. Tokens stay on the device and reach
the host once at the end; with EOS on, the all-done flag is read only every
``eos_sync_every`` steps. The reference donates the cache buffers to its
jitted steps; here the caches are written in place (the steps still
return them, so a caller of the reference's API runs unchanged). A
recurrent family's caches (mamba, mLSTM, sLSTM state) start at zero for
every ``generate``; padded rows get zero prompts, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import decode_step, init_caches, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serve.arch import sample_tokens
from repro_torch.telemetry import HeavyHitterTable


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int
    max_seq: int
    quantized_kv: bool = False
    temperature: float = 0.0   # 0 = greedy
    seed: int = 0              # sampling stream root
    # per-layer KV formats (repro_torch.autotune.FormatPolicy | None);
    # None keeps attention.KV_FMT everywhere
    kv_policy: Any = None
    # decode attends the packed KV with the fused kernel (else the whole
    # cache is dequantized each step and attended by naive attention)
    fused_attention: bool = False
    eos_sync_every: int = 8    # EOS mode: steps between host syncs


def _serve_model_cfg(cfg: ModelConfig, scfg: ServeConfig) -> ModelConfig:
    """Serve-time model-config overrides: ServeConfig knobs that change how
    the steps run against the same weights and caches."""
    if scfg.fused_attention and not cfg.fused_attention:
        cfg = dataclasses.replace(cfg, fused_attention=True)
    return cfg


def make_prefill_step(cfg: ModelConfig, scfg: ServeConfig):
    """prefill_step(model, batch, caches) -> (last-token logits [B, V],
    caches). ``batch`` holds ``"tokens"`` ``[B, S]`` (and ``"frames"`` /
    ``"patches"`` for the frontend archs); the caches are written in place
    and returned."""
    cfg = _serve_model_cfg(cfg, scfg)

    @torch.inference_mode()
    def prefill_step(model: Model, batch, caches):
        tokens = batch["tokens"]
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.to(model.device, torch.int64)
        else:   # a copy: numpy arrays may be read-only
            tokens = torch.tensor(np.asarray(tokens), dtype=torch.int64,
                                  device=model.device)
        logits = prefill(model, tokens, caches, cfg=cfg,
                         frames=batch.get("frames"),
                         patches=batch.get("patches"))
        return logits, caches

    return prefill_step


def make_serve_step(cfg: ModelConfig, scfg: ServeConfig):
    """serve_step(model, caches, token [B, 1], pos, req_ids=None)
    -> (next_token [B, 1], caches).

    Greedy decoding is an argmax; with ``temperature > 0`` each row samples
    through :func:`~repro_torch.serve.arch.sample_tokens`, whose draws are
    a pure function of (seed, request id, position): which requests share
    the batch never perturbs them. ``req_ids`` defaults to the row index.
    The caches are updated in place and returned."""
    cfg = _serve_model_cfg(cfg, scfg)

    @torch.inference_mode()
    def serve_step(model: Model, caches, token, pos, req_ids=None):
        logits = decode_step(model, token, pos, caches, cfg=cfg)
        if scfg.temperature > 0:
            if req_ids is None:
                req_ids = torch.arange(token.shape[0], device=logits.device)
            nxt = sample_tokens(logits, req_ids, pos, seed=scfg.seed,
                                temperature=scfg.temperature)
        else:
            nxt = torch.argmax(logits, -1)
        return nxt[:, None], caches

    return serve_step


class Engine:
    """Batched engine: prefill a batch of prompts, then decode until
    max_new or EOS. ``model`` is a :class:`~repro_torch.models.Model`; the
    engine runs on the model's device through :func:`make_prefill_step`
    and :func:`make_serve_step`."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, model: Model):
        self.cfg = _serve_model_cfg(cfg, scfg)
        self.scfg, self.model = scfg, model
        self.device = model.device
        self._prefill = make_prefill_step(cfg, scfg)
        self._step = make_serve_step(cfg, scfg)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new: int, eos: int = -1,
                 request_ids=None) -> np.ndarray:
        """Greedy (or sampled) decode of ``prompts [B, S]``; returns
        ``[B, <= max_new]`` int tokens. Partial batches pad to the
        configured batch and slice off; ``request_ids [B]`` key the
        per-request sample streams (default: row index)."""
        B, S = prompts.shape
        Bc = self.scfg.batch
        if B > Bc:
            raise ValueError(f"batch {B} exceeds configured {Bc}")
        if B < Bc:
            prompts = np.concatenate(
                [prompts, np.zeros((Bc - B, S), prompts.dtype)], axis=0)
        rids = np.arange(B) if request_ids is None else np.asarray(request_ids)
        if rids.shape != (B,):
            raise ValueError(f"request_ids must be [{B}], got {rids.shape}")
        rids = torch.as_tensor(np.concatenate([rids, np.zeros(Bc - B, int)]),
                               device=self.device)
        caches = init_caches(self.cfg, Bc, self.scfg.max_seq,
                             quantized_kv=self.scfg.quantized_kv,
                             kv_policy=self.scfg.kv_policy,
                             device=self.device)
        logits, caches = self._prefill(self.model, {"tokens": prompts},
                                       caches)
        tok = torch.argmax(logits, -1)[:, None]
        out = [tok]
        sync_k = max(1, self.scfg.eos_sync_every)
        done = None
        if eos >= 0:      # padded rows start done
            done = (tok[:, 0] == eos) | (torch.arange(Bc, device=self.device)
                                         >= B)
        for i in range(max_new - 1):
            tok, caches = self._step(self.model, caches, tok, S + i, rids)
            out.append(tok)
            if eos >= 0:
                done = done | (tok[:, 0] == eos)   # stays on device
                if (i + 1) % sync_k == 0 and bool(done.all()):
                    break
        return torch.cat(out, dim=1).cpu().numpy()[:B]


class SketchIngestEngine:
    """Streaming front end of the F2P sketch: packets in, reports out.

    Callers hand over chunks of flow keys (one entry per packet arrival,
    any chunk size); the engine re-batches them into fixed-size batches,
    updates the sketch, and feeds a bounded heavy-hitter candidate table
    with each batch's most frequent keys and their fresh sketch estimates.
    Short remainders are zero-count padded at ``flush`` time, so totals are
    exact regardless of how arrivals were chunked. The sketch's device
    (the card by default) runs the advance.
    """

    def __init__(self, sketch, batch: int = 1 << 16, track_top: int = 256):
        self.sketch = sketch
        self.batch = int(batch)
        self._buf = np.empty(self.batch, dtype=np.int64)
        self._fill = 0
        self.hh = HeavyHitterTable(capacity=track_top)
        # obs registry (DESIGN.md §13): packet/batch tallies live in F2P
        # cells with exact shadows; ``packets``/``batches`` stay exact-int
        # reads. ``arrivals_per_s`` is derived from accumulated ingest wall
        # time; ``flush_depth`` histograms the partial-tail size per flush.
        self.metrics = obs.MetricsRegistry("sketch.ingest")
        self._c_packets = self.metrics.counter("packets")
        self._c_batches = self.metrics.counter("batches")
        self._g_rate = self.metrics.gauge("arrivals_per_s")
        self._h_flush = self.metrics.histogram("flush_depth", 1.0,
                                               float(max(2, self.batch)))
        self._ingest_s = 0.0

    @property
    def packets(self) -> int:
        return self._c_packets.exact

    @property
    def batches(self) -> int:
        return self._c_batches.exact

    def ingest(self, keys: np.ndarray) -> None:
        """Buffer packet keys; every full batch is dispatched eagerly."""
        t0 = time.perf_counter()
        keys = np.asarray(keys).ravel()
        pos = 0
        while pos < keys.size:
            take = min(keys.size - pos, self.batch - self._fill)
            self._buf[self._fill:self._fill + take] = keys[pos:pos + take]
            self._fill += take
            pos += take
            if self._fill == self.batch:
                self._fill = 0
                self._dispatch(self._buf, np.ones(self.batch, np.float32))
        self._ingest_s += time.perf_counter() - t0
        if self._ingest_s > 0:
            self._g_rate.set(self.packets / self._ingest_s)

    def flush(self) -> None:
        """Push the partial tail batch (zero-count padded to full shape) and
        drain the budget the fixed-sweep advance carried between batches —
        estimates read after a flush reflect every packet."""
        if self._fill:
            self._h_flush.observe(float(self._fill))
        with obs.span("sketch.flush", buffered=self._fill):
            self._flush_inner()

    def _flush_inner(self) -> None:
        if self._fill:
            keys = np.zeros(self.batch, dtype=np.int64)
            counts = np.zeros(self.batch, dtype=np.float32)
            keys[:self._fill] = self._buf[:self._fill]
            counts[:self._fill] = 1.0
            self._fill = 0
            self._dispatch(keys, counts)
        self.sketch.flush()
        # the drain advanced cells the candidate table was last told about
        # pre-drain — refresh its estimates or the report undercounts
        # exactly the heaviest (most-carried) flows
        keys = self.hh.keys
        if keys.size:
            padded = np.zeros(4 * self.hh.capacity, dtype=np.int64)
            padded[:keys.size] = keys
            self.hh.offer(keys, self.sketch.query(padded)[:keys.size])

    def _dispatch(self, keys: np.ndarray, counts: np.ndarray) -> None:
        # pre-combine once and feed the sketch the (unique key, count) pairs
        # — the candidate scan needs the combine anyway
        live = keys[counts > 0]
        uniq, cnt = np.unique(live, return_counts=True)
        if uniq.size == 0:
            return
        self.sketch.update(uniq, cnt.astype(np.float32))
        self._c_packets.inc(int(cnt.sum()))
        self._c_batches.inc()
        # candidate refresh: the batch's most frequent keys, re-estimated
        # against the updated sketch (sketch+heap heavy-hitter recovery),
        # queried at one fixed padded shape
        cap = 4 * self.hh.capacity
        if uniq.size > cap:
            keep = np.argsort(cnt)[::-1][:cap]
            uniq = uniq[keep]
        padded = np.zeros(cap, dtype=np.int64)
        padded[:uniq.size] = uniq
        est = self.sketch.query(padded)[:uniq.size]
        self.hh.offer(uniq, est)

    def heavy_hitters(self, k: int = 20, min_share: float = 0.0):
        """Top-k flow report against the exact ingested-packet total."""
        return self.hh.report(k, total_arrivals=float(self.packets),
                              min_share=min_share)

    def stats(self) -> dict:
        return {
            "packets": self.packets,
            "batches": self.batches,
            "buffered": self._fill,
            "sketch_fill": self.sketch.fill(),
            "sketch_bytes": self.sketch.nbytes,
            "device": str(self.sketch.device),
            "pending_budget": self.sketch.pending_budget,
        }
