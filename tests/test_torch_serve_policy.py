"""Port parity, serving under a KV-format policy and the obs-wired engine.

* ``init_caches(kv_policy=...)`` picks the format of the ``kv/b0`` rule, as
  the reference; an empty LR cache (nonzero zero code) decodes to zeros.
* Under ``kv/*`` policies at 6/8/16-bit SR and 8-bit LR, the port's
  ``BatchedEngine`` (paged and copy-in, reference weights via
  ``params_from_jax``) gives the JAX sequential ``Engine``'s greedy tokens;
  inside the port paged == copy-in bitwise, through page relocation,
  compaction and a defragmenting paged run.
* ``stats`` has the JAX ``BatchedEngine``'s keys and exact counts on one
  workload; the registry's histograms hold every request.
* With the clock frozen, both engines' SLO admission normalises queue-wait
  age by the queue-wait histogram's interpolated p50 and picks the same
  request where the median of the raw waits would pick another.
"""
import time

import _torch_threads  # noqa: F401
import jax
import numpy as np
import pytest
import torch

from repro.autotune.policy import FormatPolicy as JPolicy
from repro.configs import smoke_config as jax_smoke
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.serve import BatchedEngine as JBatched
from repro.serve import BatchedServeConfig as JBatchedConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.autotune import FormatPolicy, PolicyRule
from repro_torch.configs import smoke_config
from repro_torch.core.formats import named_format
from repro_torch.models import decode_step, init_caches, kv_format, prefill
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (BatchedEngine, BatchedServeConfig, Engine,
                               Request, ServeConfig)

CPU = torch.device("cpu")
FORMATS = ["f2p_sr_2_6s", "f2p_sr_2_8s", "f2p_sr_2_16s", "f2p_lr_2_8s"]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke("llama3_2_3b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = smoke_config("llama3_2_3b")
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, model


def _policies(fmt: str):
    """The same ``kv/*`` policy in both packages."""
    d = {"rules": [{"pattern": "kv/*", "fmt": fmt, "block": 0}]}
    return JPolicy.from_dict(d), FormatPolicy.from_dict(d)


def _requests(cfg, n=5, seed=11, stagger=3, L=9):
    """Equal prompt lengths (one JAX prefill shape), staggered arrivals and
    ragged ``max_new``."""
    rng = np.random.default_rng(seed)
    return [Request(uid=u + 1,
                    tokens=rng.integers(0, cfg.vocab_size, L).astype(
                        np.int32),
                    max_new=int(rng.integers(4, 12)), arrival=stagger * u)
            for u in range(n)]


def test_init_caches_policy_formats_and_lr_zero_decode(setup):
    _, _, cfg, model = setup
    pol = FormatPolicy(rules=(PolicyRule("kv/b0", "f2p_lr_2_8s", 0),
                              PolicyRule("kv/*", "f2p_sr_2_8s", 0)))
    jpol = JPolicy.from_dict(pol.to_dict())
    caches = init_caches(cfg, 2, 16, quantized_kv=True, kv_policy=pol,
                         device=CPU)
    jcaches = jinit_caches(jax_smoke("llama3_2_3b"), 2, 16, quantized_kv=True,
                           kv_policy=jpol, packed_kv=True)
    assert caches["b0"]["k"].fmt == caches["b0"]["v"].fmt == named_format(
        "f2p_lr_2_8s")
    assert str(caches["b0"]["k"].fmt) == str(jcaches["b0"]["k"].fmt)
    # the same empty words as the reference: the LR code of value zero
    np.testing.assert_array_equal(
        caches["b0"]["k"].codes[0].view(torch.int32).numpy(),
        np.asarray(jcaches["b0"]["k"].codes)[0].view(np.int32))
    assert float(caches["b0"]["k"].dequantize().abs().max()) == 0.0
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    prefill(model, toks[:, :8], caches)
    assert bool(torch.isfinite(decode_step(model, toks[:, 8:], 8,
                                           caches)).all())
    # no policy: the hard-coded KV format; a kv/* rule for every layer
    assert kv_format(None) == init_caches(
        cfg, 1, 8, quantized_kv=True, device=CPU)["b0"]["k"].fmt
    assert kv_format(_policies("f2p_sr_2_6s")[1]).n_bits == 6


@pytest.mark.parametrize("fmt", FORMATS)
def test_batched_engine_under_policy_matches_jax_sequential(setup, fmt):
    jcfg, jparams, cfg, model = setup
    jpol, pol = _policies(fmt)
    reqs = _requests(cfg)
    bs = dict(slots=3, max_seq=32, sync_every=4, kv_policy=pol)
    paged = BatchedEngine(cfg, BatchedServeConfig(**bs), model)
    assert paged.pool.slabs["b0"]["k"].fmt == named_format(fmt)
    out = paged.run(reqs)
    copy_in = BatchedEngine(cfg, BatchedServeConfig(paged_decode=False, **bs),
                            model)
    assert copy_in.caches["b0"]["k"].fmt == named_format(fmt)
    got_c = copy_in.run(reqs)
    jeng = JEngine(jcfg, JServeConfig(batch=1, max_seq=32, quantized_kv=True,
                                      packed_kv=True, fused_attention=True,
                                      kv_policy=jpol), jparams)
    seq = Engine(cfg, ServeConfig(batch=1, max_seq=32, quantized_kv=True,
                                  fused_attention=True, kv_policy=pol), model)
    for r in reqs:
        want = np.asarray(jeng.generate(r.tokens[None], r.max_new)[0],
                          np.int32)
        np.testing.assert_array_equal(out[r.uid], want)
        np.testing.assert_array_equal(got_c[r.uid], out[r.uid])
        np.testing.assert_array_equal(
            seq.generate(r.tokens[None], r.max_new)[0], out[r.uid])


@pytest.mark.parametrize("fmt", FORMATS)
def test_paged_equals_copy_in_through_relocate_and_compact(setup, fmt):
    """Relocating and compacting a request's pages between prefill store
    and slot load (copy-in), and a paged run that defragments the pool
    every round and relocates every slot, leave the tokens bitwise equal
    to the plain paged run, in every policy's format."""
    _, _, cfg, model = setup
    _, pol = _policies(fmt)
    reqs = _requests(cfg, 6, seed=20, stagger=2)
    base = dict(slots=3, max_seq=32, sync_every=4, kv_policy=pol)
    want = BatchedEngine(cfg, BatchedServeConfig(**base), model).run(reqs)

    eng = BatchedEngine(cfg, BatchedServeConfig(paged_decode=False, **base),
                        model)
    store = eng.pool.store_prefill

    def store_then_relocate(caches, length, row=0):
        table = eng.pool.relocate(store(caches, length, row))
        eng.pool.compact([table])
        return table

    eng.pool.store_prefill = store_then_relocate
    got = eng.run(reqs)

    defrag = BatchedEngine(cfg, BatchedServeConfig(defrag_every=1, **base),
                           model)
    grow = defrag._grow_tables

    def grow_then_relocate():
        need = grow()
        for s in range(3):
            defrag.relocate_slot(s)
        return need

    defrag._grow_tables = grow_then_relocate
    got_d = defrag.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(got[r.uid], want[r.uid])
        np.testing.assert_array_equal(got_d[r.uid], want[r.uid])
    assert defrag.stats["pool"]["used"] == 1


@pytest.mark.parametrize("fmt", ["f2p_sr_2_6s", "f2p_lr_2_8s"])
def test_preempt_evict_readmit_under_policy(setup, fmt):
    """Host eviction and readmission carry the policy's words unchanged."""
    _, _, cfg, model = setup
    _, pol = _policies(fmt)
    rng = np.random.default_rng(7)
    reqs = [Request(uid=u + 1, tokens=rng.integers(0, cfg.vocab_size, 9)
                    .astype(np.int32), max_new=16) for u in range(5)]
    bs = dict(slots=2, max_seq=32, sync_every=4, kv_policy=pol)
    want = BatchedEngine(cfg, BatchedServeConfig(slots=5, max_seq=32,
                                                 kv_policy=pol),
                         model).run(reqs)
    for paged in (True, False):
        eng = BatchedEngine(cfg, BatchedServeConfig(
            preempt_patience=1, paged_decode=paged, **bs), model)
        out = eng.run(reqs)
        for key in ("preemptions", "host_evictions", "readmits"):
            assert eng.stats.get(key, 0) > 0, key
        for r in reqs:
            np.testing.assert_array_equal(out[r.uid], want[r.uid])


def test_stats_keys_and_counts_match_jax_engine(setup):
    jcfg, jparams, cfg, model = setup
    rng = np.random.default_rng(3)
    # more ready requests than slots and long tails: the starved queue
    # preempts, evicts to the host and readmits
    spec = [(int(rng.integers(3, 13)), int(rng.integers(12, 17)), u)
            for u in range(5)]
    reqs = [Request(uid=u + 1, tokens=rng.integers(0, cfg.vocab_size, L)
                    .astype(np.int32), max_new=m, arrival=a)
            for u, (L, m, a) in enumerate(spec)]
    kw = dict(slots=2, max_seq=32, sync_every=4, scheduler="fifo",
              preempt_patience=1)
    eng = BatchedEngine(cfg, BatchedServeConfig(**kw), model)
    out = eng.run(reqs)
    jeng = JBatched(jcfg, JBatchedConfig(**kw), jparams)
    jout = jeng.run([JRequest(r.uid, r.tokens, r.max_new, r.arrival)
                     for r in reqs])
    for r in reqs:
        np.testing.assert_array_equal(out[r.uid], np.asarray(jout[r.uid]))
    st, jst = eng.stats, jeng.stats
    assert sorted(st) == sorted(jst)
    for k in jst:
        if k == "pool":
            assert st[k] == jst[k]
        elif k == "slot_occupancy":
            assert st[k] == pytest.approx(jst[k], rel=1e-12)
        else:
            assert st[k] == jst[k], k
    assert "preemptions" in st and st["emitted_tokens"] == sum(
        r.max_new for r in reqs)
    # the registry's histograms hold every request
    m = eng.metrics
    assert m["ttft_ms"].count == m["queue_wait_ms"].count == \
        st["prefills"]
    assert m["tbt_ms"].count == len(reqs)
    assert eng.metrics.export()["counters"]["rounds"]["exact"] == \
        st["rounds"]


def test_trace_rows_match_jax_engine(setup):
    """With tracing armed, the port's engine emits the reference's trace
    events (round / prefill spans, admit / preempt / evict / readmit /
    retire instants, per-request ttft and decode rows, the slots counter)
    with the same names, phases and counts on one workload; disarmed, the
    registry still counts and no tracer exists."""
    from collections import Counter

    from repro import obs as jobs
    from repro_torch import obs

    jcfg, jparams, cfg, model = setup
    reqs = _requests(cfg, 5, seed=3, stagger=0)
    kw = dict(slots=2, max_seq=32, sync_every=4, scheduler="fifo",
              preempt_patience=1)

    def names(tracer):
        return Counter((e["name"], e["ph"]) for e in tracer.events)

    try:
        obs.enable()
        BatchedEngine(cfg, BatchedServeConfig(**kw), model).run(reqs)
        got = names(obs.get().tracer)
        jobs.enable()
        JBatched(jcfg, JBatchedConfig(**kw), jparams).run(
            [JRequest(r.uid, r.tokens, r.max_new, r.arrival) for r in reqs])
        want = names(jobs.get().tracer)
    finally:
        obs.disable()
        jobs.disable()
    assert got == want
    assert got[("preempt", "i")] > 0 and got[("decode", "X")] == len(reqs)
    eng = BatchedEngine(cfg, BatchedServeConfig(**kw), model)
    eng.run(reqs)
    assert obs.get() is None and eng.stats["preemptions"] > 0


def test_stats_event_keys_appear_once_nonzero(setup):
    _, _, cfg, model = setup
    eng = BatchedEngine(cfg, BatchedServeConfig(slots=4, max_seq=32), model)
    eng.run(_requests(cfg, 3, stagger=0))
    st = eng.stats
    for key in ("preemptions", "host_evictions", "readmits"):
        assert key not in st
    assert st["prefills"] == 3 and st["prefill_calls"] >= 1


def test_slo_admission_uses_histogram_p50_like_jax(setup, monkeypatch):
    """The fault the obs wiring repairs: the port normalised queue-wait
    ages by np.median of the raw waits, the reference by the queue-wait
    histogram's p50 (log-linear inside its bucket). With the clock frozen,
    the same wait history and the same pending requests, both engines now
    admit the same request, and the median would have picked the other."""
    jcfg, jparams, cfg, model = setup
    kw = dict(slots=2, max_seq=64, scheduler="slo", slo_ttft_ms=1000.0,
              sched_tail_weight=0.25)
    eng = BatchedEngine(cfg, BatchedServeConfig(**kw), model)
    jeng = JBatched(jcfg, JBatchedConfig(**kw), jparams)
    clock = [10 ** 12]
    monkeypatch.setattr(time, "perf_counter_ns", lambda: clock[0])

    waits_ms = [1.0, 2.0, 50.0]               # median 2.0, inside a bucket
    for i, w in enumerate(waits_ms):
        for e, R in ((eng, Request), (jeng, JRequest)):
            r = R(uid=100 + i, tokens=np.zeros(4, np.int32), max_new=4)
            e._rt[r.uid] = {"visible": clock[0] - int(w * 1e6)}
            e._note_admission(r)
    q50 = jeng._h_queue.quantile(0.5, exact=True)
    med = float(np.median(waits_ms))
    assert q50 != med
    # A is older but has the longer tail: the tail penalties differ by
    # 0.25 * 32 / 64 = 0.125, and A's extra age is set halfway between
    # the two normalisations' break-even points
    gap_ms = 0.125 * (q50 + med) / 2
    age_b = 3.0
    chosen = {}
    for name, e, R in (("port", eng, Request), ("jax", jeng, JRequest)):
        pend = [R(uid=1, tokens=np.zeros(4, np.int32), max_new=40),
                R(uid=2, tokens=np.zeros(4, np.int32), max_new=8)]
        e._rt[1] = {"visible": clock[0] - int((age_b + gap_ms) * 1e6)}
        e._rt[2] = {"visible": clock[0] - int(age_b * 1e6)}
        e._sched_skips.clear()
        chosen[name] = [r.uid for r in e._select_admissions(pend, 0, 1)]
    assert chosen["port"] == chosen["jax"]
    assert eng._h_queue.quantile(0.5, exact=True) == q50
    # the raw-wait median ranks the other way
    by_median = 1 if gap_ms / med > 0.125 else 2
    assert [by_median] != chosen["jax"]
