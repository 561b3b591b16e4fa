"""Port parity, observability: ``repro_torch.obs`` against ``repro.obs``.

Bitwise: the host path is the reference's numpy (same seeds, same
advance), so exact shadows, F2P estimates and whole exports must be equal;
a device-side histogram observe (a torch tensor) must bucket like the
reference's jitted one. Stated tolerance: quantiles from F2P-estimated
buckets track ``np.quantile`` within the reference's own tolerances; a
registry advanced through ``counter_advance`` (``device=``) is exact in the
16-bit grid's dense head (below 4096 per cell). The span tracer writes the
Chrome ``trace_event`` schema and the disabled path is a no-op.
"""
import json

import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch import obs
from repro_torch.obs import (ExpertLoadTracker, FlowStats, MetricsRegistry,
                             SpanTracer)


@pytest.fixture(autouse=True)
def _disarm():
    obs.disable()
    yield
    obs.disable()


def _fill(mod, name, **kw):
    """The same operations on a registry of either package."""
    reg = mod.MetricsRegistry(name, register=False, **kw)
    c = reg.counter("hits")
    for _ in range(100):
        c.inc()
    c.inc(90000)
    reg.counter_vector("loads", 8).add(np.array([0, 3, 3, 7]),
                                       np.array([5, 7000, 7, 123456]))
    reg.gauge("g").set(3.5)
    h = reg.histogram("lat_ms", 0.1, 1e5, per_decade=16)
    h.observe(np.random.default_rng(0).lognormal(3.0, 1.0, 20000))
    h.observe(0.01)
    h.observe(1e7)
    return reg


@pytest.mark.parametrize("n_bits", [8, 12, 16])
def test_registry_export_bitwise_vs_reference(n_bits):
    mine = _fill(obs, "t.parity", n_bits=n_bits, seed=3)
    ref = _fill(jobs, "t.parity", n_bits=n_bits, seed=3)
    got, want = mine.export(buckets=True), ref.export(buckets=True)
    assert got == want
    json.dumps(got)
    np.testing.assert_array_equal(mine["loads"].exact, ref["loads"].exact)
    np.testing.assert_array_equal(mine["loads"].estimates(),
                                  ref["loads"].estimates())
    mine.reset()
    ref.reset()
    assert mine.export() == ref.export()


def test_counter_exact_shadow_and_estimate():
    reg = MetricsRegistry("t.counters", register=False)
    c = reg.counter("hits")
    for _ in range(100):
        c.inc()
    c.inc(900)
    assert c.exact == 1000
    assert c.estimate() == 1000.0
    assert reg.counter("hits") is c
    with pytest.raises(ValueError):
        reg.gauge("hits")


def test_counter_vector_bulk_adds():
    reg = MetricsRegistry("t.vec", register=False)
    v = reg.counter_vector("loads", 8)
    v.add(np.array([0, 3, 3]), np.array([5, 7, 7]))
    assert v.exact.tolist() == [5, 0, 0, 14, 0, 0, 0, 0]
    np.testing.assert_allclose(v.estimates(), v.exact, rtol=0.05)


@pytest.mark.parametrize("n_bits,tol", [(8, 0.35), (16, 0.05)])
def test_histogram_quantiles_vs_exact_oracle(n_bits, tol):
    rng = np.random.default_rng(0)
    v = rng.lognormal(3.0, 1.0, 20000)
    reg = MetricsRegistry("t.hist", n_bits=n_bits, register=False)
    h = reg.histogram("lat_ms", 0.1, 1e5, per_decade=16)
    h.observe(v)
    assert h.count == v.size
    assert h.mean == pytest.approx(v.mean(), rel=1e-6)
    for q in (0.5, 0.9, 0.99):
        assert h.quantile(q) == pytest.approx(float(np.quantile(v, q)),
                                              rel=tol), f"p{q}"
    assert h.quantile(0.5, exact=True) == pytest.approx(
        float(np.quantile(v, 0.5)), rel=0.16)


def test_histogram_under_overflow_and_scalar_observe():
    reg = MetricsRegistry("t.uo", register=False)
    h = reg.histogram("h", 1.0, 100.0)
    h.observe(0.01)
    h.observe(1e6)
    h.observe([5.0, 50.0])
    assert h.count == 4
    c = h.counts(exact=True)
    assert c[0] == 1 and c[-1] == 1
    assert h.quantile(0.0) == pytest.approx(1.0)
    assert h.quantile(1.0) == pytest.approx(100.0)


def test_histogram_device_observe_lazy_and_bitwise_vs_reference():
    vals = np.random.default_rng(1).lognormal(2.0, 1.0, 512)
    vals[:4] = [1.0, 10.0, 0.5, 2e4]           # on an edge, under, over
    reg = MetricsRegistry("t.dev", register=False)
    jreg = jobs.MetricsRegistry("t.dev", register=False)
    h, jh = reg.histogram("d", 1.0, 1e4), jreg.histogram("d", 1.0, 1e4)
    for part in (vals[:256], vals[256:]):
        h.observe(torch.from_numpy(part))
        jh.observe(jnp.asarray(part, jnp.float32))
    assert len(h._dev_pending) == 2, "tensor observes must park, not sync"
    assert h.count == 512 == jh.count
    assert not h._dev_pending
    np.testing.assert_array_equal(h.counts(exact=True),
                                  jh.counts(exact=True))
    assert h.sum == pytest.approx(jh.sum, rel=1e-6)
    assert h.sum == pytest.approx(vals.astype(np.float32).sum(), rel=1e-4)


def test_registry_reset_and_export_schema():
    reg = MetricsRegistry("t.exp", register=False)
    reg.counter("c").inc(7)
    reg.gauge("g").set(3.5)
    reg.histogram("h", 0.1, 10.0).observe([0.5, 5.0])
    out = reg.export(buckets=True)
    assert out["counters"]["c"] == {"exact": 7, "estimate": 7.0}
    assert out["gauges"]["g"] == 3.5
    hh = out["histograms"]["h"]
    assert hh["count"] == 2 and "p99" in hh and "bucket_counts" in hh
    assert set(out) == {"n_bits", "h_bits", "counters", "gauges",
                        "histograms", "counter_vectors"}
    json.dumps(out)
    reg.reset()
    out = reg.export()
    assert out["counters"]["c"]["exact"] == 0
    assert out["histograms"]["h"]["count"] == 0
    assert out["gauges"]["g"] == 0.0


def test_process_wide_export_collects_registries():
    reg = MetricsRegistry("t.live")
    reg.counter("n").inc(3)
    snap = obs.export()
    assert snap["registries"]["t.live"]["counters"]["n"]["exact"] == 3
    assert snap["trace"] is None
    assert "t.live" not in jobs.export()["registries"]
    del reg


@pytest.mark.parametrize("cells,increments", [(1, 3000), (1000, 10 ** 5)])
def test_device_registry_advance_exact_in_dense_head(cells, increments):
    """``device=`` routes the advance through ``counter_advance`` (the plain
    version for a CPU device): exact below 4096 per cell at 16 bits."""
    reg = MetricsRegistry("t.dev_adv", device="cpu", register=False)
    v = reg.counter_vector("n", cells)
    idx = np.random.default_rng(cells).integers(0, cells, increments)
    v.add(idx)
    assert v.exact.max() < 4096
    np.testing.assert_array_equal(v.estimates(), v.exact)
    c = reg.counter("big")
    c.inc(50000)                     # past the dense head: estimative
    assert c.exact == 50000
    assert c.estimate() == pytest.approx(50000, rel=0.05)


def test_device_registry_chunks_past_the_f32_ceiling():
    """Budgets past 2^24 go to the f32 advance in chunks; an 8-bit cell
    saturates at its grid's top and parks."""
    reg = MetricsRegistry("t.ceiling", n_bits=8, device="cpu",
                          register=False)
    c = reg.counter("huge")
    c.inc(3 * (1 << 24) + 5)
    assert c.exact == 3 * (1 << 24) + 5
    assert c.estimate() == reg.grid[-1]
    assert reg._budget.sum() == 0.0


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------
def test_span_nesting_and_ordering():
    tr = SpanTracer()
    with tr.span("outer", tid=1, req=7):
        with tr.span("inner", tid=1):
            pass
        with tr.span("inner2", tid=1):
            pass
    evs = [e for e in tr.events if e["ph"] == "X"]
    byname = {e["name"]: e for e in evs}
    assert [e["name"] for e in evs] == ["inner", "inner2", "outer"]
    o, i1, i2 = byname["outer"], byname["inner"], byname["inner2"]
    assert o["ts"] <= i1["ts"] and i1["ts"] + i1["dur"] <= o["ts"] + o["dur"]
    assert i1["ts"] + i1["dur"] <= i2["ts"]
    assert o["args"] == {"req": 7}


def test_chrome_trace_schema(tmp_path):
    tr = SpanTracer()
    tr.process_name("engine")
    tr.thread_name(2, "req 1")
    with tr.span("work", tid=2):
        tr.instant("mark", tid=2, uid=1)
    tr.counter("slots", active=3)
    tr.complete("retro", 10.0, 5.0, tid=2)
    p = tmp_path / "t.trace.json"
    tr.write_chrome(str(p))
    doc = json.loads(p.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    assert {e["ph"] for e in doc["traceEvents"]} == {"M", "X", "i", "C"}
    for e in doc["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert e["dur"] >= 0
        if e["ph"] == "i":
            assert e["s"] == "t"
        if e["ph"] == "C":
            assert all(isinstance(v, float) for v in e["args"].values())
    jl = tmp_path / "t.jsonl"
    tr.write_jsonl(str(jl))
    lines = jl.read_text().splitlines()
    assert len(lines) == len(doc["traceEvents"])
    assert tr.summary()["spans"]["work"]["count"] == 1
    # the same events as the reference's tracer would write
    jtr = jobs.SpanTracer()
    assert set(jtr.to_chrome()) == set(tr.to_chrome())


def test_annotated_spans_reach_the_torch_profiler():
    tr = SpanTracer(annotate=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("sketch.flush"):
            torch.ones(4).sum()
    assert "sketch.flush" in {e.key for e in prof.key_averages()}
    assert tr.summary()["spans"]["sketch.flush"]["count"] == 1


def test_disabled_path_is_noop():
    assert not obs.enabled() and obs.get() is None
    ctx = obs.span("anything", uid=1)
    assert ctx is obs.span("other")
    with ctx:
        pass
    obs.instant("x")
    obs.counter_event("c", v=1)
    st = obs.enable(trace=True)
    assert obs.enabled() and obs.get() is st
    with obs.span("real"):
        pass
    obs.instant("mark")
    obs.counter_event("c", v=2)
    assert len(st.tracer) == 3
    assert obs.export()["trace"]["spans"]["real"]["count"] == 1
    obs.disable()
    assert obs.span("again") is ctx


# ---------------------------------------------------------------------------
# compat trackers
# ---------------------------------------------------------------------------
def test_flow_stats_compat_bitwise_vs_reference():
    fs, jfs = FlowStats(["tokens_in", "steps"]), jobs.FlowStats(
        ["tokens_in", "steps"])
    for f in (fs, jfs):
        f.add("tokens_in", 100000)
        f.add("steps")
    assert fs.snapshot() == jfs.snapshot()
    assert fs.snapshot()["tokens_in"] == pytest.approx(100000, rel=0.05)
    assert fs.snapshot()["steps"] == 1.0
    from repro_torch.telemetry import FlowStats as Old
    assert Old is FlowStats


def test_expert_load_tracker_compat_bitwise_vs_reference():
    t, jt = ExpertLoadTracker(4, n_bits=16), jobs.ExpertLoadTracker(
        4, n_bits=16)
    for tr in (t, jt):
        tr.update(np.array([100000, 0, 50, 0]))
        tr.update(np.array([100, 0, 0, 0]))
    np.testing.assert_array_equal(t.loads(), jt.loads())
    assert t.loads()[0] == pytest.approx(100100, rel=0.1)
    assert t.loads()[1] == 0
    assert t.imbalance() == jt.imbalance() > 1.0
    assert not any(k.startswith("telemetry.")
                   for k in obs.export()["registries"])
