"""Port parity, fault injection: ``repro_torch.faults`` against the JAX
reference's ``repro.faults``.

Tolerance: none. A plan's draws are numpy generators keyed by the same
(seed, crc32(domain), ints), so every fate, permutation and corruption
draw is compared EXACTLY; ``corrupt_update`` on the same update (carried
across by ``models.convert.update_from_jax``) must corrupt the same bit of
the same buffer, or plant the same value at the same position. The second
half holds the reference's own invariants (``tests/test_faults.py``)
inside the port, and ``FaultyEngine`` over the port's ``serve.Engine``.
"""
import dataclasses

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as JF
from repro.core import qtensor as JQT
from repro.core.f2p import F2PFormat as JF2PFormat
from repro.core.f2p import Flavor as JFlavor
from repro.core.formats import format_name as jformat_name
from repro_torch.core import qtensor as QT
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.faults import (BENIGN, CrashInjected, DroppedRequest,
                                FaultPlan, TransientServeError, active,
                                corrupt_update, crashpoint, install,
                                named_plan, uninstall, wrap_engine)
from repro_torch.fl._tree import leaves, to_numpy
from repro_torch.models.convert import update_from_jax

FMT8 = F2PFormat(8, 2, Flavor.SR, signed=True)
JFMT8 = JF2PFormat(8, 2, JFlavor.SR, signed=True)
JFMT6 = JF2PFormat(6, 2, JFlavor.SR, signed=True)

_PLANS = {
    "chaos-small": "chaos-small",
    "corrupt": "corrupt",
    "none": "none",
    "rates-a": dict(seed=3, dropout=0.3, straggler=0.3, straggler_delay=2.5,
                    transient=0.4, duplicate=0.5, bitflip=0.2, nan_delta=0.2,
                    reorder=True),
    "rates-b": dict(seed=12345, dropout=0.05, straggler=0.6, transient=0.05,
                    duplicate=0.9, nan_delta=0.5),
    "seed-big": dict(seed=2 ** 40 + 7, straggler=1.0, straggler_delay=50.0,
                     reorder=True),
}


def _plans(name):
    spec = _PLANS[name]
    if isinstance(spec, str):
        return named_plan(spec), JF.named_plan(spec)
    return FaultPlan(**spec), JF.FaultPlan(**spec)


# ---------------------------------------------------------------------------
# parity: the plan's draws
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(_PLANS))
def test_client_fault_equal_reference(name):
    plan, jplan = _plans(name)
    assert dataclasses.astuple(plan) == dataclasses.astuple(jplan)
    for r in range(6):
        for c in list(range(48)) + [999, 123_456]:
            assert dataclasses.astuple(plan.client_fault(r, c)) == \
                dataclasses.astuple(jplan.client_fault(r, c)), (r, c)


@pytest.mark.parametrize("name", list(_PLANS))
def test_arrival_order_and_rng_equal_reference(name):
    plan, jplan = _plans(name)
    for r in range(4):
        for n in (0, 1, 2, 7, 64):
            np.testing.assert_array_equal(plan.arrival_order(r, n),
                                          jplan.arrival_order(r, n))
    for dom, ints in (("corrupt", (0, 5)), ("reorder", (3,)),
                      ("client", (2, 2 ** 33 + 1))):
        np.testing.assert_array_equal(plan.rng(dom, *ints).random(8),
                                      jplan.rng(dom, *ints).random(8))


def test_named_plans_equal_reference():
    for name in ("chaos-small", "corrupt", "none"):
        assert dataclasses.astuple(named_plan(name)) == \
            dataclasses.astuple(JF.named_plan(name))
    assert dataclasses.astuple(BENIGN) == dataclasses.astuple(JF.BENIGN)


# ---------------------------------------------------------------------------
# parity: wire corruption on the same update
# ---------------------------------------------------------------------------
def _parts(x):
    if isinstance(x, dict):
        return {k: _parts(v) for k, v in x.items()}
    if isinstance(x, JQT.QTensor):
        return (np.asarray(x.codes), np.asarray(x.scales),
                jformat_name(x.fmt), x.block, x.shape, x.packed)
    return np.asarray(x)


def _jwire(seed, packed):
    """The reference test's wire update: a QTensor + a raw bias."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, size=(2, 64)).astype(np.float32)
    return {"w": JQT.quantize(jnp.asarray(x), JFMT8, block=32, packed=packed),
            "b": rng.normal(0, 1, size=(16,)).astype(np.float32)}


def _jtoy(seed, packed):
    """A toy-model-shaped update: stacked QTensor leaves of 6- and 8-bit
    formats under nested keys, raw norms, an unpacked and a packed leaf."""
    rng = np.random.default_rng(seed)

    def q(shape, fmt, block, pk=packed):
        x = rng.normal(0, 0.01, size=shape).astype(np.float32)
        return JQT.quantize(jnp.asarray(x), fmt, block=block, packed=pk,
                            scale_mode="pow2")

    return {"blocks": {"b0": {
                "ff": {"down": q((2, 64, 32), JFMT8, 32),
                       "gate": q((2, 32, 64), JFMT6, 64)},
                "mixer": {"wk": q((2, 32, 16), JFMT6, 16, pk=True),
                          "wq": q((2, 32, 32), JFMT8, 32, pk=False)},
                "norm1": rng.normal(0, 0.01, (2, 32)).astype(np.float32)}},
            "embed": q((128, 32), JFMT8, 32),
            "final_norm": rng.normal(0, 0.01, (32,)).astype(np.float32)}


def _assert_same_bytes(port_tree, jtree):
    got = [to_numpy(x) for x in leaves(port_tree, expand_q=True)]
    want = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("kind", ["bitflip", "nan"])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("tree", ["wire", "toy"])
def test_corrupt_update_same_bytes_as_reference(kind, packed, tree):
    make = {"wire": _jwire, "toy": _jtoy}[tree]
    plan, jplan = _plans("corrupt")
    for c in range(12):
        ju = make(c, packed)
        u = update_from_jax(_parts(ju))
        got = corrupt_update(u, kind, plan.rng("corrupt", 1, c))
        want = JF.corrupt_update(ju, kind, jplan.rng("corrupt", 1, c))
        _assert_same_bytes(got, want)
        # the port's copy is corrupted, its input untouched
        _assert_same_bytes(u, ju)


def test_corrupted_update_rejected_as_reference_rejects():
    from repro.fl.exact import UpdateRejected as JRejected
    from repro.fl.exact import validate_update as jvalidate
    from repro_torch.fl.exact import UpdateRejected, validate_update

    plan, jplan = _plans("rates-a")
    verdicts = []
    for c in range(40):
        ju = _jtoy(c, packed=c % 2 == 0)
        kind = ("bitflip", "nan")[c % 3 == 0]
        jv = JF.corrupt_update(ju, kind, jplan.rng("corrupt", 0, c))
        v = corrupt_update(update_from_jax(_parts(ju)), kind,
                           plan.rng("corrupt", 0, c))
        try:
            jvalidate(jv)
            want = None
        except JRejected as e:
            want = str(e)
        try:
            validate_update(v)
            got = None
        except UpdateRejected as e:
            got = str(e)
        assert got == want, c
        verdicts.append(want is None)
    assert any(verdicts) and not all(verdicts)


# ---------------------------------------------------------------------------
# the reference's invariants, inside the port
# ---------------------------------------------------------------------------
def test_client_fault_pure_in_seed_round_client():
    plan = named_plan("chaos-small")
    a = plan.client_fault(3, 17)
    for other in (0, 1, 99, 17):
        plan.client_fault(5, other)
    assert plan.client_fault(3, 17) == a
    assert FaultPlan(**{f.name: getattr(plan, f.name)
                        for f in dataclasses.fields(plan)}) \
        .client_fault(3, 17) == a


def test_distinct_keys_distinct_fates():
    plan = FaultPlan(seed=1, dropout=0.5, straggler=0.5)
    fates = {(r, c): plan.client_fault(r, c)
             for r in range(4) for c in range(32)}
    assert len({(f.dropped, round(f.delay, 6)) for f in fates.values()}) > 2


def test_empirical_rates_match_plan():
    plan = FaultPlan(seed=0, dropout=0.2, straggler=0.1, duplicate=0.1,
                     nan_delta=0.08)
    fates = [plan.client_fault(r, c) for r in range(20) for c in range(100)]
    n = len(fates)
    assert abs(sum(f.dropped for f in fates) / n - 0.20) < 0.03
    assert abs(sum(f.delay > 0 for f in fates) / n - 0.10) < 0.03
    assert abs(sum(f.duplicates for f in fates) / n - 0.10) < 0.03
    assert abs(sum(f.corrupt == "nan" for f in fates) / n - 0.08) < 0.03


def test_benign_plan_is_benign():
    plan = FaultPlan()
    for c in range(50):
        assert plan.client_fault(0, c) == BENIGN
    np.testing.assert_array_equal(plan.arrival_order(0, 10), np.arange(10))


def test_arrival_order_reorder_is_permutation_and_deterministic():
    plan = FaultPlan(seed=4, reorder=True)
    p1, p2 = plan.arrival_order(2, 16), plan.arrival_order(2, 16)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(np.sort(p1), np.arange(16))
    assert not np.array_equal(p1, np.arange(16))


def test_named_plan_registry():
    assert named_plan("chaos-small").dropout == pytest.approx(0.20)
    assert named_plan("none") == FaultPlan()
    with pytest.raises(ValueError, match="unknown fault plan"):
        named_plan("chaos-XL")


def _wire_update(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, size=(2, 64)).astype(np.float32)
    return {"w": QT.quantize(torch.from_numpy(x), FMT8, block=32,
                             packed=True),
            "b": torch.from_numpy(
                rng.normal(0, 1, size=(16,)).astype(np.float32))}


def _np_bufs(tree):
    return [to_numpy(x) for x in leaves(tree, expand_q=True)]


def test_corrupt_update_bitflip_flips_exactly_one_bit():
    u = _wire_update()
    v = corrupt_update(u, "bitflip", FaultPlan(seed=9).rng("corrupt", 0, 0))
    orig, corr = _np_bufs(u), _np_bufs(v)
    diff_bits = sum(
        int(np.unpackbits(np.bitwise_xor(
            a.reshape(-1).view(np.uint8),
            b.reshape(-1).view(np.uint8))).sum())
        for a, b in zip(orig, corr))
    assert diff_bits == 1
    for a, b in zip(orig, _np_bufs(_wire_update())):
        np.testing.assert_array_equal(a, b)


def test_corrupt_update_nan_plants_nonfinite_in_float_leaf():
    u = _wire_update()
    v = corrupt_update(u, "nan", FaultPlan(seed=2).rng("corrupt", 1, 5))
    bad = [a for a in _np_bufs(v)
           if a.dtype.kind == "f" and not np.all(np.isfinite(a))]
    assert bad, "nan corruption planted nothing non-finite"
    with pytest.raises(ValueError, match="unknown corruption"):
        corrupt_update(u, "gamma-ray", FaultPlan().rng("corrupt", 0, 0))


def test_nan_corruption_always_caught_by_gate():
    from repro_torch.fl.exact import UpdateRejected, validate_update

    plan = named_plan("chaos-small")
    for c in range(24):
        v = corrupt_update(_wire_update(c), "nan", plan.rng("corrupt", 0, c))
        with pytest.raises(UpdateRejected):
            validate_update(v)


def test_crashpoint_noop_when_disarmed():
    crashpoint("ckpt.before_commit")


def test_crashpoint_fires_once_then_disarms():
    with active(FaultPlan(crash_points=("cp.test",))) as plan:
        assert plan.crash_points == ("cp.test",)
        with pytest.raises(CrashInjected, match="cp.test"):
            crashpoint("cp.test")
        crashpoint("cp.test")          # second hit: already disarmed
        crashpoint("cp.other")         # unarmed name: no-op
    crashpoint("cp.test")              # context exit uninstalls


def test_active_uninstalls_on_error():
    with pytest.raises(RuntimeError, match="boom"):
        with active(FaultPlan(crash_points=("cp.x",))):
            raise RuntimeError("boom")
    crashpoint("cp.x")


def test_install_and_uninstall():
    install(FaultPlan(crash_points=("a", "b")))
    try:
        with pytest.raises(CrashInjected):
            crashpoint("b")
        with pytest.raises(CrashInjected):
            crashpoint("a")
        crashpoint("a")
    finally:
        uninstall()
    install(FaultPlan(crash_points=("a",)))
    uninstall()
    crashpoint("a")


class _FakeEngine:
    def __init__(self):
        self.calls = []

    def generate(self, prompts, max_new, eos=-1):
        self.calls.append((prompts, max_new, eos))
        return "tokens"


def test_faulty_engine_passthrough_when_benign():
    eng = _FakeEngine()
    fe = wrap_engine(eng, FaultPlan())
    assert fe.generate("p", 4) == "tokens"
    assert eng.calls == [("p", 4, -1)]
    assert fe.stats == {"delayed": 0, "dropped": 0, "transient": 0}


def test_faulty_engine_injects_per_request():
    eng = _FakeEngine()
    fe = wrap_engine(eng, FaultPlan(seed=3, dropout=0.3, straggler=0.3,
                                    transient=0.3), time_scale=1e-6)
    ok = 0
    for _ in range(60):
        try:
            fe.generate("p", 1)
            ok += 1
        except (DroppedRequest, TransientServeError):
            pass
    assert fe.stats["dropped"] > 0
    assert fe.stats["transient"] > 0
    assert fe.stats["delayed"] > 0
    assert ok == len(eng.calls)
    assert fe.requests == 60


def test_faulty_engine_over_port_engine():
    """The port's sequential Engine on the CPU: a benign plan passes the
    tokens through unchanged, dropout 1.0 loses every request, and the
    same plan fails the same request indices as the reference's wrapper."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, ServeConfig

    cfg = smoke_config("llama3_2_3b")
    model = init_params(cfg, seed=0, device="cpu")
    eng = Engine(cfg, ServeConfig(batch=2, max_seq=32, quantized_kv=True),
                 model)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want = eng.generate(prompts, 4)
    fe = wrap_engine(eng, FaultPlan())
    np.testing.assert_array_equal(fe.generate(prompts, 4), want)
    lost = wrap_engine(eng, FaultPlan(dropout=1.0))
    for _ in range(3):
        with pytest.raises(DroppedRequest):
            lost.generate(prompts, 4)
    assert lost.stats["dropped"] == 3
    spec = dict(seed=5, dropout=0.25, transient=0.25, straggler=0.2)
    fe = wrap_engine(eng, FaultPlan(**spec), time_scale=1e-6)
    jfe = JF.wrap_engine(_FakeEngine(), JF.FaultPlan(**spec),
                         time_scale=1e-6)
    for _ in range(12):
        outcome = []
        for w in (fe, jfe):
            try:
                w.generate(prompts, 2)
                outcome.append("ok")
            except (DroppedRequest, JF.DroppedRequest):
                outcome.append("dropped")
            except (TransientServeError, JF.TransientServeError):
                outcome.append("transient")
        assert outcome[0] == outcome[1]
    assert fe.stats == jfe.stats
