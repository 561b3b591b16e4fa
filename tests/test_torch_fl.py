"""Port parity, federated learning: ``repro_torch.fl`` (client, float
server, both round drivers) against the JAX reference's ``repro.fl`` at the
reference tests' toy size, both packages started from the same parameters
(``models.convert.params_tree_from_jax``).

Tolerances and why:
- ``_quantize_delta`` on the same f32 delta and residuals: BITWISE (codes,
  packed words, scales, residuals): the codec is integer work plus one
  IEEE-rounded divide;
- one client round from the same parameters and batches: losses and the
  delta within rtol=1e-5, atol=1e-6, because torch and XLA sum the f32
  matmuls in other orders;
- the float server's ``aggregate`` / ``apply_update`` on the same updates:
  1e-6; ``wire_bytes`` equal;
- whole runs: eval loss per round within rtol=1e-4 (the matmul order
  again, carried through a few rounds; an element can fall on the other
  side of an F2P rounding boundary and take the neighbouring code); wire
  bytes, the solved policy, the fleet's per-round accounting and the obs
  registries' counts EQUAL.
The second half holds the reference's own invariants
(``tests/test_fl_fleet.py``) inside the port, on the CPU.
"""
import dataclasses

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.autotune import policy as JP
from repro.core import qtensor as JQT
from repro.core.formats import format_name as jformat_name
from repro.faults import FaultPlan as JFaultPlan
from repro.faults import named_plan as jnamed_plan
from repro.fl import client as JC
from repro.fl import rounds as JR
from repro.fl import server as JS
from repro_torch.autotune import policy as P
from repro_torch.core.qtensor import QTensor
from repro_torch.faults import FaultPlan, named_plan
from repro_torch.fl import (AutotuneConfig, ClientConfig, FedAvgConfig,
                            FleetConfig, run_fed_avg, run_fleet_rounds,
                            toy_task)
from repro_torch.fl import client as C
from repro_torch.fl import rounds as R
from repro_torch.fl import server as S
from repro_torch.fl._tree import leaves, to_numpy
from repro_torch.models.convert import params_tree_from_jax, update_from_jax

TINY = dict(d_model=32, n_layers=1, vocab=128, seq_len=8, batch=2)
CPU = "cpu"


@pytest.fixture(scope="module")
def ref():
    """The reference's TINY task and initial parameters (numpy)."""
    jtask = JR.toy_task(**TINY)
    cfg, _, _, init = jtask
    jparams = init(cfg, jax.random.PRNGKey(0))
    return jtask, jparams, jax.tree.map(np.asarray, jparams)


def _task(np_params=None):
    """The port's TINY task; with ``np_params`` its init returns the
    reference's initial parameters (for the whole-run parity tests)."""
    cfg, dcfg, loss_fn, init = toy_task(**TINY)
    if np_params is not None:
        def init(cfg_, seed, device):
            return params_tree_from_jax(np_params, device)
    return cfg, dcfg, loss_fn, init


def _jccfg(ccfg):
    """The reference's ClientConfig with the port's fields (the policy
    carried by its rules)."""
    kw = {f.name: getattr(ccfg, f.name) for f in dataclasses.fields(ccfg)}
    kw["fmt"] = JC.FL_FMT
    assert ccfg.fmt == C.FL_FMT
    if ccfg.policy is not None:
        kw["policy"] = JP.FormatPolicy(
            rules=tuple(JP.PolicyRule(r.pattern, r.fmt, r.block)
                        for r in ccfg.policy.rules),
            default_fmt=ccfg.policy.default_fmt,
            default_block=ccfg.policy.default_block)
    return JC.ClientConfig(**kw)


def _parts(x):
    if isinstance(x, dict):
        return {k: _parts(v) for k, v in x.items()}
    if isinstance(x, JQT.QTensor):
        return (np.asarray(x.codes), np.asarray(x.scales),
                jformat_name(x.fmt), x.block, x.shape, x.packed)
    return None if x is None else np.asarray(x)


def _same_update(port, jtree):
    """Every QTensor's codes / words and scales and every raw leaf equal,
    bitwise, leaf for leaf in the reference's order."""
    got = leaves(port)
    want = jax.tree.leaves(jtree, is_leaf=lambda x: isinstance(x,
                                                               JQT.QTensor))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, QTensor) == isinstance(w, JQT.QTensor)
        if isinstance(g, QTensor):
            assert (jformat_name(w.fmt), w.block, tuple(w.shape), w.packed) \
                == (P.format_name(g.fmt), g.block, tuple(g.shape), g.packed)
            pairs = ((g.codes, w.codes), (g.scales, w.scales))
        else:
            pairs = ((g, w),)
        for a, b in pairs:
            a, b = to_numpy(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _policy_6_8():
    """A per-leaf policy with 6- and 8-bit formats at several blocks."""
    rules = (("blocks/b0/ff/*", "f2p_sr_1_6s", 64),
             ("blocks/b0/mixer/wk", "f2p_lr_1_6s", 128),
             ("embed", "f2p_sr_2_8s", 32),
             ("lm_head", "f2p_lr_2_6s", 128))
    return P.FormatPolicy(rules=tuple(P.PolicyRule(*r) for r in rules))


# ---------------------------------------------------------------------------
# parity: the client's quantized delta, bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("scale_mode", ["f32", "pow2"])
def test_quantize_delta_bitwise(ref, scale_mode, packed, policy):
    _, _, np_params = ref
    ccfg = ClientConfig(min_size=512, scale_mode=scale_mode, packed=packed,
                        policy=_policy_6_8() if policy else None)
    rng = np.random.default_rng(17)
    delta = jax.tree.map(
        lambda p: (rng.normal(0, 1e-3, p.shape)
                   * rng.uniform(0.1, 10.0, p.shape[:-1] + (1,))
                   ).astype(np.float32), np_params)
    jres = JC.init_client_residuals(np_params, _jccfg(ccfg))
    jres = jax.tree.map(
        lambda r: (rng.normal(0, 1e-5, r.shape).astype(np.float32)),
        jres)
    want_u, want_r = JC._quantize_delta(
        jax.tree.map(jnp.asarray, delta), jres, _jccfg(ccfg))
    got_u, got_r = C._quantize_delta(
        params_tree_from_jax(delta, CPU), params_tree_from_jax(
            jax.tree.map(np.asarray, jres), CPU), ccfg)
    _same_update(got_u, want_u)
    # residuals: the same leaves carry one (compressed ones), bitwise
    _same_update(got_r, want_r)
    assert sum(isinstance(x, QTensor) for x in leaves(got_u)) == 9
    assert len(leaves(got_r)) == 9


def test_leaf_formats_cap_blocks_at_last_dim(ref):
    _, _, np_params = ref
    ccfg = ClientConfig(min_size=512, policy=_policy_6_8())
    got = C.leaf_formats(params_tree_from_jax(np_params, CPU), ccfg)
    want = JC.leaf_formats(jax.tree.map(jnp.asarray, np_params),
                           _jccfg(ccfg))
    assert [(p, P.format_name(f), b) for p, f, b in got] == \
        [(p, jformat_name(f), b) for p, f, b in want]
    blocks = {p: b for p, _, b in got}
    assert blocks["blocks/b0/mixer/wk"] == 16        # capped: last dim 16
    assert blocks["blocks/b0/ff/down"] == 32


# ---------------------------------------------------------------------------
# parity: one client round
# ---------------------------------------------------------------------------
def test_one_client_round_matches_reference(ref):
    (jcfg, jdcfg, jloss, _), jparams, np_params = ref
    ccfg = ClientConfig(local_steps=2, compress=False)
    jbatches = JR._client_stream(jdcfg, 2, 1, 5)
    jfn = jax.jit(JC.make_client_update(jloss, _jccfg(ccfg)))
    want_u, _, want_l = jfn(jparams, JC.init_client_residuals(
        jparams, _jccfg(ccfg)), jbatches)
    cfg, dcfg, loss_fn, _ = _task()
    params = params_tree_from_jax(np_params, CPU)
    fn = C.make_client_update(loss_fn, ccfg)
    got_u, _, got_l = fn(params, C.init_client_residuals(params, ccfg),
                         R._client_stream(dcfg, 2, 1, 5))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(leaves(got_u), jax.tree.leaves(want_u)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert max(float(np.abs(np.asarray(w)).max())
               for w in jax.tree.leaves(want_u)) > 1e-4   # it moved


# ---------------------------------------------------------------------------
# parity: the float server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("packed", [False, True])
def test_float_server_matches_reference(ref, packed):
    _, _, np_params = ref
    ccfg = ClientConfig(min_size=512, packed=packed, error_feedback=False)
    rng = np.random.default_rng(3)
    jups, ups = [], []
    for _ in range(4):
        delta = jax.tree.map(lambda p: rng.normal(
            0, 1e-3, p.shape).astype(np.float32), np_params)
        ju, _ = JC._quantize_delta(jax.tree.map(jnp.asarray, delta),
                                   jax.tree.map(lambda p: None, np_params),
                                   _jccfg(ccfg))
        jups.append(ju)
        ups.append(update_from_jax(_parts(ju)))
        assert S.wire_bytes(ups[-1]) == JS.wire_bytes(ju)
    for w in (None, [1.0, 2.0, 0.5, 3.0]):
        want = JS.aggregate(jups, w)
        got = S.aggregate(ups, w)
        for g, x in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-6,
                                       atol=1e-9)
    new = S.apply_update(params_tree_from_jax(np_params, CPU), got, 0.7)
    jnew = JS.apply_update(jax.tree.map(jnp.asarray, np_params), want, 0.7)
    for g, x in zip(leaves(new), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-6,
                                   atol=1e-9)


# ---------------------------------------------------------------------------
# parity: whole runs
# ---------------------------------------------------------------------------
def _counts(reg):
    ex = reg.export()
    return ({k: v["exact"] for k, v in ex["counters"].items()},
            {k: v["count"] for k, v in ex["histograms"].items()})


_FEDAVG = {
    "f2p8": (dict(local_steps=2), None),
    "packed-autotuned": (dict(local_steps=2, packed=True),
                         # 6.5 as examples/fed_avg.py is infeasible at
                         # TINY (a 64-wide block's scale costs 0.5 bit)
                         dict(every=2, n_bits=(6, 8),
                              budget_bits_per_elem=7.0)),
}


@pytest.mark.parametrize("name", list(_FEDAVG))
def test_run_fed_avg_matches_reference(ref, name):
    jtask, _, np_params = ref
    ckw, akw = _FEDAVG[name]
    ccfg = ClientConfig(**ckw)
    fcfg = FedAvgConfig(rounds=3, client=ccfg, autotune=None if akw is None
                        else AutotuneConfig(**akw))
    jfcfg = JR.FedAvgConfig(rounds=3, client=_jccfg(ccfg),
                            autotune=None if akw is None
                            else JR.AutotuneConfig(**akw))
    want = JR.run_fed_avg(jfcfg, jtask)
    got = run_fed_avg(fcfg, _task(np_params), device=CPU)
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["client_loss"], want["client_loss"],
                               rtol=1e-4)
    assert got["wire_bytes_per_round"] == want["wire_bytes_per_round"]
    assert got["resolve_rounds"] == want["resolve_rounds"]
    if akw is None:
        assert got["policy"] is None and want["policy"] is None
    else:
        assert got["policy"].to_dict() == want["policy"].to_dict()
        assert {r.fmt for r in got["policy"].rules} & {"f2p_sr_1_6s",
                                                       "f2p_lr_1_6s"}
        assert got["wire_bytes_per_round"][-1] < \
            got["wire_bytes_per_round"][0]
    assert _counts(R._REGS["fl.fedavg"]) == _counts(JR._REGS["fl.fedavg"])


def _cfg(pkg="port", **kw):
    ccfg = kw.pop("client", ClientConfig(local_steps=1, scale_mode="pow2",
                                         error_feedback=False, packed=True,
                                         min_size=512))
    base = dict(n_clients=40, sample=16, quorum=8, rounds=2, client=ccfg,
                client_batch=8)
    base.update(kw)
    if pkg == "jax":
        base["client"] = _jccfg(ccfg)
        return JR.FleetConfig(**base)
    return FleetConfig(**base)


_ACCOUNTING = ("committed", "admitted", "late_folded", "dropped", "failed",
               "retries", "dup_skipped", "expired", "quarantined",
               "wire_bytes_per_round", "sim_time")


_FLEET_PLANS = {
    "chaos-small": "chaos-small",
    # a bit flipped in a scale's exponent passes the gate and overflows the
    # exact fold: the reference raises, so must the port, at the same fold
    "corrupt": "corrupt",
    "nan-dup-reorder": dict(seed=11, nan_delta=0.3, duplicate=0.3,
                            reorder=True, straggler=0.2,
                            straggler_delay=10.0),
}


@pytest.mark.parametrize("plan", list(_FLEET_PLANS))
def test_run_fleet_rounds_matches_reference(ref, plan):
    from repro.fl.exact import AggregationOverflow as JOverflow
    from repro_torch.fl.exact import AggregationOverflow

    jtask, _, np_params = ref
    spec = _FLEET_PLANS[plan]
    jplan, pplan = ((jnamed_plan(spec), named_plan(spec))
                    if isinstance(spec, str)
                    else (JFaultPlan(**spec), FaultPlan(**spec)))
    kw = dict(n_clients=64, sample=32, quorum=8, rounds=2)
    try:
        want = JR.run_fleet_rounds(_cfg("jax", **kw), jtask, faults=jplan)
    except JOverflow as e:
        with pytest.raises(AggregationOverflow) as ei:
            run_fleet_rounds(_cfg(**kw), _task(np_params), faults=pplan,
                             device=CPU)
        assert str(ei.value) == str(e)
        return
    got = run_fleet_rounds(_cfg(**kw), _task(np_params), faults=pplan,
                           device=CPU)
    for key in _ACCOUNTING:
        assert got[key] == want[key], key
    assert sum(got["quarantined"]) > 0
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                               rtol=1e-4)
    assert _counts(R._REGS["fl.fleet"]) == _counts(JR._REGS["fl.fleet"])
    h = R._REGS["fl.fleet"]["arrival_lag_s"]
    jh = JR._REGS["fl.fleet"]["arrival_lag_s"]
    assert h.quantile(0.99, exact=True) == jh.quantile(0.99, exact=True)


# ---------------------------------------------------------------------------
# the reference's invariants, inside the port
# ---------------------------------------------------------------------------
def _run(flcfg, faults=None):
    return run_fleet_rounds(flcfg, _task(), faults=faults, device=CPU)


def _params_bits_equal(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        np.testing.assert_array_equal(to_numpy(x).view(np.uint8),
                                      to_numpy(y).view(np.uint8))


@pytest.fixture(scope="module")
def clean():
    return _run(_cfg())


def test_reorder_and_duplicates_bit_identical_to_benign(clean):
    noisy = _run(_cfg(), FaultPlan(seed=5, duplicate=0.5, reorder=True))
    assert noisy["dup_skipped"] and sum(noisy["dup_skipped"]) > 0
    assert all(noisy["committed"])
    _params_bits_equal(clean["params"], noisy["params"])
    assert clean["eval_loss"] == noisy["eval_loss"]


@pytest.mark.parametrize("width", [1, 4, 16])
def test_client_batch_cannot_change_bits(clean, width):
    other = _run(_cfg(client_batch=width))
    _params_bits_equal(clean["params"], other["params"])


def test_quorum_not_met_model_stands_still():
    flcfg = _cfg(rounds=1, quorum=17)    # quorum > sample: never commits
    hist = _run(flcfg)
    assert hist["committed"] == [False]
    cfg, _, _, init = _task()
    _params_bits_equal(init(cfg, flcfg.seed, CPU), hist["params"])


def test_uncommitted_arrivals_refold_next_round_with_staleness():
    plan = FaultPlan(seed=1, straggler=1.0, straggler_delay=50.0)
    hist = _run(_cfg(rounds=2, deadline=3.0), plan)
    assert hist["committed"][0] is False
    assert hist["late_folded"][1] > 0
    assert hist["committed"][1] is True


def test_expiry_drops_arrivals_past_max_staleness():
    plan = FaultPlan(seed=1, straggler=1.0, straggler_delay=50.0)
    hist = _run(_cfg(rounds=3, deadline=3.0, max_staleness=0), plan)
    assert sum(hist["expired"]) > 0
    assert not any(hist["committed"])


@pytest.mark.parametrize("dropout,straggler,nan_delta", [
    (0.3, 0.0, 0.0),
    (0.0, 0.4, 0.0),
    (0.0, 0.0, 0.3),
    (0.2, 0.2, 0.15),
])
def test_fault_matrix_accounting_and_finite_model(dropout, straggler,
                                                  nan_delta):
    plan = FaultPlan(seed=11, dropout=dropout, straggler=straggler,
                     straggler_delay=20.0, nan_delta=nan_delta)
    flcfg = _cfg(rounds=1, quorum=1)
    hist = _run(flcfg, plan)
    emitted = flcfg.sample - hist["dropped"][0] - hist["failed"][0]
    on_time = hist["admitted"][0] + hist["quarantined"][0]
    assert on_time <= emitted
    if dropout:
        assert hist["dropped"][0] > 0
    if straggler:
        assert on_time < emitted
    if nan_delta:
        assert hist["quarantined"][0] > 0
    for leaf in leaves(hist["params"]):
        assert bool(torch.isfinite(leaf).all())
    assert np.isfinite(hist["eval_loss"][0])


def test_chaos_convergence_within_tolerance():
    flcfg = _cfg(n_clients=64, sample=32, quorum=8, rounds=2)
    clean_run = _run(flcfg)
    chaos = _run(flcfg, named_plan("chaos-small"))
    assert chaos["eval_loss"][-1] <= 1.05 * clean_run["eval_loss"][-1]
    for leaf in leaves(chaos["params"]):
        assert bool(torch.isfinite(leaf).all())


def test_client_stream_pure_in_client_and_round(ref):
    (_, jdcfg, _, _), _, _ = ref
    _, dcfg, _, _ = _task()
    a = R._client_stream(dcfg, 2, round_i=1, client_id=7)
    b = R._client_stream(dcfg, 2, round_i=1, client_id=7)
    for k in a:
        assert torch.equal(a[k], b[k])
        np.testing.assert_array_equal(
            a[k].numpy(), np.asarray(JR._client_stream(jdcfg, 2, 1, 7)[k]))
    c = R._client_stream(dcfg, 2, round_i=1, client_id=8)
    d = R._client_stream(dcfg, 2, round_i=2, client_id=7)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])


def test_client_stream_disjoint_from_eval_batch():
    from repro_torch.data import global_batch

    _, dcfg, _, _ = _task()
    ev = global_batch(dcfg, 1_000_003)
    for cid in (0, 1, 500):
        s = R._client_stream(dcfg, 2, round_i=0, client_id=cid)
        for step in range(2):
            assert not np.array_equal(s["tokens"][step].numpy(),
                                      ev["tokens"])


def test_fleet_wire_bytes_use_canonical_packed_accounting(clean):
    flcfg = _cfg(rounds=1)
    hist = _run(flcfg)
    cfg, dcfg, loss_fn, init = _task()
    params = init(cfg, flcfg.seed, CPU)
    ccfg = flcfg.client
    fn = C.make_client_update(loss_fn, ccfg)
    upd, _, _ = fn(params, C.init_client_residuals(params, ccfg),
                   R._client_stream(dcfg, ccfg.local_steps, 0, 0))
    per_client = S.wire_bytes(upd)
    assert hist["wire_bytes_per_round"][0] == per_client * hist["admitted"][0]
    assert hist["wire_bytes_per_round"][0] == clean["wire_bytes_per_round"][0]


def test_fed_avg_spans_and_compression_on_cpu():
    """fl.compute / fl.client spans and fl.round events reach the tracer;
    f2p8 wire bytes are ~3.9x below f32's."""
    from repro_torch import obs

    obs.enable()
    try:
        f2p8 = run_fed_avg(FedAvgConfig(rounds=1), _task(), device=CPU)
        names = {e["name"] for e in obs.get().tracer.events}
    finally:
        obs.disable()
    f32 = run_fed_avg(FedAvgConfig(rounds=1, client=ClientConfig(
        compress=False)), _task(), device=CPU)
    assert {"fl.compute", "fl.client", "fl.round"} <= names
    ratio = f32["wire_bytes_per_round"][0] / f2p8["wire_bytes_per_round"][0]
    assert ratio > 3.0
    assert R._REGS["fl.fedavg"]["rounds"].exact == 1
