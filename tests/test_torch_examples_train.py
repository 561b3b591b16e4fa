"""Port parity, the training twins: ``examples/torch_quickstart.py``,
``examples/torch_fed_avg.py`` and ``examples/torch_autotune_study.py``
against their references, run at the CI's sizes on the CPU. The reference
side runs in-process: the quickstart's loop through ``repro.train``, and
the reference example modules' own functions for fed_avg and the autotune
study (their ``run_fed_avg`` / ``run_fleet_rounds`` wrapped to keep each
run's history). Both packages start from the reference's numbers (the
train state by ``train_state_from_jax``, the toy task's parameters by
``params_tree_from_jax``, the smoke llama by ``params_from_jax``).

Tolerances and why (those of ``tests/test_torch_train.py`` and
``tests/test_torch_fl.py``):
- every loss within rtol=1e-4: torch and XLA sum the f32 matmuls in other
  orders, and over a few steps an element can fall on the other side of an
  F2P rounding boundary and take the neighbouring code;
- wire bytes per round, the rounds the policy was re-solved at, the
  fleet's drop / quarantine / commit counts, the quickstart's telemetry
  snapshot (F2P-LI counters over exact host counts) and part 1 of the
  autotune study (numpy): EQUAL;
- the FL and KV tensors the autotune study calibrates: within rtol=1e-4,
  atol=1e-6 (f32 work in another order again);
- every acceptance PASSes on both sides; the quickstart's second run
  resumes from the first run's last step in both packages.
"""
import contextlib
import io
import sys

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _examples import load_reference, load_twin

import repro.fl as JFL
from repro.configs import smoke_config as jsmoke
from repro.data import DataConfig as JDataConfig
from repro.data import host_batch as jhost_batch
from repro.models import init_params as jinit_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import CompressionConfig as JCompressionConfig
from repro.telemetry import FlowStats as JFlowStats
from repro.train import checkpoint as jckpt
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import smoke_config
from repro_torch.fl import toy_task
from repro_torch.models.convert import (params_from_jax, params_tree_from_jax,
                                        train_state_from_jax)

CPU = torch.device("cpu")
RTOL = 1e-4


def _quiet(fn, *a, **kw):
    """(fn's result, what it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*a, **kw)
    return res, out.getvalue()


def _recording(fn, store: list):
    def wrapped(*a, **kw):
        store.append(fn(*a, **kw))
        return store[-1]
    return wrapped


def _port_task(np_params):
    """The port's default toy task, started from the reference's
    parameters."""
    cfg, dcfg, loss_fn, _ = toy_task()

    def init(cfg_, seed, device):
        return params_tree_from_jax(np_params, device)

    return cfg, dcfg, loss_fn, init


@pytest.fixture(scope="module")
def toy_params():
    cfg, _, _, init = JFL.toy_task()
    return jax.tree.map(np.asarray, init(cfg, jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
QS_ARGS = ["--small", "--steps", "12", "--ckpt-every", "6", "--batch", "2",
           "--seq", "64"]


def _reference_quickstart(ref, ckpt_dir: str, steps: int) -> dict:
    """examples/quickstart.py's main loop through repro.train (``--small
    --batch 2 --seq 64 --ckpt-every 6``), keeping every loss."""
    cfg = ref.model_small()
    ocfg = JAdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps)
    ccfg = JCompressionConfig(enabled=True)
    dcfg = JDataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2)
    flows = JFlowStats(["tokens_in", "steps", "checkpoints"])
    start = jckpt.latest_step(ckpt_dir)
    state = jinit_train_state(cfg, ocfg, ccfg, jax.random.PRNGKey(0))
    init_np = jax.tree.map(np.asarray, state)
    if start is not None:
        state, start = jckpt.restore(ckpt_dir, state)
    else:
        start = 0
    step_fn = jax.jit(jmake_train_step(cfg, ocfg, ccfg))
    losses = []
    for step in range(start, steps):
        batch = jhost_batch(dcfg, step)
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
        flows.add("tokens_in", 2 * 64)
        flows.add("steps")
        if step > 0 and step % 6 == 0:
            jckpt.save(ckpt_dir, step, state, compress=True)
            flows.add("checkpoints")
    jckpt.save(ckpt_dir, steps, state, compress=True)
    return {"start": start, "losses": losses, "telemetry": flows.snapshot(),
            "init": init_np}


def test_quickstart_twin_trains_and_resumes_as_the_reference(tmp_path):
    ref, twin = load_reference("quickstart"), load_twin("torch_quickstart")
    want = _reference_quickstart(ref, str(tmp_path / "ref"), 12)
    cfg = twin.model_small()
    assert cfg.param_count() == ref.model_small().param_count()
    args = twin.parse_args(QS_ARGS + ["--ckpt-dir", str(tmp_path / "port"),
                                      "--device", "cpu"])
    state = train_state_from_jax(want["init"], cfg, CPU)
    got, out = _quiet(twin.train, args, device=CPU, state=state)
    assert got["start"] == 0 and len(got["losses"]) == 12
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    assert got["telemetry"] == want["telemetry"]
    assert f"telemetry (F2P-LI counters): {want['telemetry']}" in out
    assert out.rstrip().endswith("done.")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())

    # a second run resumes from the first run's last step, in both
    want2 = _reference_quickstart(ref, str(tmp_path / "ref"), 14)
    args2 = twin.parse_args(QS_ARGS[:1] + ["--steps", "14"] + QS_ARGS[3:] +
                            ["--ckpt-dir", str(tmp_path / "port"),
                             "--device", "cpu"])
    got2, out2 = _quiet(twin.train, args2, device=CPU)
    assert got2["start"] == want2["start"] == 12
    assert "resumed from step 12" in out2
    np.testing.assert_allclose(got2["losses"], want2["losses"], rtol=RTOL)
    assert got2["telemetry"] == want2["telemetry"]


def test_quickstart_twin_default_ckpt_dir_is_its_own():
    twin = load_twin("torch_quickstart")
    d = twin.parse_args([]).ckpt_dir
    assert d.endswith("repro_torch_quickstart_ckpt")
    assert d != "/tmp/repro_quickstart_ckpt"


# ---------------------------------------------------------------------------
# fed_avg
# ---------------------------------------------------------------------------
def _run_fed_avg_example(monkeypatch, mod, fn, *a, **kw):
    """``fn(*a, **kw)`` of example module ``mod``, keeping the history of
    every FL driver run it makes: (result, histories, report)."""
    runs: list = []
    for name in ("run_fed_avg", "run_fleet_rounds"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, _recording(getattr(mod, name),
                                                      runs))
    res, out = _quiet(fn, *a, **kw)
    return res, runs, out


def _reference_fed_avg(monkeypatch, argv: list):
    """examples/fed_avg.py's main() on ``argv``."""
    ref = load_reference("fed_avg")
    monkeypatch.setattr(sys, "argv", ["fed_avg.py"] + argv)
    return _run_fed_avg_example(monkeypatch, ref, ref.main)


def _twin_fed_avg(monkeypatch, argv: list, toy_params, entry: str):
    twin = load_twin("torch_fed_avg")
    args = twin.parse_args(argv + ["--device", "cpu"])
    return _run_fed_avg_example(monkeypatch, twin, getattr(twin, entry), args,
                                device=CPU, task=_port_task(toy_params))


def test_fed_avg_twin_matches_reference(monkeypatch, toy_params):
    argv = ["--rounds", "4", "--clients", "2"]
    rc_ref, ref_runs, ref_out = _reference_fed_avg(monkeypatch, argv)
    rc, runs, out = _twin_fed_avg(monkeypatch, argv, toy_params,
                                  "run_comparison")
    assert rc == rc_ref == 0
    for line in ("acceptance (>=3.5x wire, <=1.05x loss): PASS",
                 "acceptance (packed: >=20% wire drop, <=1.001x f2p8 loss): "
                 "PASS"):
        assert line in out and line in ref_out
    assert len(runs) == len(ref_runs) == 3     # f32, f2p8, packed-mixed
    for name, got, want in zip(("f32", "f2p8", "packed-mixed"), runs,
                               ref_runs):
        assert got["wire_bytes_per_round"] == want["wire_bytes_per_round"], \
            name
        np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                                   rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(got["client_loss"], want["client_loss"],
                                   rtol=RTOL, err_msg=name)
        assert got["resolve_rounds"] == want["resolve_rounds"], name
    # the report's byte lines are the reference's text
    wire_line = [ln for ln in out.splitlines() if "wire bytes/round" in ln]
    assert wire_line and wire_line[0] in ref_out


def test_fed_avg_twin_chaos_small_matches_reference(monkeypatch, toy_params):
    argv = ["--faults", "chaos-small", "--rounds", "3"]
    rc_ref, ref_runs, ref_out = _reference_fed_avg(monkeypatch, argv)
    rc, runs, out = _twin_fed_avg(monkeypatch, argv, toy_params, "run_chaos")
    assert rc == rc_ref == 0
    line = "acceptance (<=1.05x fault-free loss, finite model): PASS"
    assert line in out and line in ref_out
    assert len(runs) == len(ref_runs) == 2     # fault-free, faulted
    for got, want in zip(runs, ref_runs):
        np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                                   rtol=RTOL)
        for k in ("committed", "admitted", "late_folded", "dropped",
                  "failed", "quarantined", "dup_skipped", "expired",
                  "retries", "wire_bytes_per_round"):
            assert list(got[k]) == list(want[k]), k
    counts = [ln for ln in out.splitlines() if "faulted run:" in ln]
    assert counts and counts[0] in ref_out


# ---------------------------------------------------------------------------
# autotune_study --quick
# ---------------------------------------------------------------------------
def test_autotune_study_twin_matches_reference(monkeypatch, toy_params):
    ref, twin = load_reference("autotune_study"), load_twin(
        "torch_autotune_study")
    _, ref_p1 = _quiet(ref.part1_range_sweep)
    _, p1 = _quiet(twin.part1_range_sweep)
    assert p1 == ref_p1

    jmcfg = jsmoke("llama3_2_3b")
    jmp = jinit_params(jmcfg, jax.random.PRNGKey(1))
    jtoks = jax.random.randint(jax.random.PRNGKey(2), (2, 16), 0,
                               jmcfg.vocab_size)
    want_t = ref.collect_tensors(True)
    got_t = twin.collect_tensors(
        True, device=CPU, fl_params=params_tree_from_jax(toy_params, CPU),
        kv_model=params_from_jax(jax.tree.map(np.asarray, jmp),
                                 smoke_config("llama3_2_3b"), CPU),
        kv_tokens=np.asarray(jtoks))
    assert list(got_t) == list(want_t)
    for k in want_t:
        np.testing.assert_allclose(got_t[k], want_t[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)

    ok2_ref, ref_p2 = _quiet(ref.part2_policy_vs_single, want_t, True)
    ok2, out2 = _quiet(twin.part2_policy_vs_single, got_t, True)
    assert ok2 and ok2_ref
    line = "acceptance (policy beats best single at equal budget): PASS"
    assert line in out2 and line in ref_p2
    budget = [ln for ln in out2.splitlines() if "policy (" in ln][0]
    assert budget.split(" rel-MSE")[0] in ref_p2   # leaves, bits, budget

    ref_runs: list = []
    monkeypatch.setattr(JFL, "run_fed_avg",
                        _recording(JFL.run_fed_avg, ref_runs))
    ok3_ref, ref_p3 = _quiet(ref.part3_fl_tradeoff, True)
    (ok3, runs, out3) = _run_fed_avg_example(
        monkeypatch, twin, twin.part3_fl_tradeoff, True, device=CPU,
        task=_port_task(toy_params))
    assert ok3 and ok3_ref
    line = "acceptance (wire <= fixed, loss <= 1.02x fixed): PASS"
    assert line in out3 and line in ref_p3
    assert len(runs) == len(ref_runs) == 2     # fixed, autotuned
    for name, got, want in zip(("fixed", "autotuned"), runs, ref_runs):
        assert got["wire_bytes_per_round"] == want["wire_bytes_per_round"]
        np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                                   rtol=RTOL, err_msg=name)
        assert got["resolve_rounds"] == want["resolve_rounds"]
