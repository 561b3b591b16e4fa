"""Port parity, training path: ``repro_torch`` against the JAX reference on
the smoke llama3.2-3b config in f32, both started from the same numbers
(``train_state_from_jax``).

Tolerances and why:
- the codec, the compression round trip, the data pipeline and the
  checkpoint files are integer work plus one IEEE-rounded divide:
  BITWISE (codes, residuals, bytes);
- the train forward's loss and gradients: 1e-4 relative, because XLA and
  torch sum the matmuls and reductions in other orders;
- one AdamW update on identical inputs: 1e-6 relative to each leaf's
  largest magnitude (the same f32 ops, but the global norm is summed in
  another order, so the clip scale may differ by an ulp, and an element
  where p - lr * delta cancels carries that ulp as a larger relative
  error of its own);
- three train steps: each parameter leaf within 1e-4 relative in norm
  (||port - jax|| / ||jax||). Elementwise, AdamW's normalized update
  amplifies differences of nearly cancelling gradient sums (summed in other
  orders), and with compression two nearly equal gradients can fall on
  either side of an F2P8 rounding boundary and take neighbouring codes;
  such an element moves by up to lr more or less. Held as well: at most
  0.1% of the elements outside 1e-4 relative, none further than 3 x lr.
Inside the port, restarting from a checkpoint is bitwise (the reference's
own test is the model).
"""
import dataclasses
import json
import os
import threading

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import default_policy as jdefault_policy
from repro.configs import smoke_config as jsmoke
from repro.data import DataConfig as JDataConfig
from repro.data import global_batch as jglobal_batch
from repro.data import host_batch as jhost_batch
from repro.models import train_forward as jtrain_forward
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import CompressionConfig as JCompressionConfig
from repro.optim import apply_updates as japply_updates
from repro.optim import compress_decompress as jcompress
from repro.train import checkpoint as jckpt
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.autotune.policy import FormatPolicy, path_from_keystr
from repro_torch.configs import default_policy, smoke_config
from repro_torch.core.formats import named_format
from repro_torch.data import DataConfig, global_batch, host_batch
from repro_torch.faults import CrashInjected, FaultPlan, active
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import (named_from_jax, reference_path,
                                        train_state_from_jax)
from repro_torch.optim import (AdamWConfig, CompressionConfig,
                               apply_updates, compress_decompress,
                               compressed_psum, init_residuals)
from repro_torch.train import (checkpoint, init_train_state, loss_and_grads,
                               make_train_step)
from repro_torch.train.async_ckpt import AsyncCheckpointer

CPU = torch.device("cpu")
OCFG = dict(lr=1e-3, warmup_steps=5, total_steps=100)
DCFG = dict(vocab_size=512, seq_len=32, global_batch=8)


def _ccfg(pkg, **kw):
    if pkg == "jax":
        return JCompressionConfig(**kw)
    return CompressionConfig(**kw)


def _jax_state(min_size=512, seed=0, remat=False):
    jcfg = dataclasses.replace(jsmoke("llama3_2_3b"), remat=remat)
    st = jinit_train_state(jcfg, JAdamWConfig(**OCFG),
                           _ccfg("jax", min_size=min_size),
                           jax.random.PRNGKey(seed))
    return jcfg, st


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(np_state, remat=False):
    cfg = dataclasses.replace(smoke_config("llama3_2_3b"), remat=remat)
    return cfg, train_state_from_jax(np_state, cfg, CPU)


def _ref_leaf(tree, name):
    path, layer = reference_path(name, 1)
    a = tree
    for k in path:
        a = a[k]
    return np.asarray(a if layer is None else a[layer])


def _assert_named_close(named, tree, rtol, atol=0.0, leaf_rel=False):
    """Elementwise within rtol (+ atol); with ``leaf_rel`` the absolute
    slack is rtol times the leaf's largest magnitude."""
    for name, t in named.items():
        want = _ref_leaf(tree, name)
        if leaf_rel:
            atol = rtol * float(np.abs(want).max())
        np.testing.assert_allclose(t.detach().numpy(), want, rtol=rtol,
                                   atol=atol, err_msg=name)


def _assert_named_equal(named, tree):
    for name, t in named.items():
        np.testing.assert_array_equal(t.detach().numpy(),
                                      _ref_leaf(tree, name), err_msg=name)


def _jbatch(step):
    return {k: jnp.asarray(v)
            for k, v in jglobal_batch(JDataConfig(**DCFG), step).items()}


def _tbatch(step):
    return {k: torch.from_numpy(v)
            for k, v in global_batch(DataConfig(**DCFG), step).items()}


# ---------------------------------------------------------------------------
# data, policy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 7])
def test_host_and_global_batch_equal_reference(step):
    for kw in (DCFG, dict(vocab_size=128256, seq_len=128, global_batch=8)):
        want = jglobal_batch(JDataConfig(**kw), step)
        got = global_batch(DataConfig(**kw), step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
        for i in range(2):
            w = jhost_batch(JDataConfig(**kw), step, process_index=i,
                            process_count=2)
            g = host_batch(DataConfig(**kw), step, process_index=i,
                           process_count=2)
            np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_policy_f2p_for_matches_reference_on_train_state_paths():
    _, st = _jax_state()
    flat, _ = jax.tree_util.tree_flatten_with_path(st)
    jpol, pol = jdefault_policy("llama3_2_3b"), default_policy("llama3_2_3b")
    names = [jax.tree_util.keystr(p) for p, _ in flat]
    assert len(names) > 20
    fb = (named_format("f2p_sr_2_8s"), 64)
    for name in names:
        path = path_from_keystr(name)
        for dom in ("grad", "ckpt", "fl", "kv", "other"):
            jf, jb = jpol.f2p_for(f"{dom}/{path}", fb)
            tf, tb = pol.f2p_for(f"{dom}/{path}", fb)
            assert (tf.n_bits, tf.h_bits, tf.flavor.value, tf.signed, tb) \
                == (jf.n_bits, jf.h_bits, jf.flavor.value, jf.signed, jb)
    assert pol.to_json() == jpol.to_json()
    assert FormatPolicy.from_json(jpol.to_json()) == pol


# ---------------------------------------------------------------------------
# forward/backward, compression, AdamW, steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [False, True])
def test_train_forward_loss_and_grads_match_jax(remat):
    jcfg, st = _jax_state(remat=remat)
    cfg, state = _port(_np(st), remat=remat)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtrain_forward(p, _jbatch(0), jcfg), has_aux=True)(
            st["params"])
    loss, metrics, grads = loss_and_grads(state["params"], _tbatch(0), cfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["ce_loss"]),
                               float(jm["ce_loss"]), rtol=1e-4)
    assert float(metrics["aux_loss"]) == 0.0
    _assert_named_close(grads, _np(jg), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("min_size,error_feedback",
                         [(512, True), (128, True), (64, False)])
def test_compress_decompress_bitwise(min_size, error_feedback):
    """Identical gradients and residuals -> identical compressed gradients
    and residuals. min_size 128 puts the [2, 96] norms (192 elements
    stacked, 96 per layer) on the compressed side, as the reference's
    stacked leaf sizes say."""
    _, st = _jax_state(min_size=min_size)
    cfg, state = _port(_np(st))
    rng = np.random.default_rng(min_size)
    g_np = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32) * 1e-2, _np(st["params"]))
    r_np = jax.tree.map(lambda r: None if r is None else rng.normal(
        size=r.shape).astype(np.float32) * 1e-4, _np(st["residuals"]),
        is_leaf=lambda x: x is None)
    kw = dict(min_size=min_size, error_feedback=error_feedback)
    jg, jr = jcompress(jax.tree.map(jnp.asarray, g_np),
                       jax.tree.map(jnp.asarray, r_np), _ccfg("jax", **kw))
    model = state["params"]
    grads = named_from_jax(g_np, model)
    res = named_from_jax(r_np, model)
    assert (res["blocks.0.norm1"] is None) == (min_size > 192)
    cg, cr = compress_decompress(grads, res, _ccfg("torch", **kw),
                                 len(cfg.pattern))
    assert cg is grads and cr is res
    _assert_named_equal(cg, _np(jg))
    _assert_named_equal({k: v for k, v in cr.items() if v is not None},
                        _np(jr))
    assert init_residuals(model, _ccfg("torch", min_size=min_size),
                          len(cfg.pattern)).keys() \
        == res.keys()


def test_error_feedback_carries_residuals():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 16)).astype(np.float32))}
    ccfg = CompressionConfig(enabled=True, min_size=16)
    r = init_residuals(g, ccfg, 1)
    g0 = g["w"].clone()
    gq, r1 = compress_decompress(g, r, ccfg, 1)
    np.testing.assert_allclose(r1["w"].numpy(), (g0 - gq["w"]).numpy(),
                               atol=1e-6)
    gq2, _ = compress_decompress({"w": torch.zeros(8, 16)}, r1, ccfg, 1)
    assert float(gq2["w"].abs().sum()) > 0    # flushed, not dropped
    with pytest.raises(ValueError, match="residual shape"):
        compress_decompress({"w": torch.zeros(8, 8)},
                            {"w": torch.zeros(8, 16)}, ccfg, 1)


def test_apply_updates_matches_jax():
    _, st = _jax_state()
    rng = np.random.default_rng(3)
    npst = _np(st)
    rnd = lambda s, t: jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * s).astype(np.float32), t)
    g = rnd(0.05, npst["params"])
    npst["opt"] = {"mu": rnd(1e-3, npst["params"]),
                   "nu": jax.tree.map(np.abs, rnd(1e-5, npst["params"])),
                   "step": np.int32(4)}
    ocfg = dict(OCFG, warmup_steps=3, total_steps=20)
    jp, jo, jm = japply_updates(jax.tree.map(jnp.asarray, npst["params"]),
                                jax.tree.map(jnp.asarray, g),
                                jax.tree.map(jnp.asarray, npst["opt"]),
                                JAdamWConfig(**ocfg))
    _, state = _port(npst)
    model = state["params"]
    _, opt, m = apply_updates(model, named_from_jax(g, model), state["opt"],
                              AdamWConfig(**ocfg))
    assert int(opt["step"]) == 5
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    _assert_named_close(dict(model.named_parameters()), _np(jp), rtol=1e-6,
                        leaf_rel=True)
    _assert_named_close(opt["mu"], _np(jo["mu"]), rtol=1e-6, leaf_rel=True)
    _assert_named_close(opt["nu"], _np(jo["nu"]), rtol=1e-6, leaf_rel=True)


@pytest.mark.parametrize("enabled", [False, True])
def test_three_train_steps_match_jax(enabled):
    jcfg, st = _jax_state(min_size=64)
    cfg, state = _port(_np(st))
    ocfg = dict(OCFG, warmup_steps=2)
    kw = dict(enabled=enabled, min_size=64)
    jstep = jax.jit(jmake_train_step(jcfg, JAdamWConfig(**ocfg),
                                     _ccfg("jax", **kw)))
    tstep = make_train_step(cfg, AdamWConfig(**ocfg), _ccfg("torch", **kw))
    for i in range(3):
        st, jm = jstep(st, _jbatch(i))
        state, m = tstep(state, _tbatch(i))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    off = total = 0
    for name, t in state["params"].named_parameters():
        got, want = t.detach().numpy(), _ref_leaf(_np(st["params"]), name)
        diff = np.abs(got - want)
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rel <= 1e-4, (name, rel)
        assert diff.max() <= 3 * ocfg["lr"], name
        off += int((diff > 1e-4 * np.abs(want) + 1e-7).sum())
        total += want.size
    assert off <= 1e-3 * total, (off, total)


def test_bf16_remat_train_losses_track_jax():
    """The full-width run's layout at smoke size: bf16 parameters and
    gradients, per-block recomputation, compression on, the CLI's optimizer
    (lr 1e-3, warmup 10). The losses follow JAX's within 1e-4 relative
    for 6 steps (bf16 products summed in other orders)."""
    jcfg = dataclasses.replace(jsmoke("llama3_2_3b"), dtype="bfloat16",
                               remat=True)
    cfg = dataclasses.replace(smoke_config("llama3_2_3b"), dtype="bfloat16",
                              remat=True)
    ocfg = dict(lr=1e-3, warmup_steps=10, total_steps=6)
    st = jinit_train_state(jcfg, JAdamWConfig(**ocfg),
                           _ccfg("jax", min_size=512), jax.random.PRNGKey(0))
    np_st = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32))
                         if x.dtype == jnp.bfloat16 else np.asarray(x), st)
    state = train_state_from_jax(np_st, cfg, CPU)
    assert state["params"].embed.dtype == torch.bfloat16
    jstep = jax.jit(jmake_train_step(jcfg, JAdamWConfig(**ocfg),
                                     _ccfg("jax", min_size=512)))
    tstep = make_train_step(cfg, AdamWConfig(**ocfg),
                            _ccfg("torch", min_size=512))
    dcfg = dict(vocab_size=512, seq_len=64, global_batch=8)
    for i in range(6):
        b = global_batch(DataConfig(**dcfg), i)
        st, jm = jstep(st, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = tstep(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")


def test_compressed_psum_needs_several_cards():
    # the wire path runs over a torch.distributed process group (its W = 2
    # and 4 runs against the reference: tests/test_torch_compressed_psum.py)
    with pytest.raises(RuntimeError, match="process group"):
        compressed_psum(torch.zeros(4, 8), None, CompressionConfig())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _leaves(state):
    out = {"step": state["opt"]["step"].clone()}
    for n, p in state["params"].named_parameters():
        out["p/" + n] = p.detach().clone()
    for k in ("mu", "nu"):
        for n, t in state["opt"][k].items():
            out[f"{k}/{n}"] = t.clone()
    for n, t in state["residuals"].items():
        if t is not None:
            out["r/" + n] = t.clone()
    return out


def _run(n, ccfg, state=None, start=0):
    cfg = smoke_config("llama3_2_3b")
    ocfg = AdamWConfig(**OCFG)
    if state is None:
        state = init_train_state(cfg, ocfg, ccfg, seed=0, device=CPU)
    step = make_train_step(cfg, ocfg, ccfg)
    for i in range(start, start + n):
        state, _ = step(state, _tbatch(i))
    return state


def test_checkpoint_restart_parity_bitwise(tmp_path):
    """train 6 == train 3, save, restore into a fresh state, train 3
    (bitwise on every leaf), as tests/test_train.py's restart test."""
    ccfg = CompressionConfig(enabled=True, min_size=64)
    d = str(tmp_path / "ck")
    a = _leaves(_run(6, ccfg))
    b = _run(3, ccfg)
    checkpoint.save(d, 3, b)
    fresh = init_train_state(smoke_config("llama3_2_3b"), AdamWConfig(),
                             ccfg, seed=1, device=CPU)
    restored, step = checkpoint.restore(d, fresh)
    assert step == 3 and restored is fresh
    before = _leaves(b)
    for k, v in _leaves(restored).items():
        assert torch.equal(v, before[k]), k
    b2 = _leaves(_run(3, ccfg, state=restored, start=3))
    for k, v in a.items():
        assert torch.equal(b2[k], v), k


def _write_both(tmp_path, st, **kw):
    """The same state saved by both packages; returns their step dirs."""
    cfg, state = _port(_np(st))
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jp = {k: v for k, v in kw.items() if k != "policy"}
    if "policy" in kw:
        jp["policy"] = jdefault_policy("llama3_2_3b")
    jckpt.save(dj, 2, st, **jp)
    checkpoint.save(dt, 2, state, **kw)
    return dj, dt, state


_CKPT_CASES = [dict(), dict(compress=True, min_size=64),
               dict(compress=True, min_size=64, packed=True),
               dict(compress=True, min_size=64, block=32, policy=True)]


@pytest.mark.parametrize("kw", _CKPT_CASES,
                         ids=["raw", "f2p16", "f2p16-packed", "policy"])
def test_checkpoint_files_byte_identical_to_jax(tmp_path, kw):
    _, st = _jax_state(min_size=64)
    jcfg = jsmoke("llama3_2_3b")
    st, _ = jax.jit(jmake_train_step(jcfg, JAdamWConfig(**OCFG),
                                     _ccfg("jax", min_size=64)))(
        st, _jbatch(0))
    if kw.get("policy"):
        kw = dict(kw, policy=default_policy("llama3_2_3b"))
    dj, dt, _ = _write_both(tmp_path, st, **kw)
    for f in ("data.bin", "index.json", "COMMITTED") + (
            ("policy.json",) if "policy" in kw else ()):
        with open(os.path.join(dj, "step_2", f), "rb") as a, \
                open(os.path.join(dt, "step_2", f), "rb") as b:
            assert a.read() == b.read(), f
    idx = json.load(open(os.path.join(dt, "step_2", "index.json")))
    codecs = {e["codec"] for e in idx["leaves"].values()}
    assert codecs == ({"raw", "qtensor"} if kw.get("compress") else {"raw"})
    assert checkpoint.load_policy(dt) == (kw.get("policy"))


@pytest.mark.parametrize("kw", _CKPT_CASES[:3],
                         ids=["raw", "f2p16", "f2p16-packed"])
def test_each_package_restores_the_others_checkpoint(tmp_path, kw):
    _, st = _jax_state(min_size=64)
    rng = np.random.default_rng(1)
    st = jax.tree.map(lambda x: x + jnp.asarray(rng.normal(
        size=x.shape).astype(np.float32) * 1e-2) if x.dtype == jnp.float32
        else x, st)
    dj, dt, _ = _write_both(tmp_path, st, **kw)
    # the port restores JAX's files == JAX restoring its own
    jown, _ = jckpt.restore(dj, st)
    _, target = _port(_np(jax.tree.map(jnp.zeros_like, st)))
    got, step = checkpoint.restore(dj, target)
    assert step == 2
    _assert_named_equal(dict(got["params"].named_parameters()),
                        _np(jown["params"]))
    _assert_named_equal(got["opt"]["mu"], _np(jown["opt"]["mu"]))
    _assert_named_equal(got["opt"]["nu"], _np(jown["opt"]["nu"]))
    _assert_named_equal({k: v for k, v in got["residuals"].items()
                         if v is not None}, _np(jown["residuals"]))
    # and JAX restores the port's files to the same numbers
    jfrom_t, _ = jckpt.restore(dt, st)
    for a, b in zip(jax.tree.leaves(jfrom_t), jax.tree.leaves(jown)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_leaves_written_raw_under_reference_dtype(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(128, 256)).astype(np.float32)
    jt = {"w": jnp.asarray(x, jnp.bfloat16), "v": jnp.asarray(x)}
    tt = {"w": torch.from_numpy(x).to(torch.bfloat16),
          "v": torch.from_numpy(x)}
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save(dj, 0, jt, compress=True, min_size=1024)
    checkpoint.save(dt, 0, tt, compress=True, min_size=1024)
    for f in ("data.bin", "index.json"):
        assert open(os.path.join(dj, "step_0", f), "rb").read() == \
            open(os.path.join(dt, "step_0", f), "rb").read()
    idx = json.load(open(os.path.join(dt, "step_0", "index.json")))
    assert idx["leaves"]["['w']"]["dtype"] == "bfloat16"
    assert idx["leaves"]["['w']"]["codec"] == "raw"
    assert idx["leaves"]["['v']"]["codec"] == "qtensor"
    back = {"w": torch.zeros(128, 256, dtype=torch.bfloat16),
            "v": torch.zeros(128, 256)}
    checkpoint.restore(dt, back)
    assert torch.equal(back["w"], tt["w"])


def test_checkpoint_f2p16_compression_smaller_and_close(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.normal(size=(512, 256)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(8,)).astype(
            np.float32))}
    d1, d2 = str(tmp_path / "raw"), str(tmp_path / "f2p")
    checkpoint.save(d1, 0, tree, compress=False)
    checkpoint.save(d2, 0, tree, compress=True, min_size=1024)
    s1 = os.path.getsize(os.path.join(d1, "step_0", "data.bin"))
    s2 = os.path.getsize(os.path.join(d2, "step_0", "data.bin"))
    assert s2 < s1 * 0.55, (s1, s2)
    back = {k: torch.zeros_like(v) for k, v in tree.items()}
    checkpoint.restore(d2, back)
    assert float((back["w"] - tree["w"]).abs().max()) < 2e-3
    assert torch.equal(back["b"], tree["b"])        # small leaves raw


def test_checkpoint_crash_safety(tmp_path):
    """A half-written checkpoint (no COMMITTED marker) is never restored,
    and a crash between the data and the commit leaves the last committed
    step in place."""
    d = str(tmp_path / "ck")
    tree = {"w": torch.ones(4)}
    os.makedirs(os.path.join(d, "step_9"))
    with open(os.path.join(d, "step_9", "index.json"), "w") as f:
        f.write("{}")   # torn write, no COMMITTED
    checkpoint.save(d, 3, tree)
    _, step = checkpoint.restore(d, tree)
    assert step == 3
    for point in ("ckpt.data_written", "ckpt.before_commit"):
        with active(FaultPlan(crash_points=(point,))), \
                pytest.raises(CrashInjected):
            checkpoint.save(d, 4, {"w": torch.full((4,), 2.0)})
        assert checkpoint.latest_step(d) == 3
    back = {"w": torch.zeros(4)}
    checkpoint.restore(d, back)
    assert torch.equal(back["w"], torch.ones(4))
    checkpoint.save(d, 5, tree)      # prunes the crashed tmp dir
    assert not any(x.startswith(".tmp") for x in os.listdir(d))


def test_checkpoint_retention_and_corruption(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"w": torch.ones(4)}
    for s in range(6):
        checkpoint.save(d, s, tree, keep=3)
    assert sorted(checkpoint.all_steps(d)) == [3, 4, 5]
    p = os.path.join(d, "step_5", "data.bin")
    raw = bytearray(open(p, "rb").read())
    raw[0] ^= 1
    open(p, "wb").write(bytes(raw))
    with pytest.raises(checkpoint.CheckpointCorrupt, match="checksum"):
        checkpoint.restore(d, {"w": torch.zeros(4)})


def test_async_checkpointer_writes_what_save_writes(tmp_path):
    ccfg = CompressionConfig(min_size=64)
    state = _run(2, ccfg)
    pol = default_policy("llama3_2_3b")
    da, ds = str(tmp_path / "a"), str(tmp_path / "s")
    ck = AsyncCheckpointer(da, keep=2, policy=pol)
    for s in (1, 2):
        ck.save(s, state)
    ck.wait()
    ck.close()
    checkpoint.save(ds, 2, state, compress=True, policy=pol)
    assert checkpoint.latest_step(da) == 2
    assert open(os.path.join(da, "step_2", "data.bin"), "rb").read() == \
        open(os.path.join(ds, "step_2", "data.bin"), "rb").read()


def test_async_checkpoint_is_a_snapshot_while_training_goes_on(
        tmp_path, monkeypatch):
    """The train step updates parameters and moments in place while the
    worker writes: the file holds the state of the moment of ``save``,
    byte for byte what a synchronous save at that moment writes."""
    from repro_torch.train import async_ckpt

    ccfg = CompressionConfig(min_size=64)
    cfg, ocfg = smoke_config("llama3_2_3b"), AdamWConfig(**OCFG)
    state = _run(2, ccfg)
    pol = default_policy("llama3_2_3b")
    da, ds = str(tmp_path / "a"), str(tmp_path / "s")
    go, real_write = threading.Event(), checkpoint.write

    def gated_write(*a, **kw):   # the write starts after the next step
        assert go.wait(60)
        return real_write(*a, **kw)

    checkpoint.save(ds, 2, state, compress=True, policy=pol)
    monkeypatch.setattr(async_ckpt.checkpoint, "write", gated_write)
    before = _leaves(state)
    ck = AsyncCheckpointer(da, keep=2, policy=pol)
    ck.save(2, state)
    state, _ = make_train_step(cfg, ocfg, ccfg)(state, _tbatch(2))
    assert not torch.equal(_leaves(state)["mu/final_norm"],
                           before["mu/final_norm"])
    go.set()
    ck.wait()
    ck.close()
    assert open(os.path.join(da, "step_2", "data.bin"), "rb").read() == \
        open(os.path.join(ds, "step_2", "data.bin"), "rb").read()


def test_launch_train_resumes_and_rejects_meshes(tmp_path, capsys):
    d = str(tmp_path / "run")
    cfg = smoke_config("llama3_2_3b")
    kw = dict(arch="llama3_2_3b", global_batch=2, seq=16, ckpt_dir=d,
              ckpt_every=2, device="cpu")
    launch_train.run(cfg, steps=3, **kw)
    # step 2's write is queued behind nothing but may be superseded by the
    # final save before the worker takes it (latest wins, as the reference)
    assert checkpoint.latest_step(d) == 3
    assert set(checkpoint.all_steps(d)) <= {2, 3}
    launch_train.run(cfg, steps=5, **kw)
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "done." in out
    assert checkpoint.latest_step(d) == 5
    # meshes train since the sharded port (tests/test_torch_sharded_*.py);
    # a mesh shape that is not data,model is refused
    with pytest.raises(ValueError, match="mesh-shape"):
        launch_train.main(["--ckpt-dir", d, "--mesh-shape", "2,2,2"])
