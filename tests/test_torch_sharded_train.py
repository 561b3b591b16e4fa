"""Port, the sharded trainer: ``launch.train.run(mesh_shape=...)`` on gloo
ranks (one spawn of 4 ranks, one of 2) against the port's one-process run
(``mesh_shape=None``), for the xLSTM and llama smoke configs; restores onto
another mesh and lazy restores; ``constrain`` on DTensors.

The sharded step computes each data rank's slice of the batch and sums
the gradients over the data ranks in f32. Over the model axis each rank
computes the part of every layer that the rules give that axis (the
vocabulary, heads, FF width and the xLSTM's heads and channels), its
leaves local, and the ranks' f32 partial sums join over the model axis;
a layer kind whose heads do not divide the model axis (the llama smoke
config's 6 heads at m = 4) gathers its leaves and computes whole. So the
numbers add in another order than the one-process run's. Tolerances and
why:
- losses: rtol 1e-5 (the mean of the data shards' mean losses);
- gradient norms: rtol 1e-4 (the squared shards summed over the ranks);
- parameters after 3 steps: atol 2 x the sum of the 3 steps' learning
  rates (1.2e-3; AdamW moves an element by about lr a step, and an F2P8
  gradient code that lands on its neighbour can turn one step's move);
- moments and residuals, each leaf in norm relative to the one-process
  run's: mu 1e-2, nu 2e-2, residuals 0.25. Data parallel rounding moves
  some gradients across an F2P8 rounding border from the first step on
  (the llama smoke config at (2, 1): mu 3.5e-4, residuals 7e-3 after one
  step; 4e-3, 7.8e-3 and 0.163 after three), and a code step is the whole
  residual of its element;
- a world of one, (1, 1) through the mesh path: EQUAL to the
  one-process run (no data reduction, the same leaves in the same order);
- restores: EQUAL (the checkpoint is read whole and each rank keeps its
  slice); lazy restores: codes, scales and raw leaves EQUAL to the JAX
  reference's ``restore(lazy=True)`` of the same files.
"""
import dataclasses
import os

import _torch_threads  # noqa: F401
import jax
import numpy as np
import pytest
import torch

import _torch_dist as D
from repro.configs import smoke_config as jsmoke
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import CompressionConfig as JCompressionConfig
from repro.train import checkpoint as jckpt
from repro.train import init_train_state as jinit_train_state
from repro_torch.configs import smoke_config
from repro_torch.core.qtensor import QTensor
from repro_torch.launch.train import run, train_configs
from repro_torch.optim.adamw import lr_at
from repro_torch.train import checkpoint, init_train_state

XL, LL = "xlstm_125m", "llama3_2_3b"
STEPS = 3
# (tag, arch, mesh shape, fsdp)
W4 = [("xl22", XL, (2, 2), False), ("ll22", LL, (2, 2), True),
      ("ll14", LL, (1, 4), False)]
W2 = [("xl21", XL, (2, 1), False), ("xl12", XL, (1, 2), True),
      ("ll21", LL, (2, 1), True), ("ll12", LL, (1, 2), False),
      ("llv12", LL, (1, 2), False)]
# config overrides of a job: a vocabulary of 576 splits lm_head into 288
# columns a rank, so B5's block 2 straddles the ranks' border and the
# round trip runs across it (``train.step.roundtrip_across_borders``)
OVER = {"llv12": {"vocab_size": 576}}


def _plain(arch, ckpt_dir, over=None):
    """The one-process run (``fsdp`` changes nothing without a mesh)."""
    cfg = dataclasses.replace(smoke_config(arch), **(over or {}))
    state, info = run(cfg, arch=arch, steps=STEPS, global_batch=4, seq=16,
                      ckpt_dir=ckpt_dir, ckpt_every=100, device="cpu",
                      log=lambda *_: None)
    return ([h["loss"] for h in info["history"]],
            [h["grad_norm"] for h in info["history"]], D.full_state(state))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    jobs4 = [(t, a, s, f, str(d / t), STEPS, OVER.get(t, {}))
             for t, a, s, f in W4]
    r4 = D.spawn(D.multi, 4, [("train_jobs", (jobs4,)),
                              ("constrain_check", ())])
    jobs2 = [(t, a, s, f, str(d / t), STEPS, OVER.get(t, {}))
             for t, a, s, f in W2]
    r2 = D.spawn(D.multi, 2, [("train_jobs", (jobs2,)),
                              ("restore_onto", (XL, (2, 1), str(d / "xl22"))),
                              ("restore_onto", (LL, (1, 2), str(d / "ll22")))])
    plain = {arch: _plain(arch, str(d / f"plain_{arch}")) for arch in (XL, LL)}
    plain.update({t: _plain(dict((w[0], w[1]) for w in W2)[t],
                            str(d / f"plain_{t}"), o)
                  for t, o in OVER.items()})
    return dict(dir=d, sharded={**r4[0][0], **r2[0][0]},
                constrain=[r[1] for r in r4], restored=r2[0][1:],
                plain=plain)


NORM_RTOL = {"mu": 1e-2, "nu": 2e-2, "residuals": 0.25}


def _close_in_norm(got, want, key, name):
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= NORM_RTOL[key], (key, name, rel)


@pytest.mark.parametrize("tag,arch,shape,fsdp", W4 + W2,
                         ids=[t[0] for t in W4 + W2])
def test_sharded_trainer_matches_one_process(runs, tag, arch, shape, fsdp):
    losses, gnorms, full, split, nbytes = runs["sharded"][tag][:5]
    plosses, pgnorms, pfull = runs["plain"][tag if tag in OVER else arch]
    np.testing.assert_allclose(losses, plosses, rtol=1e-5)
    np.testing.assert_allclose(gnorms, pgnorms, rtol=1e-4)
    ocfg, _, _, _ = train_configs(dataclasses.replace(
        smoke_config(arch), **OVER.get(tag, {})), arch=arch, steps=STEPS)
    atol = 2 * sum(float(lr_at(ocfg, s)) for s in range(1, STEPS + 1))
    assert full["step"] == pfull["step"] == STEPS
    for n, want in pfull["params"].items():
        np.testing.assert_allclose(full["params"][n], want, rtol=0,
                                   atol=atol, err_msg=n)
    for key in ("mu", "nu", "residuals"):
        assert set(full[key]) == set(pfull[key])
        for n, want in pfull[key].items():
            _close_in_norm(full[key][n], want, key, n)
    aligned, gathered = split
    assert set(aligned) | set(gathered) == set(pfull["residuals"])
    if tag == "ll22":   # fsdp (2, 2): the embedding's last dim splits
        assert "embed" in gathered
    # a rank holds less than the whole state wherever the rules shard it:
    # a model axis of 2, or fsdp over a data axis of 2
    whole = sum(a.nbytes for k in ("params", "mu", "nu", "residuals")
                for a in pfull[k].values())
    assert nbytes < whole if (shape[1] > 1 or fsdp) else nbytes == whole


@pytest.mark.parametrize("tag,arch,shape,fsdp", W4 + W2,
                         ids=[t[0] for t in W4 + W2])
def test_model_axis_keeps_split_leaves_local(runs, tag, arch, shape, fsdp):
    """With a model axis, every leaf the rules split over it stays local:
    the step gathers no leaf whole over the model axis (no
    ``train.param_all_gather`` without fsdp) and its split layers run their
    model-axis collectives; a kind that cannot split is named whole and
    its leaves are gathered."""
    legs, plan = runs["sharded"][tag][5:]
    assert plan["model"] == shape[1]
    tp = [k for k in legs if k.startswith("train.tp_")]
    if shape[1] == 1:
        assert not any(plan["kinds"].values()) and not plan["local"]
        assert not tp
        return
    whole = {"ll14": {"heads"}}.get(tag, set())
    assert {k for k, v in plan["kinds"].items() if not v} == whole
    assert plan["local"] and tp
    gathered = "train.param_all_gather" in legs
    assert gathered == bool(whole), legs
    # a round trip crosses the ranks' border without a gather of the leaf
    # where a rank holds at least a block of the leaf's last axis (the
    # xLSTM's 192 columns of wqkv; lm_head's 288 at a vocabulary of 576);
    # llama's 48 columns of wq are narrower than a block: gathered whole
    crossed = {"xl22", "xl12", "llv12"}
    assert ("train.roundtrip_edge_gather" in legs) == (tag in crossed)
    if whole:   # the heads' leaves: 4 per layer, 2 layers
        assert legs["train.param_all_gather"][0] == 8
        assert not any(k.startswith("train.tp_attn") for k in legs)


def test_constrain_redistributes_dtensors(runs):
    for res in runs["constrain"]:
        assert res["y"] and res["z"] and res["values"], res
        assert res["local"] == (2, 3, 4, 2)
        assert res["same"] and res["outside"]


def test_restore_onto_another_mesh(runs):
    """The (2, 2) runs' checkpoints restored on (2, 1) and (1, 2) equal a
    one-process restore of the same files."""
    for (step, full), arch in zip(runs["restored"], (XL, LL)):
        tag = "xl22" if arch == XL else "ll22"
        cfg = smoke_config(arch)
        ocfg, ccfg, _, _ = train_configs(cfg, arch=arch, steps=STEPS)
        st = init_train_state(cfg, ocfg, ccfg, seed=5, device="cpu")
        st, pstep = checkpoint.restore(str(runs["dir"] / tag), st)
        assert step == pstep == STEPS
        want = D.full_state(st)
        for key in ("params", "mu", "nu", "residuals"):
            for n, a in want[key].items():
                np.testing.assert_array_equal(full[key][n], a,
                                              err_msg=f"{key}/{n}")


@pytest.mark.parametrize("packed", [False, True], ids=["codes", "packed"])
def test_lazy_restore_equals_reference(runs, tmp_path, packed):
    """The (2, 2) run's state, saved with F2P16 payloads down to 1024
    elements (unpacked and bit-packed), restored lazily by both packages."""
    cfg = smoke_config(XL)
    ocfg, ccfg, _, _ = train_configs(cfg, arch=XL, steps=STEPS)
    st = init_train_state(cfg, ocfg, ccfg, seed=5, device="cpu")
    checkpoint.restore(str(runs["dir"] / "xl22"), st)
    d = str(tmp_path / "lazy")
    checkpoint.save(d, 7, st, compress=True, min_size=1024, packed=packed)
    got, step = checkpoint.restore(d, st, lazy=True)
    jcfg = jsmoke(XL)
    jlike = jinit_train_state(jcfg, JAdamWConfig(), JCompressionConfig(
        min_size=ccfg.min_size, fmt=ccfg.fmt, block=ccfg.block),
        jax.random.PRNGKey(0))
    want, jstep = jckpt.restore(d, jlike, lazy=True)
    assert step == jstep == 7
    flat, _ = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: x is None or hasattr(x, "codes"))
    want = {jax.tree_util.keystr(p): v for p, v in flat if v is not None}
    assert set(got) == set(want)
    n_q = 0
    for name, leaf in got.items():
        w = want[name]
        if isinstance(leaf, QTensor):
            n_q += 1
            assert (leaf.block, leaf.packed, leaf.shape) == (
                w.block, w.packed, tuple(w.shape)), name
            np.testing.assert_array_equal(leaf.codes.numpy(),
                                          np.asarray(w.codes), err_msg=name)
            np.testing.assert_array_equal(leaf.scales.numpy(),
                                          np.asarray(w.scales), err_msg=name)
        else:
            np.testing.assert_array_equal(
                leaf.to(torch.float32).numpy(),
                np.asarray(w).astype(np.float32), err_msg=name)
    assert n_q > 0
    # the lazy leaves decode to what an eager restore writes
    checkpoint.restore(d, st)
    mu = got["['opt']['mu']['embed']"]
    assert isinstance(mu, QTensor) and mu.packed == packed
    np.testing.assert_array_equal(mu.dequantize().numpy(),
                                  st["opt"]["mu"]["embed"].numpy())
    with pytest.raises(ValueError, match="lazy"):
        checkpoint.restore(d, st, shardings={}, lazy=True)


def test_mesh_path_world_of_one_equals_plain(tmp_path):
    """(1, 1) through the mesh path (DTensor state, the sharded step) on a
    world of one is the one-process run, bit for bit."""
    import torch.distributed as dist

    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        cfg = smoke_config(LL)
        _, info = run(cfg, arch=LL, steps=STEPS, global_batch=4, seq=16,
                      ckpt_dir=str(tmp_path / "mesh"), ckpt_every=100,
                      device="cpu", log=lambda *_: None, mesh_shape=(1, 1))
    finally:
        dist.destroy_process_group()
    _, pinfo = run(cfg, arch=LL, steps=STEPS, global_batch=4, seq=16,
                   ckpt_dir=str(tmp_path / "plain"), ckpt_every=100,
                   device="cpu", log=lambda *_: None)
    assert info["history"] == pinfo["history"]
    for name in ("data.bin", "index.json"):
        with open(os.path.join(tmp_path, "mesh", f"step_{STEPS}", name),
                  "rb") as a, open(os.path.join(
                      tmp_path, "plain", f"step_{STEPS}", name), "rb") as b:
            assert a.read() == b.read(), name
