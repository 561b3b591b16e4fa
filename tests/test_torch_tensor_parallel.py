"""Port, model-axis parallel training: each split layer of the sharded step
on a (1, 2) mesh of spawned gloo ranks (``_torch_dist.tp_layers``; one
spawn for every layer) against the JAX reference's layer, whole, on the
same numpy inputs and weights (drawn from numpy, carried over by
``params_from_jax``); the vocabulary-split cross-entropy against
``repro.models.common.softmax_cross_entropy``; the model-axis sum of
partials; B5's round trip across the ranks' border against the whole
leaf's; and the dry run's train cells at (1, 2) against the reference's
per-device ``hlo_flops`` of ``lower_cell`` at (1, 2), in a subprocess
with 2 forced host devices.

Tolerances and why:
- every layer's output and input gradients: rtol = atol = 1e-5 (f32
  smoke configs). The port's one-process layers hold 1e-5 against the
  reference (tests/test_torch_model.py, test_torch_moe.py,
  test_torch_ssm.py, test_torch_xlstm.py); the split only adds the ranks'
  f32 partial sums in another order. The MoE's ``load`` is EQUAL and its
  ``aux_loss`` within 1e-6 relative: the router is replicated, so every
  rank routes as the one process does.
- the split loss within 1e-6 relative and its gradient within atol 1e-7:
  the max, the sum of exps and the label's logit are reduced over two
  ranks in f32.
- the model-axis sums of partials and B5's round trip across the
  border: EQUAL (one f32 sum of two addends; the round trip's blocks are
  the whole leaf's blocks).
- the dry run's per-rank FLOPs: llama3.2-3b EXACT (every matmul splits
  as GSPMD splits it); scout within SCOUT_FLOPS_GAP relative: its two
  layers' router products ([T, D] x [D, E], forward and both backward,
  393216 FLOPs, +0.23%) run on every model rank alike, where GSPMD splits
  them. Both under 0.6 x the (1, 1) count.
"""
import dataclasses
import json
import os
import subprocess
import sys

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as D
import repro_torch.configs.registry as REG
from repro.configs import smoke_config as jsmoke
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import init_params as jinit_params
from repro.models import moe as JMOE
from repro.models import ssm as JSSM
from repro.models import xlstm as JXL
from repro.models.model import _embed_tokens, _lm_logits
from repro_torch.configs import smoke_config
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import compat_make_mesh, fake_world
from repro_torch.models.convert import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 16
RTOL = ATOL = 1e-5
# (tag, arch, (where, layer index), split kind); "model": the whole
# train_forward under opt_seq_par (the residual stream split over the
# sequence between the split layers), its loss and its norm weights'
# gradients
LAYERS = [
    ("vocab", "llama3_2_3b", ("vocab", 0), "vocab"),
    ("vocab_tied", "xlstm_125m", ("vocab", 0), "vocab"),
    ("heads", "llama3_2_3b", ("mixer", 0), "heads"),
    ("ff", "llama3_2_3b", ("ff", 1), "ff"),
    ("experts", "llama4_scout_17b", ("ff", 0), "experts"),
    ("experts_top2", "jamba_1_5_large", ("ff", 1), "experts"),
    ("mamba", "jamba_1_5_large", ("mixer", 0), "mamba"),
    ("mlstm", "xlstm_125m", ("mixer", 0), "mlstm"),
    ("slstm", "xlstm_125m", ("mixer", 3), "slstm"),
    ("cross", "whisper_large_v3", ("cross", 1), "heads"),
    ("seq_sp", "llama3_2_3b", ("model", 0), "heads"),
    ("seq_sp_encdec", "whisper_large_v3", ("model", 0), "heads"),
]
SEQ_PAR = {"opt_seq_par": True}
SCOUT_FLOPS_GAP = 3e-3


def _weights(arch):
    """(JAX cfg, JAX params, the port's full weights by name, numpy): every
    leaf of the reference's tree drawn from numpy, N(0, 0.05^2), norms
    1 + N(0, 0.1^2) (shapes from ``jax.eval_shape`` of the reference's
    init, which is not run)."""
    jcfg = jsmoke(arch)
    rng = np.random.default_rng(7)
    shapes = jax.eval_shape(lambda k: jinit_params(jcfg, k),
                            jax.random.PRNGKey(0))
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in flat:
        norm = "norm" in jax.tree_util.keystr(path)
        a = rng.standard_normal(leaf.shape) * (0.1 if norm else 0.05)
        leaves.append((a + norm).astype(np.float32))
    npar = jax.tree_util.tree_unflatten(tree, leaves)
    jparams = jax.tree.map(jnp.asarray, npar)
    model = params_from_jax(npar, smoke_config(arch), torch.device("cpu"))
    return jcfg, jparams, {n: p.detach().numpy().copy()
                           for n, p in model.named_parameters()}


def _layer(jparams, cfg, i):
    P = len(cfg.pattern)
    return jax.tree.map(lambda a: a[i // P], jparams["blocks"][f"b{i % P}"])


def _reference(jcfg, jparams, where, i, inputs, ct, norms):
    """(out, {input: gradient}, loss, aux) of the reference's layer,
    whole."""
    if where == "model":
        from repro.models import train_forward as jtrain_forward

        jcfg = dataclasses.replace(jcfg, **SEQ_PAR)
        batch = {k: jnp.asarray(v) for k, v in inputs.items()}
        val, g = jax.jit(jax.value_and_grad(
            lambda p: jtrain_forward(p, batch, jcfg)[0]))(jparams)
        flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(g)[0]}
        P = len(jcfg.pattern)
        grads = {}
        for n in norms:
            parts = n.split(".")
            if parts[0] == "blocks":
                i = int(parts[1])
                grads[n] = flat[f"['blocks']['b{i % P}']['{parts[2]}']"][
                    i // P]
            elif parts[0] == "encoder":
                key = ("['encoder']['norm']" if len(parts) == 2 else
                       f"['encoder']['blocks']['{parts[3]}']")
                grads[n] = (flat[key] if len(parts) == 2
                            else flat[key][int(parts[2])])
            else:
                grads[n] = flat[f"['{n}']"]
        return np.asarray(val), grads, float(val), None
    if where == "vocab":
        e = np.asarray(_embed_tokens(jparams, inputs["tokens"], jcfg))

        def loss(x):
            return JC.softmax_cross_entropy(
                _lm_logits(jparams, x, jcfg), inputs["labels"])

        val, g = jax.value_and_grad(loss)(jnp.asarray(inputs["x"]))
        return e, {"x": np.asarray(g)}, float(val), None
    lp = _layer(jparams, jcfg, i)
    spec = jcfg.pattern[i % len(jcfg.pattern)]

    def f(*args):
        x = args[0]
        if where == "cross":
            return JA.attention_apply(lp["cross"], x, jcfg, mode="train",
                                      cross_kv=args[1])[0], {}
        if where == "ff":
            if spec.ff == "moe":
                return JMOE.moe_apply(lp["ff"], x, jcfg)
            ff = lp["ff"]
            return JC.swiglu(x, ff["gate"], ff["up"], ff["down"]), {}
        apply = {"attn": JA.attention_apply, "mamba": JSSM.mamba_apply,
                 "mlstm": JXL.mlstm_apply,
                 "slstm": JXL.slstm_apply}[spec.mixer]
        return apply(lp["mixer"], x, jcfg, mode="train")[0], {}

    names = ["x"] + (["cross_kv"] if where == "cross" else [])

    @jax.jit
    def run(args, ct):
        out, vjp, aux = jax.vjp(f, *args, has_aux=True)
        return out, vjp(ct), aux

    out, grads, aux = run([jnp.asarray(inputs[n]) for n in names],
                          jnp.asarray(ct))
    return np.asarray(out), {n: np.asarray(g) for n, g in zip(names, grads)}, \
        None, {k: np.asarray(v) for k, v in aux.items()}


def _loss_cases():
    """(logits [2, 8, 512], labels with masked tails, z_loss) of the split
    loss's two cases."""
    rng = np.random.default_rng(32)
    out = []
    for scale, z in ((3.0, 0.0), (1.0, 1e-4)):
        labels = rng.integers(0, 512, (2, 8))
        labels[1, 5:] = -1
        out.append(((rng.standard_normal((2, 8, 512)) * scale).astype(
            np.float32), labels, z))
    return out


@pytest.fixture(scope="module")
def layers():
    rng = np.random.default_rng(31)
    cases, refs, archs = [], {}, {}
    for tag, arch, (where, i), _ in LAYERS:
        if arch not in archs:
            archs[arch] = _weights(arch)
        jcfg, jparams, weights = archs[arch]
        D_ = jcfg.d_model
        inputs = {"x": rng.standard_normal((B, S, D_)).astype(np.float32)}
        if where in ("vocab", "model"):
            inputs["tokens"] = rng.integers(0, jcfg.vocab_size, (B, S))
            labels = rng.integers(0, jcfg.vocab_size, (B, S))
            labels[0, :3] = -1
            inputs["labels"] = labels
        if where == "model":
            del inputs["x"]
            if jcfg.is_encdec:
                inputs["frames"] = rng.standard_normal(
                    (B, jcfg.encoder_seq, D_)).astype(np.float32)
        if where == "cross":
            inputs["cross_kv"] = rng.standard_normal(
                (B, 24, D_)).astype(np.float32)
        ct = rng.standard_normal((B, S, D_)).astype(np.float32)
        over = SEQ_PAR if where == "model" else {}
        cases.append((tag, arch, over, weights, (where, i), inputs, ct))
        refs[tag] = _reference(jcfg, jparams, where, i, inputs, ct,
                               [n for n in weights if "norm" in n])
    got = D.spawn(D.multi, 2, [("tp_layers", (cases,)),
                               ("tp_sums", (_sum_cases(),)),
                               ("tp_roundtrip", (_border_cases(),))] + [
        ("tp_loss", case) for case in _loss_cases()])[0]
    return dict(got=got[0], sums=got[1], borders=got[2], refs=refs,
                losses=got[3:])


def _border_cases():
    """(tag, g, r, dtype) of leaves whose B5 blocks straddle the border of
    two ranks' column shards: 2 x 192 columns (the border in the middle
    of block 1), and 2 x 416 (at 32 columns into block 3, the last block
    ragged), bf16 and f32 gradients."""
    rng = np.random.default_rng(34)
    out = []
    for tag, cols, dtype in (("w192", 384, "float32"),
                             ("w416", 832, "bfloat16")):
        g = (rng.standard_normal((6, cols)) * 1e-2).astype(np.float32)
        r = (rng.standard_normal((6, cols)) * 1e-4).astype(np.float32)
        out.append((tag, g, r, dtype))
    return out


def _sum_cases():
    """(tag, [2, ...] partials, dtype) of the model-axis sum's cases."""
    rng = np.random.default_rng(33)
    a = rng.standard_normal((2, 3, 64)).astype(np.float32)
    return [("bf16", a, "bfloat16"), ("f32", a, "float32")]


@pytest.mark.parametrize("tag,arch,where,kind", LAYERS,
                         ids=[t[0] for t in LAYERS])
def test_split_layer_matches_reference(layers, tag, arch, where, kind):
    got = layers["got"][tag]
    out, grads, loss, aux = layers["refs"][tag]
    assert got["kinds"][kind], got["kinds"]        # the layer kind splits
    assert any(leg.startswith("train.tp_") for leg in got["legs"])
    if where == "model":   # the residual stream ran split over the sequence
        assert "train.tp_seq_all_gather" in got["legs"], got["legs"]
    np.testing.assert_allclose(got["out"], out, rtol=RTOL, atol=ATOL)
    assert set(got["grads"]) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    if loss is not None:
        assert got["loss"] == pytest.approx(loss, rel=1e-6)
    if aux:
        np.testing.assert_array_equal(got["load"], aux["load"])
        assert got["aux_loss"] == pytest.approx(float(aux["aux_loss"]),
                                                rel=1e-6)


def test_partial_sums_add_in_f32(layers):
    """Partials of any dtype are summed over the model axis by one f32
    all-reduce and cast back once: the f32 sum of the two partials,
    rounded once, in the partials' dtype."""
    a = _sum_cases()[0][1]
    bf = torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()
    want = torch.from_numpy(bf[0] + bf[1]).to(torch.bfloat16).to(
        torch.float32).numpy()
    got, dtype, legs = layers["sums"]["bf16"]
    assert dtype == "torch.bfloat16" and legs == ["test.sum_all_reduce"]
    np.testing.assert_array_equal(got, want)
    got, dtype, legs = layers["sums"]["f32"]
    assert dtype == "torch.float32" and legs == ["test.sum_all_reduce"]
    np.testing.assert_array_equal(got, a[0] + a[1])


@pytest.mark.parametrize("case", [0, 1], ids=["w192", "w416"])
def test_round_trip_across_the_border_is_the_whole_leafs(layers, case):
    """A leaf whose last axis splits over the model axis at a width that
    is not a multiple of B5's block: the ranks' round trips on their
    shards extended by the straddling blocks' columns give the whole
    leaf's round trip, bitwise (gradient and residual)."""
    from repro_torch.kernels.f2p_quant import ef_roundtrip_plain
    from repro_torch.optim.compress import CompressionConfig

    tag, g, r, dtype = _border_cases()[case]
    ccfg = CompressionConfig()
    gt = torch.from_numpy(g).to(getattr(torch, dtype))
    rt = torch.from_numpy(r.copy())
    ef_roundtrip_plain(gt, rt, ccfg.fmt, ccfg.block)
    got_g, got_r = layers["borders"][tag]
    np.testing.assert_array_equal(got_g, gt.to(torch.float32).numpy())
    np.testing.assert_array_equal(got_r, rt.numpy())


@pytest.mark.parametrize("case", [0, 1], ids=["plain", "z_loss"])
def test_vocab_split_loss_matches_reference(layers, case):
    logits, labels, z = _loss_cases()[case]
    val, grad = jax.value_and_grad(
        lambda lg: JC.softmax_cross_entropy(lg, labels, z_loss=z))(
            jnp.asarray(logits))
    got_loss, got_grad = layers["losses"][case]
    assert got_loss == pytest.approx(float(val), rel=1e-6)
    np.testing.assert_allclose(got_grad, np.asarray(grad), rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# The dry run's train cells at (1, 2)
# ---------------------------------------------------------------------------
DRY = ("llama3_2_3b", "llama4_scout_17b")
SMALL = {"train_4k": (64, 4, "train")}

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import repro.configs.registry as REG
from repro.configs import smoke_config
from repro.launch import roofline as RL
from repro.launch.dryrun import lower_cell
from repro.launch.mesh import compat_make_mesh
mesh = compat_make_mesh((1, 2), ("data", "model"))
REG.SHAPES.update({k: tuple(v) for k, v in json.loads(sys.argv[1]).items()})
out = {}
for arch in json.loads(sys.argv[2]):
    c, cfg, meta = lower_cell(arch, "train_4k", mesh, cfg=smoke_config(arch))
    seq, gb, kind = REG.SHAPES["train_4k"]
    rl = RL.analyze(c, arch=arch, shape="train_4k", mesh_name="1x2",
                    n_devices=2, cfg=cfg, seq=seq, gbatch=gb, kind=kind)
    out[arch] = rl.hlo_flops
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_flops_12():
    r = subprocess.run(
        [sys.executable, "-c", _REF, json.dumps(SMALL), json.dumps(DRY)],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("REF "))
    return json.loads(line[4:])


@pytest.mark.parametrize("arch", DRY)
def test_dryrun_train_cell_splits_over_the_model_axis(arch, ref_flops_12,
                                                      monkeypatch):
    monkeypatch.setitem(REG.SHAPES, "train_4k", SMALL["train_4k"])
    counts = {}
    for shape in ((1, 1), (1, 2)):
        with fake_world(shape[0] * shape[1]):
            mesh = compat_make_mesh(shape, ("data", "model"), "cpu")
            counts[shape], _, meta = lower_cell(arch, "train_4k", mesh,
                                                cfg=smoke_config(arch))
    split = counts[(1, 2)]["flops"]
    ref = ref_flops_12[arch]
    if arch == "llama3_2_3b":
        assert split == ref
    else:
        assert split == pytest.approx(ref, rel=SCOUT_FLOPS_GAP)
    assert split < 0.6 * counts[(1, 1)]["flops"]
    assert all(meta["model_split"].values()), meta["model_split"]
    assert "model axis 2: split vocab heads ff" in meta["placement"]
    assert "whole (none)" in meta["placement"]
