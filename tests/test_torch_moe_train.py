"""Port parity, MoE training: ``repro_torch`` trains the MoE family
(llama4-scout, llama4-maverick, jamba) as the JAX reference does, at the
reference's smoke configs (f32), both started from the reference's numbers
(``params_from_jax`` / ``train_state_from_jax``, or the reference's step-0
checkpoint, which ``launch.train.run`` resumes from). The reference side of
each arch is computed once per module (the ``ref`` fixture).

Tolerances and why:
- routing at step 0: EQUAL. Each MoE layer's expert picks and kept mask
  (the reference's stable sort and capacity) are held before any gradient,
  so a near-tie between two experts fails here and not as a gradient
  tolerance;
- ``train_forward``'s loss and every gradient leaf (router, experts, shared
  expert, jamba's mamba leaves): rtol 1e-4, atol 1e-7, as
  ``test_torch_train.py``: XLA and torch sum matmuls and reductions in
  other orders. The port's ``remat`` on and off are both held against the
  reference's smoke config (``remat=False``): recomputing a block changes
  no value. The same for ``moe_apply``'s gradients at a capacity that
  drops assignments (the dump row carries none);
- three ``run()`` steps: losses within 1e-4 relative, and every parameter
  leaf within 1e-4 relative in norm (F2P8 codes of nearly equal gradients
  may land on neighbouring codes, ``test_torch_train.py`` says why);
- the compressed leaf set and the checkpoint files: EQUAL (names, bytes);
- ``chunked_attention``: rtol = atol = 1e-5 (f32 online softmax, other
  summation orders); ``attn_impl="chunked"`` through ``train_forward``
  (1e-4, as above) and ``prefill`` (1e-4, as ``test_torch_model.py``: a
  one-ulp difference in k can move one F2P KV code);
- ``opt_bwd_cast`` on bf16 smoke scout: gradient dtypes EQUAL to JAX's;
  values within 1e-2 relative in norm per leaf (bf16 products summed in
  other orders); and in the port the cast changes no bit (the f32 loss's
  input cast already hands the cotangent back in the logits' dtype).
"""
import dataclasses
import json
import os

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import default_policy as jdefault_policy
from repro.configs import smoke_config as jsmoke
from repro.data import DataConfig as JDataConfig
from repro.data import host_batch as jhost_batch
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import moe as JMOE
from repro.models import prefill as jprefill
from repro.models import train_forward as jtrain_forward
from repro.models.attention import chunked_attention as jchunked
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import CompressionConfig as JCompressionConfig
from repro.optim import apply_updates as japply_updates
from repro.optim.compress import compress_decompress as jcompress_decompress
from repro.train import checkpoint as jckpt
from repro.train import init_train_state as jinit_train_state
from repro_torch.configs import default_policy, smoke_config
from repro_torch.data import DataConfig, host_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import init_caches, prefill, train_forward
from repro_torch.models import moe as MOE
from repro_torch.models.attention import chunked_attention, naive_attention
from repro_torch.models.convert import (params_from_jax, reference_path,
                                        train_state_from_jax)
from repro_torch.optim import CompressionConfig
from repro_torch.optim.compress import compressed_leaves
from repro_torch.train import checkpoint, init_train_state, loss_and_grads

CPU = torch.device("cpu")
SCOUT, MAVERICK, JAMBA = ARCHS = ["llama4_scout_17b", "llama4_maverick_400b",
                                  "jamba_1_5_large"]
STEPS, GB, SEQ = 3, 2, 16
DCFG = dict(vocab_size=512, seq_len=SEQ, global_batch=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_leaf(tree, name, pattern_len):
    path, layer = reference_path(name, pattern_len)
    a = tree
    for k in path:
        a = a[k]
    return np.asarray(a if layer is None else a[layer])


def _batch(step=0):
    return host_batch(DataConfig(**DCFG), step)


def _kept(picks: np.ndarray, cap: int) -> np.ndarray:
    """The reference's kept mask of a layer's [T, k] picks, in (token,
    choice) order: an assignment is kept when its rank in its expert's
    stable-sorted run is below the capacity."""
    flat = picks.reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty_like(order)
    se = flat[order]
    rank[order] = np.arange(flat.size) - np.searchsorted(se, se, side="left")
    return rank < cap


class _Ref:
    """The reference side of one arch: its initial train state (min_size
    512, as the CLI), the routing and ``value_and_grad`` of batch 0, and the
    three-step runs, each computed at first use. One jitted
    ``value_and_grad`` of the reference's train forward serves them all."""

    def __init__(self, arch):
        self.arch = arch
        self.jcfg = jsmoke(arch)
        self.cfg = smoke_config(arch)
        self.P = len(self.cfg.pattern)
        self.ccfg = JCompressionConfig(min_size=512)
        self.st = jinit_train_state(self.jcfg, JAdamWConfig(), self.ccfg,
                                    jax.random.PRNGKey(0))
        self.np_st = _np(self.st)
        self.vg = jax.jit(jax.value_and_grad(
            lambda p, b: jtrain_forward(p, b, self.jcfg), has_aux=True))
        self._grads, self._steps = None, {}

    def value_and_grad(self):
        if self._grads is None:
            b = {k: jnp.asarray(v) for k, v in _batch().items()}
            (loss, m), g = self.vg(self.st["params"], b)
            self._grads = (float(loss), {k: float(v) for k, v in m.items()},
                           _np(g))
        return self._grads

    def routing(self):
        """Each MoE call's [T, k] expert picks in the reference's forward of
        batch 0, in layer order (a debug callback in a wrapper of
        ``moe.moe_apply``)."""
        picks, orig = [], JMOE.moe_apply

        def recording(params, x, cfg, sp=False):
            xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
            probs = jax.nn.softmax(xf @ params["router"], axis=-1)
            _, idx = jax.lax.top_k(probs, cfg.experts_per_token)
            jax.debug.callback(lambda i: picks.append(np.asarray(i)), idx,
                               ordered=True)
            return orig(params, x, cfg, sp)

        JMOE.moe_apply = recording
        try:
            b = {k: jnp.asarray(v) for k, v in _batch().items()}
            loss, _ = jtrain_forward(self.st["params"], b,
                                     dataclasses.replace(self.jcfg,
                                                         remat=False))
            float(loss)
            jax.effects_barrier()
        finally:
            JMOE.moe_apply = orig
        return picks

    def steps(self, enabled):
        """The reference launcher's three steps (its optimizer and
        compression configs, ``host_batch``): (losses, numpy params). Each
        step is the reference's ``make_train_step`` body, value_and_grad,
        ``compress_decompress`` and ``adamw.apply_updates``, with the shared
        jitted value_and_grad, so the compressed and uncompressed runs
        compile the model once."""
        if enabled not in self._steps:
            pol = jdefault_policy(self.arch)
            gfmt, gblock = pol.f2p_for("grad", (JCompressionConfig.fmt, 128))
            ccfg = JCompressionConfig(enabled=enabled, min_size=512,
                                      fmt=gfmt, block=gblock)
            ocfg = JAdamWConfig(lr=1e-3, warmup_steps=10, total_steps=STEPS)
            dcfg = JDataConfig(vocab_size=self.jcfg.vocab_size, seq_len=SEQ,
                               global_batch=GB)
            @jax.jit
            def update(params, grads, residuals, opt):
                grads, residuals = jcompress_decompress(grads, residuals,
                                                        ccfg)
                params, opt, _ = japply_updates(params, grads, opt, ocfg)
                return {"params": params, "opt": opt, "residuals": residuals}

            st, losses = self.st, []
            for i in range(STEPS):
                (loss, _), g = self.vg(st["params"], {
                    k: jnp.asarray(v)
                    for k, v in jhost_batch(dcfg, i).items()})
                st = update(st["params"], g, st["residuals"], st["opt"])
                losses.append(float(loss))
            self._steps[enabled] = (losses, _np(st["params"]))
        return self._steps[enabled]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return _Ref(request.param)


def _port_model(ref, **over):
    cfg = dataclasses.replace(ref.cfg, **over)
    model = params_from_jax(ref.np_st["params"], cfg, CPU)
    model.requires_grad_(True)
    return cfg, model


# ---------------------------------------------------------------------------
# routing, forward and gradients
# ---------------------------------------------------------------------------
def test_step0_routing_equals_reference(ref):
    """Every MoE layer's picks and kept mask at step 0 equal the
    reference's, and so does the load each layer reports."""
    cfg, model = _port_model(ref, remat=False)
    picks, loads = [], []

    def hook(mod, args, out):
        x = args[0]
        xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
        _, idx = MOE.top_k(torch.softmax(xf @ mod.router, dim=-1),
                           cfg.experts_per_token)
        picks.append(idx.numpy())
        loads.append(out[1]["load"].numpy())

    moes = [m for m in model.modules() if isinstance(m, MOE.MoE)]
    handles = [m.register_forward_hook(hook) for m in moes]
    try:
        with torch.no_grad():
            train_forward(model, {k: torch.from_numpy(v)
                                  for k, v in _batch().items()}, cfg)
    finally:
        for h in handles:
            h.remove()
    want = ref.routing()
    n_moe = sum(b.ff == "moe" for b in cfg.pattern) * cfg.n_groups
    assert len(picks) == len(want) == len(moes) == n_moe
    T = DCFG["global_batch"] * DCFG["seq_len"]
    cap = MOE.capacity(T, cfg)
    assert cap == int(max(1, round(T * cfg.experts_per_token
                                   / cfg.n_experts * cfg.capacity_factor)))
    for layer, (got, w, load) in enumerate(zip(picks, want, loads)):
        np.testing.assert_array_equal(got, w, err_msg=f"MoE call {layer}")
        np.testing.assert_array_equal(_kept(got, cap), _kept(w, cap))
        np.testing.assert_array_equal(
            load, np.bincount(w.reshape(-1), minlength=cfg.n_experts))


@pytest.mark.parametrize("remat", [False, True])
def test_train_forward_loss_and_grads_match_jax(ref, remat):
    jl, jm, jg = ref.value_and_grad()
    cfg, model = _port_model(ref, remat=remat)
    loss, metrics, grads = loss_and_grads(
        model, {k: torch.from_numpy(v) for k, v in _batch().items()}, cfg)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-4)
    np.testing.assert_allclose(float(metrics["ce_loss"]), jm["ce_loss"],
                               rtol=1e-4)
    assert jm["aux_loss"] > 0
    np.testing.assert_allclose(float(metrics["aux_loss"]), jm["aux_loss"],
                               rtol=1e-4)
    leaves = {reference_path(n, ref.P)[0][-1] for n in grads}
    assert {"router", "gate", "up", "down"} <= leaves
    if ref.arch == JAMBA:
        assert {"in_proj", "x_proj", "dt_proj", "dt_bias", "a_log", "d_skip",
                "conv_w", "conv_b", "out_proj"} <= leaves
    else:
        assert any(".ff.shared." in n for n in grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), _ref_leaf(jg, name, ref.P),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("k,capacity_factor", [(1, 0.5), (2, 0.75)])
def test_moe_apply_grads_match_jax_where_capacity_drops(k, capacity_factor):
    """The gradients of ``moe_apply``'s output (against a random cotangent)
    plus its aux term, by x, the router, the experts and the shared expert,
    where assignments drop: a dropped assignment reaches the cut-off dump
    row and gets no gradient, in both packages."""
    over = dict(experts_per_token=k, capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jsmoke(SCOUT), **over)
    cfg = dataclasses.replace(smoke_config(SCOUT), **over)
    jp = jax.tree.map(lambda a: a[0], jinit_params(
        jcfg, jax.random.PRNGKey(0))["blocks"]["b0"]["ff"])
    rng = np.random.default_rng(k)
    x = rng.standard_normal((3, 8, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = JMOE.moe_apply(p, x, jcfg)
        return jnp.sum(out * ct) + aux["aux_loss"], aux["load"]

    (jl, jload), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                 has_aux=True)(
        jp, jnp.asarray(x))
    mod = MOE.MoE(cfg, CPU)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            a = jp
            for key in name.split("."):
                a = a[key]
            p.copy_(torch.from_numpy(np.array(a)))
    mod.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = MOE.moe_apply(mod, tx, cfg)
    loss = (out * torch.from_numpy(ct)).sum() + aux["aux_loss"]
    loss.backward()
    cap = MOE.capacity(x.shape[0] * x.shape[1], cfg)
    assert int(MOE.dropped(cap, aux["load"])) > 0
    np.testing.assert_array_equal(aux["load"].numpy(), np.asarray(jload))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-7)
    for name, p in mod.named_parameters():
        a = jgp
        for key in name.split("."):
            a = a[key]
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# the compressed leaf set, three run() steps, checkpoints
# ---------------------------------------------------------------------------
def test_compressed_leaf_set_equals_reference(ref):
    """min_size 512 on the reference's stacked sizes, at block 128: the
    routers stack to [2, 64, 4] (scout) and [1, 64, 8] (maverick), 512
    elements, compressed; jamba's [1, 64, 4], 256, not."""
    _, ccfg, _, _ = launch_train.train_configs(ref.cfg, arch=ref.arch,
                                               steps=STEPS)
    assert (ccfg.block, ccfg.min_size) == (128, 512)
    jf = JCompressionConfig.fmt
    assert (ccfg.fmt.n_bits, ccfg.fmt.h_bits, ccfg.fmt.flavor.value,
            ccfg.fmt.signed) == (jf.n_bits, jf.h_bits, jf.flavor.value,
                                 jf.signed)
    state = train_state_from_jax(ref.np_st, ref.cfg, CPU)
    fresh = init_train_state(ref.cfg, None, ccfg, device=CPU)
    assert {n for n, r in fresh["residuals"].items() if r is not None} == \
        {n for n, r in state["residuals"].items() if r is not None}
    grads = {n: torch.zeros_like(p)
             for n, p in state["params"].named_parameters()}
    names = compressed_leaves(grads, fresh["residuals"], ccfg, ref.P)
    jleaves = {tuple(k.key for k in path) for path, _ in
               jax.tree_util.tree_flatten_with_path(ref.st["residuals"])[0]}
    assert {reference_path(n, ref.P)[0] for n in names} == jleaves
    routers = {n for n in grads if n.endswith(".ff.router")}
    assert routers
    if ref.arch == JAMBA:
        assert not routers & set(names)
    else:
        assert routers <= set(names)


@pytest.mark.parametrize("enabled", [True, False],
                         ids=["compressed", "uncompressed"])
def test_run_three_steps_match_reference(ref, tmp_path, enabled):
    """``launch.train.run`` resumes from the reference's step-0 checkpoint
    and takes three steps on the CPU; its losses and parameters track the
    reference launcher's train step on the same batches."""
    want, want_params = ref.steps(enabled)
    d = str(tmp_path / "run")
    jckpt.save(d, 0, ref.st)
    logs = []
    state, info = launch_train.run(ref.cfg, arch=ref.arch, steps=STEPS,
                                   global_batch=GB, seq=SEQ, ckpt_dir=d,
                                   compress=enabled, device="cpu",
                                   log=logs.append)
    assert info["start"] == 0 and "resumed from step 0" in logs
    np.testing.assert_allclose([h["loss"] for h in info["history"]], want,
                               rtol=1e-4)
    for name, p in state["params"].named_parameters():
        got, w = p.detach().numpy(), _ref_leaf(want_params, name, ref.P)
        rel = float(np.linalg.norm(got - w) / np.linalg.norm(w))
        assert rel <= 1e-4, (name, rel)
    assert checkpoint.latest_step(d) == STEPS


def test_run_trains_moe_and_rejects_meshes(tmp_path):
    """No MoE config raises any more; a mesh shape that is not
    data,model is refused."""
    for arch in ARCHS:
        _, info = launch_train.run(smoke_config(arch), arch=arch, steps=1,
                                   global_batch=1, seq=8,
                                   ckpt_dir=str(tmp_path / arch),
                                   device="cpu", log=lambda *_: None)
        assert np.isfinite(info["history"][0]["loss"])
    with pytest.raises(ValueError, match="mesh-shape"):
        launch_train.main(["--arch", SCOUT, "--mesh-shape", "2,2,2",
                           "--ckpt-dir", str(tmp_path / "m")])


def _perturbed(ref):
    """The reference's state with every f32 leaf moved off its init."""
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda x: x + jnp.asarray(rng.normal(
        size=x.shape).astype(np.float32) * 1e-2)
        if x.dtype == jnp.float32 else x, ref.st)


_CKPT_CASES = [dict(), dict(compress=True, min_size=64),
               dict(compress=True, min_size=64, packed=True),
               dict(compress=True, min_size=64, block=32, policy=True)]


@pytest.mark.parametrize("kw", _CKPT_CASES,
                         ids=["raw", "f2p16", "f2p16-packed", "policy"])
def test_checkpoint_files_byte_identical_and_cross_restore(ref, tmp_path,
                                                           kw):
    """MoE leaves (``blocks/b<i>/ff/{router,gate,up,down,shared/*}``,
    stacked ``[G, E, D, F]``) are written as the reference writes them, and
    each package restores the other's files to the same numbers."""
    st = _perturbed(ref)
    state = train_state_from_jax(_np(st), ref.cfg, CPU)
    jkw = dict(kw)
    if kw.get("policy"):
        kw = dict(kw, policy=default_policy(ref.arch))
        jkw["policy"] = jdefault_policy(ref.arch)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(dj, 2, st, **jkw)
    checkpoint.save(dt, 2, state, **kw)
    for f in ("data.bin", "index.json", "COMMITTED") + (
            ("policy.json",) if "policy" in kw else ()):
        with open(os.path.join(dj, "step_2", f), "rb") as a, \
                open(os.path.join(dt, "step_2", f), "rb") as b:
            assert a.read() == b.read(), f
    idx = json.load(open(os.path.join(dt, "step_2", "index.json")))
    gate = "['params']['blocks']['b%d']['ff']['gate']" % next(
        i for i, b in enumerate(ref.cfg.pattern) if b.ff == "moe")
    want_codec = "qtensor" if kw.get("compress") else "raw"
    assert idx["leaves"][gate]["codec"] == want_codec
    assert idx["leaves"][gate]["shape"] == [
        ref.cfg.n_groups, ref.cfg.n_experts, ref.cfg.d_model, ref.cfg.d_ff]
    # the port restores JAX's files == JAX restoring its own, and back
    jown, _ = jckpt.restore(dj, st)
    target = train_state_from_jax(_np(jax.tree.map(jnp.zeros_like, st)),
                                  ref.cfg, CPU)
    got, step = checkpoint.restore(dj, target)
    assert step == 2
    jown = _np(jown)
    for name, p in got["params"].named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), _ref_leaf(
            jown["params"], name, ref.P), err_msg=name)
    for k in ("mu", "nu"):
        for name, t in got["opt"][k].items():
            np.testing.assert_array_equal(t.numpy(), _ref_leaf(
                jown["opt"][k], name, ref.P), err_msg=name)
    for name, t in got["residuals"].items():
        if t is not None:
            np.testing.assert_array_equal(t.numpy(), _ref_leaf(
                jown["residuals"], name, ref.P), err_msg=name)
    jfrom_t, _ = jckpt.restore(dt, st)
    for a, b in zip(jax.tree.leaves(jfrom_t), jax.tree.leaves(jown)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# chunked attention and opt_bwd_cast
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,kv_len,H,K,Sq,Sk,chunk,q_offset", [
    (True, None, 4, 4, 16, 16, 4, 0),     # causal, MHA
    (False, 11, 4, 2, 5, 16, 8, 0),       # a kv_len mask, GQA
    (True, None, 6, 2, 20, 20, 8, 0),     # GQA, 8 does not divide 20
    (True, 17, 4, 1, 6, 21, 5, 12),       # all of it, and a q offset
], ids=["causal", "kv_len", "gqa-ragged", "offset-mqa"])
def test_chunked_attention_matches_reference(causal, kv_len, H, K, Sq, Sk,
                                             chunk, q_offset):
    """Output and its gradients by q, k and v (autograd through the chunk
    loop) against the reference's ``chunked_attention`` and ``jax.grad``;
    the port's chunked output also equals its naive one within 1e-5."""
    rng = np.random.default_rng(Sq * Sk + chunk)
    hd, B = 16, 2
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for S, n in ((Sq, H), (Sk, K), (Sk, K)))
    ct = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    kw = dict(causal=causal, chunk=chunk, q_offset=q_offset, kv_len=kv_len)

    def jf(q, k, v):
        out = jchunked(q, k, v, **kw)
        return jnp.sum(out * ct), out

    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = chunked_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    naive = naive_attention(tq.detach(), tk.detach(), tv.detach(),
                            causal=causal, q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(out.detach().numpy(), naive.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["llama3_2_3b", SCOUT])
def test_chunked_train_forward_matches_jax(arch):
    """``attn_impl="chunked"`` with a chunk of 6 over 16 positions: loss and
    gradients against the reference's chunked train forward."""
    over = dict(attn_impl="chunked", attn_chunk=6, remat=False)
    jcfg = dataclasses.replace(jsmoke(arch), **over)
    cfg = dataclasses.replace(smoke_config(arch), **over)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    b = _batch()
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtrain_forward(p, {k: jnp.asarray(v) for k, v in
                                     b.items()}, jcfg), has_aux=True)(jp)
    model = params_from_jax(_np(jp), cfg, CPU)
    model.requires_grad_(True)
    loss, _, grads = loss_and_grads(
        model, {k: torch.from_numpy(v) for k, v in b.items()}, cfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    jg = _np(jg)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), _ref_leaf(jg, name, 1),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


def test_chunked_prefill_matches_jax():
    """Prefill logits and the packed KV caches' dequantized contents under
    ``attn_impl="chunked"`` (chunk 8 over 20 positions) against JAX's."""
    over = dict(attn_impl="chunked", attn_chunk=8)
    jcfg = dataclasses.replace(jsmoke("llama3_2_3b"), **over)
    cfg = dataclasses.replace(smoke_config("llama3_2_3b"), **over)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(_np(jp), cfg, CPU)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 20))
    toks = toks.astype(np.int32)
    jc = jinit_caches(jcfg, 2, 32, quantized_kv=True, packed_kv=True)
    jlog, _ = jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, jc)
    tc = init_caches(cfg, 2, 32, quantized_kv=True, device=CPU)
    tlog = prefill(model, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    naive = prefill(params_from_jax(_np(jp), smoke_config("llama3_2_3b"),
                                    CPU), torch.from_numpy(toks).long(),
                    init_caches(cfg, 2, 32, quantized_kv=True, device=CPU))
    np.testing.assert_allclose(tlog.numpy(), naive.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_opt_bwd_cast_grads_match_jax():
    """bf16 smoke scout with ``opt_bwd_cast``: each gradient's dtype is the
    reference's (bf16, the router f32) and its values track JAX's; in the
    port the flag is inert, so every gradient bit is as it is without it."""
    over = dict(dtype="bfloat16", opt_bwd_cast=True, remat=False)
    jcfg = dataclasses.replace(jsmoke(SCOUT), **over)
    cfg = dataclasses.replace(smoke_config(SCOUT), **over)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    b = _batch()
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtrain_forward(p, {k: jnp.asarray(v) for k, v in
                                     b.items()}, jcfg), has_aux=True)(jp)
    np_p = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    grads = {}
    for cast in (True, False):
        model = params_from_jax(np_p, dataclasses.replace(
            cfg, opt_bwd_cast=cast), CPU)
        model.requires_grad_(True)
        loss, _, g = loss_and_grads(model, tb, dataclasses.replace(
            cfg, opt_bwd_cast=cast))
        grads[cast] = {n: t.clone() for n, t in g.items()}
        if cast:
            np.testing.assert_allclose(float(loss), float(jl), rtol=1e-2)
    assert len(jax.tree.leaves(jg)) == len(
        {reference_path(n, 1)[0] for n in grads[True]})
    for name, g in grads[True].items():
        path, layer = reference_path(name, 1)
        w = jg
        for k in path:
            w = w[k]
        w = w if layer is None else w[layer]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
        assert torch.equal(g, grads[False][name]), name
        got = g.to(torch.float32).numpy()
        want = np.asarray(w.astype(jnp.float32))
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rel <= 1e-2, (name, rel)
