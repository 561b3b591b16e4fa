"""Port parity, whisper (the encoder-decoder) and the registry of all ten
archs, against the JAX reference at smoke size (f32, the reference's
weights carried over by ``params_from_jax``, inputs drawn with numpy from
a seed).

* Registry: ``ARCH_IDS`` and ``SHAPES`` equal the reference's; whisper's
  and internvl2's full and smoke parameter counts and default policies
  (whisper's ``kv/*`` -> f2p_sr_1_8s) equal its; ``shape_is_applicable``
  and ``input_specs`` (keys, shapes, dtypes) agree for every arch and
  shape; the two archs build, an unknown arch raises ``KeyError``.
* ``sinusoidal_positions`` is bitwise the reference's table.
* The cross-attention branch of ``attention_apply`` and ``encode`` are
  within 1e-5 of the reference's.
* whisper: ``train_forward``'s loss within 1e-5 and every gradient
  (encoder, cross-attention, decoder) within 1e-4; ``prefill(frames=)``
  then 8 ``decode_step(cross_kv=)`` steps under fused packed caches in the
  default policy's format, with a scalar and with a per-slot position:
  logits within 1e-4, greedy tokens equal; paged == dense bitwise.
* Train path: the encoder's names map onto ``encoder/blocks/...`` and
  back; the compressed leaves are the reference's; the checkpoint files
  are byte-identical and each package restores the other's; three train
  steps track the reference's ``make_train_step`` within 1e-4.
* Errors: a prefill without frames raises in both packages, and so do the
  engines and the train CLI, whose data pipeline makes no frames.
"""
import dataclasses
import os

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import default_policy as jdefault_policy
from repro.configs import full_config as jfull_config
from repro.configs import input_specs as jinput_specs
from repro.configs import shape_is_applicable as jshape_is_applicable
from repro.configs import smoke_config as jax_smoke
from repro.configs.registry import ARCH_IDS as J_IDS
from repro.models import attention as JA
from repro.models import decode_step as jdecode
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models import train_forward as jtrain_forward
from repro.models.common import sinusoidal_positions as jsinusoidal
from repro.models.model import _encode as jencode
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import CompressionConfig as JCompressionConfig
from repro.train import checkpoint as jckpt
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import (ARCH_IDS, SHAPES, default_policy,
                                 full_config, get_arch, input_specs,
                                 shape_is_applicable, smoke_config)
from repro_torch.core.formats import named_format
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as A
from repro_torch.models import (decode_step, encode, init_caches,
                                init_params, prefill)
from repro_torch.models.common import sinusoidal_positions
from repro_torch.models.convert import (Stacked, params_from_jax,
                                        reference_layout, reference_path,
                                        train_state_from_jax)
from repro_torch.optim import AdamWConfig, CompressionConfig
from repro_torch.optim.compress import compressed_leaves
from repro_torch.serve import (BatchedEngine, BatchedServeConfig, Engine,
                               ServeConfig)
from repro_torch.train import checkpoint, loss_and_grads, make_train_step

CPU = torch.device("cpu")
WHISPER = "whisper_large_v3"
FRONTENDS = ["whisper_large_v3", "internvl2_1b"]


def _pair(arch=WHISPER, **over):
    jcfg = dataclasses.replace(jax_smoke(arch), **over)
    cfg = dataclasses.replace(smoke_config(arch), **over)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def pair():
    return _pair(fused_attention=True)


def _frames(cfg, B, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _batch(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "frames": _frames(cfg, B, seed + 1)}


def _ref_leaf(tree, name):
    path, layer = reference_path(name, 1)
    a = tree
    for k in path:
        a = a[k]
    return np.asarray(a if layer is None else a[layer])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_arch_ids_and_shapes_equal_reference():
    assert ARCH_IDS == J_IDS
    assert SHAPES == J_SHAPES


@pytest.mark.parametrize("arch", FRONTENDS)
def test_param_count_and_policy_equal_reference(arch):
    assert full_config(arch).param_count() == \
        jfull_config(arch).param_count()
    assert smoke_config(arch).param_count() == jax_smoke(arch).param_count()
    assert default_policy(arch).to_dict() == jdefault_policy(arch).to_dict()


def test_whisper_policy_and_size():
    fmt, _ = default_policy(WHISPER).f2p_for("kv/b0", (A.KV_FMT, 0))
    assert fmt == named_format("f2p_sr_1_8s")
    assert default_policy("internvl2_1b").f2p_for(
        "kv/b0", (A.KV_FMT, 0))[0] == named_format("f2p_sr_2_8s")
    cfg = full_config(WHISPER)
    assert cfg.is_encdec and cfg.encoder_layers == cfg.n_layers == 32
    assert 2.0e9 < cfg.param_count() < 2.05e9


@pytest.mark.parametrize("shape", list(J_SHAPES))
@pytest.mark.parametrize("arch", J_IDS)
def test_input_specs_and_applicability_equal_reference(arch, shape):
    cfg, jcfg = full_config(arch), jfull_config(arch)
    assert shape_is_applicable(cfg, shape) == jshape_is_applicable(jcfg,
                                                                   shape)
    got, want = input_specs(cfg, shape), jinput_specs(jcfg, shape)
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k


def test_input_specs_sharding_names_a12():
    """``sharding_fn`` is called with the reference's logical axes, input
    by input, and its result rides on each stand-in as ``.sharding``."""
    for shape in ("train_4k", "decode_32k"):
        got, want = [], []
        specs = input_specs(full_config(WHISPER), shape,
                            sharding_fn=lambda axes: got.append(axes) or
                            ("sh",) + tuple(axes))
        jinput_specs(jfull_config(WHISPER), shape,
                     sharding_fn=lambda axes: want.append(axes))
        assert got == [tuple(a) for a in want]
        assert specs["frames"].sharding == ("sh", "batch", None, None)
        assert sorted(repr(t.sharding) for t in specs.values()) == \
            sorted(repr(("sh",) + a) for a in got)


@pytest.mark.parametrize("arch", FRONTENDS + ["no_such_arch"])
def test_frontend_archs_build_and_unknown_arch_raises(arch):
    if arch not in J_IDS:
        with pytest.raises(KeyError, match="unknown arch"):
            get_arch(arch)
        with pytest.raises(KeyError, match="unknown arch"):
            default_policy(arch)
        return
    cfg = smoke_config(arch)
    model = init_params(cfg, seed=0, device=CPU)
    assert (model.encoder is not None) == cfg.is_encdec
    assert (model.vision_proj is not None) == (cfg.frontend == "vision")
    assert all(torch.isfinite(p).all() for p in model.parameters())


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq,d", [(30, 64), (1500, 1280), (448, 1280)])
def test_sinusoidal_positions_bitwise(seq, d):
    got, want = sinusoidal_positions(seq, d), jsinusoidal(seq, d)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_cross_attention_apply_matches_reference(pair):
    jcfg, jparams, cfg, model = pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["b0"]["cross"])
    want, _ = JA.attention_apply(jp, jnp.asarray(x), jcfg, mode="train",
                                 cross_kv=jnp.asarray(enc))
    cache = object()
    got, back = A.attention_apply(model.blocks[1].cross.weights(),
                                  torch.from_numpy(x), cfg, mode="decode",
                                  cache=cache, cross_kv=torch.from_numpy(enc))
    assert back is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_encode_matches_reference(pair):
    jcfg, jparams, cfg, model = pair
    fr = _frames(cfg, 2, seed=5)
    want = jencode(jparams, jnp.asarray(fr), jcfg)
    got = encode(model, torch.from_numpy(fr))
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# whisper: train forward, prefill, decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [False, True])
def test_train_forward_loss_and_grads_match_reference(remat):
    jcfg, jparams, cfg, model = _pair(remat=remat)
    model.requires_grad_(True)
    batch = _batch(cfg)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtrain_forward(p, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jcfg),
        has_aux=True)(jparams)
    loss, _, grads = loss_and_grads(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jg = jax.tree.map(np.asarray, jg)
    kinds = set()
    for name, g in grads.items():
        want = _ref_leaf(jg, name)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=name)
        kinds.add(name.split(".")[0] + (".cross" if ".cross." in name
                                        else ""))
    assert {"encoder", "blocks", "blocks.cross", "embed"} <= kinds


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per-slot"])
def test_prefill_decode_match_reference(pair, per_slot):
    jcfg, jparams, cfg, model = pair
    B, S0 = 3, 7
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S0))
    fr = _frames(cfg, B, seed=2)
    jpol, pol = jdefault_policy(WHISPER), default_policy(WHISPER)
    jc = jinit_caches(jcfg, B, 32, quantized_kv=True, packed_kv=True,
                      kv_policy=jpol)
    tc = init_caches(cfg, B, 32, quantized_kv=True, kv_policy=pol,
                     device=CPU)
    assert tc["b0"]["k"].fmt == named_format("f2p_sr_1_8s")
    jl, jc = jax.jit(jprefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)},
        jcfg, jc)
    tl = prefill(model, torch.from_numpy(toks), tc,
                 frames=torch.from_numpy(fr))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    jx = jencode(jparams, jnp.asarray(fr), jcfg)
    tx = encode(model, torch.from_numpy(fr))
    step = jax.jit(jdecode, static_argnums=4)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None]
    for i in range(8):
        p = S0 + i
        jpos = jnp.full((B,), p, jnp.int32) if per_slot else p
        tpos = torch.full((B,), p) if per_slot else p
        jl, jc = step(jparams, jnp.asarray(tok), jpos, jc, jcfg, jx)
        tl = decode_step(model, torch.from_numpy(tok.copy()), tpos, tc,
                         cross_kv=tx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        want = np.asarray(jnp.argmax(jl, -1))
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want)
        tok = want[:, None]


def _to_slabs(cfg, tc, pol, B, T, maxp, seed=3):
    """The dense caches' pages copied into pool slabs at a permutation:
    (slabs, page table)."""
    P = B * maxp + 2
    slabs = init_caches(cfg, 1, P * T, quantized_kv=True, kv_policy=pol,
                        device=CPU)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(P))
    pages = perm[:B * maxp].reshape(B, maxp).to(torch.int32)
    G, K = cfg.n_groups, cfg.n_kv_heads
    for key in tc:
        for kv in ("k", "v"):
            src, dst = tc[key][kv], slabs[key][kv]
            W = src.codes.shape[-1]
            codes = dst.codes.view(torch.int32).reshape(G, P, T, K, W)
            scales = dst.scales.reshape(G, P, T, K, 1)
            codes[:, pages.flatten().long()] = src.codes.view(
                torch.int32).reshape(G, B * maxp, T, K, W)
            scales[:, pages.flatten().long()] = src.scales.reshape(
                G, B * maxp, T, K, 1)
            slabs[key][kv] = type(dst)(codes.view(torch.uint32), scales,
                                       dst.fmt, dst.block,
                                       (G, P, T, K, cfg.head_dim),
                                       packed=True)
    return slabs, pages


def test_paged_decode_equals_dense_bitwise(pair):
    _, _, cfg, model = pair
    pol = default_policy(WHISPER)
    B, T, maxp = 3, 8, 4
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 11))
    fr = torch.from_numpy(_frames(cfg, B, seed=6))
    tc = init_caches(cfg, B, maxp * T, quantized_kv=True, kv_policy=pol,
                     device=CPU)
    prefill(model, torch.from_numpy(toks), tc, frames=fr)
    slabs, pages = _to_slabs(cfg, tc, pol, B, T, maxp)
    assert slabs["b0"]["k"].fmt == named_format("f2p_sr_1_8s")
    cross = encode(model, fr)
    tok = torch.tensor([[5], [7], [9]])
    pos = torch.tensor([11, 12, 13])
    for _ in range(3):
        dense = decode_step(model, tok, pos, tc, cross_kv=cross)
        paged = decode_step(model, tok, pos, slabs, pages=pages,
                            cross_kv=cross)
        assert torch.equal(dense, paged)
        tok = torch.argmax(dense, -1)[:, None]
        pos = pos + 1


# ---------------------------------------------------------------------------
# errors: whisper needs its frames
# ---------------------------------------------------------------------------
def test_prefill_without_frames_raises_in_both_packages(pair):
    jcfg, jparams, cfg, model = pair
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(KeyError, match="frames"):
        jprefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                 jinit_caches(jcfg, 1, 16))
    with pytest.raises(KeyError, match="frames"):
        prefill(model, torch.from_numpy(toks), init_caches(cfg, 1, 16,
                                                           device=CPU))


@pytest.mark.parametrize("engine", ["Engine", "BatchedEngine"])
def test_engines_pass_no_frames_and_raise(pair, engine):
    _, _, cfg, model = pair
    prompt = np.arange(5, dtype=np.int32)
    with pytest.raises(KeyError, match="frames"):
        if engine == "Engine":
            Engine(cfg, ServeConfig(batch=1, max_seq=32), model).generate(
                prompt[None], 4)
        else:
            from repro_torch.serve import Request

            BatchedEngine(cfg, BatchedServeConfig(slots=1, max_seq=32),
                          model).run([Request(uid=1, tokens=prompt,
                                              max_new=4)])


def test_train_cli_whisper_fails_for_want_of_frames(tmp_path):
    """The data pipeline makes tokens and labels only: whisper's first step
    raises naming frames, as the reference's train forward does."""
    from repro.data import DataConfig as JDataConfig
    from repro.data import host_batch as jhost_batch

    jcfg = jax_smoke(WHISPER)
    jb = jhost_batch(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=8,
                                 global_batch=2), 0)
    with pytest.raises(KeyError, match="frames"):
        jtrain_forward(jinit_params(jcfg, jax.random.PRNGKey(0)),
                       {k: jnp.asarray(v) for k, v in jb.items()}, jcfg)
    with pytest.raises(KeyError, match="frames"):
        launch_train.run(smoke_config(WHISPER), arch=WHISPER, steps=1,
                         global_batch=2, seq=8, ckpt_dir=str(tmp_path),
                         device="cpu", log=lambda *a: None)


# ---------------------------------------------------------------------------
# train path: layout, compression, checkpoints, steps
# ---------------------------------------------------------------------------
def test_reference_layout_round_trip_encoder_names():
    cfg = smoke_config(WHISPER)
    model = init_params(cfg, seed=0, device=CPU)
    named = dict(model.named_parameters())
    assert reference_path("encoder.blocks.1.mixer.wq", 1) == (
        ("encoder", "blocks", "mixer", "wq"), 1)
    assert reference_path("encoder.norm", 1) == (("encoder", "norm"), None)
    assert reference_path("blocks.1.cross.wk", 1) == (
        ("blocks", "b0", "cross", "wk"), 1)
    layout = reference_layout(named, 1)
    jtree = jinit_params(jax_smoke(WHISPER), jax.random.PRNGKey(0))
    jpaths = {tuple(k.key for k in path): leaf.shape for path, leaf in
              jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert set(layout) == set(jpaths)
    for path, leaf in layout.items():
        parts = leaf if isinstance(leaf, Stacked) else [leaf]
        shape = ((len(parts),) if isinstance(leaf, Stacked) else ()) + \
            tuple(parts[0].shape)
        assert shape == jpaths[path], path
    back = {}
    for path, leaf in layout.items():
        if not isinstance(leaf, Stacked):
            back[".".join(path)] = leaf
            continue
        # encoder/blocks/<rest>[l] and blocks/b0/<rest>[l] (P = 1)
        head = "encoder.blocks" if path[0] == "encoder" else "blocks"
        for g, t in enumerate(leaf):
            back[".".join((head, str(g), *path[2:]))] = t
    assert set(back) == set(named)
    assert all(back[n] is named[n] for n in named)


def _jstate(arch, min_size=512):
    jcfg = jax_smoke(arch)
    return jcfg, jinit_train_state(jcfg, JAdamWConfig(),
                                   JCompressionConfig(min_size=min_size),
                                   jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", FRONTENDS)
def test_compressed_leaves_match_reference(arch):
    jcfg, jst = _jstate(arch)
    cfg = smoke_config(arch)
    state = train_state_from_jax(jax.tree.map(np.asarray, jst), cfg, CPU)
    res = state["residuals"]
    grads = {n: torch.zeros_like(p) for n, p in
             state["params"].named_parameters()}
    names = compressed_leaves(grads, res, CompressionConfig(min_size=512), 1)
    jleaves = {tuple(k.key for k in path): leaf.size for path, leaf in
               jax.tree_util.tree_flatten_with_path(jst["residuals"])[0]}
    got = {}
    for n in names:
        path, layer = reference_path(n, 1)
        got[path] = got.get(path, 0) + grads[n].numel()
    assert got == jleaves


def _train_batches(cfg, n, frontend=True, B=2, S=8):
    """Seeded batches with whisper's frames or internvl2's patches
    (``frontend=False``: tokens and labels only, as the data pipeline
    makes them)."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if frontend:
            extra = "frames" if cfg.is_encdec else "patches"
            rows = cfg.encoder_seq if cfg.is_encdec else cfg.vision_tokens
            b[extra] = rng.standard_normal((B, rows, cfg.d_model)).astype(
                np.float32)
        out.append(b)
    return out


@pytest.mark.parametrize("arch,frontend", [
    (WHISPER, True), ("internvl2_1b", True), ("internvl2_1b", False)],
    ids=["whisper", "internvl2", "internvl2-text-only"])
def test_three_train_steps_match_reference(arch, frontend):
    """Text only, vision_proj gets no gradient but AdamW's weight decay
    still moves it, in both packages."""
    jcfg, jst = _jstate(arch, min_size=64)
    cfg = smoke_config(arch)
    state = train_state_from_jax(jax.tree.map(np.asarray, jst), cfg, CPU)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    jstep = jax.jit(jmake_train_step(jcfg, JAdamWConfig(**ocfg),
                                     JCompressionConfig(min_size=64)))
    tstep = make_train_step(cfg, AdamWConfig(**ocfg),
                            CompressionConfig(min_size=64))
    for b in _train_batches(cfg, 3, frontend):
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = tstep(state, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    jp = jax.tree.map(np.asarray, jst["params"])
    for name, t in state["params"].named_parameters():
        got, want = t.detach().numpy(), _ref_leaf(jp, name)
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rel <= 1e-4, (name, rel)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_checkpoint_byte_identical_and_cross_restore(tmp_path, arch):
    jcfg, jst = _jstate(arch, min_size=64)
    jstep = jax.jit(jmake_train_step(jcfg, JAdamWConfig(),
                                     JCompressionConfig(min_size=64)))
    b = _train_batches(jax_smoke(arch), 1)[0]
    jst, _ = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
    cfg = smoke_config(arch)
    state = train_state_from_jax(jax.tree.map(np.asarray, jst), cfg, CPU)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(dj, 1, jst, compress=True, min_size=64)
    checkpoint.save(dt, 1, state, compress=True, min_size=64)
    for f in ("data.bin", "index.json", "COMMITTED"):
        with open(os.path.join(dj, "step_1", f), "rb") as fa, \
                open(os.path.join(dt, "step_1", f), "rb") as fb:
            assert fa.read() == fb.read(), f
    jown, _ = jckpt.restore(dj, jst)
    target = train_state_from_jax(
        jax.tree.map(lambda x: np.zeros_like(np.asarray(x)), jst), cfg, CPU)
    got, step = checkpoint.restore(dj, target)
    assert step == 1
    jp = jax.tree.map(np.asarray, jown["params"])
    for name, t in got["params"].named_parameters():
        np.testing.assert_array_equal(t.detach().numpy(), _ref_leaf(jp, name),
                                      err_msg=name)
    jfrom_t, _ = jckpt.restore(dt, jst)
    for a, c in zip(jax.tree.leaves(jfrom_t), jax.tree.leaves(jown)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
