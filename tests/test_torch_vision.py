"""Port parity, internvl2 (projected patch embeddings in front of the
tokens) against the JAX reference at smoke size (f32, the reference's
weights carried over by ``params_from_jax``, inputs drawn with numpy from
a seed).

* ``train_forward`` with patches (labels padded with -1 over the prefix)
  and without: loss within 1e-5, every gradient (``vision_proj`` among
  them) within 1e-4.
* ``prefill(patches=)`` then 8 decode steps from position
  ``vision_tokens + S``, scalar and per-slot: logits within 1e-4, greedy
  tokens equal; a prefill with a ``last_index`` counts the prefix; paged
  == dense bitwise.
* ``arch_for`` gives both frontend archs the reference's family
  (llama-dense); ``Engine`` and ``BatchedEngine`` (paged and copy-in)
  serve internvl2 as text only, with the reference's engines' greedy
  tokens.
"""
import dataclasses

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import decode_step as jdecode
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models import train_forward as jtrain_forward
from repro.serve import BatchedEngine as JBatched
from repro.serve import BatchedServeConfig as JBatchedConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import arch_for as jarch_for
from repro_torch.configs import smoke_config
from repro_torch.models import decode_step, init_caches, prefill
from repro_torch.models.convert import params_from_jax, reference_path
from repro_torch.serve import (BatchedEngine, BatchedServeConfig, Engine,
                               Request, ServeConfig, arch_for)
from repro_torch.train import loss_and_grads
from test_torch_encdec import _to_slabs

CPU = torch.device("cpu")
VLM = "internvl2_1b"


def _pair(**over):
    jcfg = dataclasses.replace(jax_smoke(VLM), **over)
    cfg = dataclasses.replace(smoke_config(VLM), **over)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def pair():
    return _pair(fused_attention=True)


def _patches(cfg, B, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


def _ref_leaf(tree, name):
    path, layer = reference_path(name, 1)
    a = tree
    for k in path:
        a = a[k]
    return np.asarray(a if layer is None else a[layer])


# ---------------------------------------------------------------------------
# train forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_patches", [True, False],
                         ids=["patches", "text-only"])
@pytest.mark.parametrize("remat", [False, True])
def test_train_forward_loss_and_grads_match_reference(with_patches, remat):
    jcfg, jparams, cfg, model = _pair(remat=remat)
    model.requires_grad_(True)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1              # masked labels stay masked
    batch = {"tokens": toks[:, :-1], "labels": labels}
    if with_patches:
        batch["patches"] = _patches(cfg, 2, seed=2)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtrain_forward(p, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jcfg),
        has_aux=True)(jparams)
    loss, _, grads = loss_and_grads(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jg = jax.tree.map(np.asarray, jg)
    for name, g in grads.items():
        want = _ref_leaf(jg, name)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=name)
    vp = grads["vision_proj"]
    assert bool((vp != 0).any()) == with_patches


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per-slot"])
def test_prefill_decode_match_reference(pair, per_slot):
    jcfg, jparams, cfg, model = pair
    B, S0 = 3, 6
    P = cfg.vision_tokens
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S0))
    pt = _patches(cfg, B, seed=3)
    jc = jinit_caches(jcfg, B, 32, quantized_kv=True, packed_kv=True)
    tc = init_caches(cfg, B, 32, quantized_kv=True, device=CPU)
    jl, jc = jax.jit(jprefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(toks), "patches": jnp.asarray(pt)},
        jcfg, jc)
    tl = prefill(model, torch.from_numpy(toks), tc,
                 patches=torch.from_numpy(pt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    step = jax.jit(jdecode, static_argnums=4)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None]
    for i in range(8):
        p = P + S0 + i
        jpos = jnp.full((B,), p, jnp.int32) if per_slot else p
        tpos = torch.full((B,), p) if per_slot else p
        jl, jc = step(jparams, jnp.asarray(tok), jpos, jc, jcfg)
        tl = decode_step(model, torch.from_numpy(tok.copy()), tpos, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        want = np.asarray(jnp.argmax(jl, -1))
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want)
        tok = want[:, None]


def test_prefill_last_index_counts_the_prefix(pair):
    jcfg, jparams, cfg, model = pair
    B, S0 = 2, 6
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S0))
    pt = _patches(cfg, B, seed=5)
    last = np.array([cfg.vision_tokens + 2, cfg.vision_tokens + S0 - 1])
    jl, _ = jprefill(jparams, {"tokens": jnp.asarray(toks),
                               "patches": jnp.asarray(pt)}, jcfg,
                     jinit_caches(jcfg, B, 32), last_index=jnp.asarray(last))
    tl = prefill(model, torch.from_numpy(toks),
                 init_caches(cfg, B, 32, device=CPU),
                 last_index=torch.from_numpy(last),
                 patches=torch.from_numpy(pt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def test_paged_decode_equals_dense_bitwise(pair):
    """One prefill with the prefix; its pages copied into pool slabs at a
    permutation: paged and dense decode agree bitwise."""
    _, _, cfg, model = pair
    B, T, maxp = 3, 8, 4
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 5))
    tc = init_caches(cfg, B, maxp * T, quantized_kv=True, device=CPU)
    prefill(model, torch.from_numpy(toks), tc,
            patches=torch.from_numpy(_patches(cfg, B, seed=6)))
    slabs, pages = _to_slabs(cfg, tc, None, B, T, maxp)
    tok = torch.tensor([[5], [7], [9]])
    pos = torch.full((B,), cfg.vision_tokens + 5)
    for _ in range(3):
        dense = decode_step(model, tok, pos, tc)
        paged = decode_step(model, tok, pos, slabs, pages=pages)
        assert torch.equal(dense, paged)
        tok = torch.argmax(dense, -1)[:, None]
        pos = pos + 1


# ---------------------------------------------------------------------------
# serving: text only, as the reference's engines serve it
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["internvl2_1b", "whisper_large_v3"])
def test_arch_for_is_llama_dense_as_reference(arch):
    a, j = arch_for(smoke_config(arch)), jarch_for(jax_smoke(arch))
    got = (a.name, a.paged_kv, a.recurrent_state, a.exact_cobatch,
           a.prefill_buckets)
    assert got == ("llama-dense", True, False, True, None) == (
        j.name, j.paged_kv, j.recurrent_state, j.exact_cobatch,
        j.prefill_buckets)


def _spec(cfg, n, seed=0, stagger=3):
    rng = np.random.default_rng(seed)
    return [(u + 1, rng.integers(0, cfg.vocab_size,
                                 int(rng.integers(4, 20))).astype(np.int32),
             int(rng.integers(3, 12)), stagger * u) for u in range(n)]


def test_sequential_engine_matches_reference(pair):
    jcfg, jparams, cfg, model = pair
    spec = _spec(cfg, 3, seed=1)
    eng = Engine(cfg, ServeConfig(batch=1, max_seq=64, quantized_kv=True,
                                  fused_attention=True), model)
    jeng = JEngine(jcfg, JServeConfig(batch=1, max_seq=64, quantized_kv=True,
                                      packed_kv=True, fused_attention=True),
                   jparams)
    for _, t, m, _ in spec:
        got = eng.generate(t[None], m)[0]
        want = np.asarray(jeng.generate(t[None], m)[0])
        np.testing.assert_array_equal(got.astype(np.int32),
                                      want.astype(np.int32))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "copy-in"])
def test_batched_engine_matches_reference(pair, paged):
    """Mode for mode against the reference's BatchedEngine (FIFO, whole
    uploads, ROADMAP C-ref4): text only on both sides."""
    jcfg, jparams, cfg, model = pair
    spec = _spec(cfg, 5, seed=2)
    kw = dict(slots=3, max_seq=64, paged_decode=paged, scheduler="fifo",
              io_upload="full")
    want = JBatched(jcfg, JBatchedConfig(**kw), jparams).run(
        [JRequest(uid=u, tokens=t, max_new=m, arrival=a)
         for u, t, m, a in spec])
    got = BatchedEngine(cfg, BatchedServeConfig(**kw), model).run(
        [Request(uid=u, tokens=t, max_new=m, arrival=a)
         for u, t, m, a in spec])
    assert sorted(want) == sorted(got)
    for u in want:
        np.testing.assert_array_equal(got[u], np.asarray(want[u]),
                                      err_msg=f"paged={paged}: request {u}")
