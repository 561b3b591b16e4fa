"""Port parity, the ported families and configs: llama-dense (minitron-4b,
llama3.2-3b, minicpm3-4b, codeqwen1.5-7b) and MoE (llama4-scout,
llama4-maverick), against the JAX reference at smoke size (f32, the
reference's weights carried over by ``params_from_jax``).

* Registry: the arch list, each full config's analytic parameter count
  and each default policy equal the reference's (nothing allocated).
* ``arch_for`` gives the reference's family flags; ``register_architecture``
  adds an entry ``arch_for`` returns.
* Prefill and decode logits within 1e-4 and greedy tokens equal over 8
  decode steps for the five new smoke configs.
* Inside the port, paged decode == dense decode bitwise for scout and
  maverick (whose two attention positions keep their own slabs).
* ``reference_path`` / ``reference_layout`` round trip the names of a
  pattern of two positions.
* ``Engine`` and ``BatchedEngine`` serve every smoke config an engine
  serves (all but whisper, whose engines pass no frames, as the
  reference's).
"""
import dataclasses

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import default_policy as jdefault_policy
from repro.configs import full_config as jfull_config
from repro.configs import smoke_config as jax_smoke
from repro.models import decode_step as jdecode
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.serve import arch_for as jarch_for
from repro_torch.autotune import FormatPolicy
from repro_torch.configs import (ARCH_IDS, default_policy, full_config,
                                 smoke_config)
from repro_torch.core.formats import named_format
from repro_torch.models import decode_step, init_caches, init_params, prefill
from repro_torch.models.convert import (Stacked, params_from_jax,
                                        reference_layout, reference_path)
from repro_torch.serve import (BatchedEngine, BatchedServeConfig, Engine,
                               Request, ServeConfig, SupportedArchitecture,
                               arch_for, register_architecture)
from test_torch_encdec import _to_slabs

CPU = torch.device("cpu")
NEW = ["minitron_4b", "minicpm3_4b", "codeqwen1_5_7b", "llama4_scout_17b",
       "llama4_maverick_400b"]
MOE = ["llama4_scout_17b", "llama4_maverick_400b"]


def _pair(arch, **over):
    jcfg = dataclasses.replace(jax_smoke(arch), **over)
    cfg = dataclasses.replace(smoke_config(arch), **over)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, model


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_arch_ids_param_counts_and_policies_match_reference():
    from repro.configs.registry import ARCH_IDS as J_IDS

    assert ARCH_IDS == J_IDS
    assert set(NEW) | {"llama3_2_3b", "jamba_1_5_large", "xlstm_125m",
                       "whisper_large_v3", "internvl2_1b"} == set(ARCH_IDS)
    for a in ARCH_IDS:
        assert full_config(a).param_count() == jfull_config(a).param_count(), a
        assert smoke_config(a).param_count() == jax_smoke(a).param_count(), a
        assert default_policy(a).to_dict() == jdefault_policy(a).to_dict(), a
    assert default_policy("llama4_scout_17b").rules[0].block == 256


def test_arch_for_flags_and_register_architecture():
    for arch, want in (("llama3_2_3b", ("llama-dense", True, False, True)),
                       ("minicpm3_4b", ("llama-dense", True, False, True)),
                       ("llama4_scout_17b", ("moe", True, False, False)),
                       ("llama4_maverick_400b", ("moe", True, False, False))):
        a, j = arch_for(smoke_config(arch)), jarch_for(jax_smoke(arch))
        got = (a.name, a.paged_kv, a.recurrent_state, a.exact_cobatch)
        assert got == want == (j.name, j.paged_kv, j.recurrent_state,
                               j.exact_cobatch), arch
        assert a.prefill_buckets is j.prefill_buckets is None
    old = arch_for(smoke_config("llama4_scout_17b"))
    try:
        register_architecture(SupportedArchitecture(
            name="moe", paged_kv=True, recurrent_state=False,
            exact_cobatch=True, page_tokens=16, prefill_buckets=(32,)))
        a = arch_for(smoke_config("llama4_maverick_400b"))
        # resolved against the pattern: MoE FFs never co-batch exactly
        assert (a.page_tokens, a.prefill_buckets, a.exact_cobatch) == (
            16, (32,), False)
    finally:
        register_architecture(old)
    assert arch_for(smoke_config("llama4_scout_17b")) == old


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", NEW)
def test_prefill_decode_logits_and_greedy_tokens_match_jax(arch):
    jcfg, jparams, cfg, model = _pair(arch, fused_attention=True)
    B, S0 = 3, 12
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S0))
    jc = jinit_caches(jcfg, B, 32, quantized_kv=True, packed_kv=True)
    tc = init_caches(cfg, B, 32, quantized_kv=True, device=CPU)
    jl, jc = jax.jit(jprefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(toks)}, jcfg, jc)
    step = jax.jit(jdecode, static_argnums=4)
    tl = prefill(model, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None]
    for i in range(8):
        jl, jc = step(jparams, jnp.asarray(tok), S0 + i, jc, jcfg)
        tl = decode_step(model, torch.from_numpy(tok.copy()), S0 + i, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        want = np.asarray(jnp.argmax(jl, -1))
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want)
        tok = want[:, None]


@pytest.mark.parametrize("arch", MOE)
def test_paged_decode_equals_dense_bitwise(arch):
    """Both caches from ONE prefill; the slabs hold the dense rows' pages
    at a permutation, position by position (maverick: two positions, in
    two formats)."""
    pol = FormatPolicy.from_dict({"rules": [
        {"pattern": "kv/b1", "fmt": "f2p_lr_1_6s", "block": 0},
        {"pattern": "kv/*", "fmt": "f2p_sr_2_8s", "block": 0}]})
    cfg = dataclasses.replace(smoke_config(arch), fused_attention=True)
    model = init_params(cfg, seed=0, device=CPU)
    B, T, maxp = 3, 8, 4
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 11))
    tc = init_caches(cfg, B, maxp * T, quantized_kv=True, kv_policy=pol,
                     device=CPU)
    prefill(model, torch.from_numpy(toks), tc)
    slabs, pages = _to_slabs(cfg, tc, pol, B, T, maxp)
    if arch == "llama4_maverick_400b":
        assert slabs["b1"]["k"].fmt == named_format("f2p_lr_1_6s")
        assert slabs["b0"]["k"].fmt == named_format("f2p_sr_2_8s")
    tok = torch.tensor([[5], [7], [9]])
    pos = torch.tensor([11, 11, 11])
    for _ in range(3):
        dense = decode_step(model, tok, pos, tc)
        paged = decode_step(model, tok, pos, slabs, pages=pages)
        assert torch.equal(dense, paged)
        tok = torch.argmax(dense, -1)[:, None]
        pos = pos + 1


# ---------------------------------------------------------------------------
# layout and serving
# ---------------------------------------------------------------------------
def test_reference_layout_round_trip_two_positions():
    cfg = smoke_config("llama4_maverick_400b")
    model = init_params(cfg, seed=0, device=CPU)
    named = dict(model.named_parameters())
    P = len(cfg.pattern)
    assert reference_path("blocks.1.ff.router", P) == (
        ("blocks", "b1", "ff", "router"), 0)
    assert reference_path("blocks.0.ff.gate", P) == (
        ("blocks", "b0", "ff", "gate"), 0)
    layout = reference_layout(named, P)
    jtree = jinit_params(jax_smoke("llama4_maverick_400b"),
                         jax.random.PRNGKey(0))
    jpaths = {tuple(k.key for k in path): leaf.shape for path, leaf in
              jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert set(layout) == set(jpaths)
    for path, leaf in layout.items():
        parts = leaf if isinstance(leaf, Stacked) else [leaf]
        shape = ((len(parts),) if isinstance(leaf, Stacked) else ()) + \
            tuple(parts[0].shape)
        assert shape == jpaths[path], path
    # and back: group g of position b<i> is layer g * P + i
    back = {}
    for path, leaf in layout.items():
        if isinstance(leaf, Stacked):
            for g, t in enumerate(leaf):
                back[".".join(("blocks", str(g * P + int(path[1][1:])),
                               *path[2:]))] = t
        else:
            back[".".join(path)] = leaf
    assert set(back) == set(named)
    assert all(back[n] is named[n] for n in named)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a != "whisper_large_v3"])
def test_engines_serve_every_ported_smoke_config(arch):
    """Engine and BatchedEngine (paged and copy-in) run every ported
    smoke config to the end; for the exact-cobatch family paged == copy-in
    == sequential (an MoE's idle slots take capacity, and they read other
    KV in the two modes)."""
    cfg = smoke_config(arch)
    model = init_params(cfg, seed=1, device=CPU)
    rng = np.random.default_rng(5)
    reqs = [Request(uid=u + 1, tokens=rng.integers(
        0, cfg.vocab_size, 9).astype(np.int32), max_new=6, arrival=2 * u)
        for u in range(4)]
    bs = dict(slots=2, max_seq=32, sync_every=4)
    paged = BatchedEngine(cfg, BatchedServeConfig(**bs), model).run(reqs)
    copy_in = BatchedEngine(cfg, BatchedServeConfig(paged_decode=False, **bs),
                            model).run(reqs)
    eng = Engine(cfg, ServeConfig(batch=1, max_seq=32, quantized_kv=True,
                                  fused_attention=True), model)
    exact = arch_for(cfg).exact_cobatch
    for r in reqs:
        assert len(paged[r.uid]) == len(copy_in[r.uid]) == r.max_new
        seq = eng.generate(r.tokens[None], r.max_new)[0]
        assert seq.shape == (r.max_new,)
        if exact:
            np.testing.assert_array_equal(paged[r.uid], copy_in[r.uid])
            np.testing.assert_array_equal(seq, paged[r.uid])
