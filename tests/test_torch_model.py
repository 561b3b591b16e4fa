"""Port parity, model layer: smoke llama3.2-3b (f32) with the reference's
weights carried over by ``params_from_jax``.

Prefill and decode logits match JAX within rtol=atol=1e-4 (not tighter: a
one-ulp difference in k can land on the other side of an F2P rounding
boundary and move one KV code one step), greedy tokens are equal over 8
decode steps, and inside the port paged decode is bitwise equal to dense
decode when both caches come from ONE prefill call.
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
from repro_torch.configs import smoke_config
from repro_torch.models import decode_step, init_caches, prefill
from repro_torch.models.convert import params_from_jax

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def both():
    jcfg = dataclasses.replace(jax_smoke("llama3_2_3b"), fused_attention=True)
    cfg = dataclasses.replace(smoke_config("llama3_2_3b"),
                              fused_attention=True)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_jax(tree, cfg, CPU), tree


def test_prefill_decode_logits_and_greedy_tokens_match_jax(both):
    jcfg, jparams, cfg, model, _ = both
    B, S, max_seq, steps = 2, 7, 32, 8
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    toks = toks.astype(np.int32)
    jc = jinit_caches(jcfg, B, max_seq, quantized_kv=True, packed_kv=True)
    jlog, jc = jprefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, jc)
    tc = init_caches(cfg, B, max_seq, quantized_kv=True, device=CPU)
    tlog = prefill(model, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    step = jax.jit(lambda p, t, pos, c: jdecode(p, t, pos, c, jcfg))
    jt = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tlog, -1)[:, None]
    for i in range(steps):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        pos = S + i
        jlog, jc = step(jparams, jt, jnp.int32(pos), jc)
        tlog = decode_step(model, tt, pos, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=1e-4, atol=1e-4)
        jt = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tlog, -1)[:, None]
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_bucketed_prefill_last_index_and_unfused_decode(both):
    """Per-row last_index reads each prompt's own last token; the unfused
    decode (whole-cache dequantize + naive attention) matches JAX too."""
    jcfg, jparams, cfg, _, tree = both
    jcfg = dataclasses.replace(jcfg, fused_attention=False)
    cfg = dataclasses.replace(cfg, fused_attention=False)
    model = params_from_jax(tree, cfg, CPU)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 16))
    toks = toks.astype(np.int32)
    last = np.array([4, 15, 9], np.int32)
    jc = jinit_caches(jcfg, 3, 24, quantized_kv=True, packed_kv=True)
    jlog, jc = jprefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, jc,
                        last_index=jnp.asarray(last))
    tc = init_caches(cfg, 3, 24, quantized_kv=True, device=CPU)
    tlog = prefill(model, torch.from_numpy(toks).long(), tc,
                   last_index=torch.from_numpy(last))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    pos = last + 1
    tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    jlog, _ = jdecode(jparams, jnp.asarray(tok), jnp.asarray(pos), jc, jcfg)
    tlog = decode_step(model, torch.from_numpy(tok).long(),
                       torch.from_numpy(pos), tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)


def test_paged_decode_logits_bitwise_vs_dense(both):
    """Both caches come from one prefill; the pool pages are a shuffled
    copy of the dense rows, so only the attention path differs."""
    _, _, cfg, model, _ = both
    B, T, maxp = 3, 8, 4
    S = maxp * T
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 11))
    tc = init_caches(cfg, B, S, quantized_kv=True, device=CPU)
    prefill(model, torch.from_numpy(toks).long(), tc)
    perm = torch.from_numpy(np.random.default_rng(3).permutation(B * maxp + 2))
    P = B * maxp + 2
    L, K, W = cfg.n_layers, cfg.n_kv_heads, tc["b0"]["k"].codes.shape[-1]
    slabs = init_caches(cfg, 1, P * T, quantized_kv=True, device=CPU)
    pages = perm[:B * maxp].reshape(B, maxp).to(torch.int32)
    for kv in ("k", "v"):
        src, dst = tc["b0"][kv], slabs["b0"][kv]
        codes = dst.codes.view(torch.int32).reshape(L, P, T, K, W)
        scales = dst.scales.reshape(L, P, T, K, 1)
        codes[:, pages.flatten().long()] = src.codes.view(torch.int32) \
            .reshape(L, B * maxp, T, K, W)
        scales[:, pages.flatten().long()] = src.scales.reshape(
            L, B * maxp, T, K, 1)
        slabs["b0"][kv] = type(dst)(codes.view(torch.uint32), scales,
                                    dst.fmt, dst.block,
                                    (L, P, T, K, cfg.head_dim), packed=True)
    tok = torch.tensor([[5], [7], [9]])
    pos = torch.tensor([11, 11, 11])
    for _ in range(3):
        dense = decode_step(model, tok, pos, tc)
        paged = decode_step(model, tok, pos, slabs, pages=pages)
        assert torch.equal(dense, paged)
        tok = torch.argmax(dense, -1)[:, None]
        pos = pos + 1
