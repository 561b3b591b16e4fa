"""Port parity, attention layer: ``attention_packed`` / ``attention_paged``
of ``repro_torch`` against the JAX reference.

Against JAX: within rtol=atol=1e-5 in f32 (XLA and torch sum the dot
products in different orders). The JAX side is the dense xla path or
``attention_paged_reference`` / ``pallas_interpret`` — never the JAX xla
paged path at tiles over 2 pages (ROADMAP C-ref1). Inside the port,
bitwise: paged == dense over ``gather_pages_to_dense`` for each tile, pages
past kv_len contribute exactly 0.0, and kv_len=0 gives exact zeros.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as QT
from repro.core.f2p import F2PFormat as JF2PFormat
from repro.kernels import f2p_attention as JA
from repro_torch.core import qtensor as TQ
from repro_torch.core.f2p import F2PFormat
from repro_torch.kernels import f2p_attention as TA


def _qkv(B, Sq, H, S, K, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    return q, k, v


def _both(x, fmt_args, hd):
    jq = QT.quantize(jnp.asarray(x), JF2PFormat(*fmt_args), block=hd,
                     backend="xla", packed=True)
    tq = TQ.quantize(torch.from_numpy(x), F2PFormat(*fmt_args), block=hd,
                     packed=True)
    return jq, tq


_DENSE = [  # (fmt, B, Sq, H, S, K, hd, tile, kv_len, causal, q_offset)
    ((8, 2, "sr", True), 2, 1, 6, 37, 2, 16, 8, [37, 20], False, 0),
    ((6, 2, "sr", True), 1, 1, 4, 50, 2, 32, 16, 33, False, 0),
    ((16, 2, "lr", True), 2, 1, 6, 24, 3, 16, 128, [5, 24], False, 0),
    ((8, 1, "sr", True), 2, 4, 6, 40, 2, 16, 8, 40, True, 36),
    ((8, 2, "sr", True), 1, 3, 4, 19, 2, 16, 7, None, True, [10]),
]


@pytest.mark.parametrize("case", _DENSE)
def test_attention_packed_matches_jax(case):
    fmt, B, Sq, H, S, K, hd, tile, kv_len, causal, qoff = case
    q, k, v = _qkv(B, Sq, H, S, K, hd, seed=S)
    (jk, tk), (jv, tv) = _both(k, fmt, hd), _both(v, fmt, hd)
    want = JA.attention_packed(jnp.asarray(q), jk, jv, kv_len=kv_len,
                               causal=causal, q_offset=qoff, backend="xla",
                               tile=tile)
    got = TA.attention_packed(torch.from_numpy(q), tk, tv, kv_len=kv_len,
                              causal=causal, q_offset=qoff, tile=tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    ref = TA.attention_packed_reference(torch.from_numpy(q), tk, tv,
                                        kv_len=kv_len, causal=causal,
                                        q_offset=qoff, tile=tile)
    assert torch.equal(got, ref)


def _pool(P, T, K, hd, fmt, seed):
    rng = np.random.default_rng(seed)
    slab = rng.normal(size=(P, T, K, hd)).astype(np.float32)
    return _both(slab, fmt, hd), slab


@pytest.mark.parametrize("tile", [8, 16, 40])
@pytest.mark.parametrize("fmt", [(6, 2, "sr", True), (8, 2, "sr", True),
                                 (16, 2, "lr", True)])
def test_attention_paged_matches_jax_and_gather_bitwise(tile, fmt):
    B, H, K, hd, T, P, maxp = 3, 6, 2, 16, 8, 17, 5
    ((jk, tk), _), ((jv, tv), _) = (_pool(P, T, K, hd, fmt, 1),
                                    _pool(P, T, K, hd, fmt, 2))
    rng = np.random.default_rng(tile)
    pages = rng.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    kv_len = np.array([40, 17, 1], np.int32)
    backend = "pallas_interpret" if tile > 2 * T else "xla"
    want = JA.attention_paged(jnp.asarray(q), jk, jv, jnp.asarray(pages),
                              kv_len=jnp.asarray(kv_len), backend=backend,
                              tile=tile)
    tq = torch.from_numpy(q)
    tp = torch.from_numpy(pages)
    tl = torch.from_numpy(kv_len)
    got = TA.attention_paged(tq, tk, tv, tp, kv_len=tl, tile=tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dense = TA.attention_paged_reference(tq, tk, tv, tp, kv_len=tl, tile=tile)
    assert torch.equal(got, dense)
    # pages past kv_len contribute exactly 0.0: garbage ids change nothing
    junk = tp.clone()
    junk[1, 3:] = torch.tensor([0, 13])
    junk[2, 1:] = 7
    assert torch.equal(TA.attention_paged(tq, tk, tv, junk, kv_len=tl,
                                          tile=tile), got)


def test_kv_len_zero_gives_exact_zeros_and_matches_reference():
    fmt = (8, 2, "sr", True)
    q, k, v = _qkv(2, 1, 4, 16, 2, 16, seed=3)
    (_, tk), (_, tv) = _both(k, fmt, 16), _both(v, fmt, 16)
    out = TA.attention_packed(torch.from_numpy(q), tk, tv,
                              kv_len=torch.tensor([0, 9]), tile=8)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    ref = TA.attention_reference(torch.from_numpy(q), tk.dequantize(),
                                 tv.dequantize(), kv_len=torch.tensor([0, 9]),
                                 tile=8)
    assert torch.equal(out, ref)
    want = JA.attention_reference(jnp.asarray(q), jnp.asarray(tk.dequantize()
                                                              .numpy()),
                                  jnp.asarray(tv.dequantize().numpy()),
                                  kv_len=jnp.asarray([0, 9]), tile=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_paged_rejects_tiles_that_split_pages():
    fmt = (8, 2, "sr", True)
    ((_, tk), _), ((_, tv), _) = _pool(4, 8, 2, 16, fmt, 0), \
        _pool(4, 8, 2, 16, fmt, 1)
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="whole pages"):
        TA.attention_paged(q, tk, tv, torch.tensor([[0, 1]]), tile=12)
