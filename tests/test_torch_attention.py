"""Port parity, attention layer: ``attention_packed`` / ``attention_paged``
of ``repro_torch`` against the JAX reference.

Against JAX: within rtol=atol=1e-5 in f32 (XLA and torch sum the dot
products in different orders). The JAX side is the dense xla path or
``attention_paged_reference`` / ``pallas_interpret`` — never the JAX xla
paged path at tiles over 2 pages (ROADMAP C-ref1). Inside the port,
bitwise: paged == dense over ``gather_pages_to_dense`` for each tile, pages
past kv_len contribute exactly 0.0, and kv_len=0 gives exact zeros.
"""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as QT
from repro.core.f2p import F2PFormat as JF2PFormat
from repro.kernels import f2p_attention as JA
from repro_torch.core import qtensor as TQ
from repro_torch.core.f2p import F2PFormat
from repro_torch.kernels import cuda as C
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


# ---------------------------------------------------------------------------
# The kernel's host-side plan (the kernel itself runs only on the card:
# tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,K,R,hd,S", [
    (8, 8, 3, 128, 1024),    # serving decode, copy-in (the full max_seq)
    (8, 8, 3, 128, 80),      # paged, a 10-page span bucket
    (3, 2, 12, 64, 96),      # causal multi-query, R = 12
    (2, 2, 6, 16, 257),      # smoke head_dim, one position past a split
    (1, 4, 5, 96, 256),      # R = 5 -> two groups of 3 rows
    (4, 1, 1, 32, 1),        # R = 1 -> one group of 3, two rows masked
    (2, 2, 2, 64, 200),      # R = 2
    (2, 8, 7, 128, 128),     # R = 7 -> two groups of 4
])
def test_attention_plan_arithmetic(B, K, R, hd, S):
    """Grid (splits, K x row groups, B); each CTA takes ATTN_SPLIT
    positions and 3 or 4 rows (the kernel's instances; rows past R are
    masked); the split workspace holds one (acc, m, l) partial per (row,
    head, group, split) and one count per (row, head, group), and there is
    none with one split."""
    p = TA.attention_plan(B, K, R, hd, S)
    assert p.nsplit == max(1, -(-S // TA.ATTN_SPLIT))
    assert p.grid == (p.nsplit, K * p.groups, B)
    assert p.rows in TA.ATTN_ROWS and p.rows * p.groups >= R
    assert (p.groups - 1) * p.rows < R     # no group is empty
    assert p.groups == -(-R // max(TA.ATTN_ROWS))
    if p.nsplit > 1:
        assert p.n_part == B * K * p.groups * p.nsplit * (
            p.rows * hd + 2 * p.rows)
        assert p.n_counts == B * K * p.groups
    else:
        assert p.n_part == p.n_counts == 0


def test_attention_plan_reads_only_shapes_and_no_kv_len():
    """The plan takes shapes only (no tensor, no kv_len: the host never
    reads a device value, so a call never synchronises), and a row's live
    splits ceil(kv_len / split) are the same whatever S the grid covers:
    the paged engine's span bucket and the copy-in engine's max_seq give
    the same split plan for every row, so the same bits."""
    import inspect

    params = inspect.signature(TA.attention_plan).parameters
    assert list(params) == ["B", "K", "R", "hd", "S", "tile"]
    assert params["tile"].default == TA.ATTN_SPLIT
    split = TA.ATTN_SPLIT
    for kv in (1, split - 1, split, split + 1, 4 * split + 37):
        live = -(-kv // split)
        for S in (kv, -(-kv // 8) * 8, 1024 * 8):
            p = TA.attention_plan(8, 8, 3, 128, S)
            assert live <= p.nsplit and p.rows == 3 and p.groups == 1
    # one split per (b, h, group) below the split length: no workspace
    assert TA.attention_plan(8, 8, 3, 128, split).n_part == 0


@pytest.mark.parametrize("hd,S,what", [
    (256, 64, "head_dim"),
    (66, 64, "head_dim"),     # not a multiple of the 4 dims a lane holds
    (128, 64, "tile"),        # 40: not a multiple of the 16-position chunk
])
def test_attention_plan_names_its_limits(hd, S, what):
    """Each limit raises by name; the cache's length is none of them."""
    with pytest.raises(ValueError, match=what):
        TA.attention_plan(2, 2, 3, hd, S, 40 if what == "tile" else 128)
    TA.attention_plan(2, 2, 3, 96 if hd == 66 else 128, 64)   # takes these


def test_len_arg_passes_values_and_tensors_in_place():
    """kv_len / q_offset (and the KV write's positions) reach the kernel
    without a copy: an int (or None) by value, clamped to int32; a [B] or
    one-element int32 / int64 tensor by pointer and stride (0 broadcasts);
    another dtype is cast; a wrong shape raises."""
    a, keep = C.len_arg(None, 3, 77, "cpu")
    assert (a.p, a.value, keep) == (None, 77, None)
    a, _ = C.len_arg(np.int64(2 ** 40), 3, 0, "cpu")
    assert a.p is None and a.value == 2 ** 31 - 1
    t = torch.tensor([5, 6, 7])
    a, keep = C.len_arg(t, 3, 0, "cpu")
    assert keep is t and a.p == t.data_ptr() and a.stride == 1 and a.is64
    a, keep = C.len_arg(torch.tensor(9, dtype=torch.int32), 3, 0, "cpu")
    assert a.stride == 0 and not a.is64 and keep.dtype == torch.int32
    a, keep = C.len_arg(torch.tensor([4.0]), 3, 0, "cpu")
    assert keep.dtype == torch.int32 and a.stride == 0
    a, keep = C.len_arg(torch.arange(6)[::2], 3, 0, "cpu")
    assert a.stride == 2 and a.p == keep.data_ptr()
    with pytest.raises(ValueError, match="scalar or"):
        C.len_arg(torch.tensor([1, 2]), 3, 0, "cpu")
