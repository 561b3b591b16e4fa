"""Port parity, B3's KV write: ``f2p_kv_write`` against the JAX reference.

The same K/V rows (numpy seed, with one NaN block) and the same prior cache
contents go through the reference's cache writes
(``repro.models.attention._paged_cache_write`` and ``_cache_write``, on the
CPU as the reference's own tests run them) and through the port's
``f2p_kv_write`` on CPU tensors (its plain version). Words and scales must
be BITWISE equal, over 6-, 8- and 16-bit formats, paged and dense
addressing, an int and a per-slot ``[B]`` start, a decode write (S = 1) and
a prefill-like write (S = 5, crossing pages), f32 and bf16 inputs.

Retired slots point every table entry at the dump page, so several slots
may write the same dump rows: the comparison above excludes the dump page.
The reference's paged write takes one token per slot, so at S = 5 the paged
reference is its quantize followed by its page arithmetic row by row.
Where rows share a position, the port's write keeps the last row in (slot,
position) order, as the reference's scatter does on the CPU: a separate
test points every slot at one dump position and compares the whole cache.
"""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as JQT
from repro.core.formats import named_format as jnamed
from repro.models import attention as JATT
from repro_torch.core import qtensor as TQ
from repro_torch.core.formats import named_format
from repro_torch.kernels import f2p_quant as Q
from repro_torch.kernels.bits import packed_words
from repro_torch.models import attention as TATT

FMTS = ["f2p_sr_2_6s", "f2p_sr_2_8s", "f2p_lr_2_16s"]
B, K, HD, T, MAXP, P = 4, 2, 32, 4, 3, 9
SMAX = MAXP * T
DUMP = 0          # the paged pool's dump page; slots 2 and 3 are retired


def _rows(rng, S, dtype):
    """k, v [B, S, K, HD] as f32 numpy (bf16-exact for bf16) with a NaN in
    one block of k."""
    out = []
    for _ in range(2):
        x = (rng.standard_normal((B, S, K, HD)) * 3).astype(np.float32)
        if dtype == "bf16":
            x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        out.append(x)
    out[0][1, 0, 1, 3] = np.nan
    return out


def _cache(rng, name, lead):
    """Prior cache contents: random words and scales of ``lead + (K, W)``."""
    W = packed_words(HD, named_format(name).n_bits)
    codes = rng.integers(0, 1 << 32, (*lead, K, W), dtype=np.uint64).astype(
        np.uint32)
    scales = rng.standard_normal((*lead, K, 1)).astype(np.float32)
    return codes, scales


def _torch_cache(name, parts):
    fmt = named_format(name)
    return {kv: TQ.QTensor.from_parts(
        torch.from_numpy(c.view(np.int32).copy()).view(torch.uint32),
        torch.from_numpy(s.copy()), fmt, HD, (*c.shape[:-1], HD),
        packed=True) for kv, (c, s) in parts.items()}


def _jax_cache(name, parts):
    fmt = jnamed(name)
    return {kv: JQT.QTensor.from_parts(
        jnp.asarray(c), jnp.asarray(s), fmt, HD, (*c.shape[:-1], HD),
        packed=True) for kv, (c, s) in parts.items()}


def _positions(rng, S, per_slot):
    if per_slot:
        return rng.integers(0, SMAX - S + 1, (B,)).astype(np.int64)
    return int(rng.integers(0, SMAX - S + 1))


def _page_table(rng):
    """Slots 0-1 own distinct pages, slots 2-3 are retired (dump page)."""
    pages = np.full((B, MAXP), DUMP, np.int32)
    pages[:2] = rng.permutation(np.arange(1, P))[:2 * MAXP].reshape(2, MAXP)
    return pages


def _jax_inputs(x, dtype):
    """The bits the port gets (a NaN's sign included)."""
    if dtype == "bf16":
        bits = _torch_inputs(x, dtype).view(torch.int16).numpy()
        return jnp.asarray(bits).view(jnp.bfloat16)
    return jnp.asarray(x)


def _torch_inputs(x, dtype):
    return torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16"
                                  else torch.float32)


def _paged_reference(name, parts, k, v, pos, pages, dtype):
    """The reference's paged write: its ``_paged_cache_write`` for one
    token per slot, else its quantize and page arithmetic per row."""
    S = k.shape[1]
    jc = _jax_cache(name, parts)
    jk, jv = _jax_inputs(k, dtype), _jax_inputs(v, dtype)
    if S == 1:
        out = JATT._paged_cache_write(jc, jk, jv, jnp.asarray(pos),
                                      jnp.asarray(pages))
        return {kv: (np.asarray(out[kv].codes), np.asarray(out[kv].scales))
                for kv in ("k", "v")}
    res = {}
    p = np.broadcast_to(np.asarray(pos).reshape(-1, 1), (B, 1)) \
        + np.arange(S)
    for kv, x in (("k", jk), ("v", jv)):
        up = JATT.quantize_kv(x, jc[kv].fmt, packed=True)
        codes, scales = (np.array(parts[kv][0]), np.array(parts[kv][1]))
        uc, us = np.asarray(up.codes), np.asarray(up.scales)
        for b in range(B):
            for s in range(S):
                page = pages[b, p[b, s] // T]
                codes[page, p[b, s] % T] = uc[b, s]
                scales[page, p[b, s] % T] = us[b, s]
        res[kv] = (codes, scales)
    return res


def _assert_bitwise(got, want, paged):
    keep = slice(DUMP + 1, None) if paged else slice(None)
    for kv in ("k", "v"):
        gc = got[kv].codes.view(torch.int32).numpy()[keep]
        gs = got[kv].scales.numpy().view(np.int32)[keep]
        np.testing.assert_array_equal(gc, want[kv][0].view(np.int32)[keep])
        np.testing.assert_array_equal(gs, want[kv][1].view(np.int32)[keep])


@pytest.mark.parametrize("name", FMTS)
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("per_slot", [True, False], ids=["pos_b", "pos_int"])
@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kv_write_bitwise_vs_reference(name, paged, per_slot, S, dtype):
    rng = np.random.default_rng([FMTS.index(name), paged, per_slot, S,
                                 dtype == "bf16"])
    k, v = _rows(rng, S, dtype)
    lead = (P, T) if paged else (B, SMAX)
    parts = {"k": _cache(rng, name, lead), "v": _cache(rng, name, lead)}
    pos = _positions(rng, S, per_slot)
    tpos = torch.from_numpy(pos) if per_slot else pos
    tc = _torch_cache(name, parts)
    if paged:
        pages = _page_table(rng)
        want = _paged_reference(name, parts, k, v, pos, pages, dtype)
        Q.f2p_kv_write(_torch_inputs(k, dtype), _torch_inputs(v, dtype), tc,
                       tpos, torch.from_numpy(pages))
    else:
        out = JATT._cache_write(_jax_cache(name, parts),
                                _jax_inputs(k, dtype), _jax_inputs(v, dtype),
                                jnp.asarray(pos) if per_slot else pos)
        want = {kv: (np.asarray(out[kv].codes), np.asarray(out[kv].scales))
                for kv in ("k", "v")}
        Q.f2p_kv_write(_torch_inputs(k, dtype), _torch_inputs(v, dtype), tc,
                       tpos)
    _assert_bitwise(tc, want, paged)


@pytest.mark.parametrize("S", [1, 5])
def test_kv_write_shared_positions_last_row_wins(S):
    """Every slot's table on the dump page at one start: all B rows (and,
    at S = 5, positions across pages of the one dump page) share cache
    positions; the whole cache, the dump page included, equals the
    reference's (its scatter for S = 1, its row loop at S = 5)."""
    name = "f2p_sr_2_8s"
    rng = np.random.default_rng([7, S])
    k, v = _rows(rng, S, "f32")
    parts = {"k": _cache(rng, name, (P, T)), "v": _cache(rng, name, (P, T))}
    pages = np.full((B, MAXP), DUMP, np.int32)
    pos = np.full((B,), 2, np.int64)
    want = _paged_reference(name, parts, k, v, pos, pages, "f32")
    tc = _torch_cache(name, parts)
    Q.f2p_kv_write(_torch_inputs(k, "f32"), _torch_inputs(v, "f32"), tc,
                   torch.from_numpy(pos), torch.from_numpy(pages))
    for kv in ("k", "v"):
        np.testing.assert_array_equal(
            tc[kv].codes.view(torch.int32).numpy(),
            want[kv][0].view(np.int32))
        np.testing.assert_array_equal(tc[kv].scales.numpy(), want[kv][1])


def _old_paged_cache_write(cache, k, v, pos, pages):
    """The composition B3 replaces in the paged decode write: the page
    arithmetic, then per K and V a packed quantize and two scatters."""
    T_ = cache["k"].codes.shape[1]
    Bn = pages.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64).expand(Bn)
    col = torch.clamp(pos // T_, max=pages.shape[1] - 1)
    pidx = pages[torch.arange(Bn), col].to(torch.int64)
    off = pos % T_
    for name, x in (("k", k), ("v", v)):
        slab = cache[name]
        up = TATT.quantize_kv(x, slab.fmt)
        slab.codes.view(torch.int32)[pidx, off] = up.codes[:, 0].view(
            torch.int32)
        slab.scales[pidx, off] = up.scales[:, 0]


def _old_cache_write(cache, k, v, idx):
    """The composition B3 replaces in the dense writes: per K and V a
    packed quantize, then a per-slot scatter or a slice copy."""
    for name, x in (("k", k), ("v", v)):
        c = cache[name]
        up = TATT.quantize_kv(x, c.fmt)
        dst_w, src_w = c.codes.view(torch.int32), up.codes.view(torch.int32)
        if isinstance(idx, torch.Tensor) and idx.ndim:
            rows = torch.arange(x.shape[0])[:, None]
            cols = idx[:, None] + torch.arange(x.shape[1])
            dst_w[rows, cols] = src_w
            c.scales[rows, cols] = up.scales
        else:
            dst_w[:, idx:idx + x.shape[1]].copy_(src_w)
            c.scales[:, idx:idx + x.shape[1]].copy_(up.scales)


@pytest.mark.parametrize("name", FMTS)
def test_cache_writes_match_the_old_composition(name):
    """The model's ``_paged_cache_write`` and ``_cache_write`` leave the
    slabs and caches bitwise as the composition they replace did, including
    a live slot at the table's last page and a retired slot past the table
    (clamped onto its last entry, the dump page, which is excluded)."""
    rng = np.random.default_rng(7)
    k, v = _rows(rng, 1, "bf16")
    tk, tv = _torch_inputs(k, "bf16"), _torch_inputs(v, "bf16")
    parts = {"k": _cache(rng, name, (P, T)), "v": _cache(rng, name, (P, T))}
    pages = torch.from_numpy(_page_table(rng))
    pos = torch.tensor([3, SMAX - 1, 5, SMAX + 6])
    new, old = _torch_cache(name, parts), _torch_cache(name, parts)
    TATT._paged_cache_write(new, tk, tv, pos, pages)
    _old_paged_cache_write(old, tk, tv, pos, pages)
    _assert_bitwise(new, {kv: (old[kv].codes.view(torch.int32).numpy(),
                               old[kv].scales.numpy()) for kv in old}, True)

    parts = {"k": _cache(rng, name, (B, SMAX)),
             "v": _cache(rng, name, (B, SMAX))}
    for S, idx in ((1, torch.tensor([0, 4, 11, 7])), (5, 6),
                   (5, torch.tensor([2, 0, 7, 3]))):
        k, v = _rows(rng, S, "f32")
        tk, tv = _torch_inputs(k, "f32"), _torch_inputs(v, "f32")
        new, old = _torch_cache(name, parts), _torch_cache(name, parts)
        TATT._cache_write(new, tk, tv, idx)
        _old_cache_write(old, tk, tv, idx)
        _assert_bitwise(new, {kv: (old[kv].codes.view(torch.int32).numpy(),
                                   old[kv].scales.numpy()) for kv in old},
                        False)


def test_kv_write_strided_rows_equal_contiguous():
    """K/V read at their strides (a head slice of a wider tensor, a
    transposed layout) write what their contiguous copies write."""
    rng = np.random.default_rng(3)
    name = "f2p_sr_2_8s"
    wide = torch.from_numpy(
        (rng.standard_normal((B, 1, 2 * K, HD)) * 3).astype(np.float32))
    k = wide[:, :, ::2]
    v = torch.from_numpy((rng.standard_normal((B, K, 1, HD))).astype(
        np.float32)).transpose(1, 2)
    parts = {"k": _cache(rng, name, (P, T)), "v": _cache(rng, name, (P, T))}
    pages = torch.from_numpy(_page_table(rng))
    pos = torch.tensor([1, 6, 2, 2])
    a, b = _torch_cache(name, parts), _torch_cache(name, parts)
    Q.f2p_kv_write(k, v, a, pos, pages)
    Q.kv_write_plain(k.contiguous(), v.contiguous(), b, pos, pages)
    _assert_bitwise(a, {kv: (b[kv].codes.view(torch.int32).numpy(),
                             b[kv].scales.numpy()) for kv in b}, True)


@pytest.mark.parametrize("what", ["k_rank", "v_shape", "cache_width",
                                  "block", "pages_rows", "dense_rows"])
def test_kv_write_rejects_mismatched_shapes(what):
    rng = np.random.default_rng(5)
    name = "f2p_sr_2_8s"
    k = torch.zeros(B, 1, K, HD)
    v = torch.zeros(B, 1, K, HD)
    lead = (P, T)
    pages = torch.zeros(B, MAXP, dtype=torch.int32)
    if what == "k_rank":
        k = k[:, 0]
    elif what == "v_shape":
        v = torch.zeros(B, 1, K, HD // 2)
    elif what == "pages_rows":
        pages = pages[:2]
    elif what == "dense_rows":
        lead, pages = (B + 1, SMAX), None
    cache = _torch_cache(name, {"k": _cache(rng, name, lead),
                                "v": _cache(rng, name, lead)})
    if what == "cache_width":
        c = cache["v"]
        cache["v"] = TQ.QTensor(c.codes[..., :-1], c.scales, c.fmt, c.block,
                                c.shape, True)
    elif what == "block":
        c = cache["k"]
        cache["k"] = TQ.QTensor(c.codes, c.scales, c.fmt, HD // 2, c.shape,
                                True)
    with pytest.raises(ValueError):
        Q.f2p_kv_write(k, v, cache, 0, pages)
