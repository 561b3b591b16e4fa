"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels build
with nvcc at first use and have no CPU mode); elsewhere they skip. This
file imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same checks at the full serving shapes.
"""
import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from repro_torch.core import qtensor as QT
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.core.formats import named_format
from repro_torch.kernels import cuda as C
from repro_torch.kernels import f2p_attention as A
from repro_torch.kernels import f2p_counter as FC
from repro_torch.kernels import f2p_matmul as MM
from repro_torch.kernels import f2p_quant as Q
from repro_torch.kernels.bits import unpack_bits

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _non_finite(x, block):
    """A NaN block, a -NaN block and an inf block (rows 2-4), as a
    diverged gradient brings them. A block that holds a NaN has scale 1 in
    the plain version (its absmax is NaN)."""
    x[2, 3] = float("nan")
    x[3, block + 1] = -float("nan")
    x[4, 2 * block + 5] = float("inf")


def _bits(t):
    """Values as integers, so that NaNs compare equal bit for bit."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("name", ["f2p_sr_2_6s", "f2p_sr_2_8s",
                                  "f2p_lr_2_16s"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codec_kernels_bitwise_vs_plain(gen, name, dtype):
    fmt = named_format(name)
    x = (torch.randn(48, 256, generator=gen, device="cuda") * 3).to(dtype)
    x[0, :64] = 0
    _non_finite(x, 64)
    for mode in ("f32", "pow2"):
        w, s = Q.f2p_quantize_packed(x, fmt, block=64, scale_mode=mode)
        pw, ps = Q.quantize_packed_plain(x, fmt, 64, mode)
        assert torch.equal(w.view(torch.int32), pw.view(torch.int32))
        assert torch.equal(_bits(s), _bits(ps))
        for out in (torch.float32, torch.bfloat16):
            assert torch.equal(
                _bits(Q.f2p_dequantize_packed(w, s, fmt, block=64,
                                              out_dtype=out)),
                _bits(Q.dequantize_packed_plain(w, s, fmt, 64, out)))


@pytest.mark.parametrize("name,block,cols,layout", [
    ("f2p_sr_2_8s", 128, 384, "offset"),     # one element per lane
    ("f2p_sr_2_8s", 128, 384, "columns"),    # a strided column view
    ("f2p_sr_2_6s", 8, 48, "contiguous"),    # two blocks per chunk
    ("f2p_lr_2_16s", 200, 600, "contiguous"),  # a block read twice
    ("f2p_sr_2_6s", 128, 384, "contiguous"),  # staged words at block 128
])
def test_quantize_packed_kernel_layouts(gen, name, block, cols, layout):
    """B3's contiguous mode on inputs read at their strides, and on blocks
    whose packed bits do not end on a word (a chunk of several blocks)."""
    fmt = named_format(name)
    n = 40 * cols
    flat = torch.randn(2 * n + 1, generator=gen, device="cuda") * 3
    if layout == "offset":
        x = flat[1:n + 1].view(40, cols)
    elif layout == "columns":
        x = flat[:2 * n].view(40, 2 * cols)[:, ::2]
    else:
        x = flat[:n].view(40, cols)
    _non_finite(x, block)
    C.reset_launches()
    w, s = Q.f2p_quantize_packed(x, fmt, block=block)
    assert C.LAUNCHES["quantize_packed"] == 1
    pw, ps = Q.quantize_packed_plain(x, fmt, block)
    assert torch.equal(w.view(torch.int32), pw.view(torch.int32))
    assert torch.equal(_bits(s), _bits(ps))


def _kv_rows(gen, B, S, K, hd, dtype, layout):
    """k or v [B, S, K, hd] in ``layout``: contiguous, offset by one element
    (unaligned), or a head slice of a wider tensor (strided)."""
    wide = 2 if layout == "strided" else 1
    x = (torch.randn(B, S, wide * K, hd, generator=gen, device="cuda")
         * 3).to(dtype)
    if layout == "strided":
        x = x[:, :, 1::2]
    elif layout == "offset":
        buf = x.new_empty(x.numel() + 1)
        buf[1:] = x.flatten()
        x = buf[1:].view(B, S, K, hd)
    x[0, 0, 0, 5] = float("nan")
    return x


@pytest.mark.parametrize("name", ["f2p_sr_2_6s", "f2p_sr_2_8s",
                                  "f2p_lr_2_16s"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("per_slot", [True, False], ids=["pos_b", "pos_int"])
@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "offset", "strided"])
def test_kv_write_kernel_bitwise_vs_plain(gen, name, paged, per_slot, S,
                                          dtype, layout):
    """B3's KV write (one launch for K and V) against kv_write_plain on the
    card, words and scales bitwise outside the dump page: 6/8/16-bit
    formats, a page table or a dense cache, an int or a [B] start, S = 1
    and S = 5 (positions crossing 4-token pages), f32 and bf16 rows,
    aligned (the vector path), unaligned and strided (one element per
    lane), a NaN block, two retired slots on the dump page."""
    fmt = named_format(name)
    B, K, hd, T, maxp = 6, 8, 128, 4, 5
    smax = maxp * T
    P = B * maxp + 1
    k = _kv_rows(gen, B, S, K, hd, dtype, layout)
    v = _kv_rows(gen, B, S, K, hd, dtype, layout)
    lead = (P, T) if paged else (B, smax)
    cache = {kv: QT.quantize(torch.randn(*lead, K, hd, generator=gen,
                                         device="cuda"), fmt, block=hd,
                             packed=True) for kv in ("k", "v")}
    ref = {kv: QT.QTensor(c.codes.clone(), c.scales.clone(), c.fmt, c.block,
                          c.shape, True) for kv, c in cache.items()}
    hi = smax - S + 1
    pos = (torch.randint(0, hi, (B,), generator=gen, device="cuda")
           if per_slot else int(torch.randint(0, hi, (1,), generator=gen,
                                              device="cuda")[0]))
    pages = None
    if paged:
        pages = (1 + torch.randperm(P - 1, generator=gen, device="cuda")[
            :B * maxp]).reshape(B, maxp).to(torch.int32)
        pages[-2:] = 0          # retired slots: every entry the dump page
    C.reset_launches()
    Q.f2p_kv_write(k, v, cache, pos, pages)
    assert C.LAUNCHES["kv_write"] == 1
    assert C.LAUNCHES["quantize_packed"] == 0
    Q.kv_write_plain(k, v, ref, pos, pages)
    torch.cuda.synchronize()
    keep = slice(1, None) if paged else slice(None)
    for kv in ("k", "v"):
        assert torch.equal(cache[kv].codes.view(torch.int32)[keep],
                           ref[kv].codes.view(torch.int32)[keep])
        assert torch.equal(_bits(cache[kv].scales[keep]),
                           _bits(ref[kv].scales[keep]))


def test_kv_write_kernel_raises_on_bad_inputs(gen):
    fmt = named_format("f2p_sr_2_8s")
    k = torch.randn(2, 1, 8, 128, generator=gen, device="cuda")
    cache = {kv: QT.quantize(torch.zeros(9, 8, 8, 128, device="cuda"), fmt,
                             block=128, packed=True) for kv in ("k", "v")}
    pages = torch.zeros(2, 4, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        Q.f2p_kv_write(k.half(), k.half(), cache, 0, pages)
    with pytest.raises(TypeError):
        Q.f2p_kv_write(k, k.bfloat16(), cache, 0, pages)
    with pytest.raises(TypeError):
        Q.f2p_kv_write(k, k, cache, 0, pages.long())
    with pytest.raises(ValueError):
        Q.f2p_kv_write(k, k, cache, torch.zeros(3, dtype=torch.int64,
                                               device="cuda"), pages)
    with pytest.raises(ValueError):
        Q.f2p_kv_write(k[:, :, :4], k[:, :, :4], cache, 0, pages)
    host = {kv: QT.QTensor(c.codes.cpu(), c.scales.cpu(), c.fmt, c.block,
                           c.shape, True) for kv, c in cache.items()}
    with pytest.raises(ValueError, match="CUDA"):
        Q.f2p_kv_write(k, k, host, 0, pages)


# B4: n_bits 4-8, 12 and 16; signed (payload table) and unsigned (256-entry)
_B4_FORMATS = ["f2p_sr_1_4s", "f2p_sr_2_5u", "f2p_sr_2_6s", "f2p_lr_1_7s",
               "f2p_sr_2_8s", "f2p_sr_2_8u", "f2p_lr_2_12s", "f2p_sr_2_16s"]


def _odd_scales(s):
    """A zero, an inf and a NaN scale (where there are three blocks)."""
    flat = s.view(-1)
    for i, x in enumerate((0.0, float("inf"), float("nan"))[:flat.numel()]):
        flat[i] = x


def _packed_rows(gen, fmt, rows, cols, block, offset):
    """words [rows, W] (at ``offset`` words into a buffer: 0 keeps them
    16-byte aligned) and scales of randn x 3 rows, with odd scales."""
    x = torch.randn(rows, cols, generator=gen, device="cuda") * 3
    w, s = Q.quantize_packed_plain(x, fmt, block)
    _odd_scales(s)
    buf = torch.zeros(w.numel() + offset, dtype=torch.int32, device="cuda")
    buf[offset:] = w.view(torch.int32).flatten()
    return buf[offset:].view(torch.uint32).view(w.shape), s


@pytest.mark.parametrize("name", _B4_FORMATS)
@pytest.mark.parametrize("block,cols", [(8, 64), (32, 96), (64, 192),
                                        (128, 128), (200, 600), (256, 512),
                                        (6, 48)])
@pytest.mark.parametrize("rows", [0, 1, 37, 8192])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
def test_dequantize_packed_kernel_bitwise_vs_plain(gen, name, block, cols,
                                                   rows, offset):
    """B4's single mode against dequantize_packed_plain, bitwise, f32 and
    bf16 out: n_bits 4-8, 12, 16; blocks 8-256 (200: rows of 5-, 6- and
    7-bit fields that do not end on a word) and 6 (a block of no whole
    groups of 4), each taking the row path; 0, 1, odd and 8192 rows;
    16-byte aligned and misaligned words; zero, inf and NaN scales."""
    fmt = named_format(name)
    w, s = _packed_rows(gen, fmt, rows, cols, block, offset)
    for out in (torch.float32, torch.bfloat16):
        C.reset_launches()
        got = Q.f2p_dequantize_packed(w, s, fmt, block=block, out_dtype=out)
        assert C.LAUNCHES["dequantize_packed"] == int(rows > 0)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got),
                           _bits(Q.dequantize_packed_plain(w, s, fmt, block,
                                                           out)))


def _kv_stack(gen, kname, vname, L, B, S, K, hd):
    """{"k", "v"} packed caches [L, B, S, K, hd] of randn x 3, in kname /
    vname, with odd scales in every layer."""
    out = {}
    for kv, name in (("k", kname), ("v", vname)):
        c = QT.quantize(torch.randn(L, B, S, K, hd, generator=gen,
                                    device="cuda") * 3, named_format(name),
                        block=hd, packed=True)
        for i in range(L):
            _odd_scales(c.scales[i])
        out[kv] = c
    return out


@pytest.mark.parametrize("kname,vname", [
    ("f2p_sr_2_8s", "f2p_sr_2_8s"), ("f2p_sr_2_6s", "f2p_lr_2_16s"),
    ("f2p_sr_2_8u", "f2p_lr_1_7s"), ("f2p_sr_2_5u", "f2p_sr_1_4s"),
    ("f2p_lr_2_12s", "f2p_sr_2_6s")])
@pytest.mark.parametrize("hd", [64, 100, 128])
@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kv_read_kernel_bitwise_vs_plain(gen, kname, vname, hd, layer,
                                         dtype):
    """B4's K+V mode on a layer view of an L-stacked cache [3, 1, 37, 3,
    hd] (the views of layers 1 and 2 lie off 16-byte boundaries at some
    widths; hd 100 leaves 5-, 6- and 7-bit rows off a word end), K and V
    in their own formats: ONE launch, bitwise kv_read_plain, and the same
    bits on a second call."""
    from repro_torch.models.model import layer_cache

    cache = layer_cache(_kv_stack(gen, kname, vname, 3, 1, 37, 3, hd), layer)
    C.reset_launches()
    got = Q.f2p_kv_read(cache, dtype)
    assert C.LAUNCHES["kv_read"] == 1
    assert C.LAUNCHES["dequantize_packed"] == 0
    again = Q.f2p_kv_read(cache, dtype)
    torch.cuda.synchronize()
    for a, b, c in zip(got, Q.kv_read_plain(cache, dtype), again):
        assert a.dtype == dtype and a.shape == (1, 37, 3, hd)
        assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(a), _bits(c))


def test_kv_read_and_dequantize_on_card_never_run_plain(gen, monkeypatch):
    """No B4 call on CUDA tensors reaches a plain version: the single mode
    (direct, through QTensor.dequantize), the K+V mode (direct, through the
    model's _cache_read)."""
    import types

    from repro_torch.models import attention as MA

    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached a plain path")

    monkeypatch.setattr(Q, "dequantize_packed_plain", refuse)
    monkeypatch.setattr(Q, "kv_read_plain", refuse)
    stack = _kv_stack(gen, "f2p_sr_2_8s", "f2p_sr_2_8s", 2, 2, 16, 2, 128)
    cache = {kv: QT.QTensor(c.codes[1], c.scales[1], c.fmt, c.block,
                            c.shape[1:], True) for kv, c in stack.items()}
    C.reset_launches()
    QT.dequantize(cache["k"], dtype=torch.bfloat16)
    Q.f2p_dequantize_packed(cache["v"].codes.reshape(-1, 32),
                            cache["v"].scales.reshape(-1, 1),
                            cache["v"].fmt)
    Q.f2p_kv_read(cache, torch.float32)
    MA._cache_read(cache, types.SimpleNamespace(torch_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert C.LAUNCHES["dequantize_packed"] == 2
    assert C.LAUNCHES["kv_read"] == 2


def test_kv_read_kernel_raises_on_bad_inputs(gen):
    stack = _kv_stack(gen, "f2p_sr_2_8s", "f2p_sr_2_6s", 1, 1, 8, 2, 128)
    cache = {kv: QT.QTensor(c.codes[0], c.scales[0], c.fmt, c.block,
                            c.shape[1:], True) for kv, c in stack.items()}
    short = dict(cache, v=QT.QTensor(cache["v"].codes[:, :4],
                                     cache["v"].scales[:, :4],
                                     cache["v"].fmt, 128, (1, 4, 2, 128),
                                     True))
    with pytest.raises(ValueError):
        Q.f2p_kv_read(short)
    host = dict(cache, v=QT.QTensor(cache["v"].codes.cpu(),
                                    cache["v"].scales.cpu(), cache["v"].fmt,
                                    128, cache["v"].shape, True))
    with pytest.raises(ValueError):
        Q.f2p_kv_read(host)
    strided = dict(cache, k=QT.QTensor(stack["k"].codes[0, :, ::2],
                                       stack["k"].scales[0, :, ::2],
                                       cache["k"].fmt, 128, (1, 4, 2, 128),
                                       True))
    strided["v"] = QT.QTensor(cache["v"].codes[:, :4],
                              cache["v"].scales[:, :4], cache["v"].fmt, 128,
                              (1, 4, 2, 128), True)
    with pytest.raises(ValueError, match="contiguous"):
        Q.f2p_kv_read(strided)


def _codes_i(c):
    return c.view(torch.int16) if c.dtype == torch.uint16 else c


@pytest.mark.parametrize("name", ["f2p_sr_2_6s", "f2p_sr_2_8s",
                                  "f2p_lr_2_8s", "f2p_sr_2_16s",
                                  "f2p_lr_2_16s"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,offset", [(32, 0), (128, 0), (128, 1),
                                          (256, 0)])
def test_unpacked_codec_kernels_bitwise_vs_plain(gen, name, dtype, block,
                                                 offset):
    """B5 and B6 against their plain versions: codes, scales and values,
    f32 and pow2 scales, f32 and bf16 outputs, zero and non-finite blocks;
    the vectorized kernels (block 128, aligned), the per-element ones on a
    misaligned input (offset 1), a block kept in registers (32) and one
    read twice (256)."""
    fmt = named_format(name)
    n = 37 * 4 * block
    flat = (torch.randn(n + offset, generator=gen, device="cuda") * 3).to(
        dtype)
    x = flat[offset:].view(37, 4 * block)
    x[0, :block] = 0
    x[1] = 0
    _non_finite(x, block)
    for mode in ("f32", "pow2"):
        c, s = Q.f2p_quantize_codes(x, fmt, block=block, scale_mode=mode)
        pc, ps = Q.quantize_plain(x, fmt, block, mode)
        assert c.dtype == Q.code_dtype(fmt)
        assert torch.equal(_codes_i(c), _codes_i(pc))
        assert torch.equal(_bits(s), _bits(ps))
        for out in (torch.float32, torch.bfloat16):
            assert torch.equal(
                _bits(Q.f2p_dequantize_codes(c, s, fmt, block=block,
                                             out_dtype=out)),
                _bits(Q.dequantize_plain(c, s, fmt, block, out)))


def test_unpacked_qtensor_on_card_matches_cpu(gen):
    """Any-rank QTensor through B5/B6 on the card == the CPU plain path,
    with a padded last dim, a 1-D leaf and pack()/unpack() on the card."""
    fmt = named_format("f2p_sr_2_16s")
    for shape, block in (((3, 5, 200), 128), ((3072,), 128), ((7, 64), 64)):
        x = torch.randn(*shape, generator=gen, device="cuda")
        q = QT.quantize(x, fmt, block=block, packed=False)
        qc = QT.quantize(x.cpu(), fmt, block=block, packed=False)
        assert torch.equal(_codes_i(q.codes).cpu(), _codes_i(qc.codes))
        assert torch.equal(q.scales.cpu(), qc.scales)
        assert torch.equal(q.dequantize().cpu(), qc.dequantize())
        back = q.pack().unpack()
        assert torch.equal(_codes_i(back.codes), _codes_i(q.codes))


@pytest.mark.parametrize("name", ["f2p_sr_2_16s", "f2p_lr_2_16s"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_codes_16bit_at_train_width_vs_plain(gen, name, dtype):
    """B5 at the checkpoint's 16-bit formats, rows of 3072 (a train leaf's
    width), f32 and pow2 scales, against the plain quantize."""
    fmt = named_format(name)
    x = (torch.randn(96, 3072, generator=gen, device="cuda") * 1e-3).to(dtype)
    x[0, :128] = 0
    _non_finite(x, 128)
    for mode in ("f32", "pow2"):
        c, s = Q.f2p_quantize_codes(x, fmt, scale_mode=mode)
        pc, ps = Q.quantize_plain(x, fmt, 128, mode)
        assert torch.equal(_codes_i(c), _codes_i(pc))
        assert torch.equal(_bits(s), _bits(ps))


@pytest.mark.parametrize("name", ["f2p_sr_2_8s", "f2p_lr_2_16s"])
def test_table_encode_exhaustive_on_card(gen, name):
    """B5's table encode against the arithmetic f2p_encode / f2p_decode
    over every f32 bit pattern, and the pow2 reciprocal against the IEEE
    divide at the extreme scales."""
    fmt = named_format(name)
    assert Q.encode_check(fmt) == (0, None)
    for scale in (2.0 ** -126, 2.0 ** 127):
        assert Q.encode_check(fmt, scale) == (0, None)


def _same_bits_nan(a, b):
    """Bitwise equal, NaNs by position."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        _bits(torch.where(na, 0, a)), _bits(torch.where(nb, 0, b)))


def _ef_leaves(gen, dtype):
    """Round-trip leaves: aligned, ragged (cols % 128 != 0), cols % 4 != 0
    (the element-wise form), 1-D and 3-D, with an all-zero block, NaN, -NaN
    and inf blocks."""
    shapes = [(48, 256), (5, 200), (7, 130), (3000,), (2, 3, 384)]
    gs = [(torch.randn(s, generator=gen, device="cuda") * 1e-2).to(dtype)
          for s in shapes]
    rs = [torch.randn(s, generator=gen, device="cuda") * 1e-4
          for s in shapes]
    gs[0][0, :128] = 0
    rs[0][0, :128] = 0
    gs[0][4, 200] = float("inf")
    gs[1][1, 150] = float("nan")
    gs[2][3, 129] = -float("nan")
    return gs, rs


@pytest.mark.parametrize("name", ["f2p_sr_2_8s", "f2p_lr_2_8s",
                                  "f2p_sr_2_16s"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ef", [True, False], ids=["ef", "no_ef"])
def test_ef_roundtrip_kernel_bitwise_vs_plain(gen, name, dtype, ef):
    """B5's round-trip mode: gradients and residuals bitwise against
    ef_roundtrip_plain (NaNs by position), one launch for all leaves."""
    fmt = named_format(name)
    gs, rs = _ef_leaves(gen, dtype)
    pg, pr = [g.clone() for g in gs], [r.clone() for r in rs]
    before = C.LAUNCHES["ef_roundtrip"]
    Q.f2p_ef_roundtrip(gs, rs, fmt, error_feedback=ef)
    assert C.LAUNCHES["ef_roundtrip"] == before + 1
    for a, b, c, d in zip(gs, rs, pg, pr):
        Q.ef_roundtrip_plain(c, d, fmt, 128, ef)
        assert _same_bits_nan(a, c)
        assert _same_bits_nan(b, d)


def test_ef_roundtrip_raises_on_what_it_cannot_take(gen):
    fmt = named_format("f2p_sr_2_8s")
    g = torch.randn(64, 256, generator=gen, device="cuda")
    r = torch.zeros_like(g)
    with pytest.raises(ValueError, match="contiguous"):
        Q.f2p_ef_roundtrip([g.t()], [r.t()], fmt)
    with pytest.raises(TypeError, match="f32 or bf16"):
        Q.f2p_ef_roundtrip([g.half()], [r], fmt)
    with pytest.raises(ValueError, match="blocks of 128"):
        Q.f2p_ef_roundtrip([g], [r], fmt, block=64)
    with pytest.raises(ValueError, match="all on the card"):
        Q.f2p_ef_roundtrip([g], [r.cpu()], fmt)
    with pytest.raises(TypeError, match="float32"):
        Q.f2p_ef_roundtrip([g], [r.double()], fmt)
    with pytest.raises(ValueError, match="residual"):
        Q.f2p_ef_roundtrip([g], [r[:32]], fmt)


# (format, head_dim, G, Sq, kv_len per row, causal, tile). R = G * Sq query
# rows; the tile is the kernel's positions per CTA (a multiple of 16) and
# the plain version's kv tile.
_ATTN_CASES = [
    ("f2p_sr_2_8s", 64, 3, 2, (96, 40, 0), True, 16),
    ("f2p_sr_2_8s", 64, 3, 2, (96, 40, 0), True, 32),
    ("f2p_sr_2_8s", 64, 3, 2, (96, 40, 0), True, 128),
    ("f2p_sr_2_8s", 128, 3, 1, (549, 300, 1), False, 128),   # 5 splits
    ("f2p_sr_2_8s", 128, 3, 1, (128, 127, 129), False, 64),  # a split, +-1
    ("f2p_sr_2_6s", 128, 3, 1, (549, 128, 0), False, 128),
    ("f2p_lr_2_16s", 128, 3, 1, (549, 129, 1), False, 128),
    ("f2p_sr_2_6s", 64, 3, 4, (300, 127, 5), True, 16),      # R = 12
    ("f2p_lr_2_16s", 64, 6, 2, (257, 1, 0), True, 128),      # R = 12
    ("f2p_sr_2_8s", 128, 4, 1, (640, 33, 31), False, 128),   # R = 4
    ("f2p_sr_2_8s", 16, 3, 1, (40, 13, 0), False, 16),       # smoke head_dim
    ("f2p_sr_2_8s", 128, 3, 1, (1100, 300, 129), False, 384),  # 3 passes
    ("f2p_sr_2_6s", 64, 3, 2, (700, 513, 1), True, 512),
    # rows past R masked: R = 1 and 2 on the 3-row instance, R = 5 as two
    # groups of 3
    ("f2p_sr_2_8s", 128, 1, 1, (300, 1, 0), False, 128),     # R = 1
    ("f2p_sr_2_6s", 64, 1, 2, (129, 40, 2), True, 64),       # R = 2
    ("f2p_lr_2_16s", 128, 5, 1, (257, 128, 0), False, 128),  # R = 5
]


def _attn_inputs(gen, name, hd, G, Sq, kv, K=2, T=8):
    fmt = named_format(name)
    B = len(kv)
    maxp = -(-max(kv) // T) + 2
    P = B * maxp + 3
    q = torch.randn(B, Sq, K * G, hd, generator=gen, device="cuda")
    slab_k, slab_v = (QT.quantize(torch.randn(P, T, K, hd, generator=gen,
                                              device="cuda"), fmt, block=hd,
                                  packed=True) for _ in range(2))
    pages = torch.randperm(P, generator=gen, device="cuda")[:B * maxp]
    return q, slab_k, slab_v, pages.reshape(B, maxp).to(torch.int32)


@pytest.mark.parametrize("name,hd,G,Sq,kv,causal,tile", _ATTN_CASES)
def test_attention_kernels_vs_plain_and_paged_equals_dense(
        gen, name, hd, G, Sq, kv, causal, tile):
    """B1 and B2 against the plain version (rtol = atol = 1e-5) and
    against each other (bitwise): kv_len over several splits, one split
    length and one either side, 1 and 0 (exact zeros); head_dim 16, 64 and
    128; R = 1, 2, 3, 4, 5, 6 and 12 (3- and 4-row CTAs, rows past R
    masked); 6- and 8-bit formats (the decode table) and
    16-bit (f2p_decode); garbage page ids past kv_len change nothing; a
    paged call on the page table cut to a span bucket equals the dense
    call on the full cache, bitwise (the kernel's result depends on each
    row's kv_len and the tile, not on S)."""
    q, slab_k, slab_v, pages = _attn_inputs(gen, name, hd, G, Sq, kv)
    kv_len = torch.tensor(kv, device="cuda")
    kw = dict(kv_len=kv_len, causal=causal, q_offset=kv_len - Sq, tile=tile)
    dense_k = A.gather_pages_to_dense(slab_k, pages)
    dense_v = A.gather_pages_to_dense(slab_v, pages)
    C.reset_launches()
    got = A.attention_paged(q, slab_k, slab_v, pages, **kw)
    dense = A.attention_packed(q, dense_k, dense_v, **kw)
    assert C.LAUNCHES["attention_paged"] == 1
    assert C.LAUNCHES["attention_packed"] == 1
    assert torch.equal(got, dense)
    for b, n in enumerate(kv):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))
    torch.testing.assert_close(
        got, A.attention_paged_plain(q, slab_k, slab_v, pages, **kw),
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        dense, A.attention_packed_plain(q, dense_k, dense_v, **kw),
        rtol=1e-5, atol=1e-5)
    T = slab_k.codes.shape[1]
    junk = pages.clone()
    for b, n in enumerate(kv):   # ids past each row's live pages: garbage
        tail = junk[b, -(-n // T):]
        tail[0::2] = -5
        tail[1::2] = 10 ** 6
    assert torch.equal(A.attention_paged(q, slab_k, slab_v, junk, **kw), got)
    span = max(1, -(-max(kv) // T))
    assert torch.equal(A.attention_paged(
        q, slab_k, slab_v, pages[:, :span].contiguous(), **kw), dense)


@pytest.mark.parametrize("name", ["f2p_sr_2_8s", "f2p_lr_2_16s"])
@pytest.mark.parametrize("paged", [True, False])
def test_attention_kernel_bf16_and_strided_q(gen, name, paged):
    """q in bf16 (serving's dtype): the output is bf16, bitwise the
    kernel's own f32 result on q.float() rounded to bf16 (q's bf16 -> f32
    is exact; o is rounded once, as .to(torch.bfloat16) rounds). A q whose
    heads are not laid out [B, Sq, H, hd] (a transposed view) gives the
    bits of its contiguous copy; a row's output does not depend on the
    batch it came in; an int32 kv_len and a scalar agree with int64."""
    q, slab_k, slab_v, pages = _attn_inputs(gen, name, 128, 3, 2, (300, 77))

    def call(q, rows=slice(None), **kw):
        if paged:
            return A.attention_paged(q, slab_k, slab_v, pages[rows], **kw)
        return A.attention_packed(
            q, A.gather_pages_to_dense(slab_k, pages[rows]),
            A.gather_pages_to_dense(slab_v, pages[rows]), **kw)

    kv = torch.tensor([300, 77], device="cuda")
    qb = q.to(torch.bfloat16)
    ob = call(qb, kv_len=kv)
    assert ob.dtype == torch.bfloat16 and ob.shape == qb.shape
    assert torch.equal(ob, call(qb.float(), kv_len=kv).to(torch.bfloat16))
    o = call(q, kv_len=kv)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qt.is_contiguous()
    assert torch.equal(call(qt, kv_len=kv), o)
    assert torch.equal(call(q[:1], slice(0, 1), kv_len=300)[0], o[0])
    assert torch.equal(call(q, kv_len=kv.to(torch.int32)), o)


def test_attention_kernel_raises_on_shapes_it_cannot_take(gen):
    """The kernel names its limits (head_dim <= 128, f32 or bf16 q) and
    never hands a call to another route."""
    fmt = named_format("f2p_sr_2_8s")
    q = torch.randn(1, 1, 2, 256, generator=gen, device="cuda")
    kq = QT.quantize(torch.randn(1, 8, 2, 256, generator=gen, device="cuda"),
                     fmt, block=256, packed=True)
    with pytest.raises(ValueError, match="head_dim"):
        A.attention_packed(q, kq, kq, kv_len=8)
    q = torch.randn(1, 1, 2, 64, generator=gen, device="cuda")
    kq = QT.quantize(torch.randn(1, 8, 2, 64, generator=gen, device="cuda"),
                     fmt, block=64, packed=True)
    with pytest.raises(TypeError):
        A.attention_packed(q.half(), kq, kq, kv_len=8)


@pytest.fixture
def clean_tables():
    """The tile tables are module globals: empty before and after."""
    A._TILE_TABLE.clear()
    MM._TILE_TABLE.clear()
    yield
    A._TILE_TABLE.clear()
    MM._TILE_TABLE.clear()


@pytest.mark.parametrize("tile", [128, 512])
@pytest.mark.parametrize("S", [32896, 131072])
def test_attention_kernels_past_32768_positions(gen, clean_tables, S, tile):
    """B1 and B2 at llama3.2-3b's (8 kv heads, G = 3, head_dim 128) over a
    cache past the old cap of 256 splits: paged == dense bitwise, the page
    table cut to the live span == the dense call on the full cache, within
    1e-5 of the plain version at the same tile; kv_len S - 1 and 100."""
    K, G, hd, T = 8, 3, 128, 8
    fmt = named_format("f2p_sr_2_8s")
    maxp = S // T
    slab_k, slab_v = (QT.quantize(torch.randn(maxp + 1, T, K, hd,
                                              generator=gen, device="cuda"),
                                  fmt, block=hd, packed=True)
                      for _ in range(2))
    pages = torch.randperm(maxp + 1, generator=gen, device="cuda")[:maxp]
    pages = pages[None].to(torch.int32)
    dk = A.gather_pages_to_dense(slab_k, pages)
    dv = A.gather_pages_to_dense(slab_v, pages)
    q = torch.randn(1, 1, K * G, hd, generator=gen, device="cuda")
    for kv_len in (S - 1, 100):
        C.reset_launches()
        paged = A.attention_paged(q, slab_k, slab_v, pages, kv_len=kv_len,
                                  tile=tile)
        dense = A.attention_packed(q, dk, dv, kv_len=kv_len, tile=tile)
        assert C.LAUNCHES["attention_paged"] == 1
        assert C.LAUNCHES["attention_packed"] == 1
        assert torch.equal(paged, dense)
        cut = pages[:, :-(-kv_len // T)].contiguous()
        assert torch.equal(A.attention_paged(q, slab_k, slab_v, cut,
                                             kv_len=kv_len, tile=tile), dense)
        torch.testing.assert_close(dense, A.attention_packed_plain(
            q, dk, dv, kv_len=kv_len, tile=tile), rtol=1e-5, atol=1e-5)


def test_tile_table_entries_drive_the_launches(gen, clean_tables,
                                               monkeypatch):
    """With the tables empty the wrappers launch at the planners' plans; a
    "cuda" entry launches at its tile (B1/B2) or tiles (B7's tile route),
    as the host plans the wrappers call show, and the kernels stay within
    tolerance of their plain versions."""
    seen = []
    plan, tile_plan = A.attention_plan, MM.tile_plan
    monkeypatch.setattr(A, "attention_plan",
                        lambda *a: seen.append(a[5]) or plan(*a))
    monkeypatch.setattr(MM, "tile_plan",
                        lambda *a: seen.append(tile_plan(*a)) or seen[-1])
    fmt = named_format("f2p_sr_2_8s")
    kq, vq = (QT.quantize(torch.randn(1, 4096, 8, 128, generator=gen,
                                      device="cuda"), fmt, block=128,
                          packed=True) for _ in range(2))
    q = torch.randn(1, 1, 24, 128, generator=gen, device="cuda")
    A.attention_packed(q, kq, vq, kv_len=4000)
    A.set_attention_tile("cuda", 8, 512)
    o = A.attention_packed(q, kq, vq, kv_len=4000)
    assert seen == [128, 512]
    torch.testing.assert_close(o, A.attention_packed_plain(
        q, kq, vq, kv_len=4000, tile=512), rtol=1e-5, atol=1e-5)
    x = torch.randn(256, 1024, generator=gen, device="cuda")
    w = torch.randn(1024, 1024, generator=gen, device="cuda") * 0.02
    words, scales = MM.quantize_weight(w, fmt, packed=True)
    seen.clear()
    MM.f2p_dequant_matmul_packed(x, words, scales, fmt=fmt)
    MM.set_matmul_tiles("cuda", 8, (64, 128, 256))
    y = MM.f2p_dequant_matmul_packed(x, words, scales, fmt=fmt)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert seen == [("mma",) + MM.mma_plan(256, 1024, 1024, n_sm),
                    ("mma", 64, 256, 4)]
    ref = MM.ref_dequant_matmul(x, unpack_bits(words, 8, 1024), scales, fmt)
    torch.testing.assert_close(y, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


def _cuda_luts(grid):
    return [torch.from_numpy(t).cuda() for t in FC.advance_tables(grid)]


@pytest.mark.parametrize("flavor,n_bits", [("li", 8), ("li", 12), ("li", 16),
                                           ("sr", 16)])
@pytest.mark.parametrize("sweep0", [0, 32])
def test_counter_advance_kernel_bitwise_vs_plain(gen, flavor, n_bits,
                                                 sweep0):
    """B9 against its plain version on the same stream, bitwise: stochastic
    states, spent cells (early exit), saturated cells, an odd cell count."""
    grid = F2PFormat(n_bits=n_bits, h_bits=2,
                     flavor=Flavor(flavor)).payload_grid
    rng = np.random.default_rng(n_bits + sweep0)
    shape = (3, 5001)
    state = torch.from_numpy(rng.integers(0, len(grid) - 1, shape).astype(
        np.int32)).cuda()
    budget = torch.from_numpy(rng.integers(0, 4000, shape).astype(
        np.float32)).cuda()
    budget[0, :100] = 0.0
    state[1, :100] = len(grid) - 1
    luts = _cuda_luts(grid)
    seed = int(rng.integers(0, 1 << 32))
    got = FC.counter_advance(state, budget, *luts, seed, sweep0=sweep0)
    u = FC.hash_uniforms(seed, sweep0, FC.PALLAS_SWEEPS, shape, device="cuda")
    want = FC.counter_advance_plain(state, budget, *luts, u)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0][0, :100], state[0, :100])
    assert float(got[1][1, :100].abs().sum()) == 0.0
    st, lf = FC.counter_advance_exact(state, budget, *luts, seed)
    assert float(lf.abs().sum()) == 0.0


def test_counter_estimate_kernel_bitwise_vs_plain(gen):
    grid = F2PFormat(n_bits=16, h_bits=2, flavor=Flavor.LI).payload_grid
    glut = torch.tensor(grid, dtype=torch.float32, device="cuda")
    state = torch.randint(0, len(grid), (4, 3001), generator=gen,
                          device="cuda", dtype=torch.int32)
    assert torch.equal(FC.counter_estimate(state, glut),
                       FC.counter_estimate_plain(state, glut))
    with pytest.raises(TypeError):
        FC.counter_estimate(state.long(), glut)


def _bits_any(t):
    view = {torch.uint16: torch.int16, torch.uint32: torch.int32}
    return t.view(view.get(t.dtype, t.dtype))


@pytest.mark.parametrize("name", ["f2p_sr_2_6s", "f2p_sr_2_8s",
                                  "f2p_lr_2_8s", "f2p_sr_2_10s"])
@pytest.mark.parametrize("packed", [False, True])
def test_quantize_weight_on_card_matches_cpu(gen, name, packed):
    fmt = named_format(name)
    w = torch.randn(512, 384, generator=gen, device="cuda") * 0.02
    w[:128, 5] = 0.0
    for x in (w, w.to(torch.bfloat16)):
        c, s = MM.quantize_weight(x, fmt, packed=packed)
        pc, ps = MM.quantize_weight(x.cpu(), fmt, packed=packed)
        assert c.dtype == pc.dtype and c.shape == pc.shape
        assert torch.equal(_bits_any(c).cpu(), _bits_any(pc))
        assert torch.equal(s.cpu(), ps)


def _served_by(fmt, block, M):
    """The kernel that must serve an M-row call: the route by rows, then
    the tile kernel by format and block."""
    if MM.matmul_route(M, block) == "decode":
        return "decode"
    return MM.tile_kernel(fmt, block)


def _call_once(x, q, scales, fmt, block, packed):
    """One wrapper call: (y, the kernel that served it), asserting one
    launch counted."""
    key = "dequant_matmul_packed" if packed else "dequant_matmul"
    C.reset_launches()
    before = dict(MM.SERVED)
    y = MM.dequant_matmul(x, q, scales, fmt=fmt, block=block, packed=packed)
    assert C.LAUNCHES[key] == 1 and sum(C.LAUNCHES.values()) == 1
    served = [k for k in MM.SERVED if MM.SERVED[k] != before[k]]
    assert len(served) == 1 and MM.SERVED[served[0]] == before[served[0]] + 1
    return y, served[0]


@pytest.mark.parametrize("M", [1, 5, 8, 9, 13, 16, 64, 100, 256, 2048])
@pytest.mark.parametrize("block", [16, 32, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,packed", [("f2p_sr_2_8s", False),
                                         ("f2p_sr_2_10s", False),
                                         ("f2p_sr_2_16s", False),
                                         ("f2p_sr_2_6s", True),
                                         ("f2p_lr_2_8s", True),
                                         ("f2p_sr_2_12s", True)])
def test_dequant_matmul_kernels_vs_plain(gen, M, block, dtype, name, packed):
    """B8 (uint8 / uint16 codes) and B7 (packed words, fields straddling
    words) against the plain version on the card, at decode, odd and
    prefill M and blocks of 16 to 256 rows; K split across CTAs at the
    small M. Formats of at most 10 bits take the tensor-core kernel above
    the decode rows, 12 and 16 bits the SIMT one; one launch per call, and
    a second call gives the same bits."""
    fmt = named_format(name)
    K, N = 512, 256
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    w = torch.randn(K, N, generator=gen, device="cuda") * 0.05
    codes, scales = MM.quantize_weight(w, fmt, block=block)
    q = MM.quantize_weight(w, fmt, block=block, packed=True)[0] if packed \
        else codes
    y, served = _call_once(x, q, scales, fmt, block, packed)
    want = _served_by(fmt, block, M)
    assert served == want
    if M > MM.MM_DECODE_ROWS:
        assert want == ("simt" if fmt.n_bits > 10 else "mma")
    ref = MM.ref_dequant_matmul(x, codes, scales, fmt, block)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == (M, N)
    torch.testing.assert_close(y, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))
    y2, _ = _call_once(x, q, scales, fmt, block, packed)
    assert torch.equal(_bits(y2), _bits(y))


def _edge_x(gen, M, K, dtype, kind):
    """x for the tile route's edge cases: ``wide`` spans 2^-100 to 2^100
    (random signs); ``special`` is randn with inf, -inf, NaN and the
    dtype's largest finite values of both signs in rows of their own."""
    if kind == "wide":
        e = torch.randint(-100, 101, (M, K), generator=gen, device="cuda")
        s = torch.randint(0, 2, (M, K), generator=gen, device="cuda") * 2 - 1
        m = torch.rand(M, K, generator=gen, device="cuda") + 1.0
        return (s * m * torch.exp2(e.float())).to(dtype)
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    big = torch.finfo(dtype).max
    x[1, 3], x[2, 200], x[3, 17] = float("inf"), -float("inf"), float("nan")
    x[4, 40], x[5, 301] = big, -big
    x[6, 7], x[6, 300] = float("inf"), -float("inf")   # inf - inf: NaN
    return x


@pytest.mark.parametrize("kind", ["special", "wide"])
@pytest.mark.parametrize("N", [100, 768])
@pytest.mark.parametrize("M", [9, 100, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,packed,block", [("f2p_sr_2_8s", False, 128),
                                               ("f2p_sr_2_6s", True, 16),
                                               ("f2p_sr_2_10s", True, 64),
                                               ("f2p_sr_2_16s", False, 128)])
def test_dequant_matmul_tile_route_edges_vs_plain(gen, kind, N, M, dtype,
                                                  name, packed, block):
    """The tile route against the plain version on ragged N (100: a partial
    tile, unaligned code rows; 768: six tiles), x holding inf, NaN and
    +-the largest finite value (equal NaN and inf positions), and x
    spanning 2^-100 to 2^100, where the tensor-core kernel's split of x
    and its products with subnormal terms differ from the plain version
    only far below the tolerance. Deterministic: a second call gives the
    same bits."""
    fmt = named_format(name)
    K = 512
    x = _edge_x(gen, M, K, dtype, kind)
    w = torch.randn(K, N, generator=gen, device="cuda") * 0.05
    codes, scales = MM.quantize_weight(w, fmt, block=block)
    q = MM.quantize_weight(w, fmt, block=block, packed=True)[0] if packed \
        else codes
    y, served = _call_once(x, q, scales, fmt, block, packed)
    assert served == ("simt" if fmt.n_bits > 10 else "mma")
    ref = MM.ref_dequant_matmul(x, codes, scales, fmt, block)
    torch.cuda.synchronize()
    fin = ref[torch.isfinite(ref)]
    torch.testing.assert_close(y, ref, rtol=1e-4, equal_nan=True,
                               atol=1e-4 * float(fin.abs().max()))
    if kind == "special":
        assert bool(torch.isnan(ref[3]).all())
        assert bool(torch.isinf(ref[1]).any())
        assert bool(torch.isfinite(ref[4]).all() & torch.isfinite(ref[5]).all())
    y2, _ = _call_once(x, q, scales, fmt, block, packed)
    assert torch.equal(_bits(y2), _bits(y))


def test_dequant_matmul_on_card_never_runs_plain(gen, monkeypatch):
    """No call on CUDA tensors reaches the plain version or torch.matmul,
    on any route or tile kernel."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached a plain path")

    monkeypatch.setattr(MM, "ref_dequant_matmul", refuse)
    monkeypatch.setattr(torch, "matmul", refuse)
    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    w = torch.randn(512, 256, generator=gen, device="cuda") * 0.05
    for name, block in (("f2p_sr_2_8s", 128), ("f2p_sr_2_16s", 128),
                        ("f2p_sr_2_8s", 8)):
        fmt = named_format(name)
        codes, scales = MM.quantize_weight(w, fmt, block=block)
        words, _ = MM.quantize_weight(w, fmt, block=block, packed=True)
        for M in (4, 64, 2048):
            x = torch.randn(M, 512, generator=gen, device="cuda")
            MM.dequant_matmul(x, codes, scales, fmt=fmt, block=block)
            MM.dequant_matmul(x, words, scales, fmt=fmt, block=block,
                              packed=True)
    torch.cuda.synchronize()


_DECODE_KINDS = [("f2p_sr_2_8s", False), ("f2p_sr_2_6s", False),
                 ("f2p_sr_2_10s", False), ("f2p_sr_2_16s", False),
                 ("f2p_sr_2_6s", True), ("f2p_sr_2_7s", True),
                 ("f2p_lr_2_8s", True), ("f2p_sr_2_10s", True),
                 ("f2p_sr_2_12s", True)]


@pytest.mark.parametrize("M", sorted({1, 3, 5, 8, MM.MM_DECODE_ROWS}))
@pytest.mark.parametrize("N", [100, 256, 768])
@pytest.mark.parametrize("K", [256, 3072])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,packed", _DECODE_KINDS)
def test_dequant_matmul_decode_route_vs_plain(gen, M, N, K, dtype, name,
                                              packed):
    """The decode route (M <= MM_DECODE_ROWS) against the plain version:
    N < 256 leaves a partial strip of columns (and, packed, a row's tail
    word); N = 100 takes the per-element loads; uint8 codes of 6 and 8
    bits (the byte table), uint16 codes (f2p_decode), packed words of 6, 7
    and 8 bits (the table) and 10 and 12 bits (f2p_decode); K split across
    CTAs."""
    assert MM.matmul_route(M, 128) == "decode"
    fmt = named_format(name)
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    w = torch.randn(K, N, generator=gen, device="cuda") * 0.05
    codes, scales = MM.quantize_weight(w, fmt)
    q = MM.quantize_weight(w, fmt, packed=True)[0] if packed else codes
    key = "dequant_matmul_packed" if packed else "dequant_matmul"
    C.reset_launches()
    y = MM.dequant_matmul(x, q, scales, fmt=fmt, packed=packed)
    assert C.LAUNCHES[key] == 1
    ref = MM.ref_dequant_matmul(x, codes, scales, fmt)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == (M, N)
    torch.testing.assert_close(y, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("name,packed", _DECODE_KINDS)
def test_dequant_matmul_past_decode_rows_takes_tile_route(gen, name, packed):
    """One row past MM_DECODE_ROWS the tile kernel still serves the call."""
    M = MM.MM_DECODE_ROWS + 1
    assert MM.matmul_route(M, 128) == "tile"
    fmt = named_format(name)
    x = torch.randn(M, 512, generator=gen, device="cuda")
    w = torch.randn(512, 768, generator=gen, device="cuda") * 0.05
    codes, scales = MM.quantize_weight(w, fmt)
    q = MM.quantize_weight(w, fmt, packed=True)[0] if packed else codes
    y = MM.dequant_matmul(x, q, scales, fmt=fmt, packed=packed)
    ref = MM.ref_dequant_matmul(x, codes, scales, fmt)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


def test_calibration_state_follows_the_data_to_the_card(gen):
    """A calibration started from ``empty_state()`` (on the host) folds
    CUDA data into a state on the card, equal to the CPU fold."""
    from repro_torch.autotune import NORM_SPEC, empty_state, update

    x = torch.randn(6, 256, generator=gen, device="cuda") * 3
    st = update(empty_state(NORM_SPEC), x, NORM_SPEC, block=128)
    assert all(v.device.type == "cuda" for v in st.values())
    st = update(st, x * 0.5, NORM_SPEC, block=128)
    ref = update(update(empty_state(NORM_SPEC), x.cpu(), NORM_SPEC,
                        block=128), x.cpu() * 0.5, NORM_SPEC, block=128)
    for k, v in ref.items():
        torch.testing.assert_close(st[k].cpu(), v, rtol=1e-6, atol=0)


def test_dequant_matmul_kernel_raises_on_bad_inputs(gen):
    fmt = named_format("f2p_sr_2_8s")
    w = torch.randn(256, 256, generator=gen, device="cuda")
    codes, scales = MM.quantize_weight(w, fmt)
    with pytest.raises(TypeError):
        MM.dequant_matmul(torch.zeros(8, 256, device="cuda",
                                      dtype=torch.float16), codes, scales)
    with pytest.raises(ValueError, match="contiguous"):
        MM.dequant_matmul(torch.zeros(256, 8, device="cuda").T, codes,
                          scales)
