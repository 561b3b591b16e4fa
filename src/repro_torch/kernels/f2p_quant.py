"""Block-scaled F2P quantize / dequantize, packed and unpacked: tile math,
plain versions and the CUDA kernel wrappers.

Port of ``repro.kernels.f2p_quant``. The tile
math is the reference's branch-free arithmetic, written on torch int32/f32
tensors so it is bitwise identical to the JAX functions:

  encode:  exact floor(log2 x) via the f32 bit pattern -> exponent bucket V
           -> per-bucket mantissa width -> round-half-up mantissa through the
           exact fractional part -> field assembly with variable shifts.
  decode:  field split with variable shifts -> ldexp by bit assembly.

Seven entry points, each routed by the tensor's device (no registry, no
environment override): a CPU tensor runs the plain PyTorch version, a CUDA
tensor launches the hand-written kernel of ``csrc/f2p_kernels.cu`` or raises.

``f2p_kv_write`` and ``f2p_quantize_packed`` are the two addressing modes
of one kernel (B3), which replaces the TPU kernel
``repro/kernels/f2p_quant.py::_quant_packed_kernel`` together with the
KV-cache scatter that follows it in ``repro.models.attention``.
``f2p_kv_write`` quantizes a layer's new K and V rows and stores words and
scales straight into the cache: a paged pool's slabs through a page table,
or a dense cache at per-slot positions, page and offset computed in the
kernel, one launch per layer write. ``f2p_quantize_packed`` writes
contiguous output rows. At the decode shape the bytes take nanoseconds, so
launches and the host bound the write; the kernel's note in
``csrc/f2p_kernels.cu`` says how it spends one launch on it.

``f2p_dequantize_packed`` and ``f2p_kv_read`` are the two modes of one
kernel (B4), which replaces ``repro/kernels/f2p_quant.py::_dequant_packed_kernel``:
one tensor, or a layer's whole K and V cache in one launch (the unfused
decode's cache read, ``models.attention._cache_read``). Bound by bytes
(packed words and scales in, one value out per element): warps take tiles
of 512 elements whose words they stage coalesced, cut each lane's 4 fields
from a 1-3 word window and decode through a table in shared memory (n_bits
<= 8) or the arithmetic decode; codes never exist outside registers.

``f2p_quantize_codes`` replaces ``repro/kernels/f2p_quant.py::_quant_kernel``
(B5): the same scales and codes as the packed quantize, stored one code per
byte (n_bits <= 8, uint8) or per two bytes (uint16). Bound by bytes: x in
once, 1 or 2 bytes per element and one f32 per block out. Its encode is
table driven (:func:`encode_table`, :func:`table_encode`): |y|'s f32
exponent picks a row that turns the significand into the code with one add
and one shift, bitwise the arithmetic :func:`quantize_tile_math`; a
persistent grid of warps takes two blocks of 128 per pass, a lane 4
consecutive values in one vector load. Other blocks and misaligned tensors
take a one-element-per-lane form with the arithmetic encode.

``f2p_ef_roundtrip`` is B5's round-trip mode, the train step's gradient
compression with error feedback: r += g, quantize, dequantize, r -= q,
g = q, over all of a step's compressed leaves in ONE launch (a leaf table
from :func:`ef_plan`), codes and scales kept in registers; bitwise
:func:`ef_roundtrip_plain`. ``f2p_dequantize_codes`` replaces
``_dequant_kernel`` (B6): decode times the block's scale, 4 codes per
thread where aligned, bound by bytes; the checkpoint restore runs it.

torch's uint16 has few operations, so 16-bit codes travel as uint16 tensors
(the reference's dtype, what the checkpoint writes) and every piece of
arithmetic on them goes through an int16 view.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core.f2p import F2PFormat
from repro_torch.kernels import cuda as C
from repro_torch.kernels.bits import pack_bits, packed_words, unpack_bits
from repro_torch.kernels.cost import charged

__all__ = ["quantize_tile_math", "dequantize_tile_math",
           "f2p_quantize_packed", "f2p_dequantize_packed", "f2p_kv_write",
           "f2p_kv_read", "quantize_packed_plain", "dequantize_packed_plain",
           "kv_write_plain", "kv_read_plain",
           "f2p_quantize_codes", "f2p_dequantize_codes", "quantize_plain",
           "dequantize_plain", "code_dtype", "codes_to_int32",
           "encode_table", "table_encode", "f2p_ef_roundtrip",
           "ef_roundtrip_plain", "ef_plan", "encode_check"]

def _exp2i(n: torch.Tensor) -> torch.Tensor:
    """Exact 2^n for int32 n in [-126, 127], built by bit assembly."""
    return ((n + 127) << 23).to(torch.int32).view(torch.float32)


def _fmt_consts(fmt: F2PFormat):
    if fmt.h_bits not in (1, 2):
        raise ValueError("kernel supports h_bits in {1,2}")
    if fmt.n_bits > 16:
        raise ValueError(
            f"kernel tile math supports n_bits <= 16, got {fmt.n_bits}; wider "
            "formats go through the host encode path (core.f2p)")
    nu, h = fmt.payload_bits, fmt.h_bits
    sgn = fmt.flavor.exponent_sign
    return nu, h, sgn, fmt.vmax, fmt.v_sub, fmt.v_top, fmt.bias


@functools.lru_cache(maxsize=64)
def cuda_consts(fmt: F2PFormat) -> C.F2PConsts:
    """The kernel-argument form of :func:`_fmt_consts`."""
    return C.F2PConsts(*_fmt_consts(fmt), int(fmt.signed), fmt.n_bits)


@functools.lru_cache(maxsize=64)
def inv_max_value(fmt: F2PFormat) -> float:
    """f32(1 / max_value): block scales MULTIPLY by this constant (cached:
    every KV write and quantize call needs it, and ``max_value`` is
    recomputed from the format's fields on each access)."""
    return float(np.float32(1.0 / fmt.max_value))


def _esize_of(v: torch.Tensor, h: int) -> torch.Tensor:
    # floor(log2(v+1)) as exact integer thresholds
    es = torch.zeros_like(v)
    for j in range(1, 1 << h):
        es = es + (v >= ((1 << j) - 1)).to(v.dtype)
    return es


def _pow2(e: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(e) << e


def quantize_tile_math(x: torch.Tensor, fmt: F2PFormat) -> torch.Tensor:
    """Branch-free exact nearest-F2P encode of f32 values -> int32 codes."""
    nu, h, sgn, vmax, v_sub, v_top, bias = _fmt_consts(fmt)
    x = x.to(torch.float32)
    mag = x.abs()
    bexp = (mag.view(torch.int32) >> 23) & 0xFF
    v = torch.clamp(sgn * (bexp - 127 - bias), 0, vmax - 1)
    v = torch.where(bexp == 0, v_sub, v)

    es = _esize_of(v, h)
    mbits = nu - h - es
    is_sub = v == v_sub
    e_val = sgn * v
    exp_lo = torch.where(is_sub, e_val + bias + 1, e_val + bias)
    lead = torch.where(is_sub, 0, 1).to(torch.int32)
    u = mag * _exp2i(mbits - exp_lo)
    u = u - (lead << mbits).to(torch.float32)
    u = torch.minimum(u, 2.0 * _pow2(mbits).to(torch.float32))
    # half-up via the exact fractional part (u + 0.5 is inexact just
    # below a tie and would spuriously round up)
    mf = torch.floor(u)
    m = (mf + (u - mf >= 0.5).to(torch.float32)).to(torch.int32)
    m = torch.clamp_min(m, 0)
    ovf = m >= _pow2(mbits)

    at_top = v == v_top
    v2 = torch.where(ovf & ~at_top, v + sgn, v)
    es2 = _esize_of(v2, h)
    mbits2 = nu - h - es2
    m2 = torch.where(ovf, torch.where(at_top, _pow2(mbits2) - 1, 0), m)
    efield = v2 - (_pow2(es2) - 1)
    payload = (es2 << (nu - h)) | (efield << mbits2) | m2
    if fmt.signed:
        payload = payload | (torch.signbit(x).to(torch.int32) << nu)
    return payload.to(torch.int32)


def dequantize_tile_math(codes: torch.Tensor, fmt: F2PFormat) -> torch.Tensor:
    """Branch-free exact F2P decode: integer codes -> f32 values (unscaled)."""
    nu, h, sgn, vmax, v_sub, v_top, bias = _fmt_consts(fmt)
    c = codes.to(torch.int32)
    payload = c & ((1 << nu) - 1)
    es = (payload >> (nu - h)) & ((1 << h) - 1)
    mbits = nu - h - es
    efield = (payload >> mbits) & (_pow2(es) - 1)
    v = (_pow2(es) - 1) + efield
    m = payload & (_pow2(mbits) - 1)
    is_sub = v == v_sub
    e_val = sgn * v
    exp_lo = torch.where(is_sub, e_val + bias + 1, e_val + bias)
    lead = torch.where(is_sub, 0, 1).to(torch.int32)
    val = ((lead << mbits) + m).to(torch.float32) * _exp2i(exp_lo - mbits)
    if fmt.signed:
        val = torch.where(((c >> nu) & 1) == 1, -val, val)
    return val


def code_dtype(fmt: F2PFormat) -> torch.dtype:
    """The unpacked codes' dtype: uint8 for n_bits <= 8, else uint16 (as
    ``F2PFormat.code_dtype``; the tile math stops at 16 bits)."""
    return torch.uint8 if fmt.n_bits <= 8 else torch.uint16


def codes_to_int32(codes: torch.Tensor) -> torch.Tensor:
    """uint8 / uint16 codes -> int32 values (uint16 through an int16 view)."""
    if codes.dtype == torch.uint16:
        return codes.view(torch.int16).to(torch.int32) & 0xFFFF
    return codes.to(torch.int32)


def _int32_to_codes(c: torch.Tensor, fmt: F2PFormat) -> torch.Tensor:
    if fmt.n_bits <= 8:
        return c.to(torch.uint8)
    # fold [32768, 65536) onto the int16 bit pattern, then reinterpret
    return torch.where(c >= 32768, c - 65536, c).to(torch.int16).view(
        torch.uint16)


# ---------------------------------------------------------------------------
# B5's table-driven encode
# ---------------------------------------------------------------------------
_SAT_ALWAYS, _NO_SHIFT = 0, 31


@functools.lru_cache(maxsize=64)
def encode_table(fmt: F2PFormat):
    """B5's encode table for ``fmt`` (``tab_encode`` in csrc/f2p_kernels.cu):
    (enc int32 ``[256, 4]``, val float32 ``[256, 2]``), one row per f32
    biased exponent e of |y|. With M the 24-bit significand of |y| with its
    implicit bit set (also for e = 0), ``m = (M + ((1 << sh) >> 1)) >> sh``
    and enc[e] = (off, sat, lim, sh), the payload is ``sat if m >= lim else
    off + m``, and its value ``sat_value if m >= lim else m * step`` with
    val[e] = (step, sat_value): exactly :func:`quantize_tile_math` and
    :func:`dequantize_tile_math`, derived here from the same arithmetic one
    f32 binade at a time (a format bucket spans one binade: rounding is one
    add and one shift of M; the subnormal bucket, values below and above
    the range, the top clamp, inf and NaN are rows of the same form).
    Raises for a format whose buckets reach f32 subnormals (none of <= 16
    bits does)."""
    nu, h, sgn, vmax, v_sub, v_top, bias = _fmt_consts(fmt)

    def esize(v):
        return sum(v >= (1 << j) - 1 for j in range(1, 1 << h))

    def payload(v, m):
        es = esize(v)
        return (es << (nu - h)) | ((v - ((1 << es) - 1)) << (nu - h - es)) | m

    dec = dequantize_tile_math(torch.arange(1 << nu, dtype=torch.int32),
                               fmt).numpy()
    enc = np.zeros((256, 4), np.int64)
    val = np.zeros((256, 2), np.float32)
    for e in range(256):
        v = v_sub if e == 0 else min(max(sgn * (e - 127 - bias), 0), vmax - 1)
        mbits = nu - h - esize(v)
        is_sub = v == v_sub
        exp_lo = sgn * v + bias + int(is_sub)
        k = mbits - exp_lo          # the arithmetic scales |y| by 2^k
        if not -126 <= k <= 127:
            raise ValueError(f"{fmt}: bucket scale 2^{k} is outside f32")
        v2 = v if v == v_top else v + sgn     # where an overflow goes
        sat = payload(v2, (1 << (nu - h - esize(v2))) - 1 if v == v_top
                      else 0)
        step = np.float32(2.0 ** (exp_lo - mbits))
        if e == 255:    # inf: m = 2^23 -> the overflow code; NaN: payload(v, 0)
            enc[e] = (sat - (1 << 23), payload(v, 0), (1 << 23) + 1, 0)
            val[e] = (np.float32(dec[sat]) / np.float32(1 << 23),
                      dec[payload(v, 0)])
            continue
        E = (e - 150 if e else -149) + k    # u = M * 2^E (before the lead)
        const = None
        if not is_sub:
            if E == mbits - 23:             # the bucket's own binade
                enc[e] = (payload(v, 0) - (1 << mbits), sat, 1 << (mbits + 1),
                          23 - mbits)
                val[e] = (step, dec[sat])
                continue
            const = payload(v, 0) if E < mbits - 23 else sat
        elif e == 0:
            if -E < 24:
                raise ValueError(f"{fmt}: f32 subnormals reach its grid")
            const = payload(v, 0)
        elif -E >= 25:
            const = payload(v, 0)           # rounds to 0 for every M
        else:
            enc[e] = (payload(v, 0), sat, 1 << mbits, -E)
            val[e] = (step, dec[sat])
            continue
        enc[e] = (const, const, _SAT_ALWAYS, _NO_SHIFT)
        val[e] = (0.0, dec[const])
    return enc.astype(np.int32), val


def table_encode(y: torch.Tensor, fmt: F2PFormat):
    """The card's table encode on torch tensors (f32 ``y`` -> (int32 codes,
    f32 decoded values)): equal to ``quantize_tile_math`` and
    ``dequantize_tile_math`` of it, bit for bit (the CPU tests hold it)."""
    enc, val = (torch.from_numpy(t) for t in encode_table(fmt))
    bits = y.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = bits & 0x7FFFFFFF
    ex = mag >> 23
    off, sat, lim, sh = enc.to(torch.int64)[ex].unbind(-1)
    m = (((mag | 0x800000) & 0xFFFFFF) + ((1 << sh) >> 1)) >> sh
    over = m >= lim
    code = torch.where(over, sat, off + m)
    step, sat_val = val[ex].unbind(-1)
    value = torch.where(over, sat_val, m.to(torch.float32) * step)
    if fmt.signed:
        neg = (bits >> 31) == 1
        code = code | (neg.to(torch.int64) << fmt.payload_bits)
        value = torch.where(neg, -value, value)
    return code.to(torch.int32), value


_TABLES: dict = {}


def _b5_args(fmt: F2PFormat, dev: torch.device):
    """B5's per-format kernel arguments on ``dev``, made once: (F2PConsts,
    the address of :func:`encode_table` there as the kernels take it, 256
    int4 entries then 256 float2 values, and f32(1 / max_value))."""
    args = _TABLES.get((fmt, dev))
    if args is None:
        enc, val = encode_table(fmt)
        tab = torch.from_numpy(np.concatenate(
            [enc.ravel(), val.view(np.int32).ravel()])).to(dev)
        args = _TABLES[(fmt, dev)] = (cuda_consts(fmt), tab.data_ptr(),
                                      inv_max_value(fmt), tab)
    return args[:3]


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors; the kernels' oracles on the card)
# ---------------------------------------------------------------------------
def quantize_plain(x2: torch.Tensor, fmt: F2PFormat, block: int,
                   scale_mode: str = "f32"):
    """``[r, c]`` -> (codes ``[r, c]`` uint8/uint16, scales ``[r, c/block]``
    f32): the reference's ``_quant_kernel`` body on torch tensors."""
    from repro_torch.core.qtensor import block_scales

    r, c = x2.shape
    xb = x2.to(torch.float32).reshape(r, c // block, block)
    scale = block_scales(xb, fmt, scale_mode)
    y = (xb / scale[..., None]).reshape(r, c)
    return _int32_to_codes(quantize_tile_math(y, fmt), fmt), scale


def dequantize_plain(codes: torch.Tensor, scales: torch.Tensor,
                     fmt: F2PFormat, block: int,
                     out_dtype=torch.float32) -> torch.Tensor:
    """codes ``[r, c]`` + scales ``[r, c/block]`` -> ``[r, c]`` values."""
    r, c = codes.shape
    vals = dequantize_tile_math(codes_to_int32(codes), fmt)
    vals = vals.reshape(r, c // block, block) * scales[..., None]
    return vals.reshape(r, c).to(out_dtype)


def quantize_packed_plain(x2: torch.Tensor, fmt: F2PFormat, block: int,
                          scale_mode: str = "f32"):
    """``[r, c]`` -> (words ``[r, W]`` uint32, scales ``[r, c/block]`` f32)."""
    from repro_torch.core.qtensor import block_scales

    r, c = x2.shape
    xb = x2.to(torch.float32).reshape(r, c // block, block)
    scale = block_scales(xb, fmt, scale_mode)
    y = (xb / scale[..., None]).reshape(r, c)
    return pack_bits(quantize_tile_math(y, fmt), fmt.n_bits), scale


def dequantize_packed_plain(words: torch.Tensor, scales: torch.Tensor,
                            fmt: F2PFormat, block: int,
                            out_dtype=torch.float32) -> torch.Tensor:
    """words ``[r, W]`` + scales ``[r, nblk]`` -> ``[r, nblk*block]``."""
    r, nblk = scales.shape
    codes = unpack_bits(words, fmt.n_bits, nblk * block)
    vals = dequantize_tile_math(codes, fmt).reshape(r, nblk, block)
    return (vals * scales[..., None]).reshape(r, nblk * block).to(out_dtype)


# ---------------------------------------------------------------------------
# Device-routed entry points
# ---------------------------------------------------------------------------
def _check_2d(x: torch.Tensor, block: int, what: str) -> None:
    if x.ndim != 2:
        raise ValueError(f"{what} must be 2-D [rows, cols], got {x.shape}")
    if x.shape[1] % block:
        raise ValueError(f"{what} last dim {x.shape[1]} not a multiple of "
                         f"block {block}")


@charged("quantize_packed")
def f2p_quantize_packed(x2: torch.Tensor, fmt: F2PFormat, *, block: int = 128,
                        scale_mode: str = "f32"):
    """Blocked F2P quantization of ``[r, c]`` straight into packed words:
    (words ``[r, W]`` uint32, scales ``[r, c/block]`` f32). Bitwise equal
    on both devices and to the JAX reference. On the card, B3 with
    contiguous output rows (x at its strides)."""
    _check_2d(x2, block, "x")
    if scale_mode not in ("f32", "pow2"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    if x2.device.type != "cuda":
        return quantize_packed_plain(x2, fmt, block, scale_mode)
    _check_kernel_input(x2, "x")
    r, c = x2.shape
    W = packed_words(c, fmt.n_bits)
    words = torch.empty((r, W), dtype=torch.uint32, device=x2.device)
    scales = torch.empty((r, c // block), dtype=torch.float32,
                         device=x2.device)
    if r and c:
        side = _kv_side(x2[:, None, None], words, scales, fmt, block)
        C.check(C.lib().f2p_kv_write(
            side, side, 1, int(x2.dtype == torch.bfloat16), None,
            C.AttnLen(None, 0, 0, 0), r, 1, 1, c, block, 1, r, 0,
            int(scale_mode == "pow2"), C.stream()), "quantize_packed")
        C.LAUNCHES["quantize_packed"] += 1
    return words, scales


def _check_kernel_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes f32 or bf16 {what}, got {x.dtype}")


def _kv_side(x: torch.Tensor, words: torch.Tensor, scales: torch.Tensor,
             fmt: F2PFormat, block: int) -> C.KVSideIn:
    """One input of B3: x ``[B, S, Kh, cols]`` at its strides and its
    destination rows."""
    consts = cuda_consts(fmt)   # raises for n_bits > 16 or h_bits > 2
    stage = (32 // math.gcd(block * fmt.n_bits, 32)) * block
    if 4 * 4 * min(stage, x.shape[-1]) > C.MAX_SMEM:
        raise ValueError(f"{fmt.n_bits}-bit fields in blocks of {block} "
                         "exceed the kernel's shared-memory stage")
    return C.KVSideIn(x.data_ptr(), *x.stride(), words.data_ptr(),
                      scales.data_ptr(), words.shape[-1], consts,
                      inv_max_value(fmt))


def kv_write_plain(k: torch.Tensor, v: torch.Tensor, cache: dict, pos,
                   pages=None) -> None:
    """The plain version of :func:`f2p_kv_write`: ``quantize_packed_plain``
    of K and of V, then the page arithmetic and a scatter of words and
    scales into the cache, in place."""
    B, S = k.shape[:2]
    T, dev = cache["k"].codes.shape[1], cache["k"].codes.device
    # position p = pos[b] + s: page pages[b, min(p // T, maxp - 1)] at
    # offset p % T (retired slots' table rows point at a dump page), or,
    # with no table, cache row b at position p
    p = torch.as_tensor(pos, dtype=torch.int64, device=dev).reshape(-1, 1) \
        + torch.arange(S, device=dev)
    p = p.expand(B, S)
    rows = slice(None)
    if pages is None:
        page, off = torch.arange(B, device=dev)[:, None].expand(B, S), p
    else:
        col = torch.clamp(p // T, max=pages.shape[1] - 1)
        page, off = pages.to(dev).gather(1, col).to(torch.int64), p % T
        # rows sharing a destination (retired slots on the dump page): the
        # last in (b, s) order writes, as the kernel
        key = (page * T + off).reshape(-1)
        _, inv = torch.unique(key, return_inverse=True)
        idx = torch.arange(key.numel(), device=dev)
        last = torch.full((int(inv.max()) + 1,), -1, device=dev,
                          dtype=torch.int64).scatter_reduce_(0, inv, idx,
                                                             "amax")
        rows = last[inv] == idx
        page, off = page.reshape(-1)[rows], off.reshape(-1)[rows]
    for name, x in (("k", k), ("v", v)):
        c = cache[name]
        words, scales = quantize_packed_plain(x.reshape(-1, x.shape[-1]),
                                              c.fmt, c.block)
        words = words.view(torch.int32).reshape(B * S, *c.codes.shape[2:])
        scales = scales.reshape(B * S, *c.scales.shape[2:])
        c.codes.view(torch.int32)[page.reshape(-1), off.reshape(-1)] = \
            words[rows]
        c.scales[page.reshape(-1), off.reshape(-1)] = scales[rows]


def _check_kv(k, v, cache, pages) -> None:
    if k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must both be [B, S, K, hd], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    B, _, K, hd = k.shape
    ck = cache["k"]
    for name in ("k", "v"):
        c = cache[name]
        if not c.packed or c.codes.ndim != 4:
            raise ValueError(f"cache {name} must be packed [P, T, K, W]")
        if c.block != hd or tuple(c.codes.shape) != (
                *ck.codes.shape[:2], K, packed_words(hd, c.fmt.n_bits)):
            raise ValueError(
                f"cache {name} codes {tuple(c.codes.shape)} (block "
                f"{c.block}) do not hold rows of k {tuple(k.shape)}")
    if pages is not None:
        if pages.ndim != 2 or pages.shape[0] != B:
            raise ValueError(f"pages must be [B={B}, maxp], got "
                             f"{tuple(pages.shape)}")
    elif ck.codes.shape[0] != B:
        raise ValueError(f"dense cache holds {ck.codes.shape[0]} rows, k "
                         f"{B}")


@charged("kv_write")
def f2p_kv_write(k: torch.Tensor, v: torch.Tensor, cache: dict, pos,
                 pages=None) -> None:
    """Quantize a layer's new K and V ``[B, S, K, hd]`` (f32 or bf16, any
    strides) into the packed cache ``cache = {"k", "v"}`` (QTensors: words
    ``[P, T, K, W]`` uint32, scales ``[P, T, K, 1]`` f32, block = hd), in
    place. Row (b, s) lands at position p = pos + s (``pos`` an int or a
    ``[B]`` tensor): with a ``[B, maxp]`` int32 page table ``pages`` in page
    ``pages[b, min(p // T, maxp - 1)]`` at offset ``p % T``, else in cache
    row b at position p. Words and scales are bitwise those of
    :func:`kv_write_plain`; where slots share a page (a dump page), which
    write lands there is not defined. On the card: one launch of B3 for K
    and V, no host sync."""
    _check_kv(k, v, cache, pages)
    if k.device.type != "cuda":
        return kv_write_plain(k, v, cache, pos, pages)
    _check_kernel_input(k, "k")
    _check_kernel_input(v, "v")
    if v.dtype != k.dtype or v.device != k.device:
        raise TypeError("k and v must share dtype and device")
    ck, cv = cache["k"], cache["v"]
    for t, what, dt in ((ck.codes, "k words", torch.uint32),
                        (ck.scales, "k scales", torch.float32),
                        (cv.codes, "v words", torch.uint32),
                        (cv.scales, "v scales", torch.float32)):
        C.require_cuda(t, what, dt)
    B, S, K, hd = k.shape
    P, T = ck.codes.shape[:2]
    if pages is not None:
        C.require_cuda(pages, "pages", torch.int32)
    posarg, keep = C.len_arg(pos, B, 0, k.device)
    C.check(C.lib().f2p_kv_write(
        _kv_side(k, ck.codes, ck.scales, ck.fmt, hd),
        _kv_side(v, cv.codes, cv.scales, cv.fmt, hd), 2,
        int(k.dtype == torch.bfloat16),
        None if pages is None else pages.data_ptr(), posarg, B, S, K, hd, hd,
        T, P, 0 if pages is None else pages.shape[1], 0, C.stream()),
        "kv_write")
    C.LAUNCHES["kv_write"] += 1


@charged("dequantize_packed")
def f2p_dequantize_packed(words: torch.Tensor, scales: torch.Tensor,
                          fmt: F2PFormat, *, block: int = 128,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Fused unpack -> decode -> scale: ``[r, nblk*block]`` in out_dtype
    (B4 on a CUDA tensor, one launch)."""
    r, nblk = scales.shape
    c = nblk * block
    W = packed_words(c, fmt.n_bits)
    if words.shape != (r, W):
        raise ValueError(f"words {tuple(words.shape)} != {(r, W)} for "
                         f"{c} {fmt.n_bits}-bit fields")
    if words.device.type != "cuda":
        return dequantize_packed_plain(words, scales, fmt, block, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel writes f32 or bf16, got {out_dtype}")
    C.require_cuda(words, "words", torch.uint32)
    C.require_cuda(scales, "scales", torch.float32)
    consts = cuda_consts(fmt)
    out = torch.empty((r, c), dtype=out_dtype, device=words.device)
    if r and c:
        C.check(C.lib().f2p_dequantize_packed(
            words.data_ptr(), scales.data_ptr(), out.data_ptr(), consts,
            None, None, None, consts, 1, int(out_dtype == torch.bfloat16), r,
            c, block, C.stream()), "dequantize_packed")
        C.LAUNCHES["dequantize_packed"] += 1
    return out


def _kv_read_shape(ck, cv):
    """(leading dims, hd) of the packed K and V of :func:`f2p_kv_read`,
    whose shapes it checks: words ``[..., W]`` and scales ``[..., hd /
    block]`` of unpadded rows of hd, K and V alike but for their formats."""
    kw, vw = ck.codes, cv.codes
    lead, cols, block = kw.shape[:-1], ck.shape[-1], ck.block
    nblk = ck.scales.shape[-1]
    if not (ck.packed and cv.packed and cv.block == block
            and cv.shape[-1] == cols and nblk * block == cols
            and cv.scales.shape[-1] == nblk
            and kw.shape[-1] == -(-cols * ck.fmt.n_bits // 32)
            and vw.shape[-1] == -(-cols * cv.fmt.n_bits // 32)
            and vw.shape[:-1] == lead and ck.scales.shape[:-1] == lead
            and cv.scales.shape[:-1] == lead):
        raise ValueError(
            f"f2p_kv_read takes packed K and V of one shape, unpadded rows "
            f"of {cols} fields in blocks of {block}: got k words "
            f"{tuple(kw.shape)}, scales {tuple(ck.scales.shape)}; v words "
            f"{tuple(vw.shape)}, scales {tuple(cv.scales.shape)}, block "
            f"{cv.block}, packed {ck.packed}/{cv.packed}")
    return lead, cols


def kv_read_plain(cache: dict, dtype=torch.float32):
    """The plain version of :func:`f2p_kv_read`: ``dequantize_packed_plain``
    of K and of V."""
    lead, cols = _kv_read_shape(cache["k"], cache["v"])
    odt = dtype if dtype in (torch.float32, torch.bfloat16) else torch.float32
    out = []
    for name in ("k", "v"):
        c = cache[name]
        x = dequantize_packed_plain(c.codes.reshape(-1, c.codes.shape[-1]),
                                    c.scales.reshape(-1, c.scales.shape[-1]),
                                    c.fmt, c.block, odt)
        out.append(x.reshape(*lead, cols).to(dtype))
    return tuple(out)


@charged("kv_read")
def f2p_kv_read(cache: dict, dtype=torch.float32):
    """Dense K and V of one layer's packed cache ``cache = {"k", "v"}``
    (QTensors: words ``[..., W]`` uint32 and scales ``[..., hd / block]``
    f32 of unpadded rows of hd, each side in its own format), as ``(k,
    v)``, each ``[..., hd]`` in ``dtype``: bitwise :func:`kv_read_plain`,
    the JAX reference's ``_cache_read``. On the card: ONE launch of B4 for
    K and V (bf16 or f32 out; another dtype is cast from f32), no host
    sync. The decode step calls this once per layer, so the host path is
    kept to the checks the kernel needs, the two outputs and the
    launch."""
    ck, cv = cache["k"], cache["v"]
    kw, ks, vw, vs = ck.codes, ck.scales, cv.codes, cv.scales
    if not kw.is_cuda:
        return kv_read_plain(cache, dtype)
    lead, cols = _kv_read_shape(ck, cv)
    u32, f32 = torch.uint32, torch.float32
    dev = kw.get_device()
    if not (kw.dtype == u32 and vw.dtype == u32 and ks.dtype == f32
            and vs.dtype == f32 and vw.get_device() == dev
            and ks.get_device() == dev and vs.get_device() == dev
            and kw.is_contiguous() and vw.is_contiguous()
            and ks.is_contiguous() and vs.is_contiguous()):
        for t, what, dt in ((kw, "k words", u32), (ks, "k scales", f32),
                            (vw, "v words", u32), (vs, "v scales", f32)):
            C.require_cuda(t, what, dt)
        raise ValueError("k and v words and scales must lie on one card")
    odt = dtype if dtype in (torch.float32, torch.bfloat16) else f32
    k = kw.new_empty((*lead, cols), dtype=odt)
    v = kw.new_empty((*lead, cols), dtype=odt)
    rows = math.prod(lead)
    if rows and cols:
        C.check(C.lib().f2p_dequantize_packed(
            kw.data_ptr(), ks.data_ptr(), k.data_ptr(), cuda_consts(ck.fmt),
            vw.data_ptr(), vs.data_ptr(), v.data_ptr(), cuda_consts(cv.fmt),
            2, int(odt == torch.bfloat16), rows, cols, ck.block,
            C.stream()), "kv_read")
        C.LAUNCHES["kv_read"] += 1
    if odt != dtype:
        return k.to(dtype), v.to(dtype)
    return k, v


@charged("quantize")
def f2p_quantize_codes(x2: torch.Tensor, fmt: F2PFormat, *,
                       block: int = 128, scale_mode: str = "f32"):
    """Blocked F2P quantization of ``[r, c]`` into byte-aligned codes:
    (codes ``[r, c]`` uint8 or uint16, scales ``[r, c/block]`` f32), B5 on
    a CUDA tensor. Bitwise equal on both devices and to the JAX reference."""
    _check_2d(x2, block, "x")
    if scale_mode not in ("f32", "pow2"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    if x2.device.type != "cuda":
        return quantize_plain(x2, fmt, block, scale_mode)
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes f32 or bf16 input, got {x2.dtype}")
    C.require_cuda(x2, "x")
    # raises for n_bits > 16 or h_bits > 2
    consts, tab, inv_max = _b5_args(fmt, x2.device)
    r, c = x2.shape
    cdt = code_dtype(fmt)
    codes = torch.empty((r, c), dtype=cdt, device=x2.device)
    scales = torch.empty((r, c // block), dtype=torch.float32,
                         device=x2.device)
    if r and c:
        C.check(C.lib().f2p_quantize(
            x2.data_ptr(), int(x2.dtype == torch.bfloat16), codes.data_ptr(),
            codes.element_size(), scales.data_ptr(), r, c, block, consts,
            tab, inv_max, int(scale_mode == "pow2"), C.stream()), "quantize")
        C.LAUNCHES["quantize"] += 1
    return codes, scales


@charged("dequantize")
def f2p_dequantize_codes(codes: torch.Tensor, scales: torch.Tensor,
                         fmt: F2PFormat, *, block: int = 128,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Decode x scale of byte-aligned codes ``[r, c]`` -> ``[r, c]`` in
    ``out_dtype``, B6 on a CUDA tensor."""
    _check_2d(codes, block, "codes")
    r, c = codes.shape
    if tuple(scales.shape) != (r, c // block):
        raise ValueError(f"scales {tuple(scales.shape)} != {(r, c // block)}")
    if codes.dtype != code_dtype(fmt):
        raise TypeError(f"{fmt.n_bits}-bit codes must be {code_dtype(fmt)}, "
                        f"got {codes.dtype}")
    if codes.device.type != "cuda":
        return dequantize_plain(codes, scales, fmt, block, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel writes f32 or bf16, got {out_dtype}")
    C.require_cuda(codes, "codes")
    C.require_cuda(scales, "scales", torch.float32)
    consts = cuda_consts(fmt)
    out = torch.empty((r, c), dtype=out_dtype, device=codes.device)
    if r and c:
        C.check(C.lib().f2p_dequantize(
            codes.data_ptr(), codes.element_size(), scales.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), r * c, block,
            consts, C.stream()), "dequantize")
        C.LAUNCHES["dequantize"] += 1
    return out


# ---------------------------------------------------------------------------
# B5's round-trip mode: the gradient round trip with error feedback
# ---------------------------------------------------------------------------
EF_MAX_BLOCKS = 1 << 30   # scale blocks per launch (the kernel's int32 index)
_LEAF_BF16, _LEAF_VEC = 1, 2


def ef_roundtrip_plain(g: torch.Tensor, r, fmt: F2PFormat, block: int = 128,
                       error_feedback: bool = True) -> None:
    """The plain version of :func:`f2p_ef_roundtrip` for one leaf, IN
    PLACE, the unpacked codec's composition: with error feedback ``r += g``
    and gin = r, else gin = f32(g); q = dequantize(quantize(gin)) along the
    last axis (padded with zeros to the block multiple, f32 scales); then
    ``r -= q`` (error feedback) and ``g = q`` in g's dtype. Whole rows of
    about 2^24 elements at a time (rows are independent: the same bits, and
    temporaries that fit beside a train state on the card)."""
    n = g.shape[-1] if g.ndim else 1
    g2 = g.view(-1, n)
    x2 = r.view(-1, n).add_(g2) if error_feedback else g2.to(torch.float32)
    step = max(1, (1 << 24) // n)
    for i in range(0, x2.shape[0], step):
        xi = x2[i:i + step]
        xp = torch.nn.functional.pad(xi, (0, -n % block)) if n % block else xi
        c, s = quantize_plain(xp, fmt, block)
        q = dequantize_plain(c, s, fmt, block)[:, :n]
        if error_feedback:
            xi.sub_(q)
        g2[i:i + step].copy_(q)


def ef_plan(gs, rs, block: int = 128) -> list:
    """The leaf tables of the round trip's launches, for gradients ``gs``
    and residuals ``rs`` (None without error feedback): a list of
    (table, nblocks), one per launch, leaves in order, each launch under
    ``EF_MAX_BLOCKS`` scale blocks (one launch for any model of this repo).
    ``table`` is int64 ``[n + 1, 4]``, one ``EFLeaf`` of the CUDA source
    per leaf: g's and r's addresses, ``blk0 | cols << 32`` (blk0: the
    launch-global index of the leaf's first scale block), ``nbr | flags <<
    32`` (nbr = ceil(cols / block) blocks per row; flags bf16 1, vec 2:
    cols % 4 == 0 and rows of 4 on 16-byte boundaries); row n holds blk0 =
    nblocks. A leaf of [rows, cols] has rows * nbr blocks, the last of a row
    ragged when cols % block != 0; empty leaves are left out."""
    groups, rows, blk = [], [], 0

    def close():
        if rows:
            groups.append((np.array(rows + [(0, 0, blk, 0)], dtype=np.int64),
                           blk))

    for g, r in zip(gs, rs):
        n = g.numel()
        if n == 0:
            continue
        if n >= 1 << 31:
            raise ValueError(f"a leaf of {n} elements exceeds the kernel's "
                             "32-bit index")
        cols = g.shape[-1] if g.ndim else 1
        nbr = -(-cols // block)
        nb = n // cols * nbr
        if blk + nb > EF_MAX_BLOCKS:
            close()
            rows, blk = [], 0
        esize = g.element_size()
        vec = (cols % 4 == 0 and g.data_ptr() % (4 * esize) == 0
               and (r is None or r.data_ptr() % 16 == 0))
        flags = _LEAF_BF16 * (g.dtype == torch.bfloat16) + _LEAF_VEC * vec
        rows.append((g.data_ptr(), 0 if r is None else r.data_ptr(),
                     blk | cols << 32, nbr | flags << 32))
        blk += nb
    close()
    return groups


@charged("ef_roundtrip")
def f2p_ef_roundtrip(gs, rs, fmt: F2PFormat, *, block: int = 128,
                     error_feedback: bool = True) -> None:
    """The error-feedback round trip of a train step's compressed leaves,
    IN PLACE: for each gradient g (f32 or bf16, contiguous) and f32
    residual r of g's shape, bitwise :func:`ef_roundtrip_plain`. CPU
    tensors run that plain version leaf by leaf; on the card, one launch of
    B5's round-trip mode (``ef_roundtrip_kernel``) for all the leaves, the
    leaf table (:func:`ef_plan`) sent in one async copy, no host sync and no
    temporaries. Without error feedback ``rs`` may hold None."""
    gs, rs = list(gs), list(rs)
    if len(gs) != len(rs):
        raise ValueError(f"{len(gs)} gradients but {len(rs)} residuals")
    if not gs:
        return
    kinds = {t.device.type for t in gs + rs if t is not None}
    if kinds == {"cpu"}:
        for g, r in zip(gs, rs):
            ef_roundtrip_plain(g, r, fmt, block, error_feedback)
        return
    if kinds != {"cuda"}:
        raise ValueError(f"the leaves lie on {sorted(kinds)}: the round trip "
                         "takes them all on the card or all on the CPU")
    if block != 128:
        raise ValueError(f"the round-trip kernel takes blocks of 128, got "
                         f"{block}")
    dev = gs[0].device
    for g, r in zip(gs, rs):
        if g.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"kernel takes f32 or bf16 gradients, got "
                            f"{g.dtype}")
        if g.device != dev:
            raise ValueError(f"gradients on {g.device} and {dev}")
        C.require_cuda(g, "gradient")
        if error_feedback:
            if r is None or r.device != dev:
                raise ValueError("error feedback needs each residual on the "
                                 "gradient's card")
            C.require_cuda(r, "residual", torch.float32)
            if r.shape != g.shape:
                raise ValueError(f"residual {tuple(r.shape)} != gradient "
                                 f"{tuple(g.shape)}")
    consts, tab, inv_max = _b5_args(fmt, dev)
    plan = ef_plan(gs, rs if error_feedback else [None] * len(gs), block)
    for table, nblocks in plan:
        leaves = torch.from_numpy(table).pin_memory().to(dev,
                                                         non_blocking=True)
        C.check(C.lib().f2p_ef_roundtrip(
            leaves.data_ptr(), table.shape[0] - 1, nblocks,
            int(error_feedback), tab, consts, inv_max, C.stream()),
            "ef_roundtrip")
        C.LAUNCHES["ef_roundtrip"] += 1


def encode_check(fmt: F2PFormat, scale: float = 0.0, *, device="cuda"):
    """A check on the card, no path's kernel: over all 2^32 f32 bit
    patterns, the mismatches of B5's table encode (code and value) against
    the arithmetic ``f2p_encode`` / ``f2p_decode``, or with a power-of-two
    ``scale``, of x * (1/scale) against x / scale. Returns (mismatches, the
    smallest mismatching pattern or None)."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    first = torch.full((1,), -1, dtype=torch.int32, device=device)
    consts, tab, _ = _b5_args(fmt, bad.device)
    C.check(C.lib().f2p_encode_check(
        0, 1 << 32, tab, consts, float(scale), bad.data_ptr(),
        first.data_ptr(), C.stream()), "encode_check")
    n = int(bad.item())
    return n, (int(first.item()) & 0xFFFFFFFF) if n else None
