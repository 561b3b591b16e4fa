"""Block-scaled F2P quantize / dequantize, packed and unpacked: tile math,
plain versions and the CUDA kernel wrappers.

Port of ``repro.kernels.f2p_quant``. The tile
math is the reference's branch-free arithmetic, written on torch int32/f32
tensors so it is bitwise identical to the JAX functions:

  encode:  exact floor(log2 x) via the f32 bit pattern -> exponent bucket V
           -> per-bucket mantissa width -> round-half-up mantissa through the
           exact fractional part -> field assembly with variable shifts.
  decode:  field split with variable shifts -> ldexp by bit assembly.

Five entry points, each routed by the tensor's device (no registry, no
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

``f2p_dequantize_packed`` replaces
``repro/kernels/f2p_quant.py::_dequant_packed_kernel``. Also bound by bytes
(packed words and scales in, one value out per element); one thread per
output element reads the one or two words holding its field, so codes never
exist outside registers.

``f2p_quantize_codes`` replaces ``repro/kernels/f2p_quant.py::_quant_kernel``
(B5): the same scales and codes as the packed quantize, stored one code per
byte (n_bits <= 8, uint8) or per two bytes (uint16). Bound by bytes: x in
once, 1 or 2 bytes per element and one f32 per block out. One warp per
scale block; at block 128 a lane loads its 4 consecutive values in one
vector load, keeps them in registers between the shuffle absmax and the
encode, and stores its 4 codes at once. ``f2p_dequantize_codes`` replaces
``_dequant_kernel`` (B6): decode times the block's scale, 4 codes per
thread where aligned, bound by bytes. Other blocks and misaligned tensors
take the kernels' one-element-per-lane forms.

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

__all__ = ["quantize_tile_math", "dequantize_tile_math",
           "f2p_quantize_packed", "f2p_dequantize_packed", "f2p_kv_write",
           "quantize_packed_plain", "dequantize_packed_plain",
           "kv_write_plain",
           "f2p_quantize_codes", "f2p_dequantize_codes", "quantize_plain",
           "dequantize_plain", "code_dtype", "codes_to_int32"]

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
    if pages is None:
        page, off = torch.arange(B, device=dev)[:, None].expand(B, S), p
    else:
        col = torch.clamp(p // T, max=pages.shape[1] - 1)
        page, off = pages.to(dev).gather(1, col).to(torch.int64), p % T
    for name, x in (("k", k), ("v", v)):
        c = cache[name]
        words, scales = quantize_packed_plain(x.reshape(-1, x.shape[-1]),
                                              c.fmt, c.block)
        c.codes.view(torch.int32)[page, off] = words.view(torch.int32) \
            .reshape(B, S, *c.codes.shape[2:])
        c.scales[page, off] = scales.reshape(B, S, *c.scales.shape[2:])


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


def f2p_dequantize_packed(words: torch.Tensor, scales: torch.Tensor,
                          fmt: F2PFormat, *, block: int = 128,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Fused unpack -> decode -> scale: ``[r, nblk*block]`` in out_dtype."""
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
    out = torch.empty((r, c), dtype=out_dtype, device=words.device)
    if r:
        C.check(C.lib().f2p_dequantize_packed(
            words.data_ptr(), scales.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), r, c, block, W,
            cuda_consts(fmt), C.stream()), "dequantize_packed")
        C.LAUNCHES["dequantize_packed"] += 1
    return out


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
    consts = cuda_consts(fmt)   # raises for n_bits > 16 or h_bits > 2
    r, c = x2.shape
    cdt = code_dtype(fmt)
    codes = torch.empty((r, c), dtype=cdt, device=x2.device)
    scales = torch.empty((r, c // block), dtype=torch.float32,
                         device=x2.device)
    if r and c:
        C.check(C.lib().f2p_quantize(
            x2.data_ptr(), int(x2.dtype == torch.bfloat16), codes.data_ptr(),
            codes.element_size(), scales.data_ptr(), r, c, block, consts,
            inv_max_value(fmt), int(scale_mode == "pow2"), C.stream()),
            "quantize")
        C.LAUNCHES["quantize"] += 1
    return codes, scales


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
