"""Block-scaled F2P quantize / dequantize, packed and unpacked: tile math,
plain versions and the CUDA kernel wrappers.

Port of ``repro.kernels.f2p_quant``. The tile
math is the reference's branch-free arithmetic, written on torch int32/f32
tensors so it is bitwise identical to the JAX functions:

  encode:  exact floor(log2 x) via the f32 bit pattern -> exponent bucket V
           -> per-bucket mantissa width -> round-half-up mantissa through the
           exact fractional part -> field assembly with variable shifts.
  decode:  field split with variable shifts -> ldexp by bit assembly.

Four entry points, each routed by the tensor's device (no registry, no
environment override): a CPU tensor runs the plain PyTorch version, a CUDA
tensor launches the hand-written kernel of ``csrc/f2p_kernels.cu`` or raises.

``f2p_quantize_packed`` replaces the TPU kernel
``repro/kernels/f2p_quant.py::_quant_packed_kernel``. On an H100 it is
bound by bytes: it reads ``x`` once and writes n_bits/8 bytes per element
plus one f32 scale per block. The kernel gives one warp to each scale block
(shuffle absmax, per-lane encode into shared memory) and assembles each
output word in one thread, so the only device-memory traffic is that one
read and that one write.

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

import numpy as np
import torch

from repro_torch.core.f2p import F2PFormat
from repro_torch.kernels import cuda as C
from repro_torch.kernels.bits import pack_bits, packed_words, unpack_bits

__all__ = ["quantize_tile_math", "dequantize_tile_math",
           "f2p_quantize_packed", "f2p_dequantize_packed",
           "quantize_packed_plain", "dequantize_packed_plain",
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


def inv_max_value(fmt: F2PFormat) -> float:
    """f32(1 / max_value): block scales MULTIPLY by this constant."""
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
    on both devices and to the JAX reference."""
    _check_2d(x2, block, "x")
    if scale_mode not in ("f32", "pow2"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    if x2.device.type != "cuda":
        return quantize_packed_plain(x2, fmt, block, scale_mode)
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes f32 or bf16 input, got {x2.dtype}")
    C.require_cuda(x2, "x")
    r, c = x2.shape
    if 4 * c > C.MAX_SMEM:
        raise ValueError(f"row of {c} codes exceeds the kernel's shared "
                         "memory stage")
    W = packed_words(c, fmt.n_bits)
    words = torch.empty((r, W), dtype=torch.uint32, device=x2.device)
    scales = torch.empty((r, c // block), dtype=torch.float32,
                         device=x2.device)
    if r:
        C.check(C.lib().f2p_quantize_packed(
            x2.data_ptr(), int(x2.dtype == torch.bfloat16), words.data_ptr(),
            scales.data_ptr(), r, c, block, W, cuda_consts(fmt),
            inv_max_value(fmt), int(scale_mode == "pow2"), C.stream()),
            "quantize_packed")
        C.LAUNCHES["quantize_packed"] += 1
    return words, scales


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
