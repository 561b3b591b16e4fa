"""F2P weight-only quantized matmul ``y = x @ dequant(W)``: the weight codec,
the plain versions and the CUDA kernel wrappers (port of
``repro.kernels.f2p_matmul``).

W ``[K, N]`` is stored as F2P codes plus f32 scales whose blocks run along
K, the contraction axis (``scales [K/block, N]``): unpacked codes
``[K, N]`` (uint8 up to 8 bits, uint16 above) or, ``packed=True``, each
K-row's N codes bit-packed into the port's uint32 word layout
(``words [K, packed_words(N, n_bits)]``; rows never share words).

``f2p_dequant_matmul`` replaces the TPU kernel
``repro/kernels/f2p_matmul.py::_kernel`` (B8) and
``f2p_dequant_matmul_packed`` replaces ``_packed_kernel`` (B7). On a CPU
tensor each runs its plain version (:func:`ref_dequant_matmul`, after
``unpack_bits`` for B7); on a CUDA tensor each launches
``dequant_matmul_kernel`` of ``csrc/f2p_kernels.cu`` or raises. The kernel
computes in f32 only (f32 products, f32 FMA accumulation; no TF32 and no
bf16 tensor cores), as the reference does with
``preferred_element_type=float32``. At a decode batch (M = 8) it is bound
by the weight bytes it streams (n_bits/8 per weight plus 4/block for the
scales); at a prefill batch by its f32 operations. The kernel's design
(one CTA per output tile, K split across CTAs when the tiles alone do not
fill the card) is described in the CUDA source.

The reference's per-(backend, n_bits) tile table and
``autotune_matmul_tiles`` tune Pallas tiles and have no counterpart yet
(ROADMAP A8).
"""
from __future__ import annotations

import torch

from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.core.qtensor import block_scales
from repro_torch.kernels import cuda as C
from repro_torch.kernels.bits import pack_bits, packed_words, unpack_bits
from repro_torch.kernels.f2p_quant import (_int32_to_codes, code_dtype,
                                           codes_to_int32, cuda_consts,
                                           dequantize_tile_math,
                                           f2p_quantize_codes,
                                           quantize_tile_math)

__all__ = ["WEIGHT_FMT", "quantize_weight", "quantize_weight_plain",
           "dequantize_weight", "ref_dequant_matmul",
           "f2p_dequant_matmul", "f2p_dequant_matmul_packed",
           "dequant_matmul", "matmul_split"]

WEIGHT_FMT = F2PFormat(n_bits=8, h_bits=2, flavor=Flavor.SR, signed=True)

# the reference's Pallas tiles: its preconditions are stated in them, and
# both packages accept the same calls
M_T, N_T, K_T = 128, 256, 256

# the CUDA kernel's output tile width and its K step (csrc kMmBN, kMmBK)
_BN, _BK = 128, 32


# ---------------------------------------------------------------------------
# The weight codec and the plain version
# ---------------------------------------------------------------------------
def quantize_weight(w: torch.Tensor, fmt: F2PFormat = WEIGHT_FMT,
                    block: int = 128, packed: bool = False):
    """w ``[K, N]`` -> (codes ``[K, N]``, scales f32 ``[K/block, N]``); with
    ``packed=True`` (words uint32 ``[K, packed_words(N, n_bits)]``,
    scales). Bitwise equal to the reference on both devices. On a CUDA
    tensor the codes come from B5 on ``w.T`` (its blocks run along the last
    axis, which is K there), transposed back."""
    K, _ = w.shape
    if K % block:
        raise ValueError(f"K {K} not a multiple of block {block}")
    if w.device.type != "cuda":
        return quantize_weight_plain(w, fmt, block, packed)
    ct, st = f2p_quantize_codes(w.T.contiguous(), fmt, block=block)
    codes, scale = ct.T.contiguous(), st.T.contiguous()
    if packed:
        return pack_bits(codes_to_int32(codes), fmt.n_bits), scale
    return codes, scale


def quantize_weight_plain(w: torch.Tensor, fmt: F2PFormat = WEIGHT_FMT,
                          block: int = 128, packed: bool = False):
    """The reference's ``quantize_weight`` body on torch tensors of any
    device: the plain version B5's codes are held to on the card."""
    K, N = w.shape
    wb = w.to(torch.float32).reshape(K // block, block, N)
    scale = block_scales(wb.movedim(-1, 0), fmt).T.contiguous()
    codes = quantize_tile_math(wb / scale[:, None, :], fmt).reshape(K, N)
    if packed:
        return pack_bits(codes, fmt.n_bits), scale
    return _int32_to_codes(codes, fmt), scale


def dequantize_weight(codes: torch.Tensor, scales: torch.Tensor,
                      fmt: F2PFormat = WEIGHT_FMT,
                      block: int = 128) -> torch.Tensor:
    """W ``[K, N]`` f32 = decode(codes) x scales, each element the
    correctly rounded f32 product."""
    K, N = codes.shape
    w = dequantize_tile_math(codes_to_int32(codes), fmt)
    return (w.reshape(K // block, block, N) * scales[:, None, :]).reshape(
        K, N)


def ref_dequant_matmul(x: torch.Tensor, codes: torch.Tensor,
                       scales: torch.Tensor, fmt: F2PFormat = WEIGHT_FMT,
                       block: int = 128) -> torch.Tensor:
    """The plain version: dequantize the whole W, then an f32 matmul."""
    return x.to(torch.float32) @ dequantize_weight(codes, scales, fmt, block)


# ---------------------------------------------------------------------------
# Device-routed entry points
# ---------------------------------------------------------------------------
def _check(x, K2, N, block):
    """The reference's preconditions (``_dequant_matmul_jit`` :120-122,
    ``_dequant_matmul_packed_jit`` :188-194) as ValueErrors."""
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D [M, K], got {tuple(x.shape)}")
    M, K = x.shape
    if K != K2:
        raise ValueError(f"x has K={K}, the weight K={K2}")
    if K % K_T or K_T % block:
        raise ValueError(f"K {K} must be a multiple of {K_T}, and {K_T} of "
                         f"block {block}")
    mt, nt = min(M_T, M), min(N_T, N)
    if M % mt or N % nt:
        raise ValueError(f"M {M} / N {N} not divisible by their tiles "
                         f"({mt}, {nt})")


def matmul_split(M: int, N: int, K: int, n_sm: int) -> tuple[int, int]:
    """(rows per CTA, K splits) of the kernel's launch: the smallest row
    tile of 8, 16, 32, 64 or 128 covering M, and K split across CTAs until
    the output tiles make two waves on ``n_sm`` SMs (at most 32 splits,
    each at least one K step)."""
    bm = next(b for b in (8, 16, 32, 64, 128) if b >= min(M, 128))
    tiles = -(-M // bm) * -(-N // _BN)
    splits = max(1, min(32, K // _BK, -(-2 * n_sm // tiles)))
    return bm, splits


def _launch(x, w, scales, fmt, block, N, code_bytes, W):
    """One kernel launch: (y [M, N] f32). ``code_bytes`` 1 / 2 for uint8 /
    uint16 codes, 0 for packed words of ``W`` words per row."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes f32 or bf16 x, got {x.dtype}")
    C.require_cuda(x, "x")
    C.require_cuda(w, "codes" if code_bytes else "words")
    C.require_cuda(scales, "scales", torch.float32)
    M, K = x.shape
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if not (M and N):
        return y
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    bm, splits = matmul_split(M, N, K, n_sm)
    k_chunk = -(-(K // _BK) // splits) * _BK
    splits = -(-K // k_chunk)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else y)
    C.check(C.lib().f2p_dequant_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        code_bytes, W, scales.data_ptr(), part.data_ptr(), y.data_ptr(), M,
        N, K, block, bm, k_chunk, splits, cuda_consts(fmt), C.stream()),
        "dequant_matmul" if code_bytes else "dequant_matmul_packed")
    return y


def f2p_dequant_matmul(x: torch.Tensor, codes: torch.Tensor,
                       scales: torch.Tensor, *, fmt: F2PFormat = WEIGHT_FMT,
                       block: int = 128) -> torch.Tensor:
    """y ``[M, N]`` f32 = x ``[M, K]`` @ dequant(codes ``[K, N]``, scales);
    B8 on a CUDA tensor."""
    K2, N = codes.shape
    _check(x, K2, N, block)
    if tuple(scales.shape) != (K2 // block, N):
        raise ValueError(f"scales {tuple(scales.shape)} != "
                         f"{(K2 // block, N)}")
    if codes.dtype != code_dtype(fmt):
        raise TypeError(f"{fmt.n_bits}-bit codes must be {code_dtype(fmt)}, "
                        f"got {codes.dtype}")
    if x.device.type != "cuda":
        return ref_dequant_matmul(x, codes, scales, fmt, block)
    y = _launch(x, codes, scales, fmt, block, N, codes.element_size(), 0)
    C.LAUNCHES["dequant_matmul"] += 1
    return y


def f2p_dequant_matmul_packed(x: torch.Tensor, words: torch.Tensor,
                              scales: torch.Tensor, *,
                              fmt: F2PFormat = WEIGHT_FMT,
                              block: int = 128) -> torch.Tensor:
    """y = x @ dequant(unpack(words), scales); words ``[K,
    packed_words(N)]`` uint32 from ``quantize_weight(..., packed=True)``;
    B7 on a CUDA tensor."""
    N = scales.shape[-1]
    K2, W = words.shape
    _check(x, K2, N, block)
    if W != packed_words(N, fmt.n_bits):
        raise ValueError(f"words have {W} per row, {N} {fmt.n_bits}-bit "
                         f"fields need {packed_words(N, fmt.n_bits)}")
    if x.device.type != "cuda":
        codes = unpack_bits(words, fmt.n_bits, N)
        return ref_dequant_matmul(x, codes, scales, fmt, block)
    if words.dtype != torch.uint32:
        raise TypeError(f"words must be uint32, got {words.dtype}")
    y = _launch(x, words, scales, fmt, block, N, 0, W)
    C.LAUNCHES["dequant_matmul_packed"] += 1
    return y


def dequant_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                   *, fmt: F2PFormat = WEIGHT_FMT, block: int = 128,
                   packed: bool = False) -> torch.Tensor:
    """y = x @ dequant(codes, scales); with ``packed=True`` ``codes`` is the
    uint32 word stream of ``quantize_weight(..., packed=True)``. The
    tensors' device picks the path."""
    fn = f2p_dequant_matmul_packed if packed else f2p_dequant_matmul
    return fn(x, codes, scales, fmt=fmt, block=block)
