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
``unpack_bits`` for B7); on a CUDA tensor each launches a kernel of
``csrc/f2p_kernels.cu`` or raises. Two routes compute the same function
(:func:`matmul_route`): a decode batch (M <= ``MM_DECODE_ROWS``) goes to
``dequant_matmul_decode_kernel``, which streams the weight with each lane
owning 8 columns and 8 x 8 sums in registers (rows past M are zero),
planned by
:func:`decode_plan`; a larger M goes to the tile kernel
``dequant_matmul_kernel`` (one CTA per output tile), planned by
:func:`matmul_split`. Both split K across CTAs when the columns alone do
not fill the card and add the partials in split order. Both compute in f32
only (f32 products, f32 FMA accumulation; no TF32 and no bf16 tensor
cores), as the reference does with ``preferred_element_type=float32``. At
a decode batch the work is bound by the weight bytes streamed (n_bits/8
per weight plus 4/block for the scales) and the M f32 FMAs per weight; at
a prefill batch by the f32 operations.

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
           "dequant_matmul", "matmul_split", "matmul_route", "decode_plan",
           "MM_DECODE_ROWS"]

WEIGHT_FMT = F2PFormat(n_bits=8, h_bits=2, flavor=Flavor.SR, signed=True)

# the reference's Pallas tiles: its preconditions are stated in them, and
# both packages accept the same calls
M_T, N_T, K_T = 128, 256, 256

# the tile kernel's output tile width and its K step (csrc kMmBN, kMmBK)
_BN, _BK = 128, 32

# the decode route: M at or below MM_DECODE_ROWS. A CTA of 8 warps covers
# _DEC_COLS columns (csrc kDecCols: 32 lanes x 8) and its K chunk in units
# of _DEC_UNIT rows (kDecUnit); the x chunk staged in shared memory caps
# the chunk at _DEC_MAX_CHUNK rows (32 KB at 8 rows of x), so that two
# CTAs (table, x and the warps' rings) fit an SM.
MM_DECODE_ROWS = 8
_DEC_COLS, _DEC_UNIT, _DEC_MAX_CHUNK = 256, 4, 1024


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
    """(rows per CTA, K splits) of the tile kernel's launch: the smallest row
    tile of 8, 16, 32, 64 or 128 covering M, and K split across CTAs until
    the output tiles make two waves on ``n_sm`` SMs (at most 32 splits,
    each at least one K step)."""
    bm = next(b for b in (8, 16, 32, 64, 128) if b >= min(M, 128))
    tiles = -(-M // bm) * -(-N // _BN)
    splits = max(1, min(32, K // _BK, -(-2 * n_sm // tiles)))
    return bm, splits


def matmul_route(M: int, block: int) -> str:
    """Which kernel serves an M-row call: ``"decode"`` for a decode batch
    (M <= MM_DECODE_ROWS, and scale blocks of whole 4-row units), else
    ``"tile"``."""
    return ("decode" if M <= MM_DECODE_ROWS and block % _DEC_UNIT == 0
            else "tile")


def decode_plan(M: int, N: int, K: int, n_sm: int) -> tuple[int, int]:
    """(K chunk, K splits) of the decode route's launch: a grid of
    ceil(N / 256) column groups x splits, with K split while the grid fits
    one wave of one CTA per SM (on the H100 as fast as two per SM or faster
    at every llama3.2-3b projection shape, PERF.md) and at most 32 ways
    (the last CTA of a column group adds the partials), and at least until
    a chunk is at most _DEC_MAX_CHUNK rows (a multiple of 16 rows). Every
    CTA holds MM_DECODE_ROWS rows of x, rows past M read as zero."""
    groups = -(-N // _DEC_COLS)
    splits = max(-(-K // _DEC_MAX_CHUNK), min(32, n_sm // groups))
    chunk = -(-K // min(splits, K // 16))
    chunk = -(-chunk // 16) * 16
    return chunk, -(-K // chunk)


_N_SM: dict[int, int] = {}


def _launch(x, w, scales, fmt, block, N, code_bytes, W):
    """One kernel launch: (y [M, N] f32). ``code_bytes`` 1 / 2 for uint8 /
    uint16 codes, 0 for packed words of ``W`` words per row. The SM count
    and the format's kernel constants are cached; the decode route adds
    its K splits inside the kernel, in a cached workspace."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes f32 or bf16 x, got {x.dtype}")
    C.require_cuda(x, "x")
    C.require_cuda(w, "codes" if code_bytes else "words")
    C.require_cuda(scales, "scales", torch.float32)
    M, K = x.shape
    dev = x.device
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    if not (M and N):
        return y
    n_sm = _N_SM.get(dev.index)
    if n_sm is None:
        n_sm = _N_SM[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    consts = cuda_consts(fmt)
    what = "dequant_matmul" if code_bytes else "dequant_matmul_packed"
    stream = C.stream()
    if matmul_route(M, block) == "decode":
        k_chunk, splits = decode_plan(M, N, K, n_sm)
        groups = -(-N // _DEC_COLS)
        part, counts = (C.workspace(dev, stream, splits * M * N, groups)
                        if splits > 1 else (y, y))
        C.check(C.lib().f2p_dequant_matmul_decode(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
            code_bytes, W, scales.data_ptr(), part.data_ptr(), y.data_ptr(),
            counts.data_ptr(), M, N, K, block, k_chunk, splits, consts,
            stream), what)
        return y
    bm, splits = matmul_split(M, N, K, n_sm)
    k_chunk = -(-(K // _BK) // splits) * _BK
    splits = -(-K // k_chunk)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
            if splits > 1 else y)
    C.check(C.lib().f2p_dequant_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        code_bytes, W, scales.data_ptr(), part.data_ptr(), y.data_ptr(), M,
        N, K, block, bm, k_chunk, splits, consts, stream), what)
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
