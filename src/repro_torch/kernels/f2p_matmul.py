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
``csrc/f2p_kernels.cu`` or raises. Which kernel serves a call is decided
on the host, up front, by rows (:func:`matmul_route`), format and block
(:func:`tile_kernel`), never by a failure:

- a decode batch (M <= ``MM_DECODE_ROWS``) goes to
  ``dequant_matmul_decode_kernel``, which streams the weight with each
  lane owning 8 columns and 8 x 8 f32 sums in registers (rows past M are
  zero), planned by :func:`decode_plan`; bound by the weight bytes;
- a larger M (the tile route) goes to ``dequant_matmul_mma_kernel`` on
  the tensor cores (``tile_kernel`` "mma"), planned by :func:`mma_plan`,
  when the format's decoded values hold at most 8 significant bits
  (:func:`significant_bits`: every format of at most 9 bits, and of 10
  bits all but h = 1 LR / LI), n_bits <= 10 (its decode table) and the
  block is a multiple of 16. A decoded weight is then exactly a bf16
  value (after the power of two :func:`mma_shift`), an f32 x splits
  exactly by truncation into three bf16 terms (one for bf16 x), each
  product is exact in the f32 accumulator, and each scale multiplies its
  block's sum: 3 bf16 passes for f32 x, 1 for bf16 x, the result within
  f32 rounding of the plain version's;
- the other formats (``f2p_sr_2_12s``, ``f2p_sr_2_16s``: 9 and 13
  significant bits; ``f2p_lr_1_10s``: 9) and blocks of the tile route go
  to the f32 SIMT kernel ``dequant_matmul_kernel`` (``tile_kernel``
  "simt", f32 products and FMAs, no tensor cores), planned by
  :func:`matmul_split`.

Each splits K across CTAs when the output tiles alone do not fill the card
and adds the partials in split order, so no result depends on scheduling.
``SERVED`` counts the calls each kernel served.

The reference's per-(backend, n_bits) tile table of the packed kernel
(:func:`matmul_tiles`, :func:`set_matmul_tiles`,
:func:`autotune_matmul_tiles`, ``tiles=`` on
:func:`f2p_dequant_matmul_packed`) is keyed by the device type, ``"cuda"``
or ``"cpu"``. On the card an entry (or ``tiles=``) fixes B7's tile-route
launch (:func:`tile_plan`): M_T the rows per CTA (an instance of the
kernel that serves the call), N_T the columns per CTA (``_BN``, the
kernels' only column tile) and K_T the K chunk of a split; with none the
planners above decide, as before. The decode route keeps
:func:`decode_plan` (its launch is no (M_T, N_T, K_T) tiling), and the
plain version has no tiles.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.core.qtensor import block_scales
from repro_torch.kernels import cuda as C
from repro_torch.kernels.bits import pack_bits, packed_words, unpack_bits
from repro_torch.kernels.cost import charged
from repro_torch.kernels.f2p_quant import (_int32_to_codes, code_dtype,
                                           codes_to_int32, cuda_consts,
                                           dequantize_tile_math,
                                           f2p_quantize_codes,
                                           quantize_tile_math)

__all__ = ["WEIGHT_FMT", "quantize_weight", "quantize_weight_plain",
           "dequantize_weight", "ref_dequant_matmul",
           "f2p_dequant_matmul", "f2p_dequant_matmul_packed",
           "dequant_matmul", "matmul_split", "matmul_route", "decode_plan",
           "tile_kernel", "mma_plan", "tile_plan", "significant_bits",
           "mma_shift", "matmul_tiles", "set_matmul_tiles",
           "autotune_matmul_tiles", "M_T", "N_T", "K_T", "MM_DECODE_ROWS",
           "SERVED"]

WEIGHT_FMT = F2PFormat(n_bits=8, h_bits=2, flavor=Flavor.SR, signed=True)

# the reference's Pallas tiles: its preconditions are stated in them, and
# both packages accept the same calls; matmul_tiles' default
M_T, N_T, K_T = 128, 256, 256

# per-(backend, n_bits) (M_T, N_T, K_T) of the packed kernel, the backend
# being the device type; an entry for "cuda" fixes B7's tile-route launch
_TILE_TABLE: dict[tuple[str, int], tuple[int, int, int]] = {}

# the tile kernels' output tile width (csrc kMmBN, kMmaCols) and the SIMT
# kernel's K step (kMmBK)
_BN, _BK = 128, 32

# the tensor-core kernel: its table holds every code of at most 10 bits,
# a decoded value at most bf16's 8 significant bits, a block whole mma
# K steps of 16 rows; its K step (csrc kMmaBK)
_MMA_MAX_BITS, _MMA_SIG_BITS, _MMA_K, _MMA_BK = 10, 8, 16, 64
# rows per CTA of each tile kernel's compiled instances
TILE_ROWS = {"mma": (64, 128), "simt": (8, 16, 32, 64, 128)}

# calls served by each kernel of B7 / B8 (a diagnostic beside C.LAUNCHES,
# which counts the wrappers' launches)
SERVED = {"decode": 0, "mma": 0, "simt": 0}

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


@functools.lru_cache(maxsize=64)
def _decoded_nonzero(fmt: F2PFormat) -> np.ndarray:
    """|decode(c)| of every code of the format that decodes to nonzero."""
    d = dequantize_tile_math(torch.arange(1 << fmt.n_bits, dtype=torch.int32),
                             fmt).double().abs().numpy()
    return d[d != 0]


@functools.lru_cache(maxsize=64)
def significant_bits(fmt: F2PFormat) -> int:
    """The most significant bits (leading one to last one) of any decoded
    value of the format, over every code: at most 8 makes each decoded
    weight a bf16 value."""
    m, _ = np.frexp(_decoded_nonzero(fmt))
    ints = (m * 2.0 ** 53).astype(np.int64)      # exact: 53-bit mantissas
    return int(53 - np.log2(ints & -ints).min())


@functools.lru_cache(maxsize=64)
def mma_shift(fmt: F2PFormat) -> int:
    """e with max |decode(c)| * 2^-e in [0.5, 1): the tensor-core kernel's
    table holds d * 2^-e and its scales are s * 2^e (both exact), so a
    product x * d' stays below |x|."""
    return int(np.frexp(_decoded_nonzero(fmt).max())[1])


def tile_kernel(fmt: F2PFormat, block: int) -> str:
    """Which kernel serves a tile-route call (M > MM_DECODE_ROWS):
    ``"mma"`` (``dequant_matmul_mma_kernel``, bf16 tensor cores) for a
    format of at most 10 bits whose decoded values hold at most 8
    significant bits and a block that is a multiple of 16, else ``"simt"``
    (``dequant_matmul_kernel``, f32)."""
    if (block % _MMA_K == 0 and fmt.n_bits <= _MMA_MAX_BITS
            and significant_bits(fmt) <= _MMA_SIG_BITS):
        return "mma"
    return "simt"


def mma_plan(M: int, N: int, K: int, n_sm: int) -> tuple[int, int, int]:
    """(rows per CTA, K chunk, K splits) of the tensor-core kernel's launch:
    64 or 128 rows covering M (a warpgroup per 64 rows; by shared memory
    one CTA takes an SM), and K split, in whole K steps of 64 rows and
    chunks of at least 128, while the output tiles alone leave SMs idle (at
    most 32 splits)."""
    bm = 64 if M <= 64 else 128
    tiles = -(-M // bm) * -(-N // _BN)
    splits = max(1, min(32, K // 128, n_sm // tiles))
    chunk = -(-(K // _MMA_BK) // splits) * _MMA_BK
    return bm, chunk, -(-K // chunk)


def matmul_tiles(backend: str, n_bits: int) -> tuple[int, int, int]:
    """(M_T, N_T, K_T) for the packed kernel on (backend, n_bits): table
    hit or (M_T, N_T, K_T)."""
    return _TILE_TABLE.get((backend, int(n_bits)), (M_T, N_T, K_T))


def _cuda_tiles_problem(tiles, kernel: str | None = None) -> str | None:
    """Why the tile kernels cannot take (M_T, N_T, K_T), or None: N_T must
    be the kernels' column tile, M_T the rows of an instance (of
    ``kernel``, or of either), K_T a positive multiple of the K step of
    both."""
    mt, nt, kt = (int(t) for t in tiles)
    if nt != _BN:
        return f"N_T {nt}: the tile kernels' only column tile is {_BN}"
    rows = TILE_ROWS[kernel] if kernel else sorted(
        set(TILE_ROWS["mma"]) | set(TILE_ROWS["simt"]))
    if mt not in rows:
        return (f"M_T {mt}: the {kernel or 'tile'} kernel's rows per CTA are "
                f"{tuple(rows)}")
    if kt <= 0 or kt % _MMA_BK:
        return (f"K_T {kt} must be a positive multiple of {_MMA_BK}, the "
                f"tile kernels' K step")
    return None


def _check_cuda_tiles(tiles, kernel: str | None = None):
    """(M_T, N_T, K_T) as ints, or a ValueError naming the limit."""
    problem = _cuda_tiles_problem(tiles, kernel)
    if problem:
        raise ValueError(problem)
    return tuple(int(t) for t in tiles)


def set_matmul_tiles(backend: str, n_bits: int,
                     tiles: tuple[int, int, int]) -> None:
    """Install (M_T, N_T, K_T) for (backend, n_bits): the reference's
    check (N_T word-aligned) and, for ``"cuda"``, the kernels' own."""
    mt, nt, kt = (int(t) for t in tiles)
    if nt % 32:
        raise ValueError(f"N_T {nt} not word-aligned (multiple of 32)")
    if backend == "cuda":
        _check_cuda_tiles((mt, nt, kt))
    _TILE_TABLE[(backend, int(n_bits))] = (mt, nt, kt)


def tile_plan(M: int, N: int, K: int, n_sm: int, fmt: F2PFormat,
              block: int, tiles=None) -> tuple[str, int, int, int]:
    """(kernel, rows per CTA, K chunk, K splits) of a tile-route launch
    (M > MM_DECODE_ROWS). With ``tiles`` (M_T, N_T, K_T): M_T rows, a K
    chunk of K_T and ceil(K / K_T) splits, on the kernel
    :func:`tile_kernel` picks (ValueError where it cannot take them);
    without, :func:`mma_plan` or :func:`matmul_split` decide."""
    kernel = tile_kernel(fmt, block)
    if tiles is not None:
        bm, _, chunk = _check_cuda_tiles(tiles, kernel)
        return kernel, bm, chunk, -(-K // chunk)
    if kernel == "mma":
        return (kernel,) + mma_plan(M, N, K, n_sm)
    bm, splits = matmul_split(M, N, K, n_sm)
    chunk = -(-(K // _BK) // splits) * _BK
    return kernel, bm, chunk, -(-K // chunk)


_N_SM: dict[int, int] = {}


def _launch(x, w, scales, fmt, block, N, code_bytes, W, tiles=None):
    """One kernel launch: (y [M, N] f32). ``code_bytes`` 1 / 2 for uint8 /
    uint16 codes, 0 for packed words of ``W`` words per row; ``tiles`` fix
    the tile route's launch (:func:`tile_plan`). The SM count and the
    format's kernel constants are cached; the decode route adds its K
    splits inside the kernel, in a cached workspace."""
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
        SERVED["decode"] += 1
        return y
    kernel, bm, k_chunk, splits = tile_plan(M, N, K, n_sm, fmt, block,
                                             tiles)
    shift = mma_shift(fmt) if kernel == "mma" else 0
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
            if splits > 1 else y)
    C.check(C.lib().f2p_dequant_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        code_bytes, W, scales.data_ptr(), part.data_ptr(), y.data_ptr(), M,
        N, K, block, int(kernel == "mma"), bm, k_chunk, splits, shift,
        consts, stream), what)
    SERVED[kernel] += 1
    return y


@charged("dequant_matmul")
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


@charged("dequant_matmul_packed")
def f2p_dequant_matmul_packed(x: torch.Tensor, words: torch.Tensor,
                              scales: torch.Tensor, *,
                              fmt: F2PFormat = WEIGHT_FMT,
                              block: int = 128,
                              tiles: tuple[int, int, int] | None = None
                              ) -> torch.Tensor:
    """y = x @ dequant(unpack(words), scales); words ``[K,
    packed_words(N)]`` uint32 from ``quantize_weight(..., packed=True)``;
    B7 on a CUDA tensor. ``tiles=None`` takes the tile table's entry for
    (the device type, n_bits), if any: on the card ``tiles`` fix the tile
    route's launch (M > MM_DECODE_ROWS), with none the planners decide;
    the plain version has no tiles."""
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
    if tiles is None:
        tiles = _TILE_TABLE.get(("cuda", fmt.n_bits))
    y = _launch(x, words, scales, fmt, block, N, 0, W, tiles)
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


def autotune_matmul_tiles(backend: str, n_bits: int, *,
                          candidates=((128, 128, 256), (64, 128, 256),
                                      (128, 128, 128), (64, 128, 128)),
                          shape=(256, 1024, 1024), reps: int = 3,
                          fmt: F2PFormat | None = None, block: int = 128
                          ) -> tuple[int, int, int]:
    """Time the packed kernel over candidate (M_T, N_T, K_T) tiles on a
    serve-shaped matmul ``(M, K, N)`` and install the winner in the tile
    table; returns it. ``backend`` must be ``"cuda"``: the plain version
    has no tiles (the reference refuses its xla path the same way).
    Candidates the kernel cannot take are skipped (the reference's N_T of
    256 among them: the kernels' column tile is 128, so the defaults are
    the port's own)."""
    import time

    if backend != "cuda":
        raise ValueError(f"tile autotune is for the card ('cuda'), not "
                         f"{backend!r}: the plain version has no tiles")
    if fmt is None:
        fmt = F2PFormat(n_bits, 2, Flavor.SR, signed=True)
    M, K, N = shape
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).cuda()
    words, scales = quantize_weight(w, fmt, block=block, packed=True)
    kernel = tile_kernel(fmt, block)
    best, best_t = None, None
    for t in candidates:
        if _cuda_tiles_problem(t, kernel):
            continue
        mt, nt, kt = (int(v) for v in t)

        def run():
            return f2p_dequant_matmul_packed(x, words, scales, fmt=fmt,
                                             block=block, tiles=(mt, nt, kt))

        run()       # the build and first use outside the clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(max(1, reps)):
            run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best, best_t = dt, (mt, nt, kt)
    if best_t is None:
        raise ValueError(f"no candidate tile fits the {kernel} kernel: "
                         f"{candidates}")
    set_matmul_tiles(backend, n_bits, best_t)
    return best_t
