"""Flash-style attention straight off the bit-packed F2P KV cache, dense
(``attention_packed``) and through a page table (``attention_paged``).

Port of ``repro.kernels.f2p_attention`` (DESIGN.md §11, §14). GQA folds
q ``[B, Sq, H, hd]`` (H = K*G) to rows ``[B, K, R = G*Sq, hd]`` (row
r = g*Sq + s), so the G query heads of a kv head share each decoded K/V
element; causal masks recover the query position as ``q_offset + r % Sq``.

The plain version keeps the reference's tile loop and its -inf-guarded
online softmax (``_online_step``) op for op: per kv tile, unpack the n-bit
fields, decode, scale, then one (acc, m, l) update. The paged plain version
gathers each tile's pages straight from the slabs, so with the same tile it
is bitwise equal to the dense one over :func:`gather_pages_to_dense`.

Device routing: CPU tensors run the plain version; CUDA tensors launch
``attention_decode_kernel`` of ``csrc/f2p_kernels.cu`` (or raise). That
kernel replaces ``repro/kernels/f2p_attention.py::_fused_kernel`` (dense)
and ``::_paged_kernel`` (paged). On an H100 decode attention is bound by
bytes and instruction issue: it reads every live packed K/V word and scale
once (n_bits/8 bytes per element instead of 2 for bf16) and does 4*R*hd
flops per position. The kernel splits KV across CTAs: a CTA takes ``tile``
consecutive positions (a multiple of :data:`ATTN_CHUNK`; 128 by default),
walked in passes of 128 (16 per warp, one per lane) of one (batch row, kv
head, group of 3 or 4 query rows), each warp keeping its own online
softmax across its chunks. It stages their packed words with
``cp.async``, decodes each element once in registers (a bank-replicated
table up to 8 bits), forms the QK dots by a transposing warp butterfly
and PV with lanes owning dims, and merges warps, then splits, in a fixed
order (the last CTA of a row merges any number of splits). No K/V word
past a row's kv_len is read: the result depends on each row's kv_len,
words and the tile only, not on S, the span bucket, B or the SM count, so
paged == dense-over-gathered-pages bitwise on the card too at one tile,
and a paged call on a page table cut to a span bucket equals the dense
call on the full cache, for a cache of any length. q is read and o
written in the caller's layout and dtype (f32 or bf16) by the kernel, and
kv_len / q_offset / the page ids are read (and the ids clamped) there:
one launch per call. The wrapper's host-side plan is
:func:`attention_plan`.

The kv tile comes from the caller (``tile=``) or, when it passes none,
from the per-(backend, n_bits) tile table (:func:`attention_tile`,
:func:`set_attention_tile`, :func:`autotune_attention_tile`), keyed as
the reference keys it but by the device type: ``"cuda"`` (the kernel's
positions per CTA) or ``"cpu"`` (the plain version's tile).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import qtensor as QT
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import cuda as C
from repro_torch.kernels.bits import unpack_bits
from repro_torch.kernels.cost import charged
from repro_torch.kernels.f2p_quant import cuda_consts, dequantize_tile_math

__all__ = ["attention_packed", "attention_paged", "attention_packed_plain",
           "attention_paged_plain", "gather_pages_to_dense",
           "attention_reference", "attention_packed_reference",
           "attention_paged_reference", "attention_plan", "AttnPlan",
           "attention_tile", "set_attention_tile", "autotune_attention_tile",
           "DEFAULT_TILE", "ATTN_SPLIT"]

# kv-tile length: cache positions per grid step of the reference, per CTA
# of the kernel, per step of the plain version's loop. Per-(backend,
# n_bits) overrides as in the reference, the backend being the device type
# ("cuda" or "cpu"); DEFAULT_TILE when absent.
DEFAULT_TILE = 128
_TILE_TABLE: dict[tuple[str, int], int] = {}
# the kernel's default positions per CTA: one pass of its 8 warps of
# kAttnChunk = 16 positions
ATTN_SPLIT = 128
ATTN_CHUNK = 16         # a kernel tile is a multiple of the warp chunk
ATTN_MAX_TILE = 1 << 20   # the kernel's split arithmetic stays in int32
ATTN_ROWS = (3, 4)      # query rows per CTA: the kernel's instances
ATTN_MAX_HEAD_DIM = 128   # a lane holds at most 4 dims of a row
ATTN_MAX_GRID_YZ = 65535  # CUDA's limit on the grid's y (K x groups) and z (B)
_BACKENDS = ("cuda", "cpu")


def attention_tile(backend: str, n_bits: int) -> int:
    """kv-tile length for (backend, n_bits): table hit or DEFAULT_TILE."""
    return _TILE_TABLE.get((backend, int(n_bits)), DEFAULT_TILE)


def kernel_takes_tile(tile: int) -> bool:
    """Whether the kernel takes ``tile`` positions per CTA: a multiple of
    :data:`ATTN_CHUNK` up to :data:`ATTN_MAX_TILE`."""
    return 0 < int(tile) <= ATTN_MAX_TILE and int(tile) % ATTN_CHUNK == 0


def _check_kernel_tile(tile: int) -> int:
    """The kernel's tile, or a ValueError naming the limit."""
    tile = int(tile)
    if not kernel_takes_tile(tile):
        raise ValueError(f"attention kernel takes a tile that is a multiple "
                         f"of {ATTN_CHUNK} positions up to {ATTN_MAX_TILE}, "
                         f"got {tile}")
    return tile


def set_attention_tile(backend: str, n_bits: int, tile: int) -> None:
    """Install ``tile`` for (backend, n_bits); ``"cuda"`` takes only a tile
    the kernel can take."""
    if backend == "cuda":
        _check_kernel_tile(tile)
    _TILE_TABLE[(backend, int(n_bits))] = int(tile)


def _resolve_tile(q, kq: QTensor, tile) -> int:
    """An explicit tile wins; else the table entry for q's device type and
    the K format's width."""
    if tile is None:
        return attention_tile(q.device.type, kq.fmt.n_bits)
    return int(tile)


# ---------------------------------------------------------------------------
# Shared per-tile math (plain version)
# ---------------------------------------------------------------------------
def _decode_rows(words, scales, fmt: F2PFormat, hd: int):
    """[..., W] uint32 words + [..., 1] f32 scales -> [..., hd] f32."""
    codes = unpack_bits(words, fmt.n_bits, hd)
    return dequantize_tile_math(codes, fmt) * scales


def _tile_mask(j: int, tile: int, rows: int, sq: int, causal: bool,
               kvlen, qoff):
    """[B, 1, rows, tile] validity of kv tile ``j`` for per-batch [B]
    kvlen/qoff: position < kvlen and (causal) <= q_offset + r % Sq."""
    dev = kvlen.device
    kpos = j * tile + torch.arange(tile, device=dev)
    valid = kpos[None, None, None, :] < kvlen[:, None, None, None]
    if causal:
        r = torch.arange(rows, device=dev)
        qpos = qoff[:, None] + r[None, :] % sq                # [B, rows]
        valid = valid & (kpos[None, None, None, :] <= qpos[:, None, :, None])
    return valid


def _online_step(q2, k_t, v_t, valid, acc, m, l, scale: float):
    """One online-softmax update over a tile: q2 [B,K,R,hd], k_t/v_t
    [B,K,T,hd] f32, valid [B,1,R,T], running acc [B,K,R,hd], m/l
    [B,K,R,1]. The same guarded rescale as the reference."""
    s = torch.matmul(q2, k_t.transpose(-1, -2)) * scale
    s = torch.where(valid, s, -math.inf)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - safe_m)
    corr = torch.exp(torch.where(torch.isfinite(m), m - safe_m, -math.inf))
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.matmul(p, v_t)
    return acc_new, m_new, l_new


def _tile_loop(q3, lens, sq: int, causal: bool, tile: int, nt: int,
               tile_kv):
    """Run the online softmax over ``nt`` tiles; ``tile_kv(j)`` returns the
    tile's (k, v) as contiguous [B, K, tile, hd] f32."""
    B, K, R, hd = q3.shape
    scale = 1.0 / math.sqrt(hd)
    acc = torch.zeros_like(q3)
    m = torch.full((B, K, R, 1), -math.inf, device=q3.device)
    l = torch.zeros((B, K, R, 1), device=q3.device)
    kvlen, qoff = lens[:, 0], lens[:, 1]
    for j in range(nt):
        kt, vt = tile_kv(j)
        valid = _tile_mask(j, tile, R, sq, causal, kvlen, qoff)
        acc, m, l = _online_step(q3, kt, vt, valid, acc, m, l, scale)
    return acc / torch.clamp_min(l, 1e-37)


def _fold_q(q, K: int):
    """[B, Sq, H, hd] -> [B, K, G*Sq, hd] f32 (row r = g*Sq + s)."""
    B, Sq, H, hd = q.shape
    G = H // K
    q3 = q.to(torch.float32).reshape(B, Sq, K, G, hd)
    return q3.permute(0, 2, 3, 1, 4).reshape(B, K, G * Sq, hd).contiguous()


def _unfold_o(o3, sq: int, dtype):
    """Inverse of :func:`_fold_q`: [B, K, G*Sq, hd] -> [B, Sq, H, hd]."""
    B, K, R, hd = o3.shape
    G = R // sq
    o = o3.reshape(B, K, G, sq, hd).permute(0, 3, 1, 2, 4)
    return o.reshape(B, sq, K * G, hd).to(dtype)


def _take_words(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``words[idx]`` along the first axis, through the int32 view."""
    return words.view(torch.int32)[idx].view(torch.uint32)


def _make_lens(kv_len, q_offset, B: int, S: int, device):
    """Per-batch ``[B, 2]`` int32 (kv_len, q_offset): scalars broadcast to
    every row, ``[B]`` vectors thread per-slot lengths."""
    def per_row(v):
        # a Python int fills on the device: no host->device copy (which
        # would make the step wait for the stream)
        if isinstance(v, (int, np.integer)):
            return torch.full((B,), int(v), dtype=torch.int32, device=device)
        return torch.as_tensor(v, dtype=torch.int32, device=device).expand(B)

    kv_len = torch.clamp(per_row(S if kv_len is None else kv_len), max=S)
    return torch.stack([kv_len, per_row(q_offset)], dim=1).contiguous()


def _to_tiles(x, B: int, nt: int, tile: int):
    """[B, S, K, hd] -> tile j as contiguous [B, K, tile, hd] (zero pad)."""
    pad = nt * tile - x.shape[1]
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    return lambda j: x[:, j * tile:(j + 1) * tile].permute(
        0, 2, 1, 3).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrapper (both addressing modes)
# ---------------------------------------------------------------------------
class AttnPlan(NamedTuple):
    """The kernel's launch: query rows in ``groups`` groups of ``rows``
    per CTA (rows past R are masked), ``nsplit`` splits of ``tile``
    positions, grid (nsplit, K * groups, B), and the split workspace
    (``n_part`` f32 partials, ``n_counts`` counts; none with one split)."""
    rows: int
    groups: int
    nsplit: int
    grid: tuple
    n_part: int
    n_counts: int
    tile: int


@functools.lru_cache(maxsize=1024)
def attention_plan(B: int, K: int, R: int, hd: int, S: int,
                   tile: int = ATTN_SPLIT) -> AttnPlan:
    """The kernel's launch plan from shapes only: batch rows, kv heads,
    folded query rows R = G*Sq, head_dim, the per-row length S the cache
    can hold (paged: max_pages * page_tokens) and the positions per CTA.
    It never reads kv_len (a device value): the grid covers S, of any
    length, and the kernel retires the splits past each row's kv_len
    itself. Raises ValueError naming the limit on a head_dim, a tile or a
    grid the kernel cannot take."""
    if not 1 <= hd <= ATTN_MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes head_dim 1..{ATTN_MAX_HEAD_DIM},"
                         f" got {hd}")
    lane_dims = 1 if hd <= 32 else 2 if hd <= 64 else 4
    if hd % lane_dims:
        raise ValueError(f"attention kernel: head_dim {hd} is not a multiple "
                         f"of the {lane_dims} dims a lane holds")
    tile = _check_kernel_tile(tile)
    groups = -(-R // ATTN_ROWS[-1])
    rows = max(ATTN_ROWS[0], -(-R // groups))
    if K * groups > ATTN_MAX_GRID_YZ or B > ATTN_MAX_GRID_YZ:
        raise ValueError(f"attention kernel's grid takes at most "
                         f"{ATTN_MAX_GRID_YZ} kv heads x row groups and "
                         f"batch rows, got {K * groups} and {B}")
    nsplit = max(1, -(-S // tile))
    many = nsplit > 1
    return AttnPlan(rows, groups, nsplit,
                    (nsplit, K * groups, B),
                    B * K * groups * nsplit * (rows * hd + 2 * rows) if many
                    else 0, B * K * groups if many else 0, tile)


def _attention_cuda(q, kq: QTensor, vq: QTensor, kv_len, q_offset, causal,
                    tile: int, pages=None):
    """One launch of the kernel at ``tile`` positions per CTA; o ``[B, Sq,
    H, hd]`` in q's dtype."""
    B, Sq, H, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention kernel takes f32 or bf16 q, got {q.dtype}")
    if q.stride(-1) != 1:
        q = q.contiguous()
    kw, ks, vw, vs = kq.codes, kq.scales, vq.codes, vq.scales
    for t, what, dt in ((kw, "k words", torch.uint32),
                        (ks, "k scales", torch.float32),
                        (vw, "v words", torch.uint32),
                        (vs, "v scales", torch.float32)):
        C.require_cuda(t, what, dt)
    K = kw.shape[2]
    if pages is not None:
        C.require_cuda(pages, "pages", torch.int32)
        P, T = kw.shape[0], kw.shape[1]
        maxp = pages.shape[1]
        S = maxp * T
        n_rows = P * T * K
    else:
        P, T, maxp, S = 0, 0, 0, kw.shape[1]
        n_rows = B * S * K
    if n_rows >= 2 ** 31:
        raise ValueError(f"attention kernel indexes < 2^31 cache rows, got "
                         f"{n_rows}")
    plan = attention_plan(B, K, (H // K) * Sq, hd, S, tile)
    dev = q.device
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    stream = C.stream()
    part = counts = None
    if plan.nsplit > 1:
        part, counts = C.workspace(dev, stream, plan.n_part, plan.n_counts)
    lens, keep_l = C.len_arg(kv_len, B, S, dev)
    qoff, keep_q = C.len_arg(q_offset, B, 0, dev)
    what = "attention_paged" if pages is not None else "attention_packed"
    C.check(C.lib().f2p_attention(
        q.data_ptr(), int(q.dtype == torch.bfloat16), q.stride(0),
        q.stride(1), q.stride(2), kw.data_ptr(), ks.data_ptr(),
        vw.data_ptr(), vs.data_ptr(),
        None if pages is None else pages.data_ptr(), lens, qoff,
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if counts is None else counts.data_ptr(), B, Sq, H, K, hd,
        kw.shape[-1], vw.shape[-1], S, T, P, maxp, int(causal), plan.nsplit,
        plan.tile, plan.rows, plan.groups, cuda_consts(kq.fmt),
        cuda_consts(vq.fmt),
        1.0 / math.sqrt(hd), stream), what)
    C.LAUNCHES[what] += 1
    return out


def _check_cache(qt: QTensor, hd: int, what: str, ndim: int) -> None:
    if not isinstance(qt, QTensor):
        raise TypeError(f"{what} must be a QTensor, got {type(qt).__name__}")
    if not qt.packed:
        raise ValueError(f"{what} must be bit-packed")
    if qt.codes.ndim != ndim:
        raise ValueError(f"{what} codes must be {ndim}-D, got "
                         f"{tuple(qt.codes.shape)}")
    if qt.block != hd or qt.shape[-1] != hd:
        raise ValueError(f"{what} must be blocked over head_dim={hd}, got "
                         f"block={qt.block} shape={qt.shape}")


def _dense_check(q, kq: QTensor, vq: QTensor, tile) -> int:
    """Argument checks of the dense call (both routes); the plain tile
    (``tile`` or the table's, clamped to S)."""
    H, hd = q.shape[2], q.shape[3]
    _check_cache(kq, hd, "kq", 4)
    _check_cache(vq, hd, "vq", 4)
    S, K = kq.codes.shape[1], kq.codes.shape[2]
    if H % K:
        raise ValueError(f"n_heads {H} not a multiple of kv heads {K}")
    return max(1, min(_resolve_tile(q, kq, tile), S))


def _dense_args(q, kq: QTensor, vq: QTensor, kv_len, q_offset, tile):
    tile = _dense_check(q, kq, vq, tile)
    S, K = kq.codes.shape[1], kq.codes.shape[2]
    return (_fold_q(q, K), _make_lens(kv_len, q_offset, q.shape[0], S,
                                      q.device), tile)


def _paged_check(q, kq: QTensor, vq: QTensor, pages, tile):
    """Argument checks of the paged call (both routes): (the page table as
    contiguous int32 on q's device, the plain tile)."""
    B, H, hd = q.shape[0], q.shape[2], q.shape[3]
    _check_cache(kq, hd, "kq", 4)
    _check_cache(vq, hd, "vq", 4)
    T, K = kq.codes.shape[1], kq.codes.shape[2]
    if H % K:
        raise ValueError(f"n_heads {H} not a multiple of kv heads {K}")
    if not (isinstance(pages, torch.Tensor) and pages.dtype == torch.int32
            and pages.device == q.device):
        pages = torch.as_tensor(pages, dtype=torch.int32, device=q.device)
    if pages.ndim != 2 or pages.shape[0] != B:
        raise ValueError(f"pages must be [B={B}, max_pages], got "
                         f"{tuple(pages.shape)}")
    S = pages.shape[1] * T
    tile = max(1, min(_resolve_tile(q, kq, tile), S))
    if tile % T:
        raise ValueError(f"kv tile {tile} not a multiple of page_tokens {T}: "
                         "paged tiles must span whole pages")
    return pages.contiguous(), tile


def _paged_args(q, kq: QTensor, vq: QTensor, pages, kv_len, q_offset, tile):
    pages, tile = _paged_check(q, kq, vq, pages, tile)
    P, T, K = kq.codes.shape[:3]
    # garbage ids are clamped into the slab (their positions are masked)
    pages = torch.clamp(pages, 0, P - 1)
    return (_fold_q(q, K), pages,
            _make_lens(kv_len, q_offset, q.shape[0], pages.shape[1] * T,
                       q.device), tile)


@charged("attention_packed")
def attention_packed(q, kq: QTensor, vq: QTensor, *, kv_len=None,
                     causal: bool = False, q_offset=0, tile: int | None = None):
    """Fused attention straight off a dense packed cache.

    q ``[B, Sq, H, hd]`` (math in f32), kq/vq packed QTensors of logical
    shape ``[B, S, K, hd]`` with block = hd. ``kv_len`` masks positions
    >= kv_len; ``causal`` masks positions past ``q_offset + s``. Both take a
    scalar or a per-batch ``[B]`` vector. Returns ``[B, Sq, H, hd]`` in q's
    dtype. ``tile=None`` takes the tile table's entry for (the device
    type, the K format's n_bits). CUDA tensors launch the kernel with
    ``tile`` positions per CTA (f32 or bf16 q; a tile it cannot take
    raises), CPU tensors run :func:`attention_packed_plain`."""
    if q.device.type != "cuda":
        return attention_packed_plain(q, kq, vq, kv_len=kv_len,
                                      causal=causal, q_offset=q_offset,
                                      tile=tile)
    _dense_check(q, kq, vq, tile)
    return _attention_cuda(q, kq, vq, kv_len, q_offset, bool(causal),
                           _resolve_tile(q, kq, tile))


def attention_packed_plain(q, kq: QTensor, vq: QTensor, *, kv_len=None,
                           causal: bool = False, q_offset=0,
                           tile: int | None = None):
    """Plain PyTorch version of :func:`attention_packed` (any device)."""
    q3, lens, tile = _dense_args(q, kq, vq, kv_len, q_offset, tile)
    B, Sq, hd = q.shape[0], q.shape[1], q.shape[3]
    nt = -(-kq.codes.shape[1] // tile)
    kt = _to_tiles(_decode_rows(kq.codes, kq.scales, kq.fmt, hd), B, nt, tile)
    vt = _to_tiles(_decode_rows(vq.codes, vq.scales, vq.fmt, hd), B, nt, tile)
    o3 = _tile_loop(q3, lens, Sq, bool(causal), tile, nt,
                    lambda j: (kt(j), vt(j)))
    return _unfold_o(o3, Sq, q.dtype)


@charged("attention_paged")
def attention_paged(q, kq: QTensor, vq: QTensor, pages, *, kv_len=None,
                    causal: bool = False, q_offset=0, tile: int | None = None):
    """Fused attention THROUGH a page table — no dense KV row exists.

    kq/vq are packed pool slabs, codes ``[n_pages, page_tokens, K, words]``;
    ``pages`` ``[B, max_pages]`` int32 orders each row's pages (ids are
    clamped to the slab, positions >= kv_len contribute exactly 0.0). The
    tile must span whole pages. With the same tile the output is bitwise
    equal to :func:`attention_packed` over :func:`gather_pages_to_dense`
    (on the card for any tile, and for a page table cut to any span that
    covers kv_len). ``tile=None`` reads the tile table, as
    :func:`attention_packed` does. CUDA tensors launch the kernel, CPU
    tensors run :func:`attention_paged_plain`."""
    if q.device.type != "cuda":
        return attention_paged_plain(q, kq, vq, pages, kv_len=kv_len,
                                     causal=causal, q_offset=q_offset,
                                     tile=tile)
    pages, _ = _paged_check(q, kq, vq, pages, tile)
    return _attention_cuda(q, kq, vq, kv_len, q_offset, bool(causal),
                           _resolve_tile(q, kq, tile), pages)


def attention_paged_plain(q, kq: QTensor, vq: QTensor, pages, *,
                          kv_len=None, causal: bool = False, q_offset=0,
                          tile: int | None = None):
    """Plain PyTorch version of :func:`attention_paged` (any device): each
    tile gathers its pages from the slabs and decodes them."""
    q3, pages, lens, tile = _paged_args(q, kq, vq, pages, kv_len, q_offset,
                                        tile)
    B, Sq, hd = q.shape[0], q.shape[1], q.shape[3]
    K, T = kq.codes.shape[2], kq.codes.shape[1]
    ppt = tile // T
    maxp = pages.shape[1]
    nt = -(-maxp // ppt)
    if nt * ppt > maxp:   # padding pages sit past S >= kv_len: masked
        pages = torch.nn.functional.pad(pages, (0, nt * ppt - maxp))

    def gather(qt, pj):
        x = _decode_rows(_take_words(qt.codes, pj), qt.scales[pj], qt.fmt, hd)
        return x.reshape(B, tile, K, hd).permute(0, 2, 1, 3).contiguous()

    def tile_kv(j):
        pj = pages[:, j * ppt:(j + 1) * ppt].to(torch.int64)
        return gather(kq, pj), gather(vq, pj)

    o3 = _tile_loop(q3, lens, Sq, bool(causal), tile, nt, tile_kv)
    return _unfold_o(o3, Sq, q.dtype)


def gather_pages_to_dense(qt: QTensor, pages) -> QTensor:
    """Slab ``[P, T, K, *]`` + ``pages [B, maxp]`` -> dense
    ``[B, maxp*T, K, hd]`` QTensor: a pure word/scale gather, bit-exact."""
    pages = torch.as_tensor(pages, dtype=torch.int64, device=qt.codes.device)
    codes = _take_words(qt.codes, pages)          # [B, maxp, T, K, W]
    scales = qt.scales[pages]
    B, mp, T = codes.shape[:3]
    return QTensor.from_parts(
        codes.reshape((B, mp * T) + tuple(codes.shape[3:])),
        scales.reshape((B, mp * T) + tuple(scales.shape[3:])),
        qt.fmt, qt.block, (B, mp * T) + tuple(qt.shape[-2:]), packed=True)


def attention_paged_reference(q, kq: QTensor, vq: QTensor, pages, *,
                              kv_len=None, causal: bool = False, q_offset=0,
                              tile: int | None = None):
    """The copy-in path the paged kernel replaces: gather the page table
    into a dense row, then :func:`attention_packed` on it."""
    return attention_packed(q, gather_pages_to_dense(kq, pages),
                            gather_pages_to_dense(vq, pages), kv_len=kv_len,
                            causal=causal, q_offset=q_offset, tile=tile)


def attention_reference(q, k, v, *, kv_len=None, causal: bool = False,
                        q_offset=0, tile: int = DEFAULT_TILE):
    """Dense-KV online-softmax reference: the same tile loop on already
    dequantized ``[B, S, K, hd]`` k/v (plain PyTorch on any device)."""
    B, Sq, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    tile = max(1, min(int(tile), S))
    nt = -(-S // tile)
    lens = _make_lens(kv_len, q_offset, B, S, q.device)
    kt = _to_tiles(k.to(torch.float32), B, nt, tile)
    vt = _to_tiles(v.to(torch.float32), B, nt, tile)
    o3 = _tile_loop(_fold_q(q, K), lens, Sq, bool(causal), tile, nt,
                    lambda j: (kt(j), vt(j)))
    return _unfold_o(o3, Sq, q.dtype)


def attention_packed_reference(q, kq: QTensor, vq: QTensor, *, kv_len=None,
                               causal: bool = False, q_offset=0,
                               tile: int = DEFAULT_TILE):
    """The unfused path the kernel replaces: dequantize the whole cache,
    then attend with :func:`attention_reference`."""
    return attention_reference(q, kq.dequantize(torch.float32),
                               vq.dequantize(torch.float32), kv_len=kv_len,
                               causal=causal, q_offset=q_offset, tile=tile)


def autotune_attention_tile(backend: str, n_bits: int, *,
                            candidates=(64, 128, 256, 512),
                            shape=(2, 2048, 4, 128), reps: int = 3,
                            fmt: F2PFormat | None = None) -> int:
    """Time :func:`attention_packed` over candidate kv-tile lengths on a
    decode-shaped problem ``(B, S, K, hd)`` and install the winner in the
    tile table; returns it. ``backend`` is the device that runs the calls:
    ``"cuda"`` (the kernel; a tile it cannot take is skipped) or ``"cpu"``
    (the plain version). A tile longer than S is skipped, as in the
    reference."""
    import time

    if backend not in _BACKENDS:
        raise ValueError(f"backend is the device type, one of {_BACKENDS}, "
                         f"got {backend!r}")
    if fmt is None:
        fmt = F2PFormat(n_bits, 2, Flavor.SR, signed=True)
    B, S, K, hd = shape
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(backend)

    q = put(rng.normal(size=(B, 1, 2 * K, hd)))
    kd = put(rng.normal(size=(B, S, K, hd)))
    vd = put(rng.normal(size=(B, S, K, hd)))
    kq = QT.quantize(kd, fmt, block=hd, packed=True)
    vq = QT.quantize(vd, fmt, block=hd, packed=True)
    sync = torch.cuda.synchronize if backend == "cuda" else (lambda: None)
    best, best_t = None, DEFAULT_TILE
    for t in candidates:
        if t > S:
            continue
        if backend == "cuda" and not kernel_takes_tile(t):
            continue

        def run():
            return attention_packed(q, kq, vq, kv_len=S - 1, tile=t)

        run()       # the build and first use outside the clock
        sync()
        t0 = time.perf_counter()
        for _ in range(max(1, reps)):
            run()
        sync()
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best, best_t = dt, t
    set_attention_tile(backend, n_bits, best_t)
    return best_t
