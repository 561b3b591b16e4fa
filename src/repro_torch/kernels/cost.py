"""What each hand-written kernel costs, and what it returns.

One entry per wrapper that counts its launches in ``cuda.LAUNCHES`` (B1-B10
and their modes), keyed by that count's name:

- ``nbytes(a)``: the bytes its bound counts, each input read once and each
  output written once. In-place writers (B3's KV write) are charged the
  rows they write, never the whole cache; readers of a length-masked cache
  (B1, B2) the rows below each row's ``kv_len``. ``chip_smoke.py``'s bound
  columns and the op analysis (``launch.op_analysis``) read this one count.
- ``flops(a)``: floating-point operations, as ``torch.utils.flop_counter``
  counts the kernel's plain version: the QK and PV products for B1/B2
  (over the plain version's padded tiles), ``2 M N K`` for B7/B8, 0 for
  the codecs and counters.
- ``fake(a)``: the results' shapes and dtypes with no data (``torch.empty``
  in the current mode), or None for the in-place writers.

``a`` is the wrapper's bound arguments (``inspect.BoundArguments
.arguments``, defaults applied). :func:`charged` puts a wrapper under the
op analysis: with no analysis running it is one flag check and a call. An
analysis counts the thread it runs on only (its dispatch mode is
thread-local): a wrapper called from another thread meanwhile runs as it
is and is not charged.
"""
from __future__ import annotations

import functools
import inspect
import math
import threading

import torch

# the running op analysis (launch.op_analysis.OpAnalysis) or None; its
# ``thread`` is the ident of the thread it counts
ACTIVE = None

_SIGNATURES: dict = {}


def charged(name: str):
    """Decorate the wrapper that counts ``LAUNCHES[name]``: under a running
    op analysis its call is charged :data:`COSTS` ``[name]`` (and nothing
    inside it is); otherwise the wrapper runs as it is."""
    def deco(fn):
        _SIGNATURES[name] = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            a = ACTIVE
            if a is None or a.thread != threading.get_ident():
                return fn(*args, **kwargs)
            return a.kernel(name, fn, args, kwargs)

        return wrapper

    return deco


def bind(name: str, args, kwargs) -> dict:
    """The arguments of wrapper ``name`` by parameter name, defaults
    applied."""
    _load()
    b = _SIGNATURES[name].bind(*args, **kwargs)
    b.apply_defaults()
    return b.arguments


def nbytes(name: str, *args, **kwargs) -> int:
    """Bytes kernel ``name`` moves when its wrapper is called so."""
    return int(COSTS[name].nbytes(bind(name, args, kwargs)))


def flops(name: str, *args, **kwargs) -> int:
    """Floating-point operations of kernel ``name`` called so."""
    return int(COSTS[name].flops(bind(name, args, kwargs)))


def _load() -> None:
    # the wrappers register their signatures when their modules load
    from repro_torch.kernels import (f2p_attention, f2p_counter,  # noqa: F401
                                     f2p_matmul, f2p_quant)


def _nb(t) -> int:
    return t.numel() * t.element_size()


def _empty(shape, dtype, like):
    return torch.empty(tuple(shape), dtype=dtype, device=like.device)


# ---------------------------------------------------------------------------
# B3 / B4: the packed codec
# ---------------------------------------------------------------------------
def _words(c: int, n_bits: int) -> int:
    return -(-c * n_bits // 32)


def _quantize_packed_bytes(a):
    x, fmt, block = a["x2"], a["fmt"], a["block"]
    r, c = x.shape
    return _nb(x) + r * _words(c, fmt.n_bits) * 4 + r * (c // block) * 4


def _quantize_packed_fake(a):
    x, fmt, block = a["x2"], a["fmt"], a["block"]
    r, c = x.shape
    return (_empty((r, _words(c, fmt.n_bits)), torch.uint32, x),
            _empty((r, c // block), torch.float32, x))


def _kv_write_bytes(a):
    """K and V read once, the rows they fill written (words and a scale per
    row of each side), one start position per slot and, paged, one page
    id per slot read."""
    k, cache, pages = a["k"], a["cache"], a["pages"]
    B, S, K, _ = k.shape
    total = 0
    for name in ("k", "v"):
        W = cache[name].codes.shape[-1]
        total += _nb(a[name]) + B * S * K * (4 * W + 4)
    return total + 8 * B + (4 * B if pages is not None else 0)


def _dequantize_packed_bytes(a):
    words, scales, block = a["words"], a["scales"], a["block"]
    r, nblk = scales.shape
    return _nb(words) + _nb(scales) + r * nblk * block * \
        a["out_dtype"].itemsize


def _dequantize_packed_fake(a):
    scales, block = a["scales"], a["block"]
    r, nblk = scales.shape
    return _empty((r, nblk * block), a["out_dtype"], a["words"])


def _kv_out_dtype(dtype):
    return dtype if dtype in (torch.float32, torch.bfloat16) else \
        torch.float32


def _kv_read_bytes(a):
    cache = a["cache"]
    esize = _kv_out_dtype(a["dtype"]).itemsize
    total = 0
    for name in ("k", "v"):
        c = cache[name]
        total += _nb(c.codes) + _nb(c.scales) + math.prod(
            c.codes.shape[:-1]) * c.shape[-1] * esize
    return total


def _kv_read_fake(a):
    cache, dtype = a["cache"], a["dtype"]
    out = []
    for name in ("k", "v"):
        c = cache[name]
        out.append(_empty((*c.codes.shape[:-1], c.shape[-1]), dtype,
                          c.codes))
    return tuple(out)


# ---------------------------------------------------------------------------
# B5 / B6: the unpacked codec and the gradient round trip
# ---------------------------------------------------------------------------
def _code_dtype(fmt):
    return torch.uint8 if fmt.n_bits <= 8 else torch.uint16


def _quantize_bytes(a):
    x, fmt, block = a["x2"], a["fmt"], a["block"]
    r, c = x.shape
    return _nb(x) + r * c * _code_dtype(fmt).itemsize + r * (c // block) * 4


def _quantize_fake(a):
    x, fmt, block = a["x2"], a["fmt"], a["block"]
    r, c = x.shape
    return (_empty((r, c), _code_dtype(fmt), x),
            _empty((r, c // block), torch.float32, x))


def _ef_roundtrip_bytes(a):
    """Each gradient read and written; with error feedback each f32
    residual read and written too."""
    ef = a["error_feedback"]
    total = 0
    for g, r in zip(a["gs"], a["rs"]):
        total += 2 * _nb(g) + (2 * _nb(r) if ef and r is not None else 0)
    return total


def _dequantize_bytes(a):
    codes, scales = a["codes"], a["scales"]
    return _nb(codes) + _nb(scales) + codes.numel() * a["out_dtype"].itemsize


def _dequantize_fake(a):
    return _empty(a["codes"].shape, a["out_dtype"], a["codes"])


# ---------------------------------------------------------------------------
# B1 / B2: attention off the packed cache
# ---------------------------------------------------------------------------
def _live_lens(kv_len, B: int, S: int) -> list[int]:
    """Positions each row reads: its kv_len (None: all S), capped at S,
    whatever the causal mask. A tensor without data (a fake tensor) counts
    all S."""
    if kv_len is None or (isinstance(kv_len, torch.Tensor)
                          and _no_data(kv_len)):
        lens = [S]
    elif isinstance(kv_len, torch.Tensor):
        lens = kv_len.reshape(-1).tolist()
    else:
        lens = [kv_len]
    lens = [min(int(n), S) for n in lens]
    return lens * B if len(lens) == 1 else lens


def _no_data(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake

    return t.device.type == "meta" or is_fake(t)


def _attention_bytes(a, paged: bool):
    """q in and out, and every live row's K and V words and scales (a
    scale per row and side), the lengths and, paged, each row's live page
    ids."""
    q, kq, vq = a["q"], a["kq"], a["vq"]
    B = q.shape[0]
    K = kq.codes.shape[2]
    row = (kq.codes.shape[-1] + vq.codes.shape[-1]) * 4 + 8
    T = kq.codes.shape[1]       # positions a page holds, or the cache's
    S = a["pages"].shape[1] * T if paged else T
    lens = _live_lens(a["kv_len"], B, S)
    total = sum(lens) * K * row + 2 * _nb(q) + B * 8
    if paged:
        total += 4 * sum(-(-n // T) for n in lens)
    return total


def _attention_flops(a, paged: bool):
    """The plain version's two batched products per kv tile, QK^T and PV,
    over every tile of the padded span."""
    from repro_torch.kernels.f2p_attention import _resolve_tile

    q, kq = a["q"], a["kq"]
    B, Sq, H, hd = q.shape
    S = a["pages"].shape[1] * kq.codes.shape[1] if paged else \
        kq.codes.shape[1]
    tile = max(1, min(_resolve_tile(q, kq, a["tile"]), S))
    if paged:
        T = kq.codes.shape[1]
        ppt = tile // T
        span = -(-a["pages"].shape[1] // ppt) * ppt * T
    else:
        span = -(-S // tile) * tile
    return 4 * B * H * Sq * hd * span


def _attention_fake(a):
    q = a["q"]
    return _empty(q.shape, q.dtype, q)


# ---------------------------------------------------------------------------
# B7 / B8: the dequant matmul
# ---------------------------------------------------------------------------
def _matmul_bytes(a, packed: bool):
    x, scales = a["x"], a["scales"]
    w = a["words"] if packed else a["codes"]
    M, N = x.shape[0], scales.shape[-1]
    return _nb(w) + _nb(scales) + _nb(x) + M * N * 4


def _matmul_flops(a):
    x, scales = a["x"], a["scales"]
    return 2 * x.shape[0] * x.shape[1] * scales.shape[-1]


def _matmul_fake(a):
    x = a["x"]
    return _empty((x.shape[0], a["scales"].shape[-1]), torch.float32, x)


# ---------------------------------------------------------------------------
# B9 / B10: the counters
# ---------------------------------------------------------------------------
def _advance_bytes(a):
    """State and budget read, state and leftover written (4 bytes each a
    cell); the tables stay in cache."""
    return 16 * a["state"].numel()


def _advance_fake(a):
    st, b = a["state"], a["budget"]
    return _empty(st.shape, st.dtype, st), _empty(b.shape, b.dtype, b)


def _estimate_bytes(a):
    return 8 * a["state"].numel()


def _estimate_fake(a):
    st = a["state"]
    return _empty(st.shape, torch.float32, st)


class Cost:
    def __init__(self, nbytes, fake, flops=None):
        self.nbytes, self.fake = nbytes, fake
        self.flops = flops or (lambda a: 0)


COSTS = {
    "quantize_packed": Cost(_quantize_packed_bytes, _quantize_packed_fake),
    "kv_write": Cost(_kv_write_bytes, lambda a: None),
    "dequantize_packed": Cost(_dequantize_packed_bytes,
                              _dequantize_packed_fake),
    "kv_read": Cost(_kv_read_bytes, _kv_read_fake),
    "quantize": Cost(_quantize_bytes, _quantize_fake),
    "ef_roundtrip": Cost(_ef_roundtrip_bytes, lambda a: None),
    "dequantize": Cost(_dequantize_bytes, _dequantize_fake),
    "attention_packed": Cost(functools.partial(_attention_bytes, paged=False),
                             _attention_fake,
                             functools.partial(_attention_flops,
                                               paged=False)),
    "attention_paged": Cost(functools.partial(_attention_bytes, paged=True),
                            _attention_fake,
                            functools.partial(_attention_flops, paged=True)),
    "dequant_matmul": Cost(functools.partial(_matmul_bytes, packed=False),
                           _matmul_fake, _matmul_flops),
    "dequant_matmul_packed": Cost(functools.partial(_matmul_bytes,
                                                    packed=True),
                                  _matmul_fake, _matmul_flops),
    "counter_advance": Cost(_advance_bytes, _advance_fake),
    "counter_estimate": Cost(_estimate_bytes, _estimate_fake),
}
