"""Row hashing for the sketch engine (DESIGN.md §6.2).

Port of ``repro.sketch.hashing``. Each sketch row d owns an independent hash
``h_d : key -> [0, width)``: a multiply-add in uint32 (wrap-around is the
mod-2^32 reduction), the murmur3 finalizer, then a modulo reduction to the
row width. Keys are reduced to their low 32 bits first (``astype(uint32)``
in the reference), so int64 keys that are negative or >= 2^32 hash as
their two's-complement low word.

torch has little uint32 arithmetic, so :func:`hash_rows` carries uint32
values in int64 tensors and wraps products through the port's ``_mul32``
(``kernels.bits``); the numpy twin is the reference's, copied.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.bits import _mul32, fmix32, fmix32_np

__all__ = ["make_hash_params", "hash_rows", "hash_rows_np", "fold_u64"]

_M32 = 0xFFFFFFFF


def make_hash_params(depth: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (a, b) multiply-add constants, a forced odd (invertible mod
    2^32 — keeps the pre-mix a bijection). The reference's numpy draw: the
    same seed gives the same constants."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 1 << 32, size=depth, dtype=np.uint32) | np.uint32(1)
    b = rng.integers(0, 1 << 32, size=depth, dtype=np.uint32)
    return a, b


def _u32(x, device=None) -> torch.Tensor:
    """Low 32 bits of integer ``x`` (numpy, tensor or list) as int64."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x).astype(np.int64))
    return torch.as_tensor(x, device=device).to(torch.int64) & _M32


def fold_u64(hi, lo) -> torch.Tensor:
    """Fold a (hi, lo) uint32 pair — e.g. a 5-tuple flow id pre-hashed on the
    host — into one uint32 key (carried in int64) without losing either
    half's entropy."""
    hi, lo = _u32(hi), _u32(lo)
    return fmix32(_mul32(hi, 0x9E3779B1) ^ lo.to(hi.device))


def hash_rows(keys: torch.Tensor, a, b, width: int) -> torch.Tensor:
    """(batch,) integer keys -> (depth, batch) int32 column indices, on the
    keys' device."""
    k = _u32(keys)
    a = _u32(a, k.device)[:, None]
    b = _u32(b, k.device)[:, None]
    mixed = fmix32((_mul32(k[None, :], a) + b) & _M32)
    return (mixed % int(width)).to(torch.int32)


def hash_rows_np(keys: np.ndarray, a: np.ndarray, b: np.ndarray,
                 width: int) -> np.ndarray:
    """Bit-identical numpy twin of :func:`hash_rows` — the host aggregation
    path must land arrivals in exactly the cells ``query`` reads back."""
    k = np.asarray(keys).astype(np.uint32)
    mixed = fmix32_np(a[:, None] * k[None, :] + b[:, None])
    return (mixed % np.uint32(width)).astype(np.int32)
