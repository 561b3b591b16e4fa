"""Shared uint32 bit primitives: murmur3 finalizer + n-bit field packing.

Torch + numpy twins of ``repro.kernels.bits``. The layout is the reference's
(DESIGN.md §9): dense little-endian packing of ``n_bits``-wide code fields
into uint32 words along the LAST axis. Element ``i`` of a row occupies bits
``[i*n_bits, (i+1)*n_bits)`` of that row's bit stream; stream bit ``b``
lives at bit ``b % 32`` of word ``b // 32``; within a field the LSB comes
first. Rows never share words — each last-axis row packs into its own
``packed_words(n, n_bits)`` words (trailing slack bits are zero).

Torch traps (ROADMAP A3): on the CPU ``>>``/``<<`` and ``index_put_`` are
not implemented for ``torch.uint32``, and ``int32 >>`` sign-extends. So all
bit arithmetic here runs in int64 (a uint32 value fits with room to spare),
words are stored as ``torch.uint32``, and in-place word writes go through
the zero-cost ``.view(torch.int32)`` bit reinterpretation. Codes come back
from :func:`unpack_bits` as int64. Conversions go through the int32 view
too, so the same code runs on CUDA tensors, where uint32 support is as thin.

``fmix32`` is the murmur3 finalizer (same constants as the reference): the
port's counter-based hash for temperature sampling.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["fmix32", "fmix32_np", "packed_words", "packed_nbytes",
           "pack_bits", "unpack_bits", "pack_bits_np", "unpack_bits_np"]

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): split c in 16-bit halves
    so no partial product leaves the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values carried in an int64 tensor."""
    x = x.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def fmix32_np(x: np.ndarray) -> np.ndarray:
    """Bit-identical numpy twin of :func:`fmix32` on uint32 arrays."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def packed_words(n_elems: int, n_bits: int) -> int:
    """uint32 words holding ``n_elems`` dense little-endian n-bit fields."""
    return -(-(int(n_elems) * int(n_bits)) // 32)


def packed_nbytes(n_elems: int, n_bits: int) -> int:
    """Bytes of one packed row — the canonical packed-size formula."""
    return 4 * packed_words(n_elems, n_bits)


def _check_n_bits(n_bits: int) -> int:
    n_bits = int(n_bits)
    if not 1 <= n_bits <= 32:
        raise ValueError(f"n_bits must be in [1, 32], got {n_bits}")
    return n_bits


def _mask32(n_bits: int) -> int:
    return (1 << n_bits) - 1 if n_bits < 32 else _M32


def words_i64(words: torch.Tensor) -> torch.Tensor:
    """uint32 words as int64 values in [0, 2^32), through the int32 view
    (torch implements few ops on uint32, on either device)."""
    return words.view(torch.int32).to(torch.int64) & _M32


def _field_offsets(count: int, n_bits: int, device):
    o = torch.arange(count, dtype=torch.int64, device=device) * n_bits
    return o >> 5, o & 31


def pack_bits(codes: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Pack ``[..., n]`` unsigned codes (< 2^n_bits) into ``[..., W]``
    uint32 words, little-endian dense along the last axis. Fields never
    overlap, so the OR of the shifted fields is an integer sum
    (``index_add_``) of their low and straddling high parts."""
    n_bits = _check_n_bits(n_bits)
    c = codes.to(torch.int64) & _mask32(n_bits)
    n = c.shape[-1]
    W = packed_words(n, n_bits)
    w0, s = _field_offsets(n, n_bits, c.device)
    words = torch.zeros(c.shape[:-1] + (W + 1,), dtype=torch.int64,
                        device=c.device)
    words.index_add_(-1, w0, (c << s) & _M32)
    # high part of a field that straddles into the next word; zero for a
    # field that fits (c < 2^n_bits <= 2^(32-s)), so no mask is needed
    words.index_add_(-1, w0 + 1, c >> (32 - s))
    return words[..., :W].to(torch.int32).view(torch.uint32)


def unpack_bits(words: torch.Tensor, n_bits: int,
                count: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``[..., W]`` uint32 words -> ``[...,
    count]`` int64 codes."""
    n_bits = _check_n_bits(n_bits)
    count = int(count)
    W = words.shape[-1]
    if W < packed_words(count, n_bits):
        raise ValueError(
            f"{W} words cannot hold {count} fields of {n_bits} bits")
    w = words_i64(words)
    w0, s = _field_offsets(count, n_bits, w.device)
    lo = w.index_select(-1, w0) >> s
    hi = (w.index_select(-1, torch.clamp(w0 + 1, max=W - 1))
          << (32 - s)) & _M32
    return (lo | hi) & _mask32(n_bits)


def pack_bits_np(codes: np.ndarray, n_bits: int) -> np.ndarray:
    """numpy twin of :func:`pack_bits` (host paths: the empty-cache row)."""
    n_bits = _check_n_bits(n_bits)
    c = np.asarray(codes).astype(np.uint32) & np.uint32(_mask32(n_bits))
    n = c.shape[-1]
    lead = c.shape[:-1]
    W = packed_words(n, n_bits)
    if 32 % n_bits == 0:
        per = 32 // n_bits
        pad = W * per - n
        if pad:
            c = np.pad(c, [(0, 0)] * (c.ndim - 1) + [(0, pad)])
        cw = c.reshape(*lead, W, per)
        shifts = (np.arange(per, dtype=np.uint32) * np.uint32(n_bits))
        return np.bitwise_or.reduce(cw << shifts, axis=-1).astype(np.uint32)
    bits = (c[..., None] >> np.arange(n_bits, dtype=np.uint32)) & np.uint32(1)
    flat = bits.reshape(*lead, n * n_bits)
    pad = W * 32 - n * n_bits
    if pad:
        flat = np.pad(flat, [(0, 0)] * (flat.ndim - 1) + [(0, pad)])
    w = flat.reshape(*lead, W, 32)
    return np.bitwise_or.reduce(
        w << np.arange(32, dtype=np.uint32), axis=-1).astype(np.uint32)


def unpack_bits_np(words: np.ndarray, n_bits: int, count: int) -> np.ndarray:
    """numpy twin of :func:`unpack_bits` (uint32 codes)."""
    n_bits = _check_n_bits(n_bits)
    count = int(count)
    w = np.asarray(words).astype(np.uint32)
    lead = w.shape[:-1]
    W = w.shape[-1]
    if W < packed_words(count, n_bits):
        raise ValueError(
            f"{W} words cannot hold {count} fields of {n_bits} bits")
    mask = np.uint32(_mask32(n_bits))
    if 32 % n_bits == 0:
        per = 32 // n_bits
        shifts = (np.arange(per, dtype=np.uint32) * np.uint32(n_bits))
        c = (w[..., None] >> shifts) & mask
        return c.reshape(*lead, W * per)[..., :count]
    bits = (w[..., None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    flat = bits.reshape(*lead, W * 32)[..., :count * n_bits]
    b = flat.reshape(*lead, count, n_bits)
    acc = np.zeros(b.shape[:-1], np.uint32)
    for j in range(n_bits):
        acc |= b[..., j] << np.uint32(j)
    return acc

