"""Min-max quantization exactly as the paper's Sec. III-B, plus a float64
numpy TEST ORACLE for the blockwise quantizer (port of
``repro.core.quantize``, copied: numpy only).

Paper definition: given vector V and target format F,

    s   = (max V - min V) / (F_max - F_min)
    V^F = s * round_to_nearest_F(V / s)

``block_quantize`` / ``block_dequantize`` below are the exact-f64 host
oracle for the runtime codec, which lives in :mod:`repro_torch.core.qtensor`
(QTensor; scale chosen so each block's absmax maps onto the format's max
value — the thing the CUDA kernels B3/B5 implement on the card). The oracle
keeps an independent f64 code path on purpose: tests compare the f32
kernel math against it rather than against itself. Runtime code must NOT
call it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["minmax_quantize", "quantization_mse", "BlockQuantized",
           "block_quantize", "block_dequantize"]


def minmax_quantize(v: np.ndarray, fmt: Any) -> np.ndarray:
    """Paper Sec. III-B min-max quantization of v onto format ``fmt``."""
    v = np.asarray(v, dtype=np.float64)
    fmax, fmin = fmt.max_value, fmt.min_value
    span_v = float(v.max() - v.min())
    span_f = float(fmax - fmin)
    if span_v == 0.0:
        return np.full_like(v, v.flat[0])
    s = span_v / span_f
    return s * fmt.quantize_value(v / s)


def quantization_mse(v: np.ndarray, fmt: Any) -> float:
    """MSE of the paper's quantization error err_i = |v_i - v_i^F|."""
    q = minmax_quantize(v, fmt)
    return float(np.mean((q - np.asarray(v, dtype=np.float64)) ** 2))


# ---------------------------------------------------------------------------
# Block-scaled quantization (runtime representation; host reference).
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BlockQuantized:
    """F2P codes + per-block scales. Last axis is blocked."""

    codes: np.ndarray      # uint, same shape as data
    scales: np.ndarray     # float32, shape data.shape[:-1] + (nblocks,)
    block: int
    fmt: Any


def block_quantize(x: np.ndarray, fmt: Any, block: int = 128) -> BlockQuantized:
    x = np.asarray(x, dtype=np.float64)
    if x.shape[-1] % block:
        raise ValueError(f"last dim {x.shape[-1]} not divisible by block {block}")
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // block, block)
    absmax = np.abs(xb).max(axis=-1, keepdims=True)
    scale = np.where(absmax > 0, absmax / fmt.max_value, 1.0)
    codes = fmt.encode_nearest(xb / scale)
    return BlockQuantized(codes=codes.reshape(x.shape),
                          scales=scale[..., 0].astype(np.float32),
                          block=block, fmt=fmt)


def block_dequantize(q: BlockQuantized) -> np.ndarray:
    shape = q.codes.shape
    cb = q.codes.reshape(*shape[:-1], shape[-1] // q.block, q.block)
    vals = q.fmt.decode(cb)
    return (vals * q.scales[..., None].astype(np.float64)).reshape(shape)
