"""Public F2P tensor ops (port of ``repro.kernels.ops``): the library
boundary over the canonical QTensor codec of :mod:`repro_torch.core.qtensor`.

``f2p_quantize`` / ``f2p_dequantize`` accept tensors of any rank (the last
axis is the blocked one) and pad to block boundaries. As in the reference
they default to the unpacked layout (uint8 / uint16 codes), which runs B5 /
B6 on a CUDA tensor and the plain versions on a CPU tensor. The JAX
module's ``backend=`` / ``use_pallas=`` switches have no counterpart: the
tensor's device decides.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import qtensor as QT
from repro_torch.core.f2p import F2PFormat
from repro_torch.core.qtensor import QTensor, dequantize_tree, quantize_tree

__all__ = ["f2p_quantize", "f2p_dequantize", "QTensor", "quantize_tree",
           "dequantize_tree"]


def f2p_quantize(x: torch.Tensor, fmt: F2PFormat, *, block: int = 128,
                 scale_mode: str = "f32", packed: bool = False) -> QTensor:
    """Block-quantize an any-rank tensor along its last axis."""
    return QT.quantize(x, fmt, block=block, scale_mode=scale_mode,
                       packed=packed)


def f2p_dequantize(codes: torch.Tensor, scales: torch.Tensor, fmt: F2PFormat,
                   *, block: int = 128, out_dtype=torch.float32,
                   out_shape=None, packed: bool = False) -> torch.Tensor:
    """Decode raw codes + scales leaves. ``out_shape`` is the logical shape
    (default: the codes' shape, valid when the last dim needed no pad).
    Codes in a collapsed 2-D layout (leading dims merged, extra rows) are
    cut back to ``out_shape``'s leading dims first, as the reference."""
    shape = tuple(out_shape) if out_shape is not None else tuple(codes.shape)
    if tuple(codes.shape[:-1]) != shape[:-1]:
        lead = math.prod(shape[:-1]) if shape[:-1] else 1
        codes = codes.reshape(-1, codes.shape[-1])[:lead] \
            .reshape(*shape[:-1], codes.shape[-1])
        scales = scales.reshape(-1, scales.shape[-1])[:lead] \
            .reshape(*shape[:-1], scales.shape[-1])
    qt = QTensor.from_parts(codes, scales, fmt, block, shape, packed=packed)
    return QT.dequantize(qt, dtype=out_dtype)
