"""QTensor: the F2P block-quantized tensor, packed layout (DESIGN.md §7, §9).

Port of ``repro.core.qtensor`` for the packed codec. ``QTensor`` is a plain
dataclass (there is no pytree to register): ``codes`` holds little-endian
uint32 words — each last-axis row of ``npad`` codes packs into
``packed_words(npad, n_bits)`` words, rows never share words — ``scales``
the per-block f32 scales, plus the format, block size, logical shape and
the ``packed`` flag.

Only the LAST axis is blocked. ``codes`` has the logical leading shape with
the last dim replaced by the word count; ``scales`` replaces it with the
block count. JAX's functional ``dynamic_update`` becomes an in-place write
into the destination's storage here (the KV cache and the pool slabs are
updated where they live, the torch counterpart of buffer donation).

The unpacked (byte-aligned codes) codec is not ported yet (ROADMAP B5/B6):
``packed=False`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.f2p import F2PFormat
from repro_torch.kernels.bits import packed_nbytes, packed_words

__all__ = ["QTensor", "quantize", "dequantize", "block_scales",
           "pow2_round_up"]


def pow2_round_up(scale: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= ``scale``, bit-exact in f32: a nonzero
    mantissa bumps the exponent, subnormals flush up to 2^-126, the top
    caps at 2^127 (int64 bit arithmetic: torch has no uint32 shifts)."""
    bits = scale.to(torch.float32).view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    exp = (bits >> 23) & 0xFF
    mant = bits & 0x7FFFFF
    e = torch.where(mant > 0, exp + 1, exp)
    e = torch.clamp(e, 1, 254)
    return (e << 23).to(torch.int32).view(torch.float32)


def block_scales(xb: torch.Tensor, fmt: F2PFormat, scale_mode: str = "f32"):
    """Per-block scales from ``[..., nblocks, block]`` f32 data: absmax
    MULTIPLIED by the constant f32(1/max_value) (as the reference does, so
    every producer agrees bitwise); all-zero blocks get scale 1."""
    absmax = xb.abs().amax(dim=-1)
    # an f32-representable Python float: torch multiplies f32 by it in f32
    scale = absmax * float(np.float32(1.0 / fmt.max_value))
    if scale_mode == "pow2":
        scale = pow2_round_up(torch.where(scale > 0, scale, 1.0))
    return torch.where(absmax > 0, scale, 1.0).to(torch.float32)


def _unported() -> NotImplementedError:
    return NotImplementedError(
        "the unpacked F2P codec is not ported yet (ROADMAP B5/B6); use "
        "packed=True")


@dataclasses.dataclass
class QTensor:
    """An F2P block-quantized tensor: packed code words + per-block scales.

    ``shape`` is the LOGICAL shape (before last-axis padding)."""
    codes: torch.Tensor
    scales: torch.Tensor
    fmt: F2PFormat
    block: int
    shape: tuple
    packed: bool = True

    @classmethod
    def from_parts(cls, codes, scales, fmt: F2PFormat, block: int, shape,
                   packed: bool = True) -> "QTensor":
        """Zero-copy reassembly with the reference's shape validation: the
        codes carry exactly ``packed_words(npad, n_bits)`` uint32 words per
        row and the scales cover the padded row."""
        shape = tuple(int(s) for s in shape)
        block = int(block)
        if not packed:
            raise _unported()
        npad = -(-shape[-1] // block) * block
        nw = packed_words(npad, fmt.n_bits)
        if codes.shape[-1] != nw:
            raise ValueError(
                f"packed codes last dim {codes.shape[-1]} != {nw} uint32 "
                f"words for {npad} {fmt.n_bits}-bit fields (shape {shape}, "
                f"block {block})")
        if codes.dtype != torch.uint32:
            raise ValueError(
                f"packed codes must be uint32 words, got {codes.dtype}")
        if scales.shape[-1] * block != npad:
            raise ValueError(
                f"scales last dim {scales.shape[-1]} does not cover {npad} "
                f"padded elements at block {block}")
        if codes.shape[:-1] != scales.shape[:-1]:
            raise ValueError(f"codes/scales leading dims disagree: "
                             f"{tuple(codes.shape)} vs {tuple(scales.shape)}")
        return cls(codes, scales, fmt, block, shape, True)

    @property
    def npad(self) -> int:
        """Logical last dim padded up to the block multiple."""
        return -(-self.shape[-1] // self.block) * self.block

    @property
    def logical_shape(self) -> tuple:
        return tuple(self.codes.shape[:-1]) + (self.shape[-1],)

    @property
    def nbytes(self) -> int:
        """Packed footprint: word-granular code bytes plus f32 scales."""
        rows = self.codes.numel() // max(1, self.codes.shape[-1])
        return (rows * packed_nbytes(self.npad, self.fmt.n_bits)
                + self.scales.numel() * self.scales.element_size())

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype=dtype)

    def dynamic_update(self, other: "QTensor", start: int,
                       axis: int) -> "QTensor":
        """Write ``other`` into this tensor's storage at ``start`` along a
        leading ``axis``, codes and scales together, IN PLACE (rows own
        whole words, so the slab write is an exact word copy). Returns
        ``self``."""
        if (other.fmt, other.block, other.packed) != (self.fmt, self.block,
                                                      self.packed):
            raise ValueError(
                f"format mismatch: {other.fmt}/{other.block} into "
                f"{self.fmt}/{self.block}")
        ax = axis % self.codes.ndim
        if ax == self.codes.ndim - 1:
            raise ValueError("cannot dynamic_update along the blocked axis")
        n = other.codes.shape[ax]
        self.codes.view(torch.int32).narrow(ax, int(start), n).copy_(
            other.codes.view(torch.int32))
        self.scales.narrow(ax, int(start), n).copy_(other.scales)
        return self


def _pad_last(x: torch.Tensor, block: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % block
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def quantize(x: torch.Tensor, fmt: F2PFormat, *, block: int = 128,
             scale_mode: str = "f32", packed: bool = True) -> QTensor:
    """Blockwise absmax-scaled packed F2P quantization of any-rank ``x``
    along its last axis. CPU tensors run the plain version, CUDA tensors
    the ``quantize_packed`` kernel; both are bitwise equal to the JAX
    ``QT.quantize(..., packed=True)``."""
    from repro_torch.kernels.f2p_quant import f2p_quantize_packed

    if not packed:
        raise _unported()
    shape = tuple(x.shape)
    xp = _pad_last(x, block)
    if xp.dtype not in (torch.float32, torch.bfloat16):
        xp = xp.to(torch.float32)
    x2 = xp.reshape(-1, xp.shape[-1]).contiguous()
    words, scales = f2p_quantize_packed(x2, fmt, block=block,
                                        scale_mode=scale_mode)
    return QTensor(words.reshape(*shape[:-1], words.shape[-1]),
                   scales.reshape(*shape[:-1], scales.shape[-1]),
                   fmt, block, shape, True)


def dequantize(qt: QTensor, *, dtype=torch.float32) -> torch.Tensor:
    """Decode a packed :class:`QTensor` to a dense tensor of its logical
    shape (``dequantize_packed`` kernel on CUDA, plain version on CPU)."""
    from repro_torch.kernels.f2p_quant import f2p_dequantize_packed

    if not qt.packed:
        raise _unported()
    shape = qt.logical_shape
    lead = shape[:-1]
    w2 = qt.codes.reshape(-1, qt.codes.shape[-1]).contiguous()
    s2 = qt.scales.reshape(-1, qt.scales.shape[-1]).contiguous()
    out_dtype = dtype if dtype in (torch.float32, torch.bfloat16) \
        else torch.float32
    out = f2p_dequantize_packed(w2, s2, qt.fmt, block=qt.block,
                                out_dtype=out_dtype)
    out = out.reshape(*lead, qt.npad)[..., :shape[-1]]
    return out.to(dtype)
