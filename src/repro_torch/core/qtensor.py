"""QTensor: the F2P block-quantized tensor (DESIGN.md §7, §9).

Port of ``repro.core.qtensor``. ``QTensor`` is a plain dataclass (there is
no pytree to register): ``codes``, ``scales`` the per-block f32 scales, plus
the format, block size, logical shape and the ``packed`` flag.

Two layouts of ``codes``:

* unpacked (``packed=False``): one code per element, uint8 for
  n_bits <= 8, else uint16 (``F2PFormat.code_dtype``), the logical shape
  with the last dim padded to the block multiple. The training path's
  format (gradient compression, checkpoints); B5/B6 on the card.
* packed (``packed=True``): little-endian uint32 words — each last-axis row
  of ``npad`` codes packs into ``packed_words(npad, n_bits)`` words, rows
  never share words. The serving path's format (KV cache); B3/B4.

Only the LAST axis is blocked and leading dims are never merged with it.
``scales`` replaces the last dim with the block count. JAX's functional
``dynamic_update`` becomes an in-place write into the destination's storage
here (the KV cache and the pool slabs are updated where they live, the
torch counterpart of buffer donation).

``quantize``, ``QTensor`` and ``QTensor.from_parts`` default to
``packed=False``, as the reference does, so a call ported line for line
gets the same storage and the same bytes; the port's KV caches ask for
packed words explicitly (``models.attention.quantize_kv``,
``empty_packed``). The reference's ``packed=None`` config fields resolve
through :func:`resolve_packed`, which has no ``F2P_PACKED`` environment
default in the port: ``None`` means unpacked, as the reference with the
variable unset.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.f2p import F2PFormat
from repro_torch.kernels.bits import (pack_bits, packed_nbytes, packed_words,
                                      unpack_bits)

__all__ = ["QTensor", "quantize", "dequantize", "block_scales",
           "pow2_round_up", "quantize_tree", "dequantize_tree",
           "resolve_packed"]


def resolve_packed(packed) -> bool:
    """``None`` -> False (the reference's default with ``F2P_PACKED``
    unset; the port has no such variable); else ``bool(packed)``."""
    return False if packed is None else bool(packed)


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


@dataclasses.dataclass
class QTensor:
    """An F2P block-quantized tensor: codes (unpacked or packed words) +
    per-block scales. ``shape`` is the LOGICAL shape (before last-axis
    padding)."""
    codes: torch.Tensor
    scales: torch.Tensor
    fmt: F2PFormat
    block: int
    shape: tuple
    packed: bool = False

    @classmethod
    def from_parts(cls, codes, scales, fmt: F2PFormat, block: int, shape,
                   packed: bool = False) -> "QTensor":
        """Zero-copy reassembly with the reference's shape validation:
        packed codes carry exactly ``packed_words(npad, n_bits)`` uint32
        words per row, unpacked codes ``npad`` codes of the format's code
        dtype; the scales cover the padded row."""
        shape = tuple(int(s) for s in shape)
        block = int(block)
        packed = bool(packed)
        npad = -(-shape[-1] // block) * block
        if packed:
            nw = packed_words(npad, fmt.n_bits)
            if codes.shape[-1] != nw:
                raise ValueError(
                    f"packed codes last dim {codes.shape[-1]} != {nw} uint32 "
                    f"words for {npad} {fmt.n_bits}-bit fields (shape "
                    f"{shape}, block {block})")
            if codes.dtype != torch.uint32:
                raise ValueError(
                    f"packed codes must be uint32 words, got {codes.dtype}")
        else:
            if codes.shape[-1] != npad:
                raise ValueError(
                    f"codes last dim {codes.shape[-1]} != padded logical dim "
                    f"{npad} (shape {shape}, block {block})")
            from repro_torch.kernels.f2p_quant import code_dtype

            if codes.dtype != code_dtype(fmt):
                raise ValueError(f"{fmt.n_bits}-bit codes must be "
                                 f"{code_dtype(fmt)}, got {codes.dtype}")
        if scales.shape[-1] * block != npad:
            raise ValueError(
                f"scales last dim {scales.shape[-1]} does not cover {npad} "
                f"padded elements at block {block}")
        if codes.shape[:-1] != scales.shape[:-1]:
            raise ValueError(f"codes/scales leading dims disagree: "
                             f"{tuple(codes.shape)} vs {tuple(scales.shape)}")
        return cls(codes, scales, fmt, block, shape, packed)

    @property
    def npad(self) -> int:
        """Logical last dim padded up to the block multiple."""
        return -(-self.shape[-1] // self.block) * self.block

    @property
    def logical_shape(self) -> tuple:
        return tuple(self.codes.shape[:-1]) + (self.shape[-1],)

    @property
    def nbytes(self) -> int:
        """Footprint: packed code bytes are word-granular
        (``packed_nbytes``), unpacked ones the code dtype's; plus f32
        scales."""
        if self.packed:
            rows = self.codes.numel() // max(1, self.codes.shape[-1])
            code_bytes = rows * packed_nbytes(self.npad, self.fmt.n_bits)
        else:
            code_bytes = self.codes.numel() * self.codes.element_size()
        return code_bytes + self.scales.numel() * self.scales.element_size()

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype=dtype)

    def pack(self) -> "QTensor":
        """Packed twin of this QTensor (itself when already packed)."""
        if self.packed:
            return self
        from repro_torch.kernels.f2p_quant import codes_to_int32

        words = pack_bits(codes_to_int32(self.codes), self.fmt.n_bits)
        return QTensor(words, self.scales, self.fmt, self.block, self.shape,
                       True)

    def unpack(self) -> "QTensor":
        """Byte-aligned twin (itself when already unpacked); the bitwise
        inverse of :meth:`pack`."""
        if not self.packed:
            return self
        from repro_torch.kernels.f2p_quant import _int32_to_codes

        codes = unpack_bits(self.codes, self.fmt.n_bits, self.npad)
        return QTensor(_int32_to_codes(codes.to(torch.int32), self.fmt),
                       self.scales, self.fmt, self.block, self.shape, False)

    def scale_by(self, factor) -> "QTensor":
        """Fold a multiplicative factor (mean weight, lr) into the scales:
        the dequantize side then needs no extra multiply (f32 product, as
        the reference's ``scales * jnp.asarray(factor, f32)``)."""
        f = torch.as_tensor(factor, dtype=torch.float32,
                            device=self.scales.device)
        return QTensor(self.codes, self.scales * f, self.fmt, self.block,
                       self.shape, self.packed)

    def dynamic_update(self, other: "QTensor", start: int,
                       axis: int) -> "QTensor":
        """Write ``other`` into this tensor's storage at ``start`` along a
        leading ``axis``, codes and scales together, IN PLACE (packed rows
        own whole words, so the slab write is an exact word copy). Returns
        ``self``."""
        if (other.fmt, other.block, other.packed) != (self.fmt, self.block,
                                                      self.packed):
            raise ValueError(
                f"format mismatch: {other.fmt}/{other.block}"
                f"/packed={other.packed} into {self.fmt}/{self.block}"
                f"/packed={self.packed}")
        ax = axis % self.codes.ndim
        if ax == self.codes.ndim - 1:
            raise ValueError("cannot dynamic_update along the blocked axis")
        n = other.codes.shape[ax]
        view = {torch.uint32: torch.int32, torch.uint16: torch.int16}.get(
            self.codes.dtype, self.codes.dtype)
        self.codes.view(view).narrow(ax, int(start), n).copy_(
            other.codes.view(view))
        self.scales.narrow(ax, int(start), n).copy_(other.scales)
        return self


def _pad_last(x: torch.Tensor, block: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % block
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def quantize(x: torch.Tensor, fmt: F2PFormat, *, block: int = 128,
             scale_mode: str = "f32", packed: bool = False) -> QTensor:
    """Blockwise absmax-scaled F2P quantization of any-rank ``x`` along its
    last axis (padded to the block multiple; leading dims kept). CPU
    tensors run the plain versions, CUDA tensors the ``quantize`` (B5,
    unpacked) or ``quantize_packed`` (B3) kernel; both are bitwise equal to
    the JAX ``QT.quantize(..., packed=packed)``."""
    from repro_torch.kernels import f2p_quant as K

    shape = tuple(x.shape)
    xp = _pad_last(x, block)
    if xp.dtype not in (torch.float32, torch.bfloat16):
        xp = xp.to(torch.float32)
    x2 = xp.reshape(-1, xp.shape[-1]).contiguous()
    if packed:
        codes, scales = K.f2p_quantize_packed(x2, fmt, block=block,
                                              scale_mode=scale_mode)
    else:
        codes, scales = K.f2p_quantize_codes(x2, fmt, block=block,
                                             scale_mode=scale_mode)
    return QTensor(codes.reshape(*shape[:-1], codes.shape[-1]),
                   scales.reshape(*shape[:-1], scales.shape[-1]),
                   fmt, block, shape, bool(packed))


def dequantize(qt: QTensor, *, dtype=torch.float32) -> torch.Tensor:
    """Decode a :class:`QTensor` to a dense tensor of its logical shape
    (B4 / B6 on CUDA, the plain versions on the CPU)."""
    from repro_torch.kernels import f2p_quant as K

    shape = qt.logical_shape
    c2 = qt.codes.reshape(-1, qt.codes.shape[-1]).contiguous()
    s2 = qt.scales.reshape(-1, qt.scales.shape[-1]).contiguous()
    out_dtype = dtype if dtype in (torch.float32, torch.bfloat16) \
        else torch.float32
    if qt.packed:
        out = K.f2p_dequantize_packed(c2, s2, qt.fmt, block=qt.block,
                                      out_dtype=out_dtype)
    else:
        out = K.f2p_dequantize_codes(c2, s2, qt.fmt, block=qt.block,
                                     out_dtype=out_dtype)
    out = out.reshape(*shape[:-1], qt.npad)[..., :shape[-1]]
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Tree helpers (gradient compression / checkpoint / FL paths)
# ---------------------------------------------------------------------------
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def quantize_tree(tree, fmt: F2PFormat, *, block: int = 128,
                  min_size: int = 1024, scale_mode: str = "f32",
                  packed: bool = False):
    """Quantize every float tensor leaf of a dict/list tree with >=
    ``min_size`` elements; smaller leaves (biases, norms) pass through."""

    def q(x):
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and x.numel() >= min_size):
            return quantize(x, fmt, block=block, scale_mode=scale_mode,
                            packed=packed)
        return x

    return _tree_map(q, tree)


def dequantize_tree(tree, dtype=torch.float32):
    return _tree_map(lambda x: dequantize(x, dtype=dtype)
                     if isinstance(x, QTensor) else x, tree)
