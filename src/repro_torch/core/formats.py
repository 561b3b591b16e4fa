"""Baseline number formats the paper compares against (Sec. III).

All formats expose the same tiny protocol used by the quantizer and the
counter simulator:

    .grid          sorted float64 ndarray of ALL representable values
    .max_value / .min_value
    .quantize_value(x) -> nearest representable values (ties away from zero)

Formats: INTk, generic xMyE floating point (no inf/nan, with subnormals --
matching the paper's "we discard special values" convention), FP16/BF16/TF32
aliases, and dynamic SEAD (unary exponent prefix).
"""
from __future__ import annotations

import dataclasses
import functools
import re

import numpy as np

__all__ = ["GridFormat", "IntFormat", "FPFormat", "SEADFormat",
           "fp16", "bf16", "tf32", "named_format", "format_name",
           "format_bits"]


class GridFormat:
    """Base: quantization by nearest-grid-point (ties toward larger value)."""

    @property
    def grid(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def max_value(self) -> float:
        return float(self.grid[-1])

    @property
    def min_value(self) -> float:
        return float(self.grid[0])

    def quantize_value(self, x: np.ndarray) -> np.ndarray:
        g = self.grid
        x = np.asarray(x, dtype=np.float64)
        mid = (g[:-1] + g[1:]) / 2.0
        idx = np.searchsorted(mid, x, side="right")
        return g[idx]


@dataclasses.dataclass(frozen=True)
class IntFormat(GridFormat):
    """INTk. Signed = two's complement range; unsigned = [0, 2^k-1]."""

    n_bits: int
    signed: bool = False

    @functools.cached_property
    def grid(self) -> np.ndarray:
        if self.signed:
            return np.arange(-(1 << (self.n_bits - 1)),
                             (1 << (self.n_bits - 1)), dtype=np.float64)
        return np.arange(1 << self.n_bits, dtype=np.float64)

    def __str__(self):
        return f"INT{self.n_bits}{'s' if self.signed else 'u'}"


@dataclasses.dataclass(frozen=True)
class FPFormat(GridFormat):
    """Generic xMyE float ("xMyE" in the paper): 1 sign (opt) + e_bits + m_bits.

    Bias follows the paper's symmetrical-power principle B = -2^(E-1); value
    rule is paper Eq. 2 (subnormals at the lowest exponent, no inf/nan)."""

    m_bits: int
    e_bits: int
    signed: bool = False

    @property
    def bias(self) -> int:
        return -(1 << (self.e_bits - 1))

    @functools.cached_property
    def _payload_grid(self) -> np.ndarray:
        e = np.arange(1 << self.e_bits, dtype=np.int64)[:, None]
        m = np.arange(1 << self.m_bits, dtype=np.int64)[None, :]
        mant = m.astype(np.float64) / (1 << self.m_bits)
        b = self.bias
        normal = np.ldexp(1.0 + mant, e + b)
        sub = np.ldexp(mant, e + b + 1)
        vals = np.where(e > 0, normal, sub).ravel()
        return np.unique(vals)

    @functools.cached_property
    def grid(self) -> np.ndarray:
        pos = self._payload_grid
        if not self.signed:
            return pos
        neg = -pos[::-1]
        return np.concatenate([neg[:-1], pos]) if pos[0] == 0 else np.concatenate([neg, pos])

    def __str__(self):
        return f"{self.m_bits}M{self.e_bits}E{'s' if self.signed else 'u'}"


def fp16(signed=True):
    return FPFormat(m_bits=10, e_bits=5, signed=signed)


def bf16(signed=True):
    return FPFormat(m_bits=7, e_bits=8, signed=signed)


def tf32(signed=True):
    """19-bit TensorFloat32 (10M8E)."""
    return FPFormat(m_bits=10, e_bits=8, signed=signed)


@dataclasses.dataclass(frozen=True)
class SEADFormat(GridFormat):
    """Dynamic SEAD (Liu et al., ToN'21) — unary-encoded exponent.

    An N-bit dynamic SEAD counter spends its exponent as a unary prefix of e
    ones followed by a terminating zero (the all-ones prefix of length N-1
    needs no terminator), leaving N-1-e mantissa bits at stage e. Stage e
    counts with step 2^e starting where stage e-1 ended:

        start_0 = 0;  start_{e+1} = start_e + 2^e * 2^(N-1-e) = start_e + 2^(N-1)

    This is the model the F2P paper evaluates against: the unary exponent is
    space-inefficient, shrinking the mantissa and hence accuracy."""

    n_bits: int
    signed: bool = False

    @functools.cached_property
    def _payload_grid(self) -> np.ndarray:
        n = self.n_bits - (1 if self.signed else 0)
        vals = []
        start = 0.0
        for e in range(n):
            m_bits = n - 1 - e
            k = np.arange(1 << m_bits, dtype=np.float64)
            vals.append(start + k * (2.0 ** e))
            start += (2.0 ** e) * (1 << m_bits)
        return np.unique(np.concatenate(vals))

    @functools.cached_property
    def grid(self) -> np.ndarray:
        pos = self._payload_grid
        if not self.signed:
            return pos
        neg = -pos[::-1]
        return np.concatenate([neg[:-1], pos]) if pos[0] == 0 else np.concatenate([neg, pos])

    def __str__(self):
        return f"SEAD{self.n_bits}{'s' if self.signed else 'u'}"


def format_name(fmt) -> str:
    """Canonical parseable name of any format this repo can represent.

    The inverse of :func:`named_format`: ``named_format(format_name(f)) == f``
    for every IntFormat / FPFormat / SEADFormat / F2PFormat (the property test
    in tests/test_format_names.py pins this). Signedness is encoded as a
    trailing 's'/'u' so names are self-contained — no side-channel ``signed``
    argument needed to round-trip."""
    from repro_torch.core.f2p import F2PFormat

    s = "s" if getattr(fmt, "signed", False) else "u"
    if isinstance(fmt, IntFormat):
        return f"int{fmt.n_bits}{s}"
    if isinstance(fmt, SEADFormat):
        return f"sead{fmt.n_bits}{s}"
    if isinstance(fmt, FPFormat):
        return f"{fmt.m_bits}m{fmt.e_bits}e{s}"
    if isinstance(fmt, F2PFormat):
        return f"f2p_{fmt.flavor.value}_{fmt.h_bits}_{fmt.n_bits}{s}"
    raise TypeError(f"no canonical name for {type(fmt).__name__}")


def format_bits(fmt) -> int:
    """Total storage bits per value (incl. sign bit where applicable)."""
    from repro_torch.core.f2p import F2PFormat

    if isinstance(fmt, (IntFormat, SEADFormat, F2PFormat)):
        return fmt.n_bits
    if isinstance(fmt, FPFormat):
        return fmt.m_bits + fmt.e_bits + (1 if fmt.signed else 0)
    raise TypeError(f"no bit width for {type(fmt).__name__}")


# every spelling named_format accepts; signedness suffix is optional — when
# absent the `signed` argument decides (legacy call convention)
_NAME_RES = {
    "int": re.compile(r"int(\d+)([su]?)"),
    "sead": re.compile(r"sead(\d+)([su]?)"),
    "alias": re.compile(r"(fp16|bf16|tf32)([su]?)"),
    "fp": re.compile(r"(\d+)m(\d+)e([su]?)"),
    "f2p": re.compile(r"f2p_(sr|lr|si|li)_(\d+)_(\d+)([su]?)"),
    # str(F2PFormat) spelling, e.g. "f2p_sr^2[8s]"
    "f2p_str": re.compile(r"f2p_(sr|lr|si|li)\^(\d+)\[(\d+)([su])\]"),
}


def named_format(name: str, signed: bool = False) -> GridFormat:
    """Parse a format name: 'int8', '5m2e', 'fp16', 'bf16', 'tf32', 'sead8',
    'f2p_sr_2_8' — each optionally suffixed 's'/'u' ('int8s') — plus the
    ``str()`` spellings every format emits ('INT8s', '10M5Eu', 'F2P_SR^2[8s]').
    An explicit suffix wins over the ``signed`` argument."""
    from repro_torch.core.f2p import F2PFormat, Flavor

    name = name.lower().strip()

    def sgn(suffix: str) -> bool:
        return signed if not suffix else suffix == "s"

    if m := _NAME_RES["int"].fullmatch(name):
        return IntFormat(int(m[1]), signed=sgn(m[2]))
    if m := _NAME_RES["sead"].fullmatch(name):
        return SEADFormat(int(m[1]), signed=sgn(m[2]))
    if m := _NAME_RES["alias"].fullmatch(name):
        return {"fp16": fp16, "bf16": bf16, "tf32": tf32}[m[1]](sgn(m[2]))
    if m := _NAME_RES["fp"].fullmatch(name):
        return FPFormat(m_bits=int(m[1]), e_bits=int(m[2]), signed=sgn(m[3]))
    if m := _NAME_RES["f2p"].fullmatch(name):
        return F2PFormat(n_bits=int(m[3]), h_bits=int(m[2]),
                         flavor=Flavor(m[1]), signed=sgn(m[4]))
    if m := _NAME_RES["f2p_str"].fullmatch(name):
        return F2PFormat(n_bits=int(m[3]), h_bits=int(m[2]),
                         flavor=Flavor(m[1]), signed=m[4] == "s")
    raise ValueError(f"unknown format {name!r}")
