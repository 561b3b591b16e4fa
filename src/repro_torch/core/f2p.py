"""F2P (Floating-Floating Point) number format — Cohen & Einziger 2024.

An N-bit F2P number is laid out MSB->LSB as

    [ sign (optional, 1b) | hyper-exp (H bits) | exponent (E bits) | mantissa (M bits) ]

where E = uint(hyper-exp) is itself *variable* (0 .. 2^H - 1) and the mantissa gets the
leftover M = N' - H - E bits (N' = payload bits = N - signed).

The exponent vector e (E bits) encodes the *cumulative prefix-free* value

    V(e) = (2^E - 1) + uint(e)                                  (paper Eq. 3)

so vectors of different lengths never collide; V ranges over [0, Vmax-1] with

    Vmax = 2^(2^H) - 1.                                         (paper Eq. 4)

Flavors (paper Table IV) pick the sign of the exponent value and the bias:

    SR:  E = +V,  B = -(Vmax+1)/2,            E_min = 0
    LR:  E = -V,  B = +(Vmax-1)/2,            E_min = -(Vmax-1)
    SI:  E = +V,  B = N' - H - 1,             E_min = 0
    LI:  E = -V,  B = N' - H - 2^H + Vmax-1,  E_min = -(Vmax-1)

and the value rule is FP-identical (paper Eq. 2):

    N(E, M) = 2^(E+B) * (1+M)      if E >  E_min
            = 2^(E+B+1) * M        if E == E_min   (subnormals)

This module is the *reference* implementation: exact, vectorized numpy, host-side.
The device hot path lives in repro_torch.kernels (branch-free arithmetic
encode/decode; CUDA kernels in repro_torch/csrc/f2p_kernels.cu).

Code <-> value monotonicity: for SR/SI the unsigned payload code is monotone
*increasing* in value; for LR/LI it is monotone *decreasing*. Both are bijections
onto the grid (modulo the two codes of value 0 never colliding — subnormal zero
exists only at one end).
"""
from __future__ import annotations

import dataclasses
import enum
import functools

import numpy as np

__all__ = ["Flavor", "F2PFormat"]

# Block size for the closed-form encode/round sweeps: big enough to amortize
# per-op dispatch, small enough that ~8 f64 intermediates stay in L2.
_BLOCK = 1 << 15


def _blockwise(fn, x, out_dtype):
    """Apply vectorized ``fn`` over cache-resident blocks, preserving shape."""
    x = np.asarray(x, dtype=np.float64)
    if x.size <= _BLOCK:
        return fn(x)
    flat = x.ravel()
    out = np.empty(flat.size, dtype=out_dtype)
    for i in range(0, flat.size, _BLOCK):
        out[i:i + _BLOCK] = fn(flat[i:i + _BLOCK])
    return out.reshape(x.shape)


class Flavor(enum.Enum):
    SR = "sr"  # small reals
    LR = "lr"  # large reals
    SI = "si"  # small integers
    LI = "li"  # large integers

    @property
    def exponent_sign(self) -> int:
        return +1 if self in (Flavor.SR, Flavor.SI) else -1

    @property
    def is_integer(self) -> bool:
        return self in (Flavor.SI, Flavor.LI)


def _code_dtype(n_bits: int):
    if n_bits <= 8:
        return np.uint8
    if n_bits <= 16:
        return np.uint16
    return np.uint32


@dataclasses.dataclass(frozen=True)
class F2PFormat:
    """An F2P^H number format of ``n_bits`` total bits (incl. sign if signed)."""

    n_bits: int
    h_bits: int
    flavor: Flavor
    signed: bool = False

    def __post_init__(self):
        if isinstance(self.flavor, str):  # convenience
            object.__setattr__(self, "flavor", Flavor(self.flavor.lower()))
        if not (1 <= self.h_bits <= 3):
            raise ValueError("h_bits must be in [1,3] (paper uses 1-2; 4+ overflows f64)")
        if self.payload_bits < self.h_bits + self.max_e_bits:
            raise ValueError(
                f"n_bits={self.n_bits} too small for H={self.h_bits}: need "
                f">= {self.h_bits + self.max_e_bits} payload bits"
            )

    # ---- derived constants ------------------------------------------------
    @property
    def payload_bits(self) -> int:
        return self.n_bits - (1 if self.signed else 0)

    @property
    def max_e_bits(self) -> int:
        return (1 << self.h_bits) - 1

    @property
    def vmax(self) -> int:
        """Number of distinct exponent values (paper Eq. 4); V in [0, vmax-1]."""
        return (1 << (1 << self.h_bits)) - 1

    @property
    def bias(self) -> int:
        nu, h = self.payload_bits, self.h_bits
        if self.flavor == Flavor.SR:
            return -(self.vmax + 1) // 2
        if self.flavor == Flavor.LR:
            return (self.vmax - 1) // 2
        if self.flavor == Flavor.SI:
            return nu - h - 1
        # LI
        return nu - h - (1 << h) + self.vmax - 1

    @property
    def e_min(self) -> int:
        return 0 if self.flavor.exponent_sign > 0 else -(self.vmax - 1)

    @property
    def code_dtype(self):
        return _code_dtype(self.n_bits)

    def __str__(self) -> str:  # e.g. "F2P_LI^2 n=8"
        s = "s" if self.signed else "u"
        return f"F2P_{self.flavor.name}^{self.h_bits}[{self.n_bits}{s}]"

    # ---- field helpers ----------------------------------------------------
    def e_bits_of_v(self, v):
        """Exponent-field size for exponent value v: smallest E with v <= 2^(E+1)-2.

        Exact integer thresholds (esize grows by one at v = 2^j - 1), no libm —
        the same formulation the TPU kernel uses (kernels/f2p_quant.py)."""
        v = np.asarray(v, dtype=np.int64)
        es = np.zeros_like(v)
        for j in range(1, 1 << self.h_bits):
            es += v >= ((1 << j) - 1)
        return es

    def m_bits_of_e(self, e_bits):
        return self.payload_bits - self.h_bits - np.asarray(e_bits, dtype=np.int64)

    # ---- decode: payload code -> fields -> value ----------------------------
    def split_payload(self, payload: np.ndarray):
        """payload uint -> (v, m_bits, mantissa_uint). Vectorized, exact."""
        p = np.asarray(payload, dtype=np.int64)
        nu, h = self.payload_bits, self.h_bits
        e_bits = (p >> (nu - h)) & ((1 << h) - 1)  # hyper-exp field = E size
        m_bits = nu - h - e_bits
        e_field = (p >> m_bits) & ((1 << e_bits) - 1)
        v = ((np.int64(1) << e_bits) - 1) + e_field  # paper Eq. 3
        mant = p & ((np.int64(1) << m_bits) - 1)
        return v, m_bits, mant

    def decode_payload(self, payload: np.ndarray) -> np.ndarray:
        """Unsigned payload codes -> float64 magnitudes (exact)."""
        v, m_bits, mant = self.split_payload(payload)
        e_val = self.flavor.exponent_sign * v
        b = self.bias
        normal = e_val > self.e_min
        # normal: 2^(E+B-m_bits) * (2^m_bits + mant); subnormal: 2^(E+B+1-m_bits) * mant
        exp2 = np.where(normal, e_val + b - m_bits, e_val + b + 1 - m_bits)
        sig = np.where(normal, (np.int64(1) << m_bits) + mant, mant)
        return np.ldexp(sig.astype(np.float64), exp2.astype(np.int64))

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """Full codes (incl. sign bit if signed) -> float64 values."""
        c = np.asarray(codes, dtype=np.int64)
        if not self.signed:
            return self.decode_payload(c)
        sign = (c >> self.payload_bits) & 1
        mag = self.decode_payload(c & ((1 << self.payload_bits) - 1))
        return np.where(sign == 1, -mag, mag)

    # ---- grid ---------------------------------------------------------------
    # NOTE on code<->value order: exponent *buckets* are monotone in the code
    # (increasing value for SR/SI, decreasing for LR/LI) but the mantissa always
    # increases the value, so for LR/LI the full code order is NOT value order.
    # We keep an explicit argsort mapping sorted-position -> code.

    @functools.cached_property
    def _values_by_code(self) -> np.ndarray:
        codes = np.arange(1 << self.payload_bits, dtype=np.int64)
        return self.decode_payload(codes)

    @functools.cached_property
    def _code_by_rank(self) -> np.ndarray:
        """sorted position (rank) -> payload code."""
        return np.argsort(self._values_by_code, kind="stable")

    @functools.cached_property
    def payload_grid(self) -> np.ndarray:
        """All representable magnitudes, strictly ascending. Shape (2^payload_bits,)."""
        g = self._values_by_code[self._code_by_rank]
        assert np.all(np.diff(g) > 0), f"grid not strictly increasing for {self}"
        return g

    @functools.cached_property
    def grid(self) -> np.ndarray:
        """Sorted array of ALL representable values (signed includes negatives).

        For signed formats, -0 and +0 collapse to a single 0 entry."""
        pos = self.payload_grid
        if not self.signed:
            return pos
        neg = -pos[::-1]
        if pos[0] == 0.0:
            return np.concatenate([neg[:-1], pos])  # drop duplicate zero
        return np.concatenate([neg, pos])

    @property
    def v_sub(self) -> int:
        """The (single) subnormal exponent bucket."""
        return 0 if self.flavor.exponent_sign > 0 else self.vmax - 1

    @property
    def v_top(self) -> int:
        """The bucket holding the largest magnitudes."""
        return self.vmax - 1 if self.flavor.exponent_sign > 0 else 0

    @property
    def max_value(self) -> float:
        # closed form (no grid): top bucket is always normal (v_top != v_sub
        # since vmax >= 3), so max = 2^e * (2 - 2^-mbits).
        v = self.v_top
        e = self.flavor.exponent_sign * v + self.bias
        mbits = self.payload_bits - self.h_bits - int(self.e_bits_of_v(v))
        return float(np.ldexp((1 << (mbits + 1)) - 1, e - mbits))

    @property
    def min_value(self) -> float:
        # zero is always representable (subnormal bucket, m = 0)
        return -self.max_value if self.signed else 0.0

    @property
    def min_positive(self) -> float:
        g = self.payload_grid
        return float(g[g > 0][0])

    # ---- encode: value -> nearest code --------------------------------------
    def encode_payload_nearest(self, x: np.ndarray) -> np.ndarray:
        """Magnitudes -> payload codes of the nearest representable value.

        Round-to-nearest; ties go to the LARGER magnitude. Values outside the
        range clamp to the extreme codes (negatives clamp to the zero code).

        Closed form — O(vmax) memory (<= 255 per-bucket constants), not
        O(2^payload_bits), mirroring the TPU kernel's branch-free arithmetic
        (kernels/f2p_quant.py) in float64: frexp exponent bucket -> per-bucket
        gathers -> half-up mantissa round (exact: all intermediates span < 53
        significand bits) -> code assembly. The old grid + searchsorted path
        survives as the test oracle ``encode_payload_nearest_grid``.

        Computed in cache-resident blocks: the ~12 vectorized passes are
        memory-bound, so keeping intermediates in L2 is ~2x over one sweep
        of the full array."""
        return _blockwise(self._encode_payload_block, x, self.code_dtype)

    def _encode_payload_block(self, x: np.ndarray) -> np.ndarray:
        t = self._bucket_tables
        mag, v = self._bucket_of(x)
        # u = mag * 2^shift - lead * 2^mbits: exact — the scaling is a power
        # of two and the subtraction is Sterbenz-safe. Half-up rounding must
        # go through the fractional part: u - floor(u) is exact in IEEE,
        # whereas u + 0.5 can round up for u just below a tie (u = 0.5 - ulp).
        u = np.ldexp(mag, t["shift"][v]) - t["base"][v]
        mf = np.floor(u)
        m = (mf + (u - mf >= 0.5)).astype(np.int64)
        m = np.maximum(m, 0)
        # mantissa overflow moves one bucket toward larger magnitude (V+sgn,
        # precomputed as code_ovf; the top bucket clamps to its max code)
        payload = np.where(m >= t["mmax"][v], t["code_ovf"][v],
                           t["code_base"][v] + m)
        return payload.astype(self.code_dtype)

    @functools.cached_property
    def _bucket_tables(self) -> dict:
        """Per-exponent-bucket constants (length-vmax arrays) driving the
        closed-form encode/round: scale shift, leading-bit offset, assembled
        code bases, and the mantissa-overflow target code."""
        nu, h, sgn = self.payload_bits, self.h_bits, self.flavor.exponent_sign
        one = np.int64(1)
        v = np.arange(self.vmax, dtype=np.int64)
        es = self.e_bits_of_v(v)
        mbits = nu - h - es
        is_sub = v == self.v_sub
        e_val = sgn * v
        exp_lo = np.where(is_sub, e_val + self.bias + 1, e_val + self.bias)
        lead = np.where(is_sub, 0, 1)
        code_base = (es << (nu - h)) | ((v - ((one << es) - 1)) << mbits)
        # overflow lands at m=0 of the next-larger-magnitude bucket; the top
        # bucket clamps to its own max code instead
        vn = np.clip(v + sgn, 0, self.vmax - 1)
        esn = self.e_bits_of_v(vn)
        code_ovf = (esn << (nu - h)) | ((vn - ((one << esn) - 1))
                                        << (nu - h - esn))
        code_ovf = np.where(v == self.v_top,
                            code_base + ((one << mbits) - 1), code_ovf)
        return {
            "shift": (mbits - exp_lo).astype(np.int64),
            "base": np.ldexp(lead.astype(np.float64), mbits),
            "mmax": one << mbits,
            "code_base": code_base,
            "code_ovf": code_ovf,
        }

    def _bucket_of(self, x):
        """(clamped magnitudes, exponent-bucket index V) — the shared head of
        the closed-form encode and round paths."""
        sgn, vmax, bias = self.flavor.exponent_sign, self.vmax, self.bias
        mag = np.clip(np.asarray(x, dtype=np.float64), 0.0, self.max_value)
        # NaN passes through clip and would hit an undefined float->int cast;
        # the grid oracle's searchsorted treats NaN as +inf -> clamp to max
        mag = np.where(np.isnan(mag), self.max_value, mag)
        # exact floor(log2 mag) via frexp: mag = f * 2^e, f in [0.5, 1)
        _, e = np.frexp(mag)
        v = np.clip(sgn * (e.astype(np.int64) - 1 - bias), 0, vmax - 1)
        # frexp(0) reports e=0, which would land zero in an arbitrary bucket
        return mag, np.where(mag == 0.0, np.int64(self.v_sub), v)

    def quantize_payload(self, x: np.ndarray) -> np.ndarray:
        """Magnitudes -> nearest representable magnitudes, fused closed form
        (no code assembly / decode round-trip): the rounded value is
        reconstructed directly as (lead*2^mbits + m) * 2^-shift. A mantissa
        that rounds up to 2^mbits needs no bucket hop — the reconstruction is
        exactly the next bucket's smallest value."""
        return _blockwise(self._round_payload_block, x, np.float64)

    def _round_payload_block(self, x: np.ndarray) -> np.ndarray:
        t = self._bucket_tables
        mag, v = self._bucket_of(x)
        base, shift = t["base"][v], t["shift"][v]
        u = np.ldexp(mag, shift) - base
        mf = np.floor(u)
        m = np.maximum(mf + (u - mf >= 0.5), 0.0)
        return np.ldexp(m + base, -shift)

    def encode_payload_nearest_grid(self, x: np.ndarray) -> np.ndarray:
        """Grid-materializing oracle for ``encode_payload_nearest`` (tests
        only): O(2^payload_bits) memory, bit-identical semantics."""
        g = self.payload_grid
        x = np.asarray(x, dtype=np.float64)
        mid = (g[:-1] + g[1:]) / 2.0
        rank = np.searchsorted(mid, x, side="right")  # ties -> larger magnitude
        return self._code_by_rank[rank].astype(self.code_dtype)

    def encode_nearest(self, x: np.ndarray) -> np.ndarray:
        """Values -> full codes (handles sign bit). Ties away from zero."""
        x = np.asarray(x, dtype=np.float64)
        if not self.signed:
            return self.encode_payload_nearest(np.maximum(x, 0.0))
        sign = (x < 0) | ((x == 0) & np.signbit(x))
        mag_codes = self.encode_payload_nearest(np.abs(x)).astype(np.int64)
        full = (sign.astype(np.int64) << self.payload_bits) | mag_codes
        return full.astype(self.code_dtype)

    def encode_nearest_grid(self, x: np.ndarray) -> np.ndarray:
        """Grid-oracle twin of ``encode_nearest`` (tests only)."""
        x = np.asarray(x, dtype=np.float64)
        if not self.signed:
            return self.encode_payload_nearest_grid(np.maximum(x, 0.0))
        sign = (x < 0) | ((x == 0) & np.signbit(x))
        mag_codes = self.encode_payload_nearest_grid(np.abs(x)).astype(np.int64)
        full = (sign.astype(np.int64) << self.payload_bits) | mag_codes
        return full.astype(self.code_dtype)

    def quantize_value(self, x: np.ndarray) -> np.ndarray:
        """Round values to the nearest representable value. Fused closed form
        — equivalent to decode(encode_nearest(x)) but with no code assembly
        (the minmax/table6 hot path)."""
        x = np.asarray(x, dtype=np.float64)
        if not self.signed:
            return self.quantize_payload(np.maximum(x, 0.0))
        mag = self.quantize_payload(np.abs(x))
        return np.where(x < 0, -mag, mag)
