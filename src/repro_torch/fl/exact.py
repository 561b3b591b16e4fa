"""Bit-exact, order-invariant aggregation of F2P client updates (port of
``repro.fl.exact``: host numpy as in the reference, the same bits; a
QTensor leaf's codes / packed words and scales come to the host, from any
device, as numpy arrays).

The float server path (``fl.server.aggregate``) accumulates weighted f32
contributions — correct on average, but the result depends on client
ARRIVAL ORDER (float addition is not associative), so two hosts draining the
same mailbox in different orders commit different global models. This module
is the quire idea from the posit-FL exemplar (SNIPPETS.md) rebuilt for F2P:
every contribution becomes INTEGERS on a shared dyadic grid, accumulation is
int64 addition (exact, commutative, associative), and floating point appears
exactly once — at the final decode.

Two contribution paths, per leaf:

  * **codes path** (exact): a QTensor whose per-block scales are powers of
    two (``ClientConfig(scale_mode="pow2")``) and whose format's grid fits an
    integer table. Every representable F2P magnitude is ``sig * 2^exp2``
    with integer ``sig`` (``F2PFormat.decode_payload``), so the whole grid is
    ``ivals[code] * 2^emin`` with ``ivals`` int64 (19 bits at 8-bit codes,
    27 at 16). A client's block contributes ``W * ivals[codes]`` at exponent
    ``log2(scale) + emin`` — no rounding anywhere.
  * **fixed-point path** (deterministic): any other leaf (f32-scaled
    QTensors are dequantized first; raw f32 leaves directly) is rounded ONCE
    per contribution onto a per-leaf dyadic grid with ``frac_bits``
    fractional bits below its own absmax exponent. The 2^-32 relative
    rounding is far below f32 resolution, and because it happens before any
    order-dependent state exists, invariance still holds bit-for-bit.

Accumulator cells carry ``(A: int64, E: exponent)`` per block and align by
EXPONENT DESCENT: folding a contribution at exponent ``P`` into a cell at
``E`` left-shifts whichever side sits higher so both meet at ``min(E, P)``.
Left shifts are exact, so the state after folding a SET of contributions is
``E = min(P_i)``, ``A = Σ ints_i << (P_i - E)`` — a pure function of the
set. Permutations, partial/async arrival batches (``add_batch``/``merge``),
and host architecture cannot change a bit.

Overflow cannot be silent: every fold pre-checks the post-shift magnitudes
(float64 overestimate vs a 2^61 ceiling, two bits under int64) and raises
:class:`AggregationOverflow`. Headroom arithmetic (DESIGN.md §10): grid ints
≤ 2^27 (16-bit codes), total integer weight ≤ 2^24 by construction
(``MAX_WEIGHT`` per client — 10k clients × the default 2^8 unit is 2^21.3),
leaving ≥ 10 bits of per-block scale spread before the ceiling; the FL-wire
default (8-bit codes, 2^19 ints) leaves ≥ 18.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.f2p import F2PFormat
from repro_torch.core.qtensor import QTensor
from repro_torch.fl import _tree
from repro_torch.fl._tree import to_numpy
from repro_torch.kernels.bits import unpack_bits_np

__all__ = ["AggregationOverflow", "UpdateRejected", "ExactAggregator",
           "aggregate_exact", "validate_update", "grid_ints"]

# exponent sentinel for "nothing folded yet" cells; any real exponent is
# far below it, so min() folds it away on first contact
_SENT = np.int64(1) << np.int64(60)
# |accumulator| ceiling: 2 spare bits under int64 so the float64
# overestimate in the pre-check can never pass a value that wraps
_LIMIT = 2.0 ** 61
# per-client integer weights are capped so W * grid_int stays well inside
# int64 even at 16-bit codes (24 + 27 = 51 bits)
MAX_WEIGHT = 1 << 24
# codes path eligibility: grid integer width that leaves weight + spread
# headroom (every n_bits<=16, h_bits<=2 format fits; wide h=3 ranges don't)
_MAX_GRID_BITS = 32
_FRAC_BITS = 32  # fixed-point path: relative rounding 2^-32 << f32 ulp


class AggregationOverflow(RuntimeError):
    """int64 accumulator headroom exhausted (scale spread too large)."""


class UpdateRejected(ValueError):
    """A client update failed the server validation gate."""


# ---------------------------------------------------------------------------
# Exact integer view of an F2P grid
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def grid_ints(fmt: F2PFormat):
    """``(ivals, emin)`` with ``decode(code) == ivals[code] * 2^emin``
    EXACTLY for every full code, ``ivals`` int64 — or ``None`` when the
    format's dynamic range needs more than ``_MAX_GRID_BITS`` bits (the
    fixed-point path takes over)."""
    codes = np.arange(1 << fmt.payload_bits, dtype=np.int64)
    v, m_bits, mant = fmt.split_payload(codes)
    e_val = fmt.flavor.exponent_sign * v
    normal = e_val > fmt.e_min
    exp2 = np.where(normal, e_val + fmt.bias - m_bits,
                    e_val + fmt.bias + 1 - m_bits).astype(np.int64)
    sig = np.where(normal, (np.int64(1) << m_bits) + mant, mant)
    emin = int(exp2.min())
    span = exp2 - emin
    sig_bits = np.zeros(sig.shape, np.int64)
    nz = sig > 0
    sig_bits[nz] = np.floor(np.log2(sig[nz].astype(np.float64))).astype(
        np.int64) + 1
    if int(np.max(np.where(nz, sig_bits + span, 0), initial=0)) \
            > _MAX_GRID_BITS:
        return None
    ivals = sig << span
    # exactness is load-bearing — assert it once per format, at build time
    assert np.all(np.ldexp(ivals.astype(np.float64), emin)
                  == fmt.decode_payload(codes)), f"grid_ints inexact for {fmt}"
    if fmt.signed:
        sign = (np.arange(1 << fmt.n_bits, dtype=np.int64)
                >> fmt.payload_bits) & 1
        mag = ivals[np.arange(1 << fmt.n_bits, dtype=np.int64)
                    & ((1 << fmt.payload_bits) - 1)]
        ivals = np.where(sign == 1, -mag, mag)
    return ivals, emin


def _pow2_exponents(scales: np.ndarray):
    """int64 exponents ``e`` with ``scales == 2^e`` exactly, or ``None`` if
    any scale is not a power of two (or not finite/positive)."""
    s = np.asarray(scales, np.float32)
    if not np.all(np.isfinite(s)) or np.any(s <= 0):
        return None
    m, e = np.frexp(s.astype(np.float64))
    if not np.all(m == 0.5):
        return None
    return e.astype(np.int64) - 1


# ---------------------------------------------------------------------------
# Validation gate
# ---------------------------------------------------------------------------
def validate_update(update) -> None:
    """Reject updates that would poison the global model: non-finite or
    non-positive scales, non-finite raw float leaves, out-of-format codes
    (a 6-bit code of 77 in a uint8 container). Raises
    :class:`UpdateRejected`; returning means every leaf passed.

    Packed codes are bit-masked by construction (``unpack_bits`` extracts
    exactly ``n_bits`` fields), so range corruption is only detectable on
    byte-aligned containers wider than the format — detectable corruption in
    packed words shows up through the scales/value checks instead."""
    for path, leaf in _tree.leaves_with_path(update):
        name = _tree.keystr(path)
        if isinstance(leaf, QTensor):
            s = to_numpy(leaf.scales)
            if not np.all(np.isfinite(s)):
                raise UpdateRejected(f"{name}: non-finite scales")
            if np.any(s <= 0):
                raise UpdateRejected(f"{name}: non-positive scales")
            if not leaf.packed:
                c = to_numpy(leaf.codes)
                if c.size and int(c.max()) >= (1 << leaf.fmt.n_bits):
                    raise UpdateRejected(
                        f"{name}: code {int(c.max())} out of range for "
                        f"{leaf.fmt}")
        else:
            a = to_numpy(leaf)
            if a.dtype.kind == "f" and not np.all(np.isfinite(a)):
                raise UpdateRejected(f"{name}: non-finite delta values")


# ---------------------------------------------------------------------------
# Per-leaf integer accumulator cells
# ---------------------------------------------------------------------------
class _LeafAcc:
    """(A, E) integer cells for one leaf. ``E`` broadcasts against ``A``
    over ``red_axes`` (the axes sharing one exponent: the block axis for
    QTensor leaves, the whole leaf for fixed-point ones)."""

    __slots__ = ("A", "E", "red_axes")

    def __init__(self, shape, e_shape, red_axes):
        self.A = np.zeros(shape, np.int64)
        self.E = np.full(e_shape, _SENT, np.int64)
        self.red_axes = red_axes

    def _cellmax(self, arr, batched: bool):
        ax = self.red_axes
        if batched:
            ax = tuple(a for a in ax)  # negative axes index from the right
        return np.max(np.abs(arr), axis=ax, keepdims=True) if ax \
            else np.abs(arr)

    def fold(self, ints: np.ndarray, P: np.ndarray, batched: bool) -> None:
        """Fold contributions (exact). ``batched``: leading axis of ``ints``
        and ``P`` enumerates independent contributions summed in one pass —
        bit-identical to folding them one by one (integer associativity)."""
        tail = ints.shape[1:] if batched else ints.shape
        if tail != self.A.shape:
            raise UpdateRejected(
                f"contribution shape {tail} does not match accumulator "
                f"{self.A.shape}")
        mx = self._cellmax(ints, batched)
        P_eff = np.where(mx == 0, _SENT, P)  # empty cells never drag E down
        Pmin = P_eff.min(axis=0) if batched else P_eff
        newE = np.minimum(self.E, Pmin)
        mA = self._cellmax(self.A, False)
        sh_self = np.where(mA == 0, 0, self.E - newE)
        sh_c = np.where(mx == 0, 0, P_eff - newE)
        # pre-check: float64 overestimate of the post-fold magnitude
        tot = mA.astype(np.float64) * np.exp2(
            np.minimum(sh_self, 1023).astype(np.float64))
        shifted = mx.astype(np.float64) * np.exp2(
            np.minimum(sh_c, 1023).astype(np.float64))
        tot = tot + (shifted.sum(axis=0) if batched else shifted)
        peak = float(tot.max(initial=0.0))
        if not (peak <= _LIMIT):
            raise AggregationOverflow(
                f"accumulator would reach ~2^{np.log2(max(peak, 1.0)):.0f} "
                f"(limit 2^61): per-block scale spread too large — rescale "
                f"weights or tighten the client format")
        A = np.left_shift(self.A, sh_self)
        contrib = np.left_shift(ints, sh_c)
        self.A = A + (contrib.sum(axis=0, dtype=np.int64) if batched
                      else contrib)
        self.E = newE

    def merge(self, other: "_LeafAcc") -> None:
        self.fold(other.A, other.E, batched=False)


# ---------------------------------------------------------------------------
# The aggregator
# ---------------------------------------------------------------------------
class _TreeDef:
    """The reference's treedef with QTensor leaves: the tree's leaf paths
    (equality) and a skeleton to rebuild the tree around new leaves."""

    __slots__ = ("paths", "skeleton")

    def __init__(self, tree):
        self.paths = _tree.structure(tree)
        self.skeleton = _tree.unflatten(tree, [0] * len(_tree.leaves(tree)))

    def __eq__(self, other):
        return isinstance(other, _TreeDef) and self.paths == other.paths

    def unflatten(self, leaves):
        return _tree.unflatten(self.skeleton, leaves)


class ExactAggregator:
    """Order-invariant weighted-sum accumulator for client update pytrees.

    Usage::

        agg = ExactAggregator()
        agg.add(update_a, weight=256)          # any order
        agg.add_batch(stacked_updates, [256, 256, 0, 128])   # any split
        agg.merge(other_agg)                   # any partition
        delta = agg.finalize()                 # f32 pytree, one decode

    Weights are INTEGERS (quantize floats upstream — determinism demands
    it); weight 0 is an exact no-op, which is how padded lanes and
    deduplicated deliveries are excluded. ``finalize`` divides by the total
    folded weight, so only weight RATIOS matter.
    """

    def __init__(self, *, frac_bits: int = _FRAC_BITS):
        self.frac_bits = int(frac_bits)
        self._treedef = None
        self._meta: list | None = None   # per-leaf (kind, fmt, block, shape)
        self._accs: list[_LeafAcc] | None = None
        self.total_weight = 0
        self.n_folded = 0

    # ---- structure ---------------------------------------------------------
    def _init_from(self, leaves, treedef):
        self._treedef = treedef
        self._meta, self._accs = [], []
        for leaf in leaves:
            if isinstance(leaf, QTensor):
                nb = leaf.npad // leaf.block
                shape = leaf.logical_shape[:-1] + (nb, leaf.block)
                e_shape = leaf.logical_shape[:-1] + (nb, 1)
                self._meta.append(("q", leaf.fmt, leaf.block,
                                   leaf.logical_shape))
                self._accs.append(_LeafAcc(shape, e_shape, (-1,)))
            else:
                a = to_numpy(leaf)
                self._meta.append(("x", None, None, a.shape))
                red = tuple(range(-a.ndim, 0))
                self._accs.append(_LeafAcc(a.shape,
                                           (1,) * a.ndim if a.ndim else (),
                                           red))

    def _check(self, leaves, treedef, lead: int | None):
        if self._treedef is None:
            # the template is the UNBATCHED structure; for a batched first
            # add, slice lane 0 to build it
            if lead is None:
                self._init_from(leaves, treedef)
            else:
                self._init_from([_slice_leaf(lf, 0) for lf in leaves],
                                treedef)
            return
        if treedef != self._treedef:
            raise UpdateRejected("update tree structure mismatch")
        for leaf, (kind, fmt, block, shape) in zip(leaves, self._meta):
            if isinstance(leaf, QTensor) != (kind == "q"):
                raise UpdateRejected("update leaf kind mismatch")
            if kind == "q" and (leaf.fmt, leaf.block) != (fmt, block):
                raise UpdateRejected(
                    f"format mismatch: {leaf.fmt}/{leaf.block} into "
                    f"{fmt}/{block}")

    # ---- contribution encoding --------------------------------------------
    def _encode_q(self, leaf: QTensor, W: int, lead: int | None):
        """QTensor leaf -> (ints, P) on the codes path, or None when the
        leaf needs the fixed-point fallback."""
        gi = grid_ints(leaf.fmt)
        if gi is None:
            return None
        scales = to_numpy(leaf.scales)
        se = _pow2_exponents(scales)
        if se is None:
            return None
        ivals, emin = gi
        codes = to_numpy(leaf.codes)
        if leaf.packed:
            codes = unpack_bits_np(codes, leaf.fmt.n_bits, leaf.npad)
        vals = ivals[codes.astype(np.int64)]
        block = leaf.block
        vals = vals.reshape(*vals.shape[:-1], -1, block)
        P = (se + np.int64(emin))[..., None]
        return np.int64(W) * vals, P

    def _encode_x(self, x: np.ndarray, W: int, red_axes: tuple):
        """Raw/fallback leaf -> deterministic fixed-point (ints, P).

        ``red_axes`` are the accumulator's exponent-sharing axes (negative,
        so a leading batch axis needs no special-casing). The absmax
        exponent is drawn per contribution/cell BEFORE any accumulator
        state is consulted, so the rounding is a pure function of the
        contribution — order cannot touch it."""
        x64 = np.asarray(x, np.float64)
        if not np.all(np.isfinite(x64)):
            raise UpdateRejected("non-finite delta values reached the "
                                 "aggregator (validate_update first)")
        a = np.max(np.abs(x64), axis=red_axes, keepdims=True) if red_axes \
            else np.abs(x64)
        _, e = np.frexp(a)
        P = e.astype(np.int64) - np.int64(self.frac_bits)
        ints = np.rint(np.ldexp(x64, np.broadcast_to(
            -P, x64.shape).astype(np.int32))).astype(np.int64)
        ints = np.where(a > 0, ints, 0) * np.int64(W)
        return ints, P

    # ---- public fold API ---------------------------------------------------
    def add(self, update, weight: int = 1) -> None:
        """Fold one client update with an integer weight (exact)."""
        self._fold_update(update, [int(weight)], lead=None)

    def add_batch(self, stacked_update, weights) -> None:
        """Fold a stacked update (every array leaf carries a leading client
        axis, the reference's vmapped fleet layout) with per-lane integer
        weights. Weight-0 lanes are exact no-ops (padding, dedup)."""
        ws = [int(w) for w in weights]
        self._fold_update(stacked_update, ws, lead=len(ws))

    def _fold_update(self, update, weights, lead: int | None) -> None:
        for w in weights:
            if not (0 <= w <= MAX_WEIGHT):
                raise UpdateRejected(
                    f"integer weight {w} outside [0, {MAX_WEIGHT}]")
        leaves = _tree.leaves(update)
        self._check(leaves, _TreeDef(update), lead)
        live = [w for w in weights if w > 0]
        if not live:
            return
        wvec = np.asarray(weights, np.int64)
        for leaf, meta, acc in zip(leaves, self._meta, self._accs):
            kind = meta[0]
            if kind == "q":
                enc = self._encode_q(leaf, 1, lead)
                if enc is not None:
                    ints, P = enc
                    if lead is None:
                        acc.fold(ints * np.int64(weights[0]), P,
                                 batched=False)
                    else:
                        wb = wvec.reshape((lead,) + (1,) * (ints.ndim - 1))
                        acc.fold(ints * wb, P, batched=True)
                    continue
                # fallback (f32 scales / wide grid): dequantize, reshape to
                # the accumulator's blocked layout, then fixed-point — the
                # per-BLOCK exponents come from red_axes=(-1,)
                x = _to_blocks(to_numpy(leaf.dequantize()), meta[2],
                               meta[3][-1])
            else:
                x = to_numpy(leaf)
            if lead is None:
                ints, P = self._encode_x(x, weights[0], acc.red_axes)
                acc.fold(ints, P, batched=False)
            else:
                ints, P = self._encode_x(x, 1, acc.red_axes)
                wb = wvec.reshape((lead,) + (1,) * (ints.ndim - 1))
                acc.fold(ints * wb, P, batched=True)
        self.total_weight += sum(live)
        self.n_folded += len(live)

    def merge(self, other: "ExactAggregator") -> None:
        """Fold another accumulator in (async partial aggregation: shards
        accumulate independently, merge in any order — same bits)."""
        if other._treedef is None:
            return
        if self._treedef is None:
            # adopt by merging into fresh cells (keeps `other` usable)
            self._treedef, self._meta = other._treedef, list(other._meta)
            self._accs = [_LeafAcc(a.A.shape, a.E.shape, a.red_axes)
                          for a in other._accs]
        elif other._treedef != self._treedef or other._meta != self._meta:
            raise UpdateRejected("cannot merge: aggregator structure "
                                 "mismatch")
        for mine, theirs in zip(self._accs, other._accs):
            mine.merge(theirs)
        self.total_weight += other.total_weight
        self.n_folded += other.n_folded

    # ---- decode ------------------------------------------------------------
    def finalize(self):
        """One decode: ``Σ W_i · v_i / Σ W_i`` per element, f32 pytree."""
        if self._treedef is None or self.total_weight == 0:
            raise ValueError("nothing aggregated")
        out = []
        for (kind, fmt, block, shape), acc in zip(self._meta, self._accs):
            E = np.where(acc.E >= _SENT, np.int64(0), acc.E)
            vals = np.ldexp(acc.A.astype(np.float64),
                            np.broadcast_to(E, acc.A.shape).astype(np.int32))
            vals = vals / float(self.total_weight)
            if kind == "q":
                vals = vals.reshape(*shape[:-1], -1)[..., :shape[-1]]
            out.append(vals.astype(np.float32))
        return self._treedef.unflatten(out)


def _to_blocks(x: np.ndarray, block: int, last_dim: int) -> np.ndarray:
    """Pad the last axis to the block multiple and reshape to
    ``[..., nb, block]`` (leading batch axes pass through untouched)."""
    npad = -(-last_dim // block) * block
    if npad != x.shape[-1]:
        x = np.concatenate(
            [x, np.zeros(x.shape[:-1] + (npad - x.shape[-1],), x.dtype)],
            axis=-1)
    return x.reshape(*x.shape[:-1], -1, block)


def _slice_leaf(leaf, i: int):
    if isinstance(leaf, QTensor):
        return QTensor(leaf.codes[i], leaf.scales[i], leaf.fmt, leaf.block,
                       leaf.shape, leaf.packed)
    return leaf[i]


def aggregate_exact(updates, weights=None, *, frac_bits: int = _FRAC_BITS,
                    weight_unit_bits: int = 16):
    """One-shot exact weighted mean of client updates (drop-in for
    ``fl.server.aggregate`` where bit-exact order invariance matters).

    Float ``weights`` are quantized to integers once, against the full
    weight vector (``max(1, round(w/Σw * 2^weight_unit_bits))``) — a pure
    function of the weight VECTOR, so permuting clients permutes weights
    with them and the folded set is unchanged."""
    n = len(updates)
    if n == 0:
        raise ValueError("aggregate_exact() needs at least one update")
    if weights is None:
        ivw = [1] * n
    else:
        tot = float(sum(weights))
        if tot <= 0:
            raise ValueError(f"non-positive total weight {tot}")
        unit = 1 << weight_unit_bits
        ivw = [max(1, round(float(w) / tot * unit)) for w in weights]
    agg = ExactAggregator(frac_bits=frac_bits)
    for u, w in zip(updates, ivw):
        agg.add(u, w)
    return agg.finalize()
