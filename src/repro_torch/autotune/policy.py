"""FormatPolicy: leaf-path patterns -> chosen format, and the budgeted
per-leaf format allocator (port of ``repro.autotune.policy``).

A :class:`FormatPolicy` is a small, immutable, hashable, JSON-serializable
table of ``(fnmatch pattern, format name, block)`` rules plus a default.
Formats are stored by their canonical parseable NAME
(``repro_torch.core.formats.format_name``), so the policy survives
checkpoints and config files without pickling format objects; a policy
written by either package reads back in the other.

``solve()`` turns calibrated leaf summaries into a policy: it minimizes
the total modeled squared error (closed-form models x
:class:`~repro_torch.autotune.error_models.HistogramDist` summaries)
subject to a bit budget, by greedy marginal-gain ascent, on the host in
numpy, exactly as the reference does.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import re
from typing import Sequence

import numpy as np

from repro_torch.autotune.error_models import Dist, expected_mse
from repro_torch.core.f2p import F2PFormat
from repro_torch.core.formats import format_bits, format_name, named_format

__all__ = ["PolicyRule", "FormatPolicy", "LeafSpec", "solve",
           "candidate_formats", "leaf_path_str", "path_from_keystr"]


# ---------------------------------------------------------------------------
# Leaf paths
# ---------------------------------------------------------------------------
def leaf_path_str(path) -> str:
    """Key path tuple -> 'a/b/0/c' (plain keys, and the reference's
    DictKey / SequenceKey / GetAttrKey / FlattenedIndexKey objects, all
    reduce to their bare key)."""
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            parts.append(str(k))
    return "/".join(parts)


_KEYSTR_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.([A-Za-z_]\w*)")


def path_from_keystr(name: str) -> str:
    """A ``jax.tree_util.keystr``-style leaf name (``['a']['b'][0]``, the
    checkpoint index's keys) -> the same 'a/b/0/c' normal form."""
    parts = [m[1] or m[2] or m[3] for m in _KEYSTR_RE.finditer(name)]
    return "/".join(parts) if parts else name


# ---------------------------------------------------------------------------
# The policy object
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """First matching pattern wins. ``block`` <= 0 defers the block choice:
    ``f2p_for`` keeps the caller's fallback block, ``format_for`` (no caller
    block in scope) substitutes the policy's ``default_block``."""

    pattern: str
    fmt: str            # canonical format name (formats.format_name)
    block: int = 128

    def __post_init__(self):
        named_format(self.fmt)  # fail loudly on unparseable names


@dataclasses.dataclass(frozen=True)
class FormatPolicy:
    """Leaf-path patterns -> chosen format. Immutable and hashable (safe as
    a dataclass config field); serializes to JSON."""

    rules: tuple[PolicyRule, ...] = ()
    default_fmt: str | None = None   # None: caller's hardcoded fallback
    default_block: int = 128

    def __post_init__(self):
        if not isinstance(self.rules, tuple):
            object.__setattr__(self, "rules", tuple(self.rules))
        if self.default_fmt is not None:
            named_format(self.default_fmt)

    # ---- lookup ------------------------------------------------------------
    def match(self, path: str) -> PolicyRule | None:
        for r in self.rules:
            if fnmatch.fnmatchcase(path, r.pattern):
                return r
        return None

    def format_for(self, path: str):
        """(GridFormat | None, block) for a leaf path; (None, default_block)
        when neither a rule nor a default applies."""
        r = self.match(path)
        if r is not None:
            return named_format(r.fmt), (r.block if r.block > 0
                                         else self.default_block)
        if self.default_fmt is not None:
            return named_format(self.default_fmt), self.default_block
        return None, self.default_block

    def f2p_for(self, path: str, fallback: tuple[F2PFormat, int]):
        """(F2PFormat, block) for codec call sites that can only execute F2P
        formats (QTensor kernels). A matching non-F2P rule is a config error
        and raises rather than silently running the fallback. A matching
        rule with ``block`` <= 0 keeps the CALLER's fallback block."""
        r = self.match(path)
        if r is None:
            if self.default_fmt is None:
                return fallback
            fmt, block = named_format(self.default_fmt), self.default_block
        else:
            fmt = named_format(r.fmt)
            block = r.block if r.block > 0 else fallback[1]
        if not isinstance(fmt, F2PFormat):
            raise TypeError(
                f"policy rule for {path!r} picked {format_name(fmt)}, but "
                "this call site runs the F2P codec (QTensor) only")
        return fmt, block

    # ---- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {"rules": [dataclasses.asdict(r) for r in self.rules],
                "default_fmt": self.default_fmt,
                "default_block": self.default_block}

    @classmethod
    def from_dict(cls, d: dict) -> "FormatPolicy":
        return cls(rules=tuple(PolicyRule(**r) for r in d.get("rules", [])),
                   default_fmt=d.get("default_fmt"),
                   default_block=int(d.get("default_block", 128)))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "FormatPolicy":
        return cls.from_dict(json.loads(s))

    def describe(self) -> str:
        lines = [f"  {r.pattern:<28} -> {r.fmt} (block {r.block})"
                 for r in self.rules]
        lines.append(f"  {'*':<28} -> {self.default_fmt or '<caller default>'}"
                     f" (block {self.default_block})")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------
def candidate_formats(n_bits: Sequence[int] = (8,),
                      h_bits: Sequence[int] = (1, 2, 3),
                      flavors: Sequence[str] = ("sr", "lr", "si", "li"),
                      signed: bool = True,
                      include_baselines: bool = False) -> list[str]:
    """Canonical names of every representable candidate: all valid F2P
    (flavor x h x n) combos, plus (optionally) the paper's baselines at the
    same widths: intN, the xMyE fp8 variants, SEAD."""
    s = "s" if signed else "u"
    out: list[str] = []
    for n in n_bits:
        for h in h_bits:
            for fl in flavors:
                name = f"f2p_{fl}_{h}_{n}{s}"
                try:
                    named_format(name)
                except ValueError:
                    continue
                out.append(name)
        if include_baselines:
            out.append(f"int{n}{s}")
            out.append(f"sead{n}{s}")
            if n == 8:
                out += [f"3m4e{s}", f"4m3e{s}"]  # fp8-e4m3 / e5m2 family
            if n == 16:
                out += [f"10m5e{s}", f"7m8e{s}"]  # fp16 / bf16
    return out


# ---------------------------------------------------------------------------
# The solve
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Everything the solver needs to know about one tensor: ``dist`` is
    the distribution of the block-normalized magnitudes u = |x| /
    absmax(block) on [0, 1] (``calibrate.leaf_summary`` or ``update(...,
    block=...)`` with ``NORM_SPEC``); ``scale_rms`` =
    sqrt(E[absmax_block^2]) converts modeled normalized error back to data
    units."""

    path: str
    size: int             # element count
    last_dim: int         # blocking axis width (block caps at this)
    dist: Dist            # distribution of u = |x| / absmax_block
    scale_rms: float      # sqrt(E[absmax_block^2])

    def block_for(self, block: int) -> int:
        return max(1, min(block, self.last_dim))


def _leaf_error(spec: LeafSpec, fmt_name: str) -> float:
    """Total modeled squared error of quantizing this leaf with ``fmt``
    under blockwise absmax scaling: E[err^2] ~= E[e_u^2] *
    E[absmax_block^2]."""
    fmt = named_format(fmt_name)
    if spec.scale_rms <= 0.0:
        return 0.0
    e_u = expected_mse(fmt, spec.dist, scale=1.0 / fmt.max_value)
    return spec.size * spec.scale_rms ** 2 * e_u


def _leaf_bits(spec: LeafSpec, fmt_name: str, block: int,
               bits_mode: str = "packed") -> float:
    """Total bits of the codes + per-block f32 scales for this leaf:
    ``packed`` charges the word-granular rows of ``packed_nbytes``,
    ``storage`` the byte-aligned code dtype of unpacked containers."""
    from repro_torch.kernels.bits import packed_nbytes

    fmt = named_format(fmt_name)
    blk = spec.block_for(block)
    rows = spec.size // spec.last_dim
    npad = -(-spec.last_dim // blk) * blk
    nblocks = (npad // blk) * rows
    if bits_mode == "storage":
        fbits = 8 * np.dtype(fmt.code_dtype).itemsize if hasattr(
            fmt, "code_dtype") else 8 * -(-format_bits(fmt) // 8)
        code_bits = float(spec.size * fbits)
    else:
        code_bits = 8.0 * rows * packed_nbytes(npad, format_bits(fmt))
    return code_bits + 32.0 * nblocks


def solve(leaves: Sequence[LeafSpec], candidates: Sequence[str],
          budget_bits_per_elem: float, *, block: int = 128,
          default_fmt: str | None = None,
          bits_mode: str = "packed") -> FormatPolicy:
    """Minimize total modeled squared error subject to ``sum(bits) <=
    budget_bits_per_elem * sum(size)``: every leaf starts at its cheapest
    candidate (ties: lowest error), then the single (leaf, candidate)
    upgrade with the best error drop per extra bit is applied until the
    budget is spent. Returns a FormatPolicy with one exact-path rule per
    leaf."""
    if not leaves:
        return FormatPolicy(default_fmt=default_fmt, default_block=block)
    if not candidates:
        raise ValueError("no candidate formats")

    tables = []
    for sp in leaves:
        rows = [(c, _leaf_bits(sp, c, block, bits_mode), _leaf_error(sp, c))
                for c in candidates]
        rows.sort(key=lambda r: (r[1], r[2]))
        tables.append(rows)

    total_elems = sum(sp.size for sp in leaves)
    # a relative slack: (sum/total)*total can land one ULP below the sum
    budget = budget_bits_per_elem * total_elems * (1.0 + 1e-9)

    choice = []
    spent = 0.0
    for rows in tables:
        min_bits = rows[0][1]
        best = min((r for r in rows if r[1] == min_bits), key=lambda r: r[2])
        choice.append(best)
        spent += best[1]
    if spent > budget:
        raise ValueError(
            f"budget {budget_bits_per_elem} bits/elem infeasible: cheapest "
            f"assignment needs {spent / total_elems:.2f}")

    improved = True
    while improved:
        improved = False
        best_gain, best_i, best_row = 0.0, -1, None
        for i, rows in enumerate(tables):
            _, cur_bits, cur_err = choice[i]
            for name, bits, err in rows:
                dbits = bits - cur_bits
                derr = cur_err - err
                if derr <= 0.0 or spent + dbits > budget:
                    continue
                # free upgrades (same bits, less error) are taken greedily
                gain = derr / dbits if dbits > 0 else float("inf")
                if gain > best_gain:
                    best_gain, best_i, best_row = gain, i, (name, bits, err)
        if best_i >= 0:
            spent += best_row[1] - choice[best_i][1]
            choice[best_i] = best_row
            improved = True

    rules = tuple(PolicyRule(pattern=sp.path, fmt=name,
                             block=sp.block_for(block))
                  for sp, (name, _, _) in zip(leaves, choice))
    return FormatPolicy(rules=rules, default_fmt=default_fmt,
                        default_block=block)
