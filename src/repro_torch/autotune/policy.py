"""FormatPolicy: leaf-path patterns -> chosen format (port of the data half
of ``repro.autotune.policy``).

A :class:`FormatPolicy` is a small, immutable, hashable, JSON-serializable
table of ``(fnmatch pattern, format name, block)`` rules plus a default.
Formats are stored by their canonical parseable NAME
(``repro_torch.core.formats.format_name``), so the policy survives
checkpoints and config files without pickling format objects; a policy
written by either package reads back in the other.

The budgeted allocator of the reference (``solve``, ``candidate_formats``,
``LeafSpec``) is not ported yet (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import re

from repro_torch.core.f2p import F2PFormat
from repro_torch.core.formats import format_name, named_format

__all__ = ["PolicyRule", "FormatPolicy", "leaf_path_str", "path_from_keystr"]


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
