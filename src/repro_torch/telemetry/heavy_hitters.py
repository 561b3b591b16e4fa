"""Heavy-hitters reporting on top of the F2P sketch engine (DESIGN.md §6.5).

A copy of ``repro.telemetry.heavy_hitters`` (numpy only).

A count-min sketch alone answers point queries; recovering the *top flows*
needs a candidate set, since the key space is too large to enumerate. The
standard sketch+heap construction is used here: a bounded
:class:`HeavyHitterTable` is offered each ingested batch's most frequent
keys together with their current sketch estimates, keeps the best
``capacity`` by estimate, and renders a :class:`HeavyHittersReport`
(estimate, traffic share) on demand. ``serve.SketchIngestEngine`` drives the
offers; anything else holding a sketch and a key stream can too.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["HeavyHitterTable", "HeavyHittersReport"]


@dataclasses.dataclass(frozen=True)
class HeavyHittersReport:
    """Top flows by estimated arrivals, with share of the total stream."""

    keys: np.ndarray        # (k,) flow keys, descending estimate
    estimates: np.ndarray   # (k,) sketch estimates
    shares: np.ndarray      # (k,) estimate / total_arrivals
    total_arrivals: float   # exact host-side ingest total

    def to_dict(self) -> dict:
        return {
            "total_arrivals": self.total_arrivals,
            "flows": [
                {"key": int(k), "estimate": float(e), "share": float(s)}
                for k, e, s in zip(self.keys, self.estimates, self.shares)
            ],
        }

    def __str__(self) -> str:
        lines = [f"heavy hitters ({self.total_arrivals:.0f} arrivals):"]
        for k, e, s in zip(self.keys, self.estimates, self.shares):
            lines.append(f"  key={int(k):>12d}  est={e:>12.0f}  {s:7.2%}")
        return "\n".join(lines)


class HeavyHitterTable:
    """Bounded candidate table: merge-by-key, prune to capacity by estimate.

    Estimates are *refreshed* on every offer (a sketch estimate only grows,
    and re-offering a key replaces its stale value), so the table converges
    to the true top set as long as heavy keys keep appearing in batches —
    guaranteed for actual heavy hitters.
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._keys = np.empty(0, dtype=np.int64)
        self._est = np.empty(0, dtype=np.float64)

    def offer(self, keys: np.ndarray, estimates: np.ndarray) -> None:
        """Merge candidate ``keys`` with fresh sketch ``estimates``."""
        keys = np.asarray(keys, dtype=np.int64).ravel()
        estimates = np.asarray(estimates, dtype=np.float64).ravel()
        if keys.size == 0:
            return
        merged_k = np.concatenate([keys, self._keys])
        merged_e = np.concatenate([estimates, self._est])
        # first occurrence wins -> fresh offers override stale table entries
        uniq, first = np.unique(merged_k, return_index=True)
        est = merged_e[first]
        if uniq.size > self.capacity:
            keep = np.argsort(est)[::-1][:self.capacity]
            uniq, est = uniq[keep], est[keep]
        self._keys, self._est = uniq, est

    def __len__(self) -> int:
        return int(self._keys.size)

    @property
    def keys(self) -> np.ndarray:
        """Current candidate keys (no order guarantee). For re-offering with
        fresh estimates — e.g. after a sketch drains carried budget."""
        return self._keys.copy()

    def report(self, k: int = 20, total_arrivals: float | None = None,
               min_share: float = 0.0) -> HeavyHittersReport:
        """Top-``k`` report; flows below ``min_share`` of the total drop out."""
        order = np.argsort(self._est)[::-1][:k]
        keys, est = self._keys[order], self._est[order]
        total = (float(total_arrivals) if total_arrivals is not None
                 else float(est.sum()))
        shares = est / total if total > 0 else np.zeros_like(est)
        if min_share > 0:
            keep = shares >= min_share
            keys, est, shares = keys[keep], est[keep], shares[keep]
        return HeavyHittersReport(keys=keys, estimates=est, shares=shares,
                                  total_arrivals=total)
