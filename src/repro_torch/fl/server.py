"""FL server: aggregation directly on codes+scales (port of
``repro.fl.server``).

The server never rebuilds a client's unweighted f32 delta as a standalone
step: the aggregation weight is FOLDED INTO THE SCALES
(``QTensor.scale_by``), so the per-client multiply touches only the tiny
scale tensor, then the codes decode (B4 for packed words, B6 for codes on
the card) and the weighted contributions accumulate in f32. Uncompressed
leaves take the plain weighted-sum path.

Float accumulation is order-DEPENDENT, which matters once arrivals are
async: ``fl.exact`` (re-exported here) accumulates integer codes in int64
on the shared F2P grid instead, bit-identical under any client
permutation, partial-arrival batching, or host, with one decode at the end.
The fleet driver (``fl.rounds.run_fleet_rounds``) uses it; this float path
is ``run_fed_avg``'s.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.fl import _tree
from repro_torch.fl.exact import (  # noqa: F401
    AggregationOverflow, ExactAggregator, UpdateRejected, aggregate_exact,
    validate_update)


def wire_bytes(update) -> int:
    """Bytes this update costs on the wire: QTensor leaves ship
    codes+scales; everything else ships raw."""
    total = 0
    for leaf in _tree.leaves(update):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            a = np.asarray(leaf)
            total += a.size * a.dtype.itemsize
    return int(total)


def _contribution(leaf, weight):
    """One client's weighted f32 contribution for one leaf: the weight
    folded into the scales, then one dequantize (an exact upcast of every
    8-bit F2P value, scaled once)."""
    if isinstance(leaf, QTensor):
        return leaf.scale_by(weight).dequantize(torch.float32)
    return leaf.to(torch.float32) * float(np.float32(weight))


def aggregate(updates: Sequence, weights: Sequence[float] | None = None):
    """Weighted mean of client update trees -> one f32 delta tree.

    ``weights`` default to uniform 1/n; they are normalized to sum to 1, so
    passing per-client example counts gives the standard fed-avg weighting.
    """
    n = len(updates)
    if n == 0:
        raise ValueError("aggregate() needs at least one client update")
    if weights is None:
        w = [1.0 / n] * n
    else:
        tot = float(sum(weights))
        if tot <= 0:
            raise ValueError(f"non-positive total weight {tot}")
        w = [float(x) / tot for x in weights]

    td = _tree.structure(updates[0])
    flats = [_tree.leaves(u) for u in updates]
    for u in updates[1:]:
        if _tree.structure(u) != td:
            raise ValueError("client updates have mismatched tree structures")

    out = []
    for i in range(len(flats[0])):
        acc = _contribution(flats[0][i], w[0])
        for c in range(1, n):
            acc = acc + _contribution(flats[c][i], w[c])
        out.append(acc)
    return _tree.unflatten(updates[0], out)


def apply_update(params, delta, server_lr: float = 1.0):
    """params + server_lr * delta, preserving each param leaf's dtype."""
    lr = float(np.float32(server_lr))
    return _tree.tree_map(
        lambda p, d: (p.to(torch.float32) + lr * d).to(p.dtype),
        params, delta)
