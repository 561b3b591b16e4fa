"""Streaming histogram calibration (port of ``repro.autotune.calibrate``,
DESIGN.md §8.2).

Fits a per-tensor distribution summary from live data, on the data's own
device, with fixed shapes throughout:

  * the state is a dict of f32 tensors on the input's device:
      counts  [n_bins + 2]  log2-spaced magnitude bins; bin 0 holds zeros +
                            underflow, the last bin overflow (and NaNs)
      absmax  []            running max magnitude
      n       []            total elements seen
      msq     []            running sum of per-block absmax^2
      nblocks []            blocks folded in
  * ``update`` is one bucketize plus one scatter-add; states merge by
    addition (``merge``);
  * ``to_dist`` (host side) turns a state into the piecewise-uniform
    :class:`~repro_torch.autotune.error_models.HistogramDist` the closed-form
    error models consume.

``update(..., block=B)`` histograms the block-normalized magnitudes
u = |x| / absmax(block) against ``NORM_SPEC`` and accumulates E[absmax^2]
separately, the factorization the policy solver's error model rests on
(see the reference's module docstring). Without ``block`` raw magnitudes
are binned.

Parity with the reference: the bins, counts, absmax, n and nblocks are
bitwise equal (integer-valued f32 counts are exact below 2^24 per bin; the
port adds one ``bincount`` to the f32 counts, which stays exact beyond
that, where the reference's per-element f32 increments stall: ROADMAP C7).
``msq`` is an f32 sum, which XLA and torch take in different orders: equal
to a few ulps (ROADMAP C8).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.autotune.error_models import HistogramDist

__all__ = ["HistSpec", "NORM_SPEC", "empty_state", "update", "merge",
           "update_tree", "to_dist", "scale_rms", "histogram_of",
           "leaf_summary"]


@dataclasses.dataclass(frozen=True)
class HistSpec:
    """Fixed histogram geometry."""

    n_bins: int = 64
    lo_log2: float = -44.0   # below ~5e-14: counted with the zeros
    hi_log2: float = 20.0    # above ~1e6: overflow bin

    @property
    def bin_width(self) -> float:
        return (self.hi_log2 - self.lo_log2) / self.n_bins


# block-normalized magnitudes live on [0, 1]: 4 bins per octave down to 2^-16
NORM_SPEC = HistSpec(n_bins=64, lo_log2=-16.0, hi_log2=0.0)


def empty_state(spec: HistSpec = HistSpec(), device="cpu") -> dict:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"counts": z(spec.n_bins + 2), "absmax": z(), "n": z(),
            "msq": z(), "nblocks": z()}


def _f32(v: float) -> float:
    """A Python float rounded to f32 (the reference's weakly typed scalar
    constants meet f32 arrays as f32)."""
    return float(np.float32(v))


@torch.no_grad()
def update(state: dict, x, spec: HistSpec = HistSpec(),
           block: int | None = None) -> dict:
    """Fold a tensor into the state (a new state on ``x``'s device).

    With ``block`` set, magnitudes are normalized by their block's absmax
    (capped at the last dim, zero-padded like the codec) before binning:
    use ``NORM_SPEC`` then. Without it, raw magnitudes are binned. A 0-d
    input is one one-element vector (its own block)."""
    x = torch.as_tensor(x)
    state = {k: v.to(x.device) for k, v in state.items()}
    if x.ndim == 0:
        x = x.reshape(1)
    mag = x.to(torch.float32).abs()
    # sanitize first: one NaN would poison every max / sum moment; NaN
    # elements are remembered and binned as overflow below
    nan = torch.isnan(mag)
    mag = torch.where(nan, 0.0, mag)
    if block is not None:
        blk = max(1, min(int(block), mag.shape[-1]))
        pad = (-mag.shape[-1]) % blk
        m2 = mag.reshape(-1, mag.shape[-1])
        n2 = nan.reshape(-1, nan.shape[-1])
        if pad:
            m2 = torch.nn.functional.pad(m2, (0, pad))
            n2 = torch.nn.functional.pad(n2, (0, pad))
        mb = m2.reshape(m2.shape[0], -1, blk)
        am = mb.amax(dim=-1, keepdim=True)
        u = torch.where(am > 0, mb / am, 0.0)
        # padded lanes are exact zeros -> bin 0, as codec padding
        msq = state["msq"] + (am[..., 0] ** 2).sum()
        nblocks = state["nblocks"] + float(am.numel())
        absmax = torch.maximum(state["absmax"], mb.amax())
        vals = u.reshape(-1)
        nan_flat = n2.reshape(-1)
        n_new = float(mag.numel())
    else:
        vals = mag.reshape(-1)
        nan_flat = nan.reshape(-1)
        msq, nblocks = state["msq"], state["nblocks"]
        absmax = torch.maximum(state["absmax"], vals.amax())
        n_new = float(vals.numel())

    logm = torch.log2(torch.clamp_min(vals, _f32(1e-45)))
    b = torch.floor((logm - _f32(spec.lo_log2)) / _f32(spec.bin_width))
    # XLA's f32 -> int32 saturates and sends NaN to 0 (torch's cast of inf
    # or NaN is undefined): clip in f32 first
    b = torch.clamp(torch.nan_to_num(b, nan=0.0), -1, spec.n_bins).to(
        torch.int32)
    # values AT the top edge (u == 1 for every block absmax) belong to the
    # top in-range bin, not overflow
    hi_val = _f32(2.0 ** spec.hi_log2)
    b = torch.where(vals <= hi_val, torch.clamp_max(b, spec.n_bins - 1), b) + 1
    b = torch.where(vals > 0, b, 0)                  # zeros -> bin 0
    b = torch.where(nan_flat, spec.n_bins + 1, b)    # NaN -> overflow
    counts = state["counts"] + torch.bincount(
        b.to(torch.int64), minlength=spec.n_bins + 2).to(torch.float32)
    return {"counts": counts, "absmax": absmax, "n": state["n"] + n_new,
            "msq": msq, "nblocks": nblocks}


def merge(a: dict, b: dict) -> dict:
    """Combine two states (per-shard / per-client histograms add up)."""
    return {"counts": a["counts"] + b["counts"],
            "absmax": torch.maximum(a["absmax"], b["absmax"]),
            "n": a["n"] + b["n"],
            "msq": a["msq"] + b["msq"],
            "nblocks": a["nblocks"] + b["nblocks"]}


def _flatten_with_path(tree, path=()):
    """(key path, leaf) pairs of nested dicts / lists / tuples, the order
    ``jax.tree_util`` walks them in (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, path + (i,))
    elif tree is not None:
        yield path, tree


def update_tree(states: dict, tree, spec: HistSpec = NORM_SPEC,
                *, block: int | None = 128, min_size: int = 1,
                prefix: str = "") -> dict:
    """Fold every float leaf of ``tree`` (nested dicts / lists of tensors)
    into ``states`` (a dict keyed by leaf-path string, the reference's keys
    for the same tree; missing keys are created). Returns the new dict."""
    from repro_torch.autotune.policy import leaf_path_str

    out = dict(states)
    for path, leaf in _flatten_with_path(tree):
        if not hasattr(leaf, "size"):     # Python scalars, as the reference
            continue
        leaf = torch.as_tensor(leaf)
        if not (leaf.numel() >= min_size and leaf.is_floating_point()):
            continue
        key = prefix + leaf_path_str(path)
        st = out.get(key)
        out[key] = update(st if st is not None else
                          empty_state(spec, leaf.device), leaf, spec, block)
    return out


def to_dist(state: dict, spec: HistSpec = HistSpec()) -> HistogramDist:
    """Host side: state -> piecewise-uniform HistogramDist over magnitudes.

    Bin 0 (zeros + underflow) becomes a [0, 2^lo] bin; the overflow bin
    stretches to the observed absmax."""
    counts = state["counts"].detach().cpu().numpy().astype(np.float64)
    absmax = float(state["absmax"])
    total = counts.sum()
    if total <= 0:
        raise ValueError("empty calibration state")
    edges = [0.0]
    edges += [2.0 ** (spec.lo_log2 + i * spec.bin_width)
              for i in range(spec.n_bins + 1)]
    top = max(absmax, edges[-1] * 2.0)
    edges.append(top * (1.0 + 1e-9))
    return HistogramDist(edges=tuple(edges), probs=tuple(counts / total))


def scale_rms(state: dict) -> float:
    """sqrt(E[absmax_block^2]), the block-normalized model's multiplier.
    Falls back to the global absmax when no blocks were folded, or when the
    f32 second-moment accumulator saturated."""
    nb = float(state["nblocks"])
    if nb > 0:
        rms = float(np.sqrt(float(state["msq"]) / nb))
        if np.isfinite(rms):
            return rms
    return float(state["absmax"])


def histogram_of(x, spec: HistSpec = HistSpec()) -> tuple[HistogramDist, float]:
    """One-shot host convenience: (dist, absmax) of raw magnitudes."""
    x = torch.as_tensor(x)
    state = update(empty_state(spec, x.device), x, spec)
    return to_dist(state, spec), float(state["absmax"])


def leaf_summary(x, block: int = 128,
                 spec: HistSpec = NORM_SPEC) -> tuple[HistogramDist, float]:
    """One-shot host convenience for the block-normalized model:
    (dist of u = |x|/absmax_block, sqrt(E[absmax_block^2]))."""
    x = torch.as_tensor(x)
    state = update(empty_state(spec, x.device), x, spec, block)
    return to_dist(state, spec), scale_rms(state)
