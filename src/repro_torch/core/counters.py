"""Approximate counters (paper Sec. III-A): F2P-LI counters vs Morris / CEDAR /
dynamic SEAD, evaluated under the on-arrival model.

A copy of ``repro.core.counters`` (numpy only): the port imports nothing of
the JAX package. ``CounterArray`` is the host oracle the port's device
advance (``kernels.f2p_counter``) is held against.

Every counter here is a *grid counter*: an N-bit register indexes into a
monotone estimate grid L[0..K-1] (L[0] = 0). Upon an arrival at state k the
register advances to k+1 with probability

    p_k = 1 / (L[k+1] - L[k])

which makes the expected estimate increase per arrival exactly 1 (unbiased).
This subsumes:
  - F2P_LI / F2P_SI : grid = the format's integer grid
  - Morris          : L_c = a ((1+1/a)^c - 1)
  - CEDAR           : L_i = ((1+2 delta^2)^i - 1) / (2 delta^2)
  - dynamic SEAD    : unary-exponent grid (formats.SEADFormat)

On-arrival MSE after S arrivals: (1/S) sum_{i=1..S} (C_i - i)^2 where C_i is
the estimate right after the i-th arrival. The simulator draws the geometric
sojourn time of every state at once and uses the closed form

    sum_{i=a..b} (c - i)^2 = F(c-a) - F(c-b-1),   F(n) = n(n+1)(2n+1)/6

so a whole S-arrival run costs O(K) regardless of S.
"""
from __future__ import annotations

import numpy as np

__all__ = ["morris_grid", "cedar_grid", "sead_grid", "f2p_li_grid",
           "on_arrival_mse", "tune_morris", "tune_cedar", "CounterArray"]


# ---------------------------------------------------------------------------
# Estimate grids
# ---------------------------------------------------------------------------
def f2p_li_grid(n_bits: int, h_bits: int = 2) -> np.ndarray:
    from repro_torch.core.f2p import F2PFormat, Flavor

    return F2PFormat(n_bits=n_bits, h_bits=h_bits, flavor=Flavor.LI).payload_grid


def f2p_si_grid(n_bits: int, h_bits: int = 2) -> np.ndarray:
    from repro_torch.core.f2p import F2PFormat, Flavor

    return F2PFormat(n_bits=n_bits, h_bits=h_bits, flavor=Flavor.SI).payload_grid


def morris_grid(n_bits: int, a: float) -> np.ndarray:
    """Morris'78 counter: estimate after c increments is a((1+1/a)^c - 1).

    Extreme ``a`` (tune_morris bisection probes) overflow the exponential;
    those entries clamp to the largest finite float64 — the grid saturates
    there instead of going inf (inf gaps turn downstream ``on_arrival_mse``
    sums into silent NaN)."""
    c = np.arange(1 << n_bits, dtype=np.float64)
    with np.errstate(over="ignore"):  # extreme `a` during tuning -> clamp
        g = a * (np.exp(np.log1p(1.0 / a) * c) - 1.0)
    return np.minimum(g, np.finfo(np.float64).max)


def cedar_grid(n_bits: int, delta: float) -> np.ndarray:
    """CEDAR (Tsidon et al., INFOCOM'12): L_i = ((1+2d^2)^i - 1)/(2d^2).

    Overflowing entries clamp to the largest finite float64 (see
    ``morris_grid``)."""
    i = np.arange(1 << n_bits, dtype=np.float64)
    d2 = 2.0 * delta * delta
    with np.errstate(over="ignore"):  # extreme delta during tuning -> clamp
        g = (np.exp(np.log1p(d2) * i) - 1.0) / d2
    return np.minimum(g, np.finfo(np.float64).max)


def sead_grid(n_bits: int) -> np.ndarray:
    from repro_torch.core.formats import SEADFormat

    return SEADFormat(n_bits=n_bits).grid


# ---------------------------------------------------------------------------
# On-arrival simulation
# ---------------------------------------------------------------------------
def _sq_sum(c: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """sum_{i=a..b} (c-i)^2 elementwise; 0 where b < a."""

    def F(n):
        return n * (n + 1.0) * (2.0 * n + 1.0) / 6.0

    hi = c - a
    lo = c - b - 1.0
    # lanes with b < a are masked out below; on overflow-clamped grids their
    # F() intermediates can overflow/NaN before the mask applies
    with np.errstate(over="ignore", invalid="ignore"):
        out = F(hi) - F(lo)
    return np.where(b < a, 0.0, out)


def on_arrival_mse(grid: np.ndarray, n_arrivals: int, *, trials: int = 16,
                   seed: int = 0) -> float:
    """Mean on-arrival MSE of a grid counter over `trials` independent runs."""
    g = np.asarray(grid, dtype=np.float64)
    gaps = np.diff(g)
    if np.any(gaps < 0):
        raise ValueError("grid must be non-decreasing")
    if np.any(gaps == 0):
        # overflow-clamped tail (morris/cedar under extreme tuning params):
        # the counter can never leave the first clamped state, so the grid
        # truncates there — the saturation branch below covers the rest
        cut = int(np.argmax(gaps == 0))
        if np.any(np.diff(g[cut:]) != 0):
            raise ValueError("grid must be strictly increasing away from a "
                             "saturated (clamped) tail")
        g, gaps = g[:cut + 1], gaps[:cut]
        if len(gaps) == 0:
            raise ValueError("grid saturates at its first state")
    p = np.minimum(1.0 / gaps, 1.0)
    rng = np.random.default_rng(seed)
    K = len(gaps)
    total = 0.0
    for _ in range(trials):
        # sojourn (number of arrivals spent) at each state before advancing
        t = rng.geometric(p).astype(np.float64)  # shape (K,)
        ends = np.cumsum(t)                      # arrival index of transition OUT of k
        starts = ends - t + 1.0                  # first arrival index at state k
        # clip the run at n_arrivals
        s = np.minimum(starts, n_arrivals + 1.0)
        e = np.minimum(ends, float(n_arrivals))
        # arrivals s..e-1 at state k leave estimate g[k]; arrival `ends` (if
        # within budget) bumps it to g[k+1]
        err = _sq_sum(g[:-1], s, np.minimum(e, ends - 1.0))
        bumped = ends <= n_arrivals
        with np.errstate(over="ignore"):  # unreachable clamped-top squares
            err += np.where(bumped, (g[1:] - ends) ** 2, 0.0)
        # if the counter saturates before n_arrivals, remaining arrivals sit at g[-1]
        used = ends[-1]
        if used < n_arrivals:
            err_sat = _sq_sum(np.float64(g[-1]), used + 1.0, np.float64(n_arrivals))
            total += err_sat
        total += float(err.sum())
    return total / (trials * n_arrivals)


# ---------------------------------------------------------------------------
# Baseline tuning (paper: "binary search for the configuration parameters that
# minimize the error while still reaching the maximal number that F2P reaches")
# ---------------------------------------------------------------------------
def tune_morris(n_bits: int, target_max: float, iters: int = 60) -> float:
    """Largest `a` (lowest error) such that the Morris counter still reaches
    target_max."""
    lo, hi = 1e-6, 1e12
    for _ in range(iters):
        mid = np.sqrt(lo * hi)
        if morris_grid(n_bits, mid)[-1] >= target_max:
            lo = mid
        else:
            hi = mid
    return lo


def tune_cedar(n_bits: int, target_max: float, iters: int = 60) -> float:
    """Smallest `delta` (lowest error) such that CEDAR reaches target_max."""
    lo, hi = 1e-9, 10.0
    for _ in range(iters):
        mid = np.sqrt(lo * hi)
        if cedar_grid(n_bits, mid)[-1] >= target_max:
            hi = mid
        else:
            lo = mid
    return hi


# ---------------------------------------------------------------------------
# Vectorized counter arrays — the telemetry building block. Thousands of
# concurrent counters (flow table / per-expert token counts) updated in bulk.
# ---------------------------------------------------------------------------
class CounterArray:
    """An array of independent grid counters with batched probabilistic updates.

    This is the object the framework's telemetry layer uses (MoE expert-load,
    pipeline flow stats): an (num_counters,)-shaped uint register array over a
    shared estimate grid — 8/16-bit registers tracking counts up to the grid
    max (billions for F2P_LI^2@16)."""

    def __init__(self, num: int, grid: np.ndarray, seed: int = 0):
        self.grid = np.asarray(grid, dtype=np.float64)
        self.gaps = np.diff(self.grid)
        self.state = np.zeros(num, dtype=np.int64)
        self.rng = np.random.default_rng(seed)

    def add(self, idx: np.ndarray, amounts: np.ndarray | None = None) -> None:
        """Record one arrival (or `amounts` arrivals) at each counter in idx."""
        idx = np.asarray(idx)
        amounts = np.ones(len(idx), dtype=np.int64) if amounts is None else np.asarray(amounts)
        for i, n in zip(idx, amounts):
            k = self.state[i]
            remaining = int(n)
            while remaining > 0 and k < len(self.gaps):
                gap = self.gaps[k]
                p = min(1.0 / gap, 1.0)
                # arrivals needed to advance ~ Geometric(p); consume in bulk.
                # A sojourn exceeding the budget means no advance happens
                # within it — stop (an extra Bernoulli here would double-count
                # the escape probability: P(advance) must stay 1-(1-p)^n).
                need = self.rng.geometric(p)
                if need > remaining:
                    remaining = 0
                else:
                    remaining -= int(need)
                    k += 1
            self.state[i] = k

    def estimates(self) -> np.ndarray:
        return self.grid[self.state]
