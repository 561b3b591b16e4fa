"""Closed-form quantization-error models (DESIGN.md §8.1).

A copy of ``repro.autotune.error_models`` (numpy only); the port's
``sketch.choose_grid`` scores counter grids with it.

A grid format quantizes by nearest-rounding onto its sorted magnitudes
g_0 < ... < g_{K-1}; the decision boundaries are the cell edges

    e_0 = 0,  e_i = (g_{i-1} + g_i)/2,  e_K = g_{K-1}

and every x in cell_i = [e_i, e_{i+1}) maps to g_i (x > g_{K-1} clamps).
Under a piecewise-constant pdf — exact for uniform inputs, the classic
high-resolution approximation otherwise — the in-cell mean squared error has
the closed form

    E[(Q(X)-X)^2 | cell_i] = (a_i^3 + b_i^3) / (3 (a_i + b_i)),
        a_i = g_i - e_i,  b_i = e_{i+1} - g_i

so the model is

    MSE = sum_i P(cell_i) * (a_i^3 + b_i^3)/(3 w_i)  +  E[(X-g_max)^2; X>g_max]

needing only the distribution's CDF at the cell edges and one truncated
second moment for the clip/saturation tail. For discrete distributions
(Zipf) the expectation is computed exactly by direct summation instead —
no locally-uniform assumption at all.

Everything here is host-side f64 numpy: the models feed the *policy solve*
(repro.autotune.policy), not any jitted hot path. The empirical twins these
models are validated against are the f64 grid oracles in
``repro.core.quantize`` / ``repro.kernels.ref`` (tests/test_autotune.py).

Sign convention: models run on MAGNITUDES against the format's non-negative
grid. For signed formats quantizing symmetric data the sign bit is exact, so
the magnitude model IS the full model; callers with signed data pass the
distribution of |X|.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.f2p import F2PFormat

__all__ = ["Dist", "UniformDist", "LogNormalDist", "ZipfDist",
           "HistogramDist", "expected_mse", "max_rel_error", "mag_grid"]


# ---------------------------------------------------------------------------
# erf: Abramowitz & Stegun 7.1.26 (|abs err| < 1.5e-7) — keeps the module
# pure-numpy; probability errors at that scale are far below the
# locally-uniform-pdf modeling error these models carry anyway.
# ---------------------------------------------------------------------------
def _erf(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    s = np.sign(x)
    z = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * z)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * np.exp(-z * z))


def _phi(z: np.ndarray) -> np.ndarray:
    """Standard normal CDF."""
    return 0.5 * (1.0 + _erf(np.asarray(z) / np.sqrt(2.0)))


# ---------------------------------------------------------------------------
# Distribution summaries
# ---------------------------------------------------------------------------
class Dist:
    """Protocol: a non-negative input-magnitude distribution.

    Continuous subclasses implement ``cdf`` and ``tail_sq_moment``; discrete
    ones instead expose ``support`` (values, pmf) and the model sums exactly.
    All implement ``sample`` for empirical validation.
    """

    discrete = False

    def cdf(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def tail_sq_moment(self, t: float) -> float:
        """E[(X - t)^2 ; X > t] — the clip term."""
        raise NotImplementedError

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UniformDist(Dist):
    """Uniform magnitudes on [lo, hi] — 'uniform-in-range'. The in-cell
    closed form is EXACT here (constant pdf), so model vs empirical differs
    only by sampling noise."""

    lo: float = 0.0
    hi: float = 1.0

    def __post_init__(self):
        if not (0.0 <= self.lo < self.hi):
            raise ValueError(f"need 0 <= lo < hi, got [{self.lo}, {self.hi}]")

    def cdf(self, x):
        return np.clip((np.asarray(x, np.float64) - self.lo)
                       / (self.hi - self.lo), 0.0, 1.0)

    def tail_sq_moment(self, t):
        if t >= self.hi:
            return 0.0
        a = max(t, self.lo)
        return ((self.hi - t) ** 3 - (a - t) ** 3) / (3.0 * (self.hi - self.lo))

    def sample(self, rng, n):
        return rng.uniform(self.lo, self.hi, size=n)


@dataclasses.dataclass(frozen=True)
class LogNormalDist(Dist):
    """ln X ~ N(mu, sigma^2) — the short-tailed-positive shape of weight /
    delta magnitudes. Tail moments use the lognormal partial expectations

        E[X^k ; X > t] = exp(k mu + k^2 sigma^2 / 2)
                         * Phi((mu + k sigma^2 - ln t) / sigma)
    """

    mu: float = 0.0
    sigma: float = 1.0

    def cdf(self, x):
        x = np.asarray(x, np.float64)
        with np.errstate(divide="ignore"):
            z = (np.log(np.maximum(x, 0.0)) - self.mu) / self.sigma
        return np.where(x <= 0.0, 0.0, _phi(z))

    def _partial(self, k: int, t: float) -> float:
        """E[X^k ; X > t]."""
        mu, s = self.mu, self.sigma
        full = np.exp(k * mu + 0.5 * k * k * s * s)
        if t <= 0.0:
            return float(full)
        return float(full * _phi((mu + k * s * s - np.log(t)) / s))

    def tail_sq_moment(self, t):
        t = float(t)
        p_tail = 1.0 - float(self.cdf(t))
        return self._partial(2, t) - 2.0 * t * self._partial(1, t) \
            + t * t * p_tail

    def sample(self, rng, n):
        return rng.lognormal(self.mu, self.sigma, size=n)


@dataclasses.dataclass(frozen=True)
class ZipfDist(Dist):
    """Discrete heavy tail: P(X = k) ∝ k^-alpha on {1..n} (flow counts,
    token frequencies). The error model sums the expectation exactly."""

    alpha: float = 1.2
    n: int = 100_000

    discrete = True

    @functools.cached_property
    def support(self) -> tuple[np.ndarray, np.ndarray]:
        k = np.arange(1, self.n + 1, dtype=np.float64)
        w = k ** (-self.alpha)
        return k, w / w.sum()

    def cdf(self, x):
        vals, pmf = self.support
        cum = np.concatenate([[0.0], np.cumsum(pmf)])
        idx = np.clip(np.floor(np.asarray(x, np.float64)), 0, self.n)
        return cum[idx.astype(np.int64)]

    def tail_sq_moment(self, t):
        vals, pmf = self.support
        d = vals - t
        return float(np.sum(np.where(vals > t, pmf * d * d, 0.0)))

    def sample(self, rng, n):
        vals, pmf = self.support
        return rng.choice(vals, size=n, p=pmf)


@dataclasses.dataclass(frozen=True)
class HistogramDist(Dist):
    """Piecewise-uniform magnitude distribution — what streaming calibration
    (repro.autotune.calibrate) produces. ``edges`` has B+1 ascending entries
    starting at 0; ``probs`` has B entries summing to ~1."""

    edges: tuple[float, ...]
    probs: tuple[float, ...]

    def __post_init__(self):
        e = np.asarray(self.edges, np.float64)
        if len(e) != len(self.probs) + 1 or np.any(np.diff(e) <= 0):
            raise ValueError("edges must be ascending with len(probs)+1 entries")

    @functools.cached_property
    def _arr(self):
        e = np.asarray(self.edges, np.float64)
        p = np.asarray(self.probs, np.float64)
        return e, p, np.concatenate([[0.0], np.cumsum(p)])

    def cdf(self, x):
        e, p, cum = self._arr
        x = np.asarray(x, np.float64)
        j = np.clip(np.searchsorted(e, x, side="right") - 1, 0, len(p) - 1)
        w = e[j + 1] - e[j]
        frac = np.clip((x - e[j]) / w, 0.0, 1.0)
        out = cum[j] + frac * p[j]
        return np.where(x <= e[0], 0.0, np.where(x >= e[-1], cum[-1], out))

    def tail_sq_moment(self, t):
        e, p, _ = self._arr
        lo = np.maximum(e[:-1], t)
        hi = e[1:]
        dens = p / (hi - e[:-1])
        contrib = dens * ((hi - t) ** 3 - (lo - t) ** 3) / 3.0
        return float(np.sum(np.where(hi > t, contrib, 0.0)))

    def sample(self, rng, n):
        e, p, _ = self._arr
        tot = p.sum()
        j = rng.choice(len(p), size=n, p=p / tot)
        return rng.uniform(e[j], e[j + 1])


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------
def mag_grid(fmt) -> np.ndarray:
    """Sorted non-negative representable magnitudes of any grid format."""
    if isinstance(fmt, F2PFormat):
        return fmt.payload_grid
    g = np.asarray(fmt.grid, np.float64)
    return g[g >= 0.0]


def expected_mse(fmt, dist: Dist, scale: float = 1.0) -> float:
    """Closed-form expected squared quantization error of ``dist`` magnitudes
    nearest-rounded onto ``fmt``'s grid scaled by ``scale`` (blockwise absmax
    scaling multiplies the whole grid by absmax / fmt.max_value; pass that as
    ``scale``). Includes the clip term for mass beyond the scaled max."""
    g = mag_grid(fmt) * float(scale)
    if dist.discrete:
        vals, pmf = dist.support
        mid = (g[:-1] + g[1:]) / 2.0
        q = g[np.searchsorted(mid, vals, side="right")]
        d = q - vals
        return float(np.sum(pmf * d * d))
    mid = (g[:-1] + g[1:]) / 2.0
    lo_e = np.concatenate([[0.0], mid])
    hi_e = np.concatenate([mid, [g[-1]]])
    w = hi_e - lo_e
    P = dist.cdf(hi_e) - dist.cdf(lo_e)
    a = g - lo_e
    b = hi_e - g
    with np.errstate(invalid="ignore", divide="ignore"):
        percell = (a ** 3 + b ** 3) / (3.0 * w)
    percell = np.where(w > 0.0, percell, 0.0)
    return float(np.sum(P * percell) + dist.tail_sq_moment(float(g[-1])))


def max_rel_error(fmt, lo: float, hi: float, scale: float = 1.0) -> float:
    """Closed-form worst-case relative error |Q(x)-x|/x over x in [lo, hi]
    (``lo`` must be > 0 — at x -> 0+ every grid with a zero point has
    relative error 1). The paper's accuracy-over-a-selected-sub-range metric:
    within a cell the relative error is extremal at the cell edges, so the
    maximum is a scan over edge ratios, no search."""
    if not (0.0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got [{lo}, {hi}]")
    g = mag_grid(fmt) * float(scale)
    mid = (g[:-1] + g[1:]) / 2.0
    lo_e = np.concatenate([[0.0], mid])
    hi_e = np.concatenate([mid, [g[-1]]])
    xlo = np.maximum(lo_e, lo)
    xhi = np.minimum(hi_e, hi)
    live = xlo < xhi
    worst = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        r_lo = np.abs(xlo - g) / xlo   # x < g side: decreasing in x
        r_hi = np.abs(xhi - g) / xhi   # x > g side: increasing in x
    for r in (r_lo, r_hi):
        r = np.where(live & np.isfinite(r), r, 0.0)
        worst = max(worst, float(r.max()))
    if hi > g[-1]:  # clipped region: rel error grows toward (hi-gmax)/hi
        worst = max(worst, (hi - g[-1]) / hi)
    return worst
