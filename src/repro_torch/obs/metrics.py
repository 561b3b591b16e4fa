"""F2P-backed metrics registry (DESIGN.md §13): named counters, gauges and
log-bucketed histograms whose storage cells are F2P grid counters.

Port of ``repro.obs.metrics``: the host path is the reference's numpy,
copied; device-side histogram observes take torch tensors, and a registry
given ``device=`` advances its cells with the port's ``counter_advance``
(the B9 kernel on the card).

The paper's headline use case is *measurement* — F2P exists so counters stay
accurate across huge counting ranges at narrow register width — so the
runtime's own metrics dogfood it: every counter and histogram bucket in a
:class:`MetricsRegistry` is one cell of a shared F2P_LI grid-counter bank
(the same estimate-grid construction as :mod:`repro_torch.core.counters` and the
``counter_advance`` kernels), advanced by the exact-in-distribution bulk
process.

Update discipline (the reason the enabled path stays off the hot path):

* increments and observations only *buffer* — a counter ``inc`` is one float
  add into a pending-budget lane, a host histogram ``observe`` is a
  ``searchsorted``+``bincount`` into the same lanes, and a **device**
  histogram observe (a torch tensor) stays a device-side
  ``searchsorted``+``index_add_``+sum whose (tiny) results are parked
  un-synced, exactly like the sketch's arrival tally;
* the stochastic F2P advance runs only at :meth:`MetricsRegistry.sync` (or
  lazily on first read/export), over the whole cell bank in one vectorized
  sweep — bulk budgets consume geometric sojourns exactly as if the arrivals
  had been applied one by one, so batching changes nothing in distribution;
* every cell keeps an *exact* float64 shadow alongside the F2P register —
  the compatibility oracle (``BatchedEngine.stats`` promises exact counts)
  and the self-reported accuracy check (``export`` carries both, so the
  narrow-register error is measured, never assumed).

The advance itself runs on the host by default (a float64 numpy twin of the
kernel ``_sweep``, no f32 budget ceiling); ``device="cuda"`` routes it
through ``kernels.f2p_counter.counter_advance`` instead — the deployment
shape where the register bank is advanced device-side.

Registries register themselves in a process-wide weak collection keyed by
name so :func:`repro_torch.obs.export` can snapshot every live subsystem in one
call; pass ``register=False`` for a private one.
"""
from __future__ import annotations

import math
import threading
import weakref

import numpy as np
import torch

from repro_torch.core.counters import f2p_li_grid
from repro_torch.kernels import f2p_counter as FC

__all__ = ["Counter", "CounterVector", "Gauge", "Histogram",
           "MetricsRegistry", "all_registries", "advance_host"]

# process-wide registry collection (weak: a registry dies with its owner;
# name collisions replace — "the latest engine wins" for export purposes)
_ALL: "weakref.WeakValueDictionary[str, MetricsRegistry]" = \
    weakref.WeakValueDictionary()
_ALL_LOCK = threading.Lock()


def all_registries() -> dict[str, "MetricsRegistry"]:
    """Snapshot of every live registered :class:`MetricsRegistry` by name."""
    with _ALL_LOCK:
        return dict(_ALL)


# ---------------------------------------------------------------------------
# Host advance: float64 numpy twin of kernels.f2p_counter._sweep
# ---------------------------------------------------------------------------
def advance_host(state: np.ndarray, budget: np.ndarray, p: np.ndarray,
                 run: np.ndarray, logq: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
    """Consume per-cell arrival ``budget`` by the sequential stochastic
    process, vectorized over cells — same math as the device kernels (unit
    runs crossed in one step, geometric sojourns by inverse CDF), but in
    float64 so there is no f32-exactness budget ceiling."""
    state = np.asarray(state, np.int64).copy()
    rem = np.asarray(budget, np.float64).copy()
    p = np.asarray(p, np.float64)
    run = np.asarray(run, np.float64)
    logq = np.asarray(logq, np.float64)
    kmax = len(p) - 1
    while True:
        live = rem > 0
        if not live.any():
            break
        r = np.minimum(rem, run[state])
        state = state + r.astype(np.int64)
        rem = rem - r
        u = rng.random(state.shape)
        pk = p[state]
        with np.errstate(divide="ignore", invalid="ignore"):
            need = np.ceil(np.log(u) / logq[state])
        need = np.where(pk >= 1.0, 1.0, need)
        need = np.where(pk <= 0.0, np.inf, need)
        need = np.maximum(need, 1.0)
        adv = need <= rem
        state = np.where(adv, np.minimum(state + 1, kmax), state)
        rem = np.where(adv, rem - need, 0.0)
    return state


# ---------------------------------------------------------------------------
# Metric handles (thin views over the registry's shared lanes)
# ---------------------------------------------------------------------------
class Counter:
    """A named monotone counter: one F2P cell + one exact shadow lane."""

    __slots__ = ("name", "_reg", "_i")

    def __init__(self, name: str, reg: "MetricsRegistry", i: int):
        self.name, self._reg, self._i = name, reg, i

    def inc(self, n: float = 1) -> None:
        r = self._reg
        r._budget[self._i] += n
        r._exact[self._i] += n
        r._dirty = True

    @property
    def exact(self) -> int:
        """Exact count (the compatibility/oracle value)."""
        return int(self._reg._exact[self._i])

    def estimate(self) -> float:
        """The F2P register's estimate (syncs pending budget first)."""
        r = self._reg
        r.sync()
        return float(r.grid[r._state[self._i]])


class CounterVector:
    """``n`` parallel counters under one name (per-expert loads, per-class
    tallies): indexed bulk adds, vectorized estimates."""

    __slots__ = ("name", "n", "_reg", "_base")

    def __init__(self, name: str, n: int, reg: "MetricsRegistry", base: int):
        self.name, self.n, self._reg, self._base = name, int(n), reg, base

    def add(self, idx: np.ndarray, amounts: np.ndarray | None = None) -> None:
        idx = np.asarray(idx, np.int64)
        amounts = (np.ones(idx.shape, np.float64) if amounts is None
                   else np.asarray(amounts, np.float64))
        r = self._reg
        np.add.at(r._budget, self._base + idx, amounts)
        np.add.at(r._exact, self._base + idx, amounts)
        r._dirty = True

    @property
    def exact(self) -> np.ndarray:
        s = slice(self._base, self._base + self.n)
        return self._reg._exact[s].copy()

    def estimates(self) -> np.ndarray:
        r = self._reg
        r.sync()
        s = slice(self._base, self._base + self.n)
        return r.grid[r._state[s]]


class Gauge:
    """Last-value metric (occupancy, loss, pool pages). Not a count — no F2P
    cell; gauges are plain float64 (the paper's counters count arrivals)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Log-bucketed value/latency histogram over F2P counter cells.

    Buckets are geometric between ``lo`` and ``hi`` (``per_decade`` per
    decade) plus underflow/overflow cells. ``observe`` takes a scalar or an
    array; numpy input buckets on the host, a torch tensor buckets on its
    device in one searchsorted+index_add_ whose per-call results park
    un-synced until :meth:`MetricsRegistry.sync` — an enabled
    device-fed histogram adds no host round-trip to the step that feeds it.
    """

    __slots__ = ("name", "edges", "_reg", "_base", "_n", "_sum", "_dev_edges",
                 "_dev_pending")

    def __init__(self, name: str, reg: "MetricsRegistry", base: int,
                 edges: np.ndarray):
        self.name, self._reg, self._base = name, reg, base
        self.edges = np.asarray(edges, np.float64)
        self._n = len(self.edges) + 1          # + underflow & overflow
        self._sum = 0.0
        self._dev_edges: dict = {}
        self._dev_pending: list = []

    # -- ingest -------------------------------------------------------------
    def observe(self, values) -> None:
        if isinstance(values, torch.Tensor):
            self._observe_device(values)
            return
        v = np.asarray(values, np.float64).reshape(-1)
        if v.size == 0:
            return
        r = self._reg
        idx = np.searchsorted(self.edges, v, side="right")
        cnt = np.bincount(idx, minlength=self._n).astype(np.float64)
        r._budget[self._base:self._base + self._n] += cnt
        r._exact[self._base:self._base + self._n] += cnt
        self._sum += float(v.sum())
        r._dirty = True

    def _observe_device(self, values: torch.Tensor) -> None:
        edges = self._dev_edges.get(values.device)
        if edges is None:
            edges = torch.tensor(self.edges, dtype=torch.float32,
                                 device=values.device)
            self._dev_edges[values.device] = edges
        x = values.reshape(-1).to(torch.float32)
        idx = torch.searchsorted(edges, x, right=True)
        # index_add_, not bincount: on CUDA bincount reads the max back to
        # size its output, a host sync
        cnt = torch.zeros(self._n, dtype=torch.int64, device=x.device)
        cnt.index_add_(0, idx, torch.ones_like(idx))
        self._dev_pending.append((cnt, x.sum(dtype=torch.float32)))
        self._reg._dirty = True

    def drain_pending(self) -> None:
        """Fold parked device-side bucket results into the host buffers
        (the lazy host sync; called by ``MetricsRegistry.sync``)."""
        if not self._dev_pending:
            return
        r = self._reg
        for cnt, s in self._dev_pending:
            c = cnt.cpu().numpy().astype(np.float64)
            r._budget[self._base:self._base + self._n] += c
            r._exact[self._base:self._base + self._n] += c
            self._sum += float(s)
        self._dev_pending = []

    # -- reads --------------------------------------------------------------
    def counts(self, *, exact: bool = False) -> np.ndarray:
        """Per-bucket counts ``[underflow, b_0, ..., b_{n-1}, overflow]`` —
        F2P estimates by default, the exact shadow with ``exact=True``."""
        r = self._reg
        r.sync()
        s = slice(self._base, self._base + self._n)
        return r._exact[s].copy() if exact else r.grid[r._state[s]]

    @property
    def count(self) -> int:
        self._reg.sync()
        s = slice(self._base, self._base + self._n)
        return int(self._reg._exact[s].sum())

    @property
    def sum(self) -> float:
        self._reg.sync()
        return self._sum

    @property
    def mean(self) -> float:
        c = self.count
        return self._sum / c if c else 0.0

    def quantile(self, q: float, *, exact: bool = False) -> float:
        """Quantile estimate from the (F2P-estimated) bucket counts, with
        log-linear interpolation inside the winning bucket."""
        c = self.counts(exact=exact)
        total = c.sum()
        if total <= 0:
            return 0.0
        target = min(max(q, 0.0), 1.0) * total
        cum = np.cumsum(c)
        b = int(np.searchsorted(cum, target))
        if b == 0:                               # underflow bucket
            return float(self.edges[0])
        if b >= self._n - 1:                     # overflow bucket
            return float(self.edges[-1])
        lo, hi = self.edges[b - 1], self.edges[b]
        prev = cum[b - 1]
        frac = (target - prev) / max(c[b], 1e-30)
        return float(lo * (hi / lo) ** min(max(frac, 0.0), 1.0))


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------
class MetricsRegistry:
    """A named bank of F2P grid-counter cells behind counters/gauges/
    histograms. See module docstring for the update discipline."""

    def __init__(self, name: str, *, n_bits: int = 16, h_bits: int = 2,
                 seed: int = 0, device=None,
                 register: bool = True):
        self.name = name
        self.n_bits, self.h_bits = int(n_bits), int(h_bits)
        self.grid = np.asarray(f2p_li_grid(n_bits, h_bits), np.float64)
        self._p, self._run, self._logq = FC.advance_tables(self.grid)
        self._state = np.zeros(0, np.int64)
        self._budget = np.zeros(0, np.float64)
        self._exact = np.zeros(0, np.float64)
        self._dirty = False
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)
        # None = host numpy advance; else counter_advance on this device
        self._device = None if device is None else torch.device(device)
        self._metrics: dict[str, object] = {}
        if register:
            with _ALL_LOCK:
                _ALL[name] = self

    # -- registration -------------------------------------------------------
    def _grow(self, n: int) -> int:
        base = len(self._state)
        self._state = np.concatenate([self._state, np.zeros(n, np.int64)])
        self._budget = np.concatenate([self._budget, np.zeros(n)])
        self._exact = np.concatenate([self._exact, np.zeros(n)])
        return base

    def _register(self, name: str, m):
        if name in self._metrics:
            raise ValueError(f"metric {name!r} already registered in "
                             f"registry {self.name!r}")
        self._metrics[name] = m
        return m

    def counter(self, name: str) -> Counter:
        m = self._metrics.get(name)
        if isinstance(m, Counter):
            return m
        return self._register(name, Counter(name, self, self._grow(1)))

    def counter_vector(self, name: str, n: int) -> CounterVector:
        m = self._metrics.get(name)
        if isinstance(m, CounterVector):
            return m
        return self._register(name,
                              CounterVector(name, n, self, self._grow(n)))

    def gauge(self, name: str) -> Gauge:
        m = self._metrics.get(name)
        if isinstance(m, Gauge):
            return m
        return self._register(name, Gauge(name))

    def histogram(self, name: str, lo: float, hi: float, *,
                  per_decade: int = 8) -> Histogram:
        m = self._metrics.get(name)
        if isinstance(m, Histogram):
            return m
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
        decades = math.log10(hi) - math.log10(lo)   # hi/lo can overflow f64
        n_edges = max(2, int(round(decades * per_decade)) + 1)
        edges = np.geomspace(lo, hi, n_edges)
        base = self._grow(len(edges) + 1)
        return self._register(name, Histogram(name, self, base, edges))

    def __getitem__(self, name: str):
        return self._metrics[name]

    def get(self, name: str):
        return self._metrics.get(name)

    # -- sync & lifecycle ---------------------------------------------------
    def sync(self) -> None:
        """Fold every pending budget into the F2P cells: drain parked
        device-side histogram results, then one vectorized bulk advance over
        the whole bank (host float64 twin by default, ``counter_advance`` on
        the registry's device when one is given)."""
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                m.drain_pending()
        if not self._dirty:
            return
        if self._device is None:
            self._state = advance_host(self._state, self._budget, self._p,
                                       self._run, self._logq, self._rng)
        else:
            self._device_advance()
        self._budget[:] = 0.0
        self._dirty = False

    def _device_advance(self) -> None:
        dev = self._device
        luts = [torch.from_numpy(t).to(dev)
                for t in (self._p, self._run, self._logq)]
        state = torch.from_numpy(self._state.astype(np.int32)).to(dev)
        budget = self._budget.copy()
        # the kernel's budget arithmetic is f32: chunk past the ceiling, and
        # feed the leftover of each fixed-sweep call into the next
        while (budget > 0).any():
            step = np.minimum(budget, float(FC.MAX_EXACT_BUDGET - 1))
            seed = int(self._rng.integers(0, 1 << 32, dtype=np.uint64))
            state, left = FC.counter_advance(
                state, torch.from_numpy(step.astype(np.float32)).to(dev),
                *luts, seed)
            budget -= step - left.cpu().numpy().astype(np.float64)
        self._state = state.cpu().numpy().astype(np.int64)

    def reset(self) -> None:
        """Zero every cell, shadow, pending buffer and gauge (a fresh run)."""
        self._state[:] = 0
        self._budget[:] = 0.0
        self._exact[:] = 0.0
        self._dirty = False
        self._rng = np.random.default_rng(self._seed)
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                m._sum = 0.0
                m._dev_pending = []
            elif isinstance(m, Gauge):
                m._v = 0.0

    # -- export -------------------------------------------------------------
    def export(self, *, buckets: bool = False) -> dict:
        """JSON-friendly snapshot: counters carry both the F2P estimate and
        the exact shadow (the register-width error is reported, not
        assumed); histograms carry count/sum/mean and p50/p90/p99."""
        self.sync()
        out: dict = {"n_bits": self.n_bits, "h_bits": self.h_bits,
                     "counters": {}, "gauges": {}, "histograms": {},
                     "counter_vectors": {}}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out["counters"][name] = {"exact": m.exact,
                                         "estimate": m.estimate()}
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            elif isinstance(m, CounterVector):
                out["counter_vectors"][name] = {
                    "exact": m.exact.tolist(),
                    "estimate": m.estimates().tolist()}
            elif isinstance(m, Histogram):
                h = {"count": m.count, "sum": m.sum, "mean": m.mean,
                     "p50": m.quantile(0.5), "p90": m.quantile(0.9),
                     "p99": m.quantile(0.99)}
                if buckets:
                    h["edges"] = m.edges.tolist()
                    h["bucket_counts"] = m.counts().tolist()
                out["histograms"][name] = h
        return out
