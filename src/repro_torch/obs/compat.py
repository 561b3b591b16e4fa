"""Drop-in rebuilds of the original telemetry trackers on top of the obs
metric primitives (port of ``repro.obs.compat``, unchanged).

``FlowStats`` and ``ExpertLoadTracker`` hand-rolled one F2P ``CounterArray``
each; here they are thin wrappers over a private :class:`MetricsRegistry`
(one :class:`CounterVector` per tracker) so there is exactly one grid-counter
implementation in the tree. Public APIs are unchanged — ``snapshot()`` /
``loads()`` still return F2P *estimates*, matching the originals — and the
registries are private (``register=False``): ad-hoc trackers don't pollute
the process-wide ``obs.export()``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["ExpertLoadTracker", "FlowStats"]


class ExpertLoadTracker:
    """Per-expert token-load counters for MoE routing (fed from the `load`
    aux output of moe_apply)."""

    def __init__(self, n_experts: int, n_bits: int = 16, seed: int = 0):
        self.n_experts = int(n_experts)
        self._reg = MetricsRegistry(f"telemetry.expert_load@{id(self):x}",
                                    n_bits=n_bits, seed=seed, register=False)
        self._vec = self._reg.counter_vector("load", self.n_experts)

    def update(self, load: np.ndarray) -> None:
        load = np.asarray(load, dtype=np.int64)
        idx = np.nonzero(load > 0)[0]
        self._vec.add(idx, load[idx])

    def loads(self) -> np.ndarray:
        return self._vec.estimates()

    def imbalance(self) -> float:
        est = self.loads()
        mean = est.mean() if est.size else 0.0
        return float(est.max() / mean) if mean > 0 else 0.0


class FlowStats:
    """Named flow counters (tokens in, tokens padded, examples dropped...)."""

    def __init__(self, names, n_bits: int = 16, seed: int = 1):
        self.names = list(names)
        self._reg = MetricsRegistry(f"telemetry.flow@{id(self):x}",
                                    n_bits=n_bits, seed=seed, register=False)
        self._vec = self._reg.counter_vector("flows", len(self.names))

    def add(self, name: str, amount: int = 1) -> None:
        i = self.names.index(name)
        self._vec.add(np.array([i]), np.array([amount]))

    def snapshot(self) -> dict:
        est = self._vec.estimates()
        return dict(zip(self.names, est.tolist()))
