"""Telemetry: F2P-LI counter trackers and sketch heavy-hitter recovery (port
of ``repro.telemetry``). ``FlowStats`` / ``ExpertLoadTracker`` live in
:mod:`repro_torch.obs` and are re-exported here;
``HeavyHitterTable`` / ``HeavyHittersReport`` are the reference's numpy.
"""
from __future__ import annotations

from repro_torch.obs.compat import ExpertLoadTracker, FlowStats
from repro_torch.telemetry.heavy_hitters import (HeavyHittersReport,
                                                 HeavyHitterTable)

__all__ = ["ExpertLoadTracker", "FlowStats", "HeavyHitterTable",
           "HeavyHittersReport"]
