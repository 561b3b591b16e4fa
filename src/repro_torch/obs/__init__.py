"""`repro_torch.obs` — the port of `repro.obs`: self-hosted observability
with F2P-backed metrics registries, span tracing, and one process-wide
export (DESIGN.md §13).

Two independent planes:

* **Metrics** are always on and engine-owned: each instrumented subsystem
  (``serve.batched``, ``fl.fleet``, ``sketch.ingest``...) constructs its own
  :class:`MetricsRegistry`, which self-registers in a process-wide weak
  collection; :func:`export` snapshots them all. Counters buffer O(1) on the
  hot path and fold into F2P cells lazily — cheap enough to leave on.
* **Tracing** is opt-in global state, armed with :func:`enable` — the same
  discipline as ``faults.crashpoint``: module state is a single
  ``Obs | None``, so the disabled cost of every instrumentation site is one
  ``is None`` probe and the module-level :func:`span` / :func:`instant`
  helpers are no-ops returning a shared null context.

Usage::

    from repro_torch import obs

    obs.enable()                 # arm tracing (annotate=True: torch.profiler)
    with obs.span("prefill", req=uid):
        ...
    obs.instant("evict", uid=uid)
    snap = obs.export()                # all registries + trace summary
    obs.get().tracer.write_chrome("out.trace.json")
    obs.disable()

``FlowStats`` / ``ExpertLoadTracker`` (the old telemetry trackers, rebuilt on
obs primitives) are re-exported here and from ``repro_torch.telemetry``.
"""
from __future__ import annotations

from repro_torch.obs.compat import ExpertLoadTracker, FlowStats
from repro_torch.obs.metrics import (Counter, CounterVector, Gauge, Histogram,
                               MetricsRegistry, all_registries)
from repro_torch.obs.trace import SpanTracer

__all__ = ["Counter", "CounterVector", "Gauge", "Histogram",
           "MetricsRegistry", "SpanTracer", "FlowStats", "ExpertLoadTracker",
           "all_registries", "enable", "disable", "enabled", "get", "span",
           "instant", "counter_event", "export"]


class Obs:
    """Armed observability state: the live tracer (None = metrics-only)."""

    def __init__(self, *, trace: bool = True, annotate: bool = False,
                 pid: int = 1):
        self.tracer = (SpanTracer(annotate=annotate, pid=pid)
                       if trace else None)


_STATE: Obs | None = None


class _NullCtx:
    """Shared no-op context returned by the disabled-path span helper."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


def enable(*, trace: bool = True, annotate: bool = False,
           pid: int = 1) -> Obs:
    """Arm global tracing. Idempotent-ish: re-arming replaces the tracer
    (a fresh timeline)."""
    global _STATE
    _STATE = Obs(trace=trace, annotate=annotate, pid=pid)
    return _STATE


def disable() -> None:
    global _STATE
    _STATE = None


def enabled() -> bool:
    return _STATE is not None


def get() -> Obs | None:
    return _STATE


def span(name: str, *, tid: int = 0, **args):
    """``with obs.span("prefill", req=uid):`` — a timed span when tracing is
    armed, a shared null context (one ``is None`` probe) when not."""
    s = _STATE
    if s is None or s.tracer is None:
        return _NULL
    return s.tracer.span(name, tid=tid, **args)


def instant(name: str, *, tid: int = 0, **args) -> None:
    s = _STATE
    if s is None or s.tracer is None:
        return
    s.tracer.instant(name, tid=tid, **args)


def counter_event(name: str, *, tid: int = 0, **series) -> None:
    s = _STATE
    if s is None or s.tracer is None:
        return
    s.tracer.counter(name, tid=tid, **series)


def export(*, buckets: bool = False) -> dict:
    """One snapshot of everything: every live registered
    :class:`MetricsRegistry` by name, plus a trace digest when tracing is
    armed."""
    out = {"registries": {name: reg.export(buckets=buckets)
                          for name, reg in sorted(all_registries().items())},
           "trace": None}
    s = _STATE
    if s is not None and s.tracer is not None:
        out["trace"] = s.tracer.summary()
    return out
