"""Span tracer (port of ``repro.obs.trace``): nested timing spans + instant events on a wall-clock
timeline, exported as Chrome/Perfetto ``trace_event`` JSON or compact JSONL.

The event model is the Trace Event Format subset Perfetto renders natively:

* ``"X"`` complete events (a span: ``ts`` + ``dur`` in microseconds) —
  nesting is inferred from containment per ``(pid, tid)`` row;
* ``"i"`` instant events (admit/preempt/evict/... markers);
* ``"C"`` counter events (slot occupancy, pool pages — rendered as a
  stacked area track);
* ``"M"`` metadata events naming rows (``thread_name``/``process_name``),
  so per-request rows (``tid = request uid``) read as ``req 7`` instead of
  a bare number.

Timing is ``time.perf_counter_ns`` relative to tracer construction, so
traces from one process line up across rows. ``annotate=True`` additionally
enters a ``torch.profiler.record_function`` for every span so the same names
appear in the card's profile (the reference enters a
``jax.profiler.TraceAnnotation`` there).

Everything is append-to-a-list cheap; the expensive bits (JSON encoding)
happen only at export.
"""
from __future__ import annotations

import json
import time

__all__ = ["SpanTracer"]


class _Span:
    """Context manager for one ``"X"`` event. Created hot — slots only."""

    __slots__ = ("_tr", "name", "tid", "args", "_t0", "_ann")

    def __init__(self, tr: "SpanTracer", name: str, tid: int, args: dict):
        self._tr = tr
        self.name = name
        self.tid = tid
        self.args = args
        self._t0 = 0
        self._ann = None

    def __enter__(self) -> "_Span":
        if self._tr._annotate:
            self._ann = self._tr._annotation_cls(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tr = self._tr
        ev = {"name": self.name, "ph": "X", "pid": tr.pid, "tid": self.tid,
              "ts": (self._t0 - tr._t0) / 1e3,
              "dur": (t1 - self._t0) / 1e3}
        if self.args:
            ev["args"] = self.args
        tr._events.append(ev)
        return False


class SpanTracer:
    """Collects trace events; see module docstring for the event model."""

    def __init__(self, *, annotate: bool = False, pid: int = 1):
        self.pid = pid
        self._t0 = time.perf_counter_ns()
        self._events: list[dict] = []
        self._annotate = bool(annotate)
        self._annotation_cls = None
        if annotate:
            import torch.profiler

            self._annotation_cls = torch.profiler.record_function

    # -- clocks -------------------------------------------------------------
    def now_us(self) -> float:
        """Current trace timestamp (µs since tracer construction)."""
        return (time.perf_counter_ns() - self._t0) / 1e3

    def ts_of(self, t_ns: int) -> float:
        """Convert a raw ``perf_counter_ns`` sample to a trace timestamp."""
        return (t_ns - self._t0) / 1e3

    # -- event emitters -----------------------------------------------------
    def span(self, name: str, *, tid: int = 0, **args) -> _Span:
        return _Span(self, name, tid, args)

    def instant(self, name: str, *, tid: int = 0, ts_us: float | None = None,
                **args) -> None:
        ev = {"name": name, "ph": "i", "s": "t", "pid": self.pid, "tid": tid,
              "ts": self.now_us() if ts_us is None else ts_us}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 tid: int = 0, **args) -> None:
        """Retroactive ``"X"`` span — for intervals whose endpoints were
        sampled earlier (per-request TTFT/decode windows emitted at
        retirement)."""
        ev = {"name": name, "ph": "X", "pid": self.pid, "tid": tid,
              "ts": ts_us, "dur": max(dur_us, 0.0)}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, name: str, *, tid: int = 0, ts_us: float | None = None,
                **series) -> None:
        self._events.append(
            {"name": name, "ph": "C", "pid": self.pid, "tid": tid,
             "ts": self.now_us() if ts_us is None else ts_us,
             "args": {k: float(v) for k, v in series.items()}})

    # -- row naming ---------------------------------------------------------
    def thread_name(self, tid: int, name: str) -> None:
        self._events.append(
            {"name": "thread_name", "ph": "M", "pid": self.pid, "tid": tid,
             "ts": 0, "args": {"name": name}})

    def process_name(self, name: str) -> None:
        self._events.append(
            {"name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
             "ts": 0, "args": {"name": name}})

    # -- export -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> list[dict]:
        return self._events

    def to_chrome(self) -> dict:
        """The JSON-object form Perfetto / ``chrome://tracing`` load
        directly."""
        return {"traceEvents": list(self._events), "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def write_jsonl(self, path: str) -> None:
        """Compact one-event-per-line form for grep/stream processing."""
        with open(path, "w") as f:
            for ev in self._events:
                f.write(json.dumps(ev, separators=(",", ":")) + "\n")

    def summary(self) -> dict:
        """Per-name aggregate (count, total µs) — what ``obs.export()``
        embeds so metrics snapshots carry a trace digest."""
        agg: dict[str, dict] = {}
        for ev in self._events:
            if ev["ph"] != "X":
                continue
            a = agg.setdefault(ev["name"], {"count": 0, "total_us": 0.0})
            a["count"] += 1
            a["total_us"] += ev["dur"]
        return {"n_events": len(self._events), "spans": agg}
