"""Fault injection mechanics (port of ``repro.faults.inject``): crash
points, wire-payload corruption and the serve-engine wrapper.

Everything here WRAPS the system under test: the FL round driver folds
corrupted copies, ``crashpoint`` is a no-op dict probe unless a plan is
installed, and ``wrap_engine`` proxies ``serve.Engine``, so the hot paths
(the client round, the engine's steps, the checkpoint writer's data loop)
carry no fault logic at all. The checkpoint writer calls ``crashpoint``
between writing ``data.bin`` and the commit, so a test can show that a
crash there leaves no committed step.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch.faults.plan import FaultPlan

__all__ = ["CrashInjected", "TransientServeError", "DroppedRequest",
           "crashpoint", "install", "uninstall", "active", "corrupt_update",
           "FaultyEngine", "wrap_engine"]


class CrashInjected(RuntimeError):
    """Raised at an armed crash point (simulates the process dying there)."""


class TransientServeError(RuntimeError):
    """Retryable serve failure (injected): caller may retry the request."""


class DroppedRequest(RuntimeError):
    """The request was lost (injected): no response will ever arrive."""


# ---------------------------------------------------------------------------
# Crash points
# ---------------------------------------------------------------------------
# name -> remaining fires; None when no plan installed (one `is None` check
# on the production path)
_ARMED: dict[str, int] | None = None


def install(plan: FaultPlan) -> None:
    """Arm ``plan.crash_points`` (each fires once, then disarms)."""
    global _ARMED
    _ARMED = {name: 1 for name in plan.crash_points}


def uninstall() -> None:
    global _ARMED
    _ARMED = None


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Context manager: crash points armed inside, always disarmed after."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def crashpoint(name: str) -> None:
    """Raise :class:`CrashInjected` if ``name`` is armed."""
    if _ARMED is None:
        return
    if _ARMED.get(name, 0) > 0:
        _ARMED[name] -= 1
        raise CrashInjected(name)


# ---------------------------------------------------------------------------
# Wire corruption
# ---------------------------------------------------------------------------
def _flip_one_bit(arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    out = np.array(arr)  # owned, writable copy
    flat = out.reshape(-1).view(np.uint8)
    if flat.size == 0:
        return out
    byte = int(rng.integers(flat.size))
    bit = int(rng.integers(8))
    flat[byte] ^= np.uint8(1 << bit)
    return out


def _like(orig, arr: np.ndarray):
    """``arr`` in the container of ``orig``: a torch tensor on its device,
    else the numpy array."""
    if isinstance(orig, torch.Tensor):
        return torch.from_numpy(arr).to(orig.device)
    return arr


def corrupt_update(update, kind: str, rng: np.random.Generator):
    """A corrupted COPY of a wire update tree (nested dicts of tensors,
    numpy arrays and QTensors; a QTensor's codes then scales are leaves, in
    the reference's flatten order, so the same ``rng`` corrupts the same
    byte of the same buffer in both packages).

    ``"bitflip"`` flips one random bit in one random buffer: in packed or
    8-bit codes that lands on a valid (wrong) code the gate cannot detect,
    the silent-corruption case aggregation must merely survive, while a
    flip in a scales/raw float leaf usually produces a huge or non-finite
    value the gate rejects. ``"nan"`` plants NaN (or Inf) in a float leaf,
    the case the gate MUST quarantine."""
    from repro_torch.fl import _tree

    orig = _tree.leaves(update, expand_q=True)
    arrs = [_tree.to_numpy(leaf) for leaf in orig]
    changed = None
    if kind == "bitflip":
        changed = int(rng.integers(len(arrs)))
        arrs[changed] = _flip_one_bit(arrs[changed], rng)
    elif kind == "nan":
        fidx = [i for i, a in enumerate(arrs) if a.dtype.kind == "f"]
        if fidx:
            changed = fidx[int(rng.integers(len(fidx)))]
            out = np.array(arrs[changed])
            pos = int(rng.integers(max(out.size, 1)))
            out.reshape(-1)[pos] = np.nan if rng.random() < 0.5 else np.inf
            arrs[changed] = out
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
    new = [_like(o, a) if i == changed else o
           for i, (o, a) in enumerate(zip(orig, arrs))]
    return _tree.unflatten(update, new, expand_q=True)


# ---------------------------------------------------------------------------
# Serve-engine wrapper
# ---------------------------------------------------------------------------
class FaultyEngine:
    """Proxy around ``serve.Engine`` injecting per-request faults.

    The engine itself is untouched (its steps never see the plan); the
    wrapper delays, drops, or transiently fails requests in front of it.
    ``time_scale`` shrinks the plan's simulated-seconds delays to real
    sleeps (tests use ~1e-3 so chaos runs stay instant)."""

    def __init__(self, engine, plan: FaultPlan, *, time_scale: float = 1.0):
        self.engine = engine
        self.plan = plan
        self.time_scale = float(time_scale)
        self.requests = 0
        self.stats = {"delayed": 0, "dropped": 0, "transient": 0}

    def generate(self, prompts, max_new: int, eos: int = -1):
        req = self.requests
        self.requests += 1
        # the request index plays the client role, the round is always 0
        f = self.plan.client_fault(0, req)
        if f.dropped:
            self.stats["dropped"] += 1
            raise DroppedRequest(f"request {req} lost (injected)")
        if f.delay > 0:
            self.stats["delayed"] += 1
            time.sleep(f.delay * self.time_scale)
        if f.transient_failures > 0:
            self.stats["transient"] += 1
            raise TransientServeError(
                f"request {req}: transient failure (injected); retry")
        return self.engine.generate(prompts, max_new, eos=eos)


def wrap_engine(engine, plan: FaultPlan, *, time_scale: float = 1.0):
    return FaultyEngine(engine, plan, time_scale=time_scale)
