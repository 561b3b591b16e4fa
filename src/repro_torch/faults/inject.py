"""Crash points (the part of ``repro.faults.inject`` that the checkpoint
writer calls).

``crashpoint(name)`` is a no-op dict probe unless a crash point is armed;
an armed point raises :class:`CrashInjected` once, as if the process died
there. The checkpoint writer calls it between writing ``data.bin`` and the
commit, so a test can show that a crash there leaves no committed step.
The reference arms points from a ``FaultPlan``; the port takes their names.
"""
from __future__ import annotations

import contextlib

__all__ = ["CrashInjected", "crashpoint", "active"]


class CrashInjected(RuntimeError):
    """Raised at an armed crash point (simulates the process dying there)."""


# name -> remaining fires; None when nothing is armed (one `is None` check)
_ARMED: dict[str, int] | None = None


@contextlib.contextmanager
def active(names):
    """Arm each crash point in ``names`` inside the block (each fires once);
    all are disarmed after."""
    global _ARMED
    _ARMED = {name: 1 for name in names}
    try:
        yield
    finally:
        _ARMED = None


def crashpoint(name: str) -> None:
    """Raise :class:`CrashInjected` if ``name`` is armed."""
    if _ARMED is None:
        return
    if _ARMED.get(name, 0) > 0:
        _ARMED[name] -= 1
        raise CrashInjected(name)
