"""FaultPlan: a seeded, composable description of fleet failure modes (a
copy of ``repro.faults.plan``, numpy only: both packages draw the same
fates from the same plan).

Every failure a real federated/serving fleet exhibits is drawn from ONE
frozen plan, deterministically keyed by (seed, domain, round, client):

  * ``dropout``       — the client never reports (device offline).
  * ``straggler``     — the client reports late; the extra delay is drawn
                        from an exponential with mean ``straggler_delay``
                        (simulated seconds — the fleet driver runs on a
                        simulated clock, so experiments are instant AND
                        reproducible; the serve wrapper sleeps for real).
  * ``transient``     — an attempt fails retryably (OOM, lost connection);
                        the number of consecutive failures is geometric, so
                        bounded-retry/backoff policies are actually exercised.
  * ``duplicate``     — the same update is delivered more than once
                        (at-least-once transports do this).
  * ``reorder``       — arrival processing order is shuffled (the property
                        exact aggregation makes harmless — tests prove bits
                        don't change).
  * ``bitflip`` / ``nan_delta`` — wire-payload corruption: one flipped bit
    in one buffer, or a non-finite value planted in a float leaf. The
    server-side validation gate must quarantine what it can detect.
  * ``crash_points``  — named code locations
                        (``repro_torch.faults.crashpoint``)
    that raise :class:`CrashInjected` on their first hit while the plan is
    installed — checkpoint-write crash testing without monkeypatching.

Determinism contract: ``client_fault(r, c)`` is a pure function of
``(seed, r, c)`` — NOT of call order — so dropping or resampling one client
never shifts another client's fate, and an experiment is replayable from its
plan alone.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

__all__ = ["ClientFault", "FaultPlan", "BENIGN", "named_plan"]


def _crc(s: str) -> int:
    return zlib.crc32(s.encode("utf-8"))


@dataclasses.dataclass(frozen=True)
class ClientFault:
    """One client's drawn fate for one round (all fields deterministic)."""

    dropped: bool = False
    delay: float = 0.0            # straggler lateness (simulated seconds)
    transient_failures: int = 0   # retryable failures before success
    duplicates: int = 0           # extra deliveries of the same update
    corrupt: str | None = None    # None | "bitflip" | "nan"


BENIGN = ClientFault()


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    seed: int = 0
    dropout: float = 0.0
    straggler: float = 0.0
    straggler_delay: float = 4.0
    transient: float = 0.0
    duplicate: float = 0.0
    reorder: bool = False
    bitflip: float = 0.0
    nan_delta: float = 0.0
    crash_points: tuple[str, ...] = ()

    # ---- deterministic draws ----------------------------------------------
    def rng(self, domain: str, *ints: int) -> np.random.Generator:
        """A fresh Generator keyed by (seed, domain, *ints) — independent of
        every other key, so injections compose without cross-talk."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, _crc(domain),
                                    *[int(i) & 0x7FFFFFFF for i in ints]]))

    def client_fault(self, round_i: int, client_id: int) -> ClientFault:
        """The fate of client ``client_id`` in round ``round_i``.

        The draw order below is FIXED — adding a new fault axis must append
        draws, never reorder them, or every seeded experiment shifts."""
        r = self.rng("client", round_i, client_id)
        dropped = bool(r.random() < self.dropout)
        is_straggler = bool(r.random() < self.straggler)
        delay = float(r.exponential(self.straggler_delay)) if is_straggler \
            else 0.0
        nfail = 0
        if self.transient > 0:
            # geometric(p_success): failures before the first success
            nfail = int(r.geometric(1.0 - self.transient)) - 1
        dups = int(r.random() < self.duplicate)
        u = r.random()
        corrupt = None
        if u < self.bitflip:
            corrupt = "bitflip"
        elif u < self.bitflip + self.nan_delta:
            corrupt = "nan"
        return ClientFault(dropped=dropped, delay=delay,
                           transient_failures=nfail, duplicates=dups,
                           corrupt=corrupt)

    def arrival_order(self, round_i: int, n: int) -> np.ndarray:
        """Processing permutation of ``n`` queued arrivals (identity unless
        ``reorder``) — models an unordered transport draining a mailbox."""
        if not self.reorder or n <= 1:
            return np.arange(n)
        return self.rng("reorder", round_i).permutation(n)


_NAMED = {
    # the CI chaos preset: ISSUE-6 acceptance rates (20% dropout, 10%
    # stragglers, NaN-poisoned deltas) plus duplicates + reordered delivery
    "chaos-small": FaultPlan(seed=7, dropout=0.20, straggler=0.10,
                             straggler_delay=3.0, transient=0.10,
                             duplicate=0.10, reorder=True, nan_delta=0.08),
    # corruption-heavy: exercises the validation gate hard
    "corrupt": FaultPlan(seed=11, bitflip=0.15, nan_delta=0.15,
                         reorder=True),
    "none": FaultPlan(),
}


def named_plan(name: str) -> FaultPlan:
    """Registry of chaos presets (``examples/fed_avg.py --faults <name>``)."""
    try:
        return _NAMED[name]
    except KeyError:
        raise ValueError(
            f"unknown fault plan {name!r}; have {sorted(_NAMED)}") from None
