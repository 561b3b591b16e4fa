"""Seeded fault-injection harness (port of ``repro.faults``, DESIGN.md §10).

One frozen :class:`FaultPlan` describes every failure mode a fleet exhibits
(dropout, stragglers, transient retries, duplicated/reordered delivery,
wire corruption, checkpoint-write crash points), with draws keyed by
(seed, round, client) so experiments replay exactly and composing faults
never shifts unrelated draws. The plan WRAPS the FL round driver,
``serve.Engine`` and the checkpoint writer from outside; hot paths carry a
single disarmed-probe ``crashpoint`` call at most.
"""
from repro_torch.faults.inject import (CrashInjected, DroppedRequest,
                                       FaultyEngine, TransientServeError,
                                       active, corrupt_update, crashpoint,
                                       install, uninstall, wrap_engine)
from repro_torch.faults.plan import BENIGN, ClientFault, FaultPlan, named_plan

__all__ = ["BENIGN", "ClientFault", "FaultPlan", "named_plan",
           "CrashInjected", "DroppedRequest", "FaultyEngine",
           "TransientServeError", "active", "corrupt_update", "crashpoint",
           "install", "uninstall", "wrap_engine"]
