"""Fault tolerance for the serving fleet: seeded chaos + failover policy.

``RobustnessConfig`` is the single opt-in switch threaded through
``DisaggConfig.robustness`` and ``serve(..., robustness=...)``; with it left
``None`` every serve path is bit-identical to the fault-oblivious code.
"""
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.robustness.faults import (
    FAULT_SITES,
    FailoverStats,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    FiredFault,
    InjectedFault,
)
from repro_torch.robustness.health import HealthConfig, HealthState, ReplicaHealth

__all__ = [
    "FAULT_SITES",
    "FailoverStats",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "FiredFault",
    "HealthConfig",
    "HealthState",
    "InjectedFault",
    "ReplicaHealth",
    "RobustnessConfig",
]


@dataclass
class RobustnessConfig:
    """Fault-tolerance policy for a fleet (or a single fault-tolerant server).

    ``max_retries`` bounds per-request re-placements after failures; past it
    the request sheds terminally with ``shed_reason="replica_failure"``.
    ``backoff_base_s`` delays the k-th retry by ``base * 2**(k-1)`` (0 means
    immediate re-placement, which keeps tiny test runs round-deterministic).
    ``handoff_ttl_s`` reaps staged-but-never-adopted handoff records.
    ``slo_capacity`` inflates the SLO tier's learned round cost on replica
    death so infeasible deadlines shed early instead of jittering.
    """

    health: HealthConfig = field(default_factory=HealthConfig)
    max_retries: int = 3
    backoff_base_s: float = 0.0
    handoff_ttl_s: Optional[float] = None
    slo_capacity: bool = True
    injector: Optional[FaultInjector] = None

    def make_injector(self) -> FaultInjector:
        if self.injector is None:
            self.injector = FaultInjector()
        return self.injector
