"""Deterministic, seeded fault injection for the serving fleet.

A chaos run is a *plan*, not a dice roll: ``FaultPlan`` pins every fault to a
named site and an invocation ordinal, so the same plan replays the same
failure scenario bit-for-bit — which is what lets CI gate on exact recovery
behavior (zero lost requests, exact retry counts, survivor-output identity)
instead of "it usually survives".

Sites are threaded through the stack at the narrow waists where real
failures strike:

    replica_step_crash   ReplicaServer.step raises before touching the round
    slow_round_ms        a replica's step stalls (straggler / contended host)
    handoff_drop         the cross-replica KV transfer fails; payload lost
    handoff_stall        the staged record is never adopted (TTL must reap it)
    swap_gather_fail     the export gather cannot launch; decode colocates
    nan_logits           a request's device KV goes non-finite mid-decode
    host_oom             the host-side handoff store refuses the payload

Each site is counted per scope (globally, and per replica / per request),
and a spec fires when its scope's count reaches ``nth`` — so "crash
prefill0's 3rd step" and "drop request 7's handoff" are both one line.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

FAULT_SITES: Tuple[str, ...] = (
    "replica_step_crash",
    "slow_round_ms",
    "handoff_drop",
    "handoff_stall",
    "swap_gather_fail",
    "nan_logits",
    "host_oom",
)


class InjectedFault(RuntimeError):
    """Raised by a fault site standing in for a real infrastructure failure."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault at {site}" + (f": {detail}" if detail else ""))
        self.site = site


@dataclass(frozen=True)
class FaultSpec:
    """One planned fault: fire at the ``nth`` matching invocation of ``site``.

    ``replica``/``req_id`` narrow the scope (None matches anything); ``nth``
    counts invocations *within that scope*.  ``repeat`` keeps firing on every
    invocation at or past ``nth`` (a persistent failure rather than a blip).
    ``value`` carries the site parameter (ms for ``slow_round_ms``).
    """

    site: str
    nth: int = 1
    replica: Optional[str] = None
    req_id: Optional[int] = None
    value: float = 0.0
    repeat: bool = False

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.nth < 1:
            raise ValueError("nth is 1-based")


@dataclass(frozen=True)
class FaultPlan:
    specs: Tuple[FaultSpec, ...] = ()

    @classmethod
    def fuzz(
        cls,
        seed: int,
        *,
        n_faults: int = 3,
        sites: Tuple[str, ...] = FAULT_SITES,
        max_nth: int = 30,
        replicas: Tuple[str, ...] = (),
    ) -> "FaultPlan":
        """Deterministic fuzzer: the seed fully determines the plan."""
        rng = random.Random(seed)
        specs = []
        for _ in range(n_faults):
            site = rng.choice(sites)
            specs.append(FaultSpec(
                site=site,
                nth=rng.randint(1, max_nth),
                replica=(rng.choice(replicas)
                         if replicas and rng.random() < 0.5 else None),
                value=float(rng.randint(1, 20)) if site == "slow_round_ms" else 0.0,
                repeat=rng.random() < 0.25,
            ))
        return cls(specs=tuple(specs))


@dataclass
class FiredFault:
    site: str
    spec: FaultSpec
    count: int
    replica: Optional[str] = None
    req_id: Optional[int] = None


class FaultInjector:
    """Matches live invocations of fault sites against a plan.

    ``fire(site, ...)`` increments the site's counters and returns the spec
    that fires (at most one per invocation), recording it in ``self.fired``
    so tests and reports can reconcile injected vs survived faults.
    """

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self._counts: Dict[Tuple, int] = {}
        self._consumed: set = set()
        self.fired: List[FiredFault] = []

    def _bump(self, key: Tuple) -> int:
        n = self._counts.get(key, 0) + 1
        self._counts[key] = n
        return n

    def fire(self, site: str, *, replica: Optional[str] = None,
             req_id: Optional[int] = None) -> Optional[FaultSpec]:
        n_global = self._bump((site, None, None))
        n_replica = self._bump((site, replica, None)) if replica is not None else 0
        n_req = self._bump((site, None, req_id)) if req_id is not None else 0
        for i, spec in enumerate(self.plan.specs):
            if spec.site != site or i in self._consumed:
                continue
            if spec.replica is not None and spec.replica != replica:
                continue
            if spec.req_id is not None and spec.req_id != req_id:
                continue
            if spec.req_id is not None:
                n = n_req
            elif spec.replica is not None:
                n = n_replica
            else:
                n = n_global
            if n == spec.nth or (spec.repeat and n >= spec.nth):
                if not spec.repeat:
                    self._consumed.add(i)
                self.fired.append(FiredFault(site, spec, n, replica, req_id))
                return spec
        return None

    def maybe_raise(self, site: str, **scope) -> None:
        spec = self.fire(site, **scope)
        if spec is not None:
            raise InjectedFault(site)

    def count(self, site: Optional[str] = None) -> int:
        if site is None:
            return len(self.fired)
        return sum(1 for f in self.fired if f.site == site)


@dataclass
class FailoverStats:
    """Mutable fleet-wide fault-tolerance counters (summarized into
    ``metrics.RobustnessReport`` at the end of a run)."""

    replicas_died: int = 0
    failovers: int = 0            # requests evacuated off dead replicas
    recovered_resumable: int = 0  # re-placed decode-resumable (zero re-prefill)
    requeued_reprefill: int = 0   # re-enqueued through the preempt() fold
    retries: int = 0              # total re-placement attempts
    shed_replica_failure: int = 0
    quarantined: int = 0          # non-finite requests terminated
    expired_handoffs: int = 0
    crash_unwinds: int = 0        # mid-round exceptions survived
    colocated_fallbacks: int = 0  # handoffs degraded to colocated decode
    events: List[str] = field(default_factory=list)

    def note(self, msg: str) -> None:
        self.events.append(msg)
