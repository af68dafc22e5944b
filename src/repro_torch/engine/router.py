"""Multi-replica serving router: fault tolerance, straggler mitigation,
elastic scaling — the cluster-level control plane above per-replica
chunked-prefill engines.

Design (1000+ node posture, validated here over simulated replicas):
  * Each replica = one serving engine (a pod slice running the jitted step
    under its own mesh) with its own scheduler (the paper's centralized
    engine-side scheduling, §4.3.3, replicated per pod).
  * The router keeps a REQUEST JOURNAL: every request's arrival time and
    payload.  On replica failure, in-flight requests are replayed to healthy
    replicas with their ORIGINAL arrival times — Aging priorities are a pure
    function of (arrival, remaining work), so the fairness state reconstructs
    exactly (no distributed priority queues to keep consistent).
  * Heartbeats mark replicas dead after ``heartbeat_timeout``; stragglers
    (heartbeat ok, throughput below ``straggler_factor`` x fleet median) are
    drained and their queued work re-dispatched.
  * Elastic scaling: add_replica()/remove_replica() at any time; the router
    rebalances by least-outstanding-work-first dispatch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.engine.costmodel import CostModel, CostModelConfig
from repro_torch.engine.metrics import FairnessReport, summarize, summarize_by_tenant
from repro_torch.tenancy import make_shared_vtc


@dataclass
class ReplicaState:
    rid: int
    scheduler: ChunkedPrefillScheduler
    sim: "ReplicaClock"
    alive: bool = True
    draining: bool = False
    added_at: float = 0.0
    last_heartbeat: float = 0.0
    rounds_done: int = 0
    tokens_done: int = 0
    assigned: Dict[int, Request] = field(default_factory=dict)  # req_id -> req


class ReplicaClock:
    """Discrete-event execution of one replica (same cost model as the
    simulator), advanced by the router's global clock."""

    def __init__(self, scheduler: ChunkedPrefillScheduler, cost: CostModel,
                 speed: float = 1.0):
        self.sched = scheduler
        self.cost = cost
        self.speed = speed            # <1 = straggler
        self.busy_until = 0.0

    def step(self, now: float) -> Optional[float]:
        """If idle and work exists, run one round; returns round latency s."""
        if now < self.busy_until or not self.sched.has_work():
            return None
        batch = self.sched.schedule(now)
        if batch.is_empty():
            return None
        dt = self.cost.batch_latency_ms(batch) / 1000.0 / self.speed
        self.busy_until = now + dt
        self.sched.on_batch_done(batch, now + dt)
        return dt


@dataclass
class RouterConfig:
    heartbeat_timeout: float = 1.0
    heartbeat_interval: float = 0.1
    straggler_factor: float = 0.35     # < 35% of median throughput => drain
    straggler_window: float = 3.0      # seconds of history for throughput
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    cost: CostModelConfig = field(default_factory=CostModelConfig)
    # one VirtualTokenCounter for the whole fleet: every replica's fair queue
    # sees each tenant's AGGREGATE service, so a tenant cannot launder load by
    # fanning requests across replicas.  Off => per-replica counters (the
    # pre-disaggregation behavior: each replica only sees its local slice).
    shared_vtc: bool = True
    # bound on replays per request across replica failures; past it the
    # request sheds terminally (shed_reason="replica_failure") instead of
    # ping-ponging forever between dying replicas.  None = unbounded (the
    # pre-fault-tolerance behavior).
    max_retries: Optional[int] = None


class Router:
    def __init__(self, cfg: RouterConfig, n_replicas: int = 2):
        self.cfg = cfg
        self.replicas: Dict[int, ReplicaState] = {}
        self._next_rid = 0
        self.journal: Dict[int, Request] = {}        # req_id -> original request
        self.completed: Dict[int, Request] = {}
        self.clock = 0.0
        self.events: List[str] = []
        self._replays: Dict[int, int] = {}           # req_id -> replay count
        self.shed_failed: List[Request] = []         # terminal replica_failure sheds
        self._shared_vtc = (
            make_shared_vtc(cfg.scheduler.fairness)
            if cfg.shared_vtc and cfg.scheduler.fairness is not None
            else None
        )
        for _ in range(n_replicas):
            self.add_replica()

    # -- elasticity ---------------------------------------------------------
    def add_replica(self, speed: float = 1.0) -> int:
        rid = self._next_rid
        self._next_rid += 1
        sched = ChunkedPrefillScheduler(
            self.cfg.scheduler, shared_vtc=self._shared_vtc
        )
        sim = ReplicaClock(sched, CostModel(self.cfg.cost), speed=speed)
        self.replicas[rid] = ReplicaState(
            rid=rid, scheduler=sched, sim=sim, last_heartbeat=self.clock,
            added_at=self.clock,
        )
        self.events.append(f"t={self.clock:.3f} add replica {rid} (speed {speed})")
        return rid

    def remove_replica(self, rid: int) -> None:
        """Graceful removal: drain then re-dispatch unfinished work."""
        st = self.replicas.get(rid)
        if st is None:
            return
        st.draining = True
        self.events.append(f"t={self.clock:.3f} drain replica {rid}")
        self._redistribute(st, reason="drain")
        st.alive = False

    def kill_replica(self, rid: int) -> None:
        """Hard failure: heartbeats stop; requests recovered by replay."""
        st = self.replicas[rid]
        st.alive = False
        self.events.append(f"t={self.clock:.3f} replica {rid} DIED")

    # -- dispatch -------------------------------------------------------------
    def _outstanding_work(self, st: ReplicaState) -> int:
        return sum(
            r.remaining_prefill + (r.max_new_tokens - r.generated)
            for r in st.assigned.values()
            if r.state != RequestState.FINISHED
        )

    def _tenant_outstanding(self, st: ReplicaState, tenant: str) -> int:
        return sum(
            r.remaining_prefill + (r.max_new_tokens - r.generated)
            for r in st.assigned.values()
            if r.tenant == tenant and r.state != RequestState.FINISHED
        )

    def _healthy(self) -> List[ReplicaState]:
        return [s for s in self.replicas.values() if s.alive and not s.draining]

    def submit(self, req: Request) -> None:
        self.journal[req.req_id] = req
        self._dispatch(req)

    def _dispatch(self, req: Request) -> None:
        healthy = self._healthy()
        if not healthy:
            raise RuntimeError("no healthy replicas")
        if self.cfg.scheduler.fairness is not None:
            # tenant-aware: spread each tenant's work across replicas first
            # (so one tenant's burst can't capture a whole replica), then
            # least-loaded overall.  Replays keep the original tenant tag, so
            # per-replica VTC accounting reconstructs after failover.
            target = min(
                healthy,
                key=lambda s: (
                    self._tenant_outstanding(s, req.tenant),
                    self._outstanding_work(s),
                    s.rid,
                ),
            )
        else:
            target = min(healthy, key=self._outstanding_work)
        if target.scheduler.submit(req):
            target.assigned[req.req_id] = req

    def _redistribute(self, st: ReplicaState, reason: str) -> None:
        """Replay a replica's unfinished requests elsewhere.

        Replayed requests keep their ORIGINAL arrival time; prefill progress
        on the dead replica is lost (its KV cache is gone), so remaining
        work resets to the full prompt — exactly the recovery semantics of a
        stateless-scheduler engine.  Aging re-derives priority from
        (arrival, remaining), so long-waiting requests keep their seniority.
        """
        replay = [r for r in st.assigned.values() if r.state != RequestState.FINISHED]
        st.assigned.clear()
        for r in replay:
            k = self._replays.get(r.req_id, 0) + 1
            self._replays[r.req_id] = k
            if self.cfg.max_retries is not None and k > self.cfg.max_retries:
                # retries exhausted: terminal shed, never silently lost — the
                # journal entry ends FINISHED so the run can still quiesce
                r.shed_reason = "replica_failure"
                r.state = RequestState.FINISHED
                self.journal[r.req_id] = r
                self.shed_failed.append(r)
                self.events.append(
                    f"t={self.clock:.3f} req {r.req_id} shed after {k - 1} replays"
                )
                continue
            fresh = Request(
                prompt_len=r.prompt_len,
                max_new_tokens=r.max_new_tokens,
                arrival_time=r.arrival_time,           # seniority preserved
                req_id=r.req_id,
                tenant=r.tenant,
                prompt_tokens=r.prompt_tokens,
            )
            self.journal[fresh.req_id] = fresh
            self._dispatch(fresh)
        if replay:
            self.events.append(
                f"t={self.clock:.3f} replayed {len(replay)} requests from "
                f"replica {st.rid} ({reason})"
            )

    # -- fairness aggregation ---------------------------------------------------
    def tenant_service(self) -> Dict[str, float]:
        """Actual tokens executed per tenant, summed across ALL replicas ever
        (dead ones included: their executed tokens were real service, even if
        the prefill progress itself was lost and replayed elsewhere).

        With a shared VTC every replica charges one counter, so it is read
        ONCE — summing each replica's view of it would multiply the total by
        the replica count."""
        if self._shared_vtc is not None:
            return {
                t: float(self._shared_vtc.actual_tokens(t))
                for t in self._shared_vtc.tenants()
            }
        out: Dict[str, float] = {}
        for st in self.replicas.values():
            fairness = st.scheduler.fairness
            if fairness is None:
                continue
            for t, tokens in fairness.service_by_tenant().items():
                out[t] = out.get(t, 0.0) + tokens
        return out

    def fairness_report(self) -> FairnessReport:
        """Per-tenant latency/service summary over the request journal."""
        weights = None
        fairness_cfg = self.cfg.scheduler.fairness
        if fairness_cfg is not None:
            weights = {t.name: t.weight for t in fairness_cfg.tenants}
        return summarize_by_tenant(
            self.journal.values(), weights=weights, makespan=self.clock
        )

    # -- health -----------------------------------------------------------------
    def _check_health(self) -> None:
        for st in list(self.replicas.values()):
            if not st.alive:
                if st.assigned:
                    self._redistribute(st, reason="failure")
                continue
            st.last_heartbeat = self.clock
        # straggler detection on throughput (tokens/s over the window)
        healthy = [
            s for s in self._healthy()
            if self.clock - s.added_at > self.cfg.straggler_window
        ]
        if len(healthy) >= 2:
            def rate_of(s):
                return s.tokens_done / max(self.clock - s.added_at, 1e-6)
            rates = sorted(rate_of(s) for s in healthy)
            median = rates[len(rates) // 2]
            for st in healthy:
                rate = rate_of(st)
                if (
                    median > 0
                    and rate < self.cfg.straggler_factor * median
                    and not st.draining
                ):
                    self.events.append(
                        f"t={self.clock:.3f} replica {st.rid} STRAGGLER "
                        f"({rate:.0f} vs median {median:.0f} tok/s) -> drain"
                    )
                    self.remove_replica(st.rid)

    # -- run ------------------------------------------------------------------
    def run(self, requests: List[Request], *, until: Optional[float] = None,
            fault_at: Optional[Dict[float, Callable]] = None,
            tick: float = 0.001, max_ticks: int = 10_000_000):
        """Event loop: admit arrivals, advance replicas, health checks.

        fault_at: {time_s: callback(router)} fault/scale injections.
        """
        pending = sorted(requests, key=lambda r: r.arrival_time)
        for r in pending:
            self.journal[r.req_id] = r
        next_i = 0
        faults = sorted((fault_at or {}).items())
        fault_i = 0
        last_health = 0.0
        ticks = 0

        def all_done():
            return next_i >= len(pending) and all(
                r.state == RequestState.FINISHED for r in self.journal.values()
            )

        while ticks < max_ticks:
            ticks += 1
            # inject faults
            while fault_i < len(faults) and faults[fault_i][0] <= self.clock:
                faults[fault_i][1](self)
                fault_i += 1
            # admissions
            while next_i < len(pending) and pending[next_i].arrival_time <= self.clock:
                self._dispatch(pending[next_i])
                next_i += 1
            # health
            if self.clock - last_health >= self.cfg.heartbeat_interval:
                self._check_health()
                last_health = self.clock
            # advance replicas
            progressed = False
            for st in self._healthy():
                dt = st.sim.step(self.clock)
                if dt is not None:
                    st.rounds_done += 1
                    progressed = True
                st.tokens_done = (
                    st.scheduler.stats.scheduled_prefill_tokens
                    + st.scheduler.stats.scheduled_decode_tokens
                )
            if until is not None and self.clock >= until:
                break
            if all_done() and fault_i >= len(faults):
                break
            self.clock += tick if not progressed else tick

        finished = [r for r in self.journal.values()]
        return summarize(finished, makespan=self.clock)
