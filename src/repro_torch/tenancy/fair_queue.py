"""Two-level fair prefill queue: inter-tenant weighted fair sharing over
intra-tenant paper policies.

Level 1 (inter-tenant): among tenants with queued prefill work, pop from the
tenant with the LOWEST virtual service (``VirtualTokenCounter``) — weighted
max-min fairness across tenants.  Tenants inside an admission penalty window
are deprioritized: they are only served when no unpenalized tenant has work
(still starvation-free, since penalties expire).

Level 2 (intra-tenant): each tenant owns a private ``PrefillQueue`` built by
the configured policy factory (FCFS / SJF / Aging), so the paper's
request-level aging still orders requests WITHIN a tenant.

The class mirrors the ``PrefillQueue`` interface (add / pop / update /
remove / peek / len / contains / requests / drain_sorted) so the scheduler
is oblivious to which queue it holds.

Activity bookkeeping: a request is "owned" by the queue from first ``add``
until ``retire`` (prefill complete) or ``remove``; a tenant is active while
it owns requests.  The VTC lift fires only when a genuinely idle tenant
receives a new arrival — a request bouncing back after a chunk (scheduler
re-``add``/``update``) never re-triggers it.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.policies import PrefillQueue
from repro_torch.core.request import Request
from repro_torch.tenancy.admission import AdmissionController
from repro_torch.tenancy.vtc import VirtualTokenCounter


class FairPrefillQueue:
    def __init__(
        self,
        policy_factory: Callable[[], PrefillQueue],
        vtc: VirtualTokenCounter,
        *,
        admission: Optional[AdmissionController] = None,
        extra_active_fn: Optional[Callable[[], Iterable[str]]] = None,
    ):
        self._policy_factory = policy_factory
        self.vtc = vtc
        self.admission = admission
        self._extra_active_fn = extra_active_fn
        self._queues: Dict[str, PrefillQueue] = {}
        self._owned: Dict[int, str] = {}        # req_id -> tenant (queued or mid-prefill)
        self._inflight: Dict[str, int] = {}     # tenant -> owned request count
        # ``queue`` admission policy holding pen: (ready_at, req_id, req)
        self._delayed: List[Tuple[float, int, Request]] = []
        self.now = 0.0                          # scheduler clock (penalty expiry)
        # SLO tier (FairnessState.attach_slo): urgency_fn(head_req, now) ->
        # bool.  A tenant whose HEAD request is deadline-urgent jumps the
        # VTC order (FairBatching-style SLO-driven batch formation); among
        # urgent tenants — and always when unset — VTC order still rules.
        self.urgency_fn: Optional[Callable[[Optional[Request], float], bool]] = None

    # -- clock ----------------------------------------------------------------
    def set_now(self, now: float) -> None:
        self.now = now
        while self._delayed and self._delayed[0][0] <= now:
            _, _, req = heapq.heappop(self._delayed)
            self._subqueue(req.tenant).add(req)

    # -- delayed admission (queue policy) --------------------------------------
    def add_delayed(self, req: Request, ready_at: float) -> None:
        """Park an over-budget request until its tenant's bucket refills.
        Ownership starts immediately (the tenant counts as active — rate-
        limited work must not bank idle credit), but the request only enters
        its subqueue once ``set_now`` passes ``ready_at``."""
        if ready_at <= self.now:
            self.add(req)
            return
        t = req.tenant
        if req.req_id not in self._owned:
            active = self._active_tenants()
            if t not in active:
                self.vtc.on_activate(t, active)
            self._owned[req.req_id] = t
            self._inflight[t] = self._inflight.get(t, 0) + 1
        heapq.heappush(self._delayed, (ready_at, req.req_id, req))

    def delayed_count(self) -> int:
        return len(self._delayed)

    def is_delayed(self, req: Request) -> bool:
        return any(rid == req.req_id for _, rid, _ in self._delayed)

    def next_ready_at(self) -> Optional[float]:
        return self._delayed[0][0] if self._delayed else None

    # -- helpers --------------------------------------------------------------
    def _subqueue(self, tenant: str) -> PrefillQueue:
        q = self._queues.get(tenant)
        if q is None:
            q = self._policy_factory()
            self._queues[tenant] = q
        return q

    def _active_tenants(self) -> set:
        active = {t for t, n in self._inflight.items() if n > 0}
        if self._extra_active_fn is not None:
            active |= set(self._extra_active_fn())
        return active

    def _select_tenant(self) -> Optional[str]:
        best = None
        best_key = None
        for t, q in self._queues.items():
            if len(q) == 0:
                continue
            penalized = (
                self.admission.is_penalized(t, self.now)
                if self.admission is not None
                else False
            )
            urgent = (
                bool(self.urgency_fn(q.peek(), self.now))
                if self.urgency_fn is not None
                else False
            )
            # `not urgent` is the constant True when no urgency_fn is
            # attached — ordering then reduces to (penalized, vtc, t),
            # bit-identical to the SLO-less queue
            key = (penalized, not urgent, self.vtc.virtual_service(t), t)
            if best_key is None or key < best_key:
                best, best_key = t, key
        return best

    # -- PrefillQueue interface ------------------------------------------------
    def __len__(self) -> int:
        # delayed requests count as queued work (has_work must stay true while
        # the pen drains) even though pop() skips them until they are ready
        return sum(len(q) for q in self._queues.values()) + len(self._delayed)

    def __contains__(self, req: Request) -> bool:
        t = self._owned.get(req.req_id)
        if t is None:
            return False
        q = self._queues.get(t)     # absent if the tenant's first request is
        return (q is not None and req in q) or any(  # still in the delay pen
            r.req_id == req.req_id for _, _, r in self._delayed
        )

    def add(self, req: Request) -> None:
        t = req.tenant
        if req.req_id not in self._owned:       # genuinely new arrival
            active = self._active_tenants()
            if t not in active:
                self.vtc.on_activate(t, active)
            self._owned[req.req_id] = t
            self._inflight[t] = self._inflight.get(t, 0) + 1
        self._subqueue(t).add(req)

    def update(self, req: Request) -> None:
        self._subqueue(req.tenant).update(req)
        if req.req_id not in self._owned:       # defensive: treat as add
            self._owned[req.req_id] = req.tenant
            self._inflight[req.tenant] = self._inflight.get(req.tenant, 0) + 1

    def remove(self, req: Request) -> None:
        t = self._owned.get(req.req_id)
        if t is None:
            return
        if t in self._queues:
            self._queues[t].remove(req)
        self._delayed = [e for e in self._delayed if e[1] != req.req_id]
        heapq.heapify(self._delayed)
        self.retire(req)

    def retire(self, req: Request) -> None:
        """Release ownership once a request's prefill completed (or it was
        dropped): the tenant stops counting as prefill-active for lifts."""
        t = self._owned.pop(req.req_id, None)
        if t is not None:
            self._inflight[t] = max(0, self._inflight.get(t, 0) - 1)

    def pop(self) -> Optional[Request]:
        t = self._select_tenant()
        if t is None:
            return None
        return self._queues[t].pop()            # popped but still owned

    def peek(self) -> Optional[Request]:
        t = self._select_tenant()
        if t is None:
            return None
        return self._queues[t].peek()

    def drain_sorted(self) -> List[Request]:
        out = []
        while True:
            r = self.pop()
            if r is None:
                return out
            out.append(r)

    def requests(self) -> Iterable[Request]:
        out: List[Request] = []
        for q in self._queues.values():
            out.extend(q.requests())
        out.extend(r for _, _, r in self._delayed)
        return out

    # -- introspection ---------------------------------------------------------
    def backlog_by_tenant(self) -> Dict[str, int]:
        return {t: len(q) for t, q in self._queues.items() if len(q) > 0}
