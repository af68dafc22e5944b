"""Multi-tenant fairness subsystem (layered above the paper's scheduler).

Components:
  * ``tenants``   — TenantSpec / TenantRegistry / FairnessConfig
  * ``vtc``       — weighted Virtual Token Counter (per-tenant service)
  * ``fair_queue``— two-level prefill queue (inter-tenant VTC, intra-tenant
                    FCFS/SJF/Aging)
  * ``admission`` — token-bucket admission with deprioritization penalties

``FairnessState`` wires the four together for one scheduler instance; it is
constructed by ``ChunkedPrefillScheduler`` when ``SchedulerConfig.fairness``
is set and is a no-op import otherwise.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.policies import PrefillQueue
from repro_torch.core.request import Request, RequestState
from repro_torch.tenancy.admission import AdmissionController, AdmissionDecision, TokenBucket
from repro_torch.tenancy.fair_queue import FairPrefillQueue
from repro_torch.tenancy.tenants import (
    DEFAULT_TENANT, FairnessConfig, TenantRegistry, TenantSpec,
)
from repro_torch.tenancy.vtc import TenantService, VirtualTokenCounter


class FairnessState:
    """Per-scheduler composition of registry + VTC + admission + fair queue.

    The scheduler calls exactly three hooks, all guarded by
    ``cfg.fairness is not None``:
      * ``admit(req)``        at submit — token-bucket assessment
      * ``on_round(now)``     at schedule — advance the penalty clock
      * ``on_batch_done(b)``  post-execution — charge the VTC, retire
                              completed prefills, track decoding tenants
    """

    def __init__(
        self,
        cfg: FairnessConfig,
        policy_factory: Callable[[], PrefillQueue],
        *,
        vtc: Optional[VirtualTokenCounter] = None,
    ):
        self.cfg = cfg
        self.registry = TenantRegistry(cfg.tenants, auto_register=cfg.auto_register)
        # an injected counter is SHARED across schedulers (multi-replica
        # routers): every replica charges and reads the same per-tenant
        # virtual service, so a heavy tenant cannot launder load by fanning
        # requests across replicas — each replica's fair queue sees the
        # tenant's aggregate service, not its local slice
        self.vtc = vtc if vtc is not None else VirtualTokenCounter(
            self.registry,
            prefill_weight=cfg.prefill_charge_weight,
            decode_weight=cfg.decode_charge_weight,
        )
        self.admission: Optional[AdmissionController] = (
            AdmissionController(
                self.registry,
                policy=cfg.admission_policy,
                penalty_window_s=cfg.penalty_window_s,
            )
            if cfg.admission
            else None
        )
        self._decoding: Dict[str, Set[int]] = {}   # tenant -> decoding req_ids
        self.queue = FairPrefillQueue(
            policy_factory,
            self.vtc,
            admission=self.admission,
            extra_active_fn=self._decoding_tenants,
        )
        self.rejected: List[Request] = []
        self.shed: List[Request] = []          # SLO-shed at admission
        self.slo = None                        # SLOTracker (attach_slo)
        # first-token bonus charges issued by on_batch_done (the +1 decode
        # charged when a chunk completes a prefill, per Sarathi semantics);
        # the chaos suite's charge identity needs this ledger NET of refunds:
        #   charged == Σ scheduled tokens + first_token_charges
        self.first_token_charges = 0

    def _decoding_tenants(self) -> List[str]:
        return [t for t, ids in self._decoding.items() if ids]

    def attach_slo(self, tracker) -> None:
        """Wire an ``SLOTracker`` (built by the scheduler from
        ``SchedulerConfig.slo``) into the fairness subsystem: the admission
        controller gains the feasibility shed gate and the fair queue gains
        deadline urgency.  Each hook is gated on its feature flag so an
        all-flags-off tracker leaves behavior bit-identical."""
        self.slo = tracker
        if self.admission is not None and tracker.cfg.shed:
            self.admission.slo_gate = tracker.feasible
        if tracker.cfg.queue_urgency:
            self.queue.urgency_fn = tracker.urgent

    # -- scheduler hooks -------------------------------------------------------
    def admit(self, req: Request) -> AdmissionDecision:
        """Token-bucket assessment.  Returns the full decision: the scheduler
        routes ``delayed`` requests into the fair queue's holding pen and
        drops rejected ones."""
        if self.admission is None:
            return AdmissionDecision(tenant=req.tenant, admitted=True,
                                     penalized=False)
        decision = self.admission.assess(req)
        if not decision.admitted:
            (self.shed if decision.shed else self.rejected).append(req)
        return decision

    def on_preempt(self, req: Request) -> None:
        """A decoding request was evicted under KV pressure: it re-enters the
        prefill queue, so it must stop counting as decode-active (the queue
        re-``add`` restored its prefill ownership already)."""
        ids = self._decoding.get(req.tenant)
        if ids is not None:
            ids.discard(req.req_id)

    def on_resume(self, req: Request) -> None:
        """A swapped-out victim was restored straight into the decode set —
        it will never complete a prefill chunk again, so retire its queue
        ownership here (the path ``on_batch_done`` takes for ordinary
        prefill completions) and count it decode-active.  Its restore charges
        the VTC nothing: swap-out preemption must not tax the victim
        tenant's service accounting (FairBatching's requirement) the way a
        recompute's re-prefill tokens would."""
        self.queue.retire(req)
        self._decoding.setdefault(req.tenant, set()).add(req.req_id)

    def forget(self, req: Request) -> None:
        """The request left this scheduler outside the normal finish path — a
        value-dependent stop applied at drain, or a cross-replica handoff
        export.  Drop every piece of activity bookkeeping it holds here:
        queue ownership (the tenant stops counting as prefill-active) and
        decode-active membership.  Service already charged stays charged —
        tokens were really executed."""
        self.queue.retire(req)
        ids = self._decoding.get(req.tenant)
        if ids is not None:
            ids.discard(req.req_id)

    def refund_token(self, req: Request, *, first_token: bool = False) -> None:
        """Refund the charge of ONE rolled-back undrained token (crash or
        numerics quarantine discarded it before it became host-visible).  A
        token charged as the first-token bonus also decrements that ledger so
        the chaos suite's charge identity keeps balancing."""
        self.vtc.refund(req.tenant, decode_tokens=1)
        if first_token:
            self.first_token_charges -= 1

    def on_round(self, now: float) -> None:
        self.queue.set_now(now)

    def on_batch_done(self, batch) -> None:
        """Charge executed tokens and maintain activity bookkeeping.

        Called AFTER the scheduler applied chunk/token deliveries, so request
        states reflect the post-round world.
        """
        prefill: Dict[str, int] = {}
        decode: Dict[str, int] = {}
        for req, c in batch.prefill_chunks:
            prefill[req.tenant] = prefill.get(req.tenant, 0) + int(c)
            if req.state in (RequestState.DECODING, RequestState.FINISHED):
                # the round that completes a prefill also delivers the first
                # output token (Sarathi semantics) — charge it as decode so
                # per-tenant service matches tokens delivered
                decode[req.tenant] = decode.get(req.tenant, 0) + 1
                self.first_token_charges += 1
        for req in batch.decode_reqs:
            decode[req.tenant] = decode.get(req.tenant, 0) + 1
        for t in set(prefill) | set(decode):
            self.vtc.charge(t, prefill.get(t, 0), decode.get(t, 0))

        for req, _c in batch.prefill_chunks:
            if req.state in (RequestState.DECODING, RequestState.FINISHED):
                self.queue.retire(req)
            if req.state == RequestState.DECODING:
                self._decoding.setdefault(req.tenant, set()).add(req.req_id)
        for req in batch.decode_reqs:
            if req.state == RequestState.FINISHED:
                ids = self._decoding.get(req.tenant)
                if ids is not None:
                    ids.discard(req.req_id)

    # -- views ----------------------------------------------------------------
    def service_by_tenant(self) -> Dict[str, int]:
        return {t: self.vtc.actual_tokens(t) for t in self.vtc.tenants()}

    def virtual_by_tenant(self) -> Dict[str, float]:
        return {t: self.vtc.virtual_service(t) for t in self.vtc.tenants()}


def make_shared_vtc(cfg: FairnessConfig) -> VirtualTokenCounter:
    """One VirtualTokenCounter for a whole replica fleet: pass it as every
    scheduler's ``shared_vtc`` so per-tenant service aggregates across
    replicas (anti-laundering — see ``FairnessState``)."""
    registry = TenantRegistry(cfg.tenants, auto_register=cfg.auto_register)
    return VirtualTokenCounter(
        registry,
        prefill_weight=cfg.prefill_charge_weight,
        decode_weight=cfg.decode_charge_weight,
    )


__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "DEFAULT_TENANT",
    "FairPrefillQueue",
    "FairnessConfig",
    "FairnessState",
    "TenantRegistry",
    "TenantService",
    "TenantSpec",
    "TokenBucket",
    "VirtualTokenCounter",
    "make_shared_vtc",
]
