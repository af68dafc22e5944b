"""Token-bucket admission control with a deprioritization-penalty window.

Two-stage design (cf. the llmserve fairshare exemplar):

  1. ``assess(req)`` at submission refills the tenant's bucket and charges
     the request's estimated cost (prompt + max_new_tokens).  Within budget:
     clean admit.  Over budget, the configured policy applies:
       * ``deprioritize`` (default) — the request is still admitted, but the
         tenant enters a penalty window: the fair queue serves penalized
         tenants only when no unpenalized tenant has work.  Non-blocking,
         work-conserving, and self-healing once the bucket refills.
       * ``reject`` — the request is refused outright (hard quota).
       * ``queue`` — the request is admitted but DELAYED: the bucket is
         charged into debt and the request only becomes schedulable at the
         time the debt clears, so a tenant's queued work drains at exactly
         its contracted token rate (no loss, no priority inversion).
  2. The penalty expires on its own (``penalty_window_s`` after the last
     violation); ``is_penalized(tenant, now)`` is the query the fair queue
     uses at pop time.

Buckets use the scheduler's clock (request arrival times / round ``now``),
not wall time, so behavior is identical under the simulator and the real
engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.request import Request
from repro_torch.tenancy.tenants import TenantRegistry, TenantSpec


@dataclass
class TokenBucket:
    rate: float                 # tokens per second
    burst: float                # bucket depth
    tokens: float               # current fill
    last_ts: float = 0.0

    def refill(self, now: float) -> None:
        if self.rate <= 0:
            return
        dt = now - self.last_ts
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + self.rate * dt)
            self.last_ts = now

    def consume(self, cost: float, now: float) -> float:
        """Take up to ``cost`` tokens; returns the unmet deficit (>= 0)."""
        self.refill(now)
        take = min(self.tokens, cost)
        self.tokens -= take
        return cost - take

    def consume_debt(self, cost: float, now: float) -> float:
        """Charge ``cost`` unconditionally (the fill may go negative) and
        return the time the bucket is back at zero — the earliest moment the
        charged work is within budget.  Successive debts stack, so queued
        requests drain at exactly the contracted rate."""
        self.refill(now)
        self.tokens -= cost
        if self.tokens >= 0:
            return now
        return now + (-self.tokens) / self.rate


@dataclass(frozen=True)
class AdmissionDecision:
    tenant: str
    admitted: bool
    penalized: bool
    deficit: float = 0.0
    penalty_expires_at: float = 0.0
    delayed: bool = False       # queue policy: hold until ready_at
    ready_at: float = 0.0
    shed: bool = False          # SLO tier: deadline projected infeasible


@dataclass
class AdmissionStats:
    assessed: int = 0
    admitted: int = 0
    rejected: int = 0
    penalties: int = 0          # violations that opened/extended a window
    queued: int = 0             # requests delayed until bucket refill
    shed: int = 0               # SLO load shedding at admission


class AdmissionController:
    def __init__(
        self,
        registry: TenantRegistry,
        *,
        policy: str = "deprioritize",
        penalty_window_s: float = 2.0,
    ):
        if policy not in ("deprioritize", "reject", "queue"):
            raise ValueError(f"unknown admission policy {policy!r}")
        self.registry = registry
        self.policy = policy
        self.penalty_window_s = penalty_window_s
        self._buckets: Dict[str, TokenBucket] = {}
        self._penalty_until: Dict[str, float] = {}
        self.stats = AdmissionStats()
        # SLO tier (FairnessState.attach_slo): feasibility gate called as
        # slo_gate(req, now) -> bool; False sheds the request at admission —
        # the "reject when the deadline is unattainable" leg of load shedding
        self.slo_gate = None

    def _bucket(self, spec: TenantSpec, now: float) -> TokenBucket:
        b = self._buckets.get(spec.name)
        if b is None:
            # fresh buckets start full: a tenant may spend its burst at once
            b = TokenBucket(
                rate=spec.rate_tokens_per_s,
                burst=spec.effective_burst,
                tokens=spec.effective_burst,
                last_ts=now,
            )
            self._buckets[spec.name] = b
        return b

    @staticmethod
    def request_cost(req: Request) -> float:
        # submission-time estimate: full prompt + declared generation budget
        return float(req.prompt_len + req.max_new_tokens)

    def assess(self, req: Request, now: float = None) -> AdmissionDecision:
        if now is None:
            now = req.arrival_time
        self.stats.assessed += 1
        if self.slo_gate is not None and not self.slo_gate(req, now):
            # infeasible deadline: shedding now is strictly better than
            # admitting work that must miss — no bucket charge, no penalty
            self.stats.shed += 1
            return AdmissionDecision(
                tenant=req.tenant, admitted=False, penalized=False, shed=True
            )
        spec = self.registry.get(req.tenant)
        if spec.rate_tokens_per_s <= 0:          # unlimited tenant
            self.stats.admitted += 1
            return AdmissionDecision(tenant=req.tenant, admitted=True, penalized=False)

        bucket = self._bucket(spec, now)
        if self.policy == "queue":
            # delay-until-refill: charge the bucket into debt; the request is
            # admitted but only becomes schedulable once the debt clears
            ready_at = bucket.consume_debt(self.request_cost(req), now)
            self.stats.admitted += 1
            if ready_at <= now:
                return AdmissionDecision(
                    tenant=req.tenant, admitted=True, penalized=False
                )
            self.stats.queued += 1
            return AdmissionDecision(
                tenant=req.tenant, admitted=True, penalized=False,
                delayed=True, ready_at=ready_at,
            )

        deficit = bucket.consume(self.request_cost(req), now)
        if deficit <= 0:
            self.stats.admitted += 1
            return AdmissionDecision(tenant=req.tenant, admitted=True, penalized=False)

        if self.policy == "reject":
            self.stats.rejected += 1
            return AdmissionDecision(
                tenant=req.tenant, admitted=False, penalized=False, deficit=deficit
            )

        expires = now + self.penalty_window_s
        self._penalty_until[req.tenant] = max(
            self._penalty_until.get(req.tenant, 0.0), expires
        )
        self.stats.admitted += 1
        self.stats.penalties += 1
        return AdmissionDecision(
            tenant=req.tenant, admitted=True, penalized=True,
            deficit=deficit, penalty_expires_at=expires,
        )

    def is_penalized(self, tenant: str, now: float) -> bool:
        return self._penalty_until.get(tenant, 0.0) > now

    def penalty_expires_at(self, tenant: str) -> float:
        return self._penalty_until.get(tenant, 0.0)
