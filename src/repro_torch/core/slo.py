"""SLO tier — per-request deadlines, feasibility projection, and urgency.

Closes the loop on ``TenantSpec.ttft_slo_s`` / ``TenantSpec.e2e_slo_s``:
instead of reporting-only gauges, the tenant's latency targets drive

  * **deadline-aware LPRS** — ``round_target_ms`` turns the *tightest
    admitted deadline* into the per-round latency target T* fed to
    ``select_chunk`` (slack divided over the rounds the request still
    needs, via ``predicted_resume_rounds``);
  * **SLO-weighted victim selection** — ``victim_class`` ranks preemption
    victims so a request already violating (or infeasible) sheds first
    and a protected, deadline-feasible request sheds last;
  * **APC protection** — ``urgent`` marks requests whose slack is within
    ``urgency_factor`` of the minimum feasible service time; the scheduler
    lets their prefill chunk bypass the activity cap / min-chunk gates so
    a protected tenant is never blocked below the deadline-feasible chunk;
  * **load shedding** — ``feasible`` is the admission/queue gate: a
    request whose deadline cannot be met even at max priority is shed
    (``AdmissionDecision.shed`` / ``Request.shed_reason``) instead of
    burning budget to miss it anyway.

All projections price a scheduling round with an EWMA of observed round
wall time (``begin_round``), seeded from ``round_ms_init`` — the same
"learn the round cost online" approach the LPRS predictor takes for
chunk sizing, but coarse enough to stay O(1) per request.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Tuple

from repro_torch.core.lprs import predicted_resume_rounds
from repro_torch.core.request import Request

# victim classes, ranked: higher sheds first
VICTIM_PROTECTED = 0   # has an SLO and can still make it — shed last
VICTIM_NO_SLO = 1      # best-effort traffic
VICTIM_VIOLATING = 2   # deadline already missed or infeasible — shed first


@dataclass(frozen=True)
class SLOConfig:
    """Feature flags + projection knobs for the SLO serving tier.

    Every flag defaults on; with ALL flags off the scheduler is
    bit-identical to running without a tracker (tested by
    ``tests/test_slo.py::test_slo_off_bit_identical``).
    """

    deadline_lprs: bool = True     # tightest-deadline round target for LPRS
    queue_urgency: bool = True     # deadline-urgent tenants jump the VTC order
    victim_weighting: bool = True  # SLO-attainment-weighted victim ranking
    apc_protect: bool = True       # urgent prefills bypass APC cap/min-chunk
    shed: bool = True              # infeasible deadlines shed at admission/queue

    round_ms_init: float = 50.0    # prior for the per-round wall time
    round_ms_ewma: float = 0.2     # EWMA weight for observed round times
    min_target_ms: float = 5.0     # floor for the derived LPRS target
    slack_safety: float = 1.0      # required slack = rounds * round_ms * safety
    urgency_factor: float = 2.0    # urgent when slack <= required * factor


class SLOTracker:
    """Projects deadlines/feasibility for requests of SLO-configured tenants.

    Owned by the scheduler (``SchedulerConfig.slo``); shared with the
    fairness subsystem via ``FairnessState.attach_slo`` (admission gate +
    fair-queue urgency).  Stateless per request — everything derives from
    the request's live fields, so preemption/swap/restore need no hooks.
    """

    def __init__(self, cfg: SLOConfig, registry, *, token_budget: int):
        self.cfg = cfg
        self.registry = registry          # duck-typed: .get(name) -> TenantSpec
        self.token_budget = max(int(token_budget), 1)
        self.round_ms = float(cfg.round_ms_init)
        self._last_now: Optional[float] = None

    # -- online round-cost estimate ------------------------------------------
    def begin_round(self, now: float, prev_busy: bool) -> None:
        """Fold the elapsed wall time since the previous ``schedule()`` call
        into the EWMA round cost — only when the previous round actually
        executed work (idle gaps between arrivals are not round cost)."""
        if prev_busy and self._last_now is not None and now > self._last_now:
            dt_ms = (now - self._last_now) * 1e3
            a = self.cfg.round_ms_ewma
            self.round_ms += a * (dt_ms - self.round_ms)
        self._last_now = now

    def scale_round_cost(self, factor: float) -> None:
        """Step-change the learned round cost (replica failover: the fleet
        just lost capacity, so every surviving replica's rounds get slower by
        roughly the capacity ratio).  The EWMA would learn this eventually;
        jumping it immediately makes infeasible deadlines shed NOW instead of
        burning budget during the convergence window."""
        self.round_ms *= max(float(factor), 1e-6)

    # -- deadline projection --------------------------------------------------
    def projection(self, req: Request) -> Tuple[Optional[float], int]:
        """(absolute deadline [s], minimum rounds of service still needed)
        for the request's *binding* SLO, or ``(None, 0)`` when its tenant
        has no latency target.

        Pre-first-token the TTFT target binds (falling back to E2E): the
        rounds needed are the chunked-prefill round count from
        ``predicted_resume_rounds`` — one restore round for a swap victim,
        ``ceil(remaining/budget)`` otherwise.  Post-first-token only the
        E2E target can bind and the worst case is one round per remaining
        token (stop tokens can only finish earlier).
        """
        spec = self.registry.get(req.tenant)
        pre_ttft = req.first_token_time is None
        if pre_ttft and spec.ttft_slo_s is not None:
            rounds = predicted_resume_rounds(
                req.remaining_prefill, self.token_budget, swapped=req.swapped
            )
            return req.arrival_time + spec.ttft_slo_s, rounds
        if spec.e2e_slo_s is not None:
            rounds = max(req.max_new_tokens - req.generated, 1)
            if pre_ttft:
                # prefill rounds first; the prefill-completing round already
                # delivers the first token, hence the -1 overlap
                rounds += predicted_resume_rounds(
                    req.remaining_prefill, self.token_budget, swapped=req.swapped
                ) - 1
            elif req.swapped:
                rounds += 1  # one host->device restore round before decode resumes
            return req.arrival_time + spec.e2e_slo_s, rounds
        return None, 0

    def required_s(self, rounds: int) -> float:
        return rounds * (self.round_ms / 1e3) * self.cfg.slack_safety

    def slack_s(self, req: Request, now: float) -> Optional[float]:
        """Remaining wall-clock budget before the binding deadline (signed)."""
        deadline, _ = self.projection(req)
        return None if deadline is None else deadline - now

    def feasible(self, req: Request, now: float) -> bool:
        """Can the deadline still be met at max priority?  (Admission /
        queue shed gate — requests without an SLO are always feasible.)"""
        deadline, rounds = self.projection(req)
        if deadline is None:
            return True
        return (deadline - now) >= self.required_s(rounds)

    def urgent(self, req: Optional[Request], now: float) -> bool:
        """Feasible-but-tight: the request must be served *now* (within
        ``urgency_factor`` round-budgets of the deadline) to keep its SLO.
        Drives fair-queue priority and the APC bypass."""
        if req is None:
            return False
        deadline, rounds = self.projection(req)
        if deadline is None:
            return False
        return (deadline - now) <= self.required_s(rounds) * self.cfg.urgency_factor

    def victim_class(self, req: Request, now: float) -> int:
        """Preemption ranking: violating/infeasible requests shed first,
        best-effort next, protected deadline-feasible requests last."""
        deadline, rounds = self.projection(req)
        if deadline is None:
            return VICTIM_NO_SLO
        if (deadline - now) < self.required_s(rounds):
            return VICTIM_VIOLATING
        return VICTIM_PROTECTED

    def round_target_ms(
        self, requests: Iterable[Request], now: float, base_target_ms: float
    ) -> float:
        """Deadline-aware LPRS target: the tightest per-round budget over
        every admitted deadline-bearing request — its remaining slack
        spread across the rounds it still needs — clamped to
        ``[min_target_ms, base_target_ms]`` so an SLO can only *tighten*
        the static T*, never relax it."""
        target = float(base_target_ms)
        for req in requests:
            deadline, rounds = self.projection(req)
            if deadline is None:
                continue
            per_round = (deadline - now) * 1e3 / max(rounds, 1)
            if per_round < target:
                target = per_round
        return max(target, self.cfg.min_target_ms)
