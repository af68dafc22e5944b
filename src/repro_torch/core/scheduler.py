"""ChunkedPrefillScheduler — the paper's full scheduling round (§3.1–3.3).

Round semantics (decode-first, §3.1.3):
  1. Reserve capacity for all ongoing decode requests (one token each).
  2. Rank prefill candidates by the configured policy (FCFS / SJF / Aging).
  3. For each candidate in priority order: choose a chunk via the static
     token-budget rule (Eq. 7) or LPRS (Algorithm 1); gate it through APC
     (Eq. 14) when enabled; commit the chunk and update request state.
  4. Requests with remaining prefill return to the queue with updated
     priority (heap update, O(log n)).

The scheduler is execution-agnostic: it emits a ScheduledBatch; the engine
(real JAX execution) or the simulator (calibrated clock) runs it and calls
``on_batch_done``.
"""
from __future__ import annotations

from itertools import islice
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple


from repro_torch.core.apc import APCConfig, APCStats, activity_cap
from repro_torch.core.apc import apply as apc_apply
from repro_torch.core.features import BatchState
from repro_torch.core.lprs import LPRSConfig, predicted_resume_rounds, search
from repro_torch.core.policies import PrefillQueue, make_policy
from repro_torch.core.request import Request, RequestState
from repro_torch.core.slo import SLOConfig, SLOTracker
from repro_torch.tracing import OFF

if TYPE_CHECKING:  # imported lazily at runtime: tenancy itself imports core
    from repro_torch.tenancy import FairnessState
    from repro_torch.tenancy.tenants import FairnessConfig


@dataclass(frozen=True)
class SchedulerConfig:
    policy: str = "fcfs"              # fcfs | sjf | aging
    alpha: float = 1.0                # aging waiting-time weight (>0)
    beta: float = -0.01               # aging remaining-work weight (<0)
    token_budget: int = 1024          # B_max per round
    max_seqs: int = 128               # S_max sequence slots
    lprs: Optional[LPRSConfig] = None # None = static token-budget chunking
    apc: Optional[APCConfig] = None   # None = APC off
    fairness: Optional["FairnessConfig"] = None  # None = single-tenant queue
    # SLO serving tier: per-tenant TTFT/E2E deadlines drive LPRS targets,
    # victim selection, APC protection, and load shedding.  Requires
    # ``fairness`` (the deadlines live on TenantSpec); None = tier off.
    slo: Optional[SLOConfig] = None
    # cache-aware aging credit: priority bonus per token of the request's
    # context already materialized on the attached pool (held blocks, a
    # host-staged swap record one restore round from runnable, or an indexed
    # prefix-cache match) — near-free work is not starved behind full
    # recomputes by pure arrival-order aging.  Key units per token (the same
    # scale as |beta|); 0.0 disables (legacy ordering, bit-identical).
    cache_credit: float = 0.0
    # tiered KV hierarchy: up to this many swap-ready victims are restored
    # EARLY at the end of each round, with genuinely leftover capacity only
    # (free blocks, free slots, no preemption) — the victim decodes from the
    # next round instead of waiting for a queue pop that congestion may
    # never reach.  0 disables (restores only through the pop path).
    swap_prefetch_depth: int = 0
    # partial swap-in: after this many CONSECUTIVE restore deferrals of a
    # host-resident record, shrink it to its decode-hot tail — the prefix
    # is folded for recompute (chunk-by-chunk, block-clipped) and only the
    # tail's blocks need to be free at once.  None disables.
    partial_restore_after: Optional[int] = None


@dataclass
class ScheduledBatch:
    round_idx: int
    decode_reqs: List[Request] = field(default_factory=list)
    prefill_chunks: List[Tuple[Request, int]] = field(default_factory=list)
    state: BatchState = field(default_factory=BatchState)
    # requests evicted this round to make KV room (blocks freed, prefill
    # re-enqueued for recompute) — the engine must reset their slot state
    preempted: List[Request] = field(default_factory=list)
    # swap-mode preemption traffic this round: ``swapped_out`` victims had
    # their KV staged host-side instead of discarded; ``restored`` requests
    # were swapped back in (decode-resumable).  The MB totals price the
    # transfers in the simulator's cost model.
    swapped_out: List[Request] = field(default_factory=list)
    restored: List[Request] = field(default_factory=list)
    swap_out_mb: float = 0.0
    swap_in_mb: float = 0.0

    @property
    def prefill_tokens(self) -> int:
        return sum(c for _, c in self.prefill_chunks)

    @property
    def decode_tokens(self) -> int:
        return len(self.decode_reqs)

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def n_seqs(self) -> int:
        return len(self.decode_reqs) + len(self.prefill_chunks)

    def is_empty(self) -> bool:
        return self.n_seqs == 0


@dataclass
class SchedulerStats:
    rounds: int = 0
    scheduled_prefill_seqs: int = 0     # Σ per-round count (Table 10)
    scheduled_prefill_tokens: int = 0
    scheduled_decode_tokens: int = 0
    preemptions: int = 0                # KV-pressure evictions (all modes)
    swap_preemptions: int = 0           # ... of which swapped out (not recomputed)
    swap_restores: int = 0              # swapped victims restored (swap-in)
    kv_deferrals: int = 0               # chunks deferred for lack of blocks
    swap_deferrals: int = 0             # restores deferred (SWAPPING/space/slots)
    late_stops: int = 0                 # stop-token terminations applied at drain
    refunded_decode_tokens: int = 0     # over-scheduled decodes unwound by stops
    exports: int = 0                    # requests detached for cross-replica handoff
    sheds: int = 0                      # SLO load shedding (admission + queue)
    failovers: int = 0                  # requests evacuated off this scheduler
    #                                     by replica-failure recovery
    quarantined: int = 0                # non-finite requests terminated
    rolled_back_decode_tokens: int = 0  # undrained tokens discarded by crash
    #                                     or quarantine unwinds (VTC refunded)
    # tiered KV hierarchy (host staging as a managed tier):
    prefetched_restores: int = 0        # restores run early by the prefetcher
    restore_wait_rounds: int = 0        # Σ rounds spent host-staged before restore
    host_demotions: int = 0             # staged records host-evicted under the
    #                                     byte budget (victim folded to recompute)
    partial_restores: int = 0           # tail-only swap-ins (prefix recomputed)
    tail_restored_tokens: int = 0       # tokens restored by partial swap-ins
    tail_aborts: int = 0                # tail records dropped because restore
    #                                     preconditions diverged (cache jump)
    apc: APCStats = field(default_factory=APCStats)

    @property
    def avg_prefill_seqs_per_round(self) -> float:
        return self.scheduled_prefill_seqs / max(self.rounds, 1)

    @property
    def avg_chunk_size(self) -> float:
        # prefill tokens per round (incl. rounds with zero prefill)
        return self.scheduled_prefill_tokens / max(self.rounds, 1)

    @property
    def avg_tokens_per_prefill_seq(self) -> float:
        # Paper's Table 10 "Avg. Prefill Chunk Size": tokens per SCHEDULED
        # prefill sequence — fragmentation shows as values near 1.
        return self.scheduled_prefill_tokens / max(self.scheduled_prefill_seqs, 1)


class ChunkedPrefillScheduler:
    def __init__(
        self,
        cfg: SchedulerConfig,
        *,
        predictor=None,
        kv_pool=None,           # optional KVBlockPool: memory features + booking
        kv_booking: bool = True,  # False: legacy mode, pool is features-only
        shared_vtc=None,        # VirtualTokenCounter shared across replicas
    ):
        if cfg.lprs is not None and predictor is None:
            raise ValueError("LPRS requires a latency predictor")
        self.cfg = cfg
        self.predictor = predictor
        self.kv_pool = kv_pool
        self.kv_booking = kv_booking
        # the credit closure reads self.kv_pool dynamically: attach_kv_pool
        # may run after the queue is built, and a pool-less scheduler (pure
        # simulator) simply scores every candidate 0
        credit_fn = self._cache_credit if cfg.cache_credit else None
        if cfg.fairness is not None:
            from repro_torch.tenancy import FairnessState

            self.fairness: Optional["FairnessState"] = FairnessState(
                cfg.fairness,
                policy_factory=lambda: make_policy(
                    cfg.policy, alpha=cfg.alpha, beta=cfg.beta,
                    credit_fn=credit_fn,
                ),
                vtc=shared_vtc,
            )
            self.queue = self.fairness.queue
        else:
            self.fairness = None
            self.queue: PrefillQueue = make_policy(
                cfg.policy, alpha=cfg.alpha, beta=cfg.beta,
                credit_fn=credit_fn,
            )
        # SLO tier: the tracker projects deadlines/feasibility; the fairness
        # subsystem gains the admission shed gate + fair-queue urgency
        self.slo: Optional[SLOTracker] = None
        if cfg.slo is not None:
            if self.fairness is None:
                raise ValueError(
                    "SchedulerConfig.slo requires fairness: deadlines live on "
                    "TenantSpec (ttft_slo_s / e2e_slo_s)"
                )
            self.slo = SLOTracker(
                cfg.slo, self.fairness.registry, token_budget=cfg.token_budget
            )
            self.fairness.attach_slo(self.slo)
        self._prev_round_busy = False
        self._now = 0.0                 # last schedule() clock (victim ranking)
        # decoding membership is maintained INCREMENTALLY (insert on prefill
        # completion, O(1) pop on finish/preemption) — never rebuilt with a
        # full-population comprehension inside the per-round hot path
        self._decoding: Dict[int, Request] = {}
        self._deferred_this_round: List[Request] = []
        self.stats = SchedulerStats()
        # spans of schedule(), of each LPRS search and of queue waits (a
        # ReplicaServer hands its tracer over; off by default)
        self.tracer = OFF
        self._round = 0
        self._slot_binder = None
        self._slot_releaser = None
        self._bound_slots: set = set()   # req_ids currently holding a slot
        # swap-out preemption (attach_swap): "recompute" discards victims' KV,
        # "swap" stages it host-side and chooses per victim via the cost model
        self.preemption_mode = "recompute"
        self._swapper = None             # engine hook: gather + slot release
        self._swap_restorer = None       # engine hook: scatter staged KV back
        self._swap_cost = None           # CostModel-like (swap bytes vs FLOPs)
        self._swap_restorer_tail = None  # engine hook: scatter a staged tail
        self._payload_slicer = None      # engine hook: trim payload on shrink
        # per-victim restore telemetry: the round each swap-preemption was
        # stamped (restore_wait_rounds accumulates the diff at restore time)
        # and consecutive restore deferrals (the partial swap-in trigger)
        self._swap_round: Dict[int, int] = {}
        self._restore_defers: Dict[int, int] = {}
        if self._books():
            self._apply_tenant_quotas()

    # -- KV wiring ----------------------------------------------------------
    def attach_kv_pool(self, kv_pool, *, booking: bool = True) -> None:
        """Late-bind a pool (serve loops that construct the scheduler first).
        Tenant quotas only apply when the scheduler books blocks — the legacy
        features-only mode predates quotas and must not enforce them."""
        self.kv_pool = kv_pool
        self.kv_booking = booking
        if self._books():
            self._apply_tenant_quotas()

    def _apply_tenant_quotas(self) -> None:
        """Charge per-tenant KV quotas (TenantSpec.kv_quota_frac) into the pool."""
        if self.fairness is None:
            return
        n_blocks = self.kv_pool.cfg.n_blocks
        for spec in self.fairness.registry:
            frac = getattr(spec, "kv_quota_frac", None)
            if frac:
                self.kv_pool.set_tenant_quota(spec.name, max(1, int(frac * n_blocks)))

    def _books(self) -> bool:
        return self.kv_pool is not None and self.kv_booking

    def _cache_credit(self, req: Request) -> float:
        """Cache-aware aging credit (``cfg.cache_credit`` per resident
        token): evaluated whenever the queue (re-)keys the request."""
        if self.kv_pool is None:
            return 0.0
        return self.cfg.cache_credit * self.kv_pool.resident_tokens(req.req_id)

    # -- engine slot wiring (late binding) -----------------------------------
    def attach_slot_binder(self, binder, releaser=None) -> None:
        """Late engine-slot binding: ``binder(req) -> bool`` is consulted
        before the first chunk of a not-yet-started request is committed —
        True means the request holds an execution slot (bound now or
        earlier); False defers the candidate to a later round.  Queued or
        admission-delayed requests therefore never pin slots.  ``releaser``
        (optional) is told about preemptions so the victim's slot frees
        immediately."""
        self._slot_binder = binder
        self._slot_releaser = releaser

    def attach_swap(self, swapper=None, restorer=None, *, cost_model=None,
                    mode: str = "swap", restorer_tail=None,
                    payload_slicer=None) -> None:
        """Enable swap-out preemption (``mode="swap"``): preemption victims'
        KV is staged host-side and they re-enter the fair queue
        decode-resumable instead of prefill-restart.

        ``swapper(req)`` (engine) gathers the victim's pages device-side,
        starts the async device→host copy, releases the slot, and calls
        ``pool.swap_out`` — when absent (simulator), the scheduler swaps the
        pool's accounting directly with ``ready=True``.  ``restorer(req)``
        scatters the staged payload into freshly allocated pages at swap-in.
        ``cost_model`` decides swap-vs-recompute per victim (swap bytes vs
        recompute FLOPs); with no model attached, swap always wins.

        Partial swap-in hooks (``cfg.partial_restore_after``):
        ``restorer_tail(req, payload, tail_start_blocks)`` scatters a
        tail-shrunk payload behind the re-prefilled prefix;
        ``payload_slicer(payload, tail_start_blocks, n_blocks)`` trims the
        staged arrays when a record is shrunk.  Accounting-only callers
        (the simulator) leave both None."""
        if mode not in ("swap", "recompute"):
            raise ValueError(f"unknown preemption mode {mode!r}")
        self.preemption_mode = mode
        self._swapper = swapper
        self._swap_restorer = restorer
        self._swap_cost = cost_model
        self._swap_restorer_tail = restorer_tail
        self._payload_slicer = payload_slicer

    # -- intake ------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue a request; returns False if hard-quota admission
        (``admission_policy="reject"``) refused it.  A rejected request is
        marked FINISHED (with no completion timestamps, so latency metrics
        ignore it) so serve loops terminate and callers can release any
        slot/KV resources they reserved for it.  Under the ``queue``
        admission policy an over-budget request is parked in a delay pen and
        enters the fair queue once its tenant's token bucket refills."""
        assert req.state == RequestState.WAITING
        if self.fairness is not None:
            decision = self.fairness.admit(req)
            if not decision.admitted:
                req.state = RequestState.FINISHED
                if decision.shed:
                    # SLO load shedding: the deadline was infeasible on
                    # arrival — shed, not rejected-for-rate (finish_time
                    # stays None either way; metrics split on shed_reason)
                    req.shed_reason = "admission"
                    self.stats.sheds += 1
                return False
            if decision.delayed:
                self.queue.add_delayed(req, decision.ready_at)
                return True
        self.queue.add(req)
        return True

    def submit_handoff(self, req: Request) -> None:
        """Enqueue a request whose staged KV was just imported into this
        scheduler's pool (cross-replica handoff).  Admission is NOT re-run —
        the request was assessed once, at the prefill pool; charging its
        token bucket on both sides of the link would double-bill the tenant.
        The ordinary ``schedule()`` swap-restore path picks it up: it is
        decode-resumable, so zero prefill tokens are ever scheduled for it
        here."""
        assert req.state == RequestState.WAITING and req.swapped, (
            req.state, req.swapped,
        )
        self.queue.add(req)

    def retract_handoff(self, req: Request) -> None:
        """Inverse of ``submit_handoff`` BEFORE the restore ran: the request
        died (late stop applied at the source drain) after its staged KV was
        prefetched into this scheduler's pool.  Remove it from the queue and
        drop the imported staging record + registration — nothing was
        booked, bound, or fairness-charged here yet, so nothing else needs
        unwinding."""
        if req in self.queue:
            self.queue.remove(req)
        if self.kv_pool is not None:
            self.kv_pool.drop_swap(req.req_id)
            self.kv_pool.release(req.req_id)

    def export_request(self, req: Request) -> None:
        """Detach a request from this scheduler without releasing its pool
        state (cross-replica handoff: the caller owns migrating the staged
        KV).  The inverse of ``submit_handoff`` on the source side."""
        self._decoding.pop(req.req_id, None)
        self._bound_slots.discard(req.req_id)
        self._swap_round.pop(req.req_id, None)
        self._restore_defers.pop(req.req_id, None)
        if req in self.queue:
            self.queue.remove(req)
        if self.fairness is not None:
            self.fairness.forget(req)
        self.stats.exports += 1

    def _unwind(self, req: Request, batch: Optional[ScheduledBatch] = None) -> None:
        """Detach ``req`` from everything this scheduler holds for it: decode
        set, engine slot, queue membership, any entries in a scheduled-but-
        not-yet-dispatched ``batch`` (whose phantom booking is refunded from
        the stats), KV blocks AND host-staged swap records, and fairness
        bookkeeping.  The request's own state is left untouched — callers
        decide whether this is a terminal retire (stop/shed) or an
        evacuation (failover re-placement)."""
        self._decoding.pop(req.req_id, None)
        self._bound_slots.discard(req.req_id)
        self._swap_round.pop(req.req_id, None)
        self._restore_defers.pop(req.req_id, None)
        if self.tracer.on:
            self.tracer.queue_close(req.req_id)
        if req in self.queue:
            self.queue.remove(req)
        if batch is not None:
            if req in batch.decode_reqs:
                batch.decode_reqs.remove(req)
                self.stats.scheduled_decode_tokens -= 1
                self.stats.refunded_decode_tokens += 1
            for i, (r, c) in enumerate(batch.prefill_chunks):
                if r.req_id == req.req_id:
                    batch.prefill_chunks.pop(i)
                    self.stats.scheduled_prefill_tokens -= int(c)
                    self.stats.scheduled_prefill_seqs -= 1
                    break
        if self._books():
            # the booking refund: blocks the phantom round allocated go back
            # with everything else the request held; a mid-swap victim's
            # staging entry is dropped instead (no blocks on either side)
            self.kv_pool.drop_swap(req.req_id)
            self.kv_pool.release(req.req_id)
        if self._slot_releaser is not None:
            self._slot_releaser(req)
        if self.fairness is not None:
            self.fairness.forget(req)

    def on_stop(self, req: Request, batch: Optional[ScheduledBatch] = None) -> None:
        """A value-dependent stop (EOS) terminated ``req`` outside the normal
        ``on_batch_done`` path — in a pipelined engine the real token id
        lands one round LATE, so by the time the stop is observable the
        request may already be booked into the next, not-yet-dispatched
        round (``batch``), sitting in the queue as a preemption victim, or
        host-staged mid-swap.  Unwind whatever the over-scheduled round
        booked and retire the request everywhere."""
        self._unwind(req, batch)
        self.stats.late_stops += 1

    def evict_request(self, req: Request, batch: Optional[ScheduledBatch] = None) -> None:
        """Failover evacuation: detach a LIVE request from this scheduler
        entirely (its replica crashed or was declared dead) without marking
        it terminal — the router re-places it on a survivor, either
        decode-resumable from a recovered staging record or re-prefilled
        through the ``preempt()`` fold."""
        self._unwind(req, batch)
        self.stats.failovers += 1

    def requeue_failed(self, req: Request) -> None:
        """Re-enqueue a request this scheduler still owns after a crashed
        round was unwound (the caller already ran ``preempt()`` /
        re-registered its pool entry).  Admission is NOT re-run: the request
        was admitted once and its token bucket already charged — a crash
        must not double-bill the tenant."""
        assert req.state == RequestState.WAITING, req.state
        if self.tracer.on:
            self.tracer.queue_open(req.req_id, requeue=1)
        if req in self.queue:
            self.queue.update(req)
        else:
            self.queue.add(req)

    def refund_rolled_back(self, req: Request, *, first_token: bool = False) -> None:
        """Refund the accounting of ONE rolled-back undrained token (a crash
        or quarantine discarded it before delivery): the VTC charge comes
        back so fleet-wide charge keeps equaling executed-and-surviving
        work, and the scheduled-token stats shed the same token.  A token
        that rode a prefill completion was charged as the first-token bonus
        (not counted in ``scheduled_decode_tokens``), so only the fairness
        side's first-token ledger is decremented for it."""
        if not first_token:
            self.stats.scheduled_decode_tokens -= 1
        self.stats.rolled_back_decode_tokens += 1
        if self.fairness is not None:
            self.fairness.refund_token(req, first_token=first_token)

    @property
    def decoding(self) -> List[Request]:
        """Ongoing decode requests in prefill-completion order (a snapshot —
        membership itself lives in an insertion-ordered dict)."""
        return list(self._decoding.values())

    def has_work(self) -> bool:
        return len(self.queue) > 0 or len(self._decoding) > 0

    # -- one scheduling round -------------------------------------------------
    def schedule(self, now: float) -> ScheduledBatch:
        cfg = self.cfg
        tr = self.tracer
        if tr.on:
            span = tr.open("sched.schedule", round=self._round)
            lprs_chunks, round_pred = 0, None
        batch = ScheduledBatch(round_idx=self._round)
        self._round += 1
        self.stats.rounds += 1
        self._now = now
        if self.slo is not None:
            # fold the previous round's wall time into the EWMA round cost
            # that prices every deadline projection this round
            self.slo.begin_round(now, self._prev_round_busy)
        if self.fairness is not None:
            self.fairness.on_round(now)
        if self.kv_pool is not None:
            # pool time only moves at scheduling points: TTL'd cache blocks
            # expire here, before this round's bookings
            self.kv_pool.advance_clock(now)

        # 1. decode-first: reserve budget for ongoing decodes.  With a booked
        # KV pool every decode token gets its block here (preempting the
        # youngest block-holder under pressure) — a decode is never executed
        # with unbooked memory.
        decode_candidates = list(islice(
            self._decoding.values(),
            min(len(self._decoding), cfg.max_seqs, cfg.token_budget),
        ))
        scheduled_ids: set = set()      # committed this round: preemption-immune
        if self._books():
            batch.decode_reqs = self._book_decode_blocks(
                decode_candidates, batch, scheduled_ids
            )
        else:
            batch.decode_reqs = decode_candidates
        n_decode = len(batch.decode_reqs)
        committed = n_decode

        st = BatchState(
            decode_tokens=n_decode,
            batch_request_count=n_decode,
            sum_decode_context_len=sum(r.context_len for r in batch.decode_reqs),
            max_decode_context_len=max(
                (r.context_len for r in batch.decode_reqs), default=0
            ),
        )
        if self.kv_pool is not None:
            st.kv_used_mb = self.kv_pool.used_mb
            st.kv_free_mb = self.kv_pool.free_mb
            st.hbm_allocated_mb = self.kv_pool.allocated_mb
            st.hbm_reserved_mb = self.kv_pool.reserved_mb

        # deadline-aware LPRS: the tightest admitted deadline (decode set +
        # queued backlog) replaces the static T* for every chunk search this
        # round — slack is spread over predicted_resume_rounds per request
        slo_target_ms = None
        if (
            self.slo is not None
            and self.slo.cfg.deadline_lprs
            and cfg.lprs is not None
        ):
            slo_target_ms = self.slo.round_target_ms(
                list(batch.decode_reqs) + list(self.queue.requests()),
                now,
                cfg.lprs.target_latency_ms,
            )

        # 2.-3. rank prefill candidates, allocate residual budget in order
        cap = (
            activity_cap(
                cfg.apc,
                n_decode=n_decode,
                max_seqs=cfg.max_seqs,
                token_budget=cfg.token_budget,
                committed=committed,
            )
            if cfg.apc is not None
            else None
        )

        n_active_prefills = 0
        deferred: List[Request] = []
        # popped-but-deferred candidates leave the queue until the round
        # ends; expose them to _pick_victim so a block-holder can't hide
        # from preemption by simply having been scanned earlier this round
        # (with swap-mode's extra deferral states this was a real livelock:
        # a stable pop order kept the only eligible victim in `deferred`
        # every round, so no one could ever make room)
        self._deferred_this_round = deferred
        seq_slots = cfg.max_seqs - n_decode
        blocks = 0
        # slot-exhaustion scan state: once the binder misses, only requests
        # ALREADY holding a slot can still be scheduled this round — scan on
        # until every queued slot-holder has been seen, then stop (never
        # starve a slot-holder, but don't walk a 10k-request backlog either).
        slots_missed = False
        bound_left = len(self._bound_slots - self._decoding.keys())
        MAX_BLOCK_SCAN = 8  # bounded lookahead after APC blocks: keeps O(k log n)
        while committed < cfg.token_budget and seq_slots > 0 and blocks < MAX_BLOCK_SCAN:
            req = self.queue.pop()
            if req is None:
                break

            # SLO load shedding, queue leg: a waiting request whose deadline
            # can no longer be met even at max priority is retired now —
            # burning budget on a guaranteed miss would only push OTHER
            # requests past their deadlines.  (Admission sheds on arrival;
            # this catches deadlines that died while queued or swapped out.)
            if (
                self.slo is not None
                and self.slo.cfg.shed
                and not self.slo.feasible(req, now)
            ):
                self.shed_request(req, reason="deadline")
                continue

            # host-tier demotion fold: the victim's staging record was
            # evicted under the host byte budget after it was swap-preempted
            # — its KV exists on NEITHER tier, so the decode-resumable
            # promise is void.  Fold it (generated tokens into the prompt,
            # vLLM recompute semantics) and let it continue below as an
            # ordinary prefill candidate: a recompute, never a leak.
            if (
                self.kv_pool is not None
                and req.swapped
                and self.kv_pool.swap_state(req.req_id) is None
            ):
                req.preempt()
                self.stats.host_demotions += 1
                self._swap_round.pop(req.req_id, None)
                self._restore_defers.pop(req.req_id, None)

            # swap-out victims come back through the SAME fair queue, but a
            # restore (swap-in) replaces the recompute prefill: one round, not
            # ceil(context/budget).  A mid-flight victim (SWAPPING: its
            # device→host gather has not drained) is deferred WITHOUT
            # touching the slot binder — it must never re-bind a slot in the
            # round (or pipeline window) that is still copying its pages out.
            # (Tail-shrunk records skip this branch: their owner re-prefills
            # the prefix below and restores at the block-exact split.)
            if self.kv_pool is not None and \
                    self.kv_pool.swap_state(req.req_id) is not None and \
                    self.kv_pool.swap_tail_start(req.req_id) == 0:
                if self._try_restore(req, batch, scheduled_ids):
                    if req.remaining_prefill <= 0:
                        # decode-resumable: rejoins the decode set and decodes
                        # from the next round (this round's decode tokens were
                        # already booked); no prefill chunk to size
                        self._decoding[req.req_id] = req
                        continue
                    # mid-prefill victim: fall through and chunk over the
                    # restored KV (binder already consulted by the restore)
                else:
                    self.stats.swap_deferrals += 1
                    self._note_restore_defer(req)
                    deferred.append(req)
                    blocks += 1
                    continue

            # engine-slot gate (late binding): bind BEFORE sizing the chunk —
            # binding may consume a prefix-cache hit, which shrinks
            # remaining_prefill.
            if self._slot_binder is not None:
                if req.req_id in self._bound_slots:
                    bound_left -= 1
                elif slots_missed or not self._slot_binder(req):
                    slots_missed = True
                    deferred.append(req)
                    if bound_left <= 0:
                        break          # no schedulable candidate remains
                    continue
                else:
                    self._bound_slots.add(req.req_id)

            # partial swap-in: a tail-shrunk record keeps the decode-hot
            # tail staged while the owner re-prefills the evicted prefix.
            # Chunks are clipped to the block-exact split point; the moment
            # the prefix lands the staged tail is appended in one restore
            # (prefill_done jumps over it — those positions' KV just
            # scattered in, nothing is recomputed or double-written).
            tail_cap = None
            if self.kv_pool is not None and not req.swapped:
                pool = self.kv_pool
                tail_d = pool.swap_tail_start(req.req_id)
                if tail_d > 0:
                    s = tail_d * pool.cfg.block_size
                    if req.prefill_done > s or \
                            pool.swap_tokens(req.req_id) >= req.prompt_len:
                        # preconditions diverged (a prefix-cache hit at slot
                        # bind jumped past the split): the tail can no longer
                        # land behind a block-exact prefix — drop it and
                        # prefill the remainder normally
                        pool.drop_swap(req.req_id)
                        self.stats.tail_aborts += 1
                        self._swap_round.pop(req.req_id, None)
                    elif req.prefill_done == s:
                        if not self._restore_tail(req, tail_d, batch,
                                                  scheduled_ids):
                            self.stats.swap_deferrals += 1
                            deferred.append(req)
                            blocks += 1
                            continue
                        # tail restored: chunk the (>= 1) remaining prompt
                        # tokens over the rebuilt context
                    else:
                        tail_cap = s - req.prefill_done

            h_i = min(req.remaining_prefill, cfg.token_budget - committed)
            if tail_cap is not None:
                h_i = min(h_i, tail_cap)
            if h_i <= 0:
                deferred.append(req)
                break

            # chunk proposal: LPRS (Algorithm 1) or static rule (Eq. 7)
            if cfg.lprs is not None:
                if tr.on:
                    lprs_span = tr.open("sched.lprs")
                c, pred_ms, n_cands = search(
                    remaining=req.remaining_prefill,
                    committed=committed,
                    token_budget=cfg.token_budget,
                    batch_state=st,
                    processed=req.prefill_done,
                    predictor=self.predictor,
                    cfg=cfg.lprs,
                    target_ms=slo_target_ms,
                )
                if tr.on:
                    tr.close(lprs_span, candidates=n_cands, chunk=c,
                             pred_ms=pred_ms)
                c_lprs = c
            else:
                c = h_i

            # APC gate (Eq. 14); a deadline-urgent request's chunk bypasses
            # the cap/min-chunk blocks (SLO tier: a protected tenant's
            # prefill is never blocked below the deadline-feasible chunk)
            if cfg.apc is not None:
                urgent = (
                    self.slo is not None
                    and self.slo.cfg.apc_protect
                    and self.slo.urgent(req, now)
                )
                c = apc_apply(
                    cfg.apc,
                    self.stats.apc,
                    proposed=c,
                    remaining=req.remaining_prefill,
                    upper_bound=h_i,
                    n_active_prefills=n_active_prefills,
                    cap=cap,
                    urgent=urgent,
                )

            if tail_cap is not None:
                # never prefill past the split: the chunk that would cross
                # it instead stops exactly on the block boundary the staged
                # tail restores onto
                c = min(int(c), tail_cap)

            # KV gate: shrink the chunk to what the pool (and the tenant's
            # quota) can actually back RIGHT NOW — chunk-granular allocation.
            # A huge prompt takes whatever blocks are available this round and
            # defers the rest instead of memory-blocking every later arrival.
            if self._books() and c > 0:
                fit = self.kv_pool.max_new_tokens(req.req_id, tenant=req.tenant)
                if fit <= 0 and self._make_room(req, batch, scheduled_ids):
                    fit = self.kv_pool.max_new_tokens(req.req_id, tenant=req.tenant)
                if fit < c:
                    c = min(int(c), int(fit))
                    if c < h_i:
                        self.stats.kv_deferrals += 1

            if c <= 0:
                # zero-progress deferral: a request with no prefill done and
                # no blocks held must not pin its freshly bound slot while
                # blocked (e.g. quota-starved) — unbind, re-bind when it can
                # actually run
                if (self._slot_releaser is not None
                        and req.prefill_done == 0
                        and not (self.kv_pool is not None
                                 and self.kv_pool.tables.get(req.req_id))):
                    self._slot_releaser(req)
                    self._bound_slots.discard(req.req_id)
                deferred.append(req)
                blocks += 1
                # cap blocks are global to the round — no later candidate can
                # pass; min-chunk blocks are per-request, keep scanning a
                # bounded number of candidates.
                if cfg.apc is not None and n_active_prefills >= cap:
                    break
                continue
            blocks = 0

            if self._books():
                self.kv_pool.allocate(req.req_id, int(c), tenant=req.tenant)
                scheduled_ids.add(req.req_id)
            batch.prefill_chunks.append((req, int(c)))
            if tr.on:
                tr.queue_close(req.req_id)
                if cfg.lprs is not None:
                    # the search predicted this very state unless a gate
                    # changed its chunk
                    lprs_chunks += 1
                    round_pred = pred_ms if c == c_lprs else None
            st = st.with_extra_prefill(int(c), req.prefill_done)
            committed += int(c)
            seq_slots -= 1
            if req.remaining_prefill - c > 0:
                n_active_prefills += 1

        for r in deferred:
            self.queue.add(r)
        self._deferred_this_round = []

        # swap-in prefetch: restore up to ``swap_prefetch_depth`` host-ready
        # victims with whatever capacity this round left over — the cold
        # "restore round" (queue pop under congestion) disappears for them
        self._prefetch_restores(batch, scheduled_ids)

        batch.state = st
        self.stats.scheduled_prefill_seqs += len(batch.prefill_chunks)
        self.stats.scheduled_prefill_tokens += batch.prefill_tokens
        self.stats.scheduled_decode_tokens += batch.decode_tokens
        self._prev_round_busy = not batch.is_empty()
        if tr.on:
            attrs = {}
            if lprs_chunks:
                if round_pred is None:
                    round_pred = float(self.predictor.predict(st.features()[None])[0])
                attrs = {"lprs_chunks": lprs_chunks, "pred_ms": round_pred,
                         "target_ms": (cfg.lprs.target_latency_ms
                                       if slo_target_ms is None else slo_target_ms)}
            tr.close(span, decode=n_decode, decode_tokens=batch.decode_tokens,
                     prefill=len(batch.prefill_chunks),
                     prefill_tokens=batch.prefill_tokens, **attrs)
        return batch

    def shed_request(self, req: Request, *, reason: str,
                     batch: Optional[ScheduledBatch] = None) -> None:
        """Terminal retire without service completion: SLO load shedding of a
        projected-infeasible deadline, numerics quarantine, or a request that
        exhausted its failover retries.  Full ``on_stop``-style unwinding
        (queue membership, KV blocks AND host-staged swap records, engine
        slot, fairness bookkeeping, any entries in a scheduled-but-undispatched
        ``batch``).  The request ends FINISHED with ``finish_time`` None and
        ``shed_reason`` set — a shed attainment bucket, never a violation."""
        self._unwind(req, batch)
        req.shed_reason = reason
        req.state = RequestState.FINISHED
        self.stats.sheds += 1

    # -- KV booking / preemption ---------------------------------------------
    def _book_decode_blocks(
        self, candidates: List[Request], batch: ScheduledBatch, scheduled_ids: set
    ) -> List[Request]:
        """Allocate one token of KV per decode candidate, evicting the
        youngest block-holder when the pool (or the tenant quota) is out of
        blocks.  A candidate that cannot be backed is deferred to the next
        round rather than executed unbooked."""
        kept: List[Request] = []
        for r in candidates:
            if r.state != RequestState.DECODING:       # preempted this round
                continue
            if self.kv_pool.can_allocate(r.req_id, 1, tenant=r.tenant) or (
                self._make_room(r, batch, scheduled_ids)
            ):
                self.kv_pool.allocate(r.req_id, 1, tenant=r.tenant)
                kept.append(r)
                scheduled_ids.add(r.req_id)
        return kept

    def _make_room(
        self, req: Request, batch: ScheduledBatch, scheduled_ids: set,
        *, tokens: int = 1,
    ) -> bool:
        """Preempt strictly-younger block-holders until ``req`` can allocate
        ``tokens`` more (True) or no eligible victim remains (False).  When
        the tenant quota — not pool space — is the binding limit, only
        same-tenant victims can help.  Restores pass their full staged length
        (a swapped request holds nothing, so ``blocks_needed`` equals its
        whole restore size)."""
        pool = self.kv_pool
        while not pool.can_allocate(req.req_id, tokens, tenant=req.tenant):
            same_tenant = pool.quota_blocked(req.req_id, tokens, tenant=req.tenant)
            victim = self._pick_victim(
                req, scheduled_ids, tenant=req.tenant if same_tenant else None
            )
            if victim is None:
                return False
            self._preempt(victim, batch)
        return True

    def _try_restore(
        self, req: Request, batch: ScheduledBatch, scheduled_ids: set
    ) -> bool:
        """Swap a victim's staged KV back onto the device: bind a slot,
        allocate fresh blocks (re-charging its tenant quota, preempting
        strictly-younger holders if needed), scatter the payload via the
        engine hook, and resume the request.  Returns False — deferring the
        request untouched — while the swap-out copy is still in flight
        (SWAPPING), or when no slot/blocks are available."""
        pool = self.kv_pool
        if not pool.swap_ready(req.req_id):
            return False               # mid-flight: never re-bind this round
        tokens = pool.swap_tokens(req.req_id)
        bound_here = False
        if self._slot_binder is not None and req.req_id not in self._bound_slots:
            if not self._slot_binder(req):
                return False
            self._bound_slots.add(req.req_id)
            bound_here = True
        if not pool.can_allocate(req.req_id, tokens, tenant=req.tenant) and \
                not self._make_room(req, batch, scheduled_ids, tokens=tokens):
            if bound_here and self._slot_releaser is not None:
                # blocks didn't materialize: don't pin the fresh slot
                self._slot_releaser(req)
                self._bound_slots.discard(req.req_id)
            return False
        if pool.swap_state(req.req_id) is None:
            # making room swap-staged younger victims, and THEIR staging
            # charged the host tier past its budget — the stage-time-LRU
            # eviction landed on the very record being restored.  Nothing
            # left to scatter: defer untouched; next round's demotion fold
            # recomputes this request.
            if bound_here and self._slot_releaser is not None:
                self._slot_releaser(req)
                self._bound_slots.discard(req.req_id)
            return False
        _ids, payload = pool.swap_in(req.req_id, tenant=req.tenant)
        if self._swap_restorer is not None:
            self._swap_restorer(req, payload)
        req.resume()
        scheduled_ids.add(req.req_id)   # restore-immune for this round
        self.stats.swap_restores += 1
        self._note_restored(req.req_id)
        batch.restored.append(req)
        batch.swap_in_mb += tokens * pool.cfg.bytes_per_token / 2**20
        if self.fairness is not None and req.state == RequestState.DECODING:
            # it will never finish a prefill chunk: retire its fair-queue
            # ownership and mark it decode-active again
            self.fairness.on_resume(req)
        return True

    def _note_restored(self, req_id: int) -> None:
        """A restore (full, prefetched, or tail) completed: accumulate the
        rounds this victim spent host-staged and clear its telemetry."""
        if self.tracer.on:
            self.tracer.queue_close(req_id)
        stamp = self._swap_round.pop(req_id, None)
        if stamp is not None:
            self.stats.restore_wait_rounds += max(0, self._round - stamp)
        self._restore_defers.pop(req_id, None)

    def _note_restore_defer(self, req: Request) -> None:
        """Count a consecutive restore deferral; past
        ``cfg.partial_restore_after`` of them — with the payload
        host-resident and the block shortfall (not slots) the binding limit
        — shrink the record to the largest tail the pool could back right
        now.  The owner is folded (``preempt()``) and re-prefills the
        evicted prefix chunk-by-chunk; only ``n - d`` blocks ever need to
        be free at once, so fragmentation can't pin the victim host-side
        forever."""
        after = self.cfg.partial_restore_after
        if after is None:
            return
        rid = req.req_id
        n = self._restore_defers.get(rid, 0) + 1
        self._restore_defers[rid] = n
        pool = self.kv_pool
        if n < after or not req.swapped or not pool.swap_ready(rid):
            return
        if pool.can_swap_in(rid, tenant=req.tenant):
            return        # blocked on slots, not memory: shrinking can't help
        bs = pool.cfg.block_size
        tokens = pool.swap_tokens(rid)
        nb = (tokens + bs - 1) // bs
        if nb < 2 or tokens >= req.prompt_len + (req.generated - req.folded_tokens):
            return        # nothing to split / stored length would not fit
        d = nb - max(1, min(pool.allocatable_blocks(), nb - 1))
        pool.shrink_swap_to_tail(rid, d, self._payload_slicer)
        req.preempt()     # fold: the prefix re-prefills from scratch
        self._restore_defers.pop(rid, None)

    def _restore_tail(
        self, req: Request, tail_d: int, batch: ScheduledBatch,
        scheduled_ids: set,
    ) -> bool:
        """Complete a partial swap-in: the owner's re-prefill sits exactly on
        the block split, so append fresh blocks for the staged tail, scatter
        it via the engine hook, and jump ``prefill_done`` over the restored
        positions (>= 1 prompt token always remains — its chunk writes
        genuinely new KV and the completing round samples normally)."""
        pool = self.kv_pool
        tokens = pool.swap_tokens(req.req_id)
        tail_tokens = tokens - tail_d * pool.cfg.block_size
        if not pool.can_swap_in(req.req_id, tenant=req.tenant) and \
                not self._make_room(req, batch, scheduled_ids,
                                    tokens=tail_tokens):
            return False
        if pool.swap_state(req.req_id) is None:
            # room-making swap-outs evicted this tail record off the host
            # tier: the staged tail is gone, so fall back to prefilling the
            # remainder (next round sees tail_start == 0 and chunks on)
            self.stats.tail_aborts += 1
            self._swap_round.pop(req.req_id, None)
            return False
        _ids, payload = pool.swap_in_tail(req.req_id, tenant=req.tenant)
        if self._swap_restorer_tail is not None:
            self._swap_restorer_tail(req, payload, tail_d)
        req.prefill_done = tokens
        scheduled_ids.add(req.req_id)   # restore-immune for this round
        self.stats.swap_restores += 1
        self.stats.partial_restores += 1
        self.stats.tail_restored_tokens += tail_tokens
        self._note_restored(req.req_id)
        batch.restored.append(req)
        batch.swap_in_mb += tail_tokens * pool.cfg.bytes_per_token / 2**20
        return True

    def _prefetch_restores(self, batch: ScheduledBatch,
                           scheduled_ids: set) -> None:
        """End-of-round swap-in prefetch: restore up to
        ``cfg.swap_prefetch_depth`` host-ready victims using strictly
        leftover capacity — free blocks (``can_swap_in``, no ``_make_room``)
        and free slots (a binder miss ends the pass).  A decode-resumable
        victim enters the decode set and decodes from the NEXT round's
        decode-first pass, skipping the cold restore round a congested pop
        path may never have reached; a mid-prefill victim re-queues and
        chunks over its restored KV.  Oldest swap-preemption first."""
        depth = self.cfg.swap_prefetch_depth
        if depth <= 0 or self.kv_pool is None or \
                self.preemption_mode != "swap":
            return
        pool = self.kv_pool
        cands = [
            r for r in self.queue.requests()
            if r.swapped
            and r.req_id not in scheduled_ids
            and pool.swap_ready(r.req_id)
            and pool.swap_tail_start(r.req_id) == 0
        ]
        cands.sort(key=lambda r: (
            self._swap_round.get(r.req_id, self._round),
            r.arrival_time, r.req_id,
        ))
        done = 0
        for r in cands:
            if done >= depth:
                break
            if not pool.can_swap_in(r.req_id, tenant=r.tenant):
                continue               # leftover blocks only: no preemption
            if self._slot_binder is not None and \
                    r.req_id not in self._bound_slots:
                if not self._slot_binder(r):
                    break              # no free slot — none will appear now
                self._bound_slots.add(r.req_id)
            self.queue.remove(r)
            tokens = pool.swap_tokens(r.req_id)
            _ids, payload = pool.swap_in(r.req_id, tenant=r.tenant)
            if self._swap_restorer is not None:
                self._swap_restorer(r, payload)
            r.resume()
            scheduled_ids.add(r.req_id)
            self.stats.swap_restores += 1
            self.stats.prefetched_restores += 1
            self._note_restored(r.req_id)
            batch.restored.append(r)
            batch.swap_in_mb += tokens * pool.cfg.bytes_per_token / 2**20
            if r.remaining_prefill <= 0:
                self._decoding[r.req_id] = r
                if self.fairness is not None:
                    self.fairness.on_resume(r)
            else:
                self.queue.add(r)      # chunk over the restored KV next round
            done += 1

    def _should_swap(self, victim: Request) -> bool:
        """Swap-vs-recompute, per victim: compare the swap transfer cost
        (bytes over the host link, out + back in) against re-prefilling the
        victim's whole context (FLOPs plus per-round overhead across the
        rounds LPRS predicts the recompute takes).  No cost model attached
        (or zero-byte accounting pools): swapping wins."""
        if self.preemption_mode != "swap":
            return False
        pool = self.kv_pool
        tokens = pool.lens.get(victim.req_id, 0)
        if tokens <= 0 or pool.swap_state(victim.req_id) is not None:
            return False
        if not pool.host_can_stage(tokens):
            # host tier pinned full by bytes this pool cannot evict (other
            # pools / the handoff store on a shared tier): recompute instead
            # of asserting inside the stage-time reservation
            return False
        if self._swap_cost is None:
            return True
        swap_ms = self._swap_cost.swap_cost_ms(tokens, pool.cfg.bytes_per_token)
        rounds = predicted_resume_rounds(
            tokens, self.cfg.token_budget, swapped=False
        )
        recompute_ms = self._swap_cost.recompute_cost_ms(tokens) + \
            self._swap_cost.cfg.c0_ms * (rounds - 1)
        return swap_ms <= recompute_ms

    def _pick_victim(
        self, requester: Request, scheduled_ids: set, tenant: Optional[str] = None
    ) -> Optional[Request]:
        """Lowest-priority block-holder: the youngest arrival among decoding
        requests and queued (partially prefilled) requests, excluding anything
        already committed to this round's batch.  Only a STRICTLY younger
        victim is eligible — an older request is never preempted for a newer
        one, which makes eviction thrash-free (total order on arrivals).

        With the SLO tier's ``victim_weighting`` on, eligible victims are
        ranked by projected SLO attainment first (a request already violating
        or infeasible sheds before best-effort traffic; a protected,
        deadline-feasible request sheds last), youngest-arrival within a
        class.  Eligibility itself stays strictly-younger in every mode —
        the thrash-freedom total order is load-bearing."""
        pool = self.kv_pool
        best: Optional[Request] = None
        best_key = None
        candidates = (
            list(self._decoding.values())
            + list(self.queue.requests())
            + list(self._deferred_this_round)
        )
        weighted = self.slo is not None and self.slo.cfg.victim_weighting
        for r in candidates:
            if r.req_id == requester.req_id or r.req_id in scheduled_ids:
                continue
            if tenant is not None and r.tenant != tenant:
                continue
            if not pool.tables.get(r.req_id):
                continue
            if (r.arrival_time, r.req_id) <= (requester.arrival_time, requester.req_id):
                continue
            key = (r.arrival_time, r.req_id)
            if weighted:
                key = (self.slo.victim_class(r, self._now),) + key
            if best_key is None or key > best_key:
                best, best_key = r, key
        return best

    def _preempt(self, victim: Request, batch: ScheduledBatch) -> None:
        """Evict one victim: swap its KV out to host staging (swap mode, when
        the cost model favors it) or free its blocks for recompute."""
        was_decoding = victim.state == RequestState.DECODING
        in_queue = victim in self.queue
        is_delayed = getattr(self.queue, "is_delayed", None)
        if self._should_swap(victim):
            tokens = self.kv_pool.lens.get(victim.req_id, 0)
            if self._swapper is not None:
                # engine path: gather pages + start the async device→host
                # copy + release the slot + pool.swap_out (state SWAPPING —
                # restorable only after the engine's drain finalizes it)
                self._swapper(victim)
            else:
                # accounting-only path (simulator): no real copy to wait for
                self.kv_pool.swap_out(victim.req_id, ready=True)
            victim.swap_preempt()
            self.stats.swap_preemptions += 1
            # restore-wait stamp: every restore path (pop, prefetch, tail)
            # accumulates rounds-host-staged against this round index
            self._swap_round[victim.req_id] = self._round
            batch.swapped_out.append(victim)
            batch.swap_out_mb += tokens * self.kv_pool.cfg.bytes_per_token / 2**20
        else:
            self.kv_pool.release(victim.req_id, keep_registration=True)
            victim.preempt()
            if self._slot_releaser is not None:
                self._slot_releaser(victim)    # slot frees for this very round
        self._bound_slots.discard(victim.req_id)
        self.stats.preemptions += 1
        batch.preempted.append(victim)
        if self.tracer.on:
            self.tracer.queue_open(victim.req_id, requeue=1)
        if was_decoding:
            self._decoding.pop(victim.req_id, None)
            self.queue.add(victim)
            if self.fairness is not None:
                self.fairness.on_preempt(victim)
        elif is_delayed is not None and is_delayed(victim):
            pass    # still rate-limit parked: released at its ready time
        elif in_queue:
            self.queue.update(victim)   # remaining_prefill changed: re-key

    # -- post-execution updates ---------------------------------------------
    def on_batch_done(self, batch: ScheduledBatch, now: float) -> None:
        """Apply chunk/token deliveries after the engine executed the batch."""
        tr = self.tracer
        if tr.on:
            span = tr.open("sched.on_batch_done")
        for req, c in batch.prefill_chunks:
            req.receive_chunk(c)
            if req.state == RequestState.DECODING:
                # Sarathi semantics: the round that finishes the prefill also
                # produces the first output token (TTFT = prefill completion).
                req.prefill_end_time = now
                req.receive_token(req.next_token, now)
                if req.state == RequestState.DECODING:
                    self._decoding[req.req_id] = req
            else:
                # back to the queue with updated priority (O(log n))
                self.queue.update(req)
        for req in batch.decode_reqs:
            req.receive_token(req.next_token, now)
        for req in batch.decode_reqs + [q for q, _ in batch.prefill_chunks]:
            if req.state == RequestState.FINISHED:
                self._decoding.pop(req.req_id, None)
                self._bound_slots.discard(req.req_id)
                if self._slot_releaser is not None:
                    # release here too (idempotent): callers driving the
                    # scheduler directly — not through serve() — must not
                    # leak finished requests' slots
                    self._slot_releaser(req)
                if self._books():
                    # the pool's lifecycle ends here: finished requests'
                    # blocks drop their references (hashed blocks stay
                    # cached for prefix reuse)
                    self.kv_pool.release(req.req_id)
        if self.fairness is not None:
            # charge the VTC for tokens actually executed this round and
            # retire prefill-complete requests from the fair queue's books
            self.fairness.on_batch_done(batch)
        if tr.on:
            tr.close(span)
