"""Discrete-event serving simulator.

The scheduler under test is the REAL ``repro_torch.core`` code; only the execution
clock comes from the calibrated cost model (Vidur-style).  This reproduces
the paper's scheduling results faithfully: its own ablation (§4.3.1) shows the
Aging/LPRS/APC gains are queueing/ordering effects, with model execution time
unchanged.

Event loop per round:
  1. admit arrivals with arrival_time <= now (prefix-cache matched at submit:
     cached prompt blocks are acquired and the request's remaining prefill
     shrinks before it ever enters the queue),
  2. scheduler.schedule(now) -> batch (the scheduler books KV blocks
     chunk-granularly and preempts under pressure),
  3. advance clock by the cost model's batch latency (or to the next arrival
     when idle),
  4. scheduler.on_batch_done(batch, now) — also releases finished requests'
     KV references back to the pool/prefix cache.

``legacy_eager_kv=True`` restores the pre-refactor behavior (whole-prompt
allocation at admission, head-of-line blocking when the pool is full, decode
tokens silently unbooked under pressure) for A/B comparison in
``benchmarks/bench_prefix_cache.py``.

Also emits (features, latency) training samples for the LPRS predictor — the
paper's offline profiling pipeline (§3.2.1 step 3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
from repro_torch.engine.costmodel import CostModel
from repro_torch.engine.kv_cache import KVBlockPool
from repro_torch.engine.metrics import (
    LatencyReport, MemoryReport, SLOReport, summarize, summarize_memory,
    summarize_slo,
)


@dataclass
class SimResult:
    report: LatencyReport
    requests: List[Request]
    rounds: int
    sim_time_s: float
    samples: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (features, latency_ms)
    scheduler_stats: Optional[object] = None
    memory: Optional[MemoryReport] = None     # KV pool lifecycle summary
    slo: Optional[SLOReport] = None           # per-tenant attainment gauges


class ServingSimulator:
    def __init__(
        self,
        scheduler: ChunkedPrefillScheduler,
        cost_model: CostModel,
        *,
        kv_pool: Optional[KVBlockPool] = None,
        collect_samples: bool = False,
        idle_step_s: float = 0.001,
        max_rounds: int = 2_000_000,
        horizon_s: Optional[float] = None,
        legacy_eager_kv: bool = False,
        preemption_mode: str = "recompute",
    ):
        self.sched = scheduler
        self.cost = cost_model
        self.kv_pool = kv_pool
        self.collect_samples = collect_samples
        self.idle_step_s = idle_step_s
        self.max_rounds = max_rounds
        self.horizon_s = horizon_s    # stop mid-backlog at this sim time
        self.legacy_eager_kv = legacy_eager_kv
        if kv_pool is not None:
            # the scheduler owns block booking (unless running the legacy
            # eager-admission baseline, where the pool is features-only)
            scheduler.attach_kv_pool(kv_pool, booking=not legacy_eager_kv)
            if not legacy_eager_kv:
                # accounting-only swap (no engine hooks: records are ready
                # immediately); the cost model prices the transfers into the
                # round latency and decides swap-vs-recompute per victim
                scheduler.attach_swap(cost_model=cost_model,
                                      mode=preemption_mode)

    def run(self, requests: List[Request]) -> SimResult:
        pending = sorted(requests, key=lambda r: r.arrival_time)
        next_arrival = 0
        now = 0.0
        rounds = 0
        feats: List[np.ndarray] = []
        lats: List[float] = []

        def admit():
            nonlocal next_arrival
            while next_arrival < len(pending) and pending[next_arrival].arrival_time <= now:
                req = pending[next_arrival]
                if self.kv_pool is not None:
                    if self.legacy_eager_kv:
                        # legacy admission: the ENTIRE prompt must fit the
                        # pool up front or nobody behind this request enters
                        if not self.kv_pool.can_allocate(req.req_id, req.prompt_len,
                                                         tenant=req.tenant):
                            break
                        self.kv_pool.allocate(req.req_id, req.prompt_len,
                                              tenant=req.tenant)
                    else:
                        # register tenant + prompt hashes; a prefix-cache hit
                        # skips the matched prefill work at submit
                        self.kv_pool.submit_request(req)
                if not self.sched.submit(req) and self.kv_pool is not None:
                    self.kv_pool.release(req.req_id)   # admission-rejected
                next_arrival += 1

        while rounds < self.max_rounds:
            if self.horizon_s is not None and now >= self.horizon_s:
                break
            admit()
            if not self.sched.has_work():
                if next_arrival >= len(pending):
                    break
                now = max(now + self.idle_step_s, pending[next_arrival].arrival_time)
                continue

            batch = self.sched.schedule(now)
            if batch.is_empty():
                # nothing schedulable (e.g. APC blocked everything): advance a tick
                now += self.idle_step_s
                continue

            latency_ms = self.cost.batch_latency_ms(batch)
            if self.collect_samples:
                feats.append(batch.state.features())
                lats.append(latency_ms)

            now += latency_ms / 1000.0
            rounds += 1

            if self.kv_pool is not None and self.legacy_eager_kv:
                # legacy decode accounting (the bug the refactor fixes: a full
                # pool silently generates tokens with no blocks booked)
                for r in batch.decode_reqs:
                    if self.kv_pool.can_allocate(r.req_id, 1):
                        self.kv_pool.allocate(r.req_id, 1, tenant=r.tenant)

            self.sched.on_batch_done(batch, now)

            if self.kv_pool is not None and self.legacy_eager_kv:
                for r in batch.decode_reqs + [q for q, _ in batch.prefill_chunks]:
                    if r.state == RequestState.FINISHED:
                        self.kv_pool.release(r.req_id)

        samples = (
            (np.stack(feats), np.asarray(lats)) if self.collect_samples and feats else None
        )
        return SimResult(
            report=summarize(requests, makespan=now),
            requests=requests,
            rounds=rounds,
            sim_time_s=now,
            samples=samples,
            scheduler_stats=self.sched.stats,
            memory=(
                summarize_memory(self.kv_pool, self.sched.stats)
                if self.kv_pool is not None else None
            ),
            slo=(
                summarize_slo(requests, self.sched.fairness.registry)
                if self.sched.fairness is not None else None
            ),
        )


def run_policy(
    requests: List[Request],
    scheduler_cfg: SchedulerConfig,
    *,
    cost_model: Optional[CostModel] = None,
    predictor=None,
    kv_pool: Optional[KVBlockPool] = None,
    collect_samples: bool = False,
    horizon_s: Optional[float] = None,
    legacy_eager_kv: bool = False,
    preemption_mode: str = "recompute",
) -> SimResult:
    """Convenience wrapper: fresh scheduler + simulator over a request list.

    NOTE: Request objects are stateful; pass freshly-generated requests.
    """
    sched = ChunkedPrefillScheduler(
        scheduler_cfg, predictor=predictor, kv_pool=kv_pool,
        kv_booking=not legacy_eager_kv,
    )
    sim = ServingSimulator(
        sched, cost_model or CostModel(), kv_pool=kv_pool,
        collect_samples=collect_samples, horizon_s=horizon_s,
        legacy_eager_kv=legacy_eager_kv, preemption_mode=preemption_mode,
    )
    return sim.run(requests)
