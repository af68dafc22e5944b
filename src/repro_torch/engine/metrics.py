"""Latency metrics: request-level and prefill-level summaries (§4.2).

L_req = finish - arrive; L_pf = prefill_done - arrive; TTFT; TPOT.
Percentile statistics are the primary summary (high-percentile latency is
more informative than the mean in interactive serving).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Request, RequestState

PCTS = (50, 80, 90, 95, 99)


def percentiles(xs: Sequence[float], pcts=PCTS) -> Dict[str, float]:
    if len(xs) == 0:
        return {f"p{p}": float("nan") for p in pcts} | {"mean": float("nan")}
    arr = np.asarray(xs, np.float64)
    out = {f"p{p}": float(np.percentile(arr, p)) for p in pcts}
    out["mean"] = float(arr.mean())
    out["max"] = float(arr.max())
    return out


@dataclass
class LatencyReport:
    e2e: Dict[str, float]
    ttft: Dict[str, float]
    prefill_e2e: Dict[str, float]
    tpot: Dict[str, float]
    n_finished: int
    n_total: int
    makespan: float
    throughput_rps: float

    def row(self) -> Dict[str, float]:
        return {
            "mean_e2e": self.e2e["mean"],
            "p95_e2e": self.e2e["p95"],
            "p99_e2e": self.e2e["p99"],
            "mean_ttft": self.ttft["mean"],
            "p95_ttft": self.ttft["p95"],
            "p99_ttft": self.ttft["p99"],
            "mean_prefill": self.prefill_e2e["mean"],
            "p90_prefill": self.prefill_e2e["p90"],
            "p99_prefill": self.prefill_e2e["p99"],
            "mean_tpot": self.tpot["mean"],
            "throughput_rps": self.throughput_rps,
        }


def summarize(requests: Iterable[Request], makespan: Optional[float] = None) -> LatencyReport:
    reqs = list(requests)
    fin = [r for r in reqs if r.finish_time is not None]
    e2e = [r.e2e_latency() for r in fin]
    ttft = [r.ttft() for r in reqs if r.ttft() is not None]
    pf = [r.prefill_e2e() for r in reqs if r.prefill_e2e() is not None]
    tpot = [
        (r.finish_time - r.first_token_time) / max(r.generated - 1, 1)
        for r in fin
        if r.first_token_time is not None and r.generated > 1
    ]
    ms = makespan if makespan is not None else (
        max((r.finish_time for r in fin), default=0.0)
        - min((r.arrival_time for r in reqs), default=0.0)
    )
    return LatencyReport(
        e2e=percentiles(e2e),
        ttft=percentiles(ttft),
        prefill_e2e=percentiles(pf),
        tpot=percentiles(tpot),
        n_finished=len(fin),
        n_total=len(reqs),
        makespan=ms,
        throughput_rps=len(fin) / ms if ms > 0 else float("nan"),
    )


def cdf_points(xs: Sequence[float], n: int = 100) -> List[tuple]:
    arr = np.sort(np.asarray(xs, np.float64))
    return [(float(arr[int(q * (len(arr) - 1))]), q) for q in np.linspace(0, 1, n)]


# ---------------------------------------------------------------------------
# KV memory-subsystem metrics
# ---------------------------------------------------------------------------


@dataclass
class MemoryReport:
    """One serving run's KV lifecycle summary: prefix-cache effectiveness,
    eviction/preemption pressure, and per-tenant block occupancy."""

    cache_lookups: int
    cache_hit_blocks: int
    cache_miss_blocks: int
    cache_hit_rate: float            # block-level, over all prefix lookups
    cache_hit_tokens: int            # prefill tokens skipped via the cache
    evictions: int                   # cached blocks reclaimed for new allocs
    preemptions: int                 # requests evicted for KV pressure
    kv_deferrals: int                # chunks shrunk/deferred for lack of blocks
    used_blocks: int                 # referenced blocks at end of run
    cached_blocks: int               # refcount-0 blocks held by the cache
    free_blocks: int
    utilization: float
    blocks_by_tenant: Dict[str, int]
    # swap-out preemption traffic (0 everywhere in recompute mode)
    swap_preemptions: int = 0        # victims staged host-side, not recomputed
    swap_restores: int = 0           # staged victims swapped back in
    swapped_out_tokens: int = 0      # Σ tokens moved device -> host
    swapped_in_tokens: int = 0       # Σ tokens moved host -> device
    # tiered KV hierarchy (0 everywhere without the host tier knobs)
    prefetched_restores: int = 0     # restores run early with leftover capacity
    restore_wait_rounds: int = 0     # Σ rounds victims spent host-staged
    host_demotions: int = 0          # staged records evicted under the budget
    partial_restores: int = 0        # tail-only swap-ins (prefix recomputed)
    tail_restored_tokens: int = 0
    host_resident_bytes: int = 0     # host-tier occupancy at end of run
    host_peak_bytes: int = 0
    host_evictions: int = 0          # tier-side eviction count (all causes)

    def row(self) -> Dict[str, float]:
        return {
            "cache_hit_rate": self.cache_hit_rate,
            "cache_hit_tokens": float(self.cache_hit_tokens),
            "evictions": float(self.evictions),
            "preemptions": float(self.preemptions),
            "kv_deferrals": float(self.kv_deferrals),
            "kv_utilization": self.utilization,
            "swap_preemptions": float(self.swap_preemptions),
            "swap_restores": float(self.swap_restores),
            "prefetched_restores": float(self.prefetched_restores),
            "restore_wait_rounds": float(self.restore_wait_rounds),
            "host_demotions": float(self.host_demotions),
            "partial_restores": float(self.partial_restores),
            "host_peak_bytes": float(self.host_peak_bytes),
        }


def summarize_memory(pool, scheduler_stats=None) -> MemoryReport:
    """Build a MemoryReport from a ``KVBlockPool`` (and optionally the
    scheduler's stats, which own the preemption/deferral counters)."""
    s = pool.stats
    return MemoryReport(
        cache_lookups=s.lookups,
        cache_hit_blocks=s.hit_blocks,
        cache_miss_blocks=s.miss_blocks,
        cache_hit_rate=s.hit_rate,
        cache_hit_tokens=s.hit_tokens,
        evictions=s.evictions,
        preemptions=getattr(scheduler_stats, "preemptions", 0),
        kv_deferrals=getattr(scheduler_stats, "kv_deferrals", 0),
        used_blocks=pool.used_blocks,
        cached_blocks=pool.cached_blocks,
        free_blocks=len(pool.free_blocks),
        utilization=pool.utilization(),
        blocks_by_tenant=pool.blocks_by_tenant(),
        swap_preemptions=getattr(scheduler_stats, "swap_preemptions", 0),
        swap_restores=getattr(scheduler_stats, "swap_restores", 0),
        swapped_out_tokens=s.swapped_out_tokens,
        swapped_in_tokens=s.swapped_in_tokens,
        prefetched_restores=getattr(scheduler_stats, "prefetched_restores", 0),
        restore_wait_rounds=getattr(scheduler_stats, "restore_wait_rounds", 0),
        host_demotions=getattr(scheduler_stats, "host_demotions", 0),
        partial_restores=getattr(scheduler_stats, "partial_restores", 0),
        tail_restored_tokens=getattr(scheduler_stats, "tail_restored_tokens", 0),
        host_resident_bytes=pool.host.stats.resident_bytes,
        host_peak_bytes=pool.host.stats.peak_bytes,
        host_evictions=pool.host.stats.evictions,
    )


# ---------------------------------------------------------------------------
# multi-tenant fairness metrics
# ---------------------------------------------------------------------------


def jain_index(xs: Iterable[float]) -> float:
    """Jain's fairness index: (Σx)² / (n·Σx²).  1.0 = perfectly even,
    1/n = one party gets everything.  Empty input → NaN (undefined);
    a single party, or all-zero allocations, → 1.0 (trivially fair)."""
    arr = np.asarray(list(xs), np.float64)
    if arr.size == 0:
        return float("nan")
    ss = float((arr * arr).sum())
    if ss == 0.0:
        return 1.0
    s = float(arr.sum())
    return s * s / (arr.size * ss)


@dataclass
class FairnessReport:
    """Per-tenant latency + service summary for one serving run.

    ``service_tokens``: tokens actually delivered per tenant (prefill
    progress + generated tokens).  ``normalized_service`` divides by the
    tenant's weight — the quantity the VTC equalizes.  ``jain`` is Jain's
    index over normalized service; ``max_service_delta`` is the worst-case
    spread (max - min) of normalized service, the VTC paper's service-bound
    metric.
    """

    per_tenant: Dict[str, LatencyReport]
    service_tokens: Dict[str, float]
    normalized_service: Dict[str, float]
    jain: float
    max_service_delta: float

    def row(self) -> Dict[str, float]:
        out = {"jain": self.jain, "max_service_delta": self.max_service_delta}
        for t, rep in self.per_tenant.items():
            out[f"{t}/p99_ttft"] = rep.ttft["p99"]
            out[f"{t}/mean_e2e"] = rep.e2e["mean"]
            out[f"{t}/service_tokens"] = self.service_tokens[t]
        return out


def request_service_tokens(req: Request) -> float:
    """Tokens the engine actually delivered to one request so far.
    ``context_len`` nets out tokens a preemption folded into the prompt, so
    recompute work is never double-counted as delivered service."""
    return float(req.context_len)


def summarize_by_tenant(
    requests: Iterable[Request],
    *,
    weights: Optional[Dict[str, float]] = None,
    makespan: Optional[float] = None,
) -> FairnessReport:
    reqs = list(requests)
    by_tenant: Dict[str, List[Request]] = {}
    for r in reqs:
        by_tenant.setdefault(r.tenant, []).append(r)
    per_tenant = {
        t: summarize(rs, makespan=makespan) for t, rs in sorted(by_tenant.items())
    }
    service = {
        t: sum(request_service_tokens(r) for r in rs)
        for t, rs in sorted(by_tenant.items())
    }
    weights = weights or {}
    normalized = {t: s / float(weights.get(t, 1.0)) for t, s in service.items()}
    vals = list(normalized.values())
    delta = (max(vals) - min(vals)) if vals else float("nan")
    return FairnessReport(
        per_tenant=per_tenant,
        service_tokens=service,
        normalized_service=normalized,
        jain=jain_index(vals),
        max_service_delta=delta,
    )


# ---------------------------------------------------------------------------
# SLO attainment metrics
# ---------------------------------------------------------------------------


@dataclass
class SLOTenantReport:
    """Attainment buckets for one tenant — every terminal request lands in
    exactly ONE of {attained, violated, shed, rejected}:

      * ``attained``  — served to completion, every configured SLO met
        (vacuously attained when the tenant has no SLOs)
      * ``violated``  — served to completion past a TTFT or E2E target
      * ``shed``      — retired WITHOUT service by SLO load shedding
        (``Request.shed_reason``: "admission" or "deadline")
      * ``rejected``  — refused without service for a non-SLO reason
        (hard token-bucket quota)

    ``finished`` is attained + violated (requests that completed service);
    the bucket identity attained + violated + shed == finished + rejected +
    (shed - rejected) reduces to the partition check
    attained + violated + shed + rejected == terminal requests, which the
    property suite fuzzes.  ``attainment`` counts sheds against the tenant:
    attained / (attained + violated + shed)."""

    attained: int
    violated: int
    shed: int
    rejected: int
    finished: int
    attainment: float
    ttft_slack_s: Dict[str, float]   # percentiles of (ttft_slo - ttft), finished reqs
    e2e_slack_s: Dict[str, float]    # percentiles of (e2e_slo - e2e), finished reqs


@dataclass
class SLOReport:
    """Per-tenant SLO-attainment gauges for one serving run (the llmserve
    prometheus-exporter shape, aggregated at end of run)."""

    per_tenant: Dict[str, SLOTenantReport]
    attained: int
    violated: int
    shed: int
    rejected: int
    attainment: float

    def row(self) -> Dict[str, float]:
        out = {
            "attained": float(self.attained),
            "violated": float(self.violated),
            "shed": float(self.shed),
            "attainment": self.attainment,
        }
        for t, rep in self.per_tenant.items():
            out[f"{t}/attainment"] = rep.attainment
            out[f"{t}/violated"] = float(rep.violated)
            out[f"{t}/shed"] = float(rep.shed)
        return out


# ---------------------------------------------------------------------------
# fault-tolerance / chaos metrics
# ---------------------------------------------------------------------------


@dataclass
class RobustnessReport:
    """One serving run's fault-tolerance summary.

    ``recovered_resumable`` counts failovers that re-placed a host-staged KV
    record on a survivor (zero re-prefilled tokens — the acceptance metric
    of ``bench_failover``); ``requeued_reprefill`` counts retries that had
    to fold-and-recompute.  ``shed_replica_failure`` are terminal sheds
    after ``max_retries`` (or a fully dead fleet).  ``faults_fired`` is the
    injector's total — a chaos run that fired nothing tested nothing."""

    replicas_died: int = 0
    failovers: int = 0
    recovered_resumable: int = 0
    requeued_reprefill: int = 0
    retries: int = 0
    shed_replica_failure: int = 0
    quarantined: int = 0             # NaN/Inf-quarantined requests
    expired_handoffs: int = 0        # TTL'd out of the handoff store
    crash_unwinds: int = 0           # serve-loop crash cleanups
    colocated_fallbacks: int = 0     # degraded-pool colocation decisions
    faults_fired: int = 0
    events: List[str] = None

    def row(self) -> Dict[str, float]:
        return {
            "replicas_died": float(self.replicas_died),
            "failovers": float(self.failovers),
            "recovered_resumable": float(self.recovered_resumable),
            "requeued_reprefill": float(self.requeued_reprefill),
            "shed_replica_failure": float(self.shed_replica_failure),
            "quarantined": float(self.quarantined),
            "expired_handoffs": float(self.expired_handoffs),
            "crash_unwinds": float(self.crash_unwinds),
            "faults_fired": float(self.faults_fired),
        }


def summarize_robustness(rstats, *, injector=None, quarantined: int = 0,
                         crash_unwinds: int = 0,
                         crash_shed: int = 0) -> RobustnessReport:
    """Fold a router's ``FailoverStats`` (plus per-replica counters the
    router does not own — quarantines, crash unwinds, and local
    retry-exhaustion sheds) into a report."""
    return RobustnessReport(
        replicas_died=rstats.replicas_died,
        failovers=rstats.failovers,
        recovered_resumable=rstats.recovered_resumable,
        requeued_reprefill=rstats.requeued_reprefill,
        retries=rstats.retries,
        shed_replica_failure=rstats.shed_replica_failure + crash_shed,
        quarantined=quarantined,
        expired_handoffs=rstats.expired_handoffs,
        crash_unwinds=crash_unwinds,
        colocated_fallbacks=rstats.colocated_fallbacks,
        faults_fired=(injector.count() if injector is not None else 0),
        events=list(rstats.events),
    )


def summarize_slo(requests: Iterable[Request], registry) -> SLOReport:
    """Classify every request into the attainment buckets against its
    tenant's ``ttft_slo_s``/``e2e_slo_s``.  ``registry`` is duck-typed:
    ``.get(name) -> spec`` (a ``TenantRegistry`` works).  Requests still in
    flight (not FINISHED) are not counted in any bucket."""
    by_tenant: Dict[str, List[Request]] = {}
    for r in requests:
        by_tenant.setdefault(r.tenant, []).append(r)

    per_tenant: Dict[str, SLOTenantReport] = {}
    for t, rs in sorted(by_tenant.items()):
        spec = registry.get(t)
        ttft_slo = getattr(spec, "ttft_slo_s", None)
        e2e_slo = getattr(spec, "e2e_slo_s", None)
        attained = violated = shed = rejected = 0
        ttft_slack: List[float] = []
        e2e_slack: List[float] = []
        for r in rs:
            if r.finish_time is not None:
                viol = False
                if ttft_slo is not None and r.ttft() is not None:
                    ttft_slack.append(ttft_slo - r.ttft())
                    viol |= r.ttft() > ttft_slo
                if e2e_slo is not None and r.e2e_latency() is not None:
                    e2e_slack.append(e2e_slo - r.e2e_latency())
                    viol |= r.e2e_latency() > e2e_slo
                if viol:
                    violated += 1
                else:
                    attained += 1
            elif r.state == RequestState.FINISHED:
                # terminal without service: SLO shed or hard-quota reject
                if r.shed_reason is not None:
                    shed += 1
                else:
                    rejected += 1
        per_tenant[t] = SLOTenantReport(
            attained=attained,
            violated=violated,
            shed=shed,
            rejected=rejected,
            finished=attained + violated,
            attainment=attained / max(attained + violated + shed, 1),
            ttft_slack_s=percentiles(ttft_slack),
            e2e_slack_s=percentiles(e2e_slack),
        )

    tot_a = sum(r.attained for r in per_tenant.values())
    tot_v = sum(r.violated for r in per_tenant.values())
    tot_s = sum(r.shed for r in per_tenant.values())
    tot_r = sum(r.rejected for r in per_tenant.values())
    return SLOReport(
        per_tenant=per_tenant,
        attained=tot_a,
        violated=tot_v,
        shed=tot_s,
        rejected=tot_r,
        attainment=tot_a / max(tot_a + tot_v + tot_s, 1),
    )
