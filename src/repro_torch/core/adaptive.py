"""Unified adaptive scheduling controller — the paper's §5 future work:
"a unified adaptive scheduling controller can be developed to jointly
coordinate Aging, LPRS, and APC, and to dynamically adjust scheduling
parameters according to changing online workloads."

Three coordinated feedback loops, each on the quantity its mechanism
controls:

  * LPRS target T*: tracks an EWMA percentile of observed PREFILL-carrying
    round latencies — the engine's efficiency point drifts as context
    lengths grow, a fixed T* goes stale.
  * Aging alpha/|beta|: starvation pressure (oldest wait in queue vs a
    bound) raises the waiting-time weight; absent starvation and under high
    prompt-length dispersion the remaining-work weight dominates
    (SJF-leaning for TTFT).  Re-keying the heap is O(n log n), done every
    ``adjust_every`` rounds only.
  * APC L_min: follows the median scheduled chunk so the minimum-progress
    bar stays meaningful as LPRS's chunks shrink/grow with decode load.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.scheduler import ChunkedPrefillScheduler, ScheduledBatch


@dataclass
class AdaptiveConfig:
    adjust_every: int = 50              # rounds between parameter updates
    # T* loop
    target_percentile: float = 60.0
    target_ewma: float = 0.3            # weight of the new estimate
    target_bounds: tuple = (5.0, 1000.0)
    # fairness loop
    starvation_bound_s: float = 30.0    # oldest queue wait before alpha boost
    ratio_step: float = 1.6             # multiplicative alpha/|beta| step
    ratio_bounds: tuple = (0.01, 100.0)
    # APC loop
    lmin_ewma: float = 0.3
    lmin_bounds: tuple = (8, 512)


@dataclass
class ControllerState:
    rounds: int = 0
    round_lat_ms: List[float] = field(default_factory=list)
    chunk_sizes: List[int] = field(default_factory=list)
    adjustments: List[dict] = field(default_factory=list)


class AdaptiveController:
    def __init__(self, scheduler: ChunkedPrefillScheduler,
                 cfg: Optional[AdaptiveConfig] = None):
        self.sched = scheduler
        self.cfg = cfg or AdaptiveConfig()
        self.state = ControllerState()

    # -- observation (call after every executed round) -----------------------
    def observe(self, batch: ScheduledBatch, latency_ms: float, now: float):
        st = self.state
        st.rounds += 1
        if batch.prefill_tokens > 0:
            st.round_lat_ms.append(latency_ms)
            st.chunk_sizes.extend(c for _, c in batch.prefill_chunks)
        if st.rounds % self.cfg.adjust_every == 0:
            self._adjust(now)

    # -- the three loops -------------------------------------------------------
    def _adjust(self, now: float):
        cfg = self.cfg
        sched = self.sched
        record = {"round": self.state.rounds}

        # 1. LPRS target tracks the observed efficiency point
        if sched.cfg.lprs is not None and self.state.round_lat_ms:
            obs = float(np.percentile(
                self.state.round_lat_ms[-200:], cfg.target_percentile
            ))
            old = sched.cfg.lprs.target_latency_ms
            new = (1 - cfg.target_ewma) * old + cfg.target_ewma * obs
            new = float(np.clip(new, *cfg.target_bounds))
            sched.cfg = dataclasses.replace(
                sched.cfg,
                lprs=dataclasses.replace(sched.cfg.lprs, target_latency_ms=new),
            )
            record["t_star_ms"] = new

        # 2. Aging ratio from starvation pressure
        waiting = list(sched.queue.requests())
        if waiting:
            oldest = max(now - r.arrival_time for r in waiting)
            ratio = sched.cfg.alpha / abs(sched.cfg.beta)
            if oldest > cfg.starvation_bound_s:
                ratio *= cfg.ratio_step            # wait term up
            else:
                plens = [r.remaining_prefill for r in waiting]
                if len(plens) >= 4 and np.std(plens) > np.mean(plens):
                    ratio /= cfg.ratio_step        # dispersion: SJF-leaning
            ratio = float(np.clip(ratio, *cfg.ratio_bounds))
            new_beta = -sched.cfg.alpha / ratio
            if abs(new_beta - sched.cfg.beta) / abs(sched.cfg.beta) > 1e-6:
                sched.cfg = dataclasses.replace(sched.cfg, beta=new_beta)
                self._rekey_queue()
                record["alpha_over_beta"] = ratio

        # 3. APC minimum effective progress follows the observed chunks
        if sched.cfg.apc is not None and self.state.chunk_sizes:
            med = float(np.median(self.state.chunk_sizes[-500:]))
            old = sched.cfg.apc.l_min
            new = int(np.clip(
                (1 - cfg.lmin_ewma) * old + cfg.lmin_ewma * max(med, 1.0),
                *cfg.lmin_bounds,
            ))
            if new != old:
                sched.cfg = dataclasses.replace(
                    sched.cfg, apc=dataclasses.replace(sched.cfg.apc, l_min=new)
                )
                record["l_min"] = new

        if len(record) > 1:
            self.state.adjustments.append(record)

    def _rekey_queue(self):
        """Rebuild the heap under the new (alpha, beta) — O(n log n), done
        only every adjust_every rounds."""
        from repro_torch.core.policies import make_policy

        reqs = list(self.sched.queue.requests())
        self.sched.queue = make_policy(
            "aging", alpha=self.sched.cfg.alpha, beta=self.sched.cfg.beta
        )
        for r in reqs:
            self.sched.queue.add(r)
