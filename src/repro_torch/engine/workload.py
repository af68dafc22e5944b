"""Workload generation: ShareGPT-like mixed prompt lengths + arrival
processes matching the paper's setups (§4.1).

The paper's 200-request ShareGPT replay has median prompt 19.0 tokens and P90
179.4 — a heavily right-skewed distribution.  ``sharegpt_like`` draws from a
log-normal fitted to those two quantiles (mu = ln 19, sigma from the P90/P50
ratio), clipped to the context limit; generation lengths are similarly skewed
and capped at 512 per the paper.

``apc_heterogeneous`` reproduces §4.1's APC ablation mix: 49:1 short
(30-50 tok) to long (200-220 tok) prompts with dynamic arrival rates.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.request import Request

# log-normal fit to the paper's ShareGPT stats: P50 = 19, P90 = 179.4
_SG_MU = math.log(19.0)
_SG_SIGMA = math.log(179.4 / 19.0) / 1.2815515655  # z_{0.9}


@dataclass
class WorkloadSpec:
    n_requests: int = 200
    inter_arrival_s: float = 0.1       # fixed interval (paper) ...
    poisson: bool = False              # ... or Poisson with the same mean rate
    max_context: int = 512
    max_new_tokens: int = 512
    seed: int = 0


def sharegpt_like(spec: WorkloadSpec) -> List[Request]:
    rng = np.random.default_rng(spec.seed)
    prompt = np.clip(
        np.round(rng.lognormal(_SG_MU, _SG_SIGMA, spec.n_requests)), 1, spec.max_context
    ).astype(int)
    # generation lengths: skewed, capped (paper: max 512)
    gen = np.clip(
        np.round(rng.lognormal(math.log(60.0), 1.0, spec.n_requests)), 1, spec.max_new_tokens
    ).astype(int)
    if spec.poisson:
        gaps = rng.exponential(spec.inter_arrival_s, spec.n_requests)
    else:
        gaps = np.full(spec.n_requests, spec.inter_arrival_s)
    arrivals = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return [
        Request(prompt_len=int(p), max_new_tokens=int(g), arrival_time=float(a))
        for p, g, a in zip(prompt, gen, arrivals)
    ]


def apc_heterogeneous(
    n_requests: int = 1000,
    *,
    short_ratio: int = 49,
    long_ratio: int = 1,
    short_range=(30, 50),
    long_range=(200, 220),
    max_new_tokens: int = 64,
    base_interval_s: float = 0.02,
    seed: int = 0,
) -> List[Request]:
    """§4.1 APC ablation workload: 49:1 short:long, dynamic arrival rate."""
    rng = np.random.default_rng(seed)
    period = short_ratio + long_ratio
    reqs: List[Request] = []
    t = 0.0
    for i in range(n_requests):
        if i % period < short_ratio:
            p = int(rng.integers(short_range[0], short_range[1] + 1))
        else:
            p = int(rng.integers(long_range[0], long_range[1] + 1))
        g = int(rng.integers(8, max_new_tokens + 1))
        reqs.append(Request(prompt_len=p, max_new_tokens=g, arrival_time=t))
        # dynamically varying arrival rate (paper: "could change dynamically")
        burst = 0.3 if (i // 100) % 2 == 0 else 1.7
        t += float(rng.exponential(base_interval_s * burst))
    return reqs


def uniform_arrivals(
    n_requests: int,
    interval_s: float,
    *,
    prompt_sampler=None,
    max_seq_len: int = 4096,
    max_new_tokens: int = 256,
    seed: int = 0,
) -> List[Request]:
    """LPRS workloads (§4.4): 1000 requests, uniform 0.1 s / 1.0 s arrivals,
    max sequence length 4096."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        if prompt_sampler is not None:
            p = int(prompt_sampler(rng))
        else:
            p = int(
                np.clip(round(rng.lognormal(math.log(200.0), 1.1)), 8, max_seq_len - max_new_tokens)
            )
        g = int(rng.integers(16, max_new_tokens + 1))
        reqs.append(
            Request(prompt_len=p, max_new_tokens=g, arrival_time=i * interval_s)
        )
    return reqs


def shared_prefix(
    n_requests: int = 200,
    *,
    n_prefixes: int = 4,
    prefix_len: int = 128,
    suffix_range=(16, 64),
    max_new_tokens: int = 32,
    inter_arrival_s: float = 0.05,
    vocab_size: int = 32000,
    tenants: Optional[List[str]] = None,
    seed: int = 0,
) -> List[Request]:
    """Prefix-cache workload: every prompt is one of ``n_prefixes`` shared
    system prompts (``prefix_len`` tokens) followed by a unique user suffix —
    the RAG/chat-template pattern prefix caching exists for.  Requests carry
    real ``prompt_tokens`` so the block-hash prefix cache works in both the
    simulator and the engine; with caching on, every repeat of a prefix skips
    ``block_size``-aligned prefill work."""
    rng = np.random.default_rng(seed)
    prefixes = [
        rng.integers(1, vocab_size, prefix_len).tolist() for _ in range(n_prefixes)
    ]
    reqs: List[Request] = []
    for i in range(n_requests):
        prefix = prefixes[int(rng.integers(0, n_prefixes))]
        suffix_len = int(rng.integers(suffix_range[0], suffix_range[1] + 1))
        tokens = prefix + rng.integers(1, vocab_size, suffix_len).tolist()
        reqs.append(Request(
            prompt_len=len(tokens),
            max_new_tokens=int(rng.integers(max(1, max_new_tokens // 2),
                                            max_new_tokens + 1)),
            arrival_time=i * inter_arrival_s,
            prompt_tokens=tokens,
            tenant=tenants[i % len(tenants)] if tenants else "default",
        ))
    return reqs


@dataclass(frozen=True)
class TenantTraffic:
    """One tenant's arrival process for ``multi_tenant``.

    ``kind`` picks sane defaults for unset fields:
      * ``heavy``  — high rate, long prompts (the bully tenant)
      * ``light``  — low rate, short prompts (interactive clients)
      * ``bursty`` — light, but arrivals concentrate in on/off bursts
    """

    name: str
    kind: str = "light"                    # heavy | light | bursty
    rps: Optional[float] = None            # mean arrival rate (Poisson)
    prompt_mean: Optional[float] = None    # log-normal median prompt length
    prompt_sigma: float = 0.6
    max_new_tokens: int = 64
    burst_period_s: float = 5.0            # bursty only: on+off cycle length
    burst_duty: float = 0.2                # bursty only: fraction of cycle "on"

    _KIND_DEFAULTS = {
        "heavy": {"rps": 8.0, "prompt_mean": 200.0},
        "light": {"rps": 1.0, "prompt_mean": 30.0},
        "bursty": {"rps": 1.0, "prompt_mean": 30.0},
    }

    def resolved(self) -> "TenantTraffic":
        if self.kind not in self._KIND_DEFAULTS:
            raise ValueError(f"unknown tenant traffic kind {self.kind!r}")
        d = self._KIND_DEFAULTS[self.kind]
        return dataclasses.replace(
            self,
            rps=self.rps if self.rps is not None else d["rps"],
            prompt_mean=(
                self.prompt_mean if self.prompt_mean is not None else d["prompt_mean"]
            ),
        )


def default_tenant_mix(n_light: int = 4) -> List[TenantTraffic]:
    """The bench's 1-heavy/N-light mix."""
    return [TenantTraffic("heavy0", "heavy")] + [
        TenantTraffic(f"light{i}", "light") for i in range(n_light)
    ]


def multi_tenant(
    tenants: Optional[List[TenantTraffic]] = None,
    *,
    duration_s: float = 30.0,
    max_context: int = 512,
    seed: int = 0,
) -> List[Request]:
    """Merged multi-tenant arrival trace: independent Poisson (or on/off
    burst) streams per tenant, tagged with ``Request.tenant``, sorted by
    arrival time."""
    tenants = [t.resolved() for t in (tenants or default_tenant_mix())]
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    for spec in tenants:
        # random phase offset per tenant so bursty tenants don't synchronize
        phase0 = float(rng.uniform(0.0, spec.burst_period_s))
        # first arrival is one inter-arrival gap in (a true Poisson process —
        # not a deterministic all-tenant collision at t=0)
        if spec.kind == "bursty":
            t = float(rng.exponential(spec.burst_duty / spec.rps))
        else:
            t = float(rng.exponential(1.0 / spec.rps))
        while t < duration_s:
            if spec.kind == "bursty":
                phase = (t + phase0) % spec.burst_period_s
                on_len = spec.burst_duty * spec.burst_period_s
                if phase >= on_len:                 # in the off window: skip ahead
                    t += spec.burst_period_s - phase
                    continue
                # compress the whole cycle's arrivals into the on window
                gap = float(rng.exponential(spec.burst_duty / spec.rps))
            else:
                gap = float(rng.exponential(1.0 / spec.rps))
            p = int(np.clip(
                round(rng.lognormal(math.log(spec.prompt_mean), spec.prompt_sigma)),
                1, max_context,
            ))
            g = int(rng.integers(max(1, spec.max_new_tokens // 4),
                                 spec.max_new_tokens + 1))
            reqs.append(Request(
                prompt_len=p, max_new_tokens=g, arrival_time=t, tenant=spec.name,
            ))
            t += gap
    reqs.sort(key=lambda r: r.arrival_time)
    return reqs


def attach_prompt_tokens(reqs: List[Request], vocab_size: int, seed: int = 0) -> None:
    """Real-engine mode: synthesize token ids for each prompt."""
    rng = np.random.default_rng(seed)
    for r in reqs:
        r.prompt_tokens = rng.integers(1, vocab_size, r.prompt_len).tolist()
