"""APC — Active Prefill Control (§3.3): dynamic activity cap, minimum
effective progress, and warm start.

Prevents budget dilution (too many active prefills sharing the residual
budget) and micro-progress (1-token chunks that trivially keep requests
active).  Decision rule Eq. 14 on top of the LPRS-proposed chunk.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class APCConfig:
    c_max: int = 4        # configured max active prefills (C_max)
    l_min: int = 64       # minimum effective chunk (L_min)


@dataclass
class APCStats:
    blocked_by_cap: int = 0
    blocked_by_min_chunk: int = 0
    warm_starts: int = 0
    slo_overrides: int = 0  # urgent chunks that bypassed the cap/min-chunk gates


def activity_cap(
    cfg: APCConfig,
    *,
    n_decode: int,          # |D_t|
    max_seqs: int,          # S_max
    token_budget: int,      # B_max
    committed: int,         # U_t
) -> int:
    """Eq. 12 — C_t = min(C_max, S_max - |D_t|, floor((B_max - U_t)/L_min)),
    clamped to >= 0: an over-committed round (U_t > B_max) or a decode set
    at S_max means *no* prefill slots, not a negative count."""
    return max(
        0,
        min(
            cfg.c_max,
            max_seqs - n_decode,
            (token_budget - committed) // cfg.l_min,
        ),
    )


def min_effective_progress(cfg: APCConfig, remaining: int) -> int:
    """Eq. 13 — m_i = min(r_i, L_min)."""
    return min(remaining, cfg.l_min)


def apply(
    cfg: APCConfig,
    stats: APCStats,
    *,
    proposed: int,          # c_i^* from LPRS (or the token-budget rule)
    remaining: int,         # r_i
    upper_bound: int,       # h_i
    n_active_prefills: int, # |P_t| — unfinished prefills already in this batch
    cap: int,               # C_t from activity_cap()
    urgent: bool = False,   # SLO tier: deadline-critical request (apc_protect)
) -> int:
    """Eq. 14 — returns the final chunk c_i (0 = blocked this round).

    ``urgent`` is the SLO tier's protection valve: a request whose deadline
    is feasible only if served now is never blocked by the activity cap or
    the min-chunk rule — it gets the deadline-feasible chunk regardless.
    """
    m_i = min_effective_progress(cfg, remaining)
    if n_active_prefills < cap and proposed >= m_i and proposed > 0:
        return proposed
    if urgent and upper_bound >= 1:
        stats.slo_overrides += 1
        return proposed if proposed > 0 else min(upper_bound, m_i)
    if proposed < m_i and n_active_prefills == 0 and upper_bound >= 1:
        stats.warm_starts += 1
        return min(upper_bound, m_i)
    if n_active_prefills >= cap:
        stats.blocked_by_cap += 1
    elif proposed < m_i:
        stats.blocked_by_min_chunk += 1
    return 0
