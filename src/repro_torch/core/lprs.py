"""LPRS — Latency-Prediction-Based Request Scheduling (§3.2, Algorithm 1).

Replaces "fill to the token budget" with "hit the target round latency T*":
a discrete candidate search over chunk sizes, each scored by an asymmetric
deviation of the *predicted* batch latency from T* (overflow penalized by
lambda_o > lambda_u underfill).

Preemption interaction: a *swap-out* victim re-enters the queue
decode-resumable — its comeback is ONE restore round, not a re-prefill, so
the round-count predictor (``predicted_resume_rounds``) and the chunk search
both treat it as already-prefilled work (``select_chunk`` is never consulted
for a zero-remaining-prefill resume).  A *recompute* victim pays the full
``ceil(context / budget)`` rounds of chunked re-prefill — the asymmetry the
scheduler's swap-vs-recompute cost decision weighs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.features import BatchState


@dataclass(frozen=True)
class LPRSConfig:
    target_latency_ms: float = 105.0   # T* (paper's §4.4 setting)
    search_delta: int = 128            # candidate granularity Δ
    lambda_under: float = 1.0          # λ_u
    lambda_over: float = 3.0           # λ_o  (> λ_u, Eq. 10)


def predicted_resume_rounds(
    remaining_prefill: int, token_budget: int, *, swapped: bool
) -> int:
    """Scheduling-round count until a preemption victim can decode again:
    a swapped-out victim restores in ONE round (its prefill progress
    survived host-side); a recompute victim re-prefills its whole context
    chunk-by-chunk under the round token budget."""
    if swapped or remaining_prefill <= 0:
        return 1
    return max(1, math.ceil(remaining_prefill / max(token_budget, 1)))


def candidate_set(h_i: int, delta: int) -> np.ndarray:
    """Eq. 8 — C_i = {1, h_i} ∪ {kΔ | 1 <= kΔ <= h_i}, sorted ascending."""
    if h_i < 1:
        return np.array([], dtype=np.int64)
    cands = {1, h_i}
    cands.update(range(delta, h_i + 1, delta))
    return np.array(sorted(cands), dtype=np.int64)


def score(pred_ms: np.ndarray, target: float, lam_u: float, lam_o: float) -> np.ndarray:
    """Eq. 10 — asymmetric deviation from the target latency budget."""
    pred_ms = np.asarray(pred_ms, np.float64)
    under = lam_u * (target - pred_ms)
    over = lam_o * (pred_ms - target)
    return np.where(pred_ms <= target, under, over)


def select_chunk(
    *,
    remaining: int,                 # r_i
    committed: int,                 # U_t
    token_budget: int,              # B_max
    batch_state: BatchState,        # current round state (without candidate)
    processed: int,                 # request's historical prefill progress
    predictor,                      # .predict((n,16)) -> (n,) ms
    cfg: LPRSConfig,
    target_ms: Optional[float] = None,  # deadline-derived T* override (SLO tier)
) -> int:
    """Algorithm 1 — returns c_i^* (0 = skip this round).

    ``target_ms`` lets the SLO tier substitute the *tightest admitted
    deadline's* per-round budget for the static ``cfg.target_latency_ms``.
    """
    return search(remaining=remaining, committed=committed,
                  token_budget=token_budget, batch_state=batch_state,
                  processed=processed, predictor=predictor, cfg=cfg,
                  target_ms=target_ms)[0]


def search(
    *,
    remaining: int,
    committed: int,
    token_budget: int,
    batch_state: BatchState,
    processed: int,
    predictor,
    cfg: LPRSConfig,
    target_ms: Optional[float] = None,
) -> Tuple[int, float, int]:
    """``select_chunk``'s search with what it saw: ``(c_i^*, the predicted
    ms of the round with that chunk, candidates scored)``; the prediction
    is NaN where no candidate was scored or the starvation guard chose."""
    h_i = min(remaining, token_budget - committed)
    if h_i <= 0:
        return 0, math.nan, 0

    cands = candidate_set(h_i, cfg.search_delta)
    # Build all candidate feature vectors in one batched predictor call.
    feats = np.stack(
        [batch_state.with_extra_prefill(int(c), processed).features() for c in cands]
    )
    preds = np.asarray(predictor.predict(feats), np.float64).reshape(-1)
    target = cfg.target_latency_ms if target_ms is None else float(target_ms)
    scores = score(preds, target, cfg.lambda_under, cfg.lambda_over)

    # arg-min; ties broken toward the larger chunk (Algorithm 1 lines 16-21)
    best = 0
    best_score = np.inf
    best_pred = math.nan
    for c, s, p in zip(cands, scores, preds):
        if s < best_score or (s == best_score and c > best):
            best_score = s
            best = int(c)
            best_pred = float(p)

    # starvation guard for an empty batch (Algorithm 1 lines 23-26)
    if best == 0 and committed == 0 and h_i >= 1:
        return 1, math.nan, len(cands)
    return best, best_pred, len(cands)
