"""The paper's contribution: fairness-aware, latency-controllable scheduling
for chunked-prefill LLM serving (Aging + LPRS + APC)."""
from repro_torch.core.apc import APCConfig, APCStats, activity_cap, min_effective_progress
from repro_torch.core.features import BatchState, derive_features, FEATURE_NAMES, N_FEATURES
from repro_torch.core.lprs import LPRSConfig, candidate_set, select_chunk
from repro_torch.core.policies import (
    NaiveAgingQueue,
    PrefillQueue,
    aging_priority,
    make_policy,
)
from repro_torch.core.predictor import (
    AnalyticPredictor,
    LatencyPredictor,
    PredictorConfig,
    bucket_and_downsample,
)
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import (
    ChunkedPrefillScheduler,
    ScheduledBatch,
    SchedulerConfig,
    SchedulerStats,
)

__all__ = [
    "APCConfig", "APCStats", "activity_cap", "min_effective_progress",
    "BatchState", "derive_features", "FEATURE_NAMES", "N_FEATURES",
    "LPRSConfig", "candidate_set", "select_chunk",
    "NaiveAgingQueue", "PrefillQueue", "aging_priority", "make_policy",
    "AnalyticPredictor", "LatencyPredictor", "PredictorConfig", "bucket_and_downsample",
    "Request", "RequestState",
    "ChunkedPrefillScheduler", "ScheduledBatch", "SchedulerConfig", "SchedulerStats",
]
