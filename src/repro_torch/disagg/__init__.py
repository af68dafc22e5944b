"""Disaggregated prefill/decode serving with cross-replica KV handoff.

``DisaggregatedRouter`` fronts a prefill pool and a decode pool of full
(scheduler, engine, KV pool) replicas; at prefill completion a request's KV
migrates through the host-side ``KVHandoffStore`` into a decode replica's
pool and resumes decode-only — zero re-prefilled tokens.  See
``repro_torch.disagg.router`` for the lifecycle.
"""
from repro_torch.disagg.handoff import (
    AlwaysHandoff,
    HandoffCostConfig,
    HandoffCostModel,
    HandoffStats,
    KVHandoffStore,
)
from repro_torch.disagg.router import (
    DisaggConfig,
    DisaggResult,
    DisaggregatedRouter,
    build_disagg,
    serve_disagg,
)

__all__ = [
    "AlwaysHandoff",
    "DisaggConfig",
    "DisaggResult",
    "DisaggregatedRouter",
    "HandoffCostConfig",
    "HandoffCostModel",
    "HandoffStats",
    "KVHandoffStore",
    "build_disagg",
    "serve_disagg",
]
