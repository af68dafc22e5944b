"""LPRS feature extraction (§3.2.1): 11 raw + 5 derived = 16 features.

TPU adaptation (DESIGN.md §2): the CUDA-allocator features are replaced by
the paged-KV pool + HBM accounting — the TPU-serving analogue of allocator
state.  Feature count and roles are preserved.

Raw (11):
  0 prefill_tokens            total prefill tokens scheduled this round
  1 decode_tokens             total decode tokens in the batch
  2 batch_request_count       active batched requests this round
  3 sum_decode_context_len    cumulative context length of decode requests
  4 max_decode_context_len    max context length among decode requests
  5 prefill_processed_tokens  historical prefill progress of batched prefills
  6 max_prefill_processed     max historical prefill progress
  7 kv_used_mb                KV block pool used (was gpu_mem_used_mb)
  8 kv_free_mb                KV block pool free (was gpu_mem_free_mb)
  9 hbm_allocated_mb          params + KV bytes modelled (was cuda_allocated_mb)
 10 hbm_reserved_mb           total HBM pool (was cuda_reserved_mb)

Derived (5):
 11 bias                      1.0 (fixed launch/sync overhead)
 12 scheduled_tokens          decode_tokens + prefill_tokens
 13 avg_decode_ctx            sum_decode_ctx / max(decode_tokens, 1)
 14 decode_ctx_interaction    decode_tokens * avg_decode_ctx
 15 prefill_interaction       prefill_tokens * prefill_processed_tokens
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_RAW = 11
N_FEATURES = 16

FEATURE_NAMES = [
    "prefill_tokens",
    "decode_tokens",
    "batch_request_count",
    "sum_decode_context_len",
    "max_decode_context_len",
    "prefill_processed_tokens",
    "max_prefill_processed_tokens",
    "kv_used_mb",
    "kv_free_mb",
    "hbm_allocated_mb",
    "hbm_reserved_mb",
    "bias",
    "scheduled_tokens",
    "avg_decode_ctx",
    "decode_ctx_interaction",
    "prefill_interaction",
]


@dataclass
class BatchState:
    """Runtime state of one candidate scheduling round."""

    prefill_tokens: int = 0
    decode_tokens: int = 0
    batch_request_count: int = 0
    sum_decode_context_len: int = 0
    max_decode_context_len: int = 0
    prefill_processed_tokens: int = 0
    max_prefill_processed_tokens: int = 0
    kv_used_mb: float = 0.0
    kv_free_mb: float = 0.0
    hbm_allocated_mb: float = 0.0
    hbm_reserved_mb: float = 0.0

    def raw(self) -> np.ndarray:
        return np.array(
            [
                self.prefill_tokens,
                self.decode_tokens,
                self.batch_request_count,
                self.sum_decode_context_len,
                self.max_decode_context_len,
                self.prefill_processed_tokens,
                self.max_prefill_processed_tokens,
                self.kv_used_mb,
                self.kv_free_mb,
                self.hbm_allocated_mb,
                self.hbm_reserved_mb,
            ],
            dtype=np.float64,
        )

    def features(self) -> np.ndarray:
        return derive_features(self.raw())

    def with_extra_prefill(self, chunk: int, processed: int) -> "BatchState":
        """Candidate state if `chunk` more prefill tokens (from a request with
        `processed` historical tokens) joined the batch — the x_{t,i}(c) of
        Eq. 9."""
        return BatchState(
            prefill_tokens=self.prefill_tokens + chunk,
            decode_tokens=self.decode_tokens,
            batch_request_count=self.batch_request_count + 1,
            sum_decode_context_len=self.sum_decode_context_len,
            max_decode_context_len=self.max_decode_context_len,
            prefill_processed_tokens=self.prefill_processed_tokens + processed,
            max_prefill_processed_tokens=max(self.max_prefill_processed_tokens, processed),
            kv_used_mb=self.kv_used_mb,
            kv_free_mb=self.kv_free_mb,
            hbm_allocated_mb=self.hbm_allocated_mb,
            hbm_reserved_mb=self.hbm_reserved_mb,
        )


def derive_features(raw: np.ndarray) -> np.ndarray:
    """raw: (..., 11) -> (..., 16) appending the 5 derived features."""
    raw = np.asarray(raw, dtype=np.float64)
    pf = raw[..., 0]
    dec = raw[..., 1]
    sum_ctx = raw[..., 3]
    pf_hist = raw[..., 5]
    bias = np.ones_like(pf)
    scheduled = dec + pf
    avg_ctx = sum_ctx / np.maximum(dec, 1.0)
    ctx_inter = dec * avg_ctx
    pf_inter = pf * pf_hist
    return np.concatenate(
        [raw, np.stack([bias, scheduled, avg_ctx, ctx_inter, pf_inter], axis=-1)], axis=-1
    )
