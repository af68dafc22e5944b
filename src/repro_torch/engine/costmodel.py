"""Execution-time cost model for the discrete-event simulator.

Mirrors Vidur's [17] approach: per-round latency is a structured function of
batch composition, fitted/parameterized per (model, hardware).  The simulator
uses it as ground truth (with multiplicative noise); the LPRS predictor is
trained on (features, latency) samples it generates — exactly the paper's
offline profiling pipeline with the physical GPU swapped for a calibrated
model.

The functional form captures the paper's observations:
  t = c0                              fixed launch/sync overhead
    + c_prefill * prefill_tokens      compute-bound prefill
    + c_attn * sum_i chunk_i*ctx_i    prefill attention vs existing context
    + c_decode * decode_tokens        memory-bound decode (weight streaming)
    + c_ctx * sum_decode_context      KV streaming
    + c_seq * n_seqs                  per-sequence bookkeeping
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.scheduler import ScheduledBatch


@dataclass(frozen=True)
class CostModelConfig:
    c0_ms: float = 2.0
    c_prefill_ms: float = 0.045       # per prefill token
    c_attn_ms: float = 4e-6           # per (chunk token x context token)
    c_decode_ms: float = 0.10         # per decode token
    c_ctx_ms: float = 3.5e-5          # per decode context token
    c_seq_ms: float = 0.08            # per batched sequence
    # prefill/decode interference: mixed rounds pay a superlinear penalty of
    # (prefill tokens x total decode context) — compute-phase prefill evicts
    # the decode working set (Sarathi §2's observation; why identical token
    # budgets cost different wall time, the premise of LPRS §3.2)
    c_mix_ms: float = 2e-7            # per (prefill token x decode ctx token)
    # swap-out preemption: device<->host KV migration over the host link
    # (~20 GB/s effective PCIe4 => ~0.05 ms/MB) plus a fixed per-transfer
    # launch cost.  Used both to price swap rounds in the simulator and to
    # choose swap-vs-recompute per victim (bytes moved vs FLOPs recomputed).
    c_swap_ms_per_mb: float = 0.05
    c_swap_fixed_ms: float = 0.2
    noise_std: float = 0.02           # multiplicative log-normal noise
    seed: int = 0

    @staticmethod
    def for_model(name: str = "qwen3-8b") -> "CostModelConfig":
        """Rough per-model scalings (relative compute cost)."""
        scale = {
            "qwen3-8b": 1.0,
            "llama3.2-1b": 0.18,
            "qwen1.5-0.5b": 0.10,
            "mixtral-8x7b": 1.6,
        }.get(name, 1.0)
        base = CostModelConfig()
        return CostModelConfig(
            c0_ms=base.c0_ms,
            c_prefill_ms=base.c_prefill_ms * scale,
            c_attn_ms=base.c_attn_ms * scale,
            c_decode_ms=base.c_decode_ms * scale,
            c_ctx_ms=base.c_ctx_ms * scale,
            c_seq_ms=base.c_seq_ms,
        )


class CostModel:
    def __init__(self, cfg: Optional[CostModelConfig] = None):
        self.cfg = cfg or CostModelConfig()
        self._rng = np.random.default_rng(self.cfg.seed)

    # -- preemption-mode decision (swap bytes vs recompute FLOPs) -------------
    def swap_cost_ms(self, n_tokens: int, bytes_per_token: int) -> float:
        """One full swap cycle for ``n_tokens`` of KV: device→host at
        eviction plus host→device at restore (2x the bytes), each paying the
        fixed transfer-launch cost."""
        mb = n_tokens * max(bytes_per_token, 0) / 2**20
        return 2 * (self.cfg.c_swap_fixed_ms + self.cfg.c_swap_ms_per_mb * mb)

    def recompute_cost_ms(self, n_tokens: int) -> float:
        """Re-prefilling ``n_tokens`` of context from scratch: linear prefill
        compute plus the quadratic causal-attention term (each token attends
        to the context before it — n²/2 chunk×context products)."""
        c = self.cfg
        return (
            c.c_prefill_ms * n_tokens
            + c.c_attn_ms * n_tokens * n_tokens / 2.0
        )

    def batch_latency_ms(self, batch: ScheduledBatch, *, noisy: bool = True) -> float:
        c = self.cfg
        prefill_tokens = batch.prefill_tokens
        attn_work = sum(
            chunk * max(req.prefill_done, 1) for req, chunk in batch.prefill_chunks
        )
        decode_tokens = batch.decode_tokens
        sum_ctx = sum(r.context_len for r in batch.decode_reqs)
        t = (
            c.c0_ms
            + c.c_prefill_ms * prefill_tokens
            + c.c_attn_ms * attn_work
            + c.c_decode_ms * decode_tokens
            + c.c_ctx_ms * sum_ctx
            + c.c_seq_ms * batch.n_seqs
            + c.c_mix_ms * prefill_tokens * sum_ctx
        )
        # swap traffic this round (simulator: synchronous transfer; the real
        # engine overlaps it on the async drain path, so this is conservative)
        swap_mb = batch.swap_out_mb + batch.swap_in_mb
        if swap_mb > 0:
            n_xfers = len(batch.swapped_out) + len(batch.restored)
            t += c.c_swap_fixed_ms * n_xfers + c.c_swap_ms_per_mb * swap_mb
        if noisy and c.noise_std > 0:
            t *= float(self._rng.lognormal(0.0, c.noise_std))
        return t
