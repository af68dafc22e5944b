"""Token sampling: greedy / temperature / top-k (the port of
``repro/engine/sampler.py``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0     # 0 = greedy
    top_k: int = 0               # 0 = full distribution


def sample_tokens(logits, gen: Optional[torch.Generator], cfg: SamplerConfig):
    """logits: (B, V) -> (B,) int32 tokens.  Greedy is ``argmax`` (the first
    index on ties, as ``jnp.argmax``).  Temperature and top-k draw from
    ``gen``; they match the JAX sampler in distribution, not draw for draw.
    A row with a non-finite logit (an idle lane under the plain attention,
    a poisoned request under the NaN guard; the engine discards both ids)
    draws from the uniform distribution: ``torch.multinomial`` refuses a
    NaN probability, where ``jax.random.categorical`` draws regardless."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    finite = torch.isfinite(logits).all(dim=-1, keepdim=True)
    logits = torch.where(finite, logits.float(), 0.0) / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -float("inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
