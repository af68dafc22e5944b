"""Operations and bytes from shapes, for a configuration file's published
keys and one round's real rows.

A row is ``(cached, n)``: a sequence with ``cached`` tokens already in the
KV cache that brings ``n`` tokens this round (a decode has n = 1).  Its
i-th new token (0-based) sits at position ``cached + i`` and attends to
``cached + i + 1`` keys.  Only real tokens count: the padding of a round's
``n_slots x C`` positions is work the model does not need.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

BF16 = 2          # bytes


def dims(config: Dict):
    D = config["hidden_size"]
    Hq, Hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or D // Hq
    return D, Hq, Hkv, hd


def active_params(config: Dict) -> int:
    """Parameters one token multiplies, outside the embedding and the
    unembedding: per layer the attention projections, then the dense FFN,
    or the router, ``num_experts_per_tok`` experts and the dense residual
    (``hidden_size`` wide, as Arctic's)."""
    D, Hq, Hkv, hd = dims(config)
    F = config["intermediate_size"]
    attn = D * Hq * hd + 2 * D * Hkv * hd + Hq * hd * D
    if config.get("num_local_experts"):
        ffn = (D * config["num_local_experts"]
               + config["num_experts_per_tok"] * 3 * D * F)
        if config.get("parallel_attn_mlp_res"):
            ffn += 3 * D * D
    else:
        ffn = 3 * D * F
    return config["num_hidden_layers"] * (attn + ffn)


def _keys(rows: Iterable[Tuple[int, int]]) -> int:
    """Sum over every new token of the keys it attends to."""
    return sum(n * c + n * (n + 1) // 2 for c, n in rows)


def step_flops(config: Dict, rows, n_sampled: int) -> float:
    """Useful model operations of one round: 2 x active parameters per real
    token, causal attention 4 * L * Hq * hd per query and key, and the
    unembedding of the rows that sample."""
    D, Hq, _, hd = dims(config)
    L, V = config["num_hidden_layers"], config["vocab_size"]
    tokens = sum(n for _, n in rows)
    return (2.0 * active_params(config) * tokens
            + 4.0 * L * Hq * hd * _keys(rows)
            + 2.0 * D * V * n_sampled)


def attention_cost(config: Dict, rows) -> Tuple[float, float]:
    """(operations, bytes) of ONE layer's attention call over ``rows``:
    each valid K and V row read once, each query read once and each output
    written once, in bf16; QK^T and PV at 2 * hd operations per query-key
    pair and head."""
    _, Hq, Hkv, hd = dims(config)
    flops = 4.0 * Hq * hd * _keys(rows)
    kv = sum(c + n for c, n in rows) * 2 * Hkv * hd * BF16
    qo = sum(n for _, n in rows) * 2 * Hq * hd * BF16
    return flops, float(kv + qo)


def bound_s(flops: float, nbytes: float, peak_flops: float,
            peak_bytes: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / peak_flops, nbytes / peak_bytes)
