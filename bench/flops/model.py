"""Operations and bytes from shapes, for a configuration file's published
keys and one round's real rows.

A row is ``(cached, n)``: a sequence with ``cached`` tokens already in the
KV cache that brings ``n`` tokens this round (a decode has n = 1).  Its
i-th new token (0-based) sits at position ``cached + i`` and attends to
``cached + i + 1`` keys.  Only real tokens count: the padding of a round's
``n_slots x C`` positions is work the model does not need.

What a model computes is its model module's (``bench/models/``, named by
the configuration's ``"model"``): ``Yardstick`` finds it and asks it.  The
module-level ``active_params``, ``step_flops`` and ``attention_launches``
are those of the benchmark's own root.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from bench import cell as cells

BF16 = 2          # bytes


def dims(config: Dict):
    D = config["hidden_size"]
    Hq, Hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or D // Hq
    return D, Hq, Hkv, hd


def keys(rows: Iterable[Tuple[int, int]]) -> int:
    """Sum over every new token of the keys it attends to, causally."""
    return sum(n * c + n * (n + 1) // 2 for c, n in rows)


def attention_cost(config: Dict, rows) -> Tuple[float, float]:
    """(operations, bytes) of ONE causal attention launch over ``rows`` at
    the configuration's heads: each valid K and V row read once, each query
    read once and each output written once, in bf16; QK^T and PV at 2 * hd
    operations per query-key pair and head."""
    _, Hq, Hkv, hd = dims(config)
    flops = 4.0 * Hq * hd * keys(rows)
    kv = sum(c + n for c, n in rows) * 2 * Hkv * hd * BF16
    qo = sum(n for _, n in rows) * 2 * Hq * hd * BF16
    return flops, float(kv + qo)


def bound_s(flops: float, nbytes: float, peak_flops: float,
            peak_bytes: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / peak_flops, nbytes / peak_bytes)


class Yardstick:
    """The arithmetic of the configurations under one root, each asked of
    its model module (loaded once per name)."""

    bound_s = staticmethod(bound_s)

    def __init__(self, root: Path = cells.ROOT):
        self.root = root
        self._models: Dict[str, object] = {}

    def model(self, config: Dict):
        name = cells.model_name(config)
        if name not in self._models:
            self._models[name] = cells.model_module(config, self.root)
        return self._models[name]

    def active_params(self, config: Dict) -> int:
        """Parameters one token multiplies, outside the embedding and the
        unembedding."""
        return self.model(config).active_params(config)

    def step_flops(self, config: Dict, rows, n_sampled: int) -> float:
        """Useful model operations of one round over its real rows."""
        return self.model(config).step_flops(config, rows, n_sampled)

    def attention_launches(self, config: Dict, rows) -> List[Tuple[float, float]]:
        """(operations, bytes) of each launch of the attention kernel in a
        round over ``rows``."""
        return self.model(config).attention_launches(config, rows)


_ROOT = Yardstick()
active_params = _ROOT.active_params
step_flops = _ROOT.step_flops
attention_launches = _ROOT.attention_launches
