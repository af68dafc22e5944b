"""Model factory: ``build_model(cfg)`` wraps the config family's
implementation (the port of ``repro/models/model.py``: the dense, MoE and
VLM families, all three ``TransformerLM``) behind one surface:

  init(gen, device) -> params
  train_hidden / train_logits(params, batch)
  prefill(params, batch) -> (last_logits, cache)
  decode(params, tokens, cache, lens) -> (logits, cache)
  cache_struct(batch, seq_len)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import attention_phase
from repro_torch.models.transformer import TransformerLM


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported yet (ROADMAP.md, "
                "queue 1, item 14)")
        self.impl = TransformerLM(cfg)

    def init(self, gen: torch.Generator, device="cuda"):
        return self.impl.init(gen, device)

    def train_hidden(self, params, batch, remat: bool = True):
        return self.impl.train_hidden(params, batch, remat=remat)

    def train_logits(self, params, batch, remat: bool = True):
        return self.impl.train_logits(params, batch, remat=remat)

    def prefill(self, params, batch):
        """``TransformerLM.prefill`` in the prefill attention phase: under
        ``ATTN_IMPL == "auto"`` its attention is the exact chunked path."""
        with attention_phase("prefill"):
            return self.impl.prefill(params, batch)

    def decode(self, params, tokens, cache, lens):
        return self.impl.decode(params, tokens, cache, lens)

    def cache_struct(self, batch: int, seq_len: int):
        return self.impl.cache_struct(batch, seq_len)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
