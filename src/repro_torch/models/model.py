"""Model factory: ``build_model(cfg)`` wraps the config family's
implementation (the port of ``repro/models/model.py``: the dense, MoE and
VLM families, all three ``TransformerLM``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import TransformerLM


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported yet (ROADMAP.md, "
                "queue 1, item 14)")
        self.impl = TransformerLM(cfg)

    def init(self, gen: torch.Generator, device):
        return self.impl.init(gen, device)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
