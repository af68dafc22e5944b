"""Model factory: ``build_model(cfg)`` wraps the config family's
implementation (the port of ``repro/models/model.py``, dense family only)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import TransformerLM


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        if cfg.family != "dense":
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported yet (ROADMAP.md, "
                "queue 1: item 12 for moe/vlm, item 14 for hybrid/ssm/encdec)")
        self.impl = TransformerLM(cfg)

    def init(self, gen: torch.Generator, device):
        return self.impl.init(gen, device)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
