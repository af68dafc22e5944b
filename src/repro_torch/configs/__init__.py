"""Architecture config registry.

``get_config(arch_id)`` resolves the assigned architecture ids (and the paper's
own evaluation model) to :class:`repro_torch.configs.base.ModelConfig`.
``tiny_config(arch_id)`` produces a reduced same-family config for CPU smoke
tests (small layers/width, few experts, tiny vocab).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (
    SHAPES,
    SHAPES_BY_NAME,
    EncoderConfig,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    applicable_shapes,
)

from repro_torch.configs.llama3_2_1b import CONFIG as _llama
from repro_torch.configs.granite_34b import CONFIG as _granite
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen05
from repro_torch.configs.mistral_large_123b import CONFIG as _mistral_large
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _llama,
        _granite,
        _qwen05,
        _mistral_large,
        _jamba,
        _whisper,
        _arctic,
        _mixtral,
        _llava,
        _xlstm,
        _qwen3,
    )
}

ASSIGNED_ARCHS: List[str] = [
    "llama3.2-1b",
    "granite-34b",
    "qwen1.5-0.5b",
    "mistral-large-123b",
    "jamba-1.5-large-398b",
    "whisper-large-v3",
    "arctic-480b",
    "mixtral-8x7b",
    "llava-next-mistral-7b",
    "xlstm-1.3b",
]


def get_config(arch_id: str) -> ModelConfig:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}"
        ) from None


def tiny_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_config(arch_id)
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.attn_every == 0 else cfg.attn_every),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=128 if cfg.d_ff else 0,
        head_dim=16,
        vocab_size=512,
        max_seq_len=512,
        sharding="tp",
        name=cfg.name + "-tiny",
    )
    if cfg.attn_every:
        kw["n_layers"] = cfg.attn_every  # one full interleave group
    if cfg.moe is not None:
        # capacity_factor high enough that no token drops: keeps tiny-config
        # consistency tests exact (capacity dropping is workload-dependent)
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff=128, capacity_factor=8.0
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=8, chunk_size=16)
        if cfg.ssm.kind == "xlstm":
            kw["n_layers"] = cfg.ssm.slstm_every
            kw["head_dim"] = 16
    if cfg.encoder is not None:
        kw["encoder"] = EncoderConfig(n_layers=2, seq_len=16)
        kw["n_layers"] = 2
    if cfg.n_patch_tokens:
        kw["n_patch_tokens"] = 8
    if cfg.sliding_window:
        kw["sliding_window"] = 32
    return cfg.with_(**kw)


__all__ = [
    "REGISTRY",
    "ASSIGNED_ARCHS",
    "get_config",
    "tiny_config",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "EncoderConfig",
    "ShapeSpec",
    "SHAPES",
    "SHAPES_BY_NAME",
    "applicable_shapes",
]
