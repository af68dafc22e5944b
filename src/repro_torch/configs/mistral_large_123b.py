"""mistral-large-123b — [dense] 88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
123B params: TP=16 alone leaves ~15.4 GB of weights per chip (v5e has 16 GB), so
serving uses 2D weight sharding (fsdp_tp) with per-layer gather.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=32_768,
    rope_theta=1_000_000.0,
    sharding="fsdp_tp",
    subquadratic=False,
    notes="123B dense; 2D weight sharding",
)
