"""mixtral-8x7b — [moe] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8e top-2, sliding-window attention.

[arXiv:2401.04088; hf]
SWA window 4096 -> sub-quadratic: long_500k decode keeps an O(W) ring-buffer KV
cache, so the shape runs.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=14_336, every=1),
    rope_theta=1_000_000.0,
    sharding="fsdp_tp",
    subquadratic=True,   # SWA => O(W) decode cache
    moe_impl="scatter",  # group-local dispatch (see EXPERIMENTS.md §Perf)
    notes="8 experts top-2; SWA window 4096",
)
