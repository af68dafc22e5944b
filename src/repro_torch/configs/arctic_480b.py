"""arctic-480b — [moe] 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual.

[hf:Snowflake/snowflake-arctic-base; hf]
Dense-MoE hybrid: every layer has a dense residual FFN in parallel with the
128-expert top-2 MoE FFN (d_ff=4864 for both, matching the HF config's
intermediate size for the MoE branch).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864, dense_residual=True, every=1),
    rope_theta=10_000.0,
    moe_impl="scatter",
    sharding="fsdp_tp",
    subquadratic=False,
    notes="128 experts top-2 + dense residual; EP over model axis",
)
