"""jamba-1.5-large-398b — [hybrid] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2; Mamba+attention 1:7 interleave.

[arXiv:2403.19887; hf]
Layer l is attention iff l % 8 == 0 (1 attn : 7 mamba); FFN is MoE on odd layers
(every=2) per the Jamba block design.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    attn_every=8,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=24_576, every=2),
    ssm=SSMConfig(kind="mamba", d_state=16, conv_width=4, expand=2),
    sharding="fsdp_tp",
    subquadratic=True,   # mamba-dominated -> long_500k runs
    moe_impl="scatter",
    notes="398B hybrid MoE; KV cache only on 9 of 72 layers",
)
