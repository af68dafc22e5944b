"""llava-next-mistral-7b — [vlm] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
Mistral-7B backbone. The anyres vision tower + projector are a STUB per
assignment: input_specs() provides precomputed patch embeddings
(batch, n_patch_tokens, d_model) that are prepended to the text embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    n_patch_tokens=576,   # one 24x24 anyres base grid (stubbed embeddings)
    rope_theta=1_000_000.0,
    sharding="tp",
    subquadratic=False,
    notes="vision frontend stubbed; backbone == mistral-7b",
)
