"""whisper-large-v3 — [audio] 32L d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866.

[arXiv:2212.04356; unverified]
Encoder-decoder. The conv audio frontend is a STUB per assignment: input_specs()
provides precomputed frame embeddings (batch, 1500, d_model); the 32-layer
bidirectional encoder and the 32-layer decoder (self-attn + cross-attn) are real.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    encoder=EncoderConfig(n_layers=32, seq_len=1500),
    rope_theta=10_000.0,
    sharding="tp",
    subquadratic=False,
    notes="enc-dec; conv frontend stubbed (precomputed frame embeddings)",
)
