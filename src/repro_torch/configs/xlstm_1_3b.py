"""xlstm-1.3b — [ssm] 48L d_model=2048 4H d_ff=0 vocab=50304; sLSTM + mLSTM blocks.

[arXiv:2405.04517; unverified]
xLSTM[7:1]: one sLSTM block per 8 layers, rest mLSTM (matrix-memory, chunkwise-
parallel prefill). d_ff=0: blocks carry their own internal up-projection
(mLSTM 2x, sLSTM 4/3x gated MLP) per the paper. Pure recurrence -> O(1) decode
state, long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    ssm=SSMConfig(kind="xlstm", slstm_every=8, chunk_size=256),
    sharding="tp",
    subquadratic=True,
    notes="sLSTM:mLSTM 1:7; head_dim 512; recurrent state only (no KV cache)",
)
