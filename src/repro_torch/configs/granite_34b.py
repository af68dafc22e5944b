"""granite-34b — [dense] 88L d_model=6144 48H (GQA kv=1 == MQA) d_ff=24576 vocab=49152.

[arXiv:2405.04324; hf] llama-arch code model. kv=1 < TP degree, so KV heads are
replicated under tensor parallelism (see distributed/sharding.py).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24_576,
    vocab_size=49_152,
    rope_theta=10_000.0,
    sharding="fsdp_tp",
    subquadratic=False,
    notes="MQA (kv=1); 34B params; 2D weight sharding for serving",
)
