"""Unified model / shape configuration for the FairServe-JAX model zoo.

Every assigned architecture is expressed as a :class:`ModelConfig`.  The model
factory (``repro_torch.models.model``) consumes these to build init/apply/prefill/
decode/train step functions; ``repro.launch.dryrun`` consumes the paired
:class:`ShapeSpec` set to lower every (arch x shape) cell.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                 # per-expert hidden dim
    capacity_factor: float = 1.25
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    every: int = 1                 # MoE FFN every `every` layers (1 = all layers)


@dataclass(frozen=True)
class SSMConfig:
    kind: str                 # "mamba" | "xlstm"
    d_state: int = 16         # mamba state dim
    conv_width: int = 4
    expand: int = 2           # d_inner = expand * d_model
    dt_rank: int = 0          # 0 -> d_model // 16
    # xlstm
    slstm_every: int = 8      # 1 sLSTM per `slstm_every` layers (rest mLSTM)
    chunk_size: int = 256     # chunkwise-parallel mLSTM prefill chunk


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    seq_len: int              # e.g. whisper: 1500 audio frames (post-conv, stubbed)
    d_model: int = 0          # 0 -> same as decoder d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                 # dense FFN hidden dim (0 for pure-SSM blocks)
    vocab_size: int

    head_dim: int = 0         # 0 -> d_model // n_heads
    qkv_bias: bool = False    # qwen1.5
    sliding_window: int = 0   # mixtral SWA; 0 = full attention
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None

    # hybrid (jamba): one attention layer per `attn_every` layers, rest SSM
    attn_every: int = 0

    # vlm: number of (stubbed) image-patch embedding tokens prepended to text
    n_patch_tokens: int = 0

    # distribution
    sharding: str = "tp"      # "tp" | "fsdp_tp" (big models: 2D weight sharding)
    scan_layers: bool = True
    # MoE dispatch: "onehot" (GShard dispatch/combine einsums) or "scatter"
    # (sort/gather; no O(T*E*C) dispatch tensors) — a §Perf hillclimb lever
    moe_impl: str = "onehot"

    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # which shape families apply (per-spec skips)
    subquadratic: bool = False   # True -> long_500k runs (SSM/hybrid/SWA)
    has_decode: bool = True      # encoder-only archs would set False

    max_seq_len: int = 131_072

    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        hd = self.resolved_head_dim
        d = self.d_model
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + self.n_heads * hd * d
        dense_ffn = 3 * d * self.d_ff if self.d_ff else 0
        n = 0
        for li in range(self.n_layers):
            is_attn = (self.attn_every == 0) or (li % self.attn_every == 0)
            if self.ssm is not None and not is_attn:
                n += self._ssm_params()
            elif self.ssm is not None and self.family == "ssm":
                n += self._ssm_params()
            else:
                n += attn
            if self.moe is not None and (li % self.moe.every == (self.moe.every - 1)):
                n += self.moe.n_experts * 3 * d * self.moe.d_ff + d * self.moe.n_experts
                if self.moe.dense_residual:
                    n += dense_ffn
            elif self.d_ff:
                n += dense_ffn
            n += 2 * d  # norms
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.encoder is not None:
            ed = self.encoder.d_model or d
            ehd = ed // self.n_heads
            enc_attn = 4 * ed * ehd * self.n_heads
            n += self.encoder.n_layers * (enc_attn + 3 * ed * self.d_ff + 2 * ed)
            n += self.n_layers * attn  # decoder cross-attention
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        per_layer_moe = self.moe.n_experts * 3 * self.d_model * self.moe.d_ff
        active_moe = self.moe.top_k * 3 * self.d_model * self.moe.d_ff
        n_moe_layers = sum(
            1 for li in range(self.n_layers) if li % self.moe.every == (self.moe.every - 1)
        )
        return full - n_moe_layers * (per_layer_moe - active_moe)

    def _ssm_params(self) -> int:
        d = self.d_model
        if self.ssm is None:
            return 0
        if self.ssm.kind == "mamba":
            d_in = self.ssm.expand * d
            dt_rank = self.ssm.dt_rank or d // 16
            return (
                2 * d * d_in                       # in_proj
                + d_in * self.ssm.conv_width       # conv
                + d_in * (dt_rank + 2 * self.ssm.d_state)  # x_proj
                + dt_rank * d_in                   # dt_proj
                + d_in * self.ssm.d_state          # A_log
                + d_in                             # D
                + d_in * d                         # out_proj
            )
        # xlstm mLSTM block (matches models/xlstm.py init_mlstm):
        # wq/wk/wv (d, H, hd) + wog (d, d_in) + down (d_in, d) + gates
        H = self.n_heads
        hd = self.resolved_head_dim
        d_in = H * hd
        return 3 * d * d_in + 2 * d * H + d * d_in + d_in * d

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "train", 4096, 256),
    ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    ShapeSpec("decode_32k", "decode", 32_768, 128),
    ShapeSpec("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeSpec, ...]:
    """Per-spec skips: long_500k only for sub-quadratic archs; decode shapes
    only for archs with a decode step."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.subquadratic:
            continue
        if s.kind == "decode" and not cfg.has_decode:
            continue
        out.append(s)
    return tuple(out)
