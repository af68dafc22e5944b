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

    # The router and the experts held here, as every MoEConfig has them:
    # softmax over all ``n_experts``, each held here, renormalised top-k,
    # no shared expert.  A sigmoid router (DeepSeek-V3's) chooses on the
    # scores plus a selection bias per expert and renormalises.  Class
    # attributes, not fields (the configurations that existed before them
    # keep their fields); ``RoutedMoEConfig`` makes them fields.
    scoring = "softmax"            # "softmax" | "sigmoid"
    routed_scale = 1.0             # the routed experts' sum scaled by this
    n_shared = 0                   # shared experts, on every token
    shared_d_ff = 0                # their hidden width, all together
    first_held = 0                 # the experts held here: first_held ..
    n_held = 0                     # first_held + n_held - 1 (0: all)

    @property
    def held(self) -> int:
        """Experts held here: their weights, the rest routed to but absent."""
        return self.n_held or self.n_experts


@dataclass(frozen=True)
class RoutedMoEConfig(MoEConfig):
    """A MoE whose router and expert share are set (DeepSeek-V3's router;
    a chip's share of the experts under expert parallelism).  The router
    scores all ``n_experts``; the layer computes the choices that land on
    experts ``first_held .. first_held + held - 1`` and drops the rest."""
    scoring: str = "softmax"
    routed_scale: float = 1.0
    n_shared: int = 0
    shared_d_ff: int = 0
    first_held: int = 0
    n_held: int = 0


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

    # Layer kinds, as every ModelConfig has them: pre-norm, no QK-norm,
    # RoPE and the window ``sliding_window`` on every layer, experts per
    # ``moe.every``.  Class attributes, not fields; ``LayeredModelConfig``
    # sets them layer by layer.
    layer_windows = ()
    layer_rope = ()
    layer_sparse = ()
    qk_norm = False
    post_norm = False

    def window(self, l: int) -> int:
        """Layer ``l``'s attention window (0: full causal attention)."""
        return self.layer_windows[l] if self.layer_windows else self.sliding_window

    def rope(self, l: int) -> bool:
        """Whether layer ``l`` rotates q and k (False: no positional
        encoding)."""
        return self.layer_rope[l] if self.layer_rope else True

    def sparse(self, l: int) -> bool:
        """Whether layer ``l``'s FFN is the experts (else dense)."""
        if self.layer_sparse:
            return self.layer_sparse[l]
        return self.moe is not None and l % self.moe.every == self.moe.every - 1

    @property
    def uniform_layers(self) -> bool:
        """Every layer of one kind: what the whole-sequence entry points
        and the dense round compute."""
        return True

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
            if self.sparse(li):
                n += self.moe.held * 3 * d * self.moe.d_ff + d * self.moe.n_experts
                n += 3 * d * self.moe.shared_d_ff
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
        per_layer_moe = self.moe.held * 3 * self.d_model * self.moe.d_ff
        active_moe = self.moe.top_k * 3 * self.d_model * self.moe.d_ff
        n_moe_layers = sum(1 for li in range(self.n_layers) if self.sparse(li))
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
class LayeredModelConfig(ModelConfig):
    """A decoder whose layers differ in kind (EXAONE 4.0's and K-EXAONE's
    ``layer_types``, ``sliding_windows``, ``mlp_layer_types``): each
    layer's window (0: full), whether it applies RoPE (else no positional
    encoding), whether its FFN is the experts; RMSNorm over the head
    dimension on q and k before RoPE (``qk_norm``); and with ``post_norm``
    each branch normed on its output, ``x + norm(attn(x))`` then ``x +
    norm(ffn(x))``, with no norm on a branch's input.  An empty tuple means
    what ``ModelConfig`` means."""
    layer_windows: Tuple[int, ...] = ()
    layer_rope: Tuple[bool, ...] = ()
    layer_sparse: Tuple[bool, ...] = ()
    qk_norm: bool = False
    post_norm: bool = False

    def __post_init__(self):
        for name in ("layer_windows", "layer_rope", "layer_sparse"):
            got = getattr(self, name)
            if got and len(got) != self.n_layers:
                raise ValueError(f"{name} has {len(got)} entries for "
                                 f"{self.n_layers} layers")

    @property
    def uniform_layers(self) -> bool:
        return (len({self.window(l) for l in range(self.n_layers)}) <= 1
                and all(self.rope(l) for l in range(self.n_layers))
                and len({self.sparse(l) for l in range(self.n_layers)}) <= 1
                and not (self.qk_norm or self.post_norm))


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
