"""Plain reference of the K-EXAONE form (``bench/models/exaone_moe.py``),
in float32, one sequence at a time.

Plain PyTorch only: no kernel, no cache, no batching, no import of the
program.  TF32 is off while it runs.  It reads the weights the benchmark
made (``bench/weights.py``'s stacks), upcast piece by piece, and the
configuration file's keys.  The equations, for the first
``num_hidden_layers`` layers:

- x = embed[tokens]
- attention (every layer): q, k, v = x Wq, x Wk, x Wv; q and k each
  rmsnorm over the head dimension times ``q_norm`` / ``k_norm``; on a
  sliding layer (``layer_types``) the rotary embedding on q and k, the
  first and second halves of each head as pairs (theta =
  ``rope_parameters.rope_theta``), and each query at position i sees keys
  j with i - W < j <= i (W = ``sliding_windows``); on a global layer no
  positional encoding and every key j <= i; each group of
  ``num_attention_heads / num_key_value_heads`` query heads on one key
  head, scores scaled by 1/sqrt(head_dim);
  x = x + rmsnorm(attn Wo) * post_attn_norm
- FFN: y = (silu(x Wgate) * x Wup) Wdown on a dense layer
  (``mlp_layer_types``); on a sparse layer s = sigmoid(x Wrouter) over all
  the router's experts, the ``num_experts_per_tok`` largest of s + bias
  chosen, their weights the chosen s over their sum (+ 1e-20) times
  ``routed_scaling_factor``; y = the sum over the chosen experts held here
  (experts ``first_held_expert`` .. + ``num_experts`` - 1) of weight x
  SwiGLU_e(x), plus the shared expert's SwiGLU(x);
  x = x + rmsnorm(y) * post_ffn_norm
- logits = (rmsnorm(x) * final_norm) Wlm.

Sources: the catalog row's ``config`` (K-EXAONE-236B-A23B); EXAONE 4.0's
modeling code (transformers' ``exaone4``) for QK-norm before RoPE, RoPE on
sliding layers only and the norms on each branch's output with none on its
input; DeepSeek-V3's (``deepseek_v3``) for the router, whose ``n_group`` =
``topk_group`` = 1 leaves plain top-k.  Departures from the published
model, each stated in the configuration file: ``num_hidden_layers`` of its
48 layers; the experts held on one chip of two that share each layer (the
absent experts' part is left out, as the program leaves it out); the
selection bias drawn at random at an assumed scale; no multi-token
prediction layer.

Long sequences run in blocks of ``BLOCK`` positions (queries of attention,
rows of every product), so that the scores and the hidden states of the
widest layer fit on the card.

``fp8=True`` is the control: every product of a linear layer takes its
operands rounded to float8 e4m3 (per row of the activations and per
output column of the weights, each scaled to the format's largest finite
value), the step below the bfloat16 the configuration states.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
BLOCK = 1024


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Linear:
    """x (n, din) @ w (din, dout), in float32 or through float8, in blocks
    of ``BLOCK`` rows; the weight is upcast (and rounded) once a call."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            w = _fp8(w, 0)
        return torch.cat([(_fp8(x[i:i + BLOCK], -1) if self.fp8
                           else x[i:i + BLOCK]) @ w
                          for i in range(0, x.shape[0], BLOCK)])


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x, pos, theta: float):
    """x (S, H, hd), pos (S,): pairs (i, i + hd/2)."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                         device=x.device) / hd)
    ang = (pos.double()[:, None] * freqs[None, :]).float()[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(q, k, v, window: int):
    """Causal GQA, q (S, Hq, hd), k/v (S, Hkv, hd) -> (S, Hq * hd): query i
    over keys i - window < j <= i (every j <= i where window is 0), in
    blocks of ``BLOCK`` queries."""
    S, Hq, hd = q.shape
    g = Hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    j = torch.arange(S, device=q.device)
    out = []
    for i0 in range(0, S, BLOCK):
        i = j[i0:i0 + BLOCK, None]
        s = torch.einsum("qhd,khd->hqk", q[i0:i0 + BLOCK], k) / math.sqrt(hd)
        mask = j[None, :] <= i
        if window:
            mask &= j[None, :] > i - window
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("hqk,khd->qhd", p, v))
    return torch.cat(out).reshape(S, Hq * hd)


def swiglu(lin, h, wg, wu, wd):
    return lin(F.silu(lin(h, wg)) * lin(h, wu), wd)


def experts(lin, h, config: Dict, stacks, i: int):
    """Sparse layer ``i`` (among the sparse layers): the routed experts held
    here and the shared expert."""
    s = torch.sigmoid(h @ stacks["router"][i].float())
    _, idx = torch.topk(s + stacks["router_bias"][i].float(),
                        config["num_experts_per_tok"], dim=-1)
    w = s.gather(-1, idx)
    if config["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * config["routed_scaling_factor"]
    first = config.get("first_held_expert", 0)
    out = swiglu(lin, h, stacks["s_gate"][i], stacks["s_up"][i],
                 stacks["s_down"][i])
    for e in torch.unique(idx).tolist():
        local = e - first
        if not 0 <= local < stacks["e_gate"].shape[1]:
            continue                    # an expert of the other chip
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        y = swiglu(lin, h[tok], stacks["e_gate"][i][local],
                   stacks["e_up"][i][local], stacks["e_down"][i][local])
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out


def _forward(config: Dict, stacks: Dict[str, torch.Tensor], tokens: List[int],
             first: int, fp8: bool) -> torch.Tensor:
    lin = Linear(fp8)
    dev = stacks["embed"].device
    D = config["hidden_size"]
    Hq, Hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or D // Hq
    eps = config["rms_norm_eps"]
    theta = config["rope_parameters"]["rope_theta"]
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    pos = torch.arange(len(tokens), device=dev)
    x = stacks["embed"][tok].float()
    i_dense = i_sparse = 0
    for l in range(config["num_hidden_layers"]):
        sliding = config["layer_types"][l] == "sliding_attention"
        q = lin(x, stacks["wq"][l].reshape(D, -1)).view(-1, Hq, hd)
        k = lin(x, stacks["wk"][l].reshape(D, -1)).view(-1, Hkv, hd)
        v = lin(x, stacks["wv"][l].reshape(D, -1)).view(-1, Hkv, hd)
        q = rmsnorm(q, stacks["q_norm"][l], eps)
        k = rmsnorm(k, stacks["k_norm"][l], eps)
        if sliding:
            q, k = rope(q, pos, theta), rope(k, pos, theta)
        a = attention(q, k, v, config["sliding_windows"][l] if sliding else 0)
        x = x + rmsnorm(lin(a, stacks["wo"][l].reshape(Hq * hd, D)),
                        stacks["post_attn_norm"][l], eps)
        if config["mlp_layer_types"][l] == "sparse":
            y = experts(lin, x, config, stacks, i_sparse)
            i_sparse += 1
        else:
            y = swiglu(lin, x, stacks["w_gate"][i_dense],
                       stacks["w_up"][i_dense], stacks["w_down"][i_dense])
            i_dense += 1
        x = x + rmsnorm(y, stacks["post_ffn_norm"][l], eps)
    x = rmsnorm(x[first:], stacks["final_norm"], eps)
    return lin(x, stacks["lm_head"])


def logits(config: Dict, stacks: Dict[str, torch.Tensor], tokens: List[int],
           first: int, fp8: bool = False) -> torch.Tensor:
    """Float32 logits (len(tokens) - first, V) at positions first.. of one
    sequence: position p's row predicts token p + 1."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(config, stacks, tokens, first, fp8)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
