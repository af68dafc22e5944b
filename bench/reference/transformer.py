"""Plain reference of a decoder-only transformer (dense, or with experts
and a dense residual, as ``arctic-1l``), in float32, one sequence at a
time.

Plain PyTorch only: no kernel, no cache, no batching, no import of the
program.  It reads the weights the benchmark made (``bench/weights.py``'s
stacks), upcast layer by layer, and the configuration file's published
keys.  The equations:

- x = embed[tokens]
- each layer: h = rmsnorm(x) * attn_norm; q, k, v = h Wq, h Wk, h Wv;
  rotary embedding on q and k with the first and second halves of each
  head as pairs (theta = ``rope_theta``); causal attention, each group of
  ``num_attention_heads / num_key_value_heads`` query heads on one key
  head, scores scaled by 1/sqrt(head_dim); x = x + attn Wo;
  h = rmsnorm(x) * ffn_norm; x = x + ffn(h), where
  - dense: ffn(h) = (silu(h Wgate) * h Wup) Wdown;
  - experts (``num_local_experts``): softmax of h Wrouter over the experts,
    the ``num_experts_per_tok`` largest, their weights renormalised to sum
    1, each chosen expert's SwiGLU times its weight, with no capacity
    (every choice is computed); with ``parallel_attn_mlp_res`` the dense
    SwiGLU of the same h, ``hidden_size`` wide, is added beside it.
- logits = (rmsnorm(x) * final_norm) Wlm.

Departure from the published Arctic, noted in PERF.md: Snowflake's model
feeds its expert layer the layer's input (before attention) and its dense
residual the output of attention, each under its own norm; the program,
and so this reference, feeds both the same normed output of attention.

``fp8=True`` is the control: every product of a linear layer takes its
operands rounded to float8 e4m3 (per row of the activations and per
output column of the weights, each scaled to the format's largest finite
value), the step below the bfloat16 the configurations state.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Linear:
    """x (n, din) @ w (din, dout), in float32 or through float8."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w


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


def attention(q, k, v):
    """Causal GQA: q (S, Hq, hd), k/v (S, Hkv, hd) -> (S, Hq * hd)."""
    S, Hq, hd = q.shape
    g = Hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(S, Hq * hd)


def swiglu(lin, h, wg, wu, wd):
    return lin(F.silu(lin(h, wg)) * lin(h, wu), wd)


def experts(lin, h, router, wg, wu, wd, top_k: int):
    """Every token's top-k experts, no capacity."""
    probs = torch.softmax(h @ router.float(), dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in torch.unique(idx).tolist():
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        y = swiglu(lin, h[tok], wg[e], wu[e], wd[e])
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out


def logits(config: Dict, stacks: Dict[str, torch.Tensor], tokens: List[int],
           first: int, fp8: bool = False) -> torch.Tensor:
    """Float32 logits (len(tokens) - first, V) at positions first.. of one
    sequence: position p's row predicts token p + 1."""
    lin = Linear(fp8)
    dev = stacks["embed"].device
    D = config["hidden_size"]
    Hq, Hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or D // Hq
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    pos = torch.arange(len(tokens), device=dev)
    x = stacks["embed"][tok].float()
    for l in range(config["num_hidden_layers"]):
        h = rmsnorm(x, stacks["attn_norm"][l], eps)
        q = lin(h, stacks["wq"][l].reshape(D, -1)).view(-1, Hq, hd)
        k = lin(h, stacks["wk"][l].reshape(D, -1)).view(-1, Hkv, hd)
        v = lin(h, stacks["wv"][l].reshape(D, -1)).view(-1, Hkv, hd)
        a = attention(rope(q, pos, theta), rope(k, pos, theta), v)
        x = x + lin(a, stacks["wo"][l].reshape(Hq * hd, D))
        h = rmsnorm(x, stacks["ffn_norm"][l], eps)
        if config.get("num_local_experts"):
            y = experts(lin, h, stacks["router"][l], stacks["e_gate"][l],
                        stacks["e_up"][l], stacks["e_down"][l],
                        config["num_experts_per_tok"])
            if config.get("parallel_attn_mlp_res"):
                y = y + swiglu(lin, h, stacks["w_gate"][l],
                               stacks["w_up"][l], stacks["w_down"][l])
        else:
            y = swiglu(lin, h, stacks["w_gate"][l], stacks["w_up"][l],
                       stacks["w_down"][l])
        x = x + y
    x = rmsnorm(x[first:], stacks["final_norm"], eps)
    return lin(x, stacks["lm_head"])
