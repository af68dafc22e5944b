"""Model primitives of the dense transformer's serving path, as plain
functions on tensors with explicit parameter dicts (the port of the matching
parts of ``repro/models/layers.py``).

Parameters keep the JAX package's shapes (``wq (D, Hq, hd)``, ``wo (Hq, hd,
D)``, ...), so weights convert one to one and the tests compare like with
like.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None):
    """N(0, 1) * scale with scale 1/sqrt(fan_in) by default, drawn in f32 and
    cast (the same distribution as ``repro.models.layers.dense_init``)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * s).to(dtype)


def init_attention(gen, cfg, dtype, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads, hd), dtype, device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads, hd), dtype, device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads, hd), dtype, device),
        "wo": dense_init(gen, (cfg.n_heads, hd, d), dtype, device,
                         scale=1.0 / math.sqrt(d)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=device)
    return p


def init_ffn(gen, d_model: int, d_ff: int, dtype, device):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype, device),
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device),
    }


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-5):
    """f32 math, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles at ``positions`` (B, S) int, each
    (B, S, 1, head_dim / 2) f32: what ``apply_rope`` rotates by.  They
    depend on the positions only, so a round computes them once for every
    layer and for q and k alike."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs              # (B, S, hd/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x, positions, theta: float, tables=None):
    """x: (B, S, H, hd); positions: (B, S) int.  Split-half rotation: the
    first and second halves of hd form the pairs (not interleaved).
    ``tables`` is ``rope_tables(positions, hd, theta)``, computed here when
    not given."""
    cos, sin = tables or rope_tables(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention projections and SwiGLU FFN
# ---------------------------------------------------------------------------


def qkv_project(p, x, cfg, positions=None, rope: bool = True,
                rope_tabs=None):
    """x: (B, S, D) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd) with optional RoPE;
    ``rope_tabs`` is ``rope_tables(positions, ...)`` when the caller has
    them (the engine round computes them once for all layers)."""
    B, S, D = x.shape

    def proj(w):
        return (x @ w.reshape(D, -1)).reshape(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if rope and positions is not None:
        if rope_tabs is None:
            rope_tabs = rope_tables(positions, q.shape[-1], cfg.rope_theta)
        q = apply_rope(q, positions, cfg.rope_theta, rope_tabs)
        k = apply_rope(k, positions, cfg.rope_theta, rope_tabs)
    return q, k, v


def attn_output(p, attn, cfg):
    """attn: (B, S, Hq, hd) -> (B, S, D)."""
    B, S = attn.shape[:2]
    wo = p["wo"]
    return attn.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def ffn(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
