"""Model primitives of the transformer's serving path (dense and MoE FFNs),
as plain functions on tensors with explicit parameter dicts (the port of
the matching parts of ``repro/models/layers.py``).

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


# ---------------------------------------------------------------------------
# Mixture of Experts (grouped GShard-style dispatch; capacity-bounded)
# ---------------------------------------------------------------------------

MOE_GROUP_SIZE = 4096  # tokens per capacity group


def init_moe(gen, cfg, dtype, device):
    """The router in f32 and the experts' SwiGLU weights ``(E, d, d_ff)``,
    ``(E, d, d_ff)``, ``(E, d_ff, d)`` in ``dtype``, with the reference's
    init distribution (its ``dense_init`` takes the fan-in from the first
    axis, here the expert count).  Each expert is drawn on its own: one f32
    draw of a full expert tensor at arctic-480b's widths would be 17.9 GB
    of temporary memory."""
    m = cfg.moe
    d = cfg.d_model
    scale = 1.0 / math.sqrt(m.n_experts)

    def experts(rows, cols):
        w = torch.empty((m.n_experts, rows, cols), dtype=dtype, device=device)
        for e in range(m.n_experts):
            w[e] = dense_init(gen, (rows, cols), dtype, device, scale=scale)
        return w

    return {
        "router": dense_init(gen, (d, m.n_experts), torch.float32, device),
        "w_gate": experts(d, m.d_ff),
        "w_up": experts(d, m.d_ff),
        "w_down": experts(m.d_ff, d),
    }


def moe_capacity(tokens_per_group: int, n_experts: int, top_k: int,
                 cf: float) -> int:
    return max(1, math.ceil(tokens_per_group * top_k / n_experts * cf))


def moe_groups(x, group_size: int):
    """x (B, S, D) -> (G, gsz, D): every lane of x, padding and idle lanes
    included, in groups of ``gsz`` tokens (the gcd fallback when T is not a
    multiple of the group size)."""
    B, S, D = x.shape
    T = B * S
    gsz = group_size or min(MOE_GROUP_SIZE, T)
    if T % gsz:
        gsz = math.gcd(T, gsz) if math.gcd(T, gsz) > 1 else T
    return x.reshape(T // gsz, gsz, D)


def moe_route(p, xg, top_k: int):
    """Router logits in f32, softmax, top-k and renormalised weights:
    ``(top_w (G, t, K) f32, top_idx (G, t, K) int64)``.  The top-k order is
    ``jax.lax.top_k``'s -- largest first, NaN above every number, the lowest
    index first among equals -- which a stable descending sort gives and
    ``torch.topk`` does not (it may take the highest indices of a tie)."""
    probs = torch.softmax(xg.float() @ p["router"], dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[..., :top_k], top_idx[..., :top_k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    return top_w, top_idx


def expert_hidden(p, expert_in):
    """expert_in (E, N, D) -> each expert's SwiGLU hidden (E, N, d_ff)."""
    return (F.silu(torch.bmm(expert_in, p["w_gate"]))
            * torch.bmm(expert_in, p["w_up"]))


def expert_ffn(p, expert_in):
    """expert_in (E, N, D) -> (E, N, D): each expert's SwiGLU on its rows."""
    return torch.bmm(expert_hidden(p, expert_in), p["w_down"])


def capacity_rows(top_idx, n_experts: int, C: int, order: str):
    """Each (token, choice)'s row in the experts' input buffer ``(E, G*C)``,
    flattened: ``e * G*C + g * C + slot``, or ``E * G*C`` (the sink) where
    expert ``e`` is full.  top_idx (G, t, K) -> (G, t, K).  ``order``:
    ``"token"`` takes capacity token-major over the flattened (token,
    choice) axis (the scatter dispatch); ``"choice"`` takes choice 0 of
    every token first, then choice 1 with the counts carried over (the
    one-hot dispatch).  Every lane takes capacity, padding and idle lanes
    included, as in the reference."""
    G, t, K = top_idx.shape
    if order == "token":
        eq = F.one_hot(top_idx.reshape(G, t * K), n_experts)     # (G, tK, E)
        slot = ((eq.cumsum(1) - eq) * eq).sum(-1).view(G, t, K)
    else:
        assert order == "choice", order
        counts = torch.zeros((G, 1, n_experts), dtype=torch.long,
                             device=top_idx.device)
        slots = []
        for j in range(K):
            mask = F.one_hot(top_idx[:, :, j], n_experts)         # (G, t, E)
            slot_j = ((counts + mask.cumsum(1) - mask) * mask).sum(-1)
            counts = counts + (mask * (slot_j < C)[..., None]).sum(
                1, keepdim=True)
            slots.append(slot_j)
        slot = torch.stack(slots, -1)
    g = torch.arange(G, device=top_idx.device).view(G, 1, 1)
    return torch.where(slot < C, top_idx * (G * C) + g * C + slot,
                       n_experts * G * C)


def _dispatch(xg, dest, n_slots: int):
    """The experts' input rows (E * G*C, D): row ``dest`` of each (token,
    choice) holds its token, an empty slot zeros.  Gathered by index,
    never multiplied by a 0/1 dispatch tensor: a NaN token (an idle lane of
    the plain attention, a poisoned request on the card) stays in its own
    slots and poisons no other."""
    G, t, D = xg.shape
    T, K = G * t, dest.shape[-1]
    # (not repeat_interleave: on a card it reads its output size back)
    tok = torch.arange(T * K, device=xg.device) // K
    src = torch.full((n_slots + 1,), T, dtype=torch.long, device=xg.device)
    # real slots are distinct; dropped choices all land in the sink entry
    src.index_put_((dest.reshape(-1),), tok)
    rows = torch.cat([xg.reshape(T, D), xg.new_zeros((1, D))])
    return rows[src[:n_slots]]


def _expert_rows(p, x, cfg, group_size: int, order: str):
    """Route, take capacity in ``order``, run the experts: (top_w (G, t, K)
    f32, each kept choice's expert output (G, t, K, D), zeros where
    dropped)."""
    m = cfg.moe
    xg = moe_groups(x, group_size)
    G, t, D = xg.shape
    top_w, top_idx = moe_route(p, xg, m.top_k)
    C = moe_capacity(t, m.n_experts, m.top_k, m.capacity_factor)
    n_slots = m.n_experts * G * C
    dest = capacity_rows(top_idx, m.n_experts, C, order)
    expert_in = _dispatch(xg, dest, n_slots).view(m.n_experts, G * C, D)
    out = expert_ffn(p, expert_in).view(n_slots, D)
    kept = (dest < n_slots)[..., None]
    return top_w, torch.where(kept, out[dest.clamp(max=n_slots - 1)], 0.0)


def moe_ffn(p, x, cfg, group_size: int = 0):
    """The GShard one-hot dispatch's semantics (``repro/models/layers.py``
    ``moe_ffn``): x (B, S, D) -> (B, S, D), the router in f32 and the
    experts in x's dtype; each expert takes ``C = moe_capacity(...)``
    tokens per group of ``MOE_GROUP_SIZE``, choice 0 of every token first;
    the overflow is dropped.  Dispatch and combine are gathers, with no
    (G, t, E, C) tensors: on finite inputs exactly the one-hot einsums'
    result (their other terms are exact zeros).  The combine weight is cast
    to the experts' dtype and the choices summed in f32, as the combine
    einsum's dot sums."""
    top_w, rows = _expert_rows(p, x, cfg, group_size, "choice")
    y = (top_w.to(rows.dtype)[..., None].float() * rows.float()).sum(2)
    return y.to(rows.dtype).reshape(x.shape)


def moe_ffn_scatter(p, x, cfg, group_size: int = 0):
    """The group-local scatter dispatch's semantics (``repro/models/
    layers.py`` ``moe_ffn_scatter``): capacity taken token-major over the
    flattened (token, choice) axis; each kept choice's expert output times
    its weight in x's dtype, summed over the choices in x's dtype."""
    top_w, rows = _expert_rows(p, x, cfg, group_size, "token")
    return (rows * top_w.to(x.dtype)[..., None]).sum(2).reshape(x.shape)
