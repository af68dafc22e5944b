"""Model primitives of the transformer (norms, RoPE, the whole-sequence
attention of prefill, decode and training, the dense and MoE FFNs), as plain
functions on tensors with explicit parameter dicts (the port of the matching
parts of ``repro/models/layers.py``).

Parameters keep the JAX package's shapes (``wq (D, Hq, hd)``, ``wo (Hq, hd,
D)``, ...), so weights convert one to one and the tests compare like with
like.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import grouped_swiglu as GK


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


def init_attention(gen, cfg, dtype, device, d_model: Optional[int] = None,
                   cross: bool = False):
    """The attention projections of width ``d_model`` (``cfg.d_model`` by
    default).  ``cross`` (whisper's cross-attention) changes nothing, as in
    the reference: its K/V project the encoder output, of the same width."""
    d, hd = d_model or cfg.d_model, cfg.resolved_head_dim
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
# attention (GQA, causal offset, sliding window, padded-cache masking)
# ---------------------------------------------------------------------------


INVALID_POS = -(1 << 30)  # sentinel for unwritten ring-buffer slots

# "auto" (the default): training runs the flash blocked-softmax path and
# prefill the exact chunked path; "flash" / "naive" force one of them (tests,
# A/B).  Decode (one query) always takes the exact path.
ATTN_IMPL = "auto"

_attn_phase = threading.local()


@contextmanager
def attention_phase(phase: str):
    """"train" (the default) or "prefill": set by the ``Model`` entry points,
    read by ``attention`` in this thread."""
    prev = getattr(_attn_phase, "v", "train")
    _attn_phase.v = phase
    try:
        yield
    finally:
        _attn_phase.v = prev


FLASH_BLOCK_Q = 1024
FLASH_BLOCK_K = 4096


def attention(q, k, v, **kw):
    """``attention_naive`` for one query, under ``ATTN_IMPL == "naive"`` and
    in the prefill phase; ``flash_attention`` otherwise.  The two mask
    differently and round differently in bf16, so which one runs decides
    the result."""
    if q.shape[1] == 1 or ATTN_IMPL == "naive":
        return attention_naive(q, k, v, **kw)
    if ATTN_IMPL == "flash":
        return flash_attention(q, k, v, **kw)
    if getattr(_attn_phase, "v", "train") == "prefill":
        return attention_naive(q, k, v, **kw)
    return flash_attention(q, k, v, **kw)


def _scaled_queries(q, Hkv: int):
    """q * 1/sqrt(hd) rounded to q's dtype, (B, Sq, Hkv, g, hd) in f32.  The
    scale is rounded to q's dtype first, as JAX rounds the weak-typed
    scalar (on the host: no device tensor a call); the f32 upcast is exact,
    so the products that follow are the reference's bf16-operand,
    f32-result products."""
    B, Sq, Hq, hd = q.shape
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype).item()
    return (q * scale).float().reshape(B, Sq, Hkv, Hq // Hkv, hd)


def _positions(q_offset, kv_positions, B: int, Sq: int, Skv: int, device):
    """Absolute query positions (B, Sq) from ``q_offset`` (a scalar or one
    per row) and key positions (B, Skv): ``kv_positions``, or 0..Skv-1."""
    ar = torch.arange(Sq, device=device)[None, :]
    if isinstance(q_offset, int):       # no device tensor for a scalar
        q_pos = (ar + q_offset).expand(B, Sq)
    else:
        off = torch.as_tensor(q_offset, device=device)
        q_pos = (ar + off[:, None] if off.ndim else ar + off).expand(B, Sq)
    if kv_positions is None:
        k_pos = torch.arange(Skv, device=device)[None, :].expand(B, Skv)
    else:
        k_pos = kv_positions
    return q_pos, k_pos


def attention_naive(q, k, v, *, q_offset=0, kv_lens=None, causal: bool = True,
                    sliding_window: int = 0, kv_positions=None):
    """Exact GQA attention with flexible masking.

    q (B, Sq, Hq, hd); k, v (B, Skv, Hkv, hd).  Query i sits at position
    ``q_offset + i`` (``q_offset`` a scalar or (B,)); key j at position j,
    or ``kv_positions[:, j]`` (a sliding-window ring, where ``INVALID_POS``
    marks an unwritten slot).  The causal mask admits key_pos <= query_pos,
    the window also needs key_pos > query_pos - window, ``kv_lens`` (B,)
    admits key INDEX j < kv_lens.  Masked scores are -1e30, so a row with no
    valid key is the uniform mean of V.  Scores and P.V are f32 products of
    operands in the inputs' dtype; the probabilities are rounded to V's
    dtype.  Sq is split into chunks of ``_pick_chunk(Sq)`` queries to bound
    the score temporaries; the chunks do not change the values.
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0
    qf = _scaled_queries(q, Hkv)
    q_pos, k_pos = _positions(q_offset, kv_positions, B, Sq, Skv, q.device)
    kf, vf = k.float(), v.float()
    key_idx = torch.arange(Skv, device=q.device)

    def block(q_blk, qp):
        scores = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, kf)
        mask = torch.ones((B, q_blk.shape[1], Skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= k_pos[:, None, :] <= qp[:, :, None]
        if sliding_window:
            mask &= k_pos[:, None, :] > qp[:, :, None] - sliding_window
        if kv_lens is not None:
            mask &= key_idx[None, None, :] < kv_lens[:, None, None]
        scores = torch.where(mask[:, None, None], scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
        return torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)

    Qc = _pick_chunk(Sq)
    out = torch.cat([block(qf[:, i:i + Qc], q_pos[:, i:i + Qc])
                     for i in range(0, Sq, Qc)], dim=1)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def _pick_chunk(s: int, target: int = 512) -> int:
    """Largest divisor of s that is <= target (bounds attention score temps)."""
    if s <= target:
        return s
    for c in range(target, 0, -1):
        if s % c == 0:
            return c
    return s


def flash_attention(q, k, v, *, q_offset=0, kv_lens=None, causal: bool = True,
                    sliding_window: int = 0, kv_positions=None,
                    block_q: int = 0, block_k: int = 0):
    """Blocked online-softmax attention, ``attention_naive``'s semantics but
    never the (Sq, Skv) score matrix: query blocks of
    ``_pick_chunk(Sq, block_q or FLASH_BLOCK_Q)``, an inner loop over key
    blocks of ``_pick_chunk(Skv, block_k or FLASH_BLOCK_K)`` carrying the
    running max ``m``, sum ``l`` and accumulator in f32.  Masked scores are
    -inf (the max and rescale guarded against a block with no valid key),
    ``kv_lens`` admits key POSITION < kv_lens, ``l`` sums the f32
    probabilities and P.V multiplies them rounded to V's dtype; a row with
    no valid key returns 0."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0
    g = Hq // Hkv
    qf = _scaled_queries(q, Hkv)
    q_pos, k_pos = _positions(q_offset, kv_positions, B, Sq, Skv, q.device)
    blk_q = _pick_chunk(Sq, block_q or FLASH_BLOCK_Q)
    blk_k = _pick_chunk(Skv, block_k or FLASH_BLOCK_K)
    kv_len_col = None if kv_lens is None else kv_lens[:, None, None]

    def q_chunk(q_blk, qp):
        m = torch.full((B, blk_q, Hkv, g), -math.inf, device=q.device)
        l = torch.zeros((B, blk_q, Hkv, g), device=q.device)
        acc = torch.zeros((B, blk_q, Hkv, g, hd), device=q.device)
        for j in range(0, Skv, blk_k):
            kp = k_pos[:, j:j + blk_k]
            s = torch.einsum("bqhgd,bkhd->bqhgk", q_blk,
                             k[:, j:j + blk_k].float())
            mask = torch.ones((B, blk_q, blk_k), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kp[:, None, :] <= qp[:, :, None]
            if sliding_window:
                mask &= kp[:, None, :] > qp[:, :, None] - sliding_window
            if kv_len_col is not None:
                mask &= kp[:, None, :] < kv_len_col
            maskh = mask[:, :, None, None, :]
            s = torch.where(maskh, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # a row with no valid key so far keeps m == -inf: guard the exp
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            p = torch.where(maskh, torch.exp(s - m_safe[..., None]), 0.0)
            l = l * alpha + p.sum(dim=-1)
            p16 = p.to(v.dtype).float()
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p16, v[:, j:j + blk_k].float())
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        return acc / l_safe[..., None]

    out = torch.cat([q_chunk(qf[:, i:i + blk_q], q_pos[:, i:i + blk_q])
                     for i in range(0, Sq, blk_q)], dim=1)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# attention projections and SwiGLU FFN
# ---------------------------------------------------------------------------


def qkv_project(p, x, cfg, positions=None, rope: bool = True,
                rope_tabs=None):
    """x: (B, S, D) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd): the projections,
    their biases (``bq``...), QK-norm (``q_norm``, ``k_norm``), then RoPE
    unless ``rope`` is False; ``rope_tabs`` is ``rope_tables(positions,
    ...)`` when the caller has them (the engine round computes them once
    for all layers)."""
    B, S, D = x.shape

    def proj(w):
        return (x @ w.reshape(D, -1)).reshape(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if "q_norm" in p:           # QK-norm: RMSNorm over hd, before RoPE
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
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
        if w.device.type == "meta":      # shapes only: nothing to draw
            return w
        for e in range(m.n_experts):
            w[e] = dense_init(gen, (rows, cols), dtype, device, scale=scale)
        return w

    p = {
        "router": dense_init(gen, (d, m.n_experts), torch.float32, device),
        "w_gate": experts(d, m.d_ff),
        "w_up": experts(d, m.d_ff),
        "w_down": experts(m.d_ff, d),
    }
    if m.held != m.n_experts:       # the experts held here only
        p.update({k: w[m.first_held:m.first_held + m.held].clone()
                  for k, w in p.items() if k != "router"})
    if m.scoring == "sigmoid":      # the selection bias
        p["router_bias"] = torch.zeros((m.n_experts,), dtype=torch.float32,
                                       device=device)
    if m.n_shared:
        p["shared"] = init_ffn(gen, d, m.shared_d_ff, dtype, device)
    return p


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


def route(p, xg, m):
    """The router of ``m`` (a ``MoEConfig``): ``(top_w (G, t, K) f32,
    top_idx (G, t, K) int64)`` over all ``m.n_experts``.  Softmax scoring is
    ``moe_route``.  Sigmoid scoring is DeepSeek-V3's router: s =
    sigmoid(x W_r) in f32, the top-k chosen on s + the selection bias
    (``router_bias``) in ``moe_route``'s order, their weights the chosen s,
    renormalised to sum 1 (+ 1e-20, as DeepSeek-V3's), times
    ``m.routed_scale``."""
    if m.scoring == "softmax":
        top_w, top_idx = moe_route(p, xg, m.top_k)
    else:
        assert m.scoring == "sigmoid", m.scoring
        s = torch.sigmoid(xg.float() @ p["router"])
        _, top_idx = torch.sort(s + p["router_bias"], dim=-1,
                                descending=True, stable=True)
        top_idx = top_idx[..., :m.top_k]
        top_w = s.gather(-1, top_idx)
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    if m.routed_scale != 1.0:
        top_w = top_w * m.routed_scale
    return top_w, top_idx


def expert_hidden(p, expert_in):
    """expert_in (E, N, D) -> each expert's SwiGLU hidden (E, N, d_ff)."""
    return (F.silu(torch.bmm(expert_in, p["w_gate"]))
            * torch.bmm(expert_in, p["w_up"]))


def expert_ffn(p, expert_in):
    """expert_in (E, N, D) -> (E, N, D): each expert's SwiGLU on its rows."""
    return torch.bmm(expert_hidden(p, expert_in), p["w_down"])


def capacity_rank(top_idx, order: str):
    """Each (token, choice)'s rank among its group's choices of the same
    expert in the impl's capacity order: its slot in the expert, kept where
    below the capacity.  top_idx (G, t, K) -> (G, t, K).  ``"token"``
    takes capacity token-major over the flattened (token, choice) axis
    (the scatter dispatch); ``"choice"`` takes choice 0 of every token
    first, then choice 1 (the one-hot dispatch: a choice behind a full
    expert ranks past its capacity either way).  Every lane takes
    capacity, padding and idle lanes included, as in the reference.  A
    stable sort of each group's experts, no (t*K, E) one-hots."""
    G, t, K = top_idx.shape
    flat = (top_idx if order == "token" else top_idx.transpose(1, 2))
    flat = flat.reshape(G, t * K)
    sk, perm = torch.sort(flat, dim=1, stable=True)
    ar = torch.arange(t * K, device=top_idx.device).expand(G, t * K)
    rank = torch.empty_like(perm).scatter_(
        1, perm, ar - torch.searchsorted(sk, sk))
    if order == "token":
        return rank.view(G, t, K)
    return rank.view(G, K, t).transpose(1, 2)


def capacity_rows(top_idx, n_experts: int, C: int, order: str):
    """Each (token, choice)'s row in the experts' input buffer ``(E, G*C)``,
    flattened: ``e * G*C + g * C + slot``, or ``E * G*C`` (the sink) where
    expert ``e`` is full: the slot is its ``capacity_rank``, kept below
    ``C``.  top_idx (G, t, K) -> (G, t, K)."""
    G = top_idx.shape[0]
    slot = capacity_rank(top_idx, order)
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
    if m.held != m.n_experts:
        raise NotImplementedError(
            "a share of the experts runs in the engine round only "
            "(moe_round); the batched expert GEMMs hold every expert")
    xg = moe_groups(x, group_size)
    G, t, D = xg.shape
    top_w, top_idx = route(p, xg, m)
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
    return _combine(top_w, rows, x, "choice")


def moe_ffn_scatter(p, x, cfg, group_size: int = 0):
    """The group-local scatter dispatch's semantics (``repro/models/
    layers.py`` ``moe_ffn_scatter``): capacity taken token-major over the
    flattened (token, choice) axis; each kept choice's expert output times
    its weight in x's dtype, summed over the choices in x's dtype."""
    top_w, rows = _expert_rows(p, x, cfg, group_size, "token")
    return _combine(top_w, rows, x, "token")


def _combine(top_w, rows, x, order: str):
    """The weighted sum over the K choices, in each impl's dtype rule:
    ``"token"`` (scatter) in x's dtype, ``"choice"`` (one-hot) in f32 with
    the weight cast to x's dtype first."""
    if order == "token":
        y = (rows * top_w.to(x.dtype)[..., None]).sum(2)
    else:
        y = (top_w.to(rows.dtype)[..., None].float() * rows.float()).sum(2)
    return y.to(x.dtype).reshape(x.shape)


# an expert's capacity above which the capacity-bound round runs the batched
# expert GEMMs and not the grouped kernels (see moe_round): one row tile
GROUPED_MAX_CAPACITY = GK.ROW_TILE


def moe_round(p, x, cfg, lane_mask, counts=None, group_size: int = 0):
    """The engine round's MoE FFN: ``moe_ffn_scatter``'s or ``moe_ffn``'s
    semantics (``cfg.moe_impl``), computing only the kept (token, choice)
    rows and reading only the experts that hold one (the grouped kernels,
    ``kernels.grouped_swiglu``).  x (B, C, D); lane_mask (B, C) the round's
    real lanes; ``counts`` (3,) int64, if given, gains (experts read, expert
    rows computed, real lanes' choices of experts not held here), on the
    device and inside a CUDA graph too.

    The router (``route``) scores every expert; where only some are held
    here (``cfg.moe.first_held``, ``n_held``: a chip's share under expert
    parallelism) the choices of absent experts are dropped -- not computed,
    their part left out of the output -- and the rest keep their weights.

    Where no choice can drop (``moe_capacity >= `` the group's tokens:
    capacity factor at least E / K), only real lanes enter, and a masked
    lane's expert output is zero: no real token's choice can be displaced,
    so every real row is the reference's.  Otherwise every lane takes
    capacity in the impl's order, padding and idle lanes included, as in
    the reference.

    Two cases run the reference's layer (the batched expert GEMMs over
    every expert's capacity buffer) instead.  A capacity-bound round whose
    experts may hold more than ``GROUPED_MAX_CAPACITY`` rows (one row
    tile): its choices reach every expert, so the grouped kernels read the
    same weights while the batched GEMMs compute at most 1.25x the kept
    rows near the card's peak, and past one tile each further tile reads
    its expert again from L2 (on an H100, mixtral-8x7b's layer at capacity
    80: 1.13 ms batched against 1.18 ms grouped; at 640 the kernels alone
    take 4.03 ms against the batched layer's 2.90).  And the meta device
    (the dry-run, which counts the reference's lowering of the round): the
    grouped path's work depends on the routing, which meta tensors do not
    hold."""
    m = cfg.moe
    order = "token" if cfg.moe_impl == "scatter" else "choice"
    xg = moe_groups(x, group_size)
    G, t, D = xg.shape
    C = moe_capacity(t, m.n_experts, m.top_k, m.capacity_factor)
    if x.device.type == "meta" or t > C > GROUPED_MAX_CAPACITY:
        if counts is not None:
            counts[0] += m.n_experts
            counts[1] += m.n_experts * G * C
        return _combine(*_expert_rows(p, x, cfg, group_size, order), x, order)
    top_w, top_idx = route(p, xg, m)
    # each choice's expert among those held here, and whether it is held
    local = top_idx - m.first_held
    held = (local >= 0) & (local < m.held)
    real = lane_mask.reshape(G, t, 1)
    if C >= t:
        kept = real.expand(G, t, m.top_k)
        # a masked lane's weights too: a NaN lane's would make its 0 NaN
        top_w = torch.where(kept, top_w, 0.0)
    else:
        kept = capacity_rank(top_idx, order) < C
    kept = kept & held
    lay = GK.expert_layout(local.clamp(0, m.held - 1).reshape(G * t, m.top_k),
                           kept.reshape(G * t, m.top_k), m.held)
    h = GK.grouped_gate_up(xg.reshape(G * t, D), p["w_gate"], p["w_up"],
                           lay.tok, lay.tiles, lay.n_tiles)
    y = GK.grouped_down(h, p["w_down"], lay.tiles, lay.n_tiles)
    rows = torch.where(kept[..., None], y[lay.row].view(G, t, m.top_k, D),
                       0.0)
    if counts is not None:
        counts.add_(torch.stack([(lay.counts > 0).sum(), lay.counts.sum(),
                                 (real & ~held).sum()]))
    return _combine(top_w, rows, x, order)
