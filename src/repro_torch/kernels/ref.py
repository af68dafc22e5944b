"""Plain PyTorch versions of the attention kernels (exact f32 math, no
tiling), dense and paged, split and fused KV layouts, of the INT8 host-page
math and of the fused SwiGLU: the port of ``repro/kernels/ref.py:14-176``.

They are the CPU path of the engine and the references the CUDA kernels are
held against on the card.  Like the jnp oracles, a row with no valid key
comes out NaN (a softmax over nothing); the kernels store 0 there.
"""
from __future__ import annotations

import math

import torch


def chunked_prefill_attention_ref(
    q,            # (B, Sq, Hq, hd)   the prefill chunk's queries
    k_cache,      # (B, Skv, Hkv, hd) prefix KV incl. the chunk's own K
    v_cache,      # (B, Skv, Hkv, hd)
    kv_lens,      # (B,) valid KV length (prefix + chunk)
    q_offset,     # (B,) absolute position of q[:, 0] (= prefix length)
    window=0,     # > 0: each query sees its last ``window`` positions only
):
    """Chunk of queries attends to (prefix ‖ itself) with a causal offset.

    Query i (absolute pos q_offset + i) sees key j iff j <= q_offset + i and
    j < kv_lens, and with a ``window`` also j > q_offset + i - window.  All
    math in f32.
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    qf = q.float() * (1.0 / math.sqrt(hd))
    kf = k_cache.float()
    vf = v_cache.float()

    qf = qf.reshape(B, Sq, Hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
    dev = q.device
    q_pos = q_offset.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    k_pos = torch.arange(Skv, device=dev)[None, :]
    mask = (k_pos[:, None, :] <= q_pos[:, :, None]) & (
        k_pos[:, None, :] < kv_lens.long()[:, None, None]
    )                                                            # (B, Sq, Skv)
    if window:
        mask &= k_pos[:, None, :] > q_pos[:, :, None] - window
    scores = scores.masked_fill(~mask[:, None, None, :, :], -math.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def decode_attention_ref(
    q,            # (B, Hq, hd)   one query token per sequence
    k_cache,      # (B, S, Hkv, hd)
    v_cache,      # (B, S, Hkv, hd)
    kv_lens,      # (B,) valid lengths
    window=0,     # > 0: the last ``window`` valid keys only
):
    """Single-token flash-decode reference: full softmax over the valid
    cache (the query sits at position kv_len - 1), or over its last
    ``window`` keys."""
    B, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, Hkv, g, hd)
    scores = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = k_pos < kv_lens.long()[:, None]
    if window:
        mask &= k_pos >= kv_lens.long()[:, None] - window
    scores = scores.masked_fill(~mask[:, None, None, :], -math.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache.float())
    return out.reshape(B, Hq, hd).to(q.dtype)


def gather_pages(pages, block_tables):
    """Materialize per-sequence dense K/V from a physical page pool.

    pages: (n_pages, page_size, H, hd); block_tables: (B, max_pages) int
    -> (B, max_pages * page_size, H, hd).  Padding table entries may point at
    any valid page: positions past ``kv_lens`` are masked by the caller.
    """
    B, P = block_tables.shape
    g = pages[block_tables.long()]               # (B, P, ps, H, hd)
    return g.reshape(B, P * pages.shape[1], *pages.shape[2:])


def paged_prefill_attention_ref(q, k_pages, v_pages, block_tables, kv_lens,
                                q_offset, window=0):
    """Paged chunked-prefill reference: gather the block table into a dense
    cache, then the exact dense computation."""
    return chunked_prefill_attention_ref(
        q, gather_pages(k_pages, block_tables),
        gather_pages(v_pages, block_tables), kv_lens, q_offset, window,
    )


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, kv_lens,
                               window=0):
    """Paged flash-decode reference via dense gather."""
    return decode_attention_ref(
        q, gather_pages(k_pages, block_tables),
        gather_pages(v_pages, block_tables), kv_lens, window,
    )


def split_fused_pages(kv_pages):
    """Un-interleave a fused head-interleaved pool: head axis
    ``[K0,V0,K1,V1,...]`` -> split ``(k_pages, v_pages)`` strided views.

    kv_pages: (n_pages, page_size, 2*Hkv, hd) -> two
    (n_pages, page_size, Hkv, hd) tensors.  The fused layout is pure data
    movement, so every fused plain version is the split one over these
    views.
    """
    return kv_pages[:, :, 0::2], kv_pages[:, :, 1::2]


def fuse_pages(k_pages, v_pages):
    """Inverse of ``split_fused_pages``: interleave split K/V pools onto the
    head axis (``(n_pages, ps, Hkv, hd)`` x2 -> ``(n_pages, ps, 2*Hkv, hd)``)."""
    n_pages, ps, Hkv, hd = k_pages.shape
    return torch.stack([k_pages, v_pages], dim=3).reshape(
        n_pages, ps, 2 * Hkv, hd)


def paged_prefill_attention_fused_ref(q, kv_pages, block_tables, kv_lens,
                                      q_offset, window=0):
    """Fused-layout paged chunked-prefill reference (un-interleave + split
    reference)."""
    k_pages, v_pages = split_fused_pages(kv_pages)
    return paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                       kv_lens, q_offset, window)


def paged_decode_attention_fused_ref(q, kv_pages, block_tables, kv_lens,
                                     window=0):
    """Fused-layout paged flash-decode reference."""
    k_pages, v_pages = split_fused_pages(kv_pages)
    return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                      kv_lens, window)


def quantize_pages(pages):
    """INT8-quantize staged KV pages with per-page-per-head absmax scales.

    ``pages``: ``(L, n_pages, page_size, H, hd)`` (H is ``Hkv`` for the split
    layout, ``2*Hkv`` for the fused one).  Returns ``(q, scales)``: ``q`` int8
    of the same shape and ``scales`` f32 ``(L, n_pages, 1, H, 1)``, so that
    ``q * scales`` broadcasts back.  Symmetric, scale ``absmax / 127`` per
    (layer, page, head), round half to even, clipped to +-127; an all-zero
    head quantizes to zeros with scale 0.

    Both divisions are IEEE divisions by a tensor on ``pages``' device: a
    Python-scalar divisor would let PyTorch's CUDA path multiply by its
    reciprocal instead, one ulp away from the CUDA kernel's ``amax / 127.f``.
    """
    x = pages.float()
    amax = x.abs().amax(dim=(2, 4), keepdim=True)
    scales = amax / torch.full((), 127.0, device=x.device)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return q, scales


def dequantize_pages(q, scales, dtype):
    """Inverse of ``quantize_pages``: ``q * scales`` in f32, cast to the pool
    dtype."""
    return (q.float() * scales).to(dtype)


def fused_swiglu_ref(x, w_gate, w_up, w_down):
    """x: (M, D); w_gate/w_up: (D, F); w_down: (F, D) -> (M, D), f32 math
    throughout (the jnp oracle: the hidden activations stay f32)."""
    xf = x.float()
    h = torch.nn.functional.silu(xf @ w_gate.float()) * (xf @ w_up.float())
    return (h @ w_down.float()).to(x.dtype)


def fused_swiglu_plain(x, w_gate, w_up, w_down):
    """What the TPU kernel ``fused_swiglu`` computes
    (``repro/kernels/fused_swiglu.py:47-62``): the gate and up products in
    f32, ``silu(g) * u`` as ``g * sigmoid(g) * u`` in f32 and rounded to
    ``x.dtype`` before the f32 down product -- where ``fused_swiglu_ref``
    keeps the hidden activations f32."""
    xf = x.float()
    g = xf @ w_gate.float()
    u = xf @ w_up.float()
    h = (g * torch.sigmoid(g) * u).to(x.dtype)
    return (h.float() @ w_down.float()).to(x.dtype)
