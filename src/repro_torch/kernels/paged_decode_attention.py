"""Paged flash-decode attention: hand-written CUDA kernels for Hopper, for
the split and the fused KV layouts, and their plain PyTorch versions.

Replaces the TPU kernels ``paged_decode_attention`` and
``paged_decode_attention_fused``
(``src/repro/kernels/paged_decode_attention.py:282`` and ``:303``,
``pallas_call`` at :249): one query token per sequence, q ``(B, Hq, hd)``,
against a physical page pool addressed by ``block_tables (B, max_pages)``;
keys at positions ``>= kv_len`` are masked.  The split layout keeps two
pools ``(n_pages, page_size, Hkv, hd)``; the fused layout one pool
``(n_pages, page_size, 2*Hkv, hd)`` with K of head h at 2h and V at 2h+1.

Bound on an H100: bytes at the main path's groups.  The function must read
each sequence's live K and V once per kv head, ``2 * kv_len * Hkv * hd * 2``
bytes in bf16, for ``group`` FLOPs per byte (up to 48 at granite-34b's MQA).
The kernels (``csrc/paged_decode_attention.cu`` and
``csrc/paged_decode_attention_fused.cu``, on the split-K decode body of
``csrc/decode_splitk.cuh`` shared with ``decode_attention``) cut each
sequence's keys into splits of ``native.DECODE_SPLIT_KEYS`` over CTAs,
hold up to 16 query heads of a kv head in one CTA (any group: a larger one
takes several row blocks, each reading the pages), stream K/V in their dtype through a ``cp.async``
ring, run bf16 on ``mma.sync`` tensor cores (P split into bf16 hi + lo for
P V) and f32 on f32 FMA, and merge the splits' partial softmaxes in the
same launch, in a fixed order.  The wrapper provides
the merge's f32 scratch and the stream's ticket buffer
(``native.decode_buffers``): one launch per call, nothing allocated by the
kernel.  The fused kernel reads each key's K and V as one contiguous run and
otherwise computes what the split kernel computes, bit for bit.

A sliding window (``window`` > 0: the query, at position kv_len - 1, over
the last ``window`` keys) runs the kernels' ``SlidingWindow``
instantiation, a template argument of the same body and so in the
kernel's name in a trace: the splits start at the window's first key, so
keys below it are neither read nor counted.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  The TPU kernel's ``pages_per_tile`` and
``buffering_depth`` (VMEM tile width and DMA depth) have no counterpart here.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native
from repro_torch.kernels.ref import (
    paged_decode_attention_fused_ref as paged_decode_attention_fused_plain,
    paged_decode_attention_ref as paged_decode_attention_plain,
)

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_void_p]
_FUSED_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_void_p]


def _check(q, pools, block_tables, kv_lens, heads_per_kv):
    """Validate a CUDA call on ``pools`` ({name: pool}, each holding
    ``heads_per_kv`` head rows per kv head); returns (B, Hq, Hkv, hd,
    page_size)."""
    dev = q.device
    B, Hq, hd = q.shape
    n_pages, ps, H, _ = next(iter(pools.values())).shape
    if H % heads_per_kv:
        raise ValueError(f"fused pool has an odd head count {H}")
    Hkv = H // heads_per_kv
    native.check_attention_dims(q.dtype, Hq, Hkv, hd, dev)
    native.check_cuda_tensor("q", q, q.dtype, 3, dev)
    for name, t in pools.items():
        native.check_cuda_tensor(name, t, q.dtype, 4, dev)
        if t.shape != (n_pages, ps, H, hd):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(n_pages, ps, H, hd)}")
    native.check_cuda_tensor("block_tables", block_tables, torch.int32, 2, dev)
    native.check_cuda_tensor("kv_lens", kv_lens, torch.int32, 1, dev)
    if block_tables.shape[0] != B or kv_lens.shape[0] != B:
        raise ValueError("block_tables / kv_lens batch != q batch")
    return B, Hq, Hkv, hd, ps


def paged_decode_attention(q, k_pages, v_pages, block_tables, kv_lens,
                           window=0):
    """q (B, Hq, hd); k/v_pages (n_pages, page_size, Hkv, hd); block_tables
    (B, max_pages) int32; kv_lens (B,) int32 -> (B, Hq, hd) in q's dtype.
    ``window`` > 0: over the last ``window`` keys only (the kernel's
    windowed instantiation, whose splits start at the window's first key)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                            kv_lens, window)
    B, Hq, Hkv, hd, ps = _check(
        q, {"k_pages": k_pages, "v_pages": v_pages}, block_tables, kv_lens, 1)
    max_pages = block_tables.shape[1]
    out = torch.empty_like(q)
    stream = native.stream_ptr(q.device)
    part, tickets, n_splits = native.decode_buffers(q, max_pages * ps, stream)
    fn = native.load("paged_decode_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            native.data_ptr(part), native.data_ptr(tickets), B, Hq, Hkv, hd,
            ps, max_pages, n_splits, native.DTYPE_CODES[q.dtype], int(window),
            1.0 / math.sqrt(hd), stream)
    native.raise_on_error("paged_decode_attention", rc)
    paged_decode_attention.launches += 1
    paged_decode_attention.windowed_launches += window > 0
    return out


paged_decode_attention.launches = 0
paged_decode_attention.windowed_launches = 0     # of them, the windowed ones


def paged_decode_attention_fused(q, kv_pages, block_tables, kv_lens,
                                 window=0):
    """q (B, Hq, hd); kv_pages (n_pages, page_size, 2*Hkv, hd) head-
    interleaved; block_tables (B, max_pages) int32; kv_lens (B,) int32
    -> (B, Hq, hd) in q's dtype; ``window`` as for the split layout."""
    if q.device.type == "cpu":
        return paged_decode_attention_fused_plain(q, kv_pages, block_tables,
                                                  kv_lens, window)
    B, Hq, Hkv, hd, ps = _check(q, {"kv_pages": kv_pages}, block_tables,
                                kv_lens, 2)
    max_pages = block_tables.shape[1]
    out = torch.empty_like(q)
    stream = native.stream_ptr(q.device)
    part, tickets, n_splits = native.decode_buffers(q, max_pages * ps, stream)
    fn = native.load("paged_decode_attention_fused", _FUSED_ARGTYPES)
    rc = fn(q.data_ptr(), kv_pages.data_ptr(), block_tables.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), native.data_ptr(part),
            native.data_ptr(tickets), B, Hq, Hkv, hd, ps, max_pages,
            n_splits, native.DTYPE_CODES[q.dtype], int(window),
            1.0 / math.sqrt(hd), stream)
    native.raise_on_error("paged_decode_attention_fused", rc)
    paged_decode_attention_fused.launches += 1
    paged_decode_attention_fused.windowed_launches += window > 0
    return out


paged_decode_attention_fused.launches = 0
paged_decode_attention_fused.windowed_launches = 0     # of them, the windowed ones
