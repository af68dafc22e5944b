"""Paged chunked-prefill attention: hand-written CUDA kernels for Hopper, for
the split and the fused KV layouts, and their plain PyTorch versions.

Replaces the TPU kernels ``paged_prefill_attention`` and
``paged_prefill_attention_fused``
(``src/repro/kernels/paged_prefill_attention.py:250`` and ``:274``,
``pallas_call`` at :213): a chunk of ``Sq`` queries at positions
``q_offset + i`` attends to K/V gathered through the block table; query
``i`` sees key ``j`` iff ``j <= q_offset + i`` and ``j < kv_len``.  The
split layout keeps two pools ``(n_pages, page_size, Hkv, hd)``; the fused
layout one pool ``(n_pages, page_size, 2*Hkv, hd)`` with K of head h at 2h
and V at 2h+1.

Bound on an H100: depends on the chunk.  The function must read the live K/V
once and does ``4 * Sq * keys * hd`` FLOPs per query head, so a 16-token
chunk over a long prefix is bound by bytes and a 256-token chunk by
operations.  The kernels (``csrc/paged_prefill_attention.cu`` and
``csrc/paged_prefill_attention_fused.cu``, one body in
``csrc/paged_prefill_kernel.cuh``) walk the keys through the block table and
stop at the last live tile (the TPU kernel's whole-tile skip), so work stays
O(prefix + chunk^2 / 2).  In bf16 they run the tensor-core body of
``csrc/prefill_wgmma.cuh``: one CTA per (sequence, kv head, 64 packed
(position, group head) rows), 64-key bf16 tiles staged once per kv head by
``cp.async``, S = Q K^T and O += P V on ``wgmma`` with P split into bf16
hi + lo halves, so the output stays within about 2^-17 sum(p |v|) / l of
the f32 product.  In f32 they run one CTA per (sequence, query head,
16-query tile) as f32 FMA on CUDA cores.  The fused kernel reads each
key's K and V as one contiguous run and otherwise computes what the split
kernel computes, bit for bit.

A sliding window (``window`` > 0: query i over keys ``q_offset + i -
window < j <= q_offset + i``) runs the kernels' ``SlidingWindow``
instantiation, a template argument of the same body and so in the
kernel's name in a trace: the walk starts at the tile of the first row's
first key, and tiles that every row sees whole skip the mask.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native
from repro_torch.kernels.ref import (
    paged_prefill_attention_fused_ref as paged_prefill_attention_fused_plain,
    paged_prefill_attention_ref as paged_prefill_attention_plain,
)

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_void_p]
_FUSED_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_void_p]


def _check(q, pools, block_tables, kv_lens, q_offset, heads_per_kv):
    """Validate a CUDA call on ``pools`` ({name: pool}, each holding
    ``heads_per_kv`` head rows per kv head); returns (B, Sq, Hq, Hkv, hd,
    page_size)."""
    dev = q.device
    B, Sq, Hq, hd = q.shape
    n_pages, ps, H, _ = next(iter(pools.values())).shape
    if H % heads_per_kv:
        raise ValueError(f"fused pool has an odd head count {H}")
    Hkv = H // heads_per_kv
    native.check_attention_dims(q.dtype, Hq, Hkv, hd, dev)
    native.check_cuda_tensor("q", q, q.dtype, 4, dev)
    for name, t in pools.items():
        native.check_cuda_tensor(name, t, q.dtype, 4, dev)
        if t.shape != (n_pages, ps, H, hd):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(n_pages, ps, H, hd)}")
    native.check_cuda_tensor("block_tables", block_tables, torch.int32, 2, dev)
    for name, t in (("kv_lens", kv_lens), ("q_offset", q_offset)):
        native.check_cuda_tensor(name, t, torch.int32, 1, dev)
        if t.shape[0] != B:
            raise ValueError(f"{name} batch {t.shape[0]} != q batch {B}")
    if block_tables.shape[0] != B:
        raise ValueError("block_tables batch != q batch")
    return B, Sq, Hq, Hkv, hd, ps


def paged_prefill_attention(q, k_pages, v_pages, block_tables, kv_lens,
                            q_offset, window=0):
    """q (B, Sq, Hq, hd); k/v_pages (n_pages, page_size, Hkv, hd);
    block_tables (B, max_pages) int32; kv_lens, q_offset (B,) int32
    -> (B, Sq, Hq, hd) in q's dtype.  ``window`` > 0: query i over keys
    ``q_offset + i - window < j <= q_offset + i`` only (the kernel's
    windowed instantiation, which skips the tiles below every row's
    window)."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pages, v_pages, block_tables,
                                             kv_lens, q_offset, window)
    B, Sq, Hq, Hkv, hd, ps = _check(
        q, {"k_pages": k_pages, "v_pages": v_pages}, block_tables, kv_lens,
        q_offset, 1)
    out = torch.empty_like(q)
    fn = native.load("paged_prefill_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(), q_offset.data_ptr(),
            out.data_ptr(), B, Sq, Hq, Hkv, hd, ps, block_tables.shape[1],
            native.DTYPE_CODES[q.dtype], int(window), 1.0 / math.sqrt(hd),
            native.stream_ptr(q.device))
    native.raise_on_error("paged_prefill_attention", rc)
    paged_prefill_attention.launches += 1
    paged_prefill_attention.windowed_launches += window > 0
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.windowed_launches = 0     # of them, the windowed ones


def paged_prefill_attention_fused(q, kv_pages, block_tables, kv_lens,
                                  q_offset, window=0):
    """q (B, Sq, Hq, hd); kv_pages (n_pages, page_size, 2*Hkv, hd) head-
    interleaved; block_tables (B, max_pages) int32; kv_lens, q_offset (B,)
    int32 -> (B, Sq, Hq, hd) in q's dtype; ``window`` as for the split
    layout."""
    if q.device.type == "cpu":
        return paged_prefill_attention_fused_plain(q, kv_pages, block_tables,
                                                   kv_lens, q_offset, window)
    B, Sq, Hq, Hkv, hd, ps = _check(q, {"kv_pages": kv_pages}, block_tables,
                                    kv_lens, q_offset, 2)
    out = torch.empty_like(q)
    fn = native.load("paged_prefill_attention_fused", _FUSED_ARGTYPES)
    rc = fn(q.data_ptr(), kv_pages.data_ptr(), block_tables.data_ptr(),
            kv_lens.data_ptr(), q_offset.data_ptr(), out.data_ptr(), B, Sq,
            Hq, Hkv, hd, ps, block_tables.shape[1],
            native.DTYPE_CODES[q.dtype], int(window), 1.0 / math.sqrt(hd),
            native.stream_ptr(q.device))
    native.raise_on_error("paged_prefill_attention_fused", rc)
    paged_prefill_attention_fused.launches += 1
    paged_prefill_attention_fused.windowed_launches += window > 0
    return out


paged_prefill_attention_fused.launches = 0
paged_prefill_attention_fused.windowed_launches = 0     # of them, the windowed ones
