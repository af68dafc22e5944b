"""Paged chunked-prefill attention: a hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Replaces the TPU kernel ``paged_prefill_attention``
(``src/repro/kernels/paged_prefill_attention.py``, ``pallas_call`` at :213):
a chunk of ``Sq`` queries at positions ``q_offset + i`` attends to K/V
gathered through the block table; query ``i`` sees key ``j`` iff
``j <= q_offset + i`` and ``j < kv_len``.

Bound on an H100: depends on the chunk.  The function must read the live K/V
once and does ``4 * Sq * keys * hd`` FLOPs per query head, so a 16-token
chunk over a long prefix is bound by bytes and a 256-token chunk by
operations.  The kernel (``csrc/paged_prefill_attention.cu``) runs one CTA
per (sequence, query head, 16-query tile), walks the keys 32 at a time
through the block table and stops at the last live tile (the TPU kernel's
whole-tile skip), so work stays O(prefix + chunk^2 / 2); its products are f32
FMA on CUDA cores, which leaves it well above the operations bound at large
chunks.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native
from repro_torch.kernels.ref import (
    paged_prefill_attention_ref as paged_prefill_attention_plain,
)

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


def paged_prefill_attention(q, k_pages, v_pages, block_tables, kv_lens,
                            q_offset):
    """q (B, Sq, Hq, hd); k/v_pages (n_pages, page_size, Hkv, hd);
    block_tables (B, max_pages) int32; kv_lens, q_offset (B,) int32
    -> (B, Sq, Hq, hd) in q's dtype."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pages, v_pages, block_tables,
                                             kv_lens, q_offset)
    dev = q.device
    B, Sq, Hq, hd = q.shape
    n_pages, ps, Hkv, _ = k_pages.shape
    native.check_attention_dims(q.dtype, Hq, Hkv, hd, dev)
    native.check_cuda_tensor("q", q, q.dtype, 4, dev)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        native.check_cuda_tensor(name, t, q.dtype, 4, dev)
        if t.shape != (n_pages, ps, Hkv, hd):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(n_pages, ps, Hkv, hd)}")
    native.check_cuda_tensor("block_tables", block_tables, torch.int32, 2, dev)
    for name, t in (("kv_lens", kv_lens), ("q_offset", q_offset)):
        native.check_cuda_tensor(name, t, torch.int32, 1, dev)
        if t.shape[0] != B:
            raise ValueError(f"{name} batch {t.shape[0]} != q batch {B}")
    if block_tables.shape[0] != B:
        raise ValueError("block_tables batch != q batch")
    out = torch.empty_like(q)
    fn = native.load("paged_prefill_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(), q_offset.data_ptr(),
            out.data_ptr(), B, Sq, Hq, Hkv, hd, ps, block_tables.shape[1],
            native.DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd),
            native.stream_ptr(dev))
    native.raise_on_error("paged_prefill_attention", rc)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
