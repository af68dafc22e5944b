"""Chunked-prefill attention over a dense per-sequence KV cache: a
hand-written CUDA kernel for Hopper and its plain PyTorch version.

Replaces the TPU kernel ``chunked_prefill_attention``
(``src/repro/kernels/chunked_prefill_attention.py:109``, ``pallas_call`` at
:144): a chunk of ``Sq`` queries at positions ``q_offset + i`` attends to the
cache ``(B, Skv, Hkv, hd)``; query ``i`` sees key ``j`` iff ``j <= q_offset +
i`` and ``j < kv_len``.  It is the dense engine layout's attention
(``TransformerLM.chunked_step``): every round runs it once per layer, at
every chunk bucket, C = 1 included.

Bound on an H100: depends on the chunk, as for the paged prefill kernel --
bytes for a short chunk against a long prefix, operations for a long chunk.
The kernel (``csrc/chunked_prefill_attention.cu``) is the paged prefill
kernel with another key lookup: in bf16 the tensor-core body of
``csrc/prefill_wgmma.cuh`` -- one CTA per (sequence, kv head, 64 packed
(position, group head) rows), K/V staged once per kv head in bf16 by
``cp.async``, both products on ``wgmma`` with P split into bf16 hi + lo
halves -- and in f32 the CUDA-core body (16 query rows per CTA, f32 FMA).
Both stop at the last live key tile.  It reads the cache through its
strides, so the engine's ``cache[:, :-1]`` view (the sink row dropped) goes
in without a copy, and on the same keys laid into pages it returns the
paged kernel's output bit for bit.

On a CPU tensor the wrapper runs the plain version, and on a meta tensor
too (the dry-run's shape-only pass counts it, as the reference's dry-run
counts its ``jnp`` path); on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native
from repro_torch.kernels.ref import (
    chunked_prefill_attention_ref as chunked_prefill_attention_plain,
)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def chunked_prefill_attention(q, k_cache, v_cache, kv_lens, q_offset):
    """q (B, Sq, Hq, hd); k/v_cache (B, Skv, Hkv, hd), rows contiguous, any
    batch and key strides; kv_lens and q_offset (B,) int32 -> (B, Sq, Hq, hd)
    in q's dtype."""
    if q.device.type in ("cpu", "meta"):
        return chunked_prefill_attention_plain(q, k_cache, v_cache, kv_lens,
                                               q_offset)
    dev = q.device
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k_cache.shape[1], k_cache.shape[2]
    native.check_attention_dims(q.dtype, Hq, Hkv, hd, dev)
    native.check_cuda_tensor("q", q, q.dtype, 4, dev)
    batch_stride, row_stride = native.check_kv_cache(k_cache, v_cache,
                                                     q.dtype, B, hd, dev)
    native.check_cuda_tensor("kv_lens", kv_lens, torch.int32, 1, dev)
    native.check_cuda_tensor("q_offset", q_offset, torch.int32, 1, dev)
    if kv_lens.shape[0] != B or q_offset.shape[0] != B:
        raise ValueError("kv_lens / q_offset batch != q batch")
    out = torch.empty_like(q)
    fn = native.load("chunked_prefill_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_lens.data_ptr(), q_offset.data_ptr(), out.data_ptr(),
            B, Sq, Skv, Hq, Hkv, hd, batch_stride, row_stride,
            native.DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd),
            native.stream_ptr(dev))
    native.raise_on_error("chunked_prefill_attention", rc)
    chunked_prefill_attention.launches += 1
    return out


chunked_prefill_attention.launches = 0
