"""Flash-decode attention over a dense per-sequence KV cache: a hand-written
CUDA kernel for Hopper and its plain PyTorch version.

Replaces the TPU kernel ``decode_attention``
(``src/repro/kernels/decode_attention.py:88``, ``pallas_call`` at :115): one
query token per sequence, q ``(B, Hq, hd)``, against the cache ``(B, S, Hkv,
hd)``; keys at positions ``>= kv_len`` are masked.  No model path calls it
(the dense engine's decode rounds run ``chunked_prefill_attention`` with one
query, as the reference's do); a user calls ``decode_attention`` here.

Bound on an H100: bytes at small groups -- each sequence's live K and V
read once per kv head, ``group`` FLOPs per bf16 byte.  The kernel
(``csrc/decode_attention.cu``) runs the paged decode kernels' split-K body
(``csrc/decode_splitk.cuh``) with a dense key-to-row function: the keys cut
into splits of ``native.DECODE_SPLIT_KEYS`` over CTAs (B = 4 over a 32k
cache fills the card), up to 16 query heads of a kv head in one CTA (any
group: a larger one in several row blocks), the splits merged in the same launch in a fixed order through the
wrapper's scratch and the stream's ticket buffer.  On the same keys laid
into pages it returns the paged kernel's output bit for bit.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native
from repro_torch.kernels.ref import (
    decode_attention_ref as decode_attention_plain,
)

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
    ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [
    ctypes.c_float, ctypes.c_void_p]


def decode_attention(q, k_cache, v_cache, kv_lens):
    """q (B, Hq, hd); k/v_cache (B, S, Hkv, hd), rows contiguous, any batch
    and key strides; kv_lens (B,) int32 -> (B, Hq, hd) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_lens)
    dev = q.device
    B, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    native.check_attention_dims(q.dtype, Hq, Hkv, hd, dev)
    native.check_cuda_tensor("q", q, q.dtype, 3, dev)
    batch_stride, row_stride = native.check_kv_cache(k_cache, v_cache,
                                                     q.dtype, B, hd, dev)
    native.check_cuda_tensor("kv_lens", kv_lens, torch.int32, 1, dev)
    if kv_lens.shape[0] != B:
        raise ValueError("kv_lens batch != q batch")
    out = torch.empty_like(q)
    stream = native.stream_ptr(dev)
    part, tickets, n_splits = native.decode_buffers(q, S, stream)
    fn = native.load("decode_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), native.data_ptr(part),
            native.data_ptr(tickets), B, S, Hq, Hkv, hd, batch_stride,
            row_stride, n_splits,
            native.DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd), stream)
    native.raise_on_error("decode_attention", rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
