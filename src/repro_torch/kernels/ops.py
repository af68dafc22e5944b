"""Public kernel entry points the model and the engine call: the port of
``repro/kernels/ops.py:38-169`` -- dense chunked-prefill and flash-decode
attention, the paged attention wrappers (split and fused KV layouts), the
fused SwiGLU and the four swap wrappers.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or the call raises.  ``block_q``, ``block_k``, ``block_m``,
``block_f``, ``pages_per_tile`` and ``buffering_depth`` are accepted for
signature parity and have no effect: their TPU meaning (VMEM tile sizes, DMA
semaphore depth) does not carry over.
"""
from __future__ import annotations

from repro_torch.kernels.chunked_prefill_attention import (
    chunked_prefill_attention,
)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.fused_swiglu import fused_swiglu
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_fused,
)
from repro_torch.kernels.paged_prefill_attention import (
    paged_prefill_attention, paged_prefill_attention_fused,
)
from repro_torch.kernels.swap import (
    swap_gather_pages, swap_gather_pages_q8, swap_scatter_pages,
    swap_scatter_pages_q8,
)


def prefill_chunk_attention(q, k_cache, v_cache, kv_lens, q_offset, *,
                            block_q: int = 128, block_k: int = 128):
    """(B, Sq, Hq, hd) chunk vs a (B, Skv, Hkv, hd) dense cache with causal
    offset; the cache may be a strided view (read in place)."""
    return chunked_prefill_attention(q, k_cache, v_cache, kv_lens, q_offset)


def flash_decode_attention(q, k_cache, v_cache, kv_lens, *,
                           block_k: int = 256):
    """(B, Hq, hd) single-token decode vs a (B, S, Hkv, hd) dense cache."""
    return decode_attention(q, k_cache, v_cache, kv_lens)


def paged_prefill_chunk_attention(q, k_pages, v_pages, block_tables, kv_lens,
                                  q_offset, *, pages_per_tile: int = 1,
                                  buffering_depth: int = 1, window: int = 0):
    """(B, Sq, Hq, hd) chunk vs a (n_pages, ps, Hkv, hd) physical page pool
    addressed through per-sequence block tables, with causal offset; each
    query over its last ``window`` positions only where ``window`` > 0."""
    return paged_prefill_attention(q, k_pages, v_pages, block_tables, kv_lens,
                                   q_offset, window)


def paged_prefill_chunk_attention_fused(q, kv_pages, block_tables, kv_lens,
                                        q_offset, *, pages_per_tile: int = 1,
                                        buffering_depth: int = 1,
                                        window: int = 0):
    """``paged_prefill_chunk_attention`` over a fused head-interleaved pool
    ``(n_pages, ps, 2*Hkv, hd)``: each key's K and V are read as one
    contiguous run."""
    return paged_prefill_attention_fused(q, kv_pages, block_tables, kv_lens,
                                         q_offset, window)


def paged_flash_decode_attention(q, k_pages, v_pages, block_tables, kv_lens, *,
                                 pages_per_tile: int = 1,
                                 buffering_depth: int = 1, window: int = 0):
    """(B, Hq, hd) single-token decode vs a paged pool + block tables; over
    the last ``window`` keys only where ``window`` > 0."""
    return paged_decode_attention(q, k_pages, v_pages, block_tables, kv_lens,
                                  window)


def paged_flash_decode_attention_fused(q, kv_pages, block_tables, kv_lens, *,
                                       pages_per_tile: int = 1,
                                       buffering_depth: int = 1,
                                       window: int = 0):
    """``paged_flash_decode_attention`` over a fused head-interleaved pool."""
    return paged_decode_attention_fused(q, kv_pages, block_tables, kv_lens,
                                        window)


def swiglu_ffn(x, w_gate, w_up, w_down, *, block_m: int = 256,
               block_f: int = 256):
    """(M, D) x (D, F) SwiGLU, ``(silu(x @ Wg) * (x @ Wu)) @ Wd``, the hidden
    activations rounded to x's dtype before the down product."""
    return fused_swiglu(x, w_gate, w_up, w_down)


def gather_swap_pages(pages, ids):
    """Collect scattered physical pages ``pages[:, ids]`` into one contiguous
    staging tensor (swap-out: the engine host-copies the result as one dense
    copy)."""
    return swap_gather_pages(pages, ids)


def scatter_swap_pages(pages, ids, staged):
    """Write a staging tensor back into freshly allocated physical pages
    (swap-in restore; ``pages`` is updated in place)."""
    return swap_scatter_pages(pages, ids, staged)


def gather_swap_pages_q8(pages, ids):
    """Gather + INT8-quantize staging pages in one fused pass (host tier with
    ``host_kv_dtype="int8"``): returns ``(q, scales)``."""
    return swap_gather_pages_q8(pages, ids)


def scatter_swap_pages_q8(pages, ids, q_staged, scales):
    """Dequantize + scatter INT8 staging pages back into physical pages
    (``pages`` updated in place)."""
    return swap_scatter_pages_q8(pages, ids, q_staged, scales)
