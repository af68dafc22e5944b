"""Public attention entry points the model calls: the port of the two paged
split-layout wrappers of ``repro/kernels/ops.py:60-108``.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or the call raises.  ``pages_per_tile`` and ``buffering_depth`` are
accepted for signature parity and have no effect: their TPU meaning (VMEM
tile width, DMA semaphore depth) does not carry over.
"""
from __future__ import annotations

from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention


def paged_prefill_chunk_attention(q, k_pages, v_pages, block_tables, kv_lens,
                                  q_offset, *, pages_per_tile: int = 1,
                                  buffering_depth: int = 1):
    """(B, Sq, Hq, hd) chunk vs a (n_pages, ps, Hkv, hd) physical page pool
    addressed through per-sequence block tables, with causal offset."""
    return paged_prefill_attention(q, k_pages, v_pages, block_tables, kv_lens,
                                   q_offset)


def paged_flash_decode_attention(q, k_pages, v_pages, block_tables, kv_lens, *,
                                 pages_per_tile: int = 1,
                                 buffering_depth: int = 1):
    """(B, Hq, hd) single-token decode vs a paged pool + block tables."""
    return paged_decode_attention(q, k_pages, v_pages, block_tables, kv_lens)
