"""Fused SwiGLU feed-forward, ``(silu(x @ Wg) * (x @ Wu)) @ Wd``: a
hand-written CUDA kernel for Hopper and its plain PyTorch version.

Replaces the TPU kernel ``fused_swiglu`` (``src/repro/kernels/fused_swiglu.py:66``,
``pallas_call`` at :85): x ``(M, D)``, Wg and Wu ``(D, F)``, Wd ``(F, D)``;
every product accumulates in f32 and the hidden tile is rounded to
``x.dtype`` before the down product.  ``fused_swiglu_plain`` computes
exactly that; ``fused_swiglu_ref`` (the jnp oracle's port) keeps the hidden
activations f32.  No model path calls it (``layers.ffn`` is plain, as the
reference's is); ``ops.swiglu_ffn`` exposes it.

Bound on an H100: operations at model widths -- ``6 * M * D * F`` FLOPs
against ``6 * D * F`` weight bytes in bf16.  The kernel
(``csrc/fused_swiglu.cu``) splits F over blocks: each block keeps a (32, 128)
hidden tile in shared memory, multiplies it into a (32, D) f32 partial, and a
second kernel sums the ``ceil(F / 128)`` partials in a fixed order; its
products are bf16 wmma fragments with f32 accumulators in bf16 and f32 FMA
on CUDA cores in f32.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import native
from repro_torch.kernels.ref import fused_swiglu_plain

HIDDEN_PER_BLOCK = 128   # kBF: one f32 partial (M, D) per 128 hidden columns
D_MULTIPLE = 128         # kBN: D is walked 128 output columns at a time
F_MULTIPLE = 8           # one 16-byte vector of bf16

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fused_swiglu(x, w_gate, w_up, w_down):
    """x (M, D); w_gate, w_up (D, F); w_down (F, D), one dtype -> (M, D) in
    x's dtype."""
    if x.device.type == "cpu":
        return fused_swiglu_plain(x, w_gate, w_up, w_down)
    dev = x.device
    if x.dtype not in native.DTYPE_CODES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    M, D = x.shape
    F = w_gate.shape[1]
    for name, t, shape in (("x", x, (M, D)), ("w_gate", w_gate, (D, F)),
                           ("w_up", w_up, (D, F)), ("w_down", w_down, (F, D))):
        native.check_cuda_tensor(name, t, x.dtype, 2, dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if D % D_MULTIPLE or F % F_MULTIPLE:
        raise ValueError(f"D={D} must be a multiple of {D_MULTIPLE} and "
                         f"F={F} of {F_MULTIPLE}")
    n_parts = -(-F // HIDDEN_PER_BLOCK)
    partial = torch.empty((n_parts, M, D), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    fn = native.load("fused_swiglu", _ARGTYPES)
    rc = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), partial.data_ptr(), out.data_ptr(), M, D, F,
            native.DTYPE_CODES[x.dtype], native.stream_ptr(dev))
    native.raise_on_error("fused_swiglu", rc)
    fused_swiglu.launches += 1
    return out


fused_swiglu.launches = 0
