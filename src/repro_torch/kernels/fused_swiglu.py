"""Fused SwiGLU feed-forward, ``(silu(x @ Wg) * (x @ Wu)) @ Wd``: a
hand-written CUDA kernel for Hopper and its plain PyTorch version.

Replaces the TPU kernel ``fused_swiglu`` (``src/repro/kernels/fused_swiglu.py:66``,
``pallas_call`` at :85): x ``(M, D)``, Wg and Wu ``(D, F)``, Wd ``(F, D)``;
every product accumulates in f32 and the hidden tile is rounded to
``x.dtype`` before the down product.  ``fused_swiglu_plain`` computes
exactly that; ``fused_swiglu_ref`` (the jnp oracle's port) keeps the hidden
activations f32.  No model path calls it (``layers.ffn`` is plain, as the
reference's is); a user calls ``fused_swiglu`` here.

Bound on an H100: operations at model widths -- ``6 * M * D * F`` FLOPs
against ``6 * D * F`` weight bytes in bf16 -- and bytes at small M.  In
bf16 the kernel (``csrc/fused_swiglu.cu``) is two GEMMs on the tensor cores
(wgmma fed by TMA through a four-stage shared-memory ring): the first
writes the rounded hidden activations ``H = silu(x @ Wg) * (x @ Wu)``
``(M, F)`` from its epilogue into bf16 scratch, the second computes ``H @
Wd``.  In f32 it splits F over blocks, each writing an ``(M, D)`` f32
partial from f32 FMA on CUDA cores, and sums the ``ceil(F / 128)`` partials
in a fixed order.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import native
from repro_torch.kernels.ref import fused_swiglu_plain

F_MULTIPLE = 8                # 16-byte rows of Wg, Wu and H: TMA strides
D_MULTIPLE = {torch.bfloat16: 8,          # 16-byte rows of x and Wd
              torch.float32: 128}         # the f32 kernel's 128-column passes
F32_HIDDEN_PER_BLOCK = 128    # f32: one (M, D) f32 partial per 128 hidden columns

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
    if D % D_MULTIPLE[x.dtype] or F % F_MULTIPLE:
        raise ValueError(f"D={D} must be a multiple of {D_MULTIPLE[x.dtype]} "
                         f"and F={F} of {F_MULTIPLE} in {x.dtype}")
    if x.dtype == torch.bfloat16:
        scratch = torch.empty((M, F), dtype=x.dtype, device=dev)   # H
    else:
        scratch = torch.empty((-(-F // F32_HIDDEN_PER_BLOCK), M, D),
                              dtype=torch.float32, device=dev)     # partials
    out = torch.empty_like(x)
    fn = native.load("fused_swiglu", _ARGTYPES)
    rc = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), scratch.data_ptr(), out.data_ptr(), M, D, F,
            native.DTYPE_CODES[x.dtype], native.stream_ptr(dev))
    native.raise_on_error("fused_swiglu", rc)
    fused_swiglu.launches += 1
    return out


fused_swiglu.launches = 0
