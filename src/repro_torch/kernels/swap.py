"""KV page swap gather/scatter: four hand-written CUDA kernels for Hopper and
their plain PyTorch versions.

Replaces the four TPU kernels of ``src/repro/kernels/swap.py``:
``swap_gather_pages`` (``pallas_call`` at :84), ``swap_scatter_pages``
(:113), ``swap_gather_pages_q8`` (:179) and ``swap_scatter_pages_q8``
(:221).  Swap-out preemption, the partial (tail) swap-in and every
disaggregated handoff move KV between the physical page pool ``(L, n_phys,
page_size, H, hd)`` and one contiguous staging tensor ``(L, n, page_size, H,
hd)`` through them.  ``ids`` is an int32 ``(n,)`` tensor of page ids, padded
by the caller to a power-of-two bucket with the sink page: gathered sink rows
are dropped after the host copy, scattered ones land in the never-read sink.
``H`` is a runtime argument, so the kernels serve the fused pool (``2*Hkv``
heads) as well as the split one.

Bound on an H100: bytes (pure data movement, plus a few operations per
element for the INT8 pair).  The gather (``csrc/swap_gather_pages.cu``)
runs one CTA per (page, layer) moving 16-byte vectors, neighbouring threads
on neighbouring addresses.  The other three run persistent CTAs that stage
pages through a ring in shared memory by bulk asynchronous copies.  Both
scatters move each target page once, writing nothing for an id that the
next id repeats (in a run of equal ids the last one wins, as the TPU
kernel's sequential grid leaves it); the INT8 scatter's consumer warps
dequantize each staged chunk of codes with its scales into 16-byte stores.
The INT8 gather reads each input byte once, taking each head's absmax and
its codes from the same tile.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.  The scatters update ``pages`` in place and
return it: the TPU kernels aliased the donated pool, which PyTorch has no
counterpart for, and a second copy of the pool is what the aliasing avoided.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import native
from repro_torch.kernels.ref import dequantize_pages, quantize_pages

_GATHER_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_Q8_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


# -- plain versions --------------------------------------------------------------
def swap_gather_pages_plain(pages, ids):
    return pages[:, ids.long()]


def swap_scatter_pages_plain(pages, ids, staged):
    pages[:, ids.long()] = staged.to(pages.dtype)
    return pages


def swap_gather_pages_q8_plain(pages, ids):
    return quantize_pages(pages[:, ids.long()])


def swap_scatter_pages_q8_plain(pages, ids, q, scales):
    pages[:, ids.long()] = dequantize_pages(q, scales, pages.dtype)
    return pages


# -- argument checks -------------------------------------------------------------
def _check_pool(pages, ids):
    """Raise unless ``pages`` is a pool the kernels take and ``ids`` an int32
    id vector on its device; returns (L, n_phys, n, page_size, H, hd)."""
    dev = pages.device
    if pages.dtype not in native.DTYPE_CODES:
        raise ValueError(f"unsupported dtype {pages.dtype}; the kernels take "
                         f"{sorted(str(d) for d in native.DTYPE_CODES)}")
    native.check_cuda_tensor("pages", pages, None, 5, dev)
    native.check_cuda_tensor("ids", ids, torch.int32, 1, dev)
    L, n_phys, ps, H, hd = pages.shape
    if (hd * pages.element_size()) % 16:
        raise ValueError(f"head_dim {hd} x {pages.element_size()} B is not a "
                         "multiple of 16 bytes (the kernels' vectors)")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return L, n_phys, ids.shape[0], ps, H, hd


def _check_staged(name, t, dtype, shape, dev):
    native.check_cuda_tensor(name, t, dtype, 5, dev)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")


# -- kernels ---------------------------------------------------------------------
def swap_gather_pages(pages, ids):
    """``pages[:, ids]`` as a new contiguous ``(L, n, page_size, H, hd)``
    tensor."""
    if pages.device.type == "cpu":
        return swap_gather_pages_plain(pages, ids)
    L, n_phys, n, ps, H, hd = _check_pool(pages, ids)
    out = torch.empty((L, n, ps, H, hd), dtype=pages.dtype, device=pages.device)
    fn = native.load("swap_gather_pages", _GATHER_ARGS)
    rc = fn(pages.data_ptr(), ids.data_ptr(), out.data_ptr(), L, n_phys, n,
            ps * H * hd * pages.element_size(), native.stream_ptr(pages.device))
    native.raise_on_error("swap_gather_pages", rc)
    swap_gather_pages.launches += 1
    return out


def swap_scatter_pages(pages, ids, staged):
    """``pages[:, ids] = staged``, in place; returns ``pages``."""
    if pages.device.type == "cpu":
        return swap_scatter_pages_plain(pages, ids, staged)
    L, n_phys, n, ps, H, hd = _check_pool(pages, ids)
    # the TPU kernel casts too (swap.py:130); a no-op on the engine's path
    staged = staged.to(pages.dtype)
    _check_staged("staged", staged, pages.dtype, (L, n, ps, H, hd), pages.device)
    fn = native.load("swap_scatter_pages", _GATHER_ARGS)
    rc = fn(pages.data_ptr(), ids.data_ptr(), staged.data_ptr(), L, n_phys, n,
            ps * H * hd * pages.element_size(), native.stream_ptr(pages.device))
    native.raise_on_error("swap_scatter_pages", rc)
    swap_scatter_pages.launches += 1
    return pages


def swap_gather_pages_q8(pages, ids):
    """Gather ``pages[:, ids]`` and INT8-quantize it in one pass: returns
    ``(q, scales)``, int8 ``(L, n, page_size, H, hd)`` and f32 ``(L, n, 1, H,
    1)``, bit for bit ``quantize_pages(pages[:, ids])``."""
    if pages.device.type == "cpu":
        return swap_gather_pages_q8_plain(pages, ids)
    L, n_phys, n, ps, H, hd = _check_pool(pages, ids)
    q = torch.empty((L, n, ps, H, hd), dtype=torch.int8, device=pages.device)
    scales = torch.empty((L, n, 1, H, 1), dtype=torch.float32,
                         device=pages.device)
    fn = native.load("swap_gather_pages_q8", _Q8_ARGS)
    rc = fn(pages.data_ptr(), ids.data_ptr(), q.data_ptr(), scales.data_ptr(),
            L, n_phys, n, ps, H, hd, native.DTYPE_CODES[pages.dtype],
            native.stream_ptr(pages.device))
    native.raise_on_error("swap_gather_pages_q8", rc)
    swap_gather_pages_q8.launches += 1
    return q, scales


def swap_scatter_pages_q8(pages, ids, q, scales):
    """``pages[:, ids] = q * scales`` (f32 product, cast to the pool's dtype),
    in place; returns ``pages``."""
    if pages.device.type == "cpu":
        return swap_scatter_pages_q8_plain(pages, ids, q, scales)
    L, n_phys, n, ps, H, hd = _check_pool(pages, ids)
    _check_staged("q", q, torch.int8, (L, n, ps, H, hd), pages.device)
    _check_staged("scales", scales, torch.float32, (L, n, 1, H, 1), pages.device)
    fn = native.load("swap_scatter_pages_q8", _Q8_ARGS)
    rc = fn(pages.data_ptr(), ids.data_ptr(), q.data_ptr(), scales.data_ptr(),
            L, n_phys, n, ps, H, hd, native.DTYPE_CODES[pages.dtype],
            native.stream_ptr(pages.device))
    native.raise_on_error("swap_scatter_pages_q8", rc)
    swap_scatter_pages_q8.launches += 1
    return pages


swap_gather_pages.launches = 0
swap_scatter_pages.launches = 0
swap_gather_pages_q8.launches = 0
swap_scatter_pages_q8.launches = 0
