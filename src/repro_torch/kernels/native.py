"""Build, load and call the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface and loaded with ``ctypes``:
pointers and the stream go over as ``c_void_p``, sizes as ``c_int``.  The
build happens at first use, into ``kernels/build/`` (listed in
``.gitignore``), one ``nvcc`` process per source, all started together.  Each
library's file name carries a hash of its sources and flags, so a changed
kernel rebuilds and an unchanged one loads at once.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("paged_decode_attention", "paged_prefill_attention",
           "paged_decode_attention_fused", "paged_prefill_attention_fused",
           "swap_gather_pages", "swap_scatter_pages",
           "swap_gather_pages_q8", "swap_scatter_pages_q8",
           "chunked_prefill_attention", "decode_attention", "fused_swiglu",
           "grouped_gate_up", "grouped_down")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
# keys per split of the decode kernels: kSplitKeys in csrc/decode_splitk.cuh
# (their C entry points refuse a split count made with another value)
DECODE_SPLIT_KEYS = 512

_fns: Dict[str, ctypes._CFuncPtr] = {}
# the decode kernels' merge tickets, one zeroed int32 buffer per (device,
# stream): every launch leaves the tickets it drew at 0
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}
# ptxas report (registers, shared memory, spills) of each kernel built by
# this process, for chip_smoke.py to print
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "port's CUDA kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel whose library is missing, all sources in
    parallel; returns the wall seconds spent.  Raises with nvcc's output if
    any compile fails."""
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in KERNELS if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log = proc.communicate()[0]
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)     # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<name>.cu``, built if needed."""
    fn = _fns.get(name)
    if fn is None:
        build_all()
        fn = getattr(ctypes.CDLL(str(library_path(name))), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: Optional[torch.dtype],
                      ndim: int, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given rank and
    dtype on ``device``, with a 16-byte aligned base (the kernels' vector
    loads)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                   dtype: torch.dtype, batch: int, hd: int,
                   device: torch.device) -> Tuple[int, int]:
    """Raise unless ``k_cache`` and ``v_cache`` are dense caches ``(batch, S,
    Hkv, hd)`` of ``dtype`` on ``device`` that the dense attention kernels
    can read in place: each key's ``(Hkv, hd)`` row contiguous, the same
    strides in both, every stride and base 16-byte aligned.  The batch and
    key strides may be anything else -- the engine passes ``cache[:, :-1]``,
    a view that drops each slot's sink row, and no copy is made.  Returns
    (batch stride, key stride) in elements."""
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.dim() != 4 or t.shape[0] != batch or t.shape[3] != hd:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"({batch}, S, Hkv, {hd})")
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError(f"{name}: each key's (Hkv, hd) row must be "
                             "contiguous")
        esz = t.element_size()
        if t.data_ptr() % 16 or any(s * esz % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name}: base and strides must be 16-byte "
                             "aligned")
    if k_cache.shape != v_cache.shape or k_cache.stride() != v_cache.stride():
        raise ValueError(f"k_cache {tuple(k_cache.shape)} {k_cache.stride()} "
                         f"and v_cache {tuple(v_cache.shape)} "
                         f"{v_cache.stride()} differ")
    return k_cache.stride(0), k_cache.stride(1)


def check_attention_dims(dtype: torch.dtype, n_q_heads: int, n_kv_heads: int,
                         hd: int, device: torch.device) -> None:
    if dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {dtype}; the kernels take "
                         f"{sorted(str(d) for d in DTYPE_CODES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if n_kv_heads <= 0 or n_q_heads % n_kv_heads:
        raise ValueError(f"Hq={n_q_heads} is not a multiple of Hkv={n_kv_heads}")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def decode_buffers(q: torch.Tensor, capacity: int, stream: int):
    """(scratch, tickets, n_splits) of one split-K decode launch of q ``(B,
    Hq, hd)`` on ``stream`` over caches of ``capacity`` keys per sequence:
    ``capacity`` is cut into ``n_splits`` splits of ``DECODE_SPLIT_KEYS``;
    the f32 scratch holds each split's partial (acc, m, l) per query head,
    and the tickets are the stream's zeroed int32 buffer, one per (sequence,
    query head) at least.  With one split the kernel stores directly and
    gets neither."""
    B, Hq, hd = q.shape
    n_splits = max(1, -(-capacity // DECODE_SPLIT_KEYS))
    if n_splits == 1:
        return None, None, 1
    scratch = torch.empty(B * Hq * n_splits * (hd + 2), dtype=torch.float32,
                          device=q.device)
    return scratch, tickets(q.device, stream, B * Hq), n_splits


def data_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """``t``'s device address, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The zeroed int32 ticket buffer of ``stream`` on ``device``, of at
    least ``n`` elements (grown, zeroed anew, when a launch needs more).
    Allocate it before capturing a CUDA graph: a capture must not allocate
    it."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    key = (index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {rc}")
