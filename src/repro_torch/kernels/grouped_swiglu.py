"""The grouped SwiGLU experts of the engine round: each kept (token, choice)
row through its own expert only, ``h = silu(x Wg[e]) * (x Wu[e])`` then
``y = h Wd[e]``, with two hand-written CUDA kernels for Hopper and their
plain PyTorch versions.

Replaces no TPU kernel: the reference's MoE layers are plain ``jnp``
(``repro/models/layers.py`` ``moe_ffn``, ``moe_ffn_scatter``), whose
batched matmuls run every expert over its whole capacity buffer.  Those
batched GEMMs (``layers.expert_ffn``) read every expert's weights and
compute every capacity slot, full or empty; here only the rows a round
keeps are computed, and only the experts holding one are read.

The rows are laid out on the device, with static shapes and no host sync
(``expert_layout``): sorted by expert, stable within one, and cut into a
tile table of ``(expert, first row, rows, the expert's first tile, the
expert's tiles)`` entries of at most ``ROW_TILE`` rows of one expert, whose
length lies on the device.  ``grouped_gate_up`` gathers each tile's rows
of x by token index and writes ``h`` rounded to x's dtype (as
``fused_swiglu_plain`` rounds its hidden tile); ``grouped_down`` writes
each row's expert output.  Every product accumulates in f32.

Bound on an H100: bytes where an expert holds few rows -- the touched
experts' weights (``3 D F`` each) plus the rows: about 4.4 GB, 1.3 ms at
3.35 TB/s, for the ~21 experts a decode round of Arctic touches.  Where
experts hold hundreds of rows, each row tile reads its expert again from
L2, short of the operations bound (``6 D F`` per row); the round takes the
batched GEMMs there (``layers.moe_round``).  Design in
``csrc/grouped_expert.cuh``.

On a CPU tensor the wrappers run the plain version, tile by tile; on a
CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import native

ROW_TILE = 64                 # the kernels' most rows per tile (wgmma's N)
DIM_MULTIPLE = 8              # 16-byte rows of x, h and the weights

_GATE_UP_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DOWN_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def max_tiles(n_rows: int, n_experts: int, bn: int) -> int:
    """The tile table's length: sum over experts of ceil(rows / bn) is at
    most the experts holding a row plus floor(n_rows / bn)."""
    return min(n_experts, n_rows) + n_rows // bn


class ExpertLayout(NamedTuple):
    row: torch.Tensor       # (T, K) int64: each choice's row, where kept
    tok: torch.Tensor       # (T * K,) int32: each row's token
    # (max_tiles, 5) int32: expert, first row, rows, the expert's first
    # tile, the expert's tiles; zero rows past the entries in use
    tiles: torch.Tensor
    n_tiles: torch.Tensor   # (1,) int32: the entries in use
    counts: torch.Tensor    # (E,) int64: rows per expert


def expert_layout(expert: torch.Tensor, kept: torch.Tensor, n_experts: int,
                  bn: int = ROW_TILE) -> ExpertLayout:
    """The rows of the kept choices, sorted by expert: ``expert`` (T, K)
    each (token, choice)'s expert, ``kept`` (T, K) bool; tiles of at most
    ``bn`` rows (the kernels take ``bn <= ROW_TILE``).  Plain tensor ops of
    static shapes (a stable sort, ``searchsorted``, scatters), so the
    layout captures in a CUDA graph; a choice not kept sorts past every
    expert's rows and is in no tile."""
    T, K = expert.shape
    N = T * K
    dev = expert.device
    key = torch.where(kept, expert, n_experts).reshape(N)
    sk, perm = torch.sort(key, stable=True)
    first = torch.searchsorted(
        sk, torch.arange(n_experts + 1, dtype=sk.dtype, device=dev))
    counts = first[1:] - first[:-1]
    ar = torch.arange(N, device=dev)
    row = torch.empty_like(perm).scatter_(0, perm, ar).view(T, K)
    tok = (perm // K).int()
    per = (counts + bn - 1) // bn                      # tiles per expert
    end = per.cumsum(0)
    j = torch.arange(max_tiles(N, n_experts, bn), device=dev)
    e = torch.searchsorted(end, j, right=True)          # tile j's expert
    live = e < n_experts
    e = e.clamp(max=n_experts - 1)
    local = j - (end[e] - per[e])
    row0 = first[e] + local * bn
    n = torch.where(live, (counts[e] - local * bn).clamp(max=bn), 0)
    tiles = torch.stack([e, row0, n, end[e] - per[e], per[e]], 1)
    tiles = torch.where(live[:, None], tiles, 0).int()
    return ExpertLayout(row, tok, tiles, end[-1:].int(), counts)


def _tiles(tiles, n_tiles):
    """(expert, first row, rows) of each tile in use."""
    return tiles[: int(n_tiles[0]), :3].tolist()


def grouped_gate_up_plain(x, w_gate, w_up, tok, tiles, n_tiles):
    """What ``grouped_gate_up``'s kernel computes, tile by tile: the gate
    and up products in f32, ``silu(g) * u`` as ``g * sigmoid(g) * u`` in
    f32, rounded to x's dtype.  Rows in no tile stay zero."""
    h = x.new_zeros((tok.numel(), w_gate.shape[2]))
    for e, r0, n in _tiles(tiles, n_tiles):
        xs = x[tok[r0:r0 + n].long()].float()
        g = xs @ w_gate[e].float()
        u = xs @ w_up[e].float()
        h[r0:r0 + n] = (g * torch.sigmoid(g) * u).to(x.dtype)
    return h


def grouped_down_plain(h, w_down, tiles, n_tiles):
    """What ``grouped_down``'s kernel computes: each tile's rows of h
    through its expert's down weights in f32, rounded to h's dtype."""
    y = h.new_zeros((h.shape[0], w_down.shape[2]))
    for e, r0, n in _tiles(tiles, n_tiles):
        y[r0:r0 + n] = (h[r0:r0 + n].float() @ w_down[e].float()).to(h.dtype)
    return y


def _check(x, weights, lay_tensors, dev):
    """The kernels take bf16 operands and int32 layouts, contiguous, on
    ``dev``."""
    native.check_cuda_tensor("x", x, torch.bfloat16, 2, dev)
    for name, w in weights:
        native.check_cuda_tensor(name, w, torch.bfloat16, 3, dev)
    for name, t, ndim in lay_tensors:
        native.check_cuda_tensor(name, t, torch.int32, ndim, dev)


def grouped_gate_up(x, w_gate, w_up, tok, tiles, n_tiles):
    """x (n_tokens, D); w_gate, w_up (E, D, F); the layout's ``tok``,
    ``tiles`` and ``n_tiles`` -> h (n_rows, F) in x's dtype, each row in a
    tile ``silu(x[tok] Wg[e]) * (x[tok] Wu[e])``; other rows undefined on
    the card."""
    if x.device.type == "cpu":
        return grouped_gate_up_plain(x, w_gate, w_up, tok, tiles, n_tiles)
    dev = x.device
    _check(x, (("w_gate", w_gate), ("w_up", w_up)),
           (("tok", tok, 1), ("tiles", tiles, 2), ("n_tiles", n_tiles, 1)),
           dev)
    E, D, F = w_gate.shape
    if (x.shape[1] != D or w_up.shape != w_gate.shape
            or tiles.shape[1] != 5 or D % DIM_MULTIPLE or F % DIM_MULTIPLE):
        raise ValueError(f"x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)}, tiles "
                         f"{tuple(tiles.shape)}")
    R = tok.numel()
    h = torch.empty((R, F), dtype=x.dtype, device=dev)
    fn = native.load("grouped_gate_up", _GATE_UP_ARGTYPES)
    rc = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), tok.data_ptr(),
            tiles.data_ptr(), n_tiles.data_ptr(), h.data_ptr(), x.shape[0], R,
            D, F, E, tiles.shape[0], native.stream_ptr(dev))
    native.raise_on_error("grouped_gate_up", rc)
    grouped_gate_up.launches += 1
    return h


def grouped_down(h, w_down, tiles, n_tiles):
    """h (n_rows, F); w_down (E, F, D); the layout's ``tiles`` and
    ``n_tiles`` -> y (n_rows, D), each row in a tile ``h Wd[e]``; other
    rows undefined on the card."""
    if h.device.type == "cpu":
        return grouped_down_plain(h, w_down, tiles, n_tiles)
    dev = h.device
    _check(h, (("w_down", w_down),),
           (("tiles", tiles, 2), ("n_tiles", n_tiles, 1)), dev)
    E, F, D = w_down.shape
    if (h.shape[1] != F or tiles.shape[1] != 5 or D % DIM_MULTIPLE
            or F % DIM_MULTIPLE):
        raise ValueError(f"h {tuple(h.shape)}, w_down {tuple(w_down.shape)}, "
                         f"tiles {tuple(tiles.shape)}")
    R = h.shape[0]
    y = torch.empty((R, D), dtype=h.dtype, device=dev)
    fn = native.load("grouped_down", _DOWN_ARGTYPES)
    rc = fn(h.data_ptr(), w_down.data_ptr(), tiles.data_ptr(),
            n_tiles.data_ptr(), y.data_ptr(), R, D, F, E, tiles.shape[0],
            native.stream_ptr(dev))
    native.raise_on_error("grouped_down", rc)
    grouped_down.launches += 1
    return y


grouped_gate_up.launches = 0
grouped_down.launches = 0
