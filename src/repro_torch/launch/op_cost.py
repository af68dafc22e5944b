"""Trip-count-aware cost counting of PyTorch calls: the port's counterpart
of ``repro/launch/hlo_cost.py``.

There is no HLO to parse here.  ``OpCounter`` is a ``TorchDispatchMode``
that sees every aten op a call dispatches -- forward, autograd's backward
and ``torch.utils.checkpoint``'s recompute -- on any device, the meta
device included, and charges it, as ``hlo_cost`` charges an HLO op:

  * flops            -- the matmul family (``mm``, ``bmm``, ``addmm``,
                        ``baddbmm``, convolutions, attention; einsum lowers
                        to them) exactly as 2*M*N*K by
                        ``torch.utils.flop_counter``'s formulas;
                        elementwise ops one per output element
                        (transcendentals four); a reduction one per input
                        element; a sort n*log2(n)
  * hbm_bytes        -- every op's operand and result bytes; an op whose
                        result only aliases an operand (views, ``expand``,
                        ``detach``, ``_unsafe_view``, ...) is free, as
                        ``bitcast`` and ``get-tuple-element`` are, and so is
                        a 0-d result with no tensor operand (a constant)
  * collective bytes -- ``torch.distributed`` collectives by ``hlo_cost``'s
                        link-traffic convention (all-gather: result bytes;
                        all-reduce: 2 x operand bytes; the others: operand
                        bytes).  A one-process dry-run sees none.

Trip counts.  The port steps its recurrent scans and microbatches in
Python, one op per step, where JAX lowers a ``while`` loop whose body
``hlo_cost`` multiplies by its trip count.  ``trip_range(*range_args,
device=...)`` is that loop here: on the meta device under a counter it runs
three iterations of a loop of n > 3 -- the first, one standing for the
n - 2 middle ones, and the last -- charges the middle one n - 2 times, and
``trip_fill`` repeats the per-step outputs back to n items; anywhere else
(``cpu``, ``cuda``, or meta with no counter) it is exactly ``range``.  The
backward of the middle iteration is charged n - 2 times too: each autograd
node's multiplier is looked up by its sequence number, which grows as
nodes are created, against the marks the scopes leave.  What the unrolled
loop does in its backward besides -- summing the gradients that n
iterations send to one tensor -- is rebuilt by ``_Edge``: each tensor that
needs a gradient and enters an iteration from outside it goes in through
a boundary node that adds the missing sums.  Recompute runs at the
multiplier of its ``checkpoint`` call (use this module's ``checkpoint``).
tests/test_torch_dryrun.py holds the scaled count equal to the unrolled one,
op by op, forward and backward, for every loop that uses the helper.
"""
from __future__ import annotations

import bisect
import math
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import checkpoint as _torch_checkpoint
from torch.utils.flop_counter import flop_registry
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_leaves

from repro_torch.tree import tree_map

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# aten / c10d op names -> hlo_cost's collective kinds
_COLLECTIVE_OPS = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
        "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

# no data moves: aliases, allocation without a write, metadata, a host read
_FREE_OPS = {
    "detach", "alias", "_unsafe_view", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "set_",
    "resize_", "record_stream", "_reshape_alias", "is_same_size",
}

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "rsqrt", "sqrt", "pow", "sin", "cos", "erf", "erfinv",
    "atan2", "div", "reciprocal", "silu", "gelu", "softplus",
    "log_sigmoid_forward", "_softmax", "_log_softmax", "logsumexp",
}

_ELEMENTWISE = {
    "add", "sub", "mul", "div", "neg", "abs", "maximum", "minimum", "clamp",
    "clamp_min", "clamp_max", "where", "masked_fill", "eq", "ne", "lt",
    "le", "gt", "ge", "logical_and", "logical_or", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_not", "floor", "ceil", "round",
    "sign", "remainder", "fmod", "isfinite", "isnan", "isinf", "square",
    "rsub", "lerp", "addcmul", "addcdiv", "floor_divide",
    "softplus_backward", "log_sigmoid_backward", "_softmax_backward_data",
    "_log_softmax_backward_data",
} | _TRANSCENDENTAL

_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "argmax", "argmin", "any", "all", "norm", "linalg_vector_norm", "var",
    "std", "var_mean", "cumsum", "cumprod", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data",
    "embedding_dense_backward", "index_add", "scatter_add",
}

_SORTS = {"sort", "topk", "argsort"}

# data movement: bytes, no flops
_MOVEMENT = {
    "_to_copy", "copy", "clone", "cat", "stack", "index", "gather",
    "scatter", "index_select", "index_put", "index_copy", "embedding",
    "select_backward", "slice_backward", "constant_pad_nd", "repeat",
    "flip", "roll", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_zeros", "new_ones", "new_full", "scalar_tensor",
    "arange", "fill", "zero", "tril", "triu", "expand_copy", "_unsafe_index",
    "narrow_copy", "split_with_sizes_copy", "masked_select", "nonzero",
    "randn", "rand", "normal", "uniform", "bernoulli", "randint",
    "_to_dense", "contiguous",
}


@dataclass
class CostReport:
    """Global counts of one call (``hlo_cost.CostReport``'s fields; there a
    per-device program, here one process's).  ``by_op`` maps an aten op
    name (in-place variants under their out-of-place name) to its charged
    [flops, bytes, calls]; ``n_while_loops`` counts the trip scopes."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: {c: 0.0 for c in _COLLECTIVES})
    n_collective_ops: int = 0
    n_while_loops: int = 0
    unknown_ops: Dict[str, int] = field(default_factory=dict)
    by_op: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def merge_scaled(self, other: "CostReport", k: float) -> None:
        self.flops += k * other.flops
        self.hbm_bytes += k * other.hbm_bytes
        for c in _COLLECTIVES:
            self.collective_bytes[c] += k * other.collective_bytes[c]
        self.n_collective_ops += int(k * other.n_collective_ops)
        self.n_while_loops += other.n_while_loops
        for o, n in other.unknown_ops.items():
            self.unknown_ops[o] = self.unknown_ops.get(o, 0) + n
        for o, v in other.by_op.items():
            mine = self.by_op.setdefault(o, [0.0, 0.0, 0.0])
            for i in range(3):
                mine[i] += k * v[i]

    def add_op(self, name: str, flops: float, nbytes: float, k: float):
        self.flops += k * flops
        self.hbm_bytes += k * nbytes
        v = self.by_op.setdefault(name, [0.0, 0.0, 0.0])
        v[0] += k * flops
        v[1] += k * nbytes
        v[2] += k


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Scope:
    """One active ``trip_range`` loop: its base multiplier, the current
    iteration's index and multiplier, and which iteration produced each
    tensor made inside it (for the boundary nodes)."""

    def __init__(self, base: float, n: int, independent: bool = False):
        self.base = base
        self.mults = (n,) if independent else (1, n - 2, 1)
        self.it = 0
        self.produced: Dict[int, Tuple[weakref.ref, int]] = {}
        self.edges: Dict[int, torch.Tensor] = {}
        self.per_item: set = set()

    def made_at(self, t) -> Optional[int]:
        hit = self.produced.get(id(t))
        if hit is not None and hit[0]() is t:
            return hit[1]
        return None


class _Edge(torch.autograd.Function):
    """The boundary a tensor crosses into one scaled iteration.  Forward:
    an alias.  Backward: the gradient as it is, plus ``extra`` charged sums
    of it -- the adds the unrolled loop makes where the iterations this one
    stands for each send a gradient to the same tensor."""

    @staticmethod
    def forward(ctx, t, counter, extra):
        ctx.counter, ctx.extra = counter, extra
        ctx.set_materialize_grads(False)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if grad is not None and ctx.extra:
            ctx.counter._charge("add", grad.numel(), 3 * _nbytes(grad),
                                ctx.extra)
        return grad, None, None


class OpCounter:
    """``with OpCounter() as c: fn(...)`` -> ``c.report``, the global
    counts of everything ``fn`` dispatched, trip scopes multiplied
    through.  ``trips=False`` runs every loop in full (the unrolled count
    the scaled one is held against)."""

    def __init__(self, trips: bool = True):
        self.trips = trips
        self.report = CostReport()
        self.mult = 1.0
        self._seqs: List[int] = [-1]
        self._mults: List[float] = [1.0]
        self._recompute = 0
        self._scopes: List[_Scope] = []
        self._stand_in: Dict[int, Tuple[weakref.ref, torch.Tensor]] = {}
        self._modes = (_CountMode(self), _TrackMode(self))

    def __enter__(self):
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)

    # -- multipliers ---------------------------------------------------------

    @staticmethod
    def _in_backward() -> bool:
        return torch._C._current_autograd_node() is not None

    def _set_mult(self, m: float) -> None:
        """Set the forward multiplier; nodes created from here on carry it
        (the autograd sequence number is the next node's)."""
        self.mult = m
        if torch.is_grad_enabled() and not self._in_backward():
            self._seqs.append(torch._C._autograd._get_sequence_nr())
            self._mults.append(m)

    def _op_mult(self) -> float:
        if not self._recompute:
            node = torch._C._current_autograd_node()
            if node is not None:
                i = bisect.bisect_right(self._seqs, node._sequence_nr()) - 1
                return self._mults[i]
        return self.mult

    def _charge(self, name, flops, nbytes, k=1.0) -> None:
        self.report.add_op(name, flops, nbytes, k * self._op_mult())

    # -- trip scopes ---------------------------------------------------------

    def _iterate(self, r: range, items=None, independent: bool = False):
        """Three iterations of ``r`` (n > 3) charged 1, n - 2 and 1 times
        (``independent``: the first alone, charged n times); with
        ``items``, (i, items[i]) pairs, and the tensors of the items the
        middle iteration stands for take its tensors as stand-ins."""
        scope = _Scope(self.mult, len(r), independent)
        self.report.n_while_loops += 1
        self._scopes.append(scope)
        if items is not None:
            mid = _tensors(items[1])
            for k in r[2:-1]:
                for a, b in zip(_tensors(items[k]), mid):
                    self._stand_in[id(a)] = (weakref.ref(a), b)
        try:
            picks = (r[0],) if independent else (r[0], r[1], r[-1])
            for it, i in enumerate(picks):
                scope.it, scope.edges = it, {}
                self._set_mult(scope.base * scope.mults[it])
                if items is None:
                    yield i
                    continue
                scope.per_item = {id(t) for t in _tensors(items[i])}
                yield i, items[i]
        finally:
            self._scopes.remove(scope)
            self._set_mult(scope.base)

    def _cross(self, t):
        """``t`` as the innermost scaled iteration sees it: through one
        boundary node per scope it enters from outside (or from an earlier
        iteration), outermost first.  Each scope judges the tensor itself,
        not an outer scope's boundary of it."""
        orig = t
        for scope in self._scopes:
            made = scope.made_at(orig)
            if made == scope.it:
                continue
            edge = scope.edges.get(id(orig))
            if edge is None:
                if id(orig) in scope.per_item:   # this iteration's input
                    at, extra = scope.base, 0
                elif made is None:   # from outside the loop: every iteration
                    at, extra = scope.base, scope.mults[scope.it] - 1
                else:                # a carry from the iteration before
                    at, extra = scope.base * scope.mults[made], 0
                cur = self.mult
                self._set_mult(at)
                edge = _Edge.apply(t, self, extra)
                self._set_mult(cur)
                scope.edges[id(orig)] = edge
                scope.produced[id(edge)] = (weakref.ref(edge), scope.it)
            t = edge
        return t

    def _made(self, outs) -> None:
        for t in outs:
            for scope in self._scopes:
                scope.produced[id(t)] = (weakref.ref(t), scope.it)

    # -- charging ------------------------------------------------------------

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if func.is_view or name in _FREE_OPS:
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            in_b = sum(_nbytes(t) for t in ins)
            out_b = sum(_nbytes(t) for t in outs)
            vol = out_b if coll == "all-gather" else (
                2 * in_b if coll == "all-reduce" else in_b)
            k = self._op_mult()
            self.report.collective_bytes[coll] += k * vol
            self.report.n_collective_ops += int(k)
            self.report.add_op(name, 0.0, in_b + out_b, k)
            return
        key = name[:-1] if name.endswith("_") and not name.endswith("__") \
            else name
        if not ins and all(t.dim() == 0 for t in outs):
            return                                    # a constant
        out_elems = sum(t.numel() for t in outs)
        if key == "copy":
            nbytes = _nbytes(ins[1]) + _nbytes(ins[0])
        elif key in ("fill", "zero"):
            nbytes = _nbytes(ins[0])
        else:
            nbytes = sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        elif key in _REDUCTIONS or torch.Tag.reduction in func.tags:
            n_in = max((t.numel() for t in ins), default=0)
            flops = max(n_in, out_elems) * (4 if key in _TRANSCENDENTAL
                                            else 1)
        elif key in _SORTS:
            n = max(out_elems, 1)
            flops = n * max(1, int(math.log2(n)))
        elif key in _ELEMENTWISE or torch.Tag.pointwise in func.tags:
            flops = out_elems * (4 if key in _TRANSCENDENTAL else 1)
        elif key in _MOVEMENT:
            flops = 0.0
        else:
            self.report.unknown_ops[key] = self.report.unknown_ops.get(
                key, 0) + 1
            flops = 0.0
        self.report.add_op(key, flops, nbytes, self._op_mult())


class _CountMode(TorchDispatchMode):
    def __init__(self, counter: OpCounter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.counter._count(func, args, kwargs, out)
        return out


class _TrackMode(TorchFunctionMode):
    """Inside a scaled iteration, in the forward pass with grad on: routes
    every tensor that needs a gradient and comes from outside the iteration
    through its boundary node, and notes what the iteration makes."""

    def __init__(self, counter: OpCounter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.counter
        if (not c._scopes or not torch.is_grad_enabled()
                or c._in_backward()):
            return func(*args, **kwargs)

        def swap(x):
            if isinstance(x, torch.Tensor) and x.requires_grad:
                return c._cross(x)
            if isinstance(x, (list, tuple)) and any(
                    isinstance(v, torch.Tensor) for v in x):
                return type(x)(swap(v) for v in x)
            return x

        args = tuple(swap(a) for a in args)
        kwargs = {k: swap(v) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        c._made(_tensors(out))
        return out


def active_counter() -> Optional[OpCounter]:
    """The innermost ``OpCounter`` counting in this thread, if any."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _CountMode):
            return mode.counter
    return None


def trip_range(*range_args, device, independent: bool = False):
    """``range(*range_args)`` -- exactly that on ``cpu`` and ``cuda``, and
    on ``meta`` with no counter active.  On ``meta`` under an ``OpCounter``,
    a loop of n > 3 iterations whose iterations run the same ops on the
    same shapes runs three of them (the first, the second standing for the
    n - 2 middle ones, the last), charged 1, n - 2 and 1 times.
    ``independent``: no iteration's autograd graph reaches another's and
    none differs by its position (the microbatches: each runs its own
    forward and backward), so the first alone stands for all n."""
    r = range(*range_args)
    c = active_counter()
    if (c is None or not c.trips or len(r) <= 3
            or torch.device(device).type != "meta"):
        return r
    return c._iterate(r, independent=independent)


def trip_items(items: list, *, device):
    """``enumerate(items)`` -- exactly that on ``cpu`` and ``cuda``, and on
    ``meta`` with no counter active -- for a loop over per-iteration inputs
    (the layers' params).  On ``meta`` under an ``OpCounter``, when n > 3
    items have the same shapes and dtypes, ``trip_range``'s three
    iterations; the gradients of the items the middle one stands for are
    its own (``stand_in_grads``)."""
    c = active_counter()
    n = len(items)
    if (c is None or not c.trips or n <= 3
            or torch.device(device).type != "meta"):
        return enumerate(items)
    sig = [[(t.shape, t.dtype) for t in _tensors(it)] for it in items]
    if any(s != sig[0] for s in sig):
        return enumerate(items)
    return c._iterate(range(n), items)


def trip_fill(items: list, n: int) -> list:
    """The per-iteration outputs (tensors or trees of them) of a trip loop
    of n iterations as n items: as they are when the loop ran n times,
    else the three scaled ones with the middle one repeated (detached: the
    repeats carry no gradient; the middle iteration's backward is already
    charged for them)."""
    if len(items) == n:
        return items
    first, mid, last = items
    rep = tree_map(lambda t: t.detach(), mid)
    return [first, mid] + [rep] * (n - 3) + [last]


def stand_in_grads(leaves: list, grads: list) -> list:
    """``torch.autograd.grad``'s results for ``leaves`` with each ``None``
    of a leaf a scaled ``trip_items`` loop skipped replaced by its stand-in's
    gradient (what that leaf's own backward, charged through the stand-in,
    would give in shape).  The same list when no counter holds stand-ins."""
    c = active_counter()
    if c is None or not c._stand_in:
        return grads
    by_id = {id(t): g for t, g in zip(leaves, grads)}
    out = []
    for t, g in zip(leaves, grads):
        src = t
        while g is None:        # a stand-in may itself stand in (nesting)
            hit = c._stand_in.get(id(src))
            if hit is None or hit[0]() is not src:
                break
            src = hit[1]
            g = by_id.get(id(src))
        out.append(g if g is None or src is t else g.detach())
    return out


def checkpoint(fn, *args, **kwargs):
    """``torch.utils.checkpoint.checkpoint`` (the same call when no counter
    is active); under a counter, ``fn``'s recompute in the backward pass is
    charged at the multiplier this call was made at."""
    c = active_counter()
    if c is None:
        return _torch_checkpoint.checkpoint(fn, *args, **kwargs)
    at = c.mult

    def run(*a, **k):
        prev = c.mult
        c.mult = at
        c._recompute += 1
        try:
            return fn(*a, **k)
        finally:
            c._recompute -= 1
            c.mult = prev

    return _torch_checkpoint.checkpoint(run, *args, **kwargs)


def count(fn, *args, **kwargs) -> Tuple[object, CostReport]:
    """(fn(*args, **kwargs), its CostReport)."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.report


def bytes_breakdown(report: CostReport, top: int = 15
                    ) -> List[Tuple[str, float]]:
    """The ops moving the most bytes, trip counts multiplied through
    (``hlo_cost.bytes_breakdown``'s counterpart, by aten op name)."""
    rows = [(k, v[1]) for k, v in report.by_op.items() if v[1]]
    return sorted(rows, key=lambda kv: -kv[1])[:top]


def flop_breakdown(report: CostReport, top: int = 15
                   ) -> List[Tuple[str, float]]:
    """The ops doing the most flops, by aten op name."""
    rows = [(k, v[0]) for k, v in report.by_op.items() if v[0]]
    return sorted(rows, key=lambda kv: -kv[1])[:top]
