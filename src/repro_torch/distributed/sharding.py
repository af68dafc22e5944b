"""Sharding rules: logical axes, parameter specs and per-device shard
shapes over a mesh (the port of ``repro/distributed/sharding.py``).

The rules are pure shape logic, copied from the reference: TP over the
"model" axis for head / ffn / expert dims, optional FSDP over the "data"
axis for the embed dims of big models (2D weight sharding), replication for
norms and scalars; every candidate spec is sanitized against the actual dim
sizes (axes that do not divide a dimension are dropped, e.g. granite's
single KV head under TP=16).

This round the port runs one process, so the meshes are virtual
(``repro_torch.launch.mesh.VirtualMesh``): ``NamedSharding.shard_shape``
gives each leaf's per-device shape, which the dry-run turns into bytes per
device, and nothing is placed.  ``constrain`` is the identity.

The layer dimension.  The reference stacks layers (``layers/attn/wq`` has
shape (L, d, H, hd)) and its rule adds an unsharded leading dim when the
path holds ``layers`` or ``blocks``.  The port keeps layers as lists
(``layers/<i>/attn/wq`` of shape (d, H, hd)), so ``param_specs`` rebuilds
each leaf's reference view -- the path without the list indices, the shape
with the list lengths in front -- applies the copied rule to it and drops
the stacked dims again (which the rules never shard).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple, Union

_ctx = threading.local()

AxisVal = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One mesh axis (or a tuple of them, or None) per dimension: a tuple,
    equal to ``jax.sharding.PartitionSpec`` taken as a tuple."""

    def __new__(cls, *parts: AxisVal):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _active():
    return getattr(_ctx, "active", None)


@contextmanager
def axis_rules(mesh, rules: Dict[str, AxisVal]):
    prev = _active()
    _ctx.active = (mesh, rules)
    try:
        yield
    finally:
        _ctx.active = prev


def _axis_size(mesh, axis: AxisVal) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape[axis]
    return math.prod(mesh.shape[a] for a in axis)


def sanitize_spec(mesh, spec: Sequence[AxisVal], shape: Sequence[int]) -> P:
    """Drop mesh axes that don't divide the corresponding dim.  ``mesh`` is
    anything with a ``.shape`` mapping of axis sizes."""
    used = set()
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is None:
            out.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        keep = []
        size = 1
        for a in axes:
            asz = mesh.shape[a]
            if a not in used and dim % (size * asz) == 0:
                keep.append(a)
                size *= asz
        for a in keep:
            used.add(a)
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return P(*out)


def constrain(x, logical: Sequence[Optional[str]]):
    """The identity: one process holds every tensor whole, so there is
    nothing to constrain (the reference's ``with_sharding_constraint``)."""
    return x


# ---------------------------------------------------------------------------
# rule sets
# ---------------------------------------------------------------------------


def default_rules(mesh, *, shard_seq: bool = False, fsdp: bool = False) -> Dict[str, AxisVal]:
    """Logical-name -> mesh-axis mapping.

    shard_seq: long-context decode -- shard the KV/cache length over "data".
    """
    has_pod = "pod" in mesh.axis_names
    batch_axes: AxisVal = ("pod", "data") if has_pod else "data"
    rules: Dict[str, AxisVal] = {
        "batch": batch_axes,
        "seq": None,
        "kv_seq": "data" if shard_seq else None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "moe_mlp": "model",
        "experts": "model",
        "vocab": "model",
        "ssm_inner": "model",
        "fsdp": "data" if fsdp else None,
        "pod_dp": "pod" if has_pod else None,
        # layout of KV collected for the prefill cache
        "cache_seq": None,
        "cache_heads": "model",
        "cache_hd": None,
        # residual-stream sequence dim (Megatron sequence parallelism)
        "act_seq": None,
    }
    return rules


# ---------------------------------------------------------------------------
# parameter specs (name-based)
# ---------------------------------------------------------------------------

_PARAM_RULES = [
    # (name, ndim) -> logical spec (pre-sanitization)
    ("wq", ("fsdp", "model", None)),
    ("wk", ("fsdp", "model", None)),
    ("wv", ("fsdp", "model", None)),
    ("wo", ("model", None, "fsdp")),
    ("bq", ("model", None)),
    ("bk", ("model", None)),
    ("bv", ("model", None)),
    ("w_gate", None),   # resolved dynamically (dense vs moe)
    ("w_up", None),
    ("w_down", None),
    ("router", (None, None)),
    ("embed", ("model", "fsdp")),       # (V, D): vocab over model
    ("lm_head", ("fsdp", "model")),     # (D, V)
    ("in_proj", ("fsdp", "model")),     # mamba (D, 2*d_inner)
    ("conv_w", ("model", None)),        # (d_inner, width)
    ("conv_b", ("model",)),
    ("x_proj", ("model", None)),        # (d_inner, dt_rank + 2*state)
    ("dt_proj", (None, "model")),
    ("dt_bias", ("model",)),
    ("A_log", ("model", None)),
    ("D", ("model",)),
    ("out_proj", ("model", "fsdp")),    # (d_inner, D)
    # xlstm
    ("up_proj", ("fsdp", "model")),
    ("down_proj", ("model", "fsdp")),
    ("wi", ("model", None)),
    ("wf", ("model", None)),
    ("wog", ("fsdp", "model")),
    ("r_gate", ("model", None)),
]


def spec_for_param(path: str, shape: Tuple[int, ...], mesh, *, fsdp: bool) -> P:
    """The reference's rule for one leaf of a STACKED tree (its path
    without list indices, its shape with the stacked dims in front)."""
    name = path.split("/")[-1]
    is_expert = "moe" in path and name in ("w_gate", "w_up", "w_down")
    is_ffn = (not is_expert) and name in ("w_gate", "w_up", "w_down")
    model_axis_sz = mesh.shape["model"]

    # layer-stacked params carry a leading layer dim: detect via path marker
    stacked = "layers" in path or "blocks" in path
    lead: Tuple[AxisVal, ...] = (None,) if stacked else ()

    fsdp_ax: AxisVal = "data" if fsdp else None

    if is_expert:
        # experts (E, D, F)/(E, F, D): EP over model if divisible, else TP on F
        e_dim = shape[len(lead)]
        if e_dim % model_axis_sz == 0:
            spec: Tuple[AxisVal, ...] = lead + ("model", fsdp_ax, None)
        elif name == "w_down":
            spec = lead + (None, "model", fsdp_ax)
        else:
            spec = lead + (None, fsdp_ax, "model")
        return sanitize_spec(mesh, spec, shape)
    if is_ffn:
        if name == "w_down":
            spec = lead + ("model", fsdp_ax)
        else:
            spec = lead + (fsdp_ax, "model")
        return sanitize_spec(mesh, spec, shape)

    for rule_name, logical in _PARAM_RULES:
        if name == rule_name and logical is not None:
            resolved = tuple(
                ("data" if fsdp else None) if ax == "fsdp" else ax for ax in logical
            )
            spec = lead + resolved
            return sanitize_spec(mesh, spec, shape)
    # norms, scalars, biases: replicated (stacked layer dim unsharded)
    return sanitize_spec(mesh, lead + (None,) * (len(shape) - len(lead)), shape)


def _flatten_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf}; a list's items sit under their index."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flatten_paths(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def param_specs(params_shape: Any, mesh, *, fsdp: bool) -> Any:
    """A PartitionSpec tree matching the port's param tree (of tensors,
    meta tensors included): each leaf's reference spec minus its stacked
    dims (see the module docstring)."""

    def walk(tree, prefix: str, stacked: Tuple[int, ...]):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k), stacked)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            # every item has the same structure and shapes: one spec each
            spec = walk(tree[0], prefix, stacked + (len(tree),))
            return [spec for _ in tree]
        full = stacked + tuple(tree.shape)
        spec = spec_for_param(prefix, full, mesh, fsdp=fsdp)
        if any(a is not None for a in spec[:len(stacked)]):
            raise ValueError(f"{prefix}: the rule shards a stacked dim "
                             f"({spec} over {full})")
        return P(*spec[len(stacked):])

    return walk(params_shape, "", ())


class NamedSharding:
    """A spec over a mesh (``jax.sharding.NamedSharding``'s name): here only
    its per-device shape."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """Each dim divided by the size of the axes it is sharded over."""
        spec = tuple(self.spec) + (None,) * (len(global_shape) - len(self.spec))
        out = []
        for dim, axis in zip(global_shape, spec):
            n = _axis_size(self.mesh, axis)
            if dim % n:
                raise ValueError(f"dim {dim} of {tuple(global_shape)} does "
                                 f"not divide over {axis} ({n})")
            out.append(dim // n)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh}, {self.spec!r})"


def shardings_for(tree_specs: Any, mesh) -> Any:
    """The NamedSharding of every spec of a tree (dicts, lists, tuples and
    NamedTuples of specs)."""
    if isinstance(tree_specs, P):
        return NamedSharding(mesh, tree_specs)
    if isinstance(tree_specs, dict):
        return {k: shardings_for(v, mesh) for k, v in tree_specs.items()}
    if hasattr(tree_specs, "_fields"):
        return type(tree_specs)(*(shardings_for(v, mesh) for v in tree_specs))
    if isinstance(tree_specs, (list, tuple)):
        return type(tree_specs)(shardings_for(v, mesh) for v in tree_specs)
    return tree_specs
