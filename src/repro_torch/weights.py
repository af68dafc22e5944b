"""Weights from the JAX package into the port.

``from_jax_params`` takes the JAX transformer's parameter pytree (as
built by ``repro.models.transformer.TransformerLM.init``: nested dicts whose
layer leaves carry a stacked leading layer dim), with every leaf already a
numpy array, and returns the port's parameter dict: the same names and
per-layer shapes, with ``"layers"`` a list of per-layer dicts.  The caller
converts the arrays (``jax.tree_util.tree_map(np.asarray, params)``), so this
module needs no JAX.  ``cache_from_jax`` does the same for the cache of the
reference's whole-prompt ``prefill``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import torch_dtype


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a)              # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own (JAX's comes from ml_dtypes): move the
        # raw 16-bit patterns and reinterpret them
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype).contiguous()


# leaves the reference keeps in f32 whatever the param dtype: the MoE router
# (``repro/models/layers.py`` ``init_moe``), whose logits are f32
F32_LEAVES = ("router",)


def _tree(tree, fn, name=""):
    if isinstance(tree, dict):
        return {k: _tree(v, fn, k) for k, v in tree.items()}
    return fn(tree, name)


def from_jax_params(numpy_tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """JAX param pytree (numpy leaves) -> the port's params on ``device`` in
    ``cfg.param_dtype``, the MoE router in f32."""
    dt = torch_dtype(cfg.param_dtype)
    stacked = numpy_tree["layers"]
    n_layers = cfg.n_layers
    for leaf in _leaves(stacked):
        if np.shape(leaf)[0] != n_layers:
            raise ValueError(f"layer leaf of shape {np.shape(leaf)} does not "
                             f"stack {n_layers} layers")
    params = {
        "embed": _tensor(numpy_tree["embed"], dt, device),
        "final_norm": _tensor(numpy_tree["final_norm"], dt, device),
        "layers": [_tree(stacked, lambda a, name, i=i: _tensor(
                       np.asarray(a)[i],
                       torch.float32 if name in F32_LEAVES else dt, device))
                   for i in range(n_layers)],
    }
    if "lm_head" in numpy_tree:
        params["lm_head"] = _tensor(numpy_tree["lm_head"], dt, device)
    return params


def cache_from_jax(numpy_cache: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The JAX ``prefill`` cache (numpy ``k`` and ``v`` of shape (L, B, S,
    Hkv, hd), and ``kv_pos`` (L, B, W) for a ring) -> the port's, in the
    arrays' own dtypes on ``device``: what ``TransformerLM.decode`` takes."""
    out = {}
    for name, a in numpy_cache.items():
        dt = {"bfloat16": torch.bfloat16, "float32": torch.float32,
              "int32": torch.int32}[np.asarray(a).dtype.name]
        out[name] = _tensor(a, dt, device)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
