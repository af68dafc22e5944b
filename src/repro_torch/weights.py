"""Weights from the JAX package into the port.

``from_jax_params`` takes a parameter pytree of the JAX package's models
(as built by the ``init`` of ``repro.models``' ``TransformerLM``,
``HybridLM``, ``XLSTMLM`` or ``WhisperModel``: nested dicts whose layer
subtrees carry stacked leading layer dims), with every leaf already a numpy
array, and returns the port's parameter dict: the same names and per-layer
shapes, with each stacked subtree a list of per-layer dicts (a list of
lists for the ones stacked twice).  Every leaf keeps its own dtype (f32 or
bf16): the reference keeps some leaves in f32 whatever the param dtype
(the MoE router, mamba's ``dt_bias`` / ``A_log`` / ``D``, xLSTM's ``wi`` /
``wf`` / ``bf`` and sLSTM gates).  The caller converts the arrays
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs no
JAX.  ``cache_from_jax`` does the same for the cache (or recurrent state)
of the reference's whole-prompt ``prefill``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_leaves, tree_map


def _tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor of its own dtype on ``device``."""
    a = np.array(a)              # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own (JAX's comes from ml_dtypes): move the
        # raw 16-bit patterns and reinterpret them
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _stacked_dims(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The leading stacked dims of each family's layer subtrees."""
    if cfg.family == "hybrid":
        G, n = cfg.n_layers // cfg.attn_every, cfg.attn_every - 1
        return {"attn_layers": (G,), "mamba_moe": (G, (n + 1) // 2),
                "mamba_dense": (G, n // 2)}
    if cfg.family == "ssm":
        G = cfg.n_layers // cfg.ssm.slstm_every
        return {"mlstm": (G, cfg.ssm.slstm_every - 1), "slstm": (G,)}
    if cfg.family == "encdec":
        return {"enc_blocks": (cfg.encoder.n_layers,),
                "dec_blocks": (cfg.n_layers,)}
    return {"layers": (cfg.n_layers,)}


def _unstack(tree, dims, device):
    """A subtree whose leaves stack ``dims`` leading dims -> nested lists of
    per-layer subtrees."""
    if not dims:
        return tree_map(lambda a: _tensor(a, device), tree)
    return [_unstack(tree_map(lambda a, i=i: np.asarray(a)[i], tree),
                     dims[1:], device) for i in range(dims[0])]


def from_jax_params(numpy_tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """JAX param pytree (numpy leaves) of ``cfg``'s family -> the port's
    params on ``device``, every leaf in its own dtype."""
    stacked = _stacked_dims(cfg)
    out = {}
    for name, sub in numpy_tree.items():
        dims = stacked.get(name, ())
        for leaf in tree_leaves(sub):
            if np.shape(leaf)[:len(dims)] != dims:
                raise ValueError(f"{name} leaf of shape {np.shape(leaf)} does "
                                 f"not stack {dims}")
        out[name] = _unstack(sub, dims, device)
    return out


def cache_from_jax(numpy_cache, device="cuda"):
    """The JAX ``prefill`` cache (numpy leaves: ``k`` and ``v`` of shape (L,
    B, S, Hkv, hd), ``kv_pos`` (L, B, W) for a ring; the hybrid's nested
    mamba states, xLSTM's state tuples, whisper's self and cross K/V) -> the
    port's, the same structure in the arrays' own dtypes on ``device``:
    what the port's ``decode`` takes."""
    return tree_map(lambda a: _tensor(a, device), numpy_cache)
