"""Training step: loss -> grad -> AdamW, with microbatch gradient
accumulation, remat inside the models and configurable accumulator /
moment dtypes (the port of ``repro/training/train_step.py``).

Gradients come from ``torch.autograd.grad`` over the parameter leaves
(detached views that require grad); a bf16 param's grad is bf16, as JAX's,
and is then cast to ``accum_dtype``.  The step runs eagerly on the params'
device and updates the params and moments in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Tuple

import torch

from repro_torch.launch.op_cost import stand_in_grads, trip_range
from repro_torch.models.model import Model
from repro_torch.models.transformer import torch_dtype
from repro_torch.training.optimizer import (
    AdamWConfig, AdamWState, adamw_init, adamw_update,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig(lr=3e-4, weight_decay=0.1,
                                         grad_clip_norm=1.0)
    n_microbatches: int = 1
    accum_dtype: str = "float32"     # grad accumulator ("bfloat16" = compressed)
    moment_dtype: str = "float32"    # AdamW m/v ("bfloat16" for 100B+ configs)
    remat: bool = True


def init_train_state(model: Model, gen: torch.Generator, cfg: TrainConfig,
                     device="cuda") -> Tuple[Any, AdamWState]:
    params = model.init(gen, device)
    opt = adamw_init(params, moment_dtype=torch_dtype(cfg.moment_dtype))
    return params, opt


def init_train_state_shape(model: Model, cfg: TrainConfig
                           ) -> Tuple[Any, AdamWState]:
    """(params, opt_state) on the meta device: shapes and dtypes, moments
    in ``cfg.moment_dtype``, no storage (for the dry-run)."""
    return init_train_state(model, torch.Generator(), cfg, device="meta")


def _split_microbatches(batch: Dict[str, Any], n: int):
    """Microbatch i is rows [i*B/n, (i+1)*B/n) of every batch leaf."""
    def r(x):
        B = x.shape[0]
        assert B % n == 0, f"microbatches {n} must divide global batch {B}"
        return [x[i * (B // n):(i + 1) * (B // n)] for i in range(n)]
    split = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _value_and_grad(model: Model, params, batch, remat: bool):
    """(loss, metrics, grads in each param's dtype) of one batch."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.loss(tree_unflatten(params, leaves), batch,
                                   remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a dry-run's scaled layer loop charges skipped layers' backward
    # through the layer standing for them: their grads are its grads
    grads = stand_in_grads(leaves, grads)
    # a leaf the loss does not reach gets a zero grad, as under jax.grad
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), tree_map(lambda v: v.detach(), metrics),
            tree_unflatten(params, grads))


def loss_and_grad(model: Model, params, batch, cfg: TrainConfig):
    """Microbatched value-and-grad; grads averaged in ``accum_dtype``:
    ``acc + g.to(acc) / n`` in microbatch order, the loss ``sum(loss / n)``
    in f32."""
    acc_dt = torch_dtype(cfg.accum_dtype)
    if cfg.n_microbatches <= 1:
        loss, metrics, grads = _value_and_grad(model, params, batch, cfg.remat)
        return loss, metrics, tree_map(lambda g: g.to(acc_dt), grads)

    n = cfg.n_microbatches
    dev = tree_leaves(params)[0].device
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    grad_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                              device=p.device), params)
    mbs = _split_microbatches(batch, n)
    for i in trip_range(n, device=dev, independent=True):
        loss, _, grads = _value_and_grad(model, params, mbs[i], cfg.remat)
        grad_acc = tree_map(lambda a, g: a + g.to(acc_dt) / n, grad_acc, grads)
        loss_acc = loss_acc + loss / n
    return loss_acc, {"loss": loss_acc}, grad_acc


def train_step(model: Model, cfg: TrainConfig, params, opt_state: AdamWState,
               batch):
    """One optimizer step.  Returns (params, opt_state, metrics): the given
    param and moment tensors, updated IN PLACE (see ``adamw_update``)."""
    loss, metrics, grads = loss_and_grad(model, params, batch, cfg)
    params, opt_state, opt_metrics = adamw_update(cfg.optimizer, grads,
                                                  opt_state, params)
    return params, opt_state, {**metrics, **opt_metrics}


def make_train_step(model: Model, cfg: TrainConfig):
    """``train_step`` bound to the model and config: (params, opt_state,
    batch) -> (params, opt_state, metrics).  It writes into the given params
    and moments, as the reference's jitted step with
    ``donate_argnums=(0, 1)`` reuses their buffers."""
    return partial(train_step, model, cfg)


def default_train_config(param_count: int, *, batch_shards: int,
                         global_batch: int) -> TrainConfig:
    """Heuristic: more microbatches + compressed moments for bigger models.

    ``batch_shards`` = product of mesh axes the batch is sharded over; the
    microbatch count must keep each microbatch divisible by it.
    """
    per_shard = max(1, global_batch // batch_shards)
    if param_count < 5e9:
        n_micro = 1
    elif param_count < 60e9:
        n_micro = min(4, per_shard)
    else:
        n_micro = min(16, per_shard)
    big = param_count >= 60e9
    return TrainConfig(
        n_microbatches=max(1, n_micro),
        moment_dtype="bfloat16" if big else "float32",
        accum_dtype="float32",
        remat=True,
    )
