"""AdamW over parameter trees of tensors (the port of
``repro/training/optimizer.py``, the same arithmetic step for step).

State and update are tree-shaped like the params (dicts, lists and tuples
of tensors).  ``torch.optim.AdamW`` is not used: it places eps, applies the
bias correction and decays the weights in other orders than the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0     # 0 = off
    # optional linear warmup + cosine decay
    warmup_steps: int = 0
    total_steps: int = 0


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Any
    nu: Any


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamWState(step=step, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def _schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (f32): ``adamw_update`` passes the
    incremented step, and the warmup adds one again, as the reference."""
    step = torch.as_tensor(step, dtype=torch.float32)
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)
    if cfg.warmup_steps:
        lr = lr * torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    if cfg.total_steps:
        frac = torch.clamp(
            (step - cfg.warmup_steps)
            / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
        lr = lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (params, new_state, metrics).  Grads are clipped by the f32
    global norm, the moments computed in f32 and stored in their own
    dtype, the update ``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``
    applied to every leaf in f32 and stored in the param's dtype.

    The params and moments are updated IN PLACE and returned (the
    reference's jitted step donates their buffers): a caller that needs the
    old values clones them first.  The step counter is a new tensor."""
    step = state.step + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip_norm:
        # a true division (a Python scalar over a tensor is its reciprocal
        # times the scalar: two roundings)
        clip = torch.tensor(cfg.grad_clip_norm, dtype=torch.float32,
                            device=gnorm.device)
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        # f32 like JAX's product of a grad and an f32 array
        grads = tree_map(lambda g: g.float() * scale, grads)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    mu_hat_scale = 1.0 / (1 - b1 ** stepf)   # (1 / x: correctly rounded)
    nu_hat_scale = 1.0 / (1 - b2 ** stepf)
    lr = _schedule(cfg, stepf)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.float()
        m.copy_(b1 * m.float() + (1 - b1) * g)
        v.copy_(b2 * v.float() + (1 - b2) * g.square())
        u = (m.float() * mu_hat_scale) / (
            torch.sqrt(v.float() * nu_hat_scale) + cfg.eps)
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
    return (params, AdamWState(step=step, mu=state.mu, nu=state.nu),
            {"grad_norm": gnorm, "lr": lr})
