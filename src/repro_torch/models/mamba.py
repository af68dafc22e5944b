"""Mamba (S6) mixer -- the SSM layer of the Jamba hybrid (the port of
``repro/models/mamba.py``).

The selective scan steps through time in f32, chunk by chunk: a Python loop
over sequence chunks carries the (B, d_inner, d_state) SSM state, and under
autograd each chunk runs inside ``torch.utils.checkpoint``, so the backward
pass stores only the chunk-boundary states (JAX's ``jax.checkpoint`` on its
chunk scan).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.op_cost import checkpoint, trip_fill, trip_range
from repro_torch.models.layers import dense_init

MAMBA_CHUNK = 256


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm.expand * cfg.d_model
    dt_rank = cfg.ssm.dt_rank or max(1, cfg.d_model // 16)
    return d_inner, dt_rank, cfg.ssm.d_state


def init_mamba(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    """The reference's shapes and init distribution; ``dt_bias``, ``A_log``
    and ``D`` are f32 whatever ``dtype`` (S4D-real init for A)."""
    d = cfg.d_model
    d_in, dt_rank, N = mamba_dims(cfg)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device).expand(d_in, N)
    return {
        "in_proj": dense_init(gen, (d, 2 * d_in), dtype, device),
        "conv_w": dense_init(gen, (d_in, cfg.ssm.conv_width), dtype, device,
                             scale=0.5),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "x_proj": dense_init(gen, (d_in, dt_rank + 2 * N), dtype, device),
        "dt_proj": dense_init(gen, (dt_rank, d_in), dtype, device),
        # softplus^-1(0.01)
        "dt_bias": torch.full((d_in,), -4.6, dtype=torch.float32, device=device),
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones((d_in,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, (d_in, d), dtype, device),
    }


def _causal_conv(x, w, b, state=None):
    """x: (B, S, d_in); w: (d_in, W); state: (B, W-1, d_in) trailing context
    in x's dtype.  Returns (y, new_state) with
    y[t] = b + sum_j w[:, j] * x[t - W + 1 + j], in x's dtype."""
    B, S, d_in = x.shape
    W = w.shape[1]
    if state is None:
        state = x.new_zeros((B, W - 1, d_in))
    xp = torch.cat([state, x], dim=1)           # (B, S + W - 1, d_in)
    y = torch.zeros_like(x)
    for j in range(W):
        y = y + xp[:, j:j + S] * w[None, None, :, j]
    return y + b[None, None, :], xp[:, S:]      # the last W-1 inputs


def _ssm_chunk(h0, x, dt, Bm, Cm, A):
    """One chunk of the selective scan, one step a time position, in f32.
    h0: (B, d_in, N); x, dt: (B, Q, d_in); Bm, Cm: (B, Q, N); A: (d_in, N).
    Returns (h, ys (B, Q, d_in)).  A function of its arguments only, so a
    checkpoint's recompute repeats it exactly."""
    h = h0
    ys = []
    for t in trip_range(x.shape[1], device=x.device):
        dA = torch.exp(dt[:, t, :, None] * A[None])          # (B, d_in, N)
        h = dA * h + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return h, torch.stack(trip_fill(ys, x.shape[1]), dim=1)


def mamba_mixer(p, x, cfg: ModelConfig, state=None, chunk: int = MAMBA_CHUNK):
    """x: (B, S, D) -> (y, new_state).

    state: None (from scratch) or dict(conv=(B, W-1, d_in) in x's dtype,
    ssm=(B, d_in, N) f32).  Chunks of ``Q = min(chunk, S)`` time steps, or
    ``gcd(S, Q)`` when Q does not divide S; one step at S == 1 (decode)."""
    B, S, D = x.shape
    d_in, dt_rank, N = mamba_dims(cfg)

    xs, z = (x @ p["in_proj"]).chunk(2, dim=-1)  # (B, S, d_in) each
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)

    proj = xc @ p["x_proj"]                      # (B, S, dt_rank + 2N)
    dt_low = proj[..., :dt_rank]
    Bm = proj[..., dt_rank:dt_rank + N].float()
    Cm = proj[..., dt_rank + N:].float()
    dt = F.softplus((dt_low @ p["dt_proj"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                   # (d_in, N) f32
    xc_f = xc.float()

    h = (torch.zeros((B, d_in, N), dtype=torch.float32, device=x.device)
         if state is None else state["ssm"])

    Q = min(chunk, S)
    if S % Q:
        Q = math.gcd(S, Q) or 1

    if S == 1:  # decode fast path
        h, ys = _ssm_chunk(h, xc_f, dt, Bm, Cm, A)
    else:
        ys = []
        for c in trip_range(0, S, Q, device=x.device):
            args = (h, xc_f[:, c:c + Q], dt[:, c:c + Q], Bm[:, c:c + Q],
                    Cm[:, c:c + Q], A)
            if torch.is_grad_enabled():
                h, y = checkpoint(_ssm_chunk, *args, use_reentrant=False)
            else:
                h, y = _ssm_chunk(*args)
            ys.append(y)
        ys = torch.cat(trip_fill(ys, S // Q), dim=1)

    y = ys + xc_f * p["D"][None, None, :]
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    return out, {"conv": new_conv, "ssm": h}


def mamba_state_struct(cfg: ModelConfig, batch: int, dtype):
    """The shapes and dtypes of ``mamba_mixer``'s state, on the meta
    device: conv in ``dtype`` (the param dtype), ssm in f32."""
    d_in, _, N = mamba_dims(cfg)
    return {
        "conv": torch.empty((batch, cfg.ssm.conv_width - 1, d_in), dtype=dtype,
                            device="meta"),
        "ssm": torch.empty((batch, d_in, N), dtype=torch.float32,
                           device="meta"),
    }
