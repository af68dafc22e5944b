"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel prefill) and sLSTM
(scalar memory, sequential recurrence), per arXiv:2405.04517; the port of
``repro/models/xlstm.py``.

Layer pattern (xLSTM[7:1]): one sLSTM per ``slstm_every`` layers, rest mLSTM.
mLSTM uses exponential input gating + logsigmoid forget gating with the
log-space stabilizer ``m``; it runs chunkwise (quadratic within a chunk of
``cfg.ssm.chunk_size``, recurrent across chunks, each chunk under
``torch.utils.checkpoint`` when grad is enabled), so decode is O(1) state.

Parameters are lists where the reference stacks: ``mlstm`` one list per
group of its mLSTM blocks, ``slstm`` one dict per group.  The recurrent
state stays stacked as in the reference: ``{"mlstm": (C (G, M, B, H, hd,
hd), n (G, M, B, H, hd), m (G, M, B, H)), "slstm": (c, n, h, m) each (G, B,
H, hd)}``, all f32.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.op_cost import (
    checkpoint, trip_fill, trip_items, trip_range,
)
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.transformer import torch_dtype

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    """The gate projections ``wi`` / ``wf`` and the forget bias ``bf`` are
    f32 whatever ``dtype``, as in the reference."""
    d = cfg.d_model
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    d_in = H * hd
    f32 = torch.float32
    return {
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "wq": dense_init(gen, (d, H, hd), dtype, device),
        "wk": dense_init(gen, (d, H, hd), dtype, device),
        "wv": dense_init(gen, (d, H, hd), dtype, device),
        "wi": dense_init(gen, (d, H), f32, device, scale=0.1),
        "wf": dense_init(gen, (d, H), f32, device, scale=0.1),
        "bf": torch.full((H,), 3.0, dtype=f32, device=device),  # forget open
        "wog": dense_init(gen, (d, d_in), dtype, device),
        "out_norm": torch.ones((d_in,), dtype=dtype, device=device),
        "down_proj": dense_init(gen, (d_in, d), dtype, device),
    }


def _mlstm_chunk(C_prev, n_prev, m_prev, q, k, v, log_i, log_f, hd: int):
    """Chunkwise-parallel mLSTM step, in f32.

    State: C (B, H, hd, hd), n (B, H, hd), m (B, H); q, k, v (B, Q, H, hd);
    log_i, log_f (B, Q, H) f32.  Returns (C, n, m, h (B, Q, H, hd)).  A
    function of its arguments only, so a checkpoint's recompute repeats it.
    """
    Q = q.shape[1]
    qf = q.float() / math.sqrt(hd)
    kf, vf = k.float(), v.float()

    lf_cum = torch.cumsum(log_f, dim=1)                   # (B,Q,H) inclusive
    # intra-chunk decay D[t,s] = lf_cum[t] - lf_cum[s] + log_i[s], s <= t
    Dm = lf_cum[:, :, None, :] - lf_cum[:, None, :, :] + log_i[:, None, :, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    Dm = torch.where(tri[None, :, :, None], Dm, NEG_INF)  # (B,t,s,H)

    inter_scale = lf_cum + m_prev[:, None, :]             # (B,Q,H)
    m_t = torch.maximum(Dm.amax(dim=2), inter_scale)
    m_t = m_t.clamp(min=-1e30)

    w_intra = torch.exp(Dm - m_t[:, :, None, :])          # (B,t,s,H)
    w_inter = torch.exp(inter_scale - m_t)                # (B,Q,H)

    scores = torch.einsum("bthd,bshd->btsh", qf, kf) * w_intra
    h_intra = torch.einsum("btsh,bshd->bthd", scores, vf)
    h_inter = w_inter[..., None] * torch.einsum("bthd,bhde->bthe", qf, C_prev)

    n_intra = torch.einsum("btsh,bshd->bthd", w_intra, kf)
    n_t = w_inter[..., None] * n_prev[:, None] + n_intra  # (B,Q,H,hd)

    num = h_inter + h_intra
    den = torch.maximum(torch.einsum("bthd,bthd->bth", qf, n_t).abs(),
                        torch.exp(-m_t))
    h = num / den[..., None]                              # (B,Q,H,hd)

    # end-of-chunk state
    total = lf_cum[:, -1, :]                              # (B,H)
    s_scale = total[:, None, :] - lf_cum + log_i          # (B,Q,H)
    m_new = torch.maximum(total + m_prev, s_scale.amax(dim=1))
    w_state = torch.exp(s_scale - m_new[:, None, :])      # (B,Q,H)
    decay = torch.exp(total + m_prev - m_new)             # (B,H)
    C_new = (decay[:, :, None, None] * C_prev
             + torch.einsum("bqh,bqhd,bqhe->bhde", w_state, kf, vf))
    n_new = (decay[..., None] * n_prev
             + torch.einsum("bqh,bqhd->bhd", w_state, kf))
    return C_new, n_new, m_new, h


def _heads(x, w):
    """x (B, S, D) @ w (D, H, hd) -> (B, S, H, hd)."""
    B, S, D = x.shape
    return (x @ w.reshape(D, -1)).reshape(B, S, w.shape[1], w.shape[2])


def mlstm_mixer(p, x, cfg: ModelConfig, state=None, chunk: int = 0):
    """x: (B, S, D) -> (x + block output, new_state); state = (C, n, m).
    Chunks of ``chunk or cfg.ssm.chunk_size`` steps, or ``gcd(S, Q)`` when
    that does not divide S."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    Q = chunk or cfg.ssm.chunk_size

    h_in = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _heads(h_in, p["wq"]), _heads(h_in, p["wk"]), _heads(h_in, p["wv"])
    h32 = h_in.float()
    log_i = h32 @ p["wi"]                                  # (B,S,H)
    log_f = F.logsigmoid(h32 @ p["wf"] + p["bf"])

    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((B, H, hd, hd), **f32),
                 torch.zeros((B, H, hd), **f32),
                 torch.zeros((B, H), **f32))

    if S % Q:
        Q = math.gcd(S, Q) or 1
    C, n, m = state
    hs = []
    for c in trip_range(0, S, Q, device=x.device):
        sl = slice(c, c + Q)
        args = (C, n, m, q[:, sl], k[:, sl], v[:, sl], log_i[:, sl],
                log_f[:, sl], hd)
        if torch.is_grad_enabled():
            C, n, m, h = checkpoint(_mlstm_chunk, *args, use_reentrant=False)
        else:
            C, n, m, h = _mlstm_chunk(*args)
        hs.append(h)
    h = torch.cat(trip_fill(hs, S // Q), dim=1).reshape(B, S, H * hd)

    og = torch.sigmoid(h_in @ p["wog"])
    h = rms_norm(h.to(x.dtype), p["out_norm"], cfg.norm_eps) * og
    return x + h @ p["down_proj"], (C, n, m)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    """The gate weights and biases are f32 whatever ``dtype``."""
    d = cfg.d_model
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    d_in = H * hd
    f32 = torch.float32
    d_ff = int(4.0 / 3.0 * d)
    return {
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "w_gates": dense_init(gen, (d, 4, H, hd), f32, device, scale=0.1),
        "r_gates": dense_init(gen, (4, H, hd, hd), f32, device, scale=0.1),
        "b_gates": torch.zeros((4, H, hd), dtype=f32, device=device),
        "out_norm": torch.ones((d_in,), dtype=dtype, device=device),
        "down_proj": dense_init(gen, (d_in, d), dtype, device),
        "ffn_norm": torch.ones((d,), dtype=dtype, device=device),
        "up_proj": dense_init(gen, (d, 2 * d_ff), dtype, device),
        "ffn_down": dense_init(gen, (d_ff, d), dtype, device),
    }


def _slstm_step(c, n, h, m, wx_t, r_gates):
    """State c, n, h, m each (B, H, hd) f32; wx_t: (B, 4, H, hd)."""
    rec = torch.einsum("bhd,ghde->bghe", h, r_gates)      # (B,4,H,hd)
    g = wx_t + rec
    i_t, f_t, z_t, o_t = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    m_new = torch.maximum(f_t + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(z_t)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(o_t) * c_new / n_new.clamp(min=1e-6)
    return c_new, n_new, h_new, m_new


def slstm_mixer(p, x, cfg: ModelConfig, state=None):
    """x: (B, S, D) -> (x after the sLSTM block and its gated GELU FFN,
    new_state); state = (c, n, h, m), m starting at NEG_INF."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim

    h_in = rms_norm(x, p["norm"], cfg.norm_eps)
    wx = (h_in.float() @ p["w_gates"].reshape(D, -1)).reshape(B, S, 4, H, hd)
    wx = wx + p["b_gates"][None, None]

    if state is None:
        z = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        state = (z, z, z, torch.full((B, H, hd), NEG_INF, dtype=torch.float32,
                                     device=x.device))

    c, n, h, m = state
    hs = []
    for t in trip_range(S, device=x.device):
        c, n, h, m = _slstm_step(c, n, h, m, wx[:, t], p["r_gates"])
        hs.append(h)
    out = torch.stack(trip_fill(hs, S), dim=1).reshape(B, S, H * hd)

    out = rms_norm(out.to(x.dtype), p["out_norm"], cfg.norm_eps)
    x = x + out @ p["down_proj"]
    # gated FFN (factor 4/3, GELU) per xLSTM post-up-projection block; JAX's
    # gelu is the tanh approximation by default
    f = rms_norm(x, p["ffn_norm"], cfg.norm_eps) @ p["up_proj"]
    a, b = f.chunk(2, dim=-1)
    x = x + (F.gelu(a, approximate="tanh") * b) @ p["ffn_down"]
    return x, (c, n, h, m)


def slstm_state_struct(cfg: ModelConfig, batch: int):
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    return tuple(torch.empty((batch, H, hd), dtype=torch.float32,
                             device="meta") for _ in range(4))


def mlstm_state_struct(cfg: ModelConfig, batch: int):
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    f32 = dict(dtype=torch.float32, device="meta")
    return (torch.empty((batch, H, hd, hd), **f32),
            torch.empty((batch, H, hd), **f32),
            torch.empty((batch, H), **f32))


# ---------------------------------------------------------------------------
# full xLSTM LM
# ---------------------------------------------------------------------------


class XLSTMLM:
    """xLSTM[7:1] language model: one sLSTM per ``slstm_every`` layers."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.n_groups = cfg.n_layers // cfg.ssm.slstm_every
        self.m_per_group = cfg.ssm.slstm_every - 1

    def init(self, gen: torch.Generator, device="cuda") -> Dict[str, Any]:
        """Seeded random weights with the reference's shapes and init
        distribution (the draws differ: torch's generator is not JAX's)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.param_dtype)
        return {
            "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt, device,
                                scale=0.02),
            "mlstm": [[init_mlstm(gen, cfg, dt, device)
                       for _ in range(self.m_per_group)]
                      for _ in range(self.n_groups)],
            "slstm": [init_slstm(gen, cfg, dt, device)
                      for _ in range(self.n_groups)],
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
            "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                                  device, scale=1.0 / math.sqrt(cfg.d_model)),
        }

    def _group_fwd(self, x, m_params, s_params, m_states, s_state):
        """One group: m_per_group mLSTM blocks then one sLSTM block.
        ``m_states`` is None or a list of (C, n, m); returns (x, [(C, n, m)
        per block], (c, n, h, m))."""
        cfg = self.cfg
        new_m = []
        for j, lp in trip_items(m_params, device=x.device):
            st = None if m_states is None else m_states[j]
            x, ns = mlstm_mixer(lp, x, cfg, st)
            new_m.append(ns)
        x, s_new = slstm_mixer(s_params, x, cfg, s_state)
        return x, trip_fill(new_m, len(m_params)), s_new

    def _run(self, params, x, states=None, remat: bool = False):
        """Every group: (x, the new states stacked as the reference's).
        ``remat`` recomputes each group in the backward pass when grad is
        enabled."""
        new_m, new_s = [], []
        groups = list(zip(params["mlstm"], params["slstm"]))
        for g, (m_params, s_params) in trip_items(groups, device=x.device):
            if states is None:
                m_st = s_st = None
            else:
                m_st = [tuple(a[g, j] for a in states["mlstm"])
                        for j in range(self.m_per_group)]
                s_st = tuple(a[g] for a in states["slstm"])
            args = (x, m_params, s_params, m_st, s_st)
            if remat and torch.is_grad_enabled():
                x, m_out, s_out = checkpoint(self._group_fwd, *args,
                                             use_reentrant=False)
            else:
                x, m_out, s_out = self._group_fwd(*args)
            new_m.append([torch.stack(a) for a in zip(*m_out)])
            new_s.append(s_out)
        new_m = trip_fill(new_m, self.n_groups)
        new_s = trip_fill(new_s, self.n_groups)
        return x, {"mlstm": tuple(torch.stack(a) for a in zip(*new_m)),
                   "slstm": tuple(torch.stack(a) for a in zip(*new_s))}

    # They run on the device of ``params``; input tensors may lie elsewhere.
    def _embed(self, params, tokens):
        embed = params["embed"]
        return embed[tokens.to(embed.device).long()]

    def unembed_weight(self, params):
        return params["lm_head"], "dv"

    def train_hidden(self, params, batch, remat: bool = True):
        x = self._embed(params, batch["tokens"])
        x, _ = self._run(params, x, remat=remat)
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps)

    def train_logits(self, params, batch, remat: bool = True):
        return self.train_hidden(params, batch, remat) @ params["lm_head"]

    def prefill(self, params, batch):
        """(last-position logits (B, V), the recurrent state): no KV cache,
        so nothing to pad for decode."""
        x = self._embed(params, batch["tokens"])
        x, states = self._run(params, x)
        x = rms_norm(x[:, -1:], params["final_norm"], self.cfg.norm_eps)
        return (x @ params["lm_head"])[:, 0], states

    def decode(self, params, tokens, cache, lens):
        """One token per sequence from the state ``prefill`` or ``decode``
        returned (``lens`` is not needed: the state holds the history).  The
        cache's tensors are overwritten IN PLACE with the new state and the
        cache is returned with the logits (B, V)."""
        x = self._embed(params, tokens)
        x, states = self._run(params, x, cache)
        for name in ("mlstm", "slstm"):
            for old, new in zip(cache[name], states[name]):
                old.copy_(new)
        x = rms_norm(x[:, -1], params["final_norm"], self.cfg.norm_eps)
        return x @ params["lm_head"], cache

    def cache_struct(self, batch: int, seq_len: int):
        """The shapes and dtypes of the state on the meta device."""
        cfg = self.cfg
        G, M = self.n_groups, self.m_per_group

        def stack(t, *lead):
            return tuple(torch.empty(lead + tuple(a.shape), dtype=a.dtype,
                                     device="meta") for a in t)

        return {"mlstm": stack(mlstm_state_struct(cfg, batch), G, M),
                "slstm": stack(slstm_state_struct(cfg, batch), G)}
