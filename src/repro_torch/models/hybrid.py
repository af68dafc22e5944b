"""Jamba-style hybrid: groups of (1 attention + 7 Mamba) layers with MoE FFNs
on alternating layers (4 MoE + 4 dense per group -> 36 MoE layers over 72);
the port of ``repro/models/hybrid.py``.

Group pattern (index within group):
  0: attention + dense FFN
  1,3,5,7: mamba + MoE FFN
  2,4,6:   mamba + dense FFN

Parameters are lists where the reference stacks (and scans): ``attn_layers``
one dict per group, ``mamba_moe`` / ``mamba_dense`` one list per group of
the group's MoE / dense mamba layers.  The cache stays stacked as in the
reference: K/V ``(G, B, S, Hkv, hd)`` for the one attention layer per group,
and the mamba states ``(G, 7, ...)``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.op_cost import checkpoint, trip_fill, trip_items
from repro_torch.models import layers as L
from repro_torch.models.mamba import init_mamba, mamba_mixer, mamba_state_struct
from repro_torch.models.transformer import _block_decode, _block_fwd, torch_dtype


def _init_mamba_layer(gen, cfg: ModelConfig, use_moe: bool, dtype,
                      device) -> Dict[str, Any]:
    p = {
        "mixer_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mamba": init_mamba(gen, cfg, dtype, device),
        "ffn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if use_moe:
        p["moe"] = L.init_moe(gen, cfg, dtype, device)
    else:
        p["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _init_attn_layer(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    return {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "ffn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ffn": L.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _mamba_layer_fwd(lp, x, cfg, state=None):
    h = L.rms_norm(x, lp["mixer_norm"], cfg.norm_eps)
    mix, new_state = mamba_mixer(lp["mamba"], h, cfg, state)
    x = x + mix
    h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if "moe" in lp:
        moe_fn = L.moe_ffn_scatter if cfg.moe_impl == "scatter" else L.moe_ffn
        x = x + moe_fn(lp["moe"], h, cfg)
    else:
        x = x + L.ffn(lp["ffn"], h)
    return x, new_state


def _stack_states(states):
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


class HybridLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        assert cfg.attn_every and cfg.n_layers % cfg.attn_every == 0
        self.group = cfg.attn_every              # 8
        self.n_groups = cfg.n_layers // self.group
        self.n_mamba = self.group - 1            # 7
        # within-group mamba positions 1..7; odd positions get MoE
        self.moe_slots = [j for j in range(1, self.group) if j % 2 == 1]
        self.dense_slots = [j for j in range(1, self.group) if j % 2 == 0]

    def init(self, gen: torch.Generator, device="cuda") -> Dict[str, Any]:
        """Seeded random weights with the reference's shapes and init
        distribution (the draws differ: torch's generator is not JAX's)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.param_dtype)
        G = self.n_groups
        return {
            "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                  device, scale=0.02),
            "attn_layers": [_init_attn_layer(gen, cfg, dt, device)
                            for _ in range(G)],
            "mamba_moe": [[_init_mamba_layer(gen, cfg, True, dt, device)
                           for _ in self.moe_slots] for _ in range(G)],
            "mamba_dense": [[_init_mamba_layer(gen, cfg, False, dt, device)
                             for _ in self.dense_slots] for _ in range(G)],
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
            "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                                    device, scale=1.0 / math.sqrt(cfg.d_model)),
        }

    def _mamba_layers(self, params, g: int):
        """Group g's mamba layers in position order 1..7."""
        moe, dense = iter(params["mamba_moe"][g]), iter(params["mamba_dense"][g])
        return [next(moe) if j % 2 == 1 else next(dense)
                for j in range(1, self.group)]

    # -- group bodies ----------------------------------------------------------
    def _group_fwd(self, x, attn_p, mamba_ps, positions, collect_kv: bool):
        """One group from scratch: (x, (k, v) or None, its mamba states
        stacked (7, ...))."""
        cfg = self.cfg
        x, kv = _block_fwd(attn_p, x, positions, cfg, collect_kv)
        new_states = []
        for lp in mamba_ps:
            x, ns = _mamba_layer_fwd(lp, x, cfg)
            new_states.append(ns)
        return x, kv, _stack_states(new_states)

    def _run(self, params, x, positions, collect_kv: bool, remat: bool):
        """Every group over the whole sequence: (x, (k, v) stacked (G, B, S,
        Hkv, hd) or None, mamba states stacked (G, 7, ...)).  ``remat``
        recomputes each group in the backward pass when grad is enabled."""
        ks, vs, ms = [], [], []
        groups = [(params["attn_layers"][g], self._mamba_layers(params, g))
                  for g in range(self.n_groups)]
        for _, (attn_p, mamba_ps) in trip_items(groups, device=x.device):
            args = (x, attn_p, mamba_ps, positions, collect_kv)
            if remat and torch.is_grad_enabled():
                x, kv, st = checkpoint(self._group_fwd, *args,
                                       use_reentrant=False)
            else:
                x, kv, st = self._group_fwd(*args)
            if collect_kv:
                ks.append(kv[0])
                vs.append(kv[1])
            ms.append(st)
        G = self.n_groups
        kv = ((torch.stack(trip_fill(ks, G)), torch.stack(trip_fill(vs, G)))
              if collect_kv else None)
        return x, kv, _stack_states(trip_fill(ms, G))

    @staticmethod
    def _positions(x):
        B, S = x.shape[:2]
        return torch.arange(S, device=x.device)[None, :].expand(B, S)

    # -- entry points -----------------------------------------------------------
    # They run on the device of ``params``; input tensors may lie elsewhere.
    def unembed_weight(self, params):
        return params["lm_head"], "dv"

    def train_hidden(self, params, batch, remat: bool = True):
        embed = params["embed"]
        x = embed[batch["tokens"].to(embed.device).long()]
        x, _, _ = self._run(params, x, self._positions(x), collect_kv=False,
                            remat=remat)
        return L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)

    def train_logits(self, params, batch, remat: bool = True):
        return self.train_hidden(params, batch, remat) @ params["lm_head"]

    def prefill(self, params, batch):
        """(last-position logits (B, V), cache {"k", "v": (G, B, S, Hkv, hd),
        "mamba": {"conv": (G, 7, B, W-1, d_in), "ssm": (G, 7, B, d_in, N)}})."""
        cfg = self.cfg
        embed = params["embed"]
        x = embed[batch["tokens"].to(embed.device).long()]
        x, (ks, vs), mstates = self._run(params, x, self._positions(x),
                                         collect_kv=True, remat=False)
        x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = (x @ params["lm_head"])[:, 0]
        return logits, {"k": ks, "v": vs, "mamba": mstates}

    def decode(self, params, tokens, cache, lens):
        """One token per sequence against ``prefill``'s cache (its K/V may be
        longer than the prompt).  The cache's tensors are updated IN PLACE
        (K/V rows at ``lens``, dropped past a cache's end; the mamba states
        overwritten) and the dict is returned with the logits (B, V)."""
        cfg = self.cfg
        embed = params["embed"]
        x = embed[tokens.to(embed.device).long()]
        lens = lens.to(embed.device)
        conv, ssm = cache["mamba"]["conv"], cache["mamba"]["ssm"]
        for g in range(self.n_groups):
            x, *_ = _block_decode(params["attn_layers"][g], x, cache["k"][g],
                                  cache["v"][g], lens, cfg)
            for j, lp in enumerate(self._mamba_layers(params, g)):
                st = {"conv": conv[g, j], "ssm": ssm[g, j]}
                x, ns = _mamba_layer_fwd(lp, x, cfg, st)
                conv[g, j].copy_(ns["conv"])
                ssm[g, j].copy_(ns["ssm"])
        x = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
        return x @ params["lm_head"], cache

    def cache_struct(self, batch: int, seq_len: int):
        """The shapes and dtypes of ``prefill``'s cache on the meta device."""
        cfg = self.cfg
        dt = torch_dtype(cfg.param_dtype)
        kv = (self.n_groups, batch, seq_len, cfg.n_kv_heads,
              cfg.resolved_head_dim)
        lead = (self.n_groups, self.n_mamba)
        return {
            "k": torch.empty(kv, dtype=dt, device="meta"),
            "v": torch.empty(kv, dtype=dt, device="meta"),
            "mamba": {k: torch.empty(lead + tuple(a.shape), dtype=a.dtype,
                                     device="meta")
                      for k, a in mamba_state_struct(cfg, batch, dt).items()},
        }
