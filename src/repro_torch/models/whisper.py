"""Whisper-style encoder-decoder (audio backbone; conv frontend stubbed); the
port of ``repro/models/whisper.py``.

The modality frontend is a stub: the caller passes precomputed frame
embeddings ``frames`` (B, enc_seq, d_model).  The bidirectional encoder and
the decoder with causal self-attention (KV cache) and cross-attention (the
encoder's K/V computed once at prefill) are real.  Whisper uses sinusoidal
absolute positions and GELU MLPs (no RoPE, no SwiGLU).

Parameters are lists where the reference stacks: ``enc_blocks`` and
``dec_blocks`` one dict per layer.  The cache stays stacked as in the
reference: ``self_k`` / ``self_v`` ``(L, B, S, H, hd)`` and ``cross_k`` /
``cross_v`` ``(L, B, enc_seq, H, hd)``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.op_cost import checkpoint, trip_fill, trip_items
from repro_torch.models import layers as L
from repro_torch.models.transformer import _write_rows, torch_dtype


def sinusoid_at(positions, d_model: int):
    """positions: any int tensor -> (..., d_model) f32 sinusoidal embeddings
    (sines of every angle, then cosines)."""
    pos = positions.float()[..., None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=positions.device)
    ang = pos / torch.pow(10_000.0, dim / d_model)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoid(seq_len: int, d_model: int, device=None):
    return sinusoid_at(torch.arange(seq_len, device=device), d_model)


def _init_mlp(gen, d: int, d_ff: int, dtype, device):
    return {
        "w_in": L.dense_init(gen, (d, d_ff), dtype, device),
        "w_out": L.dense_init(gen, (d_ff, d), dtype, device,
                              scale=1.0 / math.sqrt(d_ff)),
    }


def _mlp(p, x):
    # JAX's gelu is the tanh approximation by default; torch's is exact
    return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]


def _init_enc_block(gen, cfg: ModelConfig, dtype, device):
    ones = dict(dtype=dtype, device=device)
    return {
        "attn_norm": torch.ones((cfg.d_model,), **ones),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "mlp_norm": torch.ones((cfg.d_model,), **ones),
        "mlp": _init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _init_dec_block(gen, cfg: ModelConfig, dtype, device):
    ones = dict(dtype=dtype, device=device)
    return {
        "self_norm": torch.ones((cfg.d_model,), **ones),
        "self_attn": L.init_attention(gen, cfg, dtype, device),
        "cross_norm": torch.ones((cfg.d_model,), **ones),
        "cross_attn": L.init_attention(gen, cfg, dtype, device, cross=True),
        "mlp_norm": torch.ones((cfg.d_model,), **ones),
        "mlp": _init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _project(x, w):
    """x (B, S, D) @ w (D, H, hd) -> (B, S, H, hd)."""
    B, S, D = x.shape
    return (x @ w.reshape(D, -1)).reshape(B, S, w.shape[1], w.shape[2])


def _enc_layer(lp, x, cfg):
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], h, cfg, rope=False)
    a = L.attention(q, k, v, causal=False)
    y = x + L.attn_output(lp["attn"], a, cfg)
    return y + _mlp(lp["mlp"], L.rms_norm(y, lp["mlp_norm"], cfg.norm_eps))


def _cross_mlp(lp, y, ck, cv, cfg):
    """Cross-attention over the encoder's K/V, then the MLP."""
    h2 = L.rms_norm(y, lp["cross_norm"], cfg.norm_eps)
    q2 = _project(h2, lp["cross_attn"]["wq"])
    a2 = L.attention(q2, ck, cv, causal=False)
    y = y + L.attn_output(lp["cross_attn"], a2, cfg)
    return y + _mlp(lp["mlp"], L.rms_norm(y, lp["mlp_norm"], cfg.norm_eps))


def _dec_layer(lp, x, enc_out, cfg):
    """One decoder layer over the whole sequence: (x, (k, v, ck, cv))."""
    h = L.rms_norm(x, lp["self_norm"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["self_attn"], h, cfg, rope=False)
    a = L.attention(q, k, v, causal=True)
    y = x + L.attn_output(lp["self_attn"], a, cfg)
    ck = _project(enc_out, lp["cross_attn"]["wk"])
    cv = _project(enc_out, lp["cross_attn"]["wv"])
    return _cross_mlp(lp, y, ck, cv, cfg), (k, v, ck, cv)


class WhisperModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, gen: torch.Generator, device="cuda") -> Dict[str, Any]:
        """Seeded random weights with the reference's shapes and init
        distribution (the draws differ: torch's generator is not JAX's)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.param_dtype)
        return {
            "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                  device, scale=0.02),
            "enc_blocks": [_init_enc_block(gen, cfg, dt, device)
                           for _ in range(cfg.encoder.n_layers)],
            "dec_blocks": [_init_dec_block(gen, cfg, dt, device)
                           for _ in range(cfg.n_layers)],
            "enc_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        }

    # -- encoder -------------------------------------------------------------
    def encode(self, params, frames, remat: bool = False):
        """frames: (B, enc_seq, D) precomputed frame embeddings (the stub
        frontend), on any device.  ``remat`` recomputes each layer in the
        backward pass when grad is enabled."""
        cfg = self.cfg
        x = frames.to(device=params["embed"].device,
                      dtype=torch_dtype(cfg.param_dtype))
        x = x + sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
        for _, lp in trip_items(params["enc_blocks"], device=x.device):
            if remat and torch.is_grad_enabled():
                x = checkpoint(_enc_layer, lp, x, cfg, use_reentrant=False)
            else:
                x = _enc_layer(lp, x, cfg)
        return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)

    # -- decoder -------------------------------------------------------------
    def _dec_fwd(self, params, tokens, enc_out, collect_kv: bool,
                 remat: bool = False):
        cfg = self.cfg
        embed = params["embed"]
        x = embed[tokens.to(embed.device).long()]
        S = x.shape[1]
        x = x + sinusoid(S, cfg.d_model, x.device).to(x.dtype)[None]
        kvs = []
        for _, lp in trip_items(params["dec_blocks"], device=x.device):
            if remat and torch.is_grad_enabled():
                x, kv = checkpoint(_dec_layer, lp, x, enc_out, cfg,
                                   use_reentrant=False)
            else:
                x, kv = _dec_layer(lp, x, enc_out, cfg)
            if collect_kv:
                kvs.append(kv)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        kvs = trip_fill(kvs, len(params["dec_blocks"])) if collect_kv else None
        return x, (tuple(torch.stack(a) for a in zip(*kvs)) if collect_kv
                   else None)

    def unembed_weight(self, params):
        return params["embed"], "vd"

    def train_hidden(self, params, batch, remat: bool = True):
        enc_out = self.encode(params, batch["frames"], remat=remat)
        x, _ = self._dec_fwd(params, batch["tokens"], enc_out,
                             collect_kv=False, remat=remat)
        return x

    def train_logits(self, params, batch, remat: bool = True):
        return self.train_hidden(params, batch, remat) @ params["embed"].t()

    def prefill(self, params, batch):
        """(last-position logits (B, V), cache): the self-attention K/V of
        exactly S rows (a ``decode`` at ``lens == S`` drops its write) and
        the cross-attention K/V of the encoder output, computed once."""
        enc_out = self.encode(params, batch["frames"])
        x, (sk, sv, ck, cv) = self._dec_fwd(params, batch["tokens"], enc_out,
                                            collect_kv=True)
        logits = x[:, -1] @ params["embed"].t()
        return logits, {"self_k": sk, "self_v": sv, "cross_k": ck,
                        "cross_v": cv}

    def decode(self, params, tokens, cache, lens):
        """One token per sequence at position ``lens``: its self K/V are
        written IN PLACE at row ``lens`` (dropped past the cache's end) and
        the dict is returned with the logits (B, V)."""
        cfg = self.cfg
        embed = params["embed"]
        x = embed[tokens.to(embed.device).long()]
        lens = lens.to(embed.device)
        x = x + sinusoid_at(lens, cfg.d_model)[:, None].to(x.dtype)
        bidx = torch.arange(x.shape[0], device=x.device)
        for l, lp in enumerate(params["dec_blocks"]):
            k_c, v_c = cache["self_k"][l], cache["self_v"][l]
            h = L.rms_norm(x, lp["self_norm"], cfg.norm_eps)
            q, k_new, v_new = L.qkv_project(lp["self_attn"], h, cfg, rope=False)
            _write_rows(k_c, bidx, lens, k_new[:, 0])
            _write_rows(v_c, bidx, lens, v_new[:, 0])
            a = L.attention(q, k_c, v_c, q_offset=lens, kv_lens=lens + 1)
            y = x + L.attn_output(lp["self_attn"], a, cfg)
            x = _cross_mlp(lp, y, cache["cross_k"][l], cache["cross_v"][l], cfg)
        x = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
        return x @ embed.t(), cache

    def cache_struct(self, batch: int, seq_len: int):
        """The shapes and dtypes of ``prefill``'s cache on the meta device."""
        cfg = self.cfg
        dt = torch_dtype(cfg.param_dtype)
        hd = cfg.resolved_head_dim
        self_shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, hd)
        cross_shape = (cfg.n_layers, batch, cfg.encoder.seq_len,
                       cfg.n_kv_heads, hd)
        return {n: torch.empty(s, dtype=dt, device="meta")
                for n, s in (("self_k", self_shape), ("self_v", self_shape),
                             ("cross_k", cross_shape),
                             ("cross_v", cross_shape))}
