"""Decoder-only transformer LM (the dense, MoE and VLM families): parameter
init, the whole-sequence entry points -- ``train_hidden`` / ``train_logits``,
``prefill`` (forward + KV cache, a sliding-window ring for SWA configs) and
``decode`` (one token against that cache) -- and the engine's chunked step
over a dense per-slot KV cache or a paged one, split and fused KV layouts
(the port of ``repro/models/transformer.py``).  The engine's rounds carry
token ids only, so the VLM family serves its text backbone there; the
whole-sequence entry points take its patch-embedding prefix.  Layers of
mixed kinds (a ``LayeredModelConfig``: per-layer windows, RoPE or none,
dense or expert FFNs, QK-norm, post-norm) run in the paged round only.

Parameters are a dict mirroring the JAX pytree, except that ``"layers"`` is
a list with one dict per layer instead of arrays with a stacked leading
layer dim: PyTorch runs the layer loop in Python, where JAX scanned.  KV
caches stay stacked, ``(L, B, S, Hkv, hd)``, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.op_cost import checkpoint, trip_fill, trip_items
from repro_torch.kernels.chunked_prefill_attention import (
    chunked_prefill_attention,
)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_fused,
)
from repro_torch.kernels.paged_prefill_attention import (
    paged_prefill_attention, paged_prefill_attention_fused,
)
from repro_torch.models import layers as L


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _block_init(gen, cfg: ModelConfig, dtype, device,
                l: int = 0) -> Dict[str, Any]:
    # each branch's norm: on its input, or under post-norm on its output
    attn_norm, ffn_norm = (("post_attn_norm", "post_ffn_norm")
                           if cfg.post_norm else ("attn_norm", "ffn_norm"))
    p: Dict[str, Any] = {
        attn_norm: torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": L.init_attention(gen, cfg, dtype, device),
        ffn_norm: torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if cfg.qk_norm:
        hd = cfg.resolved_head_dim
        for k in ("q_norm", "k_norm"):
            p["attn"][k] = torch.ones((hd,), dtype=dtype, device=device)
    if cfg.sparse(l):
        p["moe"] = L.init_moe(gen, cfg, dtype, device)
        if cfg.moe.dense_residual:
            p["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, device)
    else:
        p["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _block_ffn(p, x, cfg: ModelConfig, lane_mask=None, moe_counts=None):
    """The FFN block.  ``lane_mask`` (B, C): an engine round's real lanes,
    whose MoE runs on the routed rows only (``L.moe_round``, adding to
    ``moe_counts``); without it the whole-sequence entry points and
    training run the batched expert GEMMs, which have a gradient.  A
    shared expert (``moe["shared"]``) runs on every lane beside the routed
    ones; under ``cfg.post_norm`` the branch's sum is normed on its way to
    the residual, and its input is not."""
    h = x if cfg.post_norm else L.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if "moe" in p:
        if lane_mask is not None:
            out = L.moe_round(p["moe"], h, cfg, lane_mask, moe_counts)
        elif cfg.moe_impl == "scatter":
            out = L.moe_ffn_scatter(p["moe"], h, cfg)
        else:
            out = L.moe_ffn(p["moe"], h, cfg)
        if "shared" in p["moe"]:
            out = out + L.ffn(p["moe"]["shared"], h)
        if "ffn" in p:  # arctic's dense residual, a parallel branch
            out = out + L.ffn(p["ffn"], h)
    else:
        out = L.ffn(p["ffn"], h)
    if cfg.post_norm:
        out = L.rms_norm(out, p["post_ffn_norm"], cfg.norm_eps)
    return x + out


def _layer(p, x, l: int, cfg: ModelConfig, positions, attend, rope_tabs=None,
           lane_mask=None, moe_counts=None):
    """Decoder layer ``l`` by its kind (``ModelConfig.rope``; ``qk_norm``
    and ``post_norm``): pre-norm, or each branch normed on its output; RoPE
    or none (``rope_tabs``: the round's tables, else computed here);
    ``attend(q, k, v)`` stores the new K/V where its caller keeps them and
    returns the attention output; then ``_block_ffn`` (``lane_mask`` and
    ``moe_counts`` as there)."""
    h = x if cfg.post_norm else L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = L.qkv_project(p["attn"], h, cfg, positions, rope=cfg.rope(l),
                            rope_tabs=rope_tabs)
    a = L.attn_output(p["attn"], attend(q, k, v), cfg)
    if cfg.post_norm:
        a = L.rms_norm(a, p["post_attn_norm"], cfg.norm_eps)
    return _block_ffn(p, x + a, cfg, lane_mask, moe_counts)


# The whole-sequence entry points and the hybrid family run layers of one
# kind only (``TransformerLM._uniform``): each block is layer 0's kind.

def _block_fwd(p, x, positions, cfg: ModelConfig, collect_kv: bool):
    """Full-sequence causal block (train / prefill): (x, (k, v) or None)."""
    kv = []

    def attend(q, k, v):
        kv.append((k, v))
        return L.attention(q, k, v, q_offset=0, causal=True,
                           sliding_window=cfg.window(0))

    x = _layer(p, x, 0, cfg, positions, attend)
    return x, (kv[0] if collect_kv else None)


def _write_rows(cache, bidx, slot, new):
    """cache[b, slot[b]] = new[b] in place, except where slot[b] is past the
    end of the cache: that write is dropped, as JAX's ``.at[].set`` drops
    it, without a host sync (the clamped row is rewritten with itself)."""
    n = cache.shape[1]
    at = slot.clamp(max=n - 1).long()
    keep = (slot < n).view(-1, *([1] * (new.dim() - 1)))
    cache[bidx, at] = torch.where(keep, new, cache[bidx, at])


def _block_decode(p, x, cache_k, cache_v, lens, cfg: ModelConfig,
                  kv_positions=None):
    """Single-token block against a padded KV cache.

    cache_k/v: (B, S, Hkv, hd); lens: (B,) current lengths (the write
    position of a linear cache; a SWA ring writes slot lens % W and
    ``kv_positions`` (B, W) holds each slot's absolute position).  The
    cache and ``kv_positions`` are written IN PLACE (JAX returned new
    ones); returns ``(x, cache_k, cache_v, kv_positions or None)``.  A
    linear cache's write at ``lens >= S`` is dropped, and attention then
    spans the S cached keys (``kv_lens = lens + 1``).
    """
    window = cfg.window(0)

    def attend(q, k_new, v_new):
        slot = lens % cache_k.shape[1] if window else lens
        bidx = torch.arange(x.shape[0], device=x.device)
        _write_rows(cache_k, bidx, slot, k_new[:, 0])
        _write_rows(cache_v, bidx, slot, v_new[:, 0])
        if window:
            _write_rows(kv_positions, bidx, slot, lens.to(kv_positions.dtype))
            return L.attention(q, cache_k, cache_v, q_offset=lens,
                               causal=True, sliding_window=window,
                               kv_positions=kv_positions)
        return L.attention(q, cache_k, cache_v, q_offset=lens,
                           kv_lens=lens + 1)

    x = _layer(p, x, 0, cfg, lens[:, None], attend)
    return x, cache_k, cache_v, (kv_positions if window else None)


class TransformerLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- params ------------------------------------------------------------
    def init(self, gen: torch.Generator, device="cuda") -> Dict[str, Any]:
        """Seeded random weights with the shapes and init distribution of
        ``repro.models.transformer.TransformerLM.init`` (the draws differ:
        torch's generator is not JAX's)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.param_dtype)
        params = {
            "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                  device, scale=0.02),
            "layers": [_block_init(gen, cfg, dt, device, l)
                       for l in range(cfg.n_layers)],
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(
                gen, (cfg.d_model, cfg.vocab_size), dt, device,
                scale=1.0 / math.sqrt(cfg.d_model))
        return params

    def _uniform(self, what: str) -> None:
        """Refuse layers of mixed kinds where only the engine's paged round
        computes them."""
        if not self.cfg.uniform_layers:
            raise NotImplementedError(
                f"{self.cfg.name}: layers of mixed kinds (windows, RoPE, "
                f"FFN, norms) run in chunked_step_paged only, not in {what}")

    def _unembed(self, params, x):
        if "lm_head" in params:
            return x @ params["lm_head"]
        return x @ params["embed"].t()

    # -- whole-sequence entry points -------------------------------------------
    # They run on the device of ``params`` (``init``'s ``device``, the card
    # unless the caller asks for the CPU); input tensors may lie elsewhere.
    def _embed_inputs(self, params, batch: Dict[str, Any]):
        """Token embeddings (B, St, D), behind the VLM patch-embedding prefix
        (B, P, D) when the config has patch tokens and the batch holds
        ``patch_embeds``."""
        embed = params["embed"]
        x = embed[batch["tokens"].to(embed.device).long()]
        if self.cfg.n_patch_tokens and "patch_embeds" in batch:
            patches = batch["patch_embeds"].to(device=embed.device,
                                               dtype=x.dtype)
            x = torch.cat([patches, x], dim=1)
        return x

    def _run_layers(self, params, x, positions, collect_kv: bool,
                    remat: bool):
        """Every block over the whole sequence: (x, (k, v) stacked
        (L, B, S, Hkv, hd) or None).  ``remat`` recomputes each layer in the
        backward pass (``torch.utils.checkpoint``) when grad is enabled."""
        cfg = self.cfg
        self._uniform("the whole-sequence entry points")
        ks, vs = [], []
        for _, lp in trip_items(params["layers"], device=x.device):
            if remat and torch.is_grad_enabled():
                x, kv = checkpoint(_block_fwd, lp, x, positions, cfg,
                                   collect_kv, use_reentrant=False)
            else:
                x, kv = _block_fwd(lp, x, positions, cfg, collect_kv)
            if collect_kv:
                ks.append(kv[0])
                vs.append(kv[1])
        n = len(params["layers"])
        return x, ((torch.stack(trip_fill(ks, n)),
                    torch.stack(trip_fill(vs, n))) if collect_kv else None)

    @staticmethod
    def _positions(x):
        B, S = x.shape[:2]
        return torch.arange(S, device=x.device)[None, :].expand(B, S)

    def unembed_weight(self, params):
        if "lm_head" in params:
            return params["lm_head"], "dv"
        return params["embed"], "vd"

    def train_hidden(self, params, batch: Dict[str, Any], remat: bool = True):
        """The final-normed hidden states (B, S, D) of the whole sequence
        (patch positions first for the VLM family)."""
        x = self._embed_inputs(params, batch)
        x, _ = self._run_layers(params, x, self._positions(x),
                                collect_kv=False, remat=remat)
        return L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)

    def train_logits(self, params, batch: Dict[str, Any], remat: bool = True):
        return self._unembed(params, self.train_hidden(params, batch, remat))

    def prefill(self, params, batch: Dict[str, Any]):
        """Forward over the whole prompt: (last-position logits (B, V), cache).

        The cache is {"k", "v"} ``(L, B, S, Hkv, hd)`` -- exactly S rows, so
        a ``decode`` at ``lens == S`` drops its write -- or, for a
        sliding-window config, a W-sized ring with {"kv_pos"} ``(L, B, W)``
        int32: the last W positions at slot ``pos % W`` when S >= W, else
        positions 0..S-1 in place and ``INVALID_POS`` after them.
        """
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        B, S, _ = x.shape
        x, (ks, vs) = self._run_layers(params, x, self._positions(x),
                                       collect_kv=True, remat=False)
        x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = self._unembed(params, x)[:, 0]
        if not cfg.sliding_window:
            return logits, {"k": ks, "v": vs}
        W = cfg.sliding_window
        dev = x.device
        if S >= W:
            pos = torch.arange(S - W, S, device=dev)
            slots = pos % W
            ks_r = torch.zeros_like(ks[:, :, :W])
            vs_r = torch.zeros_like(vs[:, :, :W])
            ks_r[:, :, slots] = ks[:, :, S - W:]
            vs_r[:, :, slots] = vs[:, :, S - W:]
            kv_pos = torch.zeros((B, W), dtype=torch.int32, device=dev)
            kv_pos[:, slots] = pos.to(torch.int32)[None, :]
        else:
            pad = (0, 0, 0, 0, 0, W - S)
            ks_r = torch.nn.functional.pad(ks, pad)
            vs_r = torch.nn.functional.pad(vs, pad)
            kv_pos = torch.full((B, W), L.INVALID_POS, dtype=torch.int32,
                                device=dev)
            kv_pos[:, :S] = torch.arange(S, dtype=torch.int32, device=dev)
        # one row per layer: decode writes each layer's own in place
        kv_pos = kv_pos[None].repeat(cfg.n_layers, 1, 1)
        return logits, {"k": ks_r, "v": vs_r, "kv_pos": kv_pos}

    def decode(self, params, tokens, cache, lens):
        """One token per sequence: tokens (B, 1); cache as ``prefill``
        returns it (a linear cache may be longer than the prompt); lens (B,)
        tokens already cached.  The cache dict's tensors are updated IN
        PLACE and the dict is returned with the logits (B, V)."""
        cfg = self.cfg
        self._uniform("the ring-cache decode")
        embed = params["embed"]
        x = embed[tokens.to(embed.device).long()]
        lens = lens.to(embed.device)
        has_pos = "kv_pos" in cache
        for l, lp in enumerate(params["layers"]):
            x, *_ = _block_decode(
                lp, x, cache["k"][l], cache["v"][l], lens, cfg,
                kv_positions=cache["kv_pos"][l] if has_pos else None)
        x = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
        return self._unembed(params, x), cache

    def cache_struct(self, batch: int, seq_len: int):
        """The shapes and dtypes of ``prefill``'s cache, as tensors on the
        meta device (no storage)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.param_dtype)
        S = cfg.sliding_window if cfg.sliding_window else seq_len
        shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        c = {"k": torch.empty(shape, dtype=dt, device="meta"),
             "v": torch.empty(shape, dtype=dt, device="meta")}
        if cfg.sliding_window:
            c["kv_pos"] = torch.empty((cfg.n_layers, batch, S),
                                      dtype=torch.int32, device="meta")
        return c

    # -- the engine round ----------------------------------------------------
    def _round(self, params, tokens, positions, write_mask, chunk_lens,
               attend, moe_counts=None):
        """The layers of one engine round around a layout's KV write and
        attention: ``attend(l, q, k_new, v_new)`` stores layer ``l``'s new
        K/V and returns its attention output.  Masked lanes (``write_mask``
        False) hand over zeros, never lane values: idle rows carry NaN under
        the plain attention (a softmax over no key), and a NaN parked in
        storage -- a shared sink page, or a slot's sink row -- would reach
        other rows' masked-position 0*V products or the NaN guard's scan.
        Zeroing also makes duplicate sink indices harmless: every write to
        that row carries the same value.  ``moe_counts`` (3,) int64, if
        given, gains each MoE layer's counts (``L.moe_round``).  Returns
        the logits at each slot's last chunk position.

        Each layer runs by its kind (``_layer``; its window in
        ``attend``)."""
        cfg = self.cfg
        keep = write_mask[:, :, None, None]
        x = params["embed"][tokens.long()]
        # the rotary angles depend on the positions only: once a round
        rope_tabs = L.rope_tables(positions, cfg.resolved_head_dim,
                                  cfg.rope_theta)
        for l, lp in enumerate(params["layers"]):
            def attend_l(q, k_new, v_new, l=l):
                return attend(l, q, torch.where(keep, k_new, 0.0),
                              torch.where(keep, v_new, 0.0))
            x = _layer(lp, x, l, cfg, positions, attend_l, rope_tabs,
                       write_mask, moe_counts)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        last = (chunk_lens - 1).clamp(min=0).long()
        x_last = x[torch.arange(x.shape[0], device=x.device), last]  # (B, D)
        return self._unembed(params, x_last)

    def chunked_step(self, params, tokens, cache, lens, chunk_lens,
                     moe_counts=None):
        """One chunked-prefill round against the dense per-slot KV cache
        (Sarathi semantics, the engine's ``paged_kv=False`` A/B layout).

        tokens (B, C) right-padded; cache {"k", "v"} each ``(L, B, S+1, Hkv,
        hd)``, the last row of every slot a write sink for padding lanes;
        lens (B,) int32 tokens already cached; chunk_lens (B,) int32 tokens
        this round (decode 1, prefill its chunk, idle 0).  The cache is
        updated IN PLACE (JAX returned a new one and donated the old
        buffer); returns the logits at each slot's last chunk position.
        ``moe_counts``: the MoE counter (``_round``).

        Every bucket, C == 1 included, attends through
        ``prefill_chunk_attention`` over ``cache[l][:, :-1]`` -- the
        reference's exact computation -- which reads that view in place.
        Full attention only: a window raises ``NotImplementedError`` (the
        paged layouts take it).
        """
        cfg = self.cfg
        if any(cfg.window(l) for l in range(cfg.n_layers)):
            raise NotImplementedError(
                f"{cfg.name}: the dense per-slot layout computes full "
                "attention only; the paged layouts take windows")
        B, C = tokens.shape
        S_pad = cache["k"].shape[2]          # S + 1 (padding sink row)
        dev = tokens.device
        positions = lens[:, None] + torch.arange(C, dtype=torch.int32,
                                                 device=dev)[None, :]
        write_mask = (torch.arange(C, device=dev)[None, :]
                      < chunk_lens[:, None])                      # (B, C)
        # padding positions scatter into the sink row S_pad - 1
        write_pos = torch.where(write_mask, positions, S_pad - 1).long()
        bidx = torch.arange(B, device=dev)[:, None].expand(B, C)
        kv_lens = lens + chunk_lens

        def attend(l, q, k_new, v_new):
            ck, cv = cache["k"][l], cache["v"][l]
            ck.index_put_((bidx, write_pos), k_new)
            cv.index_put_((bidx, write_pos), v_new)
            return chunked_prefill_attention(q, ck[:, :-1], cv[:, :-1],
                                             kv_lens, lens)

        return self._round(params, tokens, positions, write_mask, chunk_lens,
                           attend, moe_counts)

    def chunked_step_paged(self, params, tokens, kv_pages, lens, chunk_lens,
                           block_tables, *, moe_counts=None):
        """One chunked-prefill round against a paged KV cache (vLLM layout).

        tokens (B, C) right-padded; kv_pages {"k", "v"} each
        ``(L, n_pages, page_size, Hkv, hd)`` (split layout) or {"kv"}
        ``(L, n_pages, page_size, 2*Hkv, hd)`` with heads ``[K0,V0,K1,V1,
        ...]`` (fused layout: the round's new K/V interleave into ONE
        scatter per layer); lens (B,) int32 tokens already
        cached; chunk_lens (B,) int32 tokens this round (decode 1, prefill
        its chunk, idle 0); block_tables (B, max_pages) int32.  New K/V for
        position ``p`` of slot ``b`` goes to flat row
        ``block_tables[b, p // ps] * ps + p % ps``; padding lanes go to the
        last physical page (the sink) and are never read back.

        The pool is updated IN PLACE (JAX returned a new one and donated the
        old buffer); returns the logits at each slot's last chunk position.
        A bucket of C == 1 runs the paged decode kernel, C > 1 the paged
        prefill kernel (decode slots of a mixed round included), each in the
        pool's layout; a layer with a window (``cfg.window(l)``: every layer
        under a uniform ``sliding_window``, or each layer's own) runs the
        kernel's windowed instantiation.  Each layer runs by its kind
        (``_round``).  ``moe_counts``: the MoE counter (``_round``).
        """
        cfg = self.cfg
        fused = "kv" in kv_pages
        B, C = tokens.shape
        n_phys, ps = (kv_pages["kv"] if fused else kv_pages["k"]).shape[1:3]
        dev = tokens.device
        positions = lens[:, None] + torch.arange(C, dtype=torch.int32,
                                                 device=dev)[None, :]
        write_mask = (torch.arange(C, device=dev)[None, :]
                      < chunk_lens[:, None])                      # (B, C)
        # logical position -> physical flat row via the block table; padding
        # lanes may index past the table (JAX clamps such gathers) and are
        # redirected to the sink page below
        page_idx = (positions // ps).long().clamp_(max=block_tables.shape[1] - 1)
        page_of = torch.gather(block_tables, 1, page_idx)
        flat_pos = page_of * ps + positions % ps
        write_pos = torch.where(write_mask, flat_pos,
                                (n_phys - 1) * ps).reshape(-1).long()
        kv_lens = lens + chunk_lens

        def attend(l, q, k_new, v_new):
            if fused:
                return self._attend_fused(
                    kv_pages["kv"][l], q, k_new, v_new, write_pos,
                    block_tables, kv_lens, lens, cfg.window(l))
            return self._attend_split(
                kv_pages["k"][l], kv_pages["v"][l], q, k_new, v_new,
                write_pos, block_tables, kv_lens, lens, cfg.window(l))

        return self._round(params, tokens, positions, write_mask, chunk_lens,
                           attend, moe_counts)

    @staticmethod
    def _attend_split(ck, cv, q, k_new, v_new, write_pos, block_tables,
                      kv_lens, lens, window=0):
        """Scatter one layer's new K and V into the split pools
        ``(n_phys, ps, Hkv, hd)`` and attend through them (over the last
        ``window`` positions of each query where ``window`` is set)."""
        _scatter_rows(ck, write_pos, k_new)
        _scatter_rows(cv, write_pos, v_new)
        return _paged_attention(q, (ck, cv), block_tables, kv_lens, lens,
                                window)

    @staticmethod
    def _attend_fused(ckv, q, k_new, v_new, write_pos, block_tables, kv_lens,
                      lens, window=0):
        """Interleave one layer's new K/V onto the head axis, write them
        with ONE scatter into the fused pool ``(n_phys, ps, 2*Hkv, hd)``
        and attend through it (``window`` as for ``_attend_split``)."""
        B, C, Hkv, hd = k_new.shape
        kv_new = torch.stack([k_new, v_new], dim=3).reshape(B, C, 2 * Hkv, hd)
        _scatter_rows(ckv, write_pos, kv_new)
        return _paged_attention(q, (ckv,), block_tables, kv_lens, lens, window)


def _scatter_rows(pool, write_pos, new):
    """pool ``(n_phys, ps, H, hd)`` viewed as rows: row ``write_pos[i]`` =
    lane ``i`` of ``new`` (B, C, H, hd), in place."""
    pool.view(-1, *pool.shape[2:]).index_put_(
        (write_pos,), new.reshape(-1, *new.shape[2:]))


def _paged_attention(q, pools, block_tables, kv_lens, lens, window):
    """q (B, C, Hq, hd) through ``pools``, the split ``(k, v)`` or the fused
    ``(kv,)``: the paged decode kernel for C == 1, the prefill kernel
    otherwise."""
    fused = len(pools) == 1
    if q.shape[1] == 1:
        decode = paged_decode_attention_fused if fused else paged_decode_attention
        return decode(q[:, 0], *pools, block_tables, kv_lens, window)[:, None]
    prefill = paged_prefill_attention_fused if fused else paged_prefill_attention
    return prefill(q, *pools, block_tables, kv_lens, lens, window)
