"""Model factory + unified API (the port of ``repro/models/model.py``).

``build_model(cfg)`` dispatches on the config family and returns a wrapper
exposing a uniform surface:

  init(gen, device) -> params
  train_hidden / train_logits(params, batch)
  prefill(params, batch) -> (last_logits, cache)
  decode(params, tokens, cache, lens) -> (logits, cache)
  loss(params, batch) -> (scalar, metrics)       # chunked cross-entropy
  cache_struct(batch, seq_len)
  init_shape(gen) -> params on the meta device     # for the dry-run
  input_specs(shape_spec) -> dict of meta tensors (modality stubs incl.)
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.op_cost import checkpoint
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.layers import attention_phase
from repro_torch.models.transformer import TransformerLM, torch_dtype
from repro_torch.models.whisper import WhisperModel
from repro_torch.models.xlstm import XLSTMLM

XENT_CHUNK = 512


def _xent_chunk(h, w, y, m):
    """One chunk's (sum of masked token losses, sum of the mask): the
    logits are the product in the operands' dtype (bf16 for bf16 weights,
    as JAX's einsum returns them), then f32; the label term is a gather."""
    logits = (h @ w).float()                         # (B, c, V)
    logz = torch.logsumexp(logits, dim=-1)           # (B, c)
    ll = logits.gather(-1, y[..., None].long())[..., 0]
    return ((logz - ll) * m).sum(), m.sum()


def chunked_cross_entropy(hidden, unembed, kind: str, labels, mask=None,
                          chunk: int = XENT_CHUNK):
    """Cross-entropy fused with the unembedding, chunked over the sequence
    so the (B, S, V) f32 logits never exist at once: chunks of
    ``c = min(chunk, S)`` positions, decreased until c divides S, each run
    under ``torch.utils.checkpoint`` when grad is enabled (its logits are
    recomputed in the backward pass).

    hidden: (B, S, D); unembed: (D, V) if kind == "dv" else (V, D);
    labels: (B, S) int; mask: (B, S) float or None (all ones).  Returns
    ``sum((logz - ll) * mask) / max(sum(mask), 1)`` in f32.
    """
    B, S, D = hidden.shape
    dev = hidden.device
    w = unembed if kind == "dv" else unembed.t()
    labels = labels.to(dev)
    mask = (torch.ones((B, S), dtype=torch.float32, device=dev) if mask is None
            else mask.to(device=dev, dtype=torch.float32))

    c = min(chunk, S)
    while S % c:
        c -= 1
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(0, S, c):
        args = (hidden[:, i:i + c], w, labels[:, i:i + c], mask[:, i:i + c])
        if torch.is_grad_enabled():
            loss, n = checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            loss, n = _xent_chunk(*args)
        tot = tot + loss
        cnt = cnt + n
    return tot / cnt.clamp(min=1.0)


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        if cfg.family in ("dense", "moe", "vlm"):
            self.impl = TransformerLM(cfg)
        elif cfg.family == "hybrid":
            self.impl = HybridLM(cfg)
        elif cfg.family == "ssm":
            self.impl = XLSTMLM(cfg)
        elif cfg.family == "encdec":
            self.impl = WhisperModel(cfg)
        else:
            raise ValueError(f"unknown family {cfg.family!r}")

    def init(self, gen: torch.Generator, device="cuda"):
        return self.impl.init(gen, device)

    def init_shape(self, gen: torch.Generator = None):
        """The param tree on the meta device: shapes and dtypes, no
        storage (for the dry-run)."""
        return self.impl.init(gen if gen is not None else torch.Generator(),
                              "meta")

    def train_hidden(self, params, batch, remat: bool = True):
        return self.impl.train_hidden(params, batch, remat=remat)

    def train_logits(self, params, batch, remat: bool = True):
        return self.impl.train_logits(params, batch, remat=remat)

    def prefill(self, params, batch):
        """The family's ``prefill`` in the prefill attention phase: under
        ``ATTN_IMPL == "auto"`` its attention is the exact chunked path."""
        with attention_phase("prefill"):
            return self.impl.prefill(params, batch)

    def decode(self, params, tokens, cache, lens):
        return self.impl.decode(params, tokens, cache, lens)

    def cache_struct(self, batch: int, seq_len: int):
        return self.impl.cache_struct(batch, seq_len)

    def loss(self, params, batch, remat: bool = True):
        """(the masked mean next-token cross-entropy, {"loss": it}).  The
        batch holds ``tokens`` and ``labels`` (and ``frames`` for encdec,
        ``patch_embeds`` for vlm, optionally ``loss_mask``), on any
        device."""
        hidden = self.train_hidden(params, batch, remat=remat)
        w, kind = self.impl.unembed_weight(params)
        labels = batch["labels"]
        # VLM: hidden includes patch positions at the front; loss on text tail
        if labels.shape[1] != hidden.shape[1]:
            hidden = hidden[:, -labels.shape[1]:]
        loss = chunked_cross_entropy(hidden, w, kind, labels,
                                     batch.get("loss_mask"))
        return loss, {"loss": loss}

    def input_specs(self, shape: ShapeSpec) -> Dict[str, Any]:
        """Meta-tensor stand-ins for every model input of this shape cell,
        in the reference's shapes and dtypes."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        emb_dt = torch_dtype(cfg.param_dtype)

        def spec(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind == "decode":      # one new token against a cache of S
            return {"tokens": spec((B, 1), i32),
                    "cache": self.cache_struct(B, S),
                    "lens": spec((B,), i32)}
        specs: Dict[str, Any] = {}
        S_text = S
        if cfg.family == "encdec":
            specs["frames"] = spec((B, cfg.encoder.seq_len, cfg.d_model),
                                   emb_dt)
        elif cfg.family == "vlm":
            P = cfg.n_patch_tokens
            specs["patch_embeds"] = spec((B, P, cfg.d_model), emb_dt)
            S_text = S - P
        specs["tokens"] = spec((B, S_text), i32)
        if shape.kind == "train":
            specs["labels"] = spec((B, S_text), i32)
        return specs


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
