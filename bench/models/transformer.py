"""The Mixtral / Arctic form: a decoder-only transformer whose every layer
is full causal GQA attention and then a dense SwiGLU FFN, or experts
(softmax top-k, renormalised) with, as Arctic's, a dense residual beside
them.  ``bench/reference/transformer.py`` is its plain reference.

What the harness asks of a model module (``bench/cell.py``):
- ``program_config(config)``: the program's ``ModelConfig``;
- ``draws(config, mcfg)``: every weight stack as ``(name, stacked shape,
  scale, dtype)``, in draw order (``bench/weights.py`` draws them);
- ``as_params(mcfg, stacks)``: the program's parameter dict over views of
  the stacks;
- ``active_params(config)``, ``step_flops(config, rows, n_sampled)``: the
  model step's arithmetic (``bench/flops/model.py``);
- ``attention_launches(config, rows)``: one ``(operations, bytes)`` pair
  for each launch of the attention kernel in a round over ``rows``.

A configuration of another form names its own module (``"model"``) and
brings its own reference (``"reference"``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from bench.flops.model import attention_cost, dims, keys


def program_config(config: Dict):
    """The program's ``ModelConfig`` for a configuration file: every size
    from the published keys, the MoE dispatch from ``serving``.  The
    program sizes a dense residual beside the experts by ``d_ff``; Arctic's
    is ``hidden_size`` wide (``ArcticMLP(is_residual_mlp=True)`` in
    Snowflake's modeling code), the experts ``intermediate_size``.

    Refuses what neither the engine's path nor the reference computes: a
    window (the engine asserts full attention; the reference would ignore
    it) and experts on only some layers (these draws and the reference
    put them on every layer)."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    if config.get("sliding_window") is not None:
        raise ValueError(f"{config['name']}: sliding_window "
                         f"{config['sliding_window']!r}: the transformer "
                         "model module computes full attention only")
    if config.get("moe_layer_frequency", 1) != 1:
        raise ValueError(f"{config['name']}: moe_layer_frequency "
                         f"{config['moe_layer_frequency']!r}: the transformer "
                         "model module puts experts on every layer")
    serving = config["serving"]
    moe: Optional[MoEConfig] = None
    if config.get("num_local_experts"):
        moe = MoEConfig(
            n_experts=int(config["num_local_experts"]),
            top_k=int(config["num_experts_per_tok"]),
            d_ff=int(config["intermediate_size"]),
            capacity_factor=float(serving["moe_capacity_factor"]),
            dense_residual=bool(config.get("parallel_attn_mlp_res", False)))
    _, Hq, Hkv, hd = dims(config)
    return ModelConfig(
        name=config["name"], family="moe" if moe else "dense",
        n_layers=int(config["num_hidden_layers"]),
        d_model=int(config["hidden_size"]),
        n_heads=int(Hq), n_kv_heads=int(Hkv),
        d_ff=int(config["hidden_size"] if moe and moe.dense_residual
                 else config["intermediate_size"]),
        vocab_size=int(config["vocab_size"]),
        head_dim=int(hd),
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        tie_embeddings=bool(config.get("tie_word_embeddings", False)),
        moe=moe,
        moe_impl=serving.get("moe_impl", "scatter"),
        param_dtype=config["torch_dtype"], compute_dtype=config["torch_dtype"],
        max_seq_len=int(config["max_position_embeddings"]))


def draws(config: Dict, mcfg) -> List[Tuple[str, Tuple[int, ...], float, torch.dtype]]:
    """``TransformerLM``'s tensors stacked over the layers: ``wq``
    ``(D, Hq, hd)``, ``wk``/``wv`` ``(D, Hkv, hd)``, ``wo`` ``(Hq, hd, D)``,
    FFN ``(D, F)``/``(F, D)``, experts ``(E, D, Fe)``/``(E, Fe, D)``, the
    router ``(D, E)`` in float32, the unembedding ``(D, V)``.  Scales:
    1/sqrt(fan-in) for every projection, 0.02 for the embedding, 0 for a
    norm."""
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[mcfg.param_dtype]
    L, D, V = mcfg.n_layers, mcfg.d_model, mcfg.vocab_size
    Hq, Hkv, hd = mcfg.n_heads, mcfg.n_kv_heads, mcfg.resolved_head_dim
    s = [("embed", (V, D), 0.02, dt),
         ("attn_norm", (L, D), 0.0, dt),
         ("wq", (L, D, Hq, hd), 1 / math.sqrt(D), dt),
         ("wk", (L, D, Hkv, hd), 1 / math.sqrt(D), dt),
         ("wv", (L, D, Hkv, hd), 1 / math.sqrt(D), dt),
         ("wo", (L, Hq, hd, D), 1 / math.sqrt(Hq * hd), dt),
         ("ffn_norm", (L, D), 0.0, dt)]
    moe = mcfg.moe
    if moe is None or moe.dense_residual:
        F = mcfg.d_ff
        s += [("w_gate", (L, D, F), 1 / math.sqrt(D), dt),
              ("w_up", (L, D, F), 1 / math.sqrt(D), dt),
              ("w_down", (L, F, D), 1 / math.sqrt(F), dt)]
    if moe is not None:
        E, Fe = moe.n_experts, moe.d_ff
        s += [("router", (L, D, E), 1 / math.sqrt(D), torch.float32),
              ("e_gate", (L, E, D, Fe), 1 / math.sqrt(D), dt),
              ("e_up", (L, E, D, Fe), 1 / math.sqrt(D), dt),
              ("e_down", (L, E, Fe, D), 1 / math.sqrt(Fe), dt)]
    s += [("final_norm", (D,), 0.0, dt),
          ("lm_head", (D, V), 1 / math.sqrt(D), dt)]
    return s


def as_params(mcfg, stacks: Dict[str, torch.Tensor]) -> Dict:
    """``TransformerLM``'s parameter dict over views of the stacks."""
    layers = []
    for l in range(mcfg.n_layers):
        p = {"attn_norm": stacks["attn_norm"][l],
             "attn": {k: stacks[k][l] for k in ("wq", "wk", "wv", "wo")},
             "ffn_norm": stacks["ffn_norm"][l]}
        if "w_gate" in stacks:
            p["ffn"] = {k: stacks[k][l] for k in ("w_gate", "w_up", "w_down")}
        if "router" in stacks:
            p["moe"] = {"router": stacks["router"][l],
                        "w_gate": stacks["e_gate"][l],
                        "w_up": stacks["e_up"][l],
                        "w_down": stacks["e_down"][l]}
        layers.append(p)
    return {"embed": stacks["embed"], "layers": layers,
            "final_norm": stacks["final_norm"], "lm_head": stacks["lm_head"]}


def active_params(config: Dict) -> int:
    """Parameters one token multiplies, outside the embedding and the
    unembedding: per layer the attention projections, then the dense FFN,
    or the router, ``num_experts_per_tok`` experts and the dense residual
    (``hidden_size`` wide, as Arctic's)."""
    D, Hq, Hkv, hd = dims(config)
    F = config["intermediate_size"]
    attn = D * Hq * hd + 2 * D * Hkv * hd + Hq * hd * D
    if config.get("num_local_experts"):
        ffn = (D * config["num_local_experts"]
               + config["num_experts_per_tok"] * 3 * D * F)
        if config.get("parallel_attn_mlp_res"):
            ffn += 3 * D * D
    else:
        ffn = 3 * D * F
    return config["num_hidden_layers"] * (attn + ffn)


def step_flops(config: Dict, rows, n_sampled: int) -> float:
    """Useful model operations of one round: 2 x active parameters per real
    token, causal attention 4 * L * Hq * hd per query and key, and the
    unembedding of the rows that sample."""
    D, Hq, _, hd = dims(config)
    L, V = config["num_hidden_layers"], config["vocab_size"]
    tokens = sum(n for _, n in rows)
    return (2.0 * active_params(config) * tokens
            + 4.0 * L * Hq * hd * keys(rows)
            + 2.0 * D * V * n_sampled)


def attention_launches(config: Dict, rows) -> List[Tuple[float, float]]:
    """Every layer launches the attention kernel once over every row, with
    full causal attention: ``num_hidden_layers`` equal pairs."""
    return [attention_cost(config, rows)] * config["num_hidden_layers"]
