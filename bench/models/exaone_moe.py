"""The K-EXAONE form (LG AI Research's ``exaone_moe``): a decoder whose
layers differ in kind.  Each layer's attention is a sliding window
(``layer_types`` "sliding_attention", ``sliding_windows``: RoPE, the last W
positions) or global ("full_attention": full causal, no positional
encoding); q and k take an RMSNorm over the head dimension before RoPE;
each branch is normed on its output (``x + norm(attn(x))``, ``x +
norm(ffn(x))``); the FFN is dense SwiGLU (``mlp_layer_types`` "dense") or
experts (DeepSeek-V3's router: sigmoid scores, top-k chosen on scores plus
a selection bias, the chosen scores renormalised and scaled by
``routed_scaling_factor``) beside a shared expert.  Only the experts held
here are drawn (``num_experts`` of the router's ``published`` count, from
``first_held_expert``): choices of the others are dropped, as on one chip
of an expert-parallel deployment.  ``bench/reference/exaone_moe.py`` is its
plain reference.

What a model module provides: ``bench/models/transformer.py``'s list, and
``window_launches``, the sliding-window layers' launches of a round.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench.flops.model import BF16, dims

SLIDING, FULL = "sliding_attention", "full_attention"
# the selection bias's draw: N(0, 1) x this.  The checkpoint's bias is
# learned and not in the configuration; this scale moves some top-8
# choices among the sigmoid scores' spread (assumed, PERF.md)
BIAS_SCALE = 0.1


def _layers(config: Dict):
    """(window, sparse) of each of the first ``num_hidden_layers`` layers."""
    L = config["num_hidden_layers"]
    out = []
    for l in range(L):
        kind, W = config["layer_types"][l], config["sliding_windows"][l]
        if (kind == SLIDING) != (W > 0) or kind not in (SLIDING, FULL):
            raise ValueError(f"{config['name']}: layer {l} is {kind!r} with "
                             f"window {W}")
        out.append((W if kind == SLIDING else 0,
                    config["mlp_layer_types"][l] == "sparse"))
    return out


def experts_routed(config: Dict) -> int:
    """The router's width: the published expert count."""
    return int(config.get("published", {}).get("num_experts",
                                                config["num_experts"]))


def program_config(config: Dict):
    """The program's ``LayeredModelConfig``: each layer's window, RoPE
    (sliding layers only) and FFN kind, QK-norm, post-norm, and the routed
    experts' ``RoutedMoEConfig`` with the share held here.  Refuses a
    grouped router (``n_group`` > 1) and unnormalised top-k weights
    (``norm_topk_prob`` false), which the program does not compute."""
    from repro_torch.configs.base import LayeredModelConfig, RoutedMoEConfig

    if config["n_group"] != 1 or config["topk_group"] != 1:
        raise ValueError(f"{config['name']}: grouped routing "
                         f"(n_group {config['n_group']}) is not computed")
    if not config["norm_topk_prob"]:
        raise ValueError(f"{config['name']}: unnormalised top-k weights "
                         "(norm_topk_prob false) are not computed")
    if config["hidden_act"] != "silu":
        raise ValueError(f"{config['name']}: {config['hidden_act']!r}")
    layers = _layers(config)
    serving = config["serving"]
    Fe = int(config["moe_intermediate_size"])
    moe = RoutedMoEConfig(
        n_experts=experts_routed(config),
        top_k=int(config["num_experts_per_tok"]), d_ff=Fe,
        capacity_factor=float(serving["moe_capacity_factor"]),
        scoring=config["scoring_func"],
        routed_scale=float(config["routed_scaling_factor"]),
        n_shared=int(config["num_shared_experts"]),
        shared_d_ff=int(config["num_shared_experts"]) * Fe,
        first_held=int(config.get("first_held_expert", 0)),
        n_held=int(config["num_experts"]))
    _, Hq, Hkv, hd = dims(config)
    return LayeredModelConfig(
        name=config["name"], family="moe",
        n_layers=int(config["num_hidden_layers"]),
        d_model=int(config["hidden_size"]),
        n_heads=int(Hq), n_kv_heads=int(Hkv),
        d_ff=int(config["intermediate_size"]),
        vocab_size=int(config["vocab_size"]),
        head_dim=int(hd),
        rope_theta=float(config["rope_parameters"]["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        tie_embeddings=bool(config.get("tie_word_embeddings", False)),
        moe=moe,
        moe_impl=serving.get("moe_impl", "scatter"),
        param_dtype=config["torch_dtype"], compute_dtype=config["torch_dtype"],
        max_seq_len=int(config["max_position_embeddings"]),
        layer_windows=tuple(W for W, _ in layers),
        layer_rope=tuple(W > 0 for W, _ in layers),
        layer_sparse=tuple(sp for _, sp in layers),
        qk_norm=True, post_norm=True)


def draws(config: Dict, mcfg) -> List[Tuple[str, Tuple[int, ...], float, torch.dtype]]:
    """Every layer's attention (``wq`` ``(D, Hq, hd)``, ``wk``/``wv``
    ``(D, Hkv, hd)``, ``wo`` ``(Hq, hd, D)``), q/k norms ``(hd,)`` and post
    norms ``(D,)``, stacked over all layers; the dense layers' SwiGLU over
    the dense layers; over the sparse layers the router ``(D, E)`` and its
    selection bias ``(E,)`` in float32, the held experts ``(Eh, D, Fe)`` /
    ``(Eh, Fe, D)`` and the shared expert ``(D, Fs)`` / ``(Fs, D)``; the
    unembedding.  Scales: 1/sqrt(fan-in) for every projection, 0.02 for the
    embedding, ``BIAS_SCALE`` for the bias, 0 for a norm."""
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[mcfg.param_dtype]
    L, D, V = mcfg.n_layers, mcfg.d_model, mcfg.vocab_size
    Hq, Hkv, hd = mcfg.n_heads, mcfg.n_kv_heads, mcfg.resolved_head_dim
    Ls = sum(mcfg.layer_sparse)
    Ld = L - Ls
    s = [("embed", (V, D), 0.02, dt),
         ("wq", (L, D, Hq, hd), 1 / math.sqrt(D), dt),
         ("wk", (L, D, Hkv, hd), 1 / math.sqrt(D), dt),
         ("wv", (L, D, Hkv, hd), 1 / math.sqrt(D), dt),
         ("wo", (L, Hq, hd, D), 1 / math.sqrt(Hq * hd), dt),
         ("q_norm", (L, hd), 0.0, dt),
         ("k_norm", (L, hd), 0.0, dt),
         ("post_attn_norm", (L, D), 0.0, dt),
         ("post_ffn_norm", (L, D), 0.0, dt)]
    if Ld:
        F = mcfg.d_ff
        s += [("w_gate", (Ld, D, F), 1 / math.sqrt(D), dt),
              ("w_up", (Ld, D, F), 1 / math.sqrt(D), dt),
              ("w_down", (Ld, F, D), 1 / math.sqrt(F), dt)]
    if Ls:
        m = mcfg.moe
        E, Eh, Fe, Fs = m.n_experts, m.held, m.d_ff, m.shared_d_ff
        s += [("router", (Ls, D, E), 1 / math.sqrt(D), torch.float32),
              ("router_bias", (Ls, E), BIAS_SCALE, torch.float32),
              ("e_gate", (Ls, Eh, D, Fe), 1 / math.sqrt(D), dt),
              ("e_up", (Ls, Eh, D, Fe), 1 / math.sqrt(D), dt),
              ("e_down", (Ls, Eh, Fe, D), 1 / math.sqrt(Fe), dt),
              ("s_gate", (Ls, D, Fs), 1 / math.sqrt(D), dt),
              ("s_up", (Ls, D, Fs), 1 / math.sqrt(D), dt),
              ("s_down", (Ls, Fs, D), 1 / math.sqrt(Fs), dt)]
    s += [("final_norm", (D,), 0.0, dt),
          ("lm_head", (D, V), 1 / math.sqrt(D), dt)]
    return s


def as_params(mcfg, stacks: Dict[str, torch.Tensor]) -> Dict:
    """``TransformerLM``'s parameter dict over views of the stacks."""
    layers, i_dense, i_sparse = [], 0, 0
    for l in range(mcfg.n_layers):
        attn = {k: stacks[k][l] for k in ("wq", "wk", "wv", "wo", "q_norm",
                                          "k_norm")}
        p = {"attn": attn, "post_attn_norm": stacks["post_attn_norm"][l],
             "post_ffn_norm": stacks["post_ffn_norm"][l]}
        if mcfg.sparse(l):
            i = i_sparse
            p["moe"] = {"router": stacks["router"][i],
                        "router_bias": stacks["router_bias"][i],
                        "w_gate": stacks["e_gate"][i],
                        "w_up": stacks["e_up"][i],
                        "w_down": stacks["e_down"][i],
                        "shared": {"w_gate": stacks["s_gate"][i],
                                   "w_up": stacks["s_up"][i],
                                   "w_down": stacks["s_down"][i]}}
            i_sparse += 1
        else:
            p["ffn"] = {k: stacks[k][i_dense]
                        for k in ("w_gate", "w_up", "w_down")}
            i_dense += 1
        layers.append(p)
    return {"embed": stacks["embed"], "layers": layers,
            "final_norm": stacks["final_norm"], "lm_head": stacks["lm_head"]}


def active_params(config: Dict) -> int:
    """Parameters one token multiplies, outside the embedding and the
    unembedding: per layer the attention projections, then the dense
    SwiGLU, or the router, the routed experts at the share held here
    (``num_experts_per_tok`` x held / routed, each ``3 D Fe``) and the
    shared experts."""
    D, Hq, Hkv, hd = dims(config)
    attn = D * Hq * hd + 2 * D * Hkv * hd + Hq * hd * D
    E, Fe = experts_routed(config), config["moe_intermediate_size"]
    held_share = config["num_experts"] / E
    n = 0
    for _, sparse in _layers(config):
        n += attn
        if sparse:
            n += (D * E + config["num_experts_per_tok"] * held_share * 3 * D * Fe
                  + config["num_shared_experts"] * 3 * D * Fe)
        else:
            n += 3 * D * config["intermediate_size"]
    return int(n)


def _window_keys(rows, W: int) -> int:
    """Sum over every new token of the keys it attends to within the last
    ``W`` positions (``bench/flops/model.py``'s ``keys`` with a window)."""
    total = 0
    for c, n in rows:
        # token i sees min(c + i + 1, W) keys: those below the window's
        # fill in full, the rest W each
        full = max(0, min(n, W - c))                   # c + i + 1 <= W
        total += full * c + full * (full + 1) // 2 + (n - full) * W
    return total


def _window_rows(rows, W: int) -> int:
    """K/V rows a window of ``W`` reads: each row's queries' windows cover
    ``min(c + n, W + n - 1)`` keys."""
    return sum(min(c + n, W + n - 1) for c, n in rows)


def launch_cost(config: Dict, rows, W: int) -> Tuple[float, float]:
    """(operations, bytes) of ONE attention launch over ``rows`` with the
    window ``W`` (0: full causal), as ``bench/flops/model.py``'s
    ``attention_cost`` counts them: each K and V row the window reads once,
    each query and output once, in bf16; 2 * hd operations per query-key
    pair and head, each for QK^T and PV."""
    _, Hq, Hkv, hd = dims(config)
    if W:
        keys, kv_rows = _window_keys(rows, W), _window_rows(rows, W)
    else:
        keys = sum(n * c + n * (n + 1) // 2 for c, n in rows)
        kv_rows = sum(c + n for c, n in rows)
    qo = sum(n for _, n in rows) * 2 * Hq * hd * BF16
    return 4.0 * Hq * hd * keys, float(kv_rows * 2 * Hkv * hd * BF16 + qo)


def step_flops(config: Dict, rows, n_sampled: int) -> float:
    """Useful model operations of one round: 2 x active parameters per real
    token, attention 4 * Hq * hd per query and key it sees (a sliding
    layer's within its window), and the unembedding of the rows that
    sample."""
    D, V = config["hidden_size"], config["vocab_size"]
    tokens = sum(n for _, n in rows)
    attn = sum(launch_cost(config, rows, W)[0] for W, _ in _layers(config))
    return 2.0 * active_params(config) * tokens + attn + 2.0 * D * V * n_sampled


def attention_launches(config: Dict, rows) -> List[Tuple[float, float]]:
    """Every layer launches the attention kernel once over every row: a
    sliding layer's launch over the keys within its window, a global
    layer's over every key."""
    return [launch_cost(config, rows, W) for W, _ in _layers(config)]


def window_launches(config: Dict, rows) -> List[Tuple[float, float]]:
    """The sliding-window layers' launches of a round over ``rows``: the
    windowed kernel's (``window_attn_roofline``)."""
    return [launch_cost(config, rows, W) for W, _ in _layers(config) if W]
