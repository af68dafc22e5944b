"""The model's weights, made by the benchmark from ``--seed`` on the device.

One generator on the device and one draw per kind of tensor, stacked over
the layers, in the dtype the model is served in; each layer's tensors are
views of those stacks.  The program (``TorchEngine(params=...)``) and the
plain reference get these same tensors.  ``out`` refills an existing set in
place, in the same order of draws (a dozen seeds in one process, behind
the same captured graphs).

The layout is ``repro_torch``'s ``TransformerLM`` parameter dict: ``wq``
``(D, Hq, hd)``, ``wk``/``wv`` ``(D, Hkv, hd)``, ``wo`` ``(Hq, hd, D)``,
FFN ``(D, F)``/``(F, D)``, experts ``(E, D, Fe)``/``(E, Fe, D)``, the router
``(D, E)`` in float32, the unembedding ``(D, V)``.  Scales: 1/sqrt(fan-in)
for every projection, 0.02 for the embedding, norms 1 + N(0, 0.05^2) (not
all ones, so that a norm weight that is read wrongly shows).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch


def _shapes(mcfg) -> List[Tuple[str, Tuple[int, ...], float, torch.dtype]]:
    """(name, stacked shape, scale, dtype) of every draw, in draw order;
    scale 0 marks a norm (1 + 0.05 N(0, 1))."""
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


def make_stacks(mcfg, seed: int, device,
                out: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """Every stack drawn from ``seed``; into ``out``'s tensors when given."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    stacks = {} if out is None else out
    for name, shape, scale, dtype in _shapes(mcfg):
        t = stacks.get(name)
        if t is None:
            t = torch.empty(shape, dtype=dtype, device=dev)
            stacks[name] = t
        t.normal_(0.0, 1.0, generator=gen)
        if scale:
            t.mul_(scale)
        else:
            t.mul_(0.05).add_(1.0)
    return stacks


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
