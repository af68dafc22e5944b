"""Fixtures of the benchmark's own tests (``python -m pytest bench/tests``;
the repository's ``testpaths`` does not collect them).

``tiny_root`` is a copy of the benchmark with three tiny configurations
(dense; experts with a dense residual; dense with biases on q, k and v,
whose model module and reference are files added beside the benchmark's)
and a short chat-like mix, so that a whole run fits on the CPU in
seconds.  Tests marked ``card`` need a
CUDA device and skip without one (decided inside the test)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 512, "rope_theta": 10000.0, "rms_norm_eps": 1e-05,
    "sliding_window": None, "max_position_embeddings": 4096,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "reduced": [], "reference": "transformer",
    "limits": {"delivery_faults": 0, "max_logit_gap": 0.25},
}
TINY_MOE = dict(TINY, num_local_experts=8, num_experts_per_tok=2,
                moe_layer_frequency=1, parallel_attn_mlp_res=True)
TINY_QKVBIAS = dict(TINY, attention_bias=True, model="qkvbias",
                    reference="qkvbias")

# the model module and the plain reference of ``tiny-qkvbias``: a form the
# benchmark's own files do not draw (``ModelConfig.qkv_bias``), added as
# files that build on the transformer's
QKVBIAS_MODEL = '''"""The transformer form with a bias on each of q, k and v
(``attention_bias``), drawn non-zero."""
import dataclasses
from pathlib import Path

from bench import cell as cells

base = cells.load_module(Path(__file__).with_name("transformer.py"),
                         "bench_model_transformer_under_qkvbias")
active_params = base.active_params
step_flops = base.step_flops
attention_launches = base.attention_launches


def program_config(config):
    return dataclasses.replace(base.program_config(config),
                               qkv_bias=bool(config["attention_bias"]))


def draws(config, mcfg):
    s = base.draws(config, mcfg)
    if config["attention_bias"]:
        L, hd, dt = mcfg.n_layers, mcfg.resolved_head_dim, s[0][3]
        s += [("bq", (L, mcfg.n_heads, hd), 0.5, dt),
              ("bk", (L, mcfg.n_kv_heads, hd), 0.5, dt),
              ("bv", (L, mcfg.n_kv_heads, hd), 0.5, dt)]
    return s


def as_params(mcfg, stacks):
    p = base.as_params(mcfg, stacks)
    if mcfg.qkv_bias:
        for l, lp in enumerate(p["layers"]):
            lp["attn"].update({k: stacks[k][l] for k in ("bq", "bk", "bv")})
    return p
'''

QKVBIAS_REFERENCE = '''"""Plain reference of the transformer form with biases on q, k and v:
``transformer.py``'s equations, each of q, k and v plus its bias before
the rotary embedding."""
from pathlib import Path

import torch

from bench import cell as cells

base = cells.load_module(Path(__file__).with_name("transformer.py"),
                         "bench_reference_transformer_under_qkvbias")


def logits(config, stacks, tokens, first, fp8=False):
    lin = base.Linear(fp8)
    dev = stacks["embed"].device
    D = config["hidden_size"]
    Hq, Hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or D // Hq
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    pos = torch.arange(len(tokens), device=dev)
    x = stacks["embed"][tok].float()
    for l in range(config["num_hidden_layers"]):
        h = base.rmsnorm(x, stacks["attn_norm"][l], eps)
        q, k, v = (lin(h, stacks[w][l].reshape(D, -1)).view(-1, n, hd)
                   + stacks[b][l].float()
                   for w, b, n in (("wq", "bq", Hq), ("wk", "bk", Hkv),
                                   ("wv", "bv", Hkv)))
        a = base.attention(base.rope(q, pos, theta), base.rope(k, pos, theta), v)
        x = x + lin(a, stacks["wo"][l].reshape(Hq * hd, D))
        h = base.rmsnorm(x, stacks["ffn_norm"][l], eps)
        x = x + base.swiglu(lin, h, stacks["w_gate"][l], stacks["w_up"][l],
                            stacks["w_down"][l])
    x = base.rmsnorm(x[first:], stacks["final_norm"], eps)
    return lin(x, stacks["lm_head"])
'''

TINY_TRAFFIC = {
    "lead_in_s": 0.5, "base_seed": 7,
    "prompt": {"dist": "lognormal", "p50": 8.0, "p90": 40.0, "min": 1, "max": 64},
    "output": {"dist": "lognormal", "median": 12.0, "sigma": 0.5, "min": 1, "max": 32},
    "max_context": 320,
}


TINY_CONFIGS = {"tiny-dense": TINY, "tiny-moe": TINY_MOE,
                "tiny-qkvbias": TINY_QKVBIAS}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


def serving(ref: dict, **kw) -> dict:
    sv = dict(json.loads((ROOT / "bench/configs/arctic-1l.json").read_text())["serving"])
    sv.update(n_slots=4, chunk_buckets=[1, 16, 32, 64, 128], token_budget=32,
              moe_impl="scatter", moe_capacity_factor=4.0)
    sv.update(kw)
    return sv


def make_root(tmp: Path, rate: float = 12.0) -> Path:
    """A checkout-like directory: the benchmark's files plus tiny cells."""
    shutil.copytree(ROOT / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "bench/models/qkvbias.py").write_text(QKVBIAS_MODEL)
    (tmp / "bench/reference/qkvbias.py").write_text(QKVBIAS_REFERENCE)
    for name, cfg in TINY_CONFIGS.items():
        c = dict(cfg, name=name, serving=serving(cfg))
        (tmp / f"bench/configs/{name}.json").write_text(json.dumps(c))
        bench["configs"].append({"name": name, "source": "test", "reduced": [],
                                 "file": f"bench/configs/{name}.json", "why": "test"})
        bench["workloads"].append({"name": f"{name}.tiny", "config": name,
                                   "traffic": "tiny", "chips": 1, "why": "test"})
        (tmp / f"bench/cells/{name}.tiny.json").write_text(
            json.dumps({"rate_per_s": rate}))
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [f"{name}.tiny" for name in TINY_CONFIGS]
    (tmp / "bench/traffic/tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
