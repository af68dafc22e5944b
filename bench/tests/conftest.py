"""Fixtures of the benchmark's own tests (``python -m pytest bench/tests``;
the repository's ``testpaths`` does not collect them).

``tiny_root`` is a copy of the benchmark with two tiny configurations
(dense, and experts with a dense residual) and a short chat-like mix, so
that a whole run fits on the CPU in seconds.  Tests marked ``card`` need a
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
TINY_TRAFFIC = {
    "lead_in_s": 0.5, "base_seed": 7,
    "prompt": {"dist": "lognormal", "p50": 8.0, "p90": 40.0, "min": 1, "max": 64},
    "output": {"dist": "lognormal", "median": 12.0, "sigma": 0.5, "min": 1, "max": 32},
    "max_context": 320,
}


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
    for name, cfg in (("tiny-dense", TINY), ("tiny-moe", TINY_MOE)):
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
            m["workloads"] += ["tiny-dense.tiny", "tiny-moe.tiny"]
    (tmp / "bench/traffic/tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
