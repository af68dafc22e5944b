"""Finding a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
files are found from those names alone:
- ``bench/configs/<config>.json``: the model's published keys (as its
  ``config.json`` spells them), the serving stack it runs under
  (``serving``) and the plain reference that checks it (``reference``: a
  module of ``bench/reference/``);
- ``bench/traffic/<traffic>.json``: the parameters of the one generator
  (``traffic_gen.py``);
- ``bench/cells/<cell>.json``: what belongs to the pair, the offered rate;
- ``bench/metrics/<metric>.py``: one reader per per-layer metric.
A new cell, model, mix or metric is a new file: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # bench/configs/<config>.json
    traffic: Dict         # bench/traffic/<traffic>.json
    params: Dict          # bench/cells/<cell>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path = ROOT


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark by file path: names of configurations and
    metrics may hold '-' and '.', which an import statement does not take."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    params = load_json(root / "bench" / "cells" / f"{name}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        params=params,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root)


def metric_reader(name: str, root: Path = ROOT):
    return load_module(root / "bench" / "metrics" / f"{name}.py",
                       f"bench_metric_{name.replace('.', '_').replace('-', '_')}")


def reference_module(config: Dict, root: Path = ROOT):
    return load_module(root / "bench" / "reference" / f"{config['reference']}.py",
                       f"bench_reference_{config['reference']}")


def model_config(config: Dict):
    """The program's ``ModelConfig`` for a configuration file: every size
    from the published keys, the MoE dispatch from ``serving``.  The
    program sizes a dense residual beside the experts by ``d_ff``; Arctic's
    is ``hidden_size`` wide (``ArcticMLP(is_residual_mlp=True)`` in
    Snowflake's modeling code), the experts ``intermediate_size``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    serving = config["serving"]
    moe: Optional[MoEConfig] = None
    if config.get("num_local_experts"):
        moe = MoEConfig(
            n_experts=int(config["num_local_experts"]),
            top_k=int(config["num_experts_per_tok"]),
            d_ff=int(config["intermediate_size"]),
            capacity_factor=float(serving["moe_capacity_factor"]),
            dense_residual=bool(config.get("parallel_attn_mlp_res", False)),
            every=int(config.get("moe_layer_frequency", 1)))
    head_dim = config.get("head_dim") or (
        config["hidden_size"] // config["num_attention_heads"])
    return ModelConfig(
        name=config["name"], family="moe" if moe else "dense",
        n_layers=int(config["num_hidden_layers"]),
        d_model=int(config["hidden_size"]),
        n_heads=int(config["num_attention_heads"]),
        n_kv_heads=int(config["num_key_value_heads"]),
        d_ff=int(config["hidden_size"] if moe and moe.dense_residual
                 else config["intermediate_size"]),
        vocab_size=int(config["vocab_size"]),
        head_dim=int(head_dim),
        sliding_window=int(config.get("sliding_window") or 0),
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        tie_embeddings=bool(config.get("tie_word_embeddings", False)),
        moe=moe,
        moe_impl=serving.get("moe_impl", "scatter"),
        param_dtype=config["torch_dtype"], compute_dtype=config["torch_dtype"],
        max_seq_len=int(config["max_position_embeddings"]))
