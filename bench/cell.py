"""Finding a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
files are found from those names alone:
- ``bench/configs/<config>.json``: the model's published keys (as its
  ``config.json`` spells them), the serving stack it runs under
  (``serving``), the model module that maps those keys onto the program
  (``model``: a module of ``bench/models/``, ``transformer`` when the key
  is absent) and the plain reference that checks it (``reference``: a
  module of ``bench/reference/``);
- ``bench/models/<model>.py``: the program's ``ModelConfig``, the weights'
  draws and parameter dict, the operations and the attention kernel's
  launches of one form of model (``bench/models/transformer.py`` lists
  what a module provides);
- ``bench/traffic/<traffic>.json``: the parameters of the one generator
  (``traffic_gen.py``);
- ``bench/cells/<cell>.json``: what belongs to the pair, the offered rate;
- ``bench/metrics/<metric>.py``: one reader per per-layer metric.
A new cell, model, mix or metric is a new file: nothing here changes.
A model of a form the benchmark has not seen adds its configuration, its
model module and its reference; ``weights.py``, ``flops/model.py`` and
the readers ask the module, and ``bench/tests`` runs such a model made of
added files only (``tiny-qkvbias``).
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

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


def model_name(config: Dict) -> str:
    return config.get("model", "transformer")


def model_module(config: Dict, root: Path = ROOT):
    name = model_name(config)
    return load_module(root / "bench" / "models" / f"{name}.py",
                       f"bench_model_{name.replace('.', '_').replace('-', '_')}")


def model_config(config: Dict, root: Path = ROOT):
    """The program's ``ModelConfig`` for a configuration file, as its
    model module maps the published keys."""
    return model_module(config, root).program_config(config)
