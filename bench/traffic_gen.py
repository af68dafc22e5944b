"""The one traffic generator: turns a traffic file of parameters
(``bench/traffic/<name>.json``) and a cell's rate into the requests of one
run.

Open loop, independent users: every request has a due time, fixed before
the run starts, and is sent at that time whether or not earlier ones have
finished.  A run has two segments, the lead-in (``lead_in_s`` of the
traffic file, served but not counted) and the measured window
(``--seconds``).  Each segment holds ``round(rate * length)`` requests at
the points of a Poisson process conditioned on that count (uniform order
statistics).

Every seed gets the same work: the sizes and the due times of each
segment are one draw from the traffic file's own ``base_seed``; the run's
``--seed`` draws the prompt token ids (and the weights).  Runs on
different seeds then differ in content, not in work or in its order: a
seed that reordered the same requests moved a window's TTFT p95 by 13%
between seeds, against 1-6% between two runs of one seed, on a chat cell
at 9.6 req/s.  ``schedule_seed`` replaces ``base_seed`` for a held-out
schedule (``bench/run.py --schedule-seed``, a diagnostic): a change tuned
to the one draw shows there.

Length distributions (``prompt`` and ``output`` entries):
- ``{"dist": "lognormal", "p50": m, "p90": q}``: median ``m``, 90th
  percentile ``q`` (sigma = ln(q / m) / z_0.9);
- ``{"dist": "lognormal", "median": m, "sigma": s}``;
- ``{"dist": "uniform", "low": a, "high": b}``: integers, both ends in;
each rounded and clipped to ``[min, max]`` when those are given.  The chat
mix is a frozen copy of ``repro_torch.engine.workload.sharegpt_like`` (the
paper's ShareGPT fit: prompts P50 19 / P90 179.4, outputs median 60,
sigma 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

Z_90 = 1.2815515655446004      # standard normal 90th percentile


@dataclass
class Item:
    """One request of a run, before it reaches the program."""
    due_s: float                 # seconds after the serve clock's start
    prompt: List[int]
    max_new_tokens: int
    in_window: bool


def draw_lengths(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    dist = spec["dist"]
    if dist == "lognormal":
        if "p50" in spec:
            mu = math.log(spec["p50"])
            sigma = math.log(spec["p90"] / spec["p50"]) / Z_90
        else:
            mu, sigma = math.log(spec["median"]), spec["sigma"]
        x = np.round(rng.lognormal(mu, sigma, n))
    elif dist == "uniform":
        x = rng.integers(spec["low"], spec["high"] + 1, n).astype(np.float64)
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.clip(x, spec.get("min", 1), spec.get("max", np.inf)).astype(np.int64)


def _segment(traffic: Dict, rate: float, start: float, length: float,
             index: int, in_window: bool, schedule_seed: int):
    """(due times, prompt lengths, output lengths) of one segment."""
    n = max(1, int(round(rate * length)))
    base = np.random.default_rng([schedule_seed, index, n])
    due = start + np.sort(base.uniform(0.0, length, n))
    prompts = draw_lengths(traffic["prompt"], n, base)
    outputs = draw_lengths(traffic["output"], n, base)
    return due, prompts, outputs, [in_window] * n


def generate(traffic: Dict, rate: float, seconds: float, seed: int,
             vocab_size: int, schedule_seed: Optional[int] = None) -> List[Item]:
    """The run's requests in due order: the lead-in's, then the window's."""
    ids = np.random.default_rng([int(seed), 1])
    lead = float(traffic["lead_in_s"])
    sched = int(traffic["base_seed"] if schedule_seed is None else schedule_seed)
    segs = [_segment(traffic, rate, 0.0, lead, 0, False, sched),
            _segment(traffic, rate, lead, float(seconds), 1, True, sched)]
    items: List[Item] = []
    for due, prompts, outputs, flags in segs:
        for d, p, o, w in zip(due, prompts, outputs, flags):
            limit = traffic["max_context"] - int(o)
            p = int(min(p, limit))
            items.append(Item(
                due_s=float(d),
                prompt=ids.integers(1, vocab_size, p).tolist(),
                max_new_tokens=int(o), in_window=w))
    return items
