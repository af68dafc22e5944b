"""End-to-end metrics of one measured window, from the host-visible token
stamps alone (``Request.token_times``: when a token's id reached the host,
at drain), on the serve clock (seconds since the run's start).

The window is ``[t0, t1)``.  Every request is timed from when it was due,
not from when the loop took it.  Censoring: a request due in the window
with no token by ``t1`` enters the TTFT tail with its age at ``t1``; a
member of the E2E cohort (due in the window's first half) that has not
finished by ``t1`` enters with its age at ``t1``.  So a stall cannot hide.

The percentile is ``repro_torch.engine.metrics.percentiles``'s arithmetic
(numpy's linear interpolation), copied here so the yardstick cannot move
with the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np


@dataclass
class Served:
    """What the window needs of one request."""
    due: float
    max_new_tokens: int
    stamps: Sequence[float]       # token_times, in delivery order


def percentile(xs: Sequence[float], p: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), p))


def _done_at(r: Served, t1: float):
    """The last stamp, if every token arrived by ``t1``; else None."""
    if len(r.stamps) >= r.max_new_tokens and r.stamps[-1] <= t1:
        return r.stamps[-1]
    return None


def out_tokens(reqs: Sequence[Served], t0: float, t1: float) -> int:
    return sum(1 for r in reqs for s in r.stamps if t0 <= s < t1)


def ttft_samples(reqs: Sequence[Served], t0: float, t1: float) -> List[float]:
    out = []
    for r in reqs:
        if t0 <= r.due < t1:
            first = r.stamps[0] if r.stamps and r.stamps[0] < t1 else t1
            out.append(first - r.due)
    return out


def itl_samples(reqs: Sequence[Served], t0: float, t1: float) -> List[float]:
    """Every gap between consecutive stamps of one request whose later
    stamp lies in the window."""
    out = []
    for r in reqs:
        s = r.stamps
        out.extend(s[i] - s[i - 1] for i in range(1, len(s))
                   if t0 <= s[i] < t1)
    return out


def e2e_samples(reqs: Sequence[Served], t0: float, t1: float) -> List[float]:
    half = t0 + (t1 - t0) / 2
    out = []
    for r in reqs:
        if t0 <= r.due < half:
            done = _done_at(r, t1)
            out.append((done if done is not None else t1) - r.due)
    return out


def compute(reqs: Sequence[Served], t0: float, t1: float) -> Dict[str, float]:
    """The cell's end-to-end metrics other than ``setup_s``, in their units
    (tokens/s and ms)."""
    ttft = ttft_samples(reqs, t0, t1)
    itl = itl_samples(reqs, t0, t1)
    e2e = e2e_samples(reqs, t0, t1)
    return {
        "out_tok_s": out_tokens(reqs, t0, t1) / (t1 - t0),
        "ttft_p95_ms": percentile(ttft, 95) * 1e3 if ttft else float("nan"),
        "itl_p95_ms": percentile(itl, 95) * 1e3 if itl else float("nan"),
        "e2e_p90_ms": percentile(e2e, 90) * 1e3 if e2e else float("nan"),
    }


def sample_counts(reqs: Sequence[Served], t0: float, t1: float) -> Dict[str, int]:
    return {"ttft": len(ttft_samples(reqs, t0, t1)),
            "itl": len(itl_samples(reqs, t0, t1)),
            "e2e": len(e2e_samples(reqs, t0, t1))}
