"""How ``correct`` is decided, once the window has closed.

The numbers, each against its limit (``bench/configs/<config>.json``,
``limits``, which names the ones a configuration compares):
- ``delivery_faults``: finished requests whose delivered tokens are not
  each there once and in order: as many ids as ``max_new_tokens``, as many
  host stamps, stamps that never go back, and the serve loop's delivered
  list equal to the request's own.  Limit 0.
- ``max_logit_gap``: over a sample of finished requests drawn from the
  seed (the one with the longest sequence always in it, then others until
  ``MIN_TOKENS`` served tokens), the plain reference runs once over each
  prompt with its served tokens, and at each served token reads how far
  that token's logit lies below the reference's best at that position.
  The widest such gap (``max_logit_gap``), or another statistic of the
  gaps (``gap_stats``), is compared.  Greedy decoding only: every mix here
  decodes greedily.

The control (``fp8=True``, tests and diagnostics only) reads, at the same
positions, the gap of the token that the float8 reference puts first.
"""
from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

MIN_TOKENS = 400


@dataclass
class Finished:
    """A finished request as the harness saw it."""
    req_id: int
    prompt: List[int]                # as generated, before any fold
    max_new_tokens: int
    delivered: List[int]             # the serve loop's outputs
    own: List[int]                   # the request's own output_tokens
    stamps: Sequence[float]


def delivery_faults(done: Sequence[Finished]) -> int:
    bad = 0
    for r in done:
        ok = (len(r.delivered) == r.max_new_tokens
              and len(r.stamps) == r.max_new_tokens
              and list(r.delivered) == list(r.own)
              and all(b >= a for a, b in zip(r.stamps, r.stamps[1:])))
        bad += not ok
    return bad


def sample(done: Sequence[Finished], seed: int,
           min_tokens: int = MIN_TOKENS) -> List[Finished]:
    """The longest finished sequence, then others in an order drawn from
    ``seed``, until ``min_tokens`` served tokens."""
    if not done:
        return []
    order = sorted(done, key=lambda r: r.req_id)
    longest = max(order, key=lambda r: (len(r.prompt) + len(r.delivered),
                                        -r.req_id))
    rest = [r for r in order if r is not longest]
    rng = np.random.default_rng([int(seed), 2])
    picked = [longest]
    n = len(longest.delivered)
    for i in rng.permutation(len(rest)):
        if n >= min_tokens:
            break
        picked.append(rest[i])
        n += len(rest[i].delivered)
    return picked


@torch.no_grad()
def logit_gaps(ref, config: Dict, stacks: Dict[str, torch.Tensor],
               picked: Sequence[Finished], control: bool = False):
    """(each served token's gap, each position's gap of the float8
    control's first choice or None), as float64 arrays."""
    gaps, ctl = [], []
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for r in picked:
            seq = list(r.prompt) + list(r.delivered[:-1])
            first = len(r.prompt) - 1
            lg = ref.logits(config, stacks, seq, first)
            served = torch.as_tensor(r.delivered, device=lg.device)
            best = lg.max(dim=-1).values
            gaps.append((best - lg.gather(1, served[:, None].long())[:, 0]).cpu())
            if control:
                pick = ref.logits(config, stacks, seq, first,
                                  fp8=True).argmax(dim=-1)
                ctl.append((best - lg.gather(1, pick[:, None])[:, 0]).cpu())
            del lg
            gc.collect()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev

    def cat(xs):
        return torch.cat(xs).double().numpy() if xs else np.zeros(0)
    return cat(gaps), (cat(ctl) if control else None)


def gap_stats(g: np.ndarray) -> Dict[str, float]:
    """The numbers a configuration may compare, from the gaps of its
    served tokens: the widest, the mean, and the share of tokens that were
    not the reference's first choice (gap above 0)."""
    if g.size == 0:
        return {"max_logit_gap": float("inf"), "mean_logit_gap": float("inf"),
                "mismatch_pct": 100.0}
    return {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
            "mismatch_pct": 100.0 * float((g > 0).mean())}


def checks(ref, config: Dict, stacks, done: Sequence[Finished], seed: int,
           control: bool = False) -> Dict[str, Dict]:
    """The numbers compared, each beside its limit, in print order: the
    configuration's ``limits`` name them.  With ``control`` the float8
    control's readings of the same numbers follow, marked ``control_``."""
    limits = config["limits"]
    picked = sample(done, seed)
    gaps, ctl = logit_gaps(ref, config, stacks, picked, control)
    stats = gap_stats(gaps)
    out = {"delivery_faults": {"value": delivery_faults(done),
                               "limit": limits["delivery_faults"]}}
    for k, v in stats.items():
        if k in limits:
            out[k] = {"value": v, "limit": limits[k]}
    out["tokens_compared"] = {"value": int(gaps.size), "limit": MIN_TOKENS}
    if ctl is not None:
        for k, v in gap_stats(ctl).items():
            out["control_" + k] = {"value": v, "limit": limits.get(k)}
        for k, v in stats.items():
            if k not in limits:
                out["unlimited_" + k] = {"value": v, "limit": None}
    return out


def passed(ch: Dict[str, Dict]) -> bool:
    """Every number within its limit: at most the limit, except the count
    of tokens compared, which has to reach it (a run that finished fewer
    served tokens compared too little to say).  The control's readings are
    not the run's."""
    for k, v in ch.items():
        if k.startswith(("control_", "unlimited_")):
            continue
        if k == "tokens_compared":
            if v["value"] < v["limit"]:
                return False
        elif not v["value"] <= v["limit"]:
            return False
    return True


def describe(ch: Dict[str, Dict]) -> List[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in ch.items()]


def from_requests(reqs, prompts: Dict[int, List[int]],
                  outputs: Dict[int, List[int]]) -> List[Finished]:
    """The finished requests of a serve, as ``Finished`` records."""
    from repro_torch.core.request import RequestState

    return [Finished(req_id=r.req_id, prompt=prompts[r.req_id],
                     max_new_tokens=r.max_new_tokens,
                     delivered=list(outputs.get(r.req_id, [])),
                     own=list(r.output_tokens), stamps=list(r.token_times))
            for r in reqs if r.state == RequestState.FINISHED]
