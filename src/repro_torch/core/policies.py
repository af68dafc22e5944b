"""Prefill-ordering policies: FCFS, shortest-prefill-first, and the paper's
Aging weighted-fair policy (§3.1).

Aging priority:  P_i(n) = alpha * (t - a_i) + beta * r_i(n),  alpha>0, beta<0.
Since alpha*t is round-constant, ordering is maintained with the static key
K_i(n) = -alpha * a_i + beta * r_i(n)  (Eq. 4) in a max-heap; an update after
a chunk touches only that request:  O(k log n) per round (§3.1.4).

All policies share the heap implementation (FCFS: K = -a_i; SJF: K = -r_i),
differing only in the key function — which makes the O(k log n) overhead
claim directly measurable against a naive full-recompute implementation
(benchmarks/bench_overhead.py).
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Iterable, List, Optional

from repro_torch.core.request import Request


class PrefillQueue:
    """Max-heap over a request key; supports O(log n) add / pop / update.

    Entries are (-key, tiebreak, req).  Updates use lazy invalidation: a dict
    req_id -> live entry; stale heap entries are skipped on pop.
    """

    def __init__(self, key_fn: Callable[[Request], float]):
        self._key_fn = key_fn
        self._heap: List[list] = []
        self._live = {}
        self._tie = itertools.count()

    def __len__(self) -> int:
        return len(self._live)

    def __contains__(self, req: Request) -> bool:
        return req.req_id in self._live

    def add(self, req: Request) -> None:
        entry = [-self._key_fn(req), next(self._tie), req]
        self._live[req.req_id] = entry
        heapq.heappush(self._heap, entry)

    def update(self, req: Request) -> None:
        """Re-key one request (after it received a chunk): O(log n)."""
        old = self._live.pop(req.req_id, None)
        if old is not None:
            old[2] = None  # invalidate in place
        self.add(req)

    def remove(self, req: Request) -> None:
        old = self._live.pop(req.req_id, None)
        if old is not None:
            old[2] = None

    def pop(self) -> Optional[Request]:
        while self._heap:
            entry = heapq.heappop(self._heap)
            req = entry[2]
            if req is not None and req.req_id in self._live:
                del self._live[req.req_id]
                return req
        return None

    def peek(self) -> Optional[Request]:
        while self._heap:
            entry = self._heap[0]
            if entry[2] is not None and entry[2].req_id in self._live:
                return entry[2]
            heapq.heappop(self._heap)
        return None

    def drain_sorted(self) -> List[Request]:
        out = []
        while True:
            r = self.pop()
            if r is None:
                return out
            out.append(r)

    def requests(self) -> Iterable[Request]:
        return [e[2] for e in self._live.values()]


# ---------------------------------------------------------------------------
# policy factories
# ---------------------------------------------------------------------------


def make_policy(
    name: str,
    *,
    alpha: float = 1.0,
    beta: float = -0.01,
    credit_fn: Optional[Callable[[Request], float]] = None,
) -> PrefillQueue:
    """FCFS / SJF / Aging as ordering keys over the shared heap.

    ``credit_fn`` (optional, any policy) adds a cache-awareness term to the
    ordering key: requests whose KV is already materialized — resident
    prefix-cache blocks, or a host-staged swap record one restore round from
    runnable — rank ahead of equal-priority cold requests, so aging never
    starves near-free work behind full recomputes.  The credit is evaluated
    when a request is (re-)keyed (add/update — i.e. every queue bounce), the
    same refresh granularity the aging key itself has.
    """
    name = name.lower()
    if name == "fcfs":
        base = lambda r: -r.arrival_time
    elif name in ("sjf", "shortest"):
        base = lambda r: -float(r.remaining_prefill)
    elif name == "aging":
        if alpha <= 0 or beta >= 0:
            raise ValueError("aging requires alpha > 0 and beta < 0 (Eq. 1)")
        base = lambda r: -alpha * r.arrival_time + beta * float(r.remaining_prefill)
    else:
        raise ValueError(f"unknown policy {name!r}")
    if credit_fn is None:
        return PrefillQueue(base)
    return PrefillQueue(lambda r: base(r) + credit_fn(r))


def aging_priority(req: Request, now: float, alpha: float, beta: float) -> float:
    """Eq. 1 — P_i(n) = alpha (t - a_i) + beta r_i(n); for tests/analysis."""
    return alpha * (now - req.arrival_time) + beta * float(req.remaining_prefill)


class NaiveAgingQueue:
    """O(n log n)-per-round reference: recomputes all priorities each pop
    sequence (what §3.1.4 argues against).  Used to validate heap equivalence
    and to measure the overhead gap."""

    def __init__(self, alpha: float, beta: float):
        self.alpha, self.beta = alpha, beta
        self._reqs: List[Request] = []

    def __len__(self):
        return len(self._reqs)

    def add(self, req: Request) -> None:
        if all(r.req_id != req.req_id for r in self._reqs):
            self._reqs.append(req)

    update = add  # naive: everything is recomputed on pop anyway

    def remove(self, req: Request) -> None:
        self._reqs = [r for r in self._reqs if r.req_id != req.req_id]

    def pop(self, now: float = 0.0) -> Optional[Request]:
        if not self._reqs:
            return None
        best = max(
            self._reqs,
            key=lambda r: (aging_priority(r, now, self.alpha, self.beta), -r.req_id),
        )
        self._reqs.remove(best)
        return best
