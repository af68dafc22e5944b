"""Spans inside the serving loop: one tracer, off by default.

A ``Tracer`` records spans in flat lists in memory: each has a name, a start
and an end (``time.perf_counter_ns()``), the span it nests in and a few
attributes.  ``ReplicaServer(..., tracer=...)`` hands it to its scheduler
and engine, which open spans at their boundaries (``serve.step``,
``sched.schedule`` ⊃ ``sched.lprs``, ``engine.dispatch`` ⊃ ``engine.stage``
/ ``engine.upload`` / ``engine.replay``, ``engine.drain`` ⊃
``engine.drain.wait``, ``serve.deliver``, ``sched.on_batch_done``) and put
their counters on them as attributes.  ``req.queue`` spans are per request
and do not nest: one opens at submit, ends when ``schedule()`` first gives
the request work, and opens again when a preemption or a crash unwind puts
it back in the queue.

Every site tests ``tracer.on`` before anything else, so the tracer the
components hold by default (``OFF``) costs one attribute test a site and
records nothing; it never touches ``torch.profiler``.

``anchor()``, called at the start and at the end of a profiled segment,
pairs the tracer's clock with ``torch.profiler``'s: a ``repro.anchor``
annotation with ``perf_counter_ns()`` read inside it.  ``clock`` fits a line
through two such pairs, so that the drift of one clock against the other
over the segment cancels.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np

QUEUE = "req.queue"


class Span(NamedTuple):
    index: int
    name: str
    t0: int                # perf_counter_ns
    t1: int                # 0: never closed
    parent: int            # index of the enclosing span, -1 at the top
    attrs: dict


class Tracer:
    """Spans and anchors of one serve, kept in memory until read."""

    def __init__(self, on: bool = True):
        self.on = on
        self.names: List[str] = []
        self.t0: List[int] = []
        self.t1: List[int] = []
        self.parents: List[int] = []
        self.attrs: List[dict] = []
        self.anchors: List[int] = []
        self._stack: List[int] = []
        self._queued: Dict[int, int] = {}      # req_id -> its open req.queue

    def _record(self, name: str, attrs: dict) -> int:
        i = len(self.names)
        self.names.append(name)
        self.t0.append(time.perf_counter_ns())
        self.t1.append(0)
        self.parents.append(self._stack[-1] if self._stack else -1)
        self.attrs.append(attrs)
        return i

    def open(self, name: str, **attrs) -> int:
        """Open a span inside the innermost open one; returns its index."""
        i = self._record(name, attrs)
        self._stack.append(i)
        return i

    def close(self, i: int, *, drop_if_empty: bool = False, **attrs) -> None:
        """Close span ``i`` (and any span an exception left open inside it),
        adding ``attrs``.  ``drop_if_empty`` forgets it instead when nothing
        was recorded after it opened."""
        stack = self._stack
        while stack and stack.pop() != i:
            pass
        if drop_if_empty and len(self.names) == i + 1:
            for xs in (self.names, self.t0, self.t1, self.parents, self.attrs):
                xs.pop()
            return
        self.t1[i] = time.perf_counter_ns()
        if attrs:
            self.attrs[i].update(attrs)

    def queue_open(self, req_id: int, requeue: int = 0) -> None:
        """The request entered the queue (unless its wait is already open)."""
        if req_id not in self._queued:
            self._queued[req_id] = self._record(
                QUEUE, {"req_id": req_id, "requeue": requeue})

    def queue_close(self, req_id: int) -> None:
        """The request left the queue: it got work, or it left the system."""
        i = self._queued.pop(req_id, None)
        if i is not None:
            self.t1[i] = time.perf_counter_ns()

    def anchor(self) -> None:
        """Pair this clock with the profiler's (see the module's notes)."""
        from torch.profiler import record_function

        with record_function("repro.anchor"):
            self.anchors.append(time.perf_counter_ns())

    def spans(self) -> List[Span]:
        return [Span(i, *fields) for i, fields in enumerate(zip(
            self.names, self.t0, self.t1, self.parents, self.attrs))]


OFF = Tracer(on=False)


def clock(program_ns: Sequence[int], trace_t: Sequence[float]) -> Callable[[float], float]:
    """The line through the first and last ``(program_ns, trace_t)`` anchor
    pairs: program time -> the trace's time, in the trace's unit."""
    (p0, p1), (k0, k1) = (program_ns[0], program_ns[-1]), (trace_t[0], trace_t[-1])
    slope = (k1 - k0) / (p1 - p0) if p1 != p0 else 1.0
    return lambda t: k0 + (t - p0) * slope


def chrome_anchors(trace_events) -> List[float]:
    """The ends (µs) of the ``repro.anchor`` annotations in a Chrome trace
    that ``torch.profiler`` exported.  The time read inside an anchor maps
    to the annotation's end: the profiler's cost of opening an annotation
    (about 1 ms the first time) falls between its start and that read."""
    return sorted(e["ts"] + e["dur"] for e in trace_events
                  if e.get("name") == "repro.anchor" and e.get("ph") == "X")


def chrome_events(spans: List[Span], to_us: Optional[Callable] = None) -> List[dict]:
    """The spans as Chrome-trace events on one process of their own: the
    nesting spans as complete events, each request's queue wait as an async
    pair.  ``to_us`` maps program ns to the trace's µs (default: the
    program's clock, in µs)."""
    to_us = to_us or (lambda t: t / 1e3)
    pid, loop, reqs = os.getpid(), 1, 2
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "repro_torch spans"}},
           {"ph": "M", "name": "thread_name", "pid": pid, "tid": loop,
            "args": {"name": "serve loop"}},
           {"ph": "M", "name": "thread_name", "pid": pid, "tid": reqs,
            "args": {"name": "requests"}}]
    for s in spans:
        if s.name == QUEUE:
            common = {"name": s.name, "cat": s.name, "id": s.attrs["req_id"],
                      "pid": pid, "tid": reqs}
            out.append(dict(common, ph="b", ts=to_us(s.t0), args=s.attrs))
            if s.t1:
                out.append(dict(common, ph="e", ts=to_us(s.t1)))
        elif s.t1:
            a = to_us(s.t0)
            out.append({"name": s.name, "ph": "X", "pid": pid, "tid": loop,
                        "ts": a, "dur": to_us(s.t1) - a, "args": s.attrs})
    return out


def write_chrome(path: str, spans: List[Span], to_us: Optional[Callable] = None) -> None:
    with open(path, "w") as f:
        json.dump({"traceEvents": chrome_events(spans, to_us),
                   "displayTimeUnit": "ms"}, f)


def _ms(ns) -> float:
    return ns / 1e6


def summary(spans: List[Span]) -> List[str]:
    """The operator's summary of a traced serve, one line each: self ms per
    round of each nesting span, device ms per round by chunk bucket, the
    experts read and expert rows computed per round by bucket (a model with
    experts) and the share of choices routed to experts not held here, the
    share of their contexts' keys that sliding-window layers skip, queue
    wait p50 / p99, the LPRS rounds over their target and the predictor's
    median absolute error."""
    closed = [s for s in spans if s.t1 and s.name != QUEUE]
    dispatch = {s.attrs["round"]: s for s in closed if s.name == "engine.dispatch"}
    n = max(len(dispatch), 1)
    self_ns: Dict[str, int] = {}
    for s in closed:
        self_ns[s.name] = self_ns.get(s.name, 0) + s.t1 - s.t0
        if s.parent >= 0 and spans[s.parent].t1:
            parent = spans[s.parent].name
            self_ns[parent] = self_ns.get(parent, 0) - (s.t1 - s.t0)
    lines = [f"spans over {len(dispatch)} rounds, self ms per round: " + ", ".join(
        f"{k} {_ms(v) / n:.3f}" for k, v in sorted(self_ns.items(), key=lambda kv: -kv[1]))]

    drains = {s.attrs["round"]: s for s in closed if s.name == "engine.drain"}
    by_bucket: Dict[int, List[float]] = {}
    for r, d in drains.items():
        if "device_ms" in d.attrs and r in dispatch:
            by_bucket.setdefault(dispatch[r].attrs["C"], []).append(d.attrs["device_ms"])
    lines.append("device ms per round by bucket: " + (", ".join(
        f"C={C} {np.mean(v):.3f} ({len(v)} rounds)" for C, v in sorted(by_bucket.items()))
        or "not measured (no CUDA events: the CPU path)"))
    moe: Dict[int, List[tuple]] = {}
    for r, d in drains.items():
        if "expert_rows" in d.attrs and r in dispatch:
            moe.setdefault(dispatch[r].attrs["C"], []).append(
                (d.attrs["experts_read"], d.attrs["expert_rows"]))
    if moe:
        lines.append("MoE per round by bucket (summed over layers): " + ", ".join(
            f"C={C} {np.mean([e for e, _ in v]):.1f} experts read, "
            f"{np.mean([n for _, n in v]):.1f} expert rows ({len(v)} rounds)"
            for C, v in sorted(moe.items())))
        rows = sum(d.attrs["expert_rows"] for d in drains.values()
                   if "expert_rows" in d.attrs)
        absent = sum(d.attrs.get("absent_choices", 0) for d in drains.values())
        if absent:
            lines.append(f"MoE choices of experts not held here: {absent} of "
                         f"{rows + absent} ({100 * absent / (rows + absent):.1f}%), "
                         "dropped")
    window = sum(s.attrs.get("window_keys", 0) for s in dispatch.values())
    if window:
        context = sum(s.attrs["window_context_keys"] for s in dispatch.values())
        lines.append(f"sliding-window layers read {window} of the {context} "
                     f"keys in their rows' contexts: "
                     f"{100 * (1 - window / context):.1f}% skipped")

    end = max((max(s.t0, s.t1) for s in spans), default=0)
    waits = [_ms((s.t1 or end) - s.t0) for s in spans
             if s.name == QUEUE and not s.attrs["requeue"]]
    still = sum(1 for s in spans if s.name == QUEUE and not s.t1)
    lines.append("queue wait: " + (
        f"p50 {np.percentile(waits, 50):.3f} ms, p99 {np.percentile(waits, 99):.3f} ms "
        f"over {len(waits)} requests ({still} waits still open, counted to the end)"
        if waits else "no request"))

    lprs = [(s.attrs, drains[s.attrs["round"]].attrs) for s in closed
            if s.name == "sched.schedule" and s.attrs.get("lprs_chunks")
            and s.attrs["round"] in drains]
    if lprs:
        over = sum(d["wall_ms"] > a["target_ms"] for a, d in lprs)
        err = np.median([abs(a["pred_ms"] - d["wall_ms"]) for a, d in lprs])
        lines.append(f"LPRS rounds over T*: {over} of {len(lprs)} "
                     f"({100 * over / len(lprs):.1f}%); predictor |error| "
                     f"median {err:.3f} ms (dispatch-to-drain wall)")
    else:
        lines.append("LPRS rounds over T*: no round held an LPRS-sized chunk")
    return lines
