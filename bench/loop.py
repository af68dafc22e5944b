"""The open-loop serve harness and what it records.

``serve_window`` is ``repro_torch.engine.engine.serve``'s loop over the
program's own ``ReplicaServer`` (``submit`` / ``step`` / ``finish``), with
real-time arrivals and without ``compress_idle_gap``: requests are
submitted when they are due, the loop sleeps while there is nothing to do,
and it stops at the window's end.  ``Probe`` holds the traced run's spans
and records: harness spans around ``schedule()`` and the engine's
``dispatch`` / ``drain`` (``torch.profiler.record_function`` labels for the
trace's idle gaps), each round's rows as ``_stage`` sees them and, on a
card, CUDA events around each replay of a bucket's graph (the graphs'
device time, with the profiler on or off: what the profiler costs);
``counters`` reads the program's counters at the traced window's ends.

The wrappers sit on the instances (``obj.name = wrapped``) and are taken
off after the window.  They hold the instance through a weak reference:
a scheduler holds the engine's hooks, and a bound method of an object
stored on that object is a reference cycle that keeps the engine's device
memory until the cyclic collector runs.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class RoundRecord:
    """One dispatched round: its bucket ``C``, each real row as ``(tokens
    already cached, tokens this round)``, and how many rows sample."""
    C: int
    rows: List[Tuple[int, int]]
    n_sampled: int


@dataclass
class Probe:
    rounds: List[RoundRecord] = field(default_factory=list)
    sched_s: List[float] = field(default_factory=list)
    annotate: bool = False           # record_function labels (traced run)
    # CUDA events on the stream before and after each replay of a bucket's
    # graph (None: not recorded); ``events_busy_s`` sums their spans
    events: Optional[List[Tuple[object, object]]] = None
    _wrapped: List[Tuple[object, str]] = field(default_factory=list)

    def _wrap(self, obj, name: str, around: Callable):
        func = getattr(type(obj), name)
        ref = weakref.ref(obj)

        def wrapped(*args, **kwargs):
            return around(func, ref(), *args, **kwargs)

        setattr(obj, name, wrapped)
        self._wrapped.append((obj, name))

    def _label(self, label: str):
        from torch.profiler import record_function
        return record_function(label)

    def _event(self):
        if self.events is None:
            return None
        import torch
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def events_busy_s(self) -> float:
        """Device seconds of the rounds' graphs, by CUDA events, without a
        profiler: each pair spans one replay, from the end of the work
        queued before it (or its launch, on an idle stream) to its end.
        The small copies in and out of a round, outside its graph, are not
        counted."""
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3

    def span(self, label: str):
        """A ``record_function`` label in the traced window, else nothing."""
        return self._label(label) if self.annotate else contextlib.nullcontext()

    def attach(self, sched, engine) -> None:
        probe = self

        def schedule(func, obj, *args, **kwargs):
            t = time.perf_counter()
            if probe.annotate:
                with probe._label("bench.schedule"):
                    out = func(obj, *args, **kwargs)
            else:
                out = func(obj, *args, **kwargs)
            probe.sched_s.append(time.perf_counter() - t)
            return out

        def stage(func, obj, batch):
            rows = [(r.context_len - 1, 1) for r in batch.decode_reqs]
            rows += [(r.prefill_done, int(c)) for r, c in batch.prefill_chunks]
            out = func(obj, batch)
            probe.rounds.append(RoundRecord(C=int(out[0].shape[1]), rows=rows,
                                            n_sampled=len(out[4])))
            return out

        def labelled(label):
            def around(func, obj, *args, **kwargs):
                with probe.span(label):
                    return func(obj, *args, **kwargs)
            return around

        def timed(func, obj):
            a = probe._event()
            out = func(obj)
            probe.events.append((a, probe._event()))
            return out

        self._wrap(sched, "schedule", schedule)
        self._wrap(engine, "_stage", stage)
        self._wrap(engine, "dispatch", labelled("bench.dispatch"))
        self._wrap(engine, "drain", labelled("bench.drain"))
        if self.events is not None:
            for graph in engine.graphs.values():
                self._wrap(graph, "replay", timed)

    def detach(self) -> None:
        for obj, name in self._wrapped:
            obj.__dict__.pop(name, None)
        self._wrapped.clear()


def counters(sched, engine) -> Dict:
    """The program's counters the per-layer metrics take deltas of."""
    st = sched.stats
    return {"scheduled_tokens": st.scheduled_prefill_tokens
            + st.scheduled_decode_tokens,
            "bucket_rounds": dict(engine.bucket_rounds),
            "bubbles": len(engine.bubble_ms)}


def serve_window(server, reqs, t_start: float, t_end: float,
                 marks: Optional[List[Tuple[float, Callable]]] = None,
                 probe: Optional[Probe] = None) -> Dict[int, float]:
    """Serve ``reqs`` (``arrival_time`` = due, seconds after ``t_start``)
    open-loop until ``t_end`` on the same clock; ``marks`` are ``(time,
    callback)`` pairs, each called once when the clock first passes its
    time.  Drains the round in flight at the end.  Returns each submitted
    request's submit time."""
    probe = probe or Probe()
    pending = sorted(reqs, key=lambda r: r.arrival_time)
    marks = sorted(marks or [], key=lambda m: m[0])
    submitted: Dict[int, float] = {}
    server.start(t_start)
    i, n = 0, len(pending)
    while True:
        now = time.perf_counter() - t_start
        if now < t_end:
            # requests due go in before a mark's callback can hold them up
            with probe.span("bench.submit"):
                while i < n and pending[i].arrival_time <= now:
                    submitted[pending[i].req_id] = time.perf_counter() - t_start
                    server.submit(pending[i])
                    i += 1
        while marks and marks[0][0] <= now:
            marks.pop(0)[1]()
            now = time.perf_counter() - t_start
        if now >= t_end:
            break
        status = server.step(now)
        if status == "idle":
            nxt = pending[i].arrival_time if i < n else t_end
            if marks:
                nxt = min(nxt, marks[0][0])
            with probe.span("bench.sleep"):
                time.sleep(max(0.0, min(0.001, nxt - now)))
        elif status == "starved":
            with probe.span("bench.sleep"):
                time.sleep(0.0005)
    server.finish()
    return submitted


def drain_all(server, limit_s: float = 600.0) -> None:
    """Serve what is left, with no new arrivals, until nothing is queued or
    in flight (between the windows of one process)."""
    t_end = time.perf_counter() + limit_s
    while server.busy() and time.perf_counter() < t_end:
        if server.step(time.perf_counter() - server.t_start) == "starved":
            time.sleep(0.0005)
    server.finish()
    if server.busy():
        raise RuntimeError("requests left after draining")
