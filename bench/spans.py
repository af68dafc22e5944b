"""Reading the program's own spans (``repro_torch.tracing``) beside the trace.

The program records spans on ``time.perf_counter_ns()``: each has ``name``,
``t0``, ``t1`` (0 while open), ``parent`` (an index, -1 at the top) and
``attrs``.  A segment of a run hands its readers the spans that started in
it (``Segment``).  The traced segment also carries two clock maps:

- program -> the profiler's host clock (``clock``): the line through the
  tracer's two ``repro.anchor`` annotations;
- the profiler's device clock -> its host clock (``device_to_host``): the
  trace's device timestamps run apart from its host timestamps (on an H100
  with PyTorch 2.11 they drifted by up to 6 ms a second, and a few copies
  read 10.7 ms late), so they are read against the host calls that
  enqueued them (``Links``, by correlation id).  A host-to-device copy of
  a round's inputs lands on an idle stream and starts a few µs after its
  call: the least (copy start - call start) in each 20 ms of the segment
  is the offset there, interpolated between and held beyond the ends.

``rounds`` gives each dispatched round its device ops: those enqueued by a
host call inside its ``engine.dispatch`` span (its input copies, its
graph's kernels, the copy of its ids), on the host clock.  The clocks agree
in a round when its first op launched from ``engine.replay`` starts within
1 ms after that span opens, and its ``engine.drain.wait`` does not end
before its last op.

Nothing here imports the program: a run of a program that records no spans
hands its readers none, and they read nothing.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bench import trace_read

QUEUE = "req.queue"
LAUNCH_NS = 1_000_000          # a round's first replayed op within 1 ms
ENVELOPE_NS = 20_000_000       # one point of the device-to-host offset each


@dataclass
class Links:
    """Device ops and the host calls that enqueued them."""
    ops: List[Tuple[str, int, int, int]]    # (name, start, end, correlation), device clock
    calls: Dict[int, int]                   # correlation -> call start, host clock


@dataclass
class Segment:
    spans: list                    # the program's spans that start in it
    lo_ns: int                     # the segment on the program's clock
    hi_ns: int
    to_trace: Optional[Callable[[int], float]] = None   # traced: -> host clock
    links: Optional[Links] = None                       # traced


def segment(tracer, lo_ns: int, hi_ns: int, to_trace=None, links=None) -> Segment:
    return Segment([s for s in tracer.spans() if lo_ns <= s.t0 < hi_ns],
                   lo_ns, hi_ns, to_trace, links)


def anchors(prof) -> List[int]:
    """The ends (ns, the profiler's host clock) of the ``repro.anchor``
    annotations: the time the tracer read inside each maps to its end, as
    the profiler's cost of opening one falls before that read."""
    return sorted(e.end_ns() for e in prof.profiler.kineto_results.events()
                  if e.name() == "repro.anchor")


def links(prof) -> Links:
    ops, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if trace_read.is_work(name):
                ops.append((name, e.start_ns(), e.end_ns(), e.correlation_id()))
        elif name.startswith("cuda"):
            calls[e.correlation_id()] = e.start_ns()
    return Links(sorted(ops, key=lambda o: o[1]), calls)


def clock(program_ns: Sequence[int], trace_ns: Sequence[int]) -> Callable[[int], float]:
    """The line through the first and last anchor pairs (the drift between
    the two clocks over the segment cancels)."""
    p0, p1, k0, k1 = program_ns[0], program_ns[-1], trace_ns[0], trace_ns[-1]
    slope = (k1 - k0) / (p1 - p0) if p1 != p0 else 1.0
    return lambda t: k0 + (t - p0) * slope


def device_to_host(lk: Links) -> Optional[Callable[[float], float]]:
    """Device time -> host time (see the module's notes); None without a
    host-to-device copy to read the offset from."""
    pts = sorted((lk.calls[c], s - lk.calls[c]) for n, s, _, c in lk.ops
                 if n.startswith("Memcpy HtoD") and c in lk.calls)
    if not pts:
        return None
    t = np.array([p[0] for p in pts], np.float64)
    u = np.array([p[1] for p in pts], np.float64)
    n = max(1, int((t[-1] - t[0]) / ENVELOPE_NS))
    edges = np.linspace(t[0], t[-1], n + 1)
    ts, us = [], []
    for a, b in zip(edges, edges[1:]):
        sel = np.nonzero((t >= a) & (t <= b))[0]
        if len(sel):
            k = sel[np.argmin(u[sel])]
            ts.append(t[k])
            us.append(u[k])

    def to_host(d: float) -> float:
        h = d - us[0]
        for _ in range(3):
            h = d - float(np.interp(h, ts, us))
        return h
    return to_host


@dataclass
class Round:
    index: int                     # the scheduler's round index
    seq: int                       # its place among the segment's dispatches
    replay: float                  # engine.replay's start, host clock
    first: float                   # its first device op's start, host clock
    first_replayed: Optional[float]  # the first op launched inside engine.replay
    last: float                    # its last device op's end
    wait_end: Optional[float]      # engine.drain.wait's end

    @property
    def agrees(self) -> bool:
        return (self.first_replayed is not None
                and 0 <= self.first_replayed - self.replay <= LAUNCH_NS
                and (self.wait_end is None or self.wait_end >= self.last))


def rounds(seg: Optional[Segment]) -> List[Round]:
    """The segment's rounds that have device ops in the trace, in order."""
    if seg is None or seg.to_trace is None or seg.links is None:
        return []
    to_host = device_to_host(seg.links)
    if to_host is None:
        return []
    m, spans = seg.to_trace, seg.spans
    dispatch = sorted((s for s in spans if s.name == "engine.dispatch" and s.t1),
                      key=lambda s: s.t0)
    starts = [m(d.t0) for d in dispatch]
    by_index = {s.index: s for s in spans}
    replay = {s.parent: m(s.t0) for s in spans if s.name == "engine.replay"}
    wait = {by_index[s.parent].attrs["round"]: m(s.t1) for s in spans
            if s.name == "engine.drain.wait" and s.t1 and s.parent in by_index}
    ops: Dict[int, list] = {}
    for _, a, b, c in seg.links.ops:
        h = seg.links.calls.get(c)
        k = bisect.bisect_right(starts, h) - 1 if h is not None else -1
        if k >= 0 and h <= m(dispatch[k].t1):
            ops.setdefault(k, []).append((to_host(a), to_host(b), h))
    out = []
    for k in sorted(ops):
        d, xs = dispatch[k], ops[k]
        rep = replay.get(d.index)
        replayed = [a for a, _, h in xs if rep is not None and h >= rep]
        out.append(Round(index=d.attrs["round"], seq=k, replay=rep,
                         first=min(a for a, _, _ in xs),
                         first_replayed=min(replayed) if replayed else None,
                         last=max(b for _, b, _ in xs), wait_end=wait.get(d.attrs["round"])))
    return out


def busy(seg: Segment) -> List[Tuple[float, float]]:
    """The union of the device ops' intervals, on the host clock."""
    to_host = device_to_host(seg.links)
    out: List[Tuple[float, float]] = []
    for _, a, b, _ in seg.links.ops:
        a, b = to_host(a), to_host(b)
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(b, out[-1][1]))
        else:
            out.append((a, b))
    return out


def _busy_in(iv: List[Tuple[float, float]], starts: List[float], lo: float,
             hi: float) -> float:
    """ns of ``[lo, hi]`` covered by the sorted, disjoint intervals ``iv``
    (``starts``: their starts)."""
    k = max(0, bisect.bisect_right(starts, lo) - 1)
    s = 0.0
    for a, b in iv[k:]:
        if a >= hi:
            break
        s += max(0.0, min(b, hi) - max(a, lo))
    return s


def gaps_between_rounds_ns(seg: Segment, rs: List[Round]) -> List[float]:
    """Idle ns from each round's last op to the next round's first (ops of
    neither inside a gap count as busy)."""
    iv = busy(seg)
    starts = [a for a, _ in iv]
    return [max(0.0, (b.first - a.last) - _busy_in(iv, starts, a.last, b.first))
            for a, b in zip(rs, rs[1:]) if b.seq == a.seq + 1 and b.first > a.last]


def idle_gaps(trace, seg: Segment, k: int = 10) -> List[List]:
    """The ``k`` longest idle gaps of the traced window (device ops on the
    host clock), each named by the innermost program span open when it
    began (queue waits aside)."""
    m = seg.to_trace
    mapped = sorted((m(s.t0), m(s.t1), s.name) for s in seg.spans
                    if s.t1 and s.name != QUEUE)
    gaps, prev = [], trace.lo
    for a, b in busy(seg) + [(trace.hi, trace.hi)]:
        a, b = max(a, trace.lo), min(b, trace.hi)
        if a > prev:
            gaps.append((a - prev, prev))
        prev = max(prev, b)
    gaps.sort(reverse=True)
    out = []
    for ns, t in gaps[:k]:
        name = "host: outside the program's spans"
        for a, b, n in mapped:
            if a > t:
                break
            if t < b:
                name = n           # the latest-opened span holding t
        out.append([name, ns / 1e9])
    return out


def report(trace, seg: Optional[Segment]) -> List[str]:
    """Lines for standard error: how well the clocks agree, and the longest
    idle gaps by program span."""
    rs = rounds(seg)
    if not rs:
        return ["clock agreement: no traced round (no spans or no device work)"]
    lead = [r.first_replayed - r.replay for r in rs if r.first_replayed is not None]
    q = np.percentile(lead, [0, 50, 99, 100]) / 1e3 if lead else [float("nan")] * 4
    late = sum(r.wait_end is not None and r.wait_end < r.last for r in rs)
    to_host = device_to_host(seg.links)
    ahead = [(d - to_host(d)) / 1e3 for d in (seg.links.ops[0][1], seg.links.ops[-1][1])]
    lines = [
        f"clock agreement: {sum(r.agrees for r in rs)} of {len(rs)} traced rounds "
        f"agree; first replayed op {q[0]:.1f} / {q[1]:.1f} / {q[2]:.1f} / {q[3]:.1f} "
        f"us (min / median / p99 / max) after engine.replay opens; "
        f"engine.drain.wait ending before the round's last op in {late}; the "
        f"device clock {ahead[0]:.1f} us ahead of the host's at the first op, "
        f"{ahead[1]:.1f} us at the last"]
    lines += [f"idle gap {s * 1e3:.3f} ms in {name}" for name, s in idle_gaps(trace, seg)]
    return lines
