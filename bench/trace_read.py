"""Reading the traced window from ``torch.profiler``'s events.

The traced window is bracketed by a ``bench.window`` annotation.  Device
work is every kernel, memcpy and memset event on the card
(``repro_torch.launch.serve.device_busy_ms``'s categories, copied; told
apart by name, as the profiler's events name copies ``Memcpy ...`` and
memsets ``Memset ...``, and its synchronisation records, which are no
work, ``... Sync``); busy
time is the union of their intervals inside the window.  The harness's own
``bench.*`` annotations (``schedule``, ``dispatch``, ``drain``, ``submit``,
``sleep``) say what the host was doing when the device went idle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple


def is_work(name: str) -> bool:
    """A device event that is a kernel, a copy or a memset: not a
    synchronisation record, and not the profiler's projection of a
    ``bench.*`` annotation onto the device's timeline."""
    return not ("Sync" in name or name.startswith(("cuda", "bench.")))


@dataclass
class Trace:
    lo: int                                    # window, ns
    hi: int
    device: List[Tuple[str, int, int]]         # (name, start, end), ns
    host: List[Tuple[str, int, int]]           # bench.* annotations

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9


def from_profiler(prof) -> Trace:
    device, host, lo, hi = [], [], None, None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if is_work(name):
                device.append((name, t0, t1))
        elif name == "bench.window":
            lo, hi = t0, t1
        elif name.startswith("bench."):
            host.append((name, t0, t1))
    if lo is None:
        raise RuntimeError("no bench.window annotation in the trace")
    device = [(n, max(a, lo), min(b, hi)) for n, a, b in device
              if b > lo and a < hi]
    return Trace(lo=lo, hi=hi, device=sorted(device, key=lambda d: d[1]),
                 host=sorted(host, key=lambda h: h[1]))


def busy_intervals(tr: Trace) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for _, a, b in tr.device:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) / 1e9


def kernel_s(tr: Trace, match: Callable[[str], bool]) -> Tuple[float, int]:
    """(device seconds, launches) of the events whose name matches."""
    s, n = 0, 0
    for name, a, b in tr.device:
        if match(name):
            s += b - a
            n += 1
    return s / 1e9, n


def top_ops(tr: Trace, k: int = 10) -> List[List]:
    by: dict = {}
    for name, a, b in tr.device:
        by[name] = by.get(name, 0) + (b - a)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:200], ns / 1e9] for name, ns in top]


def _doing(tr: Trace, t: int) -> str:
    """The innermost harness annotation open at ``t``."""
    best = None
    for name, a, b in tr.host:
        if a <= t < b and (best is None or a >= best[1]):
            best = (name, a)
        if a > t:
            break
    return best[0] if best else "host: outside the harness's spans"


def idle_gaps(tr: Trace, k: int = 10) -> List[List]:
    """The ``k`` longest idle gaps inside the window, each named by what
    the host was doing when it began."""
    gaps, prev = [], tr.lo
    for a, b in busy_intervals(tr) + [(tr.hi, tr.hi)]:
        if a > prev:
            gaps.append((a - prev, prev))
        prev = max(prev, b)
    gaps.sort(reverse=True)
    return [[_doing(tr, t), ns / 1e9] for ns, t in gaps[:k]]
