"""The readers of the program's spans (``bench/spans.py`` and the five
metrics on them) against hand counts on a made-up trace, a program that
records no spans (they read nothing), and the spans of a real serve on the
CPU (their names and attributes are the ones the readers look for)."""
import pytest

from bench import cell as cells, spans, trace_read
from repro_torch.tracing import Span

US = 1000
P0 = 5 * 10**9                       # the program's clock at the first anchor
OFFSET, DRIFT = 7 * 10**12, 2e-4     # the profiler's host clock against it
DEV_OFF, DEV_DRIFT = 5_600 * US, 1e-4   # its device clock against its host clock
PERIOD = 10_000 * US
LATENCY = 3 * US                     # an input copy starts 3 µs after its call
NAMES = ("queue_wait_p99_ms", "lprs_ms_per_round", "lprs_over_target_pct",
         "round_gap_idle_pct", "readback_lag_ms_mean")


class Ctx:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def k(p):
    """Program ns -> the profiler's host ns."""
    return OFFSET + (p - P0) * (1 + DRIFT) + P0


def dev(h):
    """The profiler's host ns -> its device ns."""
    return int(h + DEV_OFF + (h - k(P0)) * DEV_DRIFT)


class Spans:
    def __init__(self):
        self.out = []

    def add(self, name, a, b, parent=-1, **attrs):
        self.out.append(Span(len(self.out), name, P0 + a, b and P0 + b, parent, attrs))
        return len(self.out) - 1


def made_up(n_rounds=4, wait_end=8600):
    """``n_rounds`` rounds 10 ms apart (µs from the first anchor): dispatch
    100-200 (replay from 180) with its calls at 150 (the input copy, on the
    device 153-158), 185 (the graph: its kernel 210-8000) and 195 (the ids'
    copy, 8000-8010); the drain 8500-8700, its wait to ``wait_end``; LPRS
    searches of 100, 200 and 300 µs; queue waits."""
    sp, ops, calls = Spans(), [], {}
    for r in range(n_rounds):
        t = r * PERIOD
        step = sp.add("serve.step", t, t + 9000 * US, status="round", round=r)
        sched = sp.add("sched.schedule", t + 10 * US, t + 90 * US, step, round=r,
                       **({"lprs_chunks": 1, "target_ms": 9.0, "pred_ms": 8.0}
                          if r < 3 else {}))
        if r < 3:
            sp.add("sched.lprs", t + 20 * US, t + 20 * US + (r + 1) * 100 * US, sched)
        d = sp.add("engine.dispatch", t + 100 * US, t + 200 * US, step, round=r, C=16)
        sp.add("engine.replay", t + 180 * US, t + 200 * US, d)
        drain = sp.add("engine.drain", t + 8500 * US, t + 8700 * US, step, round=r,
                       wall_ms=[8.5, 9.5, 10.0, 20.0][r % 4])
        sp.add("engine.drain.wait", t + 8500 * US, t + wait_end * US, drain)
        for i, (call, name, a, b) in enumerate([
                (150, "Memcpy HtoD (Pinned -> Device)", 150 + LATENCY / US, 155 + LATENCY / US),
                (185, "nvjet_tst_256x128", 210, 8000),
                (195, "Memcpy DtoH (Device -> Pinned)", 8000, 8010)]):
            calls[10 * r + i] = k(P0 + t + call * US)
            ops.append((name, dev(k(P0 + t + a * US)), dev(k(P0 + t + b * US)), 10 * r + i))
    hi = n_rounds * PERIOD
    for i, (a, wait) in enumerate([(0, 1), (1, 2), (2, 3), (3, 4)]):
        sp.add("req.queue", a * US, (a + wait * 1000) * US, req_id=i, requeue=0)
    sp.add("req.queue", hi - 10_000 * US, 0, req_id=4, requeue=0)     # still waiting
    sp.add("req.queue", 0, 100_000 * US, req_id=5, requeue=1)         # a requeue
    trace = trace_read.Trace(lo=k(P0), hi=k(P0 + hi), host=[], device=[])
    anchors_p = [P0, P0 + hi]
    return sp.out, trace, anchors_p, [k(p) for p in anchors_p], hi, spans.Links(ops, calls)


def ctx_for(shift_ns=0, **kw):
    out, trace, ap, ak, hi, lk = made_up(**kw)
    to_trace = spans.clock(ap, [a + shift_ns for a in ak])
    seg = spans.Segment(out, P0, P0 + hi)
    traced = spans.Segment(out, P0, P0 + hi, to_trace, lk)
    return Ctx(off=Ctx(spans=seg), traced=Ctx(spans=traced), trace=trace,
               window_s=trace.window_s, trace_read=trace_read)


def read(name, ctx):
    return cells.metric_reader(name).read(ctx)


def test_clock_is_the_line_through_the_anchors():
    _out, _trace, ap, ak, _hi, _lk = made_up()
    m = spans.clock(ap, ak)
    for p in (P0, P0 + 123_456_789, P0 + 40_000 * US):
        assert m(p) == pytest.approx(k(p), abs=2)


def test_device_clock_read_against_the_calls():
    """Two copies a round for 2 s, the device clock drifting 6 ms a second
    from 0.5 s on, one copy in twenty read 10.7 ms late: the offset comes
    from the copies' lower envelope, their 3 µs launch latency aside."""
    def drifting(h):
        s = (h - k(P0)) / 1e9
        return h + DEV_OFF + 6e-3 * max(0.0, s - 0.5) * 1e9

    ops, calls = [], {}
    for i in range(400):
        h = k(P0) + i * 5 * US * 1000
        calls[i] = h
        late = 10_700 * US if i % 20 == 7 else 0
        ops.append(("Memcpy HtoD (Pinned -> Device)", int(drifting(h + LATENCY)) + late,
                    int(drifting(h + LATENCY + 5 * US)) + late, i))
    to_host = spans.device_to_host(spans.Links(ops, calls))
    for x in (k(P0) + 0.2e9, k(P0) + 0.9e9, k(P0) + 1.73e9):
        assert to_host(drifting(x)) == pytest.approx(x - LATENCY, abs=50 * US)


def test_program_span_readers_hand_count():
    ctx = ctx_for()
    # waits 1, 2, 3, 4 ms and one open 10 ms at the end; the requeue aside
    assert read("queue_wait_p99_ms", ctx) == pytest.approx(4 + 0.96 * 6)
    assert read("lprs_ms_per_round", ctx) == pytest.approx(0.6 / 4)
    # rounds 0-2 hold LPRS chunks (T* 9 ms): walls 8.5, 9.5, 10
    assert read("lprs_over_target_pct", ctx) == pytest.approx(100 * 2 / 3)


def test_device_readers_hand_count():
    ctx = ctx_for()
    # three gaps from a round's ids (8,010 µs) to the next round's input
    # copy (10,153 µs), in a 40 ms window
    assert read("round_gap_idle_pct", ctx) == pytest.approx(
        100 * 3 * 2143 / 40_000, abs=0.01)
    # the ids land at 8,010 µs, the wait ends at 8,600 µs
    assert read("readback_lag_ms_mean", ctx) == pytest.approx(0.590, abs=0.005)


def test_clock_agreement_catches_faults():
    ctx = ctx_for()
    rs = spans.rounds(ctx.traced.spans)
    assert len(rs) == 4 and all(r.agrees for r in rs)
    assert [r.first_replayed - r.replay for r in rs] == pytest.approx([27 * US] * 4, abs=5 * US)
    out = spans.report(ctx.trace, ctx.traced.spans)
    assert out[0].startswith("clock agreement: 4 of 4 traced rounds agree")
    # the program mapped 20 µs late: the graph's launch seems to precede
    # its replay span
    late = ctx_for(shift_ns=20 * US)
    assert not any(r.agrees for r in spans.rounds(late.traced.spans))
    # a wait that ends before the ids land
    early = ctx_for(wait_end=8005)
    rs = spans.rounds(early.traced.spans)
    assert rs and all(r.wait_end < r.last and not r.agrees for r in rs)


def test_idle_gaps_named_by_the_innermost_span():
    ctx = ctx_for()
    gaps = spans.idle_gaps(ctx.trace, ctx.traced.spans)
    # each gap opens when the ids have landed (8,010 µs), inside serve.step
    assert gaps[0][0] == "serve.step"
    assert gaps[0][1] == pytest.approx(2143e-6, abs=5e-6)


def test_readers_read_nothing_without_spans():
    from bench import trace_read as tr
    trace = tr.Trace(lo=0, hi=10, device=[("gemm", 0, 5)], host=[])
    ctx = Ctx(off=Ctx(), traced=Ctx(), trace=trace, window_s=trace.window_s,
              trace_read=tr)
    for name in NAMES:
        assert read(name, ctx) is None


def test_readers_on_a_served_tracer():
    """The spans of a real serve (CPU: no device work) give the program-side
    readers their numbers, and the device-side ones nothing to read."""
    import time

    import torch

    from repro_torch import tracing
    from repro_torch.configs import tiny_config
    from repro_torch.core.lprs import LPRSConfig
    from repro_torch.core.predictor import AnalyticPredictor
    from repro_torch.core.scheduler import ChunkedPrefillScheduler, SchedulerConfig
    from repro_torch.engine.engine import EngineConfig, TorchEngine, serve
    from repro_torch.engine.workload import WorkloadSpec, attach_prompt_tokens, sharegpt_like

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = tiny_config("qwen1.5-0.5b").with_(param_dtype="float32")
        engine = TorchEngine(cfg, EngineConfig(n_slots=4, max_context=256,
                                               chunk_buckets=(1, 16, 32)), device="cpu")
        reqs = sharegpt_like(WorkloadSpec(n_requests=6, inter_arrival_s=0.005,
                                          max_context=100, max_new_tokens=4, seed=3))
        attach_prompt_tokens(reqs, cfg.vocab_size)
        sched = ChunkedPrefillScheduler(
            SchedulerConfig(policy="aging", token_budget=32, max_seqs=4,
                            lprs=LPRSConfig(target_latency_ms=2.5, search_delta=8)),
            predictor=AnalyticPredictor())
        tracer = tracing.Tracer()
        lo = time.perf_counter_ns()
        serve(reqs, sched, engine, tracer=tracer)
        seg = spans.segment(tracer, lo, time.perf_counter_ns())
    finally:
        torch.set_num_threads(prev)
    ctx = Ctx(off=Ctx(spans=seg), traced=Ctx(spans=seg),
              trace=trace_read.Trace(lo=0, hi=10, device=[], host=[]),
              window_s=1e-8, trace_read=trace_read)
    assert read("queue_wait_p99_ms", ctx) > 0
    assert read("lprs_ms_per_round", ctx) > 0
    assert 0 <= read("lprs_over_target_pct", ctx) <= 100
    assert read("round_gap_idle_pct", ctx) is None
    assert read("readback_lag_ms_mean", ctx) is None
