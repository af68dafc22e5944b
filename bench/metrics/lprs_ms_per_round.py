"""Host milliseconds of LPRS's chunk search per round: the summed
``sched.lprs`` spans (``repro_torch.tracing``: candidate features, the
predictor, the scores) of the segment with the profiler off, over the
rounds dispatched in it (its ``engine.dispatch`` spans).  A part of
``schedule()``, which the pipelined loop overlaps with the round on the
card."""
LAYER = "scheduler"
UNIT = "ms"
MOVES = "itl_p95_ms"


def read(ctx):
    seg = getattr(ctx.off, "spans", None)
    if seg is None:
        return None
    rounds = sum(1 for s in seg.spans if s.name == "engine.dispatch")
    if rounds == 0:
        return None
    ns = sum(s.t1 - s.t0 for s in seg.spans if s.name == "sched.lprs" and s.t1)
    return ns / 1e6 / rounds
