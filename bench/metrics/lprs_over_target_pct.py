"""Share of the rounds holding at least one LPRS-sized chunk whose
dispatch-to-drain wall exceeded the target T* they were sized against,
in the segment with the profiler off: ``sched.schedule``'s
``lprs_chunks`` and ``target_ms`` beside ``engine.drain``'s ``wall_ms``
for the same round (``repro_torch.tracing``).  That wall is the quantity
the LPRS profile trained the predictor on."""
LAYER = "scheduler"
UNIT = "%"
MOVES = "itl_p95_ms"


def read(ctx):
    seg = getattr(ctx.off, "spans", None)
    if seg is None:
        return None
    sized = {s.attrs["round"]: s.attrs["target_ms"] for s in seg.spans
             if s.name == "sched.schedule" and s.attrs.get("lprs_chunks")}
    walls = {s.attrs["round"]: s.attrs["wall_ms"] for s in seg.spans
             if s.name == "engine.drain" and s.t1}
    rounds = [r for r in sized if r in walls]
    if not rounds:
        return None
    return 100.0 * sum(walls[r] > sized[r] for r in rounds) / len(rounds)
