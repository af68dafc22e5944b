"""Host milliseconds per ``schedule()`` call in the segment with the
profiler off: the harness's span around each call (a wrapper on the
scheduler instance, put on for the segment and taken off after it).  The
pipelined loop overlaps it with the round on the card; it holds the card
back only when it outlasts that round."""
LAYER = "scheduler"
UNIT = "ms"
MOVES = "out_tok_s"


def read(ctx):
    s = ctx.off.sched_s
    if not s:
        return None
    return sum(s) / len(s) * 1e3
