"""Share of the traced segment in which the card ran no kernel, copy or
memset (the union of those intervals in the trace), gaps between the
kernels of one round's graph included.  The profiler's host cost is part
of it: the graphs' CUDA events read 0.6-2.7 points more idle in the
traced segment than in the segment before it with the profiler off
(``bench/run.py`` prints both in every traced run)."""
LAYER = "device"
UNIT = "%"
MOVES = "out_tok_s"


def read(ctx):
    if ctx.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
