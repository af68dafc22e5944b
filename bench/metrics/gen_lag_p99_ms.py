"""How late the generator ran: the 99th percentile of (submit time - due
time) over the requests due in the segment with the profiler off, on the
serve clock.  A request submitted late waits in the harness, not in the
program, and its TTFT still counts from its due time."""
import numpy as np

LAYER = "serve loop"
UNIT = "ms"
MOVES = "ttft_p95_ms"


def read(ctx):
    lag = ctx.off.gen_lag_s
    if not lag:
        return None
    return float(np.percentile(np.asarray(lag, np.float64), 99)) * 1e3
