"""The 99th percentile of each request's wait in the program's queue, from
its submit to the first ``schedule()`` that gives it a prefill chunk (its
first ``req.queue`` span, ``repro_torch.tracing``), over the requests
submitted in the segment with the profiler off.  A request still waiting
at the segment's end counts its age then.  Aging exists to shorten this
wait; TTFT holds it beside the prefill rounds."""
import numpy as np

LAYER = "scheduler"
UNIT = "ms"
MOVES = "ttft_p95_ms"


def read(ctx):
    seg = getattr(ctx.off, "spans", None)
    if seg is None:
        return None
    waits = [(min(s.t1 or seg.hi_ns, seg.hi_ns) - s.t0) / 1e6 for s in seg.spans
             if s.name == "req.queue" and not s.attrs["requeue"]]
    if not waits:
        return None
    return float(np.percentile(np.asarray(waits, np.float64), 99))
