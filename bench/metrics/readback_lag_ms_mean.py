"""Mean, over the traced segment's rounds, of the time from the end of a
round's last device op (the copy of its sampled ids) to the end of its
``engine.drain.wait`` span (``repro_torch.tracing``), both on the host's
clock (``bench/spans.py``): how long the ids sat on the host before the
loop took them up."""
LAYER = "engine round"
UNIT = "ms"
MOVES = "itl_p95_ms"


def read(ctx):
    seg = getattr(ctx.traced, "spans", None)
    if seg is None:
        return None
    from bench import spans

    lags = [(r.wait_end - r.last) / 1e6 for r in spans.rounds(seg)
            if r.wait_end is not None]
    if not lags:
        return None
    return sum(lags) / len(lags)
