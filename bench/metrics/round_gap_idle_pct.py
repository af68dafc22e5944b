"""Share of the traced segment in which the card sat idle between rounds:
from the end of one round's last device op to the start of the next
round's first (its input copies), ops of neither excepted.  A round's ops
are those enqueued from its ``engine.dispatch`` span (``repro_torch.
tracing``), found by the trace's correlation ids and put on the host's
clock (``bench/spans.py``).  ``device_idle_pct`` less this is the idle
inside rounds (the graph's launch, gaps between its kernels)."""
LAYER = "device"
UNIT = "%"
MOVES = "out_tok_s"


def read(ctx):
    seg = getattr(ctx.traced, "spans", None)
    if seg is None or ctx.window_s <= 0:
        return None
    from bench import spans

    rs = spans.rounds(seg)
    if len(rs) < 2:
        return None
    return 100.0 * sum(spans.gaps_between_rounds_ns(seg, rs)) / 1e9 / ctx.window_s
