"""Share of the positions the rounds computed that carried a real token:
the scheduler's scheduled prefill and decode tokens over the sum, over
chunk buckets C, of the engine's rounds at C times n_slots x C (every round
runs all slots at the bucket's width), as deltas over the segment with the
profiler off."""
LAYER = "engine round"
UNIT = "%"
MOVES = "out_tok_s"


def read(ctx):
    off = ctx.off
    positions = sum(n * ctx.n_slots * C for C, n in off.bucket_rounds.items())
    if positions <= 0:
        return None
    return 100.0 * off.scheduled_tokens / positions
