"""Mean host bubble before a dispatch (``TorchEngine.bubble_ms``: from the
moment the previous round's ids reached the host to this round's dispatch),
over the rounds dispatched in the segment with the profiler off."""
LAYER = "engine round"
UNIT = "ms"
MOVES = "out_tok_s"


def read(ctx):
    b = ctx.off.bubble_ms
    if not b:
        return None
    return sum(b) / len(b)
