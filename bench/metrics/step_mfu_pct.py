"""The model step's share of the card's bf16 peak: the useful operations
of every round dispatched in the traced window (``bench/flops/model.py``:
2 x active non-embedding parameters per real token, causal attention over
each token's real context, the unembedding of the rows that sample), over
the traced window's seconds times 989 TFLOP/s.  Padding positions count
for nothing."""
LAYER = "model step"
UNIT = "%"
MOVES = "out_tok_s"


def read(ctx):
    if not ctx.rounds or ctx.window_s <= 0:
        return None
    flops = sum(ctx.flops.step_flops(ctx.config, r.rows, r.n_sampled)
                for r in ctx.rounds)
    return 100.0 * flops / (ctx.window_s * ctx.peaks.BF16_FLOPS)
