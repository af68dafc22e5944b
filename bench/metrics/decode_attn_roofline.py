"""The paged decode kernel's share of its roofline in the traced window:
the sum over its launches of the least time the card could take (the
larger of operations / 989 TFLOP/s and bytes / 3.35 TB/s, from each
pure-decode round's real rows: every valid K and V byte once, q and the
output once), over the kernel's traced device time.  A C == 1 round
launches it as many times, and with such bounds, as the model module's
``attention_launches`` gives (``bench/flops/model.py``): once per layer
over every row for the transformer form."""
LAYER = "kernels"
UNIT = "%"
MOVES = "itl_p95_ms"
# cells with pure-decode rounds: under long prompts and short answers
# prefill is always pending
WORKLOADS = ["arctic-1l.chat"]
KERNEL = "decode_splitk_kernel"


def read(ctx):
    rounds = [r for r in ctx.rounds if r.C == 1]
    t, n = ctx.trace_read.kernel_s(ctx.trace, lambda name: KERNEL in name)
    if not rounds or n == 0 or t <= 0:
        return None
    launches = [ctx.flops.attention_launches(ctx.config, r.rows) for r in rounds]
    expected = sum(len(x) for x in launches)
    if n != expected:
        ctx.log(f"{__name__}: {n} launches traced, {expected} expected")
    # the bound of an average launch times the launches traced: a launch
    # or two of the rounds recorded can fall outside the traced window
    bound = sum(ctx.flops.bound_s(f, b, ctx.peaks.BF16_FLOPS,
                                  ctx.peaks.HBM_BYTES_PER_S)
                for x in launches for f, b in x) / expected * n
    return 100.0 * bound / t
