"""The paged prefill kernel's share of its roofline in the traced window,
as ``decode_attn_roofline`` counts it: every round with C > 1 (decode
rows of a mixed round included) launches it as the model module's
``attention_launches`` gives, each launch's bound from each row's real
chunk and context lengths."""
LAYER = "kernels"
UNIT = "%"
MOVES = "ttft_p95_ms"
KERNEL = "paged_prefill"


def read(ctx):
    rounds = [r for r in ctx.rounds if r.C > 1]
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
