"""The paged prefill kernel's share of its roofline in the traced window,
as ``decode_attn_roofline`` counts it: every round with C > 1 (decode
rows of a mixed round included) launches it once per layer, and its bound
comes from each row's real chunk and context lengths, causal."""
LAYER = "kernels"
UNIT = "%"
MOVES = "ttft_p95_ms"
KERNEL = "paged_prefill"


def read(ctx):
    rounds = [r for r in ctx.rounds if r.C > 1]
    t, n = ctx.trace_read.kernel_s(ctx.trace, lambda name: KERNEL in name)
    if not rounds or n == 0 or t <= 0:
        return None
    L = ctx.config["num_hidden_layers"]
    expected = L * len(rounds)
    if n != expected:
        ctx.log(f"{__name__}: {n} launches traced, {expected} expected")
    # the bound of an average launch times the launches traced: the
    # profiler's record can miss a few launches of the rounds recorded
    bound = sum(ctx.flops.bound_s(*ctx.flops.attention_cost(ctx.config, r.rows),
                                  ctx.peaks.BF16_FLOPS, ctx.peaks.HBM_BYTES_PER_S)
                for r in rounds) * L / expected * n
    return 100.0 * bound / t
