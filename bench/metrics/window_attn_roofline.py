"""The sliding-window attention kernels' share of their roofline in the
traced window: the windowed instantiations of the paged decode and
prefill kernels (``paged::SlidingWindow`` in the kernel's name), each
launch's bound from its round's real ``(cached, new)`` rows over the keys
within the layer's window (the model module's ``window_launches``: one per
sliding layer a round), over their traced device time.  A program without
windowed kernels traces none, and the reader finds nothing."""
LAYER = "kernels"
UNIT = "%"
MOVES = "ttft_p95_ms"
WORKLOADS = ["k-exaone-8l.longdoc"]
KERNELS = ("decode_splitk_kernel", "paged_prefill")
WINDOWED = "SlidingWindow"


def windowed(name: str) -> bool:
    return WINDOWED in name and any(k in name for k in KERNELS)


def read(ctx):
    model = ctx.flops.model(ctx.config)
    if not ctx.rounds or not hasattr(model, "window_launches"):
        return None
    t, n = ctx.trace_read.kernel_s(ctx.trace, windowed)
    if n == 0 or t <= 0:
        return None
    launches = [model.window_launches(ctx.config, r.rows) for r in ctx.rounds]
    expected = sum(len(x) for x in launches)
    if expected == 0:
        return None
    if n != expected:
        ctx.log(f"{__name__}: {n} launches traced, {expected} expected")
    # the bound of an average launch times the launches traced: a launch
    # or two of the rounds recorded can fall outside the traced window
    bound = sum(ctx.flops.bound_s(f, b, ctx.peaks.BF16_FLOPS,
                                  ctx.peaks.HBM_BYTES_PER_S)
                for x in launches for f, b in x) / expected * n
    return 100.0 * bound / t
