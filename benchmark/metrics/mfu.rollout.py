"""A rollout's share of the card's FP32 peak: the operations its traced
freerun steps need, posteriors included (yardstick.rollout_per_step), over
the traced stretch's seconds times 67 TFLOP/s."""


def read(ctx):
    if ctx.kind != "rollout" or ctx.trace is None or not ctx.units or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.per_unit_ops * ctx.units / (ctx.trace.window_s * ctx.fp32_ops_per_s)
