"""The whole train step's share of the card's dense bf16 peak (989 TFLOP/s),
%: the model FLOPs of a rank's step (`counts.flops_per_step`, on the
reference model) times the steps of the traced window of graph replays,
over the window."""

PEAK_FLOPS = 989e12


def read(ctx):
    return 100.0 * ctx.flops_per_step * ctx.steps / ctx.window_s / PEAK_FLOPS
