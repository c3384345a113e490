"""The recurrences' share of their roofline, %: the least time of every
ConvLSTM recurrence of a step (forward and backward, counted as K5 and K6
count them in bf16: `counts.recurrence_bound_ms`) over their regions' device
ms a step."""

NAMES = ("enc_lstm", "chunk_lstm", "dec_lstm")


def read(ctx):
    rows = [sum(v) for r, v in ctx.regions.items() if r.split("/")[-1] in NAMES]
    if not rows or sum(rows) <= 0:
        return None
    return 100.0 * ctx.recurrence_bound_ms / sum(rows)
