"""Device ms a step of the ConvLSTM recurrences, forward and backward: the
`enc_lstm`, `chunk_lstm` and `dec_lstm` regions of the eager steps."""

NAMES = ("enc_lstm", "chunk_lstm", "dec_lstm")


def read(ctx):
    rows = [sum(v) for r, v in ctx.regions.items() if r.split("/")[-1] in NAMES]
    return sum(rows) if rows else None
