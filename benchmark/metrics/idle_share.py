"""The device's idle share, %: 1 - (the union of its kernel, memset and copy
intervals) / the traced window, in a window of graph replays, averaged over
the ranks."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
