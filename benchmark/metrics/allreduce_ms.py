"""Device ms a step of the NCCL kernels (the gradients' all-reduce that
`parallel.GradSync` captures in the graph), in the traced window of graph
replays, averaged over the ranks; None where the window ran none."""


def read(ctx):
    if ctx.nccl_s <= 0:
        return None
    return 1e3 * ctx.nccl_s / ctx.steps
