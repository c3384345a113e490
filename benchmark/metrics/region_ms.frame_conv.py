"""Device ms a step of the frame encoder and decoder (cuDNN convs), forward
and backward: the `frame_enc` and `frame_dec` regions of the eager steps."""


def read(ctx):
    rows = [sum(v) for r, v in ctx.regions.items()
            if r.split("/")[-1] in ("frame_enc", "frame_dec")]
    return sum(rows) if rows else None
