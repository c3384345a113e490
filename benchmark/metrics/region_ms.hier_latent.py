"""Device ms a step of the work in the `model_fwd` region outside its named
sub-regions, forward and backward: config 5's f32 latent path (chunk
projection, posterior MLP, the GRU prior, the heads and their samples)."""


def read(ctx):
    row = ctx.regions.get("model_fwd")
    return sum(row) if row else None
