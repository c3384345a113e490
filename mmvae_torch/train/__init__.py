"""Training: state and step (port of mmvae_tpu.train)."""
