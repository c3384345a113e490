"""Generation layer: reconstruction, prior sampling, rollout, image dump."""

from mmvae_torch.sample.generate import (
    prior_sample,
    reconstruct,
    rollout,
    save_gif,
    save_grid,
)

__all__ = ["reconstruct", "prior_sample", "rollout", "save_grid", "save_gif"]
