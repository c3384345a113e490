"""Config 1: MLP VAE on single 64x64 frames (port of mmvae_tpu/models/mlp_vae.py).

encode: flatten -> `enc_fc` (model dtype) + relu -> the Gaussian head
(`enc_mu`, `enc_logvar`, f32) and its sample, through `head_and_sample`;
decode: `dec_fc` (model dtype) + relu -> `dec_out` (f32) -> logits (B, H, W);
`prior_logits` decodes z ~ N(0, I).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmvae_torch.models.base import (
    SampleFn,
    VAEOutput,
    head_and_sample,
    linear,
    linear_f32,
    prior_z,
)


class MLPVAE(nn.Module):
    def __init__(self, latent_dim: int = 20, hidden_dim: int = 512, image_size: int = 64,
                 dtype=torch.float32, device=None):
        super().__init__()
        d = image_size * image_size
        self.dtype = dtype
        self.latent_dim = latent_dim
        self.image_size = image_size
        self.enc_fc = nn.Linear(d, hidden_dim, device=device)
        self.enc_mu = nn.Linear(hidden_dim, latent_dim, device=device)
        self.enc_logvar = nn.Linear(hidden_dim, latent_dim, device=device)
        self.dec_fc = nn.Linear(latent_dim, hidden_dim, device=device)
        self.dec_out = nn.Linear(hidden_dim, d, device=device)

    def encode_hidden(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W) -> the head's input (B, hidden), model dtype."""
        return F.relu(linear(x.reshape(x.shape[0], -1), self.enc_fc, self.dtype))

    def encode(self, x: torch.Tensor):
        h = self.encode_hidden(x)
        return linear_f32(h, self.enc_mu), linear_f32(h, self.enc_logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent) -> logits (B, H, W), float32."""
        h = F.relu(linear(z, self.dec_fc, self.dtype))
        return linear_f32(h, self.dec_out).reshape(z.shape[0], self.image_size,
                                                   self.image_size)

    def prior_logits(self, seed: int, batch: int, seq_len=None, *, z=None) -> torch.Tensor:
        """Prior-sampling protocol (sample.generate.prior_sample): z ~ N(0, I)
        (`base.prior_z`: drawn from `seed`, or the injected (B, latent) `z`)."""
        return self.decode(prior_z(self, seed, (batch, self.latent_dim), z))

    def forward(self, x: torch.Tensor, sample_fn: SampleFn) -> VAEOutput:
        mu, logvar, z = head_and_sample(self.encode_hidden(x), self.enc_mu, self.enc_logvar,
                                        sample_fn)
        return VAEOutput(logits=self.decode(z), target=x, mu=mu, logvar=logvar, z=z,
                         extra_kl=torch.zeros((), device=x.device))
