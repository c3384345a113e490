"""Config 2: per-frame conv VAE (port of mmvae_tpu/models/conv_vae.py).

encode: 4x4 / stride-2 convs 64 -> 4 (`ConvEncoder`, NCHW) -> the Gaussian
head over the NHWC flatten (flax's order) and its sample;
decode: `dec_in` (model dtype) + relu, reshaped to NHWC (g, g, C) as flax
does and permuted to NCHW -> `ConvDecoder(upsample="transpose")`, one 4x4
transpose per encoder stride and a 3x3 conv -> logits (B, H, W);
`prior_logits` decodes z ~ N(0, I).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmvae_torch.models.base import (
    ConvDecoder,
    ConvEncoder,
    GaussianHead,
    SampleFn,
    VAEOutput,
    linear,
    prior_z,
)


class ConvVAE(nn.Module):
    def __init__(self, latent_dim: int = 64, channels: Sequence[int] = (32, 64, 128, 256),
                 image_size: int = 64, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.latent_dim = latent_dim
        self.image_size = image_size
        self.channels = tuple(channels)
        self.grid = image_size // (2 ** len(channels))
        g, c = self.grid, self.channels[-1]
        self.encoder = ConvEncoder(channels, dtype=dtype, device=device)
        self.head = GaussianHead(g * g * c, latent_dim, device=device)
        self.dec_in = nn.Linear(latent_dim, g * g * c, device=device)
        dec_channels = tuple(reversed(self.channels[:-1])) + (max(self.channels[0] // 2, 8),)
        self.decoder = ConvDecoder(c, dec_channels, dtype=dtype, upsample="transpose",
                                   device=device)

    def encode_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W) -> (B, g, g, C) NHWC features."""
        return self.encoder(x[:, None]).permute(0, 2, 3, 1)

    def encode(self, x: torch.Tensor):
        return self.head(self.encode_features(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent) -> logits (B, H, W), float32."""
        h = F.relu(linear(z, self.dec_in, self.dtype))
        h = h.reshape(z.shape[0], self.grid, self.grid, self.channels[-1]).permute(0, 3, 1, 2)
        return self.decoder(h)[:, 0]

    def prior_logits(self, seed: int, batch: int, seq_len=None, *, z=None) -> torch.Tensor:
        """Prior-sampling protocol (sample.generate.prior_sample): z ~ N(0, I)
        (`base.prior_z`: drawn from `seed`, or the injected (B, latent) `z`)."""
        return self.decode(prior_z(self, seed, (batch, self.latent_dim), z))

    def forward(self, x: torch.Tensor, sample_fn: SampleFn) -> VAEOutput:
        mu, logvar, z = self.head.sample(self.encode_features(x), sample_fn)
        return VAEOutput(logits=self.decode(z), target=x, mu=mu, logvar=logvar, z=z,
                         extra_kl=torch.zeros((), device=x.device))
