"""Config 4: sequence VAE with a next-frame prediction head (port of
mmvae_tpu/models/pred_vae.py).

The context prefix (`context_len` frames) runs through the conv stack and
the encoder ConvLSTM (terminal state only); the posterior comes from h_T.
The decoder ConvLSTM starts from the encoder's terminal (c_T, h_T), the
deterministic motion pathway, and is driven by a time-constant z-token, the
stochastic content pathway, for the future frames.  BCE scores only the
future frames (`VAEOutput.target = x[:, context_len:]`).  Under fused=True
the encoder runs K5 and the decoder K6, so K6's dc0 and dh0 flow into K5's
backward as its (dc_T, dh_T).  `prior_logits` rolls z ~ N(0, I) out from a
zero state.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from mmvae_torch.models.base import (
    ConvDecoder,
    ConvEncoder,
    GaussianHead,
    SampleFn,
    VAEOutput,
    linear_f32,
    prior_z,
)
from mmvae_torch.models.convlstm import ConvLSTM

_TOKEN_CH = 16  # z-token channels (fixed in the JAX model)


class PredSeqVAE(nn.Module):
    def __init__(
        self,
        latent_dim: int = 128,
        enc_channels: Sequence[int] = (32, 64, 128),
        lstm_features: int = 128,
        context_len: int = 10,
        image_size: int = 64,
        dtype=torch.float32,
        remat: bool = False,
        unroll: int = 1,  # lax.scan unroll factor of the JAX model; no effect here
        gate_bf16: bool = False,
        fused: Optional[bool] = None,
        dec_upsample: str = "fast",
        enc_x_kernel: int = 3,
        device=None,
    ):
        super().__init__()
        del unroll
        gate_dtype = torch.bfloat16 if gate_bf16 else torch.float32
        self.dtype = dtype
        self.latent_dim = latent_dim
        self.lstm_features = lstm_features
        self.context_len = context_len
        self.image_size = image_size
        self.grid = image_size // (2 ** len(enc_channels))
        g, f = self.grid, lstm_features
        self.frame_enc = ConvEncoder(enc_channels, dtype=dtype, device=device)
        self.enc_lstm = ConvLSTM(
            enc_channels[-1], f, x_kernel=enc_x_kernel, dtype=dtype,
            gate_dtype=gate_dtype, remat=remat, fused=fused, device=device,
        )
        self.head = GaussianHead(g * g * f, latent_dim, device=device)
        self.z_to_token = nn.Linear(latent_dim, g * g * _TOKEN_CH, device=device)
        self.dec_lstm = ConvLSTM(
            _TOKEN_CH, f, dtype=dtype, gate_dtype=gate_dtype, remat=remat, fused=fused,
            device=device,
        )
        self.frame_dec = ConvDecoder(
            f, tuple(reversed(enc_channels)), dtype=dtype, upsample=dec_upsample,
            device=device,
        )

    def context_state(self, ctx: torch.Tensor):
        """(B, Tc, H, W) -> the encoder's terminal state (c_T, h_T)."""
        b, t = ctx.shape[:2]
        feats = self.frame_enc(ctx.reshape(b * t, 1, *ctx.shape[2:]))
        feats = feats.permute(0, 2, 3, 1).reshape(b, t, self.grid, self.grid, -1)
        zeros = torch.zeros(b, self.grid, self.grid, self.lstm_features,
                            device=ctx.device, dtype=self.dtype)
        state_t, _ = self.enc_lstm((zeros, zeros), feats, need_hs=False)
        return state_t

    def encode_context(self, ctx: torch.Tensor):
        """(B, Tc, H, W) -> (terminal state (c_T, h_T), (mu, logvar))."""
        state_t = self.context_state(ctx)
        return state_t, self.head(state_t[1])

    def encode(self, x: torch.Tensor):
        """Posterior from the context prefix (x may be the full clip)."""
        _, (mu, logvar) = self.encode_context(x[:, : self.context_len])
        return mu, logvar

    def rollout(self, state, z: torch.Tensor, n_future: int) -> torch.Tensor:
        """Roll the decoder ConvLSTM n_future steps -> logits (B, n, H, W)."""
        b, g = z.shape[0], self.grid
        token = linear_f32(z, self.z_to_token).reshape(b, 1, g, g, _TOKEN_CH).to(self.dtype)
        _, hs = self.dec_lstm(state, token, length=n_future)
        flat = hs.reshape(b * n_future, *hs.shape[2:]).permute(0, 3, 1, 2)
        logits = self.frame_dec(flat)[:, 0]
        return logits.reshape(b, n_future, self.image_size, self.image_size)

    def prior_logits(self, seed: int, batch: int, seq_len=None, *, z=None) -> torch.Tensor:
        """Prior-sampling protocol: z ~ N(0, I) (`base.prior_z`: drawn from
        `seed`, or the injected (B, latent) `z`), rolled out `seq_len`
        (default `context_len`) steps from a zero motion state.  Without
        context frames there is no encoder terminal state, so the frames
        are shaped by the stochastic content pathway alone."""
        z = prior_z(self, seed, (batch, self.latent_dim), z)
        zeros = torch.zeros(batch, self.grid, self.grid, self.lstm_features, device=z.device,
                            dtype=self.dtype)
        return self.rollout((zeros, zeros), z, seq_len or self.context_len)

    def forward(self, x: torch.Tensor, sample_fn: SampleFn) -> VAEOutput:
        ctx, future = x[:, : self.context_len], x[:, self.context_len:]
        state_t = self.context_state(ctx)
        mu, logvar, z = self.head.sample(state_t[1], sample_fn)
        logits = self.rollout(state_t, z, future.shape[1])
        return VAEOutput(
            logits=logits, target=future, mu=mu, logvar=logvar, z=z,
            extra_kl=torch.zeros((), device=x.device),
        )
