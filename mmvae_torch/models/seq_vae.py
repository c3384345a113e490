"""Config 3: ConvLSTM sequence VAE (port of mmvae_tpu/models/seq_vae.py).

encode: per-frame conv stack over B*T frames -> encoder ConvLSTM (terminal
state only, through the recurrence kernel) -> Gaussian head.
decode: z -> initial (c, h) and a time-constant z-token -> decoder ConvLSTM
over T steps -> batched frame decoder -> logits (B, T, H, W), float32.
`fused` goes to both ConvLSTMs (see models/convlstm.py): None runs the
decoder through K6 on the card where `convlstm.runs_kernel` finds K6 the
faster (the 2-CTA wgmma kernels, F <= 128) and eagerly elsewhere (the CPU,
wider F, the general route), True through K6, False eagerly.
`prior_logits` decodes z ~ N(0, I).

Named regions (`utils.profiling.annotate`), the JAX model's
`jax.named_scope`s: frame_enc, enc_lstm, latent_head, z_init, dec_lstm,
frame_dec.  One intended difference: the fused head draws z in the kernel
that computes mu and logvar, so `latent_head` holds the sample, which the
JAX model draws outside that scope.
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
from mmvae_torch.utils.profiling import annotate


class ConvLSTMSeqVAE(nn.Module):
    def __init__(
        self,
        latent_dim: int = 128,
        enc_channels: Sequence[int] = (32, 64, 128),
        lstm_features: int = 128,
        image_size: int = 64,
        dtype=torch.float32,
        remat: bool = False,
        unroll: int = 1,  # lax.scan unroll factor of the JAX model; no effect here
        gate_bf16: bool = False,
        fused: Optional[bool] = None,
        dec_upsample: str = "fast",
        enc_x_kernel: int = 3,
        token_ch: int = 16,
        device=None,
    ):
        super().__init__()
        del unroll
        gate_dtype = torch.bfloat16 if gate_bf16 else torch.float32
        self.dtype = dtype
        self.latent_dim = latent_dim
        self.lstm_features = lstm_features
        self.image_size = image_size
        self.token_ch = token_ch
        self.grid = image_size // (2 ** len(enc_channels))
        g, f = self.grid, lstm_features
        self.frame_enc = ConvEncoder(enc_channels, dtype=dtype, device=device)
        self.enc_lstm = ConvLSTM(
            enc_channels[-1], f, x_kernel=enc_x_kernel, dtype=dtype,
            gate_dtype=gate_dtype, remat=remat, fused=fused, device=device,
        )
        self.head = GaussianHead(g * g * f, latent_dim, device=device)
        self.z_to_state = nn.Linear(latent_dim, 2 * g * g * f, device=device)
        self.z_to_token = nn.Linear(latent_dim, g * g * token_ch, device=device)
        self.dec_lstm = ConvLSTM(
            token_ch, f, dtype=dtype, gate_dtype=gate_dtype, remat=remat, fused=fused,
            device=device,
        )
        self.frame_dec = ConvDecoder(
            f, tuple(reversed(enc_channels)), dtype=dtype, upsample=dec_upsample,
            device=device,
        )

    def encode_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W) -> (B, T, g, g, C) NHWC features."""
        b, t = x.shape[:2]
        with annotate("frame_enc"):
            feats = self.frame_enc(x.reshape(b * t, 1, *x.shape[2:]))
        return feats.permute(0, 2, 3, 1).reshape(b, t, self.grid, self.grid, -1)

    def encode_state(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W) -> the encoder's terminal h (B, g, g, F), NHWC."""
        feats = self.encode_features(x)
        b = x.shape[0]
        zeros = torch.zeros(b, self.grid, self.grid, self.lstm_features,
                            device=x.device, dtype=self.dtype)
        with annotate("enc_lstm"):
            (_, h_t), _ = self.enc_lstm((zeros, zeros), feats, need_hs=False)
        return h_t

    def encode(self, x: torch.Tensor):
        h_t = self.encode_state(x)
        with annotate("latent_head"):
            return self.head(h_t)

    def _init_decoder(self, z: torch.Tensor):
        b = z.shape[0]
        g, f = self.grid, self.lstm_features
        ch = linear_f32(z, self.z_to_state).reshape(b, g, g, 2 * f).to(self.dtype)
        token = linear_f32(z, self.z_to_token).reshape(b, 1, g, g, self.token_ch)
        return (ch[..., :f], ch[..., f:]), token.to(self.dtype)

    def decode(self, z: torch.Tensor, t: int) -> torch.Tensor:
        """z (B, latent) -> logits (B, t, H, W)."""
        with annotate("z_init"):
            state0, token = self._init_decoder(z)
        with annotate("dec_lstm"):
            _, hs = self.dec_lstm(state0, token, length=t)  # (B, t, g, g, F)
        b = z.shape[0]
        flat = hs.reshape(b * t, *hs.shape[2:]).permute(0, 3, 1, 2)
        with annotate("frame_dec"):
            logits = self.frame_dec(flat)[:, 0]
        return logits.reshape(b, t, self.image_size, self.image_size)

    def prior_logits(self, seed: int, batch: int, seq_len=None, *, z=None) -> torch.Tensor:
        """Prior-sampling protocol (sample.generate.prior_sample): z ~ N(0, I)
        (`base.prior_z`: drawn from `seed`, or the injected (B, latent) `z`)
        decoded over `seq_len` (default 20) steps."""
        return self.decode(prior_z(self, seed, (batch, self.latent_dim), z), seq_len or 20)

    def forward(self, x: torch.Tensor, sample_fn: SampleFn) -> VAEOutput:
        h_t = self.encode_state(x)
        with annotate("latent_head"):
            mu, logvar, z = self.head.sample(h_t, sample_fn)
        logits = self.decode(z, x.shape[1])
        return VAEOutput(
            logits=logits, target=x, mu=mu, logvar=logvar, z=z,
            extra_kl=torch.zeros((), device=x.device),
        )
