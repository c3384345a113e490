"""Config 5: hierarchical temporal-latent video VAE (port of
mmvae_tpu/models/hier_vae.py).

Clips of K chunks x Tc frames (default 10 x 10):

- chunk features: the conv stack over all B*T frames, then the chunk
  ConvLSTM batched over B*K chunks (terminal state only) and a dense
  projection;
- a global latent z_g ~ q(z_g | mean-pooled chunk features), whose KL
  against N(0, I) the ELBO kernel takes;
- per-chunk latents z_k ~ q(z_k | feat_k, z_g), sampled with salt 1, whose
  KL against a learned autoregressive prior p(z_k | z_g, z_{k-1}) (a GRU
  over the chunk index) is `VAEOutput.extra_kl` (`gaussian_kl`, plain f32);
- the decoder ConvLSTM runs the chunks in parallel at batch B*K over Tc
  steps from a state and a time-constant token made from (z_g, z_k).

Under fused=True the chunk encoder runs K5 and the decoder K6 in its
const-input mode.  Named regions (`utils.profiling.annotate`), the JAX
model's `jax.named_scope`s: frame_enc, chunk_lstm, dec_lstm, frame_dec.  `generate` (and `prior_logits`) samples the learned
prior chain: z_g ~ N(0, I), then each chunk's latent through the fused head
and sample, then the chunks decoded in parallel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmvae_torch.models.base import (
    ConvDecoder,
    ConvEncoder,
    RecurrentLinear,
    SampleFn,
    VAEOutput,
    head_and_sample,
    linear_f32,
    prior_z,
)
from mmvae_torch.models.convlstm import ConvLSTM
from mmvae_torch.ops.dispatch import make_sample_fn
from mmvae_torch.utils.profiling import annotate

_TOKEN_CH = 16  # z-token channels (fixed in the JAX model)
# Salt of chunk k's draw in the prior chain: CHAIN_SALT + k.  `forward`
# draws with salts 0 (z_g) and 1 (the chunks), which a reconstruction from
# the same seed runs, so the chain starts past them.
CHAIN_SALT = 2


def gaussian_kl(mu_q, logvar_q, mu_p, logvar_p) -> torch.Tensor:
    """KL(N(mu_q, var_q) || N(mu_p, var_p)), summed over all elements, f32."""
    mu_q, logvar_q, mu_p, logvar_p = (t.float() for t in (mu_q, logvar_q, mu_p, logvar_p))
    return 0.5 * torch.sum(
        logvar_p - logvar_q + (torch.exp(logvar_q) + (mu_q - mu_p) ** 2) * torch.exp(-logvar_p)
        - 1.0
    )


class GRUCell(nn.Module):
    """flax `nn.GRUCell`: input kernels `ir`, `iz`, `in` with biases,
    recurrent kernels `hr`, `hz` without and `hn` with a bias (orthogonal
    init), f32:

        r = sig(ir(x) + hr(h));  z = sig(iz(x) + hz(h))
        n = tanh(in(x) + r * hn(h));  h' = (1 - z) * n + z * h

    (torch's `nn.GRUCell` has recurrent biases on r and z that flax lacks.)"""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(in_features, features, device=device))
        self.hr = RecurrentLinear(features, features, bias=False, device=device)
        self.hz = RecurrentLinear(features, features, bias=False, device=device)
        self.hn = RecurrentLinear(features, features, device=device)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h, x = h.float(), x.float()
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class HierVideoVAE(nn.Module):
    def __init__(
        self,
        global_latent: int = 128,
        chunk_latent: int = 64,
        chunk_len: int = 10,
        enc_channels: Sequence[int] = (32, 64, 128),
        lstm_features: int = 128,
        chunk_feature: int = 256,
        image_size: int = 64,
        dtype=torch.float32,
        remat: bool = True,
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
        self.global_latent = global_latent
        self.chunk_latent = chunk_latent
        self.chunk_len = chunk_len
        self.lstm_features = lstm_features
        self.chunk_feature = chunk_feature
        self.image_size = image_size
        self.grid = image_size // (2 ** len(enc_channels))
        g, f = self.grid, lstm_features
        self.frame_enc = ConvEncoder(enc_channels, dtype=dtype, device=device)
        self.chunk_lstm = ConvLSTM(
            enc_channels[-1], f, x_kernel=enc_x_kernel, dtype=dtype,
            gate_dtype=gate_dtype, remat=remat, fused=fused, device=device,
        )
        self.chunk_proj = nn.Linear(g * g * f, chunk_feature, device=device)
        self.g_mu = nn.Linear(chunk_feature, global_latent, device=device)
        self.g_logvar = nn.Linear(chunk_feature, global_latent, device=device)
        self.q_hidden = nn.Linear(chunk_feature + global_latent, 256, device=device)
        self.q_mu = nn.Linear(256, chunk_latent, device=device)
        self.q_logvar = nn.Linear(256, chunk_latent, device=device)
        self.prior_gru = GRUCell(chunk_latent, 256, device=device)
        self.prior_init = nn.Linear(global_latent, 256, device=device)
        self.p_mu = nn.Linear(256, chunk_latent, device=device)
        self.p_logvar = nn.Linear(256, chunk_latent, device=device)
        zdim = global_latent + chunk_latent
        self.z_to_state = nn.Linear(zdim, 2 * g * g * f, device=device)
        self.z_to_token = nn.Linear(zdim, g * g * _TOKEN_CH, device=device)
        self.dec_lstm = ConvLSTM(
            _TOKEN_CH, f, dtype=dtype, gate_dtype=gate_dtype, remat=remat, fused=fused,
            device=device,
        )
        self.frame_dec = ConvDecoder(
            f, tuple(reversed(enc_channels)), dtype=dtype, upsample=dec_upsample,
            device=device,
        )

    def chunk_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W) -> (B, K, chunk_feature); the ConvLSTM batched over B*K."""
        b, t = x.shape[:2]
        k = t // self.chunk_len
        if k * self.chunk_len != t:
            raise ValueError(f"seq_len {t} is not a multiple of chunk_len {self.chunk_len}")
        with annotate("frame_enc"):
            feats = self.frame_enc(x.reshape(b * t, 1, *x.shape[2:]))
        feats = feats.permute(0, 2, 3, 1).reshape(b * k, self.chunk_len, self.grid,
                                                  self.grid, -1)
        zeros = torch.zeros(b * k, self.grid, self.grid, self.lstm_features,
                            device=x.device, dtype=self.dtype)
        with annotate("chunk_lstm"):
            (_, h_t), _ = self.chunk_lstm((zeros, zeros), feats, need_hs=False)
        pooled = h_t.reshape(b * k, -1).float()
        return linear_f32(pooled, self.chunk_proj).reshape(b, k, self.chunk_feature)

    def encode(self, x: torch.Tensor):
        """Global posterior (mu, logvar), the top-level latent."""
        pooled = self.chunk_features(x).mean(dim=1)
        return linear_f32(pooled, self.g_mu), linear_f32(pooled, self.g_logvar)

    def prior_params(self, z_g: torch.Tensor, z_chunks: torch.Tensor):
        """p(z_k | z_g, z_{k-1}) for all k, teacher-forced on the sampled
        z_chunks (B, K, Lc): (mu_p, logvar_p), each (B, K, Lc)."""
        k = z_chunks.shape[1]
        s = torch.tanh(linear_f32(z_g, self.prior_init))
        mus, logvars = [], []
        z_prev = torch.zeros_like(z_chunks[:, 0])
        for i in range(k):
            s = self.prior_gru(s, z_prev)
            mus.append(linear_f32(s, self.p_mu))
            logvars.append(linear_f32(s, self.p_logvar))
            z_prev = z_chunks[:, i]
        return torch.stack(mus, dim=1), torch.stack(logvars, dim=1)

    def decode_chunks(self, z_g: torch.Tensor, z_chunks: torch.Tensor) -> torch.Tensor:
        """(B, Lg), (B, K, Lc) -> logits (B, K*Tc, H, W); chunks in parallel."""
        b, k, _ = z_chunks.shape
        g, f, tc = self.grid, self.lstm_features, self.chunk_len
        zg_rep = z_g[:, None].expand(b, k, z_g.shape[-1])
        zz = torch.cat([zg_rep, z_chunks], dim=-1).reshape(b * k, -1)
        ch = linear_f32(zz, self.z_to_state).reshape(b * k, g, g, 2 * f).to(self.dtype)
        token = linear_f32(zz, self.z_to_token).reshape(b * k, 1, g, g, _TOKEN_CH)
        with annotate("dec_lstm"):
            _, hs = self.dec_lstm((ch[..., :f], ch[..., f:]), token.to(self.dtype), length=tc)
        flat = hs.reshape(b * k * tc, *hs.shape[2:]).permute(0, 3, 1, 2)
        with annotate("frame_dec"):
            logits = self.frame_dec(flat)[:, 0]
        return logits.reshape(b, k * tc, self.image_size, self.image_size)

    def generate(self, seed: int, batch: int, n_chunks: int, *, z_g=None,
                 eps=None) -> torch.Tensor:
        """Prior sample: z_g ~ N(0, I) (`base.prior_z`), s = tanh(prior_init(z_g));
        then for each chunk k, s = GRU(s, z_{k-1}) and z_k ~ N(p_mu(s),
        exp(p_logvar(s))) through `head_and_sample` with salt CHAIN_SALT + k
        of the step sampler of `seed` (on the card the fused head-and-sample
        kernel, one launch a chunk); decode.  Injected draws: `z_g` (B, Lg)
        and `eps`, {salt: (B, Lc)}.  Returns logits (B, n_chunks * Tc, H, W)."""
        z_g = prior_z(self, seed, (batch, self.global_latent), z_g)
        sample_fn = make_sample_fn(seed, eps)
        s = torch.tanh(linear_f32(z_g, self.prior_init))
        z_prev = torch.zeros(batch, self.chunk_latent, device=z_g.device)
        zs = []
        for k in range(n_chunks):
            s = self.prior_gru(s, z_prev)
            _, _, z_prev = head_and_sample(s, self.p_mu, self.p_logvar, sample_fn,
                                           salt=CHAIN_SALT + k)
            zs.append(z_prev)
        return self.decode_chunks(z_g, torch.stack(zs, dim=1))

    def prior_logits(self, seed: int, batch: int, seq_len=None, *, z_g=None,
                     eps=None) -> torch.Tensor:
        """Prior-sampling protocol: the learned autoregressive chunk prior over
        (`seq_len` or 100) // chunk_len chunks (`generate`)."""
        return self.generate(seed, batch, (seq_len or 100) // self.chunk_len, z_g=z_g, eps=eps)

    def forward(self, x: torch.Tensor, sample_fn: SampleFn) -> VAEOutput:
        b = x.shape[0]
        cf = self.chunk_features(x)  # (B, K, chunk_feature)
        k = cf.shape[1]
        pooled = cf.mean(dim=1)
        mu_g, logvar_g, z_g = head_and_sample(pooled, self.g_mu, self.g_logvar, sample_fn)

        zg_rep = z_g[:, None].expand(b, k, z_g.shape[-1])
        qin = torch.cat([cf, zg_rep], dim=-1).reshape(b * k, -1)
        hq = torch.tanh(linear_f32(qin, self.q_hidden))
        mu_c, logvar_c, z_c = (
            t.reshape(b, k, self.chunk_latent)
            for t in head_and_sample(hq, self.q_mu, self.q_logvar, sample_fn, salt=1)
        )

        mu_p, logvar_p = self.prior_params(z_g, z_c)
        extra_kl = gaussian_kl(mu_c, logvar_c, mu_p, logvar_p)
        logits = self.decode_chunks(z_g, z_c)
        return VAEOutput(
            logits=logits, target=x, mu=mu_g, logvar=logvar_g, z=z_g, extra_kl=extra_kl,
        )
