"""Shared model pieces (port of mmvae_tpu/models/base.py).

Numerics follow flax's casts explicitly: each conv layer casts its input,
weight and bias to the model's activation `dtype`; the posterior heads and
the final logits are float32.  Parameters are float32.  Init copies flax:
truncated lecun_normal weights, orthogonal recurrent kernels, zero biases
(`flax_init_`).

Layout: frames and convolutions are NCHW inside the port (cuDNN's layout);
the ConvLSTM interface and the Gaussian head's flatten keep the JAX
package's NHWC order so that weights and results line up with it.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmvae_torch.ops.dispatch import prior_normal
from mmvae_torch.ops.head_kernels import gaussian_head_sample

# sample_fn(mu, logvar, salt=0) -> z
SampleFn = Callable[..., torch.Tensor]

# stddev correction of a standard normal truncated to [-2, 2] (flax/jax
# variance_scaling with "truncated_normal").
_TRUNC_STD = 0.87962566103423978


class VAEOutput(NamedTuple):
    """Forward result consumed by the loss: negative ELBO =
    BCE(logits, target) + KL(mu, logvar || N(0, I)) + extra_kl."""

    logits: torch.Tensor
    target: torch.Tensor
    mu: torch.Tensor
    logvar: torch.Tensor
    z: torch.Tensor
    extra_kl: torch.Tensor


class HWIOKernel(nn.Module):
    """A bare conv kernel kept in flax's HWIO layout (kh, kw, in, out)."""

    def __init__(self, shape, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, device=device))

    def fan_in(self) -> int:
        return math.prod(self.weight.shape[:-1])


class ProjMatrix(nn.Module):
    """A 1x1 conv as a (C, N) matrix plus bias: flax's (1, 1, C, N) kernel."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def fan_in(self) -> int:
        return self.weight.shape[0]


class RecurrentLinear(nn.Linear):
    """A Dense whose kernel flax initializes orthogonal (a GRU's recurrent
    kernels, `recurrent_kernel_init=orthogonal()`)."""


def _fan_in(mod: nn.Module) -> int:
    if isinstance(mod, (HWIOKernel, ProjMatrix)):
        return mod.fan_in()
    if isinstance(mod, nn.Linear):
        return mod.in_features
    if isinstance(mod, nn.Conv2d):
        return math.prod(mod.weight.shape[1:])
    if isinstance(mod, nn.ConvTranspose2d):
        # torch (in, out, kh, kw) <-> flax (kh, kw, in, out): fan_in = kh*kw*in
        w = mod.weight.shape
        return w[0] * w[2] * w[3]
    raise TypeError(f"no flax init rule for {type(mod).__name__}")


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Truncated lecun_normal weights, orthogonal recurrent kernels and zero
    biases, as flax initializes."""
    for mod in model.modules():
        if not any(True for _ in mod.parameters(recurse=False)):
            continue
        w = mod.weight
        # Drawn on the CPU generator, then copied onto the device.
        sample = torch.empty(w.shape, dtype=torch.float32)
        if isinstance(mod, RecurrentLinear):
            nn.init.orthogonal_(sample, generator=generator)
        else:
            std = math.sqrt(1.0 / _fan_in(mod)) / _TRUNC_STD
            nn.init.trunc_normal_(sample, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        w.copy_(sample)
        if getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
    return model


def conv2d(x, conv: nn.Conv2d, dtype, stride=1, padding=0):
    """flax nn.Conv(dtype=...): input, kernel and bias cast to `dtype`."""
    b = conv.bias.to(dtype) if conv.bias is not None else None
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), b, stride=stride, padding=padding)


def linear(x, lin: nn.Linear, dtype):
    """flax nn.Dense(dtype=...): input, kernel and bias cast to `dtype`."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def linear_f32(x, lin: nn.Linear):
    return F.linear(x.float(), lin.weight, lin.bias)


def head_and_sample(x, lin_mu: nn.Linear, lin_lv: nn.Linear, sample_fn: SampleFn,
                    salt: int = 0):
    """(mu, logvar, z) of a sampling site: mu and logvar are f32 Linears of
    x (B, K), z their sample.  A sample function that names its stream seed
    (`dispatch.make_sample_fn`'s) takes the fused head and sample
    (`ops.head_kernels.gaussian_head_sample`: one kernel each way on the
    card), with its injected eps where it carries one; any other callable
    gets two `linear_f32` and `sample_fn(mu, logvar, salt=salt)`."""
    stream_seed = getattr(sample_fn, "stream_seed", None)
    if stream_seed is None:
        xf = x.float()  # one cast: dx sums in f32 and rounds once, as the fused op
        mu, logvar = linear_f32(xf, lin_mu), linear_f32(xf, lin_lv)
        return mu, logvar, sample_fn(mu, logvar, salt=salt)
    eps = sample_fn.noise(salt)
    if eps is not None:
        eps = eps.to(x.device, torch.float32).contiguous()
    return gaussian_head_sample(x.contiguous(), lin_mu.weight, lin_mu.bias, lin_lv.weight,
                                lin_lv.bias, stream_seed(salt), eps)


def prior_z(module: nn.Module, seed: int, shape, z=None) -> torch.Tensor:
    """A prior-sampling protocol's z ~ N(0, I) of `shape` on the module's
    device (`dispatch.prior_normal` from `seed`), or the injected `z`."""
    dev = next(module.parameters()).device
    if z is None:
        return prior_normal(seed, shape, dev)
    z = torch.as_tensor(z, dtype=torch.float32).to(dev)
    if tuple(z.shape) != tuple(shape):
        raise ValueError(f"prior z {tuple(z.shape)}, expected {tuple(shape)}")
    return z


class ConvEncoder(nn.Module):
    """4x4 / stride-2 conv + relu stack: (N, 1, 64, 64) -> (N, C_last, 8, 8)."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128), dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.n = len(channels)
        cin = 1
        for i, ch in enumerate(channels):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, ch, 4, stride=2, padding=1,
                                                   device=device))
            cin = ch

    def forward(self, x):
        h = x.to(self.dtype)
        for i in range(self.n):
            h = F.relu(conv2d(h, getattr(self, f"Conv_{i}"), self.dtype, stride=2, padding=1))
        return h


DECODER_MODES = ("fast", "fast_k4tail", "fast_mid", "fast_midw", "fast_hq", "transpose")


class ConvDecoder(nn.Module):
    """Frame decoder, every `upsample` mode of flax's ConvDecoder, with its
    parameter names.  Input (N, C, g, g) -> (N, 1, 64, 64) float32 logits;
    each layer runs in the activation dtype, only the logits are cast.  With
    chs = `channels`:

    - "fast": 2x2/s2 transposes (`ConvTranspose_i`) to chs[0], a 3x3 mix
      (`Conv_0`) to chs[1] after the first, transposes to chs[2:], a final
      2x2 transpose to 1 channel;
    - "fast_k4tail": "fast" with the final transpose a 4x4/s2 SAME one
      (`k4_tail`, torch padding 1);
    - "fast_mid" / "fast_midw": "fast" plus a 3x3 conv (`mid_mix`) before the
      final transpose, to max(chs[-1] // 2, 8) / chs[-1] channels;
    - "fast_hq": 2x2 transposes over chs[:-1], `Conv_0` to chs[-1], the
      final transpose;
    - "transpose": 4x4/s2 SAME transposes over chs, then `Conv_0`, a 3x3
      conv to 1 channel.

    Every layer but the last is followed by a relu.  Other names raise (the
    reference takes any other name as "transpose")."""

    def __init__(self, cin: int, channels: Sequence[int] = (128, 64, 32),
                 dtype=torch.float32, upsample: str = "fast", device=None):
        super().__init__()
        if upsample not in DECODER_MODES:
            raise ValueError(f"dec_upsample={upsample!r}: not one of {DECODER_MODES}")
        self.dtype = dtype
        self.layers = []  # module names in forward order
        cur = cin

        def add(name: str, mod: nn.Module) -> None:
            nonlocal cur
            self.add_module(name, mod)
            self.layers.append(name)
            cur = mod.out_channels

        def up(ch: int, k: int = 2) -> None:
            # `ConvTranspose_i`: k x k, stride 2, flax SAME = torch padding (k - 2) / 2
            add(f"ConvTranspose_{sum(n.startswith('ConvTranspose_') for n in self.layers)}",
                nn.ConvTranspose2d(cur, ch, k, stride=2, padding=(k - 2) // 2, device=device))

        def conv(name: str, ch: int) -> None:
            add(name, nn.Conv2d(cur, ch, 3, padding=1, device=device))

        chs = list(channels)
        if upsample == "transpose":
            for ch in chs:
                up(ch, 4)
            conv("Conv_0", 1)
        elif upsample == "fast_hq":
            for ch in chs[:-1]:
                up(ch)
            conv("Conv_0", chs[-1])
            up(1)
        else:
            up(chs[0])
            conv("Conv_0", chs[1] if len(chs) > 1 else chs[0])
            for ch in chs[2:]:
                up(ch)
            if upsample in ("fast_mid", "fast_midw"):
                conv("mid_mix", chs[-1] if upsample == "fast_midw" else max(chs[-1] // 2, 8))
            if upsample == "fast_k4tail":
                add("k4_tail", nn.ConvTranspose2d(cur, 1, 4, stride=2, padding=1, device=device))
            else:
                up(1)

    def forward(self, h):
        h = h.to(self.dtype)
        for i, name in enumerate(self.layers):
            m = getattr(self, name)
            if isinstance(m, nn.ConvTranspose2d):
                h = F.conv_transpose2d(h, m.weight.to(self.dtype), m.bias.to(self.dtype),
                                       stride=2, padding=m.padding)
            else:
                h = conv2d(h, m, self.dtype, padding=1)
            if i + 1 < len(self.layers):
                h = F.relu(h)
        return h.float()


class GaussianHead(nn.Module):
    """Flatten in NHWC order -> (mu, logvar), always float32."""

    def __init__(self, in_features: int, latent_dim: int, device=None):
        super().__init__()
        self.mu = nn.Linear(in_features, latent_dim, device=device)
        self.logvar = nn.Linear(in_features, latent_dim, device=device)

    def forward(self, h_nhwc):
        flat = h_nhwc.reshape(h_nhwc.shape[0], -1).float()
        return linear_f32(flat, self.mu), linear_f32(flat, self.logvar)

    def sample(self, h_nhwc, sample_fn: SampleFn):
        """(mu, logvar, z) through `head_and_sample`; x keeps its dtype."""
        return head_and_sample(h_nhwc.reshape(h_nhwc.shape[0], -1), self.mu, self.logvar,
                               sample_fn)
