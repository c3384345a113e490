"""Plain PyTorch pieces of the reference models, in float32.

Parameters come as a dict of tensors under the program's names and
layouts: conv kernels OIHW, transposed-conv kernels (in, out, kh, kw),
Linear (out, in), a 1x1 projection as a (C, 4F) matrix and a ConvLSTM's
hidden kernel HWIO (3, 3, F, 4F) where the projection is a matrix.

`lowp`, where given, rounds every tensor that the configuration keeps in
its activation dtype (conv inputs, weights and biases, the recurrences'
gates and state, the logits before their f32 cast) and is how the
control computes in a lower precision; None computes everything in f32.
`lowp32`, where given, rounds the inputs and weights of every product that
the configuration keeps in f32 (the Dense layers: the heads, config 5's
latent path, z to the decoder's state and token): the controls of those
layers, in TF32 or bf16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
LowP = Optional[Callable[[torch.Tensor], torch.Tensor]]

# stddev correction of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 (saturated at its largest value, 448)."""
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32)


def _to_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32(torch.autograd.Function):
    """The rounding to TF32 both ways, as a cast rounds its gradient."""

    @staticmethod
    def forward(ctx, x):
        return _to_tf32(x)

    @staticmethod
    def backward(ctx, grad):
        return _to_tf32(grad)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa, to nearest with ties away from
    zero, as the tensor cores round an f32 input; its gradient likewise."""
    return _TF32.apply(x)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16."""
    return x.to(torch.bfloat16).to(torch.float32)


def _q(x, lowp: LowP):
    return x if lowp is None else lowp(x)


def conv(x, w, b, lowp: LowP, stride: int = 1, padding: int = 0):
    return F.conv2d(_q(x, lowp), _q(w, lowp), None if b is None else _q(b, lowp),
                    stride=stride, padding=padding)


def conv_t(x, w, b, lowp: LowP, padding: int = 0):
    return F.conv_transpose2d(_q(x, lowp), _q(w, lowp), _q(b, lowp), stride=2,
                              padding=padding)


def linear(x, P: Params, name: str, lowp32: LowP = None):
    """An f32 Dense: x W^T + b (x and W rounded by `lowp32`)."""
    return F.linear(_q(x, lowp32), _q(P[f"{name}.weight"], lowp32), P.get(f"{name}.bias"))


def frame_encoder(P: Params, frames, channels: Sequence[int], lowp: LowP, prefix="frame_enc"):
    """4x4 / stride-2 convs with relu: (N, 1, 64, 64) -> (N, C, g, g)."""
    h = frames
    for i in range(len(channels)):
        h = F.relu(conv(h, P[f"{prefix}.Conv_{i}.weight"], P[f"{prefix}.Conv_{i}.bias"],
                        lowp, stride=2, padding=1))
    return h


def frame_decoder(P: Params, h, lowp: LowP, prefix="frame_dec"):
    """The "fast" frame decoder: a 2x2 transpose, a 3x3 mix, 2x2 transposes
    to 1 channel; relu after every layer but the last.  (N, F, g, g) ->
    f32 logits (N, 64, 64)."""
    layers = ("ConvTranspose_0", "Conv_0", "ConvTranspose_1", "ConvTranspose_2")
    for i, name in enumerate(layers):
        w, b = P[f"{prefix}.{name}.weight"], P[f"{prefix}.{name}.bias"]
        h = conv_t(h, w, b, lowp) if name.startswith("ConvTranspose") else \
            conv(h, w, b, lowp, padding=1)
        if i + 1 < len(layers):
            h = F.relu(h)
    return _q(h, lowp)[:, 0]


def lstm_cell(gates, c, lowp: LowP):
    """Gates i, f, g, o along dim 1, forget bias +1: (c, h)."""
    gates = _q(gates, lowp)
    i, f, g, o = gates.chunk(4, dim=1)
    c = _q(torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g), lowp)
    h = _q(torch.sigmoid(o) * torch.tanh(c), lowp)
    return c, h


def convlstm(xg_steps, w_hidden_oihw, c, h, steps: int, lowp: LowP, hidden_conv=None):
    """A ConvLSTM over `steps` steps: gates = xg_t + convkxk(h), SAME, k odd
    from the OIHW hidden kernel.  `xg_steps` is (B, T, 4F, g, g) or, for a
    time-constant drive, (B, 1, 4F, g, g); c and h are NCHW.  Returns (c_T,
    h_T, [h_1 .. h_T]).  `hidden_conv` replaces the hidden product (the FLOP
    count's)."""
    hidden_conv = hidden_conv or (
        lambda h_, w: conv(h_, w, None, lowp, padding=w.shape[-1] // 2))
    hs = []
    for t in range(steps):
        xg = xg_steps[:, 0 if xg_steps.shape[1] == 1 else t]
        c, h = lstm_cell(xg + hidden_conv(h, w_hidden_oihw), c, lowp)
        hs.append(h)
    return c, h, hs


def proj_drive(P: Params, feats, name: str, lowp: LowP):
    """A 1x1 input projection of NHWC features (B, T, g, g, C): the drive
    (B, T, 4F, g, g)."""
    xg = _q(feats, lowp) @ _q(P[f"{name}.input.weight"], lowp) + _q(P[f"{name}.input.bias"], lowp)
    return xg.permute(0, 1, 4, 2, 3)


def sample(mu, logvar, eps):
    return mu + torch.exp(0.5 * logvar) * eps


def bce_sum(logits, x):
    """Bernoulli cross-entropy of logits against x, summed; its gradient is
    sigmoid(logits) - x everywhere, 0 included."""
    return F.binary_cross_entropy_with_logits(logits, x, reduction="sum")


def kl_sum(mu, logvar):
    return -0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar))


def gaussian_kl(mu_q, logvar_q, mu_p, logvar_p):
    return 0.5 * torch.sum(logvar_p - logvar_q
                           + (torch.exp(logvar_q) + (mu_q - mu_p) ** 2) * torch.exp(-logvar_p)
                           - 1.0)


# --- parameters ------------------------------------------------------------------


def conv_spec(name: str, cin: int, cout: int, k: int, bias: bool = True) -> list:
    out = [(f"{name}.weight", (cout, cin, k, k), cin * k * k)]
    return out + ([(f"{name}.bias", (cout,), 0)] if bias else [])


def conv_t_spec(name: str, cin: int, cout: int, k: int) -> list:
    return [(f"{name}.weight", (cin, cout, k, k), cin * k * k), (f"{name}.bias", (cout,), 0)]


def linear_spec(name: str, cin: int, cout: int, bias: bool = True) -> list:
    out = [(f"{name}.weight", (cout, cin), cin)]
    return out + ([(f"{name}.bias", (cout,), 0)] if bias else [])


def encoder_spec(channels: Sequence[int], prefix="frame_enc") -> list:
    out, cin = [], 1
    for i, ch in enumerate(channels):
        out += conv_spec(f"{prefix}.Conv_{i}", cin, ch, 4)
        cin = ch
    return out


def decoder_spec(cin: int, channels: Sequence[int], prefix="frame_dec") -> list:
    """The "fast" decoder over channels (c0, c1, c2): transpose to c0, mix to
    c1, transpose to c2, transpose to 1."""
    c0, c1, c2 = channels
    return (conv_t_spec(f"{prefix}.ConvTranspose_0", cin, c0, 2)
            + conv_spec(f"{prefix}.Conv_0", c0, c1, 3)
            + conv_t_spec(f"{prefix}.ConvTranspose_1", c1, c2, 2)
            + conv_t_spec(f"{prefix}.ConvTranspose_2", c2, 1, 2))


def lstm_proj_spec(name: str, cin: int, f: int) -> list:
    """A ConvLSTM with a 1x1 projection: HWIO hidden kernel, (C, 4F) matrix."""
    return [(f"{name}.step.hidden.weight", (3, 3, f, 4 * f), 9 * f),
            (f"{name}.input.weight", (cin, 4 * f), cin), (f"{name}.input.bias", (4 * f,), 0)]


def lstm_conv_spec(name: str, cin: int, f: int) -> list:
    """A ConvLSTM with a 3x3 input conv: both kernels OIHW."""
    return [(f"{name}.step.hidden.weight", (4 * f, f, 3, 3), 9 * f)] + \
        conv_spec(f"{name}.input", cin, 4 * f, 3)


def init_params(spec, seed: int, device) -> Params:
    """Weights from `seed`, made on `device` in one draw: a standard normal
    for every weight element at once, each leaf scaled to lecun-normal
    (1 / sqrt(fan in), corrected for the truncation) and cut at two
    standard deviations; biases zero.  The same seed on the same kind of
    device gives the same weights."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, fan in spec if fan]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for name, shape, fan in spec:
        if not fan:
            out[name] = torch.zeros(shape, device=device, dtype=torch.float32)
            continue
        n = math.prod(shape)
        std = math.sqrt(1.0 / fan) / _TRUNC_STD
        out[name] = (flat[pos:pos + n].clamp(-2.0, 2.0) * std).reshape(shape)
        pos += n
    return out
