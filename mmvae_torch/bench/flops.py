"""Model FLOPs of one train step, and the card's peak for MFU.

`flops_per_step(cfg)` counts the products of one train step of the global
batch (`data.batch_size`): every product of the forward once, and those of
the backward as autograd computes them, which is twice the forward's (the
input and the weight gradients) except where an input needs no gradient
(the first layer's frames: its weight gradient only).  Remat's recompute is
not counted (the count runs with remat off), nor elementwise work, the
loss's reductions or the optimizer.  The ConvLSTM kernels' products (K5,
K6) are taken from their shapes with `bench.roofline.kernel_products`,
which counts a 3x3 conv's taps inside the image only, as the kernels
compute them; every other product (cuBLAS's and cuDNN's, and the Gaussian
head's, which are the two f32 products the fused kernel computes) is
counted from its shape by `torch.utils.flop_counter.FlopCounterMode`, padded
taps included, as the library computes them.  The step runs on the `meta`
device through the plain route: nothing is computed and no memory is
allocated, so a full-width count takes well under a second.

The JAX bench's number is not comparable: XLA's cost analysis counts a
scan body once (mmvae_tpu/bench/throughput.py:152-154), so a recurrence's
products count for one time step, and it counts remat's recompute.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Optional

import torch

# Dense bf16 tensor-core peak (TFLOP/s) of a card, by a substring of its
# name (NVIDIA's data sheets, without sparsity): the MFU denominator, as the
# JAX bench takes each chip's bf16 peak for its f32 configs too.
_PEAK_BF16_TFLOPS = (
    ("h100 pcie", 756.0),
    ("h100", 989.0),   # SXM ("NVIDIA H100 80GB HBM3")
    ("h200", 989.0),
)


def peak_bf16_tflops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak in TFLOP/s, None for a card not listed."""
    name = device_name.lower()
    return next((peak for sub, peak in _PEAK_BF16_TFLOPS if sub in name), None)


@contextlib.contextmanager
def _kernel_products(total: list):
    """While active, each ConvLSTM kernel wrapper adds its products
    (`roofline.kernel_products` at its call's shape) to total[0] and runs its
    plain version outside the enclosing FlopCounterMode, so the plain
    version's own products are not counted twice."""
    from torch.utils._python_dispatch import _disable_current_modes

    from mmvae_torch.bench.roofline import kernel_products
    from mmvae_torch.ops import convlstm_kernels as ck

    def proj_key(x, wx, *rest):
        return (*x.shape, wx.shape[1] // 4)

    def scan_fwd_key(xg, w, c0, h0, length, *rest):
        b, t_in, h, w_, f4 = xg.shape
        return (b, length or t_in, h, w_, f4 // 4, t_in == 1)

    def scan_bwd_key(w, c0, h0, hs, cs, ga, dh, dc_last, const_input, last_only):
        b, h, w_, f = c0.shape
        return (b, hs.shape[1], h, w_, f, const_input)

    wrapped = {"convlstm_proj_forward": proj_key, "convlstm_proj_backward": proj_key,
               "convlstm_scan_forward": scan_fwd_key, "convlstm_scan_backward": scan_bwd_key}
    real = {name: getattr(ck, name) for name in wrapped}

    def counting(name):
        def call(*args):
            total[0] += kernel_products(name, wrapped[name](*args))
            with _disable_current_modes():
                return real[name](*args)

        return call

    try:
        for name in wrapped:
            setattr(ck, name, counting(name))
        yield
    finally:
        for name, fn in real.items():
            setattr(ck, name, fn)


def _zero_noise(mu, logvar, salt=0):
    """The sample without a draw: z = mu + exp(logvar / 2) * 0."""
    return mu + torch.exp(0.5 * logvar) * torch.zeros_like(mu)


def flops_per_step(cfg) -> float:
    """Model FLOPs of one train step of `cfg`'s global batch (see the module
    docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from mmvae_torch.models import MODEL_REGISTRY
    from mmvae_torch.ops import dispatch
    from mmvae_torch.train.loop import _DTYPES, _sample_shape

    cls = MODEL_REGISTRY[cfg.model.name]
    kwargs = dict(cfg.model.kwargs)
    if "remat" in inspect.signature(cls).parameters:
        kwargs["remat"] = False
    dtype = _DTYPES[cfg.model.dtype]
    model = cls(**kwargs, dtype=dtype, device="meta")
    frame_dtype = torch.bfloat16 if cfg.data.binarize and dtype == torch.bfloat16 \
        else torch.float32
    x = torch.empty(_sample_shape(cfg), dtype=frame_dtype, device="meta")
    kernels = [0.0]
    with FlopCounterMode(display=False) as counter, _kernel_products(kernels):
        out = model(x, _zero_noise)
        bce, kl = dispatch.elbo_parts(out.logits, out.target, out.mu, out.logvar)
        ((bce + kl + out.extra_kl) / x.shape[0]).backward()
    return float(counter.get_total_flops()) + kernels[0]
