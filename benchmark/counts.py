"""The work a train step needs: the recurrences' bound and the step's model
FLOPs, from the cell's sizes alone.

`recurrence_bound_ms` is the least time of every ConvLSTM recurrence of a
step, forward (saving) and backward, each as the port's K5 (a 1x1
projection inside) or K6 (a time-constant drive) counts it in bf16: the
products of the 3x3 hidden conv over the taps inside the image only, the
projection's products, and each input and output byte once; each call's
operations over 989 TFLOP/s or its bytes over 3.35 TB/s, whichever is
larger, summed over the calls.  It is the same work whether the program
runs a kernel or an eager loop.  A frozen copy of the K5/K6 rows of
`mmvae_torch/bench/roofline.py` as of this benchmark.

`flops_per_step` counts the products of one train step of the global
batch on the reference model on the `meta` device: every product of the
forward once and those of the backward as autograd computes them
(`torch.utils.flop_counter`), recompute not counted, no elementwise work;
the recurrences' 3x3 hidden products are taken from their shapes over the
taps inside the image, as the kernels compute them.
"""

from __future__ import annotations

import importlib
from typing import List, Tuple

import torch

BF16_TENSOR_FLOPS = 989e12  # dense bf16, one H100 SXM at 700 W
HBM_BYTES = 3.35e12         # bytes/s
_E = 2                      # bytes of a bf16 activation


def taps(h: int, w: int) -> int:
    """(position, tap) pairs of a 3x3 SAME conv whose tap lies in the image."""
    return (3 * h - 2) * (3 * w - 2)


def k5_work(b, t, h, w, c, f, backward: bool) -> Tuple[float, float]:
    """(operations, bytes) of K5 at (B, T, H, W, C, F): forward saving its
    residuals, or its backward."""
    rows, f4, k = b * t * h * w, 4 * f, c + 9 * f
    state = 4 * b * h * w * f * _E
    weights = k * f4 * _E + f4 * _E
    x, hs, gates = rows * c * _E, rows * f * _E, rows * f4 * _E
    proj, conv = 2.0 * rows * c * f4, 2.0 * b * t * taps(h, w) * f * f4
    if not backward:
        return proj + conv, float(x + 2 * hs + gates + weights + state)
    return 2 * conv + 2 * proj, float(2 * x + 2 * hs + gates + weights + k * f4 * 4
                                      + f4 * 4 + state)


def k6_work(b, t, h, w, f, const: bool, backward: bool) -> Tuple[float, float]:
    """(operations, bytes) of K6 at (B, T, H, W, F), `const` for a
    time-constant drive: forward saving its residuals, or its backward."""
    rows, f4 = b * t * h * w, 4 * f
    xg = (b * h * w if const else rows) * f4 * _E
    hs, gates = rows * f * _E, rows * f4 * _E
    weights = 9 * f * f4 * _E
    state = 4 * b * h * w * f * _E
    fwd = 2.0 * b * t * taps(h, w) * f * f4
    if not backward:
        return fwd, float(xg + 2 * hs + gates + weights + state)
    dxg = xg * (2 if const else 1)
    return 2 * fwd, float(3 * hs + gates + dxg + weights + 9 * f * f4 * 4 + state)


def bound_ms(ops: float, nbytes: float) -> float:
    return max(ops / BF16_TENSOR_FLOPS, nbytes / HBM_BYTES) * 1e3


def recurrences(sizes: dict, batch: int) -> List[tuple]:
    """The step's recurrences at a batch of `batch` clips: ("k5", B, T, H, W,
    C, F) for an encoder with a 1x1 projection, ("k6", B, T, H, W, F) for a
    decoder driven by a time-constant token."""
    ch, f = sizes["enc_channels"], sizes["lstm_features"]
    g, t = 64 // 2 ** len(ch), sizes["seq_len"]
    if "chunk_len" in sizes:
        tc = sizes["chunk_len"]
        n = batch * (t // tc)
        return [("k5", n, tc, g, g, ch[-1], f), ("k6", n, tc, g, g, f)]
    return [("k5", batch, t, g, g, ch[-1], f), ("k6", batch, t, g, g, f)]


def recurrence_bound_ms(sizes: dict, batch: int) -> float:
    """The least ms of a step's recurrences, forward and backward."""
    total = 0.0
    for kind, *shape in recurrences(sizes, batch):
        for backward in (False, True):
            work = k5_work(*shape, backward) if kind == "k5" else \
                k6_work(*shape, True, backward)
            total += bound_ms(*work)
    return total


def _hidden_products(sizes: dict, batch: int) -> float:
    """The recurrences' 3x3 hidden products of a step, forward and backward
    (the backward twice the forward: dh and dW)."""
    total = 0.0
    for kind, b, t, h, w, *rest in recurrences(sizes, batch):
        f = rest[-1]
        total += 3 * 2.0 * b * t * taps(h, w) * f * 4 * f
    return total


class _Uncounted(torch.autograd.Function):
    """A 3x3 SAME conv whose products the FLOP counter does not see, either
    way (its count is `_hidden_products`)."""

    @staticmethod
    def forward(ctx, h, w):
        from torch.utils._python_dispatch import _disable_current_modes

        ctx.save_for_backward(h, w)
        with _disable_current_modes():
            return torch.nn.functional.conv2d(h, w, padding=1)

    @staticmethod
    def backward(ctx, g):
        from torch.utils._python_dispatch import _disable_current_modes

        h, w = ctx.saved_tensors
        with _disable_current_modes():
            dh = torch.nn.grad.conv2d_input(h.shape, w, g, padding=1)
            dw = torch.nn.grad.conv2d_weight(h, w.shape, g, padding=1)
        return dh, dw


def flops_per_step(sizes: dict, reference: str, batch: int) -> float:
    """Model FLOPs of one train step at `batch` clips (see the module
    docstring), counted on the reference model `reference`."""
    from torch.utils.flop_counter import FlopCounterMode

    ref = importlib.import_module(f"benchmark.reference.{reference}")
    params = {n: torch.empty(shape, device="meta", requires_grad=True)
              for n, shape, _ in ref.spec(sizes)}
    x = torch.empty(batch, sizes["seq_len"], 64, 64, device="meta")
    eps = {s: torch.empty(shape, device="meta")
           for s, shape in ref.eps_shapes(sizes, batch).items()}
    with FlopCounterMode(display=False) as counter:
        ref.loss(params, x, eps, sizes, hidden_conv=_Uncounted.apply).backward()
    return float(counter.get_total_flops()) + _hidden_products(sizes, batch)
