"""The work a train step needs: the recurrences' bound and the step's model
FLOPs, from the cell's sizes and its reference model's declarations.

Each reference module (`benchmark/reference/<name>.py`) declares the
recurrence calls of its train step in `recurrences(sizes, batch)`: for
each, the region the program opens around it, the forward's and the
backward's (operations, bytes), and the hidden conv's products that the
reference routes through `hidden_conv`, forward and backward.  A new
architecture declares its own there; nothing here changes.

`recurrence_bound_ms` is the least time of every recurrence of a step,
forward (saving) and backward: each call's operations over 989 TFLOP/s or
its bytes over 3.35 TB/s, whichever is larger, summed over the calls;
`bound_ms_by_region` the same by region.  `k5_work` and `k6_work` count
the port's K5 (a 1x1 projection inside) and K6 (a time-constant drive) in
bf16: the products of the k x k hidden conv over the taps inside the image
only, the projection's products, and each input and output byte once.  It
is the same work whether the program runs a kernel or an eager loop.  A
frozen copy of the K5/K6 rows of `mmvae_torch/bench/roofline.py` as of
this benchmark.

`flops_per_step` counts the products of one train step of the global
batch on the reference model on the `meta` device: every product of the
forward once and those of the backward as autograd computes them
(`torch.utils.flop_counter`), recompute not counted, no elementwise work;
the recurrences' hidden products are taken from their declarations, over
the taps inside the image, as the kernels compute them.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

import torch

BF16_TENSOR_FLOPS = 989e12  # dense bf16, one H100 SXM at 700 W
HBM_BYTES = 3.35e12         # bytes/s
_E = 2                      # bytes of a bf16 activation


def taps(h: int, w: int, k: int = 3) -> int:
    """(position, tap) pairs of a k x k SAME conv (k odd) whose tap lies in
    the image: along each axis k positions a tap less p (p + 1) for the
    p = (k - 1) / 2 taps that fall off each side."""
    off = (k * k - 1) // 4
    return (k * h - off) * (k * w - off)


def k5_work(b, t, h, w, c, f, backward: bool, k: int = 3) -> Tuple[float, float]:
    """(operations, bytes) of K5 at (B, T, H, W, C, F) with a k x k hidden
    conv: forward saving its residuals, or its backward."""
    rows, f4, kin = b * t * h * w, 4 * f, c + k * k * f
    state = 4 * b * h * w * f * _E
    weights = kin * f4 * _E + f4 * _E
    x, hs, gates = rows * c * _E, rows * f * _E, rows * f4 * _E
    proj, conv = 2.0 * rows * c * f4, 2.0 * b * t * taps(h, w, k) * f * f4
    if not backward:
        return proj + conv, float(x + 2 * hs + gates + weights + state)
    return 2 * conv + 2 * proj, float(2 * x + 2 * hs + gates + weights + kin * f4 * 4
                                      + f4 * 4 + state)


def k6_work(b, t, h, w, f, const: bool, backward: bool, k: int = 3) -> Tuple[float, float]:
    """(operations, bytes) of K6 at (B, T, H, W, F) with a k x k hidden
    conv, `const` for a time-constant drive: forward saving its residuals,
    or its backward."""
    rows, f4 = b * t * h * w, 4 * f
    xg = (b * h * w if const else rows) * f4 * _E
    hs, gates = rows * f * _E, rows * f4 * _E
    weights = k * k * f * f4 * _E
    state = 4 * b * h * w * f * _E
    fwd = 2.0 * b * t * taps(h, w, k) * f * f4
    if not backward:
        return fwd, float(xg + 2 * hs + gates + weights + state)
    dxg = xg * (2 if const else 1)
    return 2 * fwd, float(3 * hs + gates + dxg + weights + k * k * f * f4 * 4 + state)


def hidden_products(b, t, h, w, f, k: int = 3) -> float:
    """A recurrence's k x k hidden products over the taps inside the image,
    forward and backward (the backward twice the forward: dh and dW)."""
    return 3 * 2.0 * b * t * taps(h, w, k) * f * 4 * f


@dataclasses.dataclass(frozen=True)
class Recurrence:
    """One recurrence call of a train step, as a reference module declares
    it: the program's region around it, (operations, bytes) forward and
    backward, and the products of its hidden conv that the reference routes
    through `hidden_conv`, forward and backward."""

    region: str
    forward: Tuple[float, float]
    backward: Tuple[float, float]
    hidden_flops: float


def k5_call(region: str, b, t, h, w, c, f, k: int = 3) -> Recurrence:
    """A K5 call (a 1x1 input projection inside) as a reference declares it."""
    return Recurrence(region, k5_work(b, t, h, w, c, f, False, k),
                      k5_work(b, t, h, w, c, f, True, k), hidden_products(b, t, h, w, f, k))


def k6_call(region: str, b, t, h, w, f, const: bool = True, k: int = 3) -> Recurrence:
    """A K6 call (the drive computed outside) as a reference declares it."""
    return Recurrence(region, k6_work(b, t, h, w, f, const, False, k),
                      k6_work(b, t, h, w, f, const, True, k), hidden_products(b, t, h, w, f, k))


def bound_ms(ops: float, nbytes: float) -> float:
    return max(ops / BF16_TENSOR_FLOPS, nbytes / HBM_BYTES) * 1e3


def recurrences(sizes: dict, reference: str, batch: int) -> List[Recurrence]:
    """What the reference model `reference` declares of its step at a batch
    of `batch` clips."""
    return importlib.import_module(f"benchmark.reference.{reference}").recurrences(sizes, batch)


def bound_ms_by_region(declared: List[Recurrence]) -> Dict[str, float]:
    """{region: the least ms of its declared recurrences a step, forward and
    backward}."""
    out: Dict[str, float] = {}
    for r in declared:
        out[r.region] = out.get(r.region, 0.0) + bound_ms(*r.forward) + bound_ms(*r.backward)
    return out


def recurrence_bound_ms(declared: List[Recurrence]) -> float:
    """The least ms of a step's declared recurrences, forward and backward,
    added one by one in the step's order (`sum` compensates, and would move
    the last digit)."""
    total = 0.0
    for r in declared:
        total += bound_ms(*r.forward)
        total += bound_ms(*r.backward)
    return total


class _Uncounted(torch.autograd.Function):
    """A SAME conv of odd size whose products the FLOP counter does not see,
    either way (its count is what the recurrences declare)."""

    @staticmethod
    def forward(ctx, h, w):
        from torch.utils._python_dispatch import _disable_current_modes

        ctx.save_for_backward(h, w)
        with _disable_current_modes():
            return torch.nn.functional.conv2d(h, w, padding=w.shape[-1] // 2)

    @staticmethod
    def backward(ctx, g):
        from torch.utils._python_dispatch import _disable_current_modes

        h, w = ctx.saved_tensors
        pad = w.shape[-1] // 2
        with _disable_current_modes():
            dh = torch.nn.grad.conv2d_input(h.shape, w, g, padding=pad)
            dw = torch.nn.grad.conv2d_weight(h, w.shape, g, padding=pad)
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
    hidden = sum(r.hidden_flops for r in recurrences(sizes, reference, batch))
    return float(counter.get_total_flops()) + hidden
