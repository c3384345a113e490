"""The least time the H100 could take for each kernel's work.

`kernel_work(name, shape)` counts the operations and bytes one call of a
kernel wrapper needs at `shape`: each input read once, each output written
once, whatever the kernel reads again; a 3x3 conv's products count only
for the taps inside the image, not those on its zero padding (at 8x8, 484
of 576).  `bound(name, shape)` turns them into
milliseconds against the published peaks of one H100 SXM (NVIDIA's data
sheet, dense, at the full 700 W power limit): the larger of operations over
the peak rate of their type and bytes over the memory rate.  The ConvLSTM
kernels (K5, K6) run their products on the tensor cores in bf16 or, with
f32 activations, f32-accurate: the card's fastest f32-accurate product rate
is three TF32 passes (3xTF32: each operand split into a TF32 hi and lo
part, hi hi + hi lo + lo hi) at 494.7 TFLOP/s dense, about 165 TFLOP/s of
f32 products, so an f32 recurrence is bounded at that rate (at F32_FLOPS,
67 TFLOP/s outside the tensor cores, a 3xTF32 kernel could read over 100 %
of its bound).  The Gaussian head's products run on the tensor cores as
split TF32 too (f32-accurate, as the reference computes the posterior):
three passes at the TF32 rate, or two where one operand is a bf16 x (exact
in TF32, so its lo pass is zero and the kernels skip it): the forward and
dW, not dx = D W.  The others do f32 work outside the tensor cores.

Shapes, as `chip_smoke.path_shapes` keys them:

    preprocess_gather        (rows in the set, frames a row, batch[, bytes of an
                             output element, default 2: bf16])
    elbo_reduce              ((logits shape), (mu shape)[, bytes of an x element,
                             default 2: bf16])
    reparameterize           (mu shape)
    head_sample_forward      (M, K, N, bytes of an x element): x (M, K), latent N
    head_sample_backward     (M, K, N, bytes of an x element)
    convlstm_proj_forward    (B, T, H, W, C, F[, bytes of an activation, default
                             2: bf16; 4: f32]), saving residuals
    convlstm_proj_forward_nores  (B, T, H, W, C, F[, bytes]), no grad: (h_T, c_T) only
    convlstm_proj_backward   (B, T, H, W, C, F[, bytes])
    convlstm_scan_forward    (B, T, H, W, F, const[, bytes]), saving residuals
    convlstm_scan_forward_hs     (B, T, H, W, F, const[, bytes]), no grad: every h_t
                             and c_T
    convlstm_scan_forward_last   (B, T, H, W, F, const[, bytes]), no grad: (h_T, c_T)
                             only
    convlstm_scan_backward   (B, T, H, W, F, const[, bytes]), per-step dhs

The ConvLSTM kernels' activations, weights, residuals and dgates are of
the activation's size; their weight gradients are f32 either way.

A forward without residuals does the operations of the one that saves
them; only its bytes are fewer.
"""

from __future__ import annotations

import math
from typing import Tuple

BF16_TENSOR_FLOPS = 989e12  # dense bf16 on the tensor cores
TF32_TENSOR_FLOPS = 494.7e12  # dense TF32 on the tensor cores
TF32_3X_FLOPS = TF32_TENSOR_FLOPS / 3  # f32-accurate products as 3xTF32
F32_FLOPS = 67e12           # f32 outside the tensor cores
HBM_BYTES = 3.35e12         # bytes/s

# Operations per element of the elementwise kernels (exp, log and the
# Philox rounds each counted as one).
_BCE_OPS = 8      # max, mul, sub, abs, neg, exp, log1p, add
_KL_OPS = 6       # 1 + lv - mu^2 - e^lv, summed
_REPARAM_OPS = 24  # Philox-4x32 per 4 draws, Box-Muller, exp, fma
_BINARIZE_OPS = 12  # Philox per 4 bytes, compare, convert



def _n(shape) -> int:
    return math.prod(shape)


def _taps(h: int, w: int) -> int:
    """(position, tap) pairs of a 3x3 SAME conv on an h x w image whose tap
    lies inside it: (3h - 2)(3w - 2) of 9hw, the rest read the zero pad."""
    return (3 * h - 2) * (3 * w - 2)


def kernel_work(name: str, shape) -> Tuple[float, float]:
    """(operations, bytes) of one call of kernel wrapper `name` at `shape`."""
    if name == "preprocess_gather":
        _, t, b, *out_bytes = shape
        n = b * t * 64 * 64
        ob = out_bytes[0] if out_bytes else 2
        return float(n * _BINARIZE_OPS), float(n * 1 + n * ob + b * 8)  # u8 in, frames out
    if name == "elbo_reduce":
        big, small, *x_bytes = shape
        n, k = _n(big), _n(small)
        xb = x_bytes[0] if x_bytes else 2
        return (float(n * _BCE_OPS + k * _KL_OPS),
                float(n * 4 + n * xb + 2 * k * 4 + 2 * 4))  # f32 logits, x, f32 mu/lv
    if name == "reparameterize":
        n = _n(shape)
        return float(n * _REPARAM_OPS), float(3 * n * 4)  # mu, logvar in; z out
    if name.startswith("head_sample"):
        m, k, n, xb = shape
        x, w, mn = m * k * xb, 2 * n * k * 4, m * n * 4
        products = 2.0 * m * k * 2 * n  # x against W_mu and W_lv
        if name == "head_sample_forward":
            # x, both weights and biases in; mu, logvar, z and z - mu out
            return products + m * n * (_REPARAM_OPS + 2), float(x + w + 2 * n * 4 + 4 * mn)
        # x, weights, z - mu and the three cotangents in; dx, dW, db out: dx
        # and dW each the products' count again, plus the dmu/dlv prologue
        return 2 * products + m * n * 4, float(x + w + 4 * mn + x + w + 2 * n * 4)
    if name.startswith("convlstm_proj"):
        b, t, h, w, c, f, *act = shape
        e = act[0] if act else 2
        rows, f4, k = b * t * h * w, 4 * f, c + 9 * f
        state = 4 * b * h * w * f * e  # c0, h0 and (c_T, h_T) or (dc0, dh0)
        weights = k * f4 * e + f4 * e
        x, hs, gates = rows * c * e, rows * f * e, rows * f4 * e
        # the x projection, then the conv over the taps inside the image
        proj, conv = 2.0 * rows * c * f4, 2.0 * b * t * _taps(h, w) * f * f4
        if name == "convlstm_proj_forward":
            return proj + conv, float(x + 2 * hs + gates + weights + state)
        if name == "convlstm_proj_forward_nores":
            return proj + conv, float(x + weights + state)
        # dh (transposed conv), dW, dWx, dx; x, hs, cs, gates in; dx out;
        # weights in, their f32 gradients out
        return 2 * conv + 2 * proj, float(2 * x + 2 * hs + gates + weights + k * f4 * 4
                                          + f4 * 4 + state)
    if name.startswith("convlstm_scan"):
        b, t, h, w, f, const, *act = shape
        e = act[0] if act else 2
        rows, f4 = b * t * h * w, 4 * f
        xg = (b * h * w if const else rows) * f4 * e
        hs, gates = rows * f * e, rows * f4 * e
        weights = 9 * f * f4 * e
        state = 4 * b * h * w * f * e
        fwd = 2.0 * b * t * _taps(h, w) * f * f4
        if name == "convlstm_scan_forward":
            return fwd, float(xg + 2 * hs + gates + weights + state)
        if name == "convlstm_scan_forward_hs":  # c0, h0 in; hs and c_T out
            return fwd, float(xg + hs + weights + state * 3 // 4)
        if name == "convlstm_scan_forward_last":
            return fwd, float(xg + weights + state)
        # hs, cs, gates, dhs in; dxg (f32 sum for a const input) and dW out
        dxg = xg * (2 if const else 1)
        return 2 * fwd, float(3 * hs + gates + dxg + weights + 9 * f * f4 * 4 + state)
    raise KeyError(f"kernel_work: unknown kernel {name!r}")


def kernel_products(name: str, shape) -> float:
    """The multiply-add operations (2 a product) of one call of kernel
    wrapper `name` at `shape`: the ConvLSTM kernels' work without their
    gate math (the model FLOPs of `bench.flops`)."""
    if name.startswith("convlstm_proj"):
        b, t, h, w, c, f = shape[:6]
        proj, conv = 2.0 * b * t * h * w * c * 4 * f, 2.0 * b * t * _taps(h, w) * f * 4 * f
        return 2 * (proj + conv) if name == "convlstm_proj_backward" else proj + conv
    if name.startswith("convlstm_scan"):
        b, t, h, w, f = shape[:5]
        conv = 2.0 * b * t * _taps(h, w) * f * 4 * f
        return 2 * conv if name == "convlstm_scan_backward" else conv
    raise KeyError(f"kernel_products: {name!r} is not a ConvLSTM kernel")


def bound(name: str, shape) -> Tuple[float, str]:
    """(least milliseconds, "bytes" or "operations") for one call."""
    ops, nbytes = kernel_work(name, shape)
    # the ConvLSTM kernels run their products on the tensor cores: bf16, or
    # f32 (an activation of 4 bytes) as 3xTF32; the head's are split TF32
    if name.startswith("convlstm"):
        peak = TF32_3X_FLOPS if tuple(shape[6:]) == (4,) else BF16_TENSOR_FLOPS
    elif name.startswith("head_sample"):
        passes = 3 if shape[3] == 4 else 2  # against x: three passes, two for a bf16 x
        # the backward's dW takes x's passes and dx three, over equal products
        peak = TF32_TENSOR_FLOPS / (passes if name == "head_sample_forward"
                                    else (passes + 3) / 2)
    else:
        peak = F32_FLOPS
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
