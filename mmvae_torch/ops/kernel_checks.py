"""The ConvLSTM kernels (K5, K6) and the Gaussian head's kernels held against
their plain versions on the card.

One place for the inputs (made on the card from a seed), the comparisons and
their tolerances; `chip_smoke.py` and `tests/test_torch_cuda.py` both call
`compare_proj` and `compare_scan`.  Kernel and plain version round the same
operands to the activation dtype.  With bf16 activations:

- forward with f32 gates: each output (hs, cs, gates) within 2 bf16 ulps of
  its largest |ref|;
- forward with bf16 gates, which round the pointwise chain at every step on
  both sides: hs and gates within 0.05 absolute, the bf16 tolerance of
  tests/test_convlstm_fused.py; cs within 0.05 for K5, and within
  0.05 + 2^-6 |ref| for K6, whose cell state passes |c| = 8, where one
  bf16 ulp (0.0625) exceeds 0.05, and carries each step's rounding
  differences forward (about 3 ulps of |ref| after 20 steps on the H100);
- the residual-free forwards equal to the saving one exactly;
- both backward passes from the same residuals (an f32 chain whatever the
  gate dtype): each gradient within 2 bf16 ulps of its largest |ref|;
- the Gaussian head and its sample, f32-accurate products on both sides
  (the kernels' split TF32 against the plain f32) in other orders: mu,
  logvar, z (eps injected), z - mu and every f32 gradient within
  F32_UNITS f32 units u = sqrt(L) 2^-24 max|ref|, L the length of the
  sums behind the output (K forward; K + 2N + M for the gradients, which
  carry the forward's z - mu); a bf16 dx within 0.05.  The limit sits
  between the kernel's readings and those of the same products with their
  operands rounded to TF32 (`head_tf32_control`), which a 1xTF32 kernel
  would show, so a kernel that left f32 fails it.  A bf16 x's TF32 lo
  part is zero, and the bf16 kernels, which skip its pass, equal the f32
  kernels on the same x cast to f32 bit for bit (`head_lo_pass_same`).

The same readings hold K5 and K6 at every width they take, the 4-CTA
ones (F = 160-256) included, which `chip_smoke.py`'s phase 11 compares at
B = 64, T = 20.

With f32 activations (`act=torch.float32`, F <= 128) the plain version runs
with TF32 off whatever the caller set (`full_f32`), and:

- forward with f32 gates: each output within REC_F32_ULPS f32 ulps of its
  largest |ref| (u = 2^-24 max|ref|); with bf16 gates the bf16-gate
  readings above;
- both backward passes, whatever the gate dtype: each gradient within
  REC_F32_ULPS f32 ulps of its largest |ref|.

The limit sits between the kernels' readings (3xTF32 products, about 2^-21
of a product) and those of the plain version with every product operand
rounded to TF32 (`proj_tf32_control`, `scan_tf32_control`: what a 1xTF32
kernel, or one that rounded an operand to bf16, would read), so a kernel
that left f32 fails it.  `wgrad_f64_readings` holds the f32 weight GEMM
alone against an f64 product, beside cuBLAS's f32 product.

The general kernels (`convlstm_kernels.route`: every shape outside the
wgmma kernels' domain) are held to the same readings, whatever their
activation dtype and F (`check_general`, at `GENERAL_SHAPES` in
`chip_smoke.py`'s phase 13): with f32 activations their products are f64
(the forwards, the BPTT, the weight GEMM) or 3xTF32 (K5's dx) on the
tensor cores, so the TF32 control fails them too.

`plain_route()` swaps every wrapper's CUDA branch for its plain version,
so a run on the card takes the model's own ops with no kernel of the repo:
the witness for a result of the kernels' route.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import List, NamedTuple

import torch

from mmvae_torch.ops import convlstm_kernels as ck
from mmvae_torch.ops import elbo_kernels as ek
from mmvae_torch.ops import head_kernels as hk
from mmvae_torch.ops import preprocess_kernels as pk


@contextlib.contextmanager
def plain_route():
    """A context in which every kernel wrapper's CUDA branch runs its plain
    version on the card (and counts no launch); the wrappers are restored
    on exit."""
    swaps = ((ck, "proj_forward_cuda", ck.proj_forward_plain),
             (ck, "proj_backward_cuda", ck.proj_backward_plain),
             (ck, "scan_forward_cuda", ck.scan_forward_plain),
             (ck, "scan_backward_cuda", ck.scan_backward_plain),
             (hk, "head_sample_forward_cuda", hk.head_sample_forward_plain),
             (hk, "head_sample_backward_cuda", hk.head_sample_backward_plain),
             (ek, "_elbo_reduce_cuda", ek.elbo_reduce_plain),
             (pk, "_preprocess_gather_cuda",
              lambda data, idx, seed, binarize, out_dtype: pk.preprocess_gather_plain(
                  data, idx, seed, binarize=binarize, out_dtype=out_dtype)))
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)

CS_RTOL = 2.0 ** -6  # K6's cs bound with bf16 gates: 0.05 + CS_RTOL |ref|
BF16_ATOL = 0.05
ULPS = 2.0
F32_UNITS = 4.0  # the head's f32 outputs, in u = sqrt(L) 2^-24 max|ref|
REC_F32_ULPS = 512.0  # K5's and K6's f32 outputs and gradients, in u = 2^-24 max|ref|


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN's convolutions and cuBLAS's matmuls (restored on
    exit): the plain versions' f32 products in f32."""
    kept = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = kept


class Reading(NamedTuple):
    value: float
    limit: float
    text: str


@dataclass
class Comparison:
    readings: List[Reading]
    fwd_err: float  # max|kernel - plain| over the forward outputs
    bwd_err: float  # the same over the gradients

    def text(self) -> str:
        return ", ".join(r.text for r in self.readings)

    def check(self, label: str) -> None:
        bad = [r for r in self.readings if not r.value <= r.limit]  # NaN fails too
        if bad:
            raise AssertionError(f"{label}: " + "; ".join(
                f"{r.text} over its limit {r.limit:g}" for r in bad))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| in bf16 ulps of b's largest magnitude."""
    m = float(b.detach().float().abs().max())
    return max_abs_err(a, b) / 2.0 ** (math.floor(math.log2(max(m, 2.0 ** -126))) - 7)


def _ulps(name, a, b) -> Reading:
    u = bf16_ulps(a, b)
    return Reading(u, ULPS, f"{name} {u:.2f} ulps")


def _scaled(name, a, b, rtol) -> Reading:
    """max |a - b| / (0.05 + rtol |b|), which must be <= 1."""
    a, b = a.detach().float(), b.detach().float()
    r = float(((a - b).abs() / (BF16_ATOL + rtol * b.abs())).max())
    bound = "0.05 + 2^-6|ref|" if rtol else "0.05"
    return Reading(r, 1.0, f"{name} {max_abs_err(a, b):.2e} ({r:.2f} of {bound})")


def f32_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| in f32 ulps of b's largest magnitude, u = 2^-24 max|b|."""
    m = float(b.detach().float().abs().max())
    return max_abs_err(a, b) / (2.0 ** -24 * max(m, 2.0 ** -126))


def _rec_f32(name, a, b) -> Reading:
    u = f32_ulps(a, b)
    return Reading(u, REC_F32_ULPS, f"{name} {u:.1f} f32 ulps")


def _grad(name, a, b) -> Reading:
    """A recurrence's gradient: in bf16 ulps, or in f32 ulps for f32."""
    return _rec_f32(name, a, b) if b.dtype == torch.float32 else _ulps(name, a, b)


def forward_readings(outs_k, outs_p, gate_dtype, cs_rtol) -> List[Reading]:
    names = ("hs", "cs", "gates")
    if gate_dtype == torch.float32:
        return [_grad(n, a, b) for n, a, b in zip(names, outs_k, outs_p)]
    return [_scaled(n, a, b, cs_rtol if n == "cs" else 0.0)
            for n, a, b in zip(names, outs_k, outs_p)]


def residual_free_readings(names, outs_k, outs_p, gate_dtype, cs_rtol) -> List[Reading]:
    """A residual-free forward's outputs (h_T or hs, then c_T) against the
    plain version's, at the saving forward's tolerances: 2 bf16 ulps (f32
    activations: REC_F32_ULPS f32 ulps) with f32 gates; with bf16 gates
    0.05, and 0.05 + cs_rtol |ref| for c_T."""
    if gate_dtype == torch.float32:
        return [_grad(n, a, b) for n, a, b in zip(names, outs_k, outs_p)]
    return [_scaled(n, a, b, cs_rtol if n.startswith("c") else 0.0)
            for n, a, b in zip(names, outs_k, outs_p)]


def _exact(name, pairs) -> Reading:
    e = max(max_abs_err(a, b) for a, b in pairs)
    return Reading(e, 0.0, f"{name} {e:.2e} from the saving forward")


def _randn(g, dev, shape, scale, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def proj_inputs(dev, b, t, h, w, c, f, seed, dtype=torch.bfloat16):
    """K5's (x, wx, bx, w, c0, h0) in `dtype` (bf16 or f32)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (_randn(g, dev, (b, t, h, w, c), 0.5, dtype),
            _randn(g, dev, (c, 4 * f), c ** -0.5, dtype),
            _randn(g, dev, (4 * f,), 0.1, dtype),
            _randn(g, dev, (3, 3, f, 4 * f), (9 * f) ** -0.5, dtype),
            _randn(g, dev, (b, h, w, f), 0.5, dtype), _randn(g, dev, (b, h, w, f), 0.5, dtype))


def scan_inputs(dev, b, t_in, h, w, f, seed, dtype=torch.bfloat16):
    """K6's (xg, w, c0, h0) in `dtype`; t_in = 1 for a time-constant xg."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (_randn(g, dev, (b, t_in, h, w, 4 * f), 0.5, dtype),
            _randn(g, dev, (3, 3, f, 4 * f), (9 * f) ** -0.5, dtype),
            _randn(g, dev, (b, h, w, f), 0.5, dtype), _randn(g, dev, (b, h, w, f), 0.5, dtype))


def compare_proj(dev, shape, gate_dtype, seed: int = 4, act=torch.bfloat16) -> Comparison:
    """K5 at shape (B, T, H, W, C, F) with `act` activations: the saving
    forward, the residual-free one, and the backward with random (dh_T,
    dc_T)."""
    x, wx, bx, w, c0, h0 = proj_inputs(dev, *shape, seed, act)
    outs_k = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, gate_dtype, True)
    with full_f32():
        outs_p = ck.proj_forward_plain(x, wx, bx, w, c0, h0, gate_dtype, True)
    h_l, c_l = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, gate_dtype, False)
    rd = [_exact("residual-free", ((h_l, outs_k[0][:, -1]), (c_l, outs_k[1][:, -1])))]
    rd += forward_readings(outs_k, outs_p, gate_dtype, cs_rtol=0.0)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dh = torch.randn(h_l.shape, generator=g, device=dev)
    dc = torch.randn(h_l.shape, generator=g, device=dev)
    gk = ck.proj_backward_cuda(x, wx, w, c0, h0, *outs_p, dh, dc)
    with full_f32():
        gp = ck.proj_backward_plain(x, wx, w, c0, h0, *outs_p, dh, dc)
    rd += [_grad(n, a, b) for n, a, b in zip(("dx", "dWx", "dbx", "dW", "dc0", "dh0"), gk, gp)]
    return Comparison(rd, max(max_abs_err(a, b) for a, b in zip(outs_k, outs_p)),
                      max(max_abs_err(a, b) for a, b in zip(gk, gp)))


def proj_tf32_control(dev, shape, seed: int = 4) -> dict:
    """What a 1xTF32 K5 would read against the plain version, in the units
    of `compare_proj` with f32 activations and gates and on its inputs: the
    plain forward and backward with every product operand rounded to TF32,
    against the same in f32.  {output name: f32 ulps}."""
    x, wx, bx, w, c0, h0 = proj_inputs(dev, *shape, seed, torch.float32)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with full_f32():
        outs = [ck.proj_forward_plain(x, wx, bx, w, c0, h0, torch.float32, True, tf32_operands=t)
                for t in (False, True)]
        dh = torch.randn(outs[0][0][:, -1].shape, generator=g, device=dev)
        dc = torch.randn(dh.shape, generator=g, device=dev)
        grads = [ck.proj_backward_plain(x, wx, w, c0, h0, *outs[0], dh, dc, tf32_operands=t)
                 for t in (False, True)]
    names = ("hs", "cs", "gates", "dx", "dWx", "dbx", "dW", "dc0", "dh0")
    return {n: f32_ulps(a, b) for n, a, b in zip(names, (*outs[1], *grads[1]),
                                                 (*outs[0], *grads[0]))}


def proj_backward_repeatable(dev, shape, seed: int = 12, act=torch.bfloat16) -> dict:
    """K5's backward twice on the same inputs (bf16 gates, `act`
    activations): {gradient name: bit-identical}.  The kernels sum in fixed
    orders, without float atomics."""
    x, wx, bx, w, c0, h0 = proj_inputs(dev, *shape, seed, act)
    res = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, torch.bfloat16, True)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dh = torch.randn(c0.shape, generator=g, device=dev)
    dc = torch.randn(c0.shape, generator=g, device=dev)
    first = ck.proj_backward_cuda(x, wx, w, c0, h0, *res, dh, dc)
    second = ck.proj_backward_cuda(x, wx, w, c0, h0, *res, dh, dc)
    return {n: torch.equal(a, b)
            for n, a, b in zip(("dx", "dWx", "dbx", "dW", "dc0", "dh0"), first, second)}


def scan_backward_repeatable(dev, shape, const: bool, seed: int = 14,
                             act=torch.bfloat16) -> dict:
    """K6's backward twice on the same inputs (bf16 gates, per-step dhs,
    `act` activations) at shape (B, T, H, W, F), time-constant or streaming
    xg: {gradient name: bit-identical}.  The kernels sum in fixed orders,
    without float atomics."""
    b, t, h, w, f = shape
    xg, wh, c0, h0 = scan_inputs(dev, b, 1 if const else t, h, w, f, seed, act)
    res = ck.scan_forward_cuda(xg, wh, c0, h0, t, torch.bfloat16, "save")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dhs = torch.randn(res[0].shape, generator=g, device=dev)
    dc = torch.randn(c0.shape, generator=g, device=dev)
    first = ck.scan_backward_cuda(wh, c0, h0, *res, dhs, dc, const, False)
    second = ck.scan_backward_cuda(wh, c0, h0, *res, dhs, dc, const, False)
    return {n: torch.equal(a, b_) for n, a, b_ in zip(("dxg", "dW", "dc0", "dh0"), first, second)}


def compare_scan(dev, shape, const: bool, gate_dtype, seed: int = 8,
                 act=torch.bfloat16) -> Comparison:
    """K6 at shape (B, T, H, W, F) with a time-constant or streaming xg and
    `act` activations: the saving forward, the two residual-free ones (every
    h_t; last-only), and the backward with per-step dhs and with dh_T once,
    both with a random dc_T."""
    b, t, h, w, f = shape
    xg, wh, c0, h0 = scan_inputs(dev, b, 1 if const else t, h, w, f, seed, act)
    outs_k = ck.scan_forward_cuda(xg, wh, c0, h0, t, gate_dtype, "save")
    with full_f32():
        outs_p = ck.scan_forward_plain(xg, wh, c0, h0, t, gate_dtype, "save")
    hs_k, c_k = ck.scan_forward_cuda(xg, wh, c0, h0, t, gate_dtype, "hs")
    hl_k, cl_k = ck.scan_forward_cuda(xg, wh, c0, h0, t, gate_dtype, "last")
    rd = [_exact("residual-free", ((hs_k, outs_k[0]), (c_k, outs_k[1][:, -1]),
                                   (hl_k, outs_k[0][:, -1]), (cl_k, outs_k[1][:, -1])))]
    rd += forward_readings(outs_k, outs_p, gate_dtype, cs_rtol=CS_RTOL)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dhs = torch.randn(outs_p[0].shape, generator=g, device=dev)
    dc = torch.randn(hl_k.shape, generator=g, device=dev)
    bwd_err = 0.0
    for last_only in (False, True):
        dh = dhs[:, -1] if last_only else dhs
        gk = ck.scan_backward_cuda(wh, c0, h0, *outs_p, dh, dc, const, last_only)
        with full_f32():
            gp = ck.scan_backward_plain(wh, c0, h0, *outs_p, dh, dc, const, last_only)
        for n, a, b_ in zip(("dxg", "dW", "dc0", "dh0"), gk, gp):
            n = f"last-only {n}" if last_only else n
            if a.shape != b_.shape:
                raise AssertionError(f"convlstm_scan {n}: shape {tuple(a.shape)} vs "
                                     f"{tuple(b_.shape)}")
            rd.append(_grad(n, a, b_))
        bwd_err = max(bwd_err, max(max_abs_err(a, b_) for a, b_ in zip(gk, gp)))
    return Comparison(rd, max(max_abs_err(a, b_) for a, b_ in zip(outs_k, outs_p)), bwd_err)


def scan_tf32_control(dev, shape, const: bool, seed: int = 8) -> dict:
    """K6's counterpart of `proj_tf32_control` (f32 gates, per-step dhs).
    {output name: f32 ulps}."""
    b, t, h, w, f = shape
    xg, wh, c0, h0 = scan_inputs(dev, b, 1 if const else t, h, w, f, seed, torch.float32)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with full_f32():
        outs = [ck.scan_forward_plain(xg, wh, c0, h0, t, torch.float32, "save",
                                      tf32_operands=tt) for tt in (False, True)]
        dhs = torch.randn(outs[0][0].shape, generator=g, device=dev)
        dc = torch.randn(dhs[:, -1].shape, generator=g, device=dev)
        grads = [ck.scan_backward_plain(wh, c0, h0, *outs[0], dhs, dc, const, False,
                                        tf32_operands=tt) for tt in (False, True)]
    names = ("hs", "cs", "gates", "dxg", "dW", "dc0", "dh0")
    return {n: f32_ulps(a, b_) for n, a, b_ in zip(names, (*outs[1], *grads[1]),
                                                   (*outs[0], *grads[0]))}


# The general kernels' shapes, (B, T, H, W, C, F) for K5 (K6 drops C), with
# their activation dtypes: the JAX package's small widths, the README's, odd
# grids and widths, F off the wgmma multiples (bf16), f32 above F = 128, a
# 16x16 grid at full width, and the lstm_features=192 probe in f32.
GENERAL_SHAPES = (
    ((2, 4, 16, 16, 16, 16), (torch.bfloat16, torch.float32)),
    ((2, 4, 16, 16, 8, 8), (torch.bfloat16, torch.float32)),
    ((1, 1, 9, 13, 24, 20), (torch.bfloat16, torch.float32)),
    ((4, 4, 8, 8, 128, 144), (torch.bfloat16,)),
    ((4, 4, 8, 8, 128, 288), (torch.bfloat16,)),
    ((4, 4, 8, 8, 128, 160), (torch.float32,)),
    ((4, 4, 8, 8, 128, 192), (torch.float32,)),
    ((4, 4, 8, 8, 128, 256), (torch.float32,)),
    ((64, 20, 16, 16, 128, 128), (torch.bfloat16, torch.float32)),
    ((64, 20, 8, 8, 128, 192), (torch.float32,)),
)


def check_general(dev, shape, act) -> dict:
    """K5 at `shape` (B, T, H, W, C, F) and K6 at it without C, on the
    general route, with `act` activations: every forward mode and both
    backward modes of each (time-constant and streaming xg) against their
    plain versions with both gate dtypes (`compare_proj`, `compare_scan`,
    which raise over a limit), then each backward twice on the same inputs.
    Raises unless the route is the general one for both.  Returns
    {"comparisons": [(label, Comparison)], "err": {wrapper: max abs err},
    "same": {backward output: bit-identical}}."""
    b, t, h, w, c, f = shape
    for cin in (c, None):
        way = ck.route(act, f, h * w, cin)
        if way != "general":
            raise AssertionError(f"{shape} ({act}, C={cin}) takes the {way} route")
    err = dict.fromkeys(("convlstm_proj_forward", "convlstm_proj_backward",
                         "convlstm_scan_forward", "convlstm_scan_backward"), 0.0)
    comparisons = []
    for gdt in (torch.float32, torch.bfloat16):
        cmp = compare_proj(dev, shape, gdt, act=act)
        label = f"convlstm_proj {shape} {act}, gates {gdt}"
        cmp.check(label)
        comparisons.append((label, cmp))
        err["convlstm_proj_forward"] = max(err["convlstm_proj_forward"], cmp.fwd_err)
        err["convlstm_proj_backward"] = max(err["convlstm_proj_backward"], cmp.bwd_err)
        for const in (True, False):
            cmp = compare_scan(dev, (b, t, h, w, f), const, gdt, act=act)
            label = (f"convlstm_scan {(b, t, h, w, f)} {'const' if const else 'streaming'} "
                     f"{act}, gates {gdt}")
            cmp.check(label)
            comparisons.append((label, cmp))
            err["convlstm_scan_forward"] = max(err["convlstm_scan_forward"], cmp.fwd_err)
            err["convlstm_scan_backward"] = max(err["convlstm_scan_backward"], cmp.bwd_err)
    same = {f"K5 {n}": v for n, v in proj_backward_repeatable(dev, shape, act=act).items()}
    for const in (True, False):
        same.update({f"K6 {'const' if const else 'streaming'} {n}": v for n, v in
                     scan_backward_repeatable(dev, (b, t, h, w, f), const, act=act).items()})
    return {"comparisons": comparisons, "err": err, "same": same}


def wgrad_f64_readings(dev, shape, seed: int = 3) -> dict:
    """The f32 weight GEMM (`mmvae_convlstm_wgrad`) alone at K5's shape (B,
    T, H, W, C, F), on random f32 x, hs, h0 and dgates, against the same
    product in f64, beside cuBLAS's f32 product (TF32 off) and the product
    of the operands rounded to TF32: {"kernel", "cuBLAS f32", "TF32
    operands": f32 ulps of the f64 result's largest magnitude}."""
    import torch.nn.functional as F

    from mmvae_torch.ops import _build

    b, t, h, w, c, f = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x, hs, dg = (torch.randn(b, t, h * w, n, generator=g, device=dev) for n in (c, f, 4 * f))
    h0 = torch.randn(b, h * w, f, generator=g, device=dev)
    splits = ck.proj_geometry(b, t, h, w, c, f, 4)["wgrad_splits"]
    m = c + 9 * f
    part = torch.empty(splits, m, 4 * f, device=dev)
    got = torch.empty(m, 4 * f, device=dev)
    err = _build.library().mmvae_convlstm_wgrad(
        x.data_ptr(), hs.data_ptr(), h0.data_ptr(), dg.data_ptr(), part.data_ptr(),
        got.data_ptr(), b, t, h, w, c, f, splits, ck._DTYPE_CODE[torch.float32],
        _build.stream_ptr(dev))
    _build.check(err, "convlstm_wgrad f32")
    # A: row r of [x; the 3x3 taps of h_{t-1}] in the kernel's (tap, f) order
    hprev = torch.cat([h0[:, None], hs[:, :-1]], 1).reshape(b * t, h, w, f).permute(0, 3, 1, 2)
    taps = F.unfold(hprev.double(), 3, padding=1).view(b * t, f, 9, h * w)
    a = torch.cat([x.reshape(-1, c).double(),
                   taps.permute(0, 3, 2, 1).reshape(-1, 9 * f)], 1)
    d = dg.reshape(-1, 4 * f)
    ref = a.t() @ d.double()
    with full_f32():
        cublas = a.float().t() @ d
    rounded = ck.tf32(a.float()).double().t() @ ck.tf32(d).double()
    u = 2.0 ** -24 * float(ref.abs().max())
    return {name: float((v.double() - ref).abs().max()) / u
            for name, v in (("kernel", got), ("cuBLAS f32", cublas), ("TF32 operands", rounded))}


HEAD_OUTS = ("mu", "logvar", "z", "z-mu")
HEAD_GRADS = ("dx", "dW_mu", "db_mu", "dW_logvar", "db_logvar")


def head_inputs(dev, m, k, n, x_dtype, seed):
    """The head's (x, w_mu, b_mu, w_lv, b_lv): x (m, k) in `x_dtype`, the
    rest f32 at nn.Linear's scale."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    return (r(m, k).to(x_dtype), r(n, k, scale=k ** -0.5), r(n, scale=0.1),
            r(n, k, scale=k ** -0.5), r(n, scale=0.1))


def head_cotangents(dev, m, n, seed):
    """(eps, g_mu, g_logvar, g_z), each (m, n) f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(m, n, generator=g, device=dev) for _ in range(4))


def _f32(name, a, b, length) -> Reading:
    """max|a - b| in f32 units u = sqrt(length) 2^-24 max|b|."""
    u = math.sqrt(length) * 2.0 ** -24 * max(float(b.detach().float().abs().max()), 2.0 ** -126)
    r = max_abs_err(a, b) / u
    return Reading(r, F32_UNITS, f"{name} {r:.2f} f32 units")


def _head_readings(prefix, outs, refs, shape) -> List[Reading]:
    """Readings of the forward's four outputs, or of the five gradients."""
    m, k, n, x_dtype = shape
    names = HEAD_OUTS if len(outs) == 4 else HEAD_GRADS
    rd = []
    for name, a, b in zip(names, outs, refs):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"head {name}: {tuple(a.shape)} {a.dtype} vs "
                                 f"{tuple(b.shape)} {b.dtype}")
        if name == "dx" and x_dtype == torch.bfloat16:
            rd.append(_scaled(prefix + name, a, b, 0.0))
        else:
            rd.append(_f32(prefix + name, a, b, k if len(outs) == 4 else k + 2 * n + m))
    return rd


def compare_head(dev, shape, seed: int = 20) -> Comparison:
    """The head at (M, K, N, x dtype): the forward kernel with eps injected
    against the plain version, then the op's backward through autograd
    with cotangents on mu, logvar and z, and the backward kernel with g_mu
    absent (None), each against the plain backward."""
    m, k, n, x_dtype = shape
    x, w_mu, b_mu, w_lv, b_lv = head_inputs(dev, m, k, n, x_dtype, seed)
    eps, *cot = head_cotangents(dev, m, n, seed + 1)
    outs_k = hk.head_sample_forward_cuda(x, w_mu, b_mu, w_lv, b_lv, 0, eps)
    outs_p = hk.head_sample_forward_plain(x, w_mu, b_mu, w_lv, b_lv, 0, eps)
    rd = _head_readings("", outs_k, outs_p, shape)
    leaves = [t.detach().clone().requires_grad_() for t in (x, w_mu, b_mu, w_lv, b_lv)]
    torch.autograd.backward(hk.gaussian_head_sample(*leaves, 0, eps), cot)
    gk = [leaves[i].grad for i in range(5)]
    gp = hk.head_sample_backward_plain(x, w_mu, w_lv, outs_p[3], *cot)
    rd += _head_readings("", gk, gp, shape)
    gk2 = hk.head_sample_backward_cuda(x, w_mu, w_lv, outs_p[3], None, cot[1], cot[2])
    gp2 = hk.head_sample_backward_plain(x, w_mu, w_lv, outs_p[3], None, cot[1], cot[2])
    rd += _head_readings("no g_mu: ", gk2, gp2, shape)
    return Comparison(rd, max(max_abs_err(a, b) for a, b in zip(outs_k, outs_p)),
                      max(max_abs_err(a, b) for a, b in zip((*gk, *gk2), (*gp, *gp2))))


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 `t` rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def head_tf32_control(dev, shape, seed: int = 20) -> dict:
    """What a 1xTF32 head would read against the plain version, in the
    units of `compare_head` and on its inputs: the plain products with
    their operands rounded to TF32 (x and the weights forward; D = [dmu |
    dlv], x and the weights backward).  {output name: f32 units} for the
    products: mu, logvar, dW_mu, dW_logvar and an f32 dx."""
    m, k, n, x_dtype = shape
    x, w_mu, b_mu, w_lv, b_lv = head_inputs(dev, m, k, n, x_dtype, seed)
    eps, g_mu, g_lv, g_z = head_cotangents(dev, m, n, seed + 1)
    outs_p = hk.head_sample_forward_plain(x, w_mu, b_mu, w_lv, b_lv, 0, eps)
    outs_t = hk.head_sample_forward_plain(_tf32(x).to(x_dtype), _tf32(w_mu), b_mu, _tf32(w_lv),
                                          b_lv, 0, eps)
    diff = outs_p[3]
    gp = hk.head_sample_backward_plain(x, w_mu, w_lv, diff, g_mu, g_lv, g_z)
    dmu, dlv = g_mu + g_z, g_lv + 0.5 * g_z * diff  # the plain backward's D
    gt = hk.head_sample_backward_plain(_tf32(x).to(x_dtype), _tf32(w_mu), _tf32(w_lv), diff,
                                       _tf32(dmu), _tf32(dlv), None)
    rd = _head_readings("", outs_t, outs_p, shape) + _head_readings("", gt, gp, shape)
    keep = {"mu", "logvar", "dW_mu", "dW_logvar"} | ({"dx"} if x_dtype == torch.float32 else set())
    return {r.text.split()[0]: r.value for r in rd if r.text.split()[0] in keep}


def head_backward_repeatable(dev, shape, seed: int = 24) -> dict:
    """The head's backward kernel twice on the same inputs: {gradient name:
    bit-identical}.  Every sum runs in a fixed order, without atomics."""
    m, k, n, x_dtype = shape
    x, w_mu, b_mu, w_lv, b_lv = head_inputs(dev, m, k, n, x_dtype, seed)
    eps, *cot = head_cotangents(dev, m, n, seed + 1)
    diff = hk.head_sample_forward_cuda(x, w_mu, b_mu, w_lv, b_lv, 0, eps)[3]
    first = hk.head_sample_backward_cuda(x, w_mu, w_lv, diff, *cot)
    second = hk.head_sample_backward_cuda(x, w_mu, w_lv, diff, *cot)
    return {nm: torch.equal(a, b) for nm, a, b in zip(HEAD_GRADS, first, second)}


def head_lo_pass_same(dev, shape, seed: int = 26) -> dict:
    """A bf16 x is exact in TF32, so the kernels skip its zero lo pass: the
    bf16 kernels (two passes against x) against the f32 kernels (three) on
    the same x cast to f32, forward (eps drawn) and backward, {output or
    gradient name: bit-identical}; the f32 dx is rounded to bf16 first."""
    m, k, n, x_dtype = shape
    x, w_mu, b_mu, w_lv, b_lv = head_inputs(dev, m, k, n, x_dtype, seed)
    cot = head_cotangents(dev, m, n, seed + 1)[1:]
    runs = []
    for xs in (x, x.float()):
        fwd = hk.head_sample_forward_cuda(xs, w_mu, b_mu, w_lv, b_lv, 5)
        dx, *rest = hk.head_sample_backward_cuda(xs, w_mu, w_lv, fwd[3], *cot)
        runs.append((*fwd, dx.to(x.dtype), *rest))
    return {nm: torch.equal(a, b) for nm, a, b in zip(HEAD_OUTS + HEAD_GRADS, *runs)}


def head_forward_repeatable(dev, shape, copies: int = 20, reps: int = 10,
                            seed: int = 60) -> dict:
    """The forward kernel (eps drawn, seed 7) over many launches, each
    output held bit-identical to the first launch on its inputs:
    {"warm": `copies * reps` launches back to back on one input;
    "cold": a CUDA graph of `copies` launches, each on its own copy of
    the inputs, replayed `reps` times; "two streams": `copies * reps`
    launches alternating between two streams with nothing between them}.
    The last CTA of a tile sums the others' partials when its ticket says
    they are in, so a lost or stale partial would show here."""
    m, k, n, x_dtype = shape
    ins = [head_inputs(dev, m, k, n, x_dtype, seed + i) for i in range(copies)]
    refs = [[t.clone() for t in hk.head_sample_forward_cuda(*c, 7)] for c in ins]

    def same(outs, ref) -> bool:
        return all(torch.equal(a, b) for a, b in zip(outs, ref))

    warm = [hk.head_sample_forward_cuda(*ins[0], 7) for _ in range(copies * reps)]
    res = {"warm": all(same(o, refs[0]) for o in warm)}
    del warm
    graph, ok = torch.cuda.CUDAGraph(), True
    with torch.cuda.graph(graph):
        outs = [hk.head_sample_forward_cuda(*c, 7) for c in ins]
    for _ in range(reps):
        graph.replay()
        torch.cuda.synchronize()
        ok = ok and all(same(o, r) for o, r in zip(outs, refs))
    res["cold"] = ok
    del graph, outs
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    runs = []
    for i in range(copies * reps):
        with torch.cuda.stream(streams[i % 2]):
            runs.append((i % copies, hk.head_sample_forward_cuda(*ins[i % copies], 7)))
    torch.cuda.synchronize()
    res["two streams"] = all(same(o, refs[j]) for j, o in runs)
    return res


def head_eps(dev, shape, seed: int, stream_seed: int) -> torch.Tensor:
    """The eps the forward kernel draws from `stream_seed`, recovered as
    (z - mu) / exp(logvar / 2)."""
    m, k, n, x_dtype = shape
    x, w_mu, b_mu, w_lv, b_lv = head_inputs(dev, m, k, n, x_dtype, seed)
    mu, logvar, z, diff = hk.head_sample_forward_cuda(x, w_mu, b_mu, w_lv, b_lv, stream_seed)
    return diff / torch.exp(0.5 * logvar)
