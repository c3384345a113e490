"""The ConvLSTM kernels (K5, K6) held against their plain versions on the card.

One place for the inputs (made on the card from a seed), the comparisons and
their tolerances; `chip_smoke.py` and `tests/test_torch_cuda.py` both call
`compare_proj` and `compare_scan`.  Kernel and plain version round the same
operands to bf16, the one activation dtype the kernels take:

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
  gate dtype): each gradient within 2 bf16 ulps of its largest |ref|.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple

import torch

from mmvae_torch.ops import convlstm_kernels as ck

CS_RTOL = 2.0 ** -6  # K6's cs bound with bf16 gates: 0.05 + CS_RTOL |ref|
BF16_ATOL = 0.05
ULPS = 2.0


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


def forward_readings(outs_k, outs_p, gate_dtype, cs_rtol) -> List[Reading]:
    names = ("hs", "cs", "gates")
    if gate_dtype == torch.float32:
        return [_ulps(n, a, b) for n, a, b in zip(names, outs_k, outs_p)]
    return [_scaled(n, a, b, cs_rtol if n == "cs" else 0.0)
            for n, a, b in zip(names, outs_k, outs_p)]


def _exact(name, pairs) -> Reading:
    e = max(max_abs_err(a, b) for a, b in pairs)
    return Reading(e, 0.0, f"{name} {e:.2e} from the saving forward")


def _randn(g, dev, shape, scale):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)


def proj_inputs(dev, b, t, h, w, c, f, seed):
    """K5's (x, wx, bx, w, c0, h0) in bf16."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (_randn(g, dev, (b, t, h, w, c), 0.5), _randn(g, dev, (c, 4 * f), c ** -0.5),
            _randn(g, dev, (4 * f,), 0.1), _randn(g, dev, (3, 3, f, 4 * f), (9 * f) ** -0.5),
            _randn(g, dev, (b, h, w, f), 0.5), _randn(g, dev, (b, h, w, f), 0.5))


def scan_inputs(dev, b, t_in, h, w, f, seed):
    """K6's (xg, w, c0, h0) in bf16; t_in = 1 for a time-constant xg."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (_randn(g, dev, (b, t_in, h, w, 4 * f), 0.5),
            _randn(g, dev, (3, 3, f, 4 * f), (9 * f) ** -0.5),
            _randn(g, dev, (b, h, w, f), 0.5), _randn(g, dev, (b, h, w, f), 0.5))


def compare_proj(dev, shape, gate_dtype, seed: int = 4) -> Comparison:
    """K5 at shape (B, T, H, W, C, F): the saving forward, the residual-free
    one, and the backward with random (dh_T, dc_T)."""
    x, wx, bx, w, c0, h0 = proj_inputs(dev, *shape, seed)
    outs_k = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, gate_dtype, True)
    outs_p = ck.proj_forward_plain(x, wx, bx, w, c0, h0, gate_dtype, True)
    h_l, c_l = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, gate_dtype, False)
    rd = [_exact("residual-free", ((h_l, outs_k[0][:, -1]), (c_l, outs_k[1][:, -1])))]
    rd += forward_readings(outs_k, outs_p, gate_dtype, cs_rtol=0.0)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dh = torch.randn(h_l.shape, generator=g, device=dev)
    dc = torch.randn(h_l.shape, generator=g, device=dev)
    gk = ck.proj_backward_cuda(x, wx, w, c0, h0, *outs_p, dh, dc)
    gp = ck.proj_backward_plain(x, wx, w, c0, h0, *outs_p, dh, dc)
    rd += [_ulps(n, a, b) for n, a, b in zip(("dx", "dWx", "dbx", "dW", "dc0", "dh0"), gk, gp)]
    return Comparison(rd, max(max_abs_err(a, b) for a, b in zip(outs_k, outs_p)),
                      max(max_abs_err(a, b) for a, b in zip(gk, gp)))


def proj_backward_repeatable(dev, shape, seed: int = 12) -> dict:
    """K5's backward twice on the same inputs (bf16 gates): {gradient name:
    bit-identical}.  The kernels sum in fixed orders, without float atomics."""
    x, wx, bx, w, c0, h0 = proj_inputs(dev, *shape, seed)
    res = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, torch.bfloat16, True)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dh = torch.randn(c0.shape, generator=g, device=dev)
    dc = torch.randn(c0.shape, generator=g, device=dev)
    first = ck.proj_backward_cuda(x, wx, w, c0, h0, *res, dh, dc)
    second = ck.proj_backward_cuda(x, wx, w, c0, h0, *res, dh, dc)
    return {n: torch.equal(a, b)
            for n, a, b in zip(("dx", "dWx", "dbx", "dW", "dc0", "dh0"), first, second)}


def scan_backward_repeatable(dev, shape, const: bool, seed: int = 14) -> dict:
    """K6's backward twice on the same inputs (bf16 gates, per-step dhs) at
    shape (B, T, H, W, F), time-constant or streaming xg: {gradient name:
    bit-identical}.  The kernels sum in fixed orders, without float atomics."""
    b, t, h, w, f = shape
    xg, wh, c0, h0 = scan_inputs(dev, b, 1 if const else t, h, w, f, seed)
    res = ck.scan_forward_cuda(xg, wh, c0, h0, t, torch.bfloat16, "save")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dhs = torch.randn(res[0].shape, generator=g, device=dev)
    dc = torch.randn(c0.shape, generator=g, device=dev)
    first = ck.scan_backward_cuda(wh, c0, h0, *res, dhs, dc, const, False)
    second = ck.scan_backward_cuda(wh, c0, h0, *res, dhs, dc, const, False)
    return {n: torch.equal(a, b_) for n, a, b_ in zip(("dxg", "dW", "dc0", "dh0"), first, second)}


def compare_scan(dev, shape, const: bool, gate_dtype, seed: int = 8) -> Comparison:
    """K6 at shape (B, T, H, W, F) with a time-constant or streaming xg: the
    saving forward, the two residual-free ones (every h_t; last-only), and
    the backward with per-step dhs and with dh_T once, both with a random
    dc_T."""
    b, t, h, w, f = shape
    xg, wh, c0, h0 = scan_inputs(dev, b, 1 if const else t, h, w, f, seed)
    outs_k = ck.scan_forward_cuda(xg, wh, c0, h0, t, gate_dtype, "save")
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
        gp = ck.scan_backward_plain(wh, c0, h0, *outs_p, dh, dc, const, last_only)
        for n, a, b_ in zip(("dxg", "dW", "dc0", "dh0"), gk, gp):
            n = f"last-only {n}" if last_only else n
            if a.shape != b_.shape:
                raise AssertionError(f"convlstm_scan {n}: shape {tuple(a.shape)} vs "
                                     f"{tuple(b_.shape)}")
            rd.append(_ulps(n, a, b_))
        bwd_err = max(bwd_err, max(max_abs_err(a, b_) for a, b_ in zip(gk, gp)))
    return Comparison(rd, max(max_abs_err(a, b_) for a, b_ in zip(outs_k, outs_p)), bwd_err)
