"""ConvLSTM with a hoisted input projection (port of mmvae_tpu/models/convlstm.py).

`ConvLSTM(cin, features, x_kernel=..., fused=...)`:

- x_kernel == 1 (the encoders of configs 3-5): the input projection is a
  (C, 4F) matrix and the hidden kernel stays HWIO (3, 3, F, 4F); otherwise
  (the decoders) the input projection is a conv and the hidden conv an OIHW
  `nn.Conv2d`.  Param names and layouts follow `convert.state_dict_from_flax`.
- The recurrence runs one of three ways (`runs_kernel`; the JAX module's
  `fused`, `mmvae_tpu/models/convlstm.py:224-307`):
  - the encoder fast path, `ops.convlstm_scan_proj` (K5, projection inside
    the kernel), for a 1x1 projection, need_hs=False and a streaming input,
    unless fused=False.  The JAX path also needs C % 128 == 0, a TPU
    lane-width condition;
  - `ops.convlstm_scan` (K6) after the hoisted projection: for every other
    recurrence under fused=True, and under fused=None (auto) for a
    streaming input and, on a CUDA tensor, for a time-constant one (xs of
    length 1 with `length=T`, the decoders) where the H100 ran K6 faster
    than the eager loop under remat: the 2-CTA wgmma kernels
    (`ops.convlstm_kernels.route`, F <= 128) with bf16 or f32 activations;
  - an eager loop of convs (the JAX `lax.scan`): fused=False, and a
    time-constant input under auto elsewhere: on the CPU and on `meta` (the
    JAX policy, which the TPU runs), and on the card at the 4-CTA widths and
    on the general route.
    `remat=True` recomputes each step in the backward
    (`torch.utils.checkpoint`); on the kernel paths it is ignored, with a
    warning when fused=True asked for it, as in JAX.
  A time-constant input is projected once on every path.  Each kernel
  wrapper runs its CUDA kernels for CUDA tensors with bf16 or f32
  activations at any shape, as the TPU kernels take any (the wgmma kernels
  in their domain, the general ones elsewhere; another dtype raises) and
  its plain version for CPU tensors.

Gate order i/f/g/o, forget bias +1; the pointwise chain and the cell state
run in `gate_dtype` (`_gate_math`).  The interface is NHWC like the JAX
module: state (c, h) each (B, H, W, F), xs (B, T, H, W, C), hs (B, T, H, W, F).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mmvae_torch.models.base import HWIOKernel, ProjMatrix
from mmvae_torch.ops.convlstm_kernels import (
    cluster_size,
    convlstm_scan,
    convlstm_scan_proj,
    route,
)

State = Tuple[torch.Tensor, torch.Tensor]


def runs_kernel(fused: Optional[bool], const: bool, device, dtype: torch.dtype, feat: int,
                hw: int) -> bool:
    """Whether a recurrence of F = `feat` channels over `hw` positions, its
    input time-constant or not (`const`), runs a kernel (K5 or K6) rather
    than the eager loop.  fused=True or False decides; under auto (None) a
    streaming input runs one, and a time-constant input does on a CUDA
    `device` where K6 ran faster than the eager loop under remat on an
    H100: bf16 or f32 activations on the wgmma kernels with two CTAs a
    sample (F <= 128).  Their 4-CTA widths (bf16 F = 160-256) and the
    general kernels ran slower, and keep the loop, as do the CPU and `meta`
    (the JAX policy)."""
    if fused is not None:
        return fused
    if not const:
        return True
    if torch.device(device).type != "cuda" or dtype not in (torch.bfloat16, torch.float32):
        return False
    return route(dtype, feat, hw) == "wgmma" and cluster_size(feat) == 2


def _gate_math(gates, c, out_dtype, compute_dtype=torch.float32):
    """i, f, g, o along dim 1 (NCHW); forget bias +1; returns (c, h)."""
    gates = gates.to(compute_dtype)
    i, f, g, o = gates.chunk(4, dim=1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + 1.0)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c.to(compute_dtype) + i * g
    h_new = o * torch.tanh(c_new)
    return c_new.to(out_dtype), h_new.to(out_dtype)


class ConvLSTM(nn.Module):
    def __init__(self, cin: int, features: int, *, kernel: int = 3,
                 x_kernel: Optional[int] = None, dtype=torch.float32,
                 gate_dtype=torch.float32, remat: bool = False,
                 fused: Optional[bool] = None, device=None):
        super().__init__()
        self.features = features
        self.kernel = kernel
        self.x_kernel = x_kernel or kernel
        self.dtype = dtype
        self.gate_dtype = gate_dtype
        self.remat = remat
        self.fused = fused
        f4 = 4 * features
        self.proj = self.x_kernel == 1
        self.step = nn.Module()
        if self.proj:
            self.input = ProjMatrix(cin, f4, device=device)
            self.step.hidden = HWIOKernel((kernel, kernel, features, f4), device=device)
        else:
            self.input = nn.Conv2d(cin, f4, self.x_kernel, padding=self.x_kernel // 2,
                                   device=device)
            self.step.hidden = nn.Conv2d(features, f4, kernel, padding=kernel // 2,
                                         bias=False, device=device)

    def _hidden_oihw(self):
        w = self.step.hidden.weight
        return w.permute(3, 2, 0, 1) if self.proj else w

    def _step(self, xg_t, c, h, w_h):
        # w_h and a time-constant xg_t come in f32 and are cast in each step,
        # as flax's scanned conv casts its kernel: autograd sums their
        # per-step gradients in f32, as JAX's scan does
        hg = F.conv2d(h.to(self.dtype), w_h.to(self.dtype), padding=self.kernel // 2)
        return _gate_math(
            xg_t.to(self.gate_dtype) + hg.to(self.gate_dtype), c, h.dtype,
            compute_dtype=self.gate_dtype,
        )

    def forward(self, state0: State, xs: torch.Tensor, *, length: Optional[int] = None,
                need_hs: bool = True) -> Tuple[State, Optional[torch.Tensor]]:
        b, t_in = xs.shape[:2]
        t = length or t_in
        const = t_in == 1 and t > 1
        fused = runs_kernel(self.fused, const, xs.device, self.dtype, self.features,
                            xs.shape[2] * xs.shape[3])
        dt = self.dtype
        c0, h0 = state0
        if fused and self.proj and not need_hs and not const:
            c_t, h_t = convlstm_scan_proj(
                xs.to(dt), self.input.weight.to(dt), self.input.bias.to(dt),
                self.step.hidden.weight.to(dt), c0.to(dt), h0.to(dt),
                gate_dtype=self.gate_dtype,
            )
            return (c_t, h_t), None

        # Hoisted input projection over all B*T_in frames (NHWC views; the
        # conv runs NCHW).
        flat = xs.reshape(b * t_in, *xs.shape[2:]).to(dt)
        if self.proj:
            xg = flat @ self.input.weight.to(dt) + self.input.bias.to(dt)
        else:
            xg = F.conv2d(flat.permute(0, 3, 1, 2), self.input.weight.to(dt),
                          self.input.bias.to(dt), padding=self.x_kernel // 2).permute(0, 2, 3, 1)
        xg = xg.reshape(b, t_in, *xg.shape[1:])
        if fused:
            if self.fused and self.remat:
                warnings.warn("ConvLSTM(fused=True): the K6 kernel keeps its own forward "
                              "residuals; remat is ignored on this path.", stacklevel=2)
            w = self.step.hidden.weight
            w_hwio = w if self.proj else w.permute(2, 3, 1, 0)
            return convlstm_scan(xg, w_hwio.to(dt), c0.to(dt), h0.to(dt), length=t,
                                 gate_dtype=self.gate_dtype, last_only=not need_hs)

        w_h = self._hidden_oihw()
        # a time-constant drive: one f32 copy for all T steps (see _step)
        x0 = xg[:, 0].permute(0, 3, 1, 2).float() if t_in == 1 else None
        c = c0.permute(0, 3, 1, 2)
        h = h0.permute(0, 3, 1, 2)
        hs = []
        for s in range(t):
            xg_t = x0 if x0 is not None else xg[:, s].permute(0, 3, 1, 2)
            if self.remat and torch.is_grad_enabled():
                # the step draws nothing from torch's RNG: no RNG state to
                # save and restore (which a CUDA graph capture would refuse)
                c, h = checkpoint(self._step, xg_t, c, h, w_h, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                c, h = self._step(xg_t, c, h, w_h)
            hs.append(h)
        hs = torch.stack(hs, dim=1).permute(0, 1, 3, 4, 2)
        return (c.permute(0, 2, 3, 1), h.permute(0, 2, 3, 1)), hs
