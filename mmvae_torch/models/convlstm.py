"""ConvLSTM with a hoisted input projection (port of mmvae_tpu/models/convlstm.py).

`ConvLSTM(cin, features, x_kernel=...)`:

- x_kernel == 1 (the encoder): the input projection is a (C, 4F) matrix and
  the hidden kernel stays HWIO (3, 3, F, 4F).  With need_hs=False and a
  streaming input, the whole recurrence runs in `ops.convlstm_scan_proj`
  (the CUDA kernel on the card, its plain version on the CPU), the
  counterpart of the JAX encoder's proj-fused Pallas path.  The JAX path
  also needs C % 128 == 0, a TPU lane-width condition.  The CUDA kernels
  have conditions of their own and raise where they are not met: bf16
  activations, C and F multiples of 16, F <= 128 and H*W <= 64.
- otherwise (the decoder): the input projection is a conv, the hidden conv
  an OIHW `nn.Conv2d`, and the recurrence an eager loop of cuDNN convs, as
  the JAX auto policy runs it (`lax.scan`).  A time-constant input
  (xs of length 1 with `length=T`) is projected once.  `remat=True`
  recomputes each step in the backward (`torch.utils.checkpoint`).

Gate order i/f/g/o, forget bias +1; the pointwise chain and the cell state
run in `gate_dtype` (`_gate_math`).  The interface is NHWC like the JAX
module: state (c, h) each (B, H, W, F), xs (B, T, H, W, C), hs (B, T, H, W, F).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mmvae_torch.models.base import HWIOKernel, ProjMatrix
from mmvae_torch.ops.convlstm_kernels import convlstm_scan_proj

State = Tuple[torch.Tensor, torch.Tensor]


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
                 gate_dtype=torch.float32, remat: bool = False, device=None):
        super().__init__()
        self.features = features
        self.kernel = kernel
        self.x_kernel = x_kernel or kernel
        self.dtype = dtype
        self.gate_dtype = gate_dtype
        self.remat = remat
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
        hg = F.conv2d(h.to(self.dtype), w_h, padding=self.kernel // 2)
        return _gate_math(
            xg_t.to(self.gate_dtype) + hg.to(self.gate_dtype), c, h.dtype,
            compute_dtype=self.gate_dtype,
        )

    def forward(self, state0: State, xs: torch.Tensor, *, length: Optional[int] = None,
                need_hs: bool = True) -> Tuple[State, Optional[torch.Tensor]]:
        b, t_in = xs.shape[:2]
        t = length or t_in
        dt = self.dtype
        c0, h0 = state0
        if self.proj and not need_hs and t_in == t:
            c_t, h_t = convlstm_scan_proj(
                xs.to(dt), self.input.weight.to(dt), self.input.bias.to(dt),
                self.step.hidden.weight.to(dt), c0.to(dt), h0.to(dt),
                gate_dtype=self.gate_dtype,
            )
            return (c_t, h_t), None

        # Hoisted input projection over all B*T_in frames (NCHW inside).
        flat = xs.reshape(b * t_in, *xs.shape[2:]).to(dt)
        if self.proj:
            xg = flat @ self.input.weight.to(dt) + self.input.bias.to(dt)
            xg = xg.permute(0, 3, 1, 2)
        else:
            xg = F.conv2d(flat.permute(0, 3, 1, 2), self.input.weight.to(dt),
                          self.input.bias.to(dt), padding=self.x_kernel // 2)
        xg = xg.reshape(b, t_in, *xg.shape[1:])
        w_h = self._hidden_oihw().to(dt)
        c = c0.permute(0, 3, 1, 2)
        h = h0.permute(0, 3, 1, 2)
        hs = []
        for s in range(t):
            xg_t = xg[:, 0] if t_in == 1 else xg[:, s]
            if self.remat and torch.is_grad_enabled():
                c, h = checkpoint(self._step, xg_t, c, h, w_h, use_reentrant=False)
            else:
                c, h = self._step(xg_t, c, h, w_h)
            hs.append(h)
        hs = torch.stack(hs, dim=1).permute(0, 1, 3, 4, 2)
        return (c.permute(0, 2, 3, 1), h.permute(0, 2, 3, 1)), hs
