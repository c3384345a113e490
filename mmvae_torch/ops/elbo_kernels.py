"""Triton kernels for the ELBO reduce and reparameterized sampling.

Replaces mmvae_tpu/ops/elbo_pallas.py:

- `elbo_reduce(logits, x, mu, logvar) -> (bce_sum, kl_sum)` replaces
  `elbo_reduce_pallas` (`_elbo_reduce_kernel`).  Bound on the H100: bytes.
  At the main path's shape it reads 21 MB of f32 logits and 10.5 MB of bf16
  frames once (about 10 us at 3.35 TB/s) and does no matrix product.  Design:
  two passes.  Each program reduces a 4096-element block to one f32 partial,
  and program 0 also computes the KL over (mu, logvar); a one-program second
  pass sums the partials in a fixed order.  No atomics, so the result is
  deterministic.
- `reparameterize(mu, logvar, seed) -> z` replaces `reparameterize_pallas`
  (`_reparam_kernel`, `_box_muller`).  Bound: launch latency; it is one fused
  elementwise pass over B x latent (8,192 elements on the main path).  eps
  comes from Philox (`tl.randn`) keyed by the stream seed and the element
  offset; the kernel writes z and the residual z - mu together.

Both backward passes are plain PyTorch elementwise code in a
`torch.autograd.Function`, with the formulas of the JAX VJPs
(`_elbo_reduce_bwd`, `_reparam_bwd`): the TPU kernels had no backward kernel
either.  A wrapper runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the Triton kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mmvae_torch.ops import elbo_ref
from mmvae_torch.ops._build import on_device, triton_cache_env

_BCE_BLOCK = 4096
_SUM_BLOCK = 1024
_REPARAM_BLOCK = 1024

_TRITON = None


def _triton_kernels():
    """Compile-on-first-use Triton kernels (triton imports only here)."""
    global _TRITON
    if _TRITON is not None:
        return _TRITON
    triton_cache_env()
    import triton
    import triton.language as tl

    @triton.jit
    def bce_partial_kernel(logits_ptr, x_ptr, part_ptr, mu_ptr, lv_ptr, out_ptr,
                           n, n_lat, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        l = tl.load(logits_ptr + offs, mask=m, other=0.0).to(tl.float32)
        t = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        e = tl.exp(-tl.abs(l))
        u = 1.0 + e
        log1p_e = tl.log(u) - ((u - 1.0) - e) / u  # log1p(e), accurate for tiny e
        per = tl.maximum(l, 0.0) - l * t + log1p_e
        per = tl.where(m, per, 0.0)
        tl.store(part_ptr + pid, tl.sum(per, axis=0))
        if pid == 0:
            acc = tl.zeros([BLOCK], tl.float32)
            for s in range(0, n_lat, BLOCK):
                o = s + tl.arange(0, BLOCK)
                mm = o < n_lat
                mu = tl.load(mu_ptr + o, mask=mm, other=0.0).to(tl.float32)
                lv = tl.load(lv_ptr + o, mask=mm, other=0.0).to(tl.float32)
                acc += tl.where(mm, 1.0 + lv - mu * mu - tl.exp(lv), 0.0)
            tl.store(out_ptr + 1, -0.5 * tl.sum(acc, axis=0))

    @triton.jit
    def sum_partials_kernel(part_ptr, out_ptr, n, BLOCK: tl.constexpr):
        acc = tl.zeros([BLOCK], tl.float32)
        for s in range(0, n, BLOCK):
            o = s + tl.arange(0, BLOCK)
            acc += tl.load(part_ptr + o, mask=o < n, other=0.0)
        tl.store(out_ptr, tl.sum(acc, axis=0))

    @triton.jit
    def reparam_kernel(mu_ptr, lv_ptr, z_ptr, res_ptr, n, seed, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        mu = tl.load(mu_ptr + offs, mask=m, other=0.0).to(tl.float32)
        lv = tl.load(lv_ptr + offs, mask=m, other=0.0).to(tl.float32)
        eps = tl.randn(seed, offs)
        z = mu + tl.exp(0.5 * lv) * eps
        tl.store(z_ptr + offs, z, mask=m)
        tl.store(res_ptr + offs, z - mu, mask=m)

    _TRITON = (triton, bce_partial_kernel, sum_partials_kernel, reparam_kernel)
    return _TRITON


# ---------------------------------------------------------------------------
# K1: ELBO reduce
# ---------------------------------------------------------------------------


def elbo_reduce_plain(logits, x, mu, logvar) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ELBO reduce kernel."""
    return elbo_ref.elbo_parts_ref(logits, x, mu, logvar)


@on_device
def _elbo_reduce_cuda(logits, x, mu, logvar) -> Tuple[torch.Tensor, torch.Tensor]:
    for name, t in (("logits", logits), ("x", x), ("mu", mu), ("logvar", logvar)):
        if not t.is_cuda:
            raise ValueError(f"elbo_reduce: {name} is on {t.device}, logits on cuda")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"elbo_reduce: {name} has dtype {t.dtype}")
    if logits.shape != x.shape or mu.shape != logvar.shape:
        raise ValueError(
            f"elbo_reduce: shapes {tuple(logits.shape)}/{tuple(x.shape)} and "
            f"{tuple(mu.shape)}/{tuple(logvar.shape)} must match pairwise"
        )
    triton, bce_partial, sum_partials, _ = _triton_kernels()
    lf, xf = logits.contiguous().view(-1), x.contiguous().view(-1)
    muf, lvf = mu.contiguous().view(-1), logvar.contiguous().view(-1)
    n = lf.numel()
    grid = max(triton.cdiv(n, _BCE_BLOCK), 1)
    part = torch.empty(grid, device=logits.device, dtype=torch.float32)
    out = torch.empty(2, device=logits.device, dtype=torch.float32)
    bce_partial[(grid,)](lf, xf, part, muf, lvf, out, n, muf.numel(),
                         BLOCK=_BCE_BLOCK, num_warps=8)
    sum_partials[(1,)](part, out, grid, BLOCK=_SUM_BLOCK, num_warps=4)
    elbo_reduce.launches += 1
    return out[0], out[1]


class _ElboReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, x, mu, logvar):
        ctx.save_for_backward(logits, x, mu, logvar)
        if logits.is_cuda:
            return _elbo_reduce_cuda(logits, x, mu, logvar)
        return elbo_reduce_plain(logits, x, mu, logvar)

    @staticmethod
    def backward(ctx, g_bce, g_kl):
        logits, x, mu, logvar = ctx.saved_tensors
        l = logits.float()
        d_logits = (g_bce * (torch.sigmoid(l) - x.float())).to(logits.dtype)
        d_x = (g_bce * (-l)).to(x.dtype) if ctx.needs_input_grad[1] else None
        d_mu = (g_kl * mu.float()).to(mu.dtype)
        d_logvar = (g_kl * 0.5 * (torch.exp(logvar.float()) - 1.0)).to(logvar.dtype)
        return d_logits, d_x, d_mu, d_logvar


def elbo_reduce(logits, x, mu, logvar) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bce_sum, kl_sum) as f32 scalars; differentiable wrt all four tensors.

    Triton kernel for CUDA tensors, plain version for CPU tensors."""
    return _ElboReduce.apply(logits, x, mu, logvar)


elbo_reduce.launches = 0


# ---------------------------------------------------------------------------
# K2: reparameterized sampling
# ---------------------------------------------------------------------------


def reparameterize_plain(mu, logvar, seed: int, eps: Optional[torch.Tensor] = None):
    """Plain version of the sampling kernel: (z, z - mu).  eps is drawn from a
    torch.Generator seeded with `seed` unless given (the kernel's Philox bits
    differ; the two agree in distribution, and exactly for injected eps)."""
    z = elbo_ref.reparameterize_ref(mu.float(), logvar.float(), seed, eps)
    return z, z - mu.float()


@on_device
def _reparameterize_cuda(mu, logvar, seed: int):
    if not (mu.is_cuda and logvar.is_cuda):
        raise ValueError("reparameterize: mu and logvar must both be on cuda")
    if mu.shape != logvar.shape:
        raise ValueError(f"reparameterize: {tuple(mu.shape)} != {tuple(logvar.shape)}")
    triton, _, _, reparam = _triton_kernels()
    muf, lvf = mu.contiguous().view(-1), logvar.contiguous().view(-1)
    n = muf.numel()
    z = torch.empty(n, device=mu.device, dtype=torch.float32)
    res = torch.empty_like(z)
    reparam[(max(triton.cdiv(n, _REPARAM_BLOCK), 1),)](
        muf, lvf, z, res, n, int(seed), BLOCK=_REPARAM_BLOCK, num_warps=4
    )
    reparameterize.launches += 1
    return z.view(mu.shape), res.view(mu.shape)


class _Reparameterize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, logvar, seed):
        if mu.is_cuda:
            z, sig_eps = _reparameterize_cuda(mu, logvar, seed)
        else:
            z, sig_eps = reparameterize_plain(mu, logvar, seed)
        ctx.save_for_backward(sig_eps)
        return z

    @staticmethod
    def backward(ctx, g):
        (sig_eps,) = ctx.saved_tensors
        return g, 0.5 * g * sig_eps, None


def reparameterize(mu, logvar, seed: int) -> torch.Tensor:
    """z = mu + exp(0.5 logvar) * eps, eps ~ N(0, I) from `seed` (an int32
    stream seed).  VJP: d mu = g, d logvar = 0.5 g (z - mu)."""
    return _Reparameterize.apply(mu, logvar, seed)


reparameterize.launches = 0
