"""The Gaussian head and its sample as one op (CUDA kernels `csrc/head_sample.cu`).

`gaussian_head_sample(x, w_mu, b_mu, w_lv, b_lv, seed, eps=None)` returns
(mu, logvar, z) and computes what the JAX package computes, in its order:
the head of mmvae_tpu/models/base.py::GaussianHead (x cast to f32, then
Dense(mu) and Dense(logvar) in f32), then mmvae_tpu/ops/elbo_pallas.py::
reparameterize_pallas (z = mu + exp(logvar / 2) eps) with its VJP
(`_reparam_bwd`: dmu = g, dlogvar = g (z - mu) / 2).

- x is (M, K) in bf16 or f32 and is read in its own dtype; the weights are
  nn.Linear's (N, K) f32, the biases (N,) f32; mu, logvar and z come out
  (M, N) f32.
- eps comes from Philox-4x32-10 keyed by `seed` (the REPARAM stream seed,
  ops/seeds.py: a host int, or a `seeds.SeedRef` whose step seed the kernel
  reads from device memory), counter = the element's offset in (M, N); an
  `eps` tensor replaces the draw (tests and the card-against-CPU model
  checks).
- Autograd: the op saves z - mu and takes (g_mu, g_logvar, g_z), each may be
  absent; dmu = g_mu + g_z, dlv = g_logvar + g_z (z - mu) / 2, then dx =
  dmu W_mu + dlv W_lv in x's dtype (f32 sums rounded once), dW = d^T x and
  db in f32.

For CUDA tensors the wrappers launch the kernels (one forward launch: the
products, bias, draw and sample; one backward launch: dx, dW, db; the
products on the tensor cores as split TF32, f32-accurate; any batch and
any latent width) or raise; for CPU tensors they run the plain versions,
which are the models' route before the fusion: two `linear_f32` and
`reparameterize_plain`, and the same numbers.  The design notes are in
the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from mmvae_torch.ops import _build
from mmvae_torch.ops.elbo_kernels import reparameterize_plain
from mmvae_torch.ops.seeds import host_seed, kernel_seed

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory a block can use on the H100

# Geometry, as csrc/head_sample.cu computes it.
_FW_MT, _FW_NT, _FW_KC, _FW_MAX_STAGES, _FW_MAX_SPLIT = 64, 8, 128, 8, 8
_BW_KT, _BW_MR, _BW_MAX_LB = 64, 64, 128


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def head_geometry(m: int, k: int, n: int, x_itemsize: int) -> dict:
    """The kernels' launch geometry at x (m, k), latent n: the forward's
    K splits (CTAs a tile), its K slice a CTA, its grid, ring slots and
    shared bytes; the backward's grid (K tiles of 64 columns, blocks of
    latent columns), the latent columns a block (the latent width rounded
    up to a power of two, at least 8 and at most 128), the rows of the
    batch a block of D and x holds, and shared bytes, which depend on
    neither the batch nor, past 128, the latent width."""
    splits = min(max(-(-k // _FW_KC), 1), _FW_MAX_SPLIT)
    stage = _FW_MT * (_FW_KC + 16 // x_itemsize) * x_itemsize + 2 * _FW_NT * (_FW_KC + 4) * 4
    stages = min(_FW_MAX_STAGES, SMEM_LIMIT // stage)
    tiles, lb = -(-k // _BW_KT), 8
    while lb < n and lb < _BW_MAX_LB:
        lb *= 2
    return {
        "fwd_splits": splits,
        "fwd_kslice": _up(-(-k // splits), _FW_KC),
        "fwd_grid": (splits, -(-n // _FW_NT), -(-m // _FW_MT)),
        "fwd_stages": stages,
        "fwd_smem": stages * stage,
        "bwd_grid": (tiles, -(-n // lb)),
        "bwd_latent": lb,
        "bwd_rows": _BW_MR,
        # the W tile in f32, D's TF32 hi and lo cores, x^T's hi and lo cores
        "bwd_smem": 3 * (2 * lb) * _BW_KT * 4 + 2 * _BW_MR * _BW_KT * 4,
    }


def library_layout(m: int, k: int, n: int, x_dtype) -> tuple:
    """(K splits, K slice, forward smem, backward smem, backward K tiles,
    backward latent columns a block) as the CUDA library computes them
    (needs the built library)."""
    out = (ctypes.c_int * 6)()
    _build.library().mmvae_head_sample_layout(m, k, n, _DTYPE_CODE[x_dtype], out)
    return tuple(out)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def head_sample_forward_plain(x, w_mu, b_mu, w_lv, b_lv, seed: int,
                              eps: Optional[torch.Tensor] = None):
    """(mu, logvar, z, z - mu): two f32 Linears, then the sample (eps from a
    torch.Generator seeded with `seed` unless given: the kernel's Philox bits
    differ; the two agree in distribution, and exactly for injected eps)."""
    xf = x.float()
    mu, logvar = F.linear(xf, w_mu, b_mu), F.linear(xf, w_lv, b_lv)
    z, diff = reparameterize_plain(mu, logvar, host_seed(seed) if eps is None else 0, eps)
    return mu, logvar, z, diff


def head_sample_backward_plain(x, w_mu, w_lv, diff, g_mu, g_lv, g_z):
    """(dx, dW_mu, db_mu, dW_lv, db_lv) from the cotangents of (mu, logvar,
    z), each may be None; the products of autograd through two Linears."""
    zeros = torch.zeros_like(diff)
    g_mu = zeros if g_mu is None else g_mu
    g_lv = zeros if g_lv is None else g_lv
    if g_z is not None:
        g_mu = g_mu + g_z
        g_lv = g_lv + 0.5 * g_z * diff
    xf = x.float()
    dx = (g_mu.mm(w_mu) + g_lv.mm(w_lv)).to(x.dtype)
    return dx, g_mu.t().mm(xf), g_mu.sum(0), g_lv.t().mm(xf), g_lv.sum(0)


# ---------------------------------------------------------------------------
# CUDA paths
# ---------------------------------------------------------------------------


def _check(what, x, w_mu, w_lv, **others):
    """Device, dtype, shape and layout checks shared by both kernels; each
    of `others` is (tensor or None, "n" or "mn"), of shape (N,) or (M, N).
    Returns (M, K, N)."""
    if not x.is_cuda:
        raise ValueError(f"{what}: x is on {x.device}, the kernel needs cuda")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: x has dtype {x.dtype}, needs float32 or bfloat16")
    if x.dim() != 2 or w_mu.dim() != 2 or w_mu.shape[1] != x.shape[1]:
        raise ValueError(f"{what}: x {tuple(x.shape)} and W {tuple(w_mu.shape)} are not "
                         f"(M, K) and (N, K)")
    m, k = x.shape
    n = w_mu.shape[0]
    dims = {"n": (n,), "mn": (m, n)}
    for name, t, shape in (("x", x, (m, k)), ("w_mu", w_mu, (n, k)), ("w_lv", w_lv, (n, k)),
                           *((nm, t, dims[kind]) for nm, (t, kind) in others.items())):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device} (cuda)")
        if name != "x" and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}, needs float32")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {shape}, got "
                             f"{tuple(t.shape)} (contiguous={t.is_contiguous()})")
    if m == 0 or k == 0 or n == 0:
        raise ValueError(f"{what}: empty shape (M, K, N) = ({m}, {k}, {n})")
    return m, k, n


_TICKETS = {}


def tickets(device, stream: int, count: int) -> torch.Tensor:
    """The tickets of both kernels (the forward's one a tile, the
    backward's one a K tile) for launches on `stream` (a CUDA stream
    handle) of `device`: int32 zeros, which every launch leaves zero (its
    last CTA a tile resets its ticket).  Launches on one stream run one
    after another, so they can share a buffer; two streams never do, so
    forwards in flight on two streams at once keep their sums apart.  A
    CUDA graph keeps the buffer of the stream it was captured on: graphs
    captured on one stream are replayed one at a time."""
    buf = _TICKETS.get((device, stream))
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 4096), device=device, dtype=torch.int32)
        _TICKETS[(device, stream)] = buf
    return buf


@_build.on_device
def head_sample_forward_cuda(x, w_mu, b_mu, w_lv, b_lv, seed: int,
                             eps: Optional[torch.Tensor] = None):
    """The forward kernel; same contract as `head_sample_forward_plain`."""
    m, k, n = _check("head_sample_forward", x, w_mu, w_lv, b_mu=(b_mu, "n"), b_lv=(b_lv, "n"),
                     eps=(eps, "mn"))
    splits, tiles_n, tiles_m = head_geometry(m, k, n, x.element_size())["fwd_grid"]
    f32 = dict(device=x.device, dtype=torch.float32)
    outs = tuple(torch.empty(m, n, **f32) for _ in range(4))
    partials = torch.empty(tiles_n * tiles_m * splits * _FW_MT * 2 * _FW_NT, **f32)
    stream = _build.stream_ptr(x.device)
    err = _build.library().mmvae_head_sample_fwd(
        x.data_ptr(), w_mu.data_ptr(), b_mu.data_ptr(), w_lv.data_ptr(), b_lv.data_ptr(),
        None if eps is None else eps.data_ptr(), *(o.data_ptr() for o in outs),
        partials.data_ptr(), tickets(x.device, stream, tiles_n * tiles_m).data_ptr(), m, k, n,
        _DTYPE_CODE[x.dtype], *kernel_seed(seed, x.device), stream,
    )
    _build.check(err, "head_sample_forward")
    head_sample_forward.launches += 1
    return outs


@_build.on_device
def head_sample_backward_cuda(x, w_mu, w_lv, diff, g_mu, g_lv, g_z):
    """The backward kernel; same contract as `head_sample_backward_plain`."""
    g_mu, g_lv, g_z = (None if g is None else g.float().contiguous() for g in (g_mu, g_lv, g_z))
    m, k, n = _check("head_sample_backward", x, w_mu, w_lv, diff=(diff, "mn"),
                     g_mu=(g_mu, "mn"), g_logvar=(g_lv, "mn"), g_z=(g_z, "mn"))
    dev = x.device
    tiles, blocks = head_geometry(m, k, n, x.element_size())["bwd_grid"]
    dx = torch.empty_like(x)
    f32 = dict(device=dev, dtype=torch.float32)
    dw = (torch.empty(n, k, **f32), torch.empty(n, k, **f32))
    db = (torch.empty(n, **f32), torch.empty(n, **f32))
    stream = _build.stream_ptr(dev)
    # partial dx of each latent block, summed by the last CTA of a K tile
    scratch = torch.empty(tiles * blocks * m * _BW_KT, **f32) if blocks > 1 else None
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = _build.library().mmvae_head_sample_bwd(
        x.data_ptr(), w_mu.data_ptr(), w_lv.data_ptr(), diff.data_ptr(), ptr(g_mu), ptr(g_lv),
        ptr(g_z), dx.data_ptr(), dw[0].data_ptr(), dw[1].data_ptr(), db[0].data_ptr(),
        db[1].data_ptr(), ptr(scratch), tickets(dev, stream, tiles).data_ptr(), m, k, n,
        _DTYPE_CODE[x.dtype], stream,
    )
    _build.check(err, "head_sample_backward")
    head_sample_backward.launches += 1
    return dx, dw[0], db[0], dw[1], db[1]


# ---------------------------------------------------------------------------
# wrappers and the op
# ---------------------------------------------------------------------------


def head_sample_forward(x, w_mu, b_mu, w_lv, b_lv, seed: int,
                        eps: Optional[torch.Tensor] = None):
    """(mu, logvar, z, z - mu): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        return head_sample_forward_cuda(x, w_mu, b_mu, w_lv, b_lv, seed, eps)
    return head_sample_forward_plain(x, w_mu, b_mu, w_lv, b_lv, seed, eps)


head_sample_forward.launches = 0


def head_sample_backward(x, w_mu, w_lv, diff, g_mu, g_lv, g_z):
    """(dx, dW_mu, db_mu, dW_lv, db_lv): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if x.is_cuda:
        return head_sample_backward_cuda(x, w_mu, w_lv, diff, g_mu, g_lv, g_z)
    return head_sample_backward_plain(x, w_mu, w_lv, diff, g_mu, g_lv, g_z)


head_sample_backward.launches = 0


class _GaussianHeadSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_mu, b_mu, w_lv, b_lv, seed, eps):
        mu, logvar, z, diff = head_sample_forward(x, w_mu, b_mu, w_lv, b_lv, seed, eps)
        ctx.save_for_backward(x, w_mu, w_lv, diff)
        ctx.set_materialize_grads(False)  # an unused output's cotangent stays None
        return mu, logvar, z

    @staticmethod
    def backward(ctx, g_mu, g_lv, g_z):
        x, w_mu, w_lv, diff = ctx.saved_tensors
        if g_mu is None and g_lv is None and g_z is None:
            return (None,) * 7
        dx, dw_mu, db_mu, dw_lv, db_lv = head_sample_backward(x, w_mu, w_lv, diff, g_mu, g_lv,
                                                              g_z)
        return dx, dw_mu, db_mu, dw_lv, db_lv, None, None


def gaussian_head_sample(x, w_mu, b_mu, w_lv, b_lv, seed: int,
                         eps: Optional[torch.Tensor] = None):
    """(mu, logvar, z), differentiable in x, the weights and the biases."""
    return _GaussianHeadSample.apply(x, w_mu, b_mu, w_lv, b_lv, seed, eps)


def gaussian_head_sample_plain(x, w_mu, b_mu, w_lv, b_lv, seed: int,
                               eps: Optional[torch.Tensor] = None):
    """The oracle: (mu, logvar, z) through plain differentiable PyTorch ops."""
    return head_sample_forward_plain(x, w_mu, b_mu, w_lv, b_lv, seed, eps)[:3]
