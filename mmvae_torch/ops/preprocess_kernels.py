"""Resident-batch gather + normalize/binarize (CUDA kernel `csrc/preprocess.cu`).

Replaces mmvae_tpu/ops/preprocess_pallas.py::preprocess_pallas and
::preprocess_packed_pallas with one kernel: `preprocess_gather(data, idx,
seed)` reads rows `idx` of the u8 dataset `data` (N, *sample) and writes the
frame batch (B, *sample).  The TPU's int32 chunk-planar packing is not carried
over (the dataset stays u8 on the card); the computation is.  For a streamed
batch, `idx = arange(B)` over the batch tensor gives preprocess_pallas.

binarize=True:  1 iff float(u24) < float(u8) * (2^24 / 255), u24 a 24-bit
                uniform integer (P(on) = u8 / 255, exactly as the TPU kernel
                compares);
binarize=False: float(u8) * (1 / 255).
Row indices outside [0, N) are clamped to it (both versions), so no index
reads outside the dataset.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmvae_torch.ops import _build
from mmvae_torch.ops.seeds import Seed, host_seed, kernel_seed

_SCALE24 = 16777216.0 / 255.0


def preprocess_gather_plain(
    data: torch.Tensor,
    idx: torch.Tensor,
    seed: Seed,
    *,
    binarize: bool = True,
    out_dtype: torch.dtype = torch.float32,
    u24: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version.  `u24` (int, values in [0, 2^24), shape of the output)
    injects the uniforms; otherwise they come from a torch.Generator seeded
    with the stream seed (`seed`, or a device seed read back: the kernel's
    Philox bits differ; they agree in distribution, and exactly for
    binarize=False)."""
    pix = data[idx.clamp(0, data.shape[0] - 1)].to(torch.float32)
    if not binarize:
        return (pix * (1.0 / 255.0)).to(out_dtype)
    if u24 is None:
        gen = torch.Generator(device=data.device)
        gen.manual_seed(host_seed(seed) & 0xFFFFFFFF)
        u24 = torch.randint(0, 1 << 24, pix.shape, generator=gen, device=data.device)
    return (u24.to(torch.float32) < pix * _SCALE24).to(out_dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@_build.on_device
def _preprocess_gather_cuda(data, idx, seed, binarize, out_dtype):
    if not (data.is_cuda and idx.is_cuda):
        raise ValueError("preprocess_gather: data and idx must both be on cuda")
    if data.dtype != torch.uint8 or idx.dtype != torch.int64 or idx.dim() != 1:
        raise TypeError(
            f"preprocess_gather: needs uint8 data and 1-D int64 idx, got "
            f"{data.dtype} and {idx.dtype} {tuple(idx.shape)}"
        )
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"preprocess_gather: out_dtype {out_dtype} not supported")
    if not data.is_contiguous():
        raise ValueError("preprocess_gather: data must be contiguous")
    if data.shape[0] == 0 and idx.numel():
        raise ValueError("preprocess_gather: gathering from an empty dataset")
    lib = _build.library()
    idx = idx.contiguous()
    row = data[0].numel() if data.shape[0] else 0
    out = torch.empty((idx.shape[0],) + tuple(data.shape[1:]), device=data.device,
                      dtype=out_dtype)
    err = lib.mmvae_preprocess_gather(
        data.data_ptr(), idx.data_ptr(), out.data_ptr(), data.shape[0], row, idx.shape[0],
        *kernel_seed(seed, data.device), int(binarize), _DTYPE_CODE[out_dtype],
        _build.stream_ptr(data.device),
    )
    _build.check(err, "preprocess_gather")
    preprocess_gather.launches += 1
    return out


def preprocess_gather(
    data: torch.Tensor,
    idx: torch.Tensor,
    seed: Seed,
    *,
    binarize: bool = True,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """u8 rows `data[idx]` -> frames in `out_dtype`, binarized from the
    stream seed `seed`: a host int, or a `seeds.SeedRef` whose step seed the
    kernel reads from device memory (the train step's, so a CUDA graph's
    replays draw each step's own bits).  CUDA kernel for CUDA tensors;
    plain version for CPU tensors."""
    if data.is_cuda:
        return _preprocess_gather_cuda(data, idx, seed, binarize, out_dtype)
    return preprocess_gather_plain(data, idx, seed, binarize=binarize, out_dtype=out_dtype)


preprocess_gather.launches = 0
