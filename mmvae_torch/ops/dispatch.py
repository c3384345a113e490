"""The train step's kernel calls (port of mmvae_tpu/ops/dispatch.py).

The JAX module picks Pallas or XLA by `use_pallas`.  Here each kernel
wrapper decides by the device of its tensors alone: for CUDA tensors it
launches its kernel or raises, for CPU tensors it runs its plain PyTorch
version.  This module adds the step's stream seeds (ops.seeds).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mmvae_torch.ops import elbo_kernels, preprocess_kernels, seeds


def preprocess_gather(
    data: torch.Tensor,
    idx: torch.Tensor,
    seed: int,
    *,
    binarize: bool,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Frames `data[idx]` binarized from the PREPROCESS stream of `seed`."""
    s = seeds.stream_seed(seed, seeds.STREAM_PREPROCESS)
    return preprocess_kernels.preprocess_gather(data, idx, s, binarize=binarize,
                                                out_dtype=out_dtype)


def make_sample_fn(seed: int):
    """`sample_fn(mu, logvar, salt=0) -> z` for one step: eps is drawn from
    the REPARAM stream of the step seed (ops.seeds)."""

    def sample_fn(mu, logvar, salt=0):
        s = seeds.stream_seed(seed, seeds.STREAM_REPARAM, salt)
        return elbo_kernels.reparameterize(mu, logvar, s)

    return sample_fn


def elbo_parts(
    logits: torch.Tensor, x: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bce_sum, kl_sum) from the ELBO reduce kernel."""
    return elbo_kernels.elbo_reduce(logits, x, mu, logvar)
