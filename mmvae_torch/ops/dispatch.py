"""The train step's kernel calls (port of mmvae_tpu/ops/dispatch.py).

The JAX module picks Pallas or XLA by `use_pallas`.  Here each kernel
wrapper decides by the device of its tensors alone: for CUDA tensors it
launches its kernel or raises, for CPU tensors it runs its plain PyTorch
version.  This module adds the step's stream seeds (ops.seeds) and the
sampling paths' prior draws (`prior_normal`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


class StepSampler:
    """`sample_fn(mu, logvar, salt=0) -> z` for one step: eps is drawn from
    the REPARAM stream of the step seed (ops.seeds), by the standalone
    sampling kernel for a bare (mu, logvar).  `stream_seed(salt)` names the
    stream, so a model that holds the head's input takes the fused head and
    sample instead (models.base.head_and_sample).  `eps`, {salt: tensor},
    is what `noise(salt)` hands that fused op in place of the draw (the
    model checks inject their noise so); a bare call always draws."""

    def __init__(self, seed: int, eps: Optional[Dict[int, torch.Tensor]] = None):
        self.seed = seed
        self.eps = dict(eps or {})

    def stream_seed(self, salt: int = 0) -> int:
        return seeds.stream_seed(self.seed, seeds.STREAM_REPARAM, salt)

    def noise(self, salt: int = 0) -> Optional[torch.Tensor]:
        return self.eps.get(salt)

    def __call__(self, mu, logvar, salt=0):
        return elbo_kernels.reparameterize(mu, logvar, self.stream_seed(salt))


def make_sample_fn(seed: int, eps: Optional[Dict[int, torch.Tensor]] = None) -> StepSampler:
    """The step's sample function (`StepSampler`)."""
    return StepSampler(seed, eps)


def elbo_parts(
    logits: torch.Tensor, x: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bce_sum, kl_sum) from the ELBO reduce kernel."""
    return elbo_kernels.elbo_reduce(logits, x, mu, logvar)


def prior_normal(seed: int, shape, device) -> torch.Tensor:
    """z ~ N(0, I), f32, of `shape` on `device`, from the PRIOR stream of
    `seed` (ops.seeds) by a generator on `device` itself: a draw for the
    card never passes through the host."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.stream_seed(seed, seeds.STREAM_PRIOR))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
