"""The train step's kernel calls (port of mmvae_tpu/ops/dispatch.py).

The JAX module picks Pallas or XLA by `use_pallas`.  Here each kernel
wrapper decides by the device of its tensors alone: for CUDA tensors it
launches its kernel or raises, for CPU tensors it runs its plain PyTorch
version.  This module adds the step's stream seeds (ops.seeds) and the
sampling paths' prior draws (`prior_normal`).  A step seed is a host int
(eval, sampling) or a 0-d int64 tensor on the device (the train step's,
`train.loop`): its streams then reach the kernels as `seeds.SeedRef`s,
read from device memory, which a CUDA graph of train steps replays with
each step's own seed.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from mmvae_torch.ops import elbo_kernels, preprocess_kernels, seeds

StepSeed = Union[int, torch.Tensor]


def stream(seed: StepSeed, stream_id: int, salt: int = 0) -> seeds.Seed:
    """Stream `stream_id`'s seed of the step seed `seed`: a host int, or for
    a device seed a `seeds.SeedRef` the kernels resolve on the card."""
    if isinstance(seed, torch.Tensor):
        return seeds.SeedRef(seed, stream_id, salt)
    return seeds.stream_seed(seed, stream_id, salt)


def preprocess_gather(
    data: torch.Tensor,
    idx: torch.Tensor,
    seed: StepSeed,
    *,
    binarize: bool,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Frames `data[idx]` binarized from the PREPROCESS stream of `seed`."""
    s = stream(seed, seeds.STREAM_PREPROCESS)
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

    def __init__(self, seed: StepSeed, eps: Optional[Dict[int, torch.Tensor]] = None):
        self.seed = seed
        self.eps = dict(eps or {})

    def stream_seed(self, salt: int = 0) -> seeds.Seed:
        return stream(self.seed, seeds.STREAM_REPARAM, salt)

    def noise(self, salt: int = 0) -> Optional[torch.Tensor]:
        return self.eps.get(salt)

    def __call__(self, mu, logvar, salt=0):
        # the standalone kernel takes a host seed: a device seed is read back
        return elbo_kernels.reparameterize(mu, logvar, seeds.host_seed(self.stream_seed(salt)))


def make_sample_fn(seed: StepSeed, eps: Optional[Dict[int, torch.Tensor]] = None) -> StepSampler:
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
