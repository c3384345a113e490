"""u8 frame preprocessing (port of mmvae_tpu/data/transforms.py).

`normalize`, `binarize` and `preprocess` only.  The TPU's int32 chunk-planar
resident packing (`pack_resident` / `unpack_sample`) is not ported: the
resident set stays u8 on the card and `ops.preprocess_kernels` gathers and
binarizes it in one kernel.
"""

from __future__ import annotations

from typing import Optional

import torch


def normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]."""
    return u8.to(torch.float32) * (1.0 / 255.0)


def binarize(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Stochastic Bernoulli binarization: pixel value is P(on)."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return (u < x).to(torch.float32)


def preprocess(u8: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """normalize, then binarize if a generator is given."""
    x = normalize(u8)
    if generator is not None:
        x = binarize(x, generator)
    return x
