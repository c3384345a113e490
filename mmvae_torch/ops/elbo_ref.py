"""Plain PyTorch ELBO and reparameterization (port of mmvae_tpu/ops/elbo_ref.py).

These are the plain versions of the ELBO reduce and sampling kernels
(`ops.elbo_kernels`): the CPU path and the oracle the kernels are held to.

    BCE(sigmoid(logits), x, reduction='sum') + KL(N(mu, e^logvar) || N(0, I))

BCE is computed from logits in the stable form, all sums in float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def bce_with_logits_sum(logits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum of max(l, 0) - l*x + log1p(exp(-|l|)), in float32."""
    l = logits.float()
    t = x.float()
    return torch.sum(torch.clamp_min(l, 0.0) - l * t + torch.log1p(torch.exp(-l.abs())))


def kl_sum(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, diag exp(logvar)) || N(0, I)), summed over all elements."""
    m = mu.float()
    lv = logvar.float()
    return -0.5 * torch.sum(1.0 + lv - m * m - torch.exp(lv))


def elbo_parts_ref(
    logits: torch.Tensor, x: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bce_sum, kl_sum): the negative ELBO is their sum."""
    return bce_with_logits_sum(logits, x), kl_sum(mu, logvar)


def standard_normal(shape, seed: int, device, dtype=torch.float32) -> torch.Tensor:
    """eps ~ N(0, I) from a torch.Generator seeded with `seed` on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & 0xFFFFFFFF)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def reparameterize_ref(
    mu: torch.Tensor,
    logvar: torch.Tensor,
    seed: int,
    eps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """z = mu + exp(0.5 * logvar) * eps; eps drawn from `seed` unless given."""
    if eps is None:
        eps = standard_normal(mu.shape, seed, mu.device, mu.dtype)
    return mu + torch.exp(0.5 * logvar) * eps
