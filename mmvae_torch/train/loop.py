"""Loss and train step (port of mmvae_tpu/train/loop.py:62-251, 312-324).

One train step: derive the step seed from the host step counter, draw the
batch's row indices from a device torch.Generator, gather + binarize the u8
rows on the card (preprocess kernel), run the model with kernel-sampled
latents, reduce the ELBO (kernel), backward, Adam.  No host sync: metrics
come back as device tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mmvae_torch.models import MODEL_REGISTRY, flax_init_
from mmvae_torch.ops import dispatch
from mmvae_torch.ops.seeds import step_seed
from mmvae_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_loss_fn(model, *, binarize: bool):
    """loss_fn(data_u8, idx, seed, beta=1.0) -> (loss per sample, metrics).

    `data_u8[idx]` are the batch's clips.  Loss = (BCE sum + beta * KL sum) / B;
    the metrics report the unscaled ELBO terms per sample."""
    # Binarized {0, 1} frames are exact in bf16: a bf16 model gets bf16 frames.
    frame_dtype = (
        torch.bfloat16 if binarize and model.dtype == torch.bfloat16 else torch.float32
    )

    def loss_fn(data_u8, idx, seed: int, beta: float = 1.0):
        x = dispatch.preprocess_gather(
            data_u8, idx, seed, binarize=binarize, out_dtype=frame_dtype
        )
        out = model(x, dispatch.make_sample_fn(seed))
        bce, kl = dispatch.elbo_parts(out.logits, out.target, out.mu, out.logvar)
        b = out.mu.shape[0]
        kl_total = kl + out.extra_kl
        loss = (bce + beta * kl_total) / b
        metrics = {
            "loss": ((bce + kl_total) / b).detach(),
            "bce": (bce / b).detach(),
            "kl": (kl_total / b).detach(),
        }
        return loss, metrics

    return loss_fn


def make_train_step(
    model,
    *,
    binarize: bool = True,
    resident_batch: Optional[int] = None,
    beta: float = 1.0,
) -> Callable[[TrainState, torch.Tensor], Metrics]:
    """Build step(state, data) -> metrics; updates `state` in place.

    With `resident_batch` set, `data` is the whole u8 dataset on the device
    and each step gathers `resident_batch` rows uniformly with replacement,
    the indices drawn by a device torch.Generator seeded from the step seed.
    Otherwise `data` is the batch itself."""
    loss_fn = make_loss_fn(model, binarize=binarize)
    generators = {}

    def step(state: TrainState, data: torch.Tensor) -> Metrics:
        seed = step_seed(state.step)
        if resident_batch is not None:
            gen = generators.get(data.device)
            if gen is None:
                gen = generators[data.device] = torch.Generator(device=data.device)
            gen.manual_seed(seed & 0xFFFFFFFF)
            idx = torch.randint(0, data.shape[0], (resident_batch,), generator=gen,
                                device=data.device)
        else:
            idx = torch.arange(data.shape[0], device=data.device)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(data, idx, seed, beta)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return metrics

    return step


def build_model(cfg, device="cuda", generator: Optional[torch.Generator] = None):
    """The config's model on `device` (the card unless the caller names the
    CPU) with flax-style init from `generator` (default: a CPU generator
    seeded with cfg.train.seed, so every device gets the same weights)."""
    cls = MODEL_REGISTRY[cfg.model.name]
    model = cls(**dict(cfg.model.kwargs), dtype=_DTYPES[cfg.model.dtype], device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    return flax_init_(model, generator)


def _sample_shape(cfg) -> tuple:
    s = 64
    if cfg.data.per_frame:
        return (cfg.data.batch_size, s, s)
    return (cfg.data.batch_size, cfg.data.seq_len, s, s)
