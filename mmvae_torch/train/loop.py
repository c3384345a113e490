"""Loss and train step (port of mmvae_tpu/train/loop.py:32-251, 312-324).

One train step: derive the step seed from the host step counter, get the
batch's u8 clips (rows of the resident set by index, uniform with
replacement or by shuffled epochs, or clips generated on the card by
`data.ongen`), binarize them on the card (preprocess kernel), run the model
with kernel-sampled latents, reduce the ELBO (kernel) with the KL weight of
the step, backward, and `TrainState.apply_gradients` (clip, Adam or AdamW
at the step's rate, EMA).  No host sync: metrics come back as device
tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mmvae_torch.models import MODEL_REGISTRY, flax_init_
from mmvae_torch.ops import dispatch
from mmvae_torch.ops.seeds import STREAM_ONGEN, step_seed, stream_seed
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


def kl_beta(step: int, beta: float, kl_warmup_steps: int) -> float:
    """The step's KL weight, beta * min(1, step / kl_warmup_steps), in float32
    arithmetic as the JAX step computes it (exact as a Python float)."""
    b = np.float32(beta)
    if kl_warmup_steps > 0:
        b = b * np.minimum(np.float32(1.0), np.float32(step) / np.float32(kl_warmup_steps))
    return float(b)


def resident_row_indices(step: int, n_rows: int, batch: int, seed_base: int,
                         device, generator: Optional[torch.Generator] = None,
                         ) -> torch.Tensor:
    """Shuffled-epoch batch indices for the resident path: each row exactly
    once per epoch, a fresh permutation every epoch, a pure function of the
    step (so a restart draws the same).  epoch = step // (n_rows // batch)
    seeds a device torch.Generator from `seed_base`; the step takes its
    slice of that epoch's permutation.  The permutation is not
    threefry's: the rows differ from the JAX step's, the semantics do not."""
    steps_per_epoch = n_rows // batch
    if steps_per_epoch < 1:
        raise ValueError(f"resident epoch sampling needs n_rows ({n_rows}) >= batch ({batch})")
    epoch, pos = divmod(step, steps_per_epoch)
    gen = generator if generator is not None else torch.Generator(device=device)
    # 32 bits: the CPU generator drops a seed's high bits
    gen.manual_seed((seed_base * 2654435761 + epoch) & 0xFFFFFFFF)
    perm = torch.randperm(n_rows, generator=gen, device=device)
    return perm[pos * batch:(pos + 1) * batch]


def make_train_step(
    model,
    *,
    binarize: bool = True,
    resident_batch: Optional[int] = None,
    per_frame: bool = False,
    beta: float = 1.0,
    kl_warmup_steps: int = 0,
    resident_epochs: bool = False,
    resident_seed: int = 0,
    ongen_batch: Optional[int] = None,
    ongen_shape: Optional[Tuple[int, ...]] = None,
    ongen_num_digits: int = 2,
    ongen_sprites=None,
) -> Callable[[TrainState, Optional[torch.Tensor]], Metrics]:
    """Build step(state, data) -> metrics; updates `state` in place.

    With `resident_batch` set, `data` is the whole u8 dataset on the device
    and each step gathers `resident_batch` rows: uniformly with replacement,
    the indices drawn by a device torch.Generator seeded from the step seed,
    or under `resident_epochs` by `resident_row_indices` (seeded from
    `resident_seed`).  With `ongen_batch` set, each step generates its
    `ongen_batch` clips of `ongen_shape` (one sample's u8 shape) on the
    model's device (`data.ongen`, from the step seed's ONGEN stream) and
    `data` is ignored.  Otherwise `data` is the batch itself.  The KL term is
    weighted by `kl_beta(step, beta, kl_warmup_steps)`."""
    loss_fn = make_loss_fn(model, binarize=binarize)
    generators = {}
    gen_fn = None
    if ongen_batch is not None:
        from mmvae_torch.data import ongen

        device = next(model.parameters()).device
        gen_fn = ongen.clip_batch_fn(
            ongen_batch, ongen_shape or ((64, 64) if per_frame else (20, 64, 64)),
            num_digits=ongen_num_digits, per_frame=per_frame, sprites=ongen_sprites,
            device=device,
        )
        ongen_idx = torch.arange(ongen_batch, device=device)  # the whole generated batch

    def generator(device) -> torch.Generator:
        gen = generators.get(device)
        if gen is None:
            gen = generators[device] = torch.Generator(device=device)
        return gen

    def step(state: TrainState, data: Optional[torch.Tensor]) -> Metrics:
        seed = step_seed(state.step)
        if gen_fn is not None:
            data, idx = gen_fn(stream_seed(seed, STREAM_ONGEN)), ongen_idx
        elif resident_batch is not None and resident_epochs:
            idx = resident_row_indices(state.step, data.shape[0], resident_batch,
                                       resident_seed, data.device, generator(data.device))
        elif resident_batch is not None:
            gen = generator(data.device)
            gen.manual_seed(seed & 0xFFFFFFFF)
            idx = torch.randint(0, data.shape[0], (resident_batch,), generator=gen,
                                device=data.device)
        else:
            idx = torch.arange(data.shape[0], device=data.device)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(data, idx, seed, kl_beta(state.step, beta, kl_warmup_steps))
        loss.backward()
        state.apply_gradients()
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
