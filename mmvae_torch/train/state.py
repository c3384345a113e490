"""Train state: model, Adam and a step counter (port of mmvae_tpu/train/state.py).

Adam at a constant learning rate with optax's b1, b2 and eps (1e-8, no
eps_root), which is torch.optim.Adam's update.  LR schedules, AdamW, grad
clipping and EMA are not ported yet and are refused rather than ignored.
The step counter is a host int: every per-step seed derives from it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params, optim_cfg) -> torch.optim.Optimizer:
    unsupported = {
        "lr_schedule": optim_cfg.lr_schedule != "constant",
        "lr_warmup_steps": optim_cfg.lr_warmup_steps > 0,
        "weight_decay": bool(optim_cfg.weight_decay),
        "grad_clip": bool(optim_cfg.grad_clip),
        "ema_decay": bool(optim_cfg.ema_decay),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"optim options not ported yet: {', '.join(bad)}")
    return torch.optim.Adam(
        params, lr=optim_cfg.lr, betas=(optim_cfg.b1, optim_cfg.b2), eps=1e-8
    )


def create_train_state(model: torch.nn.Module, optim_cfg) -> TrainState:
    return TrainState(model=model, optimizer=make_optimizer(model.parameters(), optim_cfg))
