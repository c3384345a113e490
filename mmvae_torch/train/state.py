"""Train state: model, optimizer, EMA and a step counter (port of
mmvae_tpu/train/state.py).

The update follows optax's chain: clip by global norm (`grad_clip`), then
Adam, or AdamW with decoupled decay on every parameter (`weight_decay`),
at the rate of the schedule (`make_lr`) for the update's count, then the
parameter EMA (`ema_decay`).  torch.optim.Adam / AdamW compute optax's
adam / adamw update (eps 1e-8, no eps_root).

The step counter is kept twice: `step`, a host int (the loop, the logger,
checkpoints), and `step_t`, a 0-d int64 tensor on the parameters' device
that the update advances.  Every per-step seed, the KL weight and the rate
derive from `step_t` on the device, so a step makes no host sync and a CUDA
graph of several steps (`train.loop.chunk_steps`) replays each step's own
values.  The optimizer is torch's fused Adam / AdamW; on a card it is
built `capturable` and reads its rate from a 0-d device tensor; on the
CPU, where torch's Adam is not capturable, the update reads the same f32
rate back as a float.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Union

import torch

Count = Union[int, torch.Tensor]


def _f32(count: Count) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def _linear(init: float, end: float, steps: int) -> Callable[[Count], torch.Tensor]:
    """optax.linear_schedule(init, end, steps) in float32: held at `init` for
    steps <= 0."""
    if steps <= 0:
        return lambda count: torch.full_like(_f32(count), init)

    def sched(count):
        frac = 1.0 - _f32(count).clamp(0, steps) / steps
        return (init - end) * frac + end

    return sched


def _cosine(init: float, steps: int, alpha: float) -> Callable[[Count], torch.Tensor]:
    """optax.cosine_decay_schedule(init, steps, alpha) in float32."""
    if steps <= 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={steps}.")

    def sched(count):
        c = 0.5 * (1.0 + torch.cos(math.pi * _f32(count).clamp(max=steps) / steps))
        return init * ((1.0 - alpha) * c + alpha)

    return sched


def _join(first, second, boundary: int) -> Callable[[Count], torch.Tensor]:
    """optax.join_schedules([first, second], [boundary])."""
    return lambda count: torch.where(torch.as_tensor(count) < boundary, first(count),
                                     second(count - boundary))


def _constant(lr: float) -> Callable[[Count], torch.Tensor]:
    """A constant rate; `.constant` names it, so an update skips the op."""
    sched = lambda count: torch.full_like(_f32(count), lr)  # noqa: E731
    sched.constant = lr
    return sched


def make_lr(optim_cfg) -> Callable[[Count], torch.Tensor]:
    """The learning rate as a function of the update's count (0 for the
    first update; an int or an int64 tensor on any device) to a float32
    tensor on the count's device, computed in float32 as
    `mmvae_tpu.train.state.make_lr`'s optax schedule: constant,
    constant after a linear warmup, `cosine` (warmup_cosine_decay_schedule
    from 0 to lr, down to lr * lr_end_ratio at lr_decay_steps) or `linear`
    (a ramp to lr over the warmup, then a fall to the end rate over
    lr_decay_steps - warmup)."""
    lr, sched = optim_cfg.lr, optim_cfg.lr_schedule
    warmup = optim_cfg.lr_warmup_steps
    if sched == "constant":
        return _linear(0.0, lr, warmup) if warmup > 0 else _constant(lr)
    decay = optim_cfg.lr_decay_steps
    if decay <= 0:
        raise ValueError(f"optim.lr_schedule={sched!r} needs optim.lr_decay_steps > 0 "
                         "(get_config defaults it to train.steps)")
    end = lr * optim_cfg.lr_end_ratio
    if sched == "cosine":
        alpha = 0.0 if lr == 0.0 else end / lr
        return _join(_linear(0.0, lr, warmup), _cosine(lr, decay - warmup, alpha), warmup)
    if sched == "linear":
        fall = _linear(lr, end, decay - warmup)
        return _join(_linear(0.0, lr, max(warmup, 1)), fall, warmup) if warmup > 0 else fall
    raise ValueError(f"unknown optim.lr_schedule {sched!r}; use constant | cosine | linear")


def make_optimizer(params, optim_cfg) -> torch.optim.Optimizer:
    """Adam, or AdamW under `weight_decay` (decay on every parameter, as
    optax.adamw without a mask), at the schedule's first rate, in torch's
    fused implementation (one kernel for the whole update, where foreach
    takes a dozen a step).  Parameters on a card get a `capturable`
    optimizer whose rate is a 0-d float32 tensor on that card
    (`TrainState.apply_gradients` writes it each update), so its update
    can be captured in a CUDA graph."""
    params = list(params)
    lr = float(make_lr(optim_cfg)(0))
    kw = dict(betas=(optim_cfg.b1, optim_cfg.b2), eps=1e-8, fused=True)
    if params and params[0].is_cuda:
        kw["capturable"] = True
        lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    if optim_cfg.weight_decay:
        return torch.optim.AdamW(params, lr=lr, weight_decay=optim_cfg.weight_decay, **kw)
    return torch.optim.Adam(params, lr=lr, **kw)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: every gradient scaled by
    max_norm / ||g|| where ||g|| >= max_norm, else kept.  The decision stays
    on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, torch.ones_like(norm),
                                           max_norm / norm))


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_fn: Callable[[Count], torch.Tensor]  # the rate of an update's count (make_lr)
    step: int = 0
    grad_clip: Optional[float] = None
    # f32 EMA of the parameters by name (optim.ema_decay > 0), else None
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_decay: float = 0.0
    # `step` on the parameters' device (0-d int64), advanced by the update
    step_t: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.step_t is None:
            dev = next(self.model.parameters()).device
            self.step_t = torch.tensor(self.step, dtype=torch.int64, device=dev)

    def set_step(self, step: int) -> None:
        """Set both counters (a restore)."""
        self.step = step
        self.step_t.fill_(step)

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """One update from the parameters' `.grad`: clip, the optimizer at
        this step's rate (from `step_t`), the EMA, step += 1 on the host and
        on the device (optax's chain and
        `mmvae_tpu.train.state.TrainState.apply_gradients`)."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        if self.grad_clip:
            clip_by_global_norm_([p.grad for p in params if p.grad is not None],
                                 self.grad_clip)
        if not hasattr(self.lr_fn, "constant"):  # a constant is the optimizer's already
            lr = self.lr_fn(self.step_t)
            for group in self.optimizer.param_groups:
                if isinstance(group["lr"], torch.Tensor):
                    group["lr"].copy_(lr)  # a capturable optimizer's rate
                else:
                    group["lr"] = float(lr)  # the CPU's: the same f32 rate
        self.optimizer.step()
        if self.ema_params is not None:
            d = self.ema_decay
            ema = list(self.ema_params.values())
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, [p for _, p in self.model.named_parameters()],
                                alpha=1.0 - d)
        self.step_t += 1
        self.step += 1


def create_train_state(model: torch.nn.Module, optim_cfg) -> TrainState:
    ema_decay = float(optim_cfg.ema_decay)
    return TrainState(
        model=model,
        optimizer=make_optimizer(model.parameters(), optim_cfg),
        lr_fn=make_lr(optim_cfg),
        grad_clip=optim_cfg.grad_clip,
        ema_params={n: p.detach().float().clone() for n, p in model.named_parameters()}
        if ema_decay > 0 else None,
        ema_decay=ema_decay,
    )
