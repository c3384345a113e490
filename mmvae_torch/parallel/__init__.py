"""Data parallelism, one process per card (port of mmvae_tpu/parallel)."""

from mmvae_torch.parallel.mesh import (
    GradSync,
    barrier,
    env_world,
    grad_sync,
    init_from_env,
    join,
    launched_by_torchrun,
    local_device,
    place,
    rank,
    shutdown,
    world,
)

__all__ = [
    "GradSync",
    "barrier",
    "env_world",
    "grad_sync",
    "init_from_env",
    "join",
    "launched_by_torchrun",
    "local_device",
    "place",
    "rank",
    "shutdown",
    "world",
]
