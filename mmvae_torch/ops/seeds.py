"""Disjoint int32 seed streams (port of mmvae_tpu/ops/seeds.py), as host
ints and as tensors, and counter-based random bits keyed by them.

The host int functions serve sampling, eval and the tests.  The train step
keeps its step counter on the device as well (`TrainState.step_t`) and
derives its seeds there with the same int32 arithmetic (`step_seed_t`,
`shard_seed_t`, `stream_seed_t`: int64 tensors holding the int32 values),
so a CUDA graph of several steps draws each step's own noise on replay.  A
kernel takes such a seed as a `SeedRef` (the step seed's tensor, the
stream and the salt) and applies the stream itself (csrc/philox.cuh).
Python ints do not wrap, so every int32 operation of the JAX version is
wrapped explicitly here.

Bits 27..30 carry a static stream id, the low 27 bits the (salt-mixed) step
seed; streams are disjoint for every step seed and the sign bit stays clear.

`bits32(key, counter)` gives 32 random bits for each element of an int64
`counter` tensor under `key` (an int or a 0-d int64 tensor): lowbias32
(a 32-bit integer hash) of `counter * golden + key * c`, in plain int64
tensor arithmetic, so the CPU and the card give the same bits.  For one
key it is a bijection of the counter mod 2^32: distinct counters give
distinct bits.  The row draws and the on-card clip draws come from it.
Each tensor op is a kernel launch in an eager step, so the tensor
versions take as few ops as the arithmetic allows.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

STREAM_PREPROCESS = 1   # Bernoulli binarization noise
STREAM_REPARAM = 2      # posterior sampling eps (salt = draw index)
STREAM_ONGEN = 3        # on-device clip generation
STREAM_PRIOR = 4        # prior draws of the sampling paths (z ~ N(0, I))
STREAM_ROWS = 5         # the resident path's uniform row draws

_LOW_MASK = 0x07FFFFFF
_M32 = 0xFFFFFFFF


def wrap_int32(v: int) -> int:
    """Two's-complement int32 value of v (what jnp.int32 arithmetic gives)."""
    v &= _M32
    return v - (1 << 32) if v >= (1 << 31) else v


def step_seed(step: int) -> int:
    """The train step's seed: step * 1103515245 + 12345 in int32 arithmetic
    (mmvae_tpu/train/loop.py:207)."""
    return wrap_int32(wrap_int32(step) * 1103515245 + 12345)


def shard_seed(seed: int, rank: int) -> int:
    """Rank `rank`'s seed of a data-parallel step: seed + rank * 1000003 in
    int32 arithmetic, the JAX step's shard offset
    (mmvae_tpu/train/loop.py:211-213); rank 0 keeps `seed`."""
    return wrap_int32(wrap_int32(seed) + wrap_int32(rank * 1000003))


def stream_seed(seed: int, stream_id: int, salt: int = 0) -> int:
    """int32 seed for stream `stream_id`; disjoint across streams for any step."""
    s = wrap_int32(wrap_int32(seed) + wrap_int32(salt * 1000003))
    return (s & _LOW_MASK) | (stream_id << 27)


# --- the same on int64 tensors ------------------------------------------------


_HALF = 1 << 31


def step_seed_t(step: torch.Tensor) -> torch.Tensor:
    """`step_seed` of an int64 tensor of steps, elementwise: the low 32 bits
    of step * 1103515245 + 12345, taken as signed (offset by 2^31 around
    the mask)."""
    return (((step & _M32) * 1103515245 + (12345 + _HALF)) & _M32) - _HALF


def shard_seed_t(seed: torch.Tensor, rank: int) -> torch.Tensor:
    """`shard_seed` of an int64 tensor of seeds; rank 0 returns `seed`."""
    if rank == 0:
        return seed
    return ((seed + (wrap_int32(rank * 1000003) + _HALF)) & _M32) - _HALF


def stream_seed_t(seed: torch.Tensor, stream_id: int, salt: int = 0) -> torch.Tensor:
    """`stream_seed` of an int64 tensor of seeds, elementwise."""
    if salt:
        seed = seed + wrap_int32(salt * 1000003)
    return (seed & _LOW_MASK) | (stream_id << 27)


class SeedRef(NamedTuple):
    """The stream seed `stream_seed(step, stream, salt)` of a step seed `step`
    that lives on the device (a 0-d int64 tensor).  The kernels read `step`
    from device memory and apply the stream and salt themselves; a plain
    version reads it back (`host_seed`)."""

    step: torch.Tensor
    stream: int
    salt: int = 0

    def tensor(self) -> torch.Tensor:
        return stream_seed_t(self.step, self.stream, self.salt)


Seed = Union[int, SeedRef]


def host_seed(seed: Seed) -> int:
    """The stream seed as a host int: an int as it is, a `SeedRef` read back
    from its device (a sync on a card; the plain versions' route)."""
    return seed if isinstance(seed, int) else int(seed.tensor())


def kernel_seed(seed: Seed, device) -> tuple:
    """(value, pointer or None, stream, salt): a kernel's seed arguments
    (csrc/philox.cuh `SeedArg`).  A `SeedRef`'s tensor must be a 0-d int64
    on `device`."""
    if isinstance(seed, int):
        return seed & _M32, None, 0, 0
    t = seed.step
    if t.device != torch.device(device) or t.dtype != torch.int64 or t.numel() != 1:
        raise ValueError(f"a device seed must be one int64 on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return 0, t.data_ptr(), seed.stream, seed.salt


# --- counter-based bits ---------------------------------------------------------


def _mul32(x, m: int):
    """x * m mod 2^32 for x in [0, 2^32): a multiplier >= 2^31 is taken as
    m - 2^32, so the int64 product cannot overflow."""
    return (x * (m - (1 << 32) if m >= 1 << 31 else m)) & _M32


def _lowbias32(x):
    """A bijective 32-bit integer hash (lowbias32), on an int or an int64
    tensor of values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def bits32(key: Union[int, torch.Tensor], counter: torch.Tensor) -> torch.Tensor:
    """32 random bits (int64 values in [0, 2^32)) for each element of the
    int64 `counter` (values in [0, 2^32)), keyed by `key`: an int, or a 0-d
    int64 tensor on the counter's device with its value in [0, 2^32) (a
    stream seed, or a key masked to 32 bits)."""
    if isinstance(key, int):
        key &= _M32
    return _lowbias32((_mul32(counter, 0x9E3779B9) + _mul32(key, 0x85EBCA6B)) & _M32)


def uniform24(bits: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) from the 24 high bits of `bits32` values."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)
