"""Disjoint int32 seed streams (port of mmvae_tpu/ops/seeds.py).

Seeds are host Python ints: the step counter lives on the host, so deriving
a step's seeds costs no device sync.  Python ints do not wrap, so every
int32 operation of the JAX version is wrapped explicitly here.

Bits 27..30 carry a static stream id, the low 27 bits the (salt-mixed) step
seed; streams are disjoint for every step seed and the sign bit stays clear.
"""

from __future__ import annotations

STREAM_PREPROCESS = 1   # Bernoulli binarization noise
STREAM_REPARAM = 2      # posterior sampling eps (salt = draw index)
STREAM_ONGEN = 3        # on-device clip generation
STREAM_PRIOR = 4        # prior draws of the sampling paths (z ~ N(0, I))

_LOW_MASK = 0x07FFFFFF


def wrap_int32(v: int) -> int:
    """Two's-complement int32 value of v (what jnp.int32 arithmetic gives)."""
    v &= 0xFFFFFFFF
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
