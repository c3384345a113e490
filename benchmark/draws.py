"""The random draws of a train step, worked out again from the step counter.

Frozen copies of the port's arithmetic, so the reference needs nothing the
program made:

- the step seed, a data-parallel rank's shard seed and the stream seeds
  (int32 arithmetic; `mmvae_torch/ops/seeds.py` as of this benchmark);
- the resident set's uniform row draws (`bits32`, lowbias32 of the row
  counter under the ROWS stream seed);
- Philox-4x32-10 (`csrc/philox.cuh`), from which the preprocess kernel
  draws its Bernoulli bits (24-bit uniforms, four a counter) and the
  Gaussian head its eps (Box-Muller on the first two words of a counter).

Everything runs on int64 tensors holding 32-bit values, on any device.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_LOW_MASK = 0x07FFFFFF
_HALF = 1 << 31

STREAM_PREPROCESS = 1
STREAM_REPARAM = 2
STREAM_ROWS = 5

PHILOX_KEY_HI = 0x6D6D7661
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def wrap_int32(v: int) -> int:
    v &= M32
    return v - (1 << 32) if v >= _HALF else v


def step_seed(step: int) -> int:
    """The train step's seed: step * 1103515245 + 12345 in int32."""
    return wrap_int32(wrap_int32(step) * 1103515245 + 12345)


def shard_seed(seed: int, rank: int) -> int:
    """A data-parallel rank's seed: seed + rank * 1000003 in int32."""
    return wrap_int32(wrap_int32(seed) + wrap_int32(rank * 1000003))


def stream_seed(seed: int, stream: int, salt: int = 0) -> int:
    """Stream `stream`'s seed (bits 27..30) of a step seed, salted."""
    s = wrap_int32(wrap_int32(seed) + wrap_int32(salt * 1000003))
    return ((s & _LOW_MASK) | (stream << 27)) & M32


def rank_seed(step: int, rank: int) -> int:
    return shard_seed(step_seed(step), rank)


# --- lowbias32 rows ---------------------------------------------------------------


def _mul32(x, m: int):
    return (x * (m - (1 << 32) if m >= _HALF else m)) & M32


def bits32(key: int, counter: torch.Tensor) -> torch.Tensor:
    """lowbias32 of `counter * golden + key * c` (values in [0, 2^32))."""
    x = (_mul32(counter, 0x9E3779B9) + _mul32(key & M32, 0x85EBCA6B)) & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_rows(seed: int, n_rows: int, batch: int, device) -> torch.Tensor:
    """A step's `batch` rows of a resident set of `n_rows`, with replacement."""
    key = stream_seed(seed, STREAM_ROWS)
    return bits32(key, torch.arange(batch, device=device, dtype=torch.int64)) % n_rows


# --- Philox-4x32-10 ---------------------------------------------------------------


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m, a in [0, 2^32), in int64 pieces."""
    p_lo = (a & 0xFFFF) * m           # < 2^48
    p_hi = (a >> 16) * m              # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & M32


def philox4x32(ctr, key0, key1: int = PHILOX_KEY_HI):
    """The four output words of Philox-4x32-10 for counters `ctr` (a tuple of
    four int64 tensors) under the key (key0, key1); key0 an int or a
    tensor broadcasting against the counters."""
    x0, x1, x2, x3 = ctr
    k0 = key0 & M32 if isinstance(key0, int) else key0 & M32
    k1 = key1 & M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(x0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(x2, _PHILOX_M1)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & M32
        k1 = (k1 + _PHILOX_W1) & M32
    return x0, x1, x2, x3


def philox_words(counter: torch.Tensor, seed: int):
    """The four words for 64-bit counters `counter` under stream seed `seed`
    (philox.cuh `philox_draw`)."""
    zero = torch.zeros_like(counter)
    return philox4x32((counter & M32, counter >> 32, zero, zero), seed)


def binarize(pix_u8: torch.Tensor, seed: int) -> torch.Tensor:
    """The preprocess kernel's frames: element e is 1 iff float(u24) <
    float(u8) * (2^24 / 255) in f32, u24 the high 24 bits of word e % 4 of
    counter e // 4.  `pix_u8` is the gathered batch; returns f32 {0, 1}."""
    n = pix_u8.numel()
    counters = torch.arange((n + 3) // 4, device=pix_u8.device, dtype=torch.int64)
    words = torch.stack(philox_words(counters, seed), dim=1).reshape(-1)[:n]
    u24 = (words >> 8).to(torch.float32)
    scale = torch.tensor(16777216.0 / 255.0, dtype=torch.float32, device=pix_u8.device)
    on = u24 < pix_u8.reshape(-1).to(torch.float32) * scale
    return on.to(torch.float32).reshape(pix_u8.shape)


def normal(m: int, n: int, seed: int, device) -> torch.Tensor:
    """The Gaussian head's eps (M, N), f32: element e = m N + j, Box-Muller
    on u1 = (w0 >> 8) 2^-24 + 2^-25 and u2 = (w1 >> 8) 2^-24, computed in
    f64 and rounded once."""
    counters = torch.arange(m * n, device=device, dtype=torch.int64)
    w0, w1, _, _ = philox_words(counters, seed)
    u1 = (w0 >> 8).to(torch.float64) * 2.0 ** -24 + 2.0 ** -25
    u2 = (w1 >> 8).to(torch.float64) * 2.0 ** -24
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return eps.to(torch.float32).reshape(m, n)


def resident_set(n_clips: int, frames: int, seed: int, device) -> torch.Tensor:
    """The resident u8 clips (N, T, 64, 64), uniform bytes from a generator on
    `device` seeded with `seed` (the port's `bench.throughput.resident_set`,
    seeded by the run's seed instead of 0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n_clips, frames, 64, 64), generator=gen, device=device,
                         dtype=torch.uint8)


def start_step(seed: int) -> int:
    """The step counter a run starts from: the seed's low 30 bits, so every
    seed draws its own rows, Bernoulli bits and eps."""
    return seed & ((1 << 30) - 1)
