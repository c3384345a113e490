"""On-card Moving MNIST generation: fresh clips inside the train step (port of
mmvae_tpu/data/ongen.py:49-155).

The same process as the host generator (`data.loader.generate_moving_mnist`):
`num_digits` sprites a clip, identity U{0..K-1}, start U[0, lim)^2, angle
U[0, 2 pi), speed U[2, 4.5), elastic bounces, compositing that saturates at
1.0 and quantizes to u8 by `*255` truncation.

- **Draws** are counter-based bits keyed by the seed (`ops.seeds.bits32`,
  five words a sprite: digit, start y, start x, angle, speed;
  `Canvas.draw`), in int64 tensor arithmetic on the canvas's device, so the
  card and the CPU draw the same clips from a seed, and a seed held on the
  card (the train step's) needs no host call: a CUDA graph of train steps
  replays each step's own draws.  `generate_clips` also takes them
  injected (`Draws`), so a test can hand it the draws the JAX generator
  made.  The bits are not threefry's: from a seed the clips match the
  reference in distribution only.
- **Positions** in closed form: reflection off the [0, lim] walls is a
  triangular fold of the free trajectory, lim - |((p0 + v t) mod 2 lim) -
  lim|, in float32, truncated to int.  cos and sin of the angle are taken
  in float64 and rounded to float32, so the card and the CPU place the
  sprites alike.
- **Compositing** by index: each digit's 16x16 window is added into the
  canvas with `index_add_`, one digit after another (within a digit no two
  pixels share an index), so the sum is exact, ordered and free of any
  matmul: the u8 output does not depend on the TF32 settings.  The
  reference composites with two one-hot einsums, whose sums are exact too.
- **Constants** (the sprites, the time steps, the canvas offsets) live on
  the device in a `Canvas`, built once per `clip_batch_fn`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from mmvae_torch.data.loader import _digit_sprite
from mmvae_torch.ops.seeds import bits32, uniform24

# the words a sprite draws: digit, start y, start x, angle, speed
_WORDS = 5

SPRITE_SIZE = 16


def sprite_table(size: int = SPRITE_SIZE) -> np.ndarray:
    """(10, size, size) float32 digit sprites, those of the host generator."""
    return np.stack([_digit_sprite(d, size) for d in range(10)]).astype(np.float32)


class Draws(NamedTuple):
    """A batch's random draws: digits (B, D) int, start positions (B, D, 2)
    in [0, lim), angles (B, D) in [0, 2 pi), speeds (B, D) in [2, 4.5)."""

    digits: torch.Tensor
    pos0: torch.Tensor
    theta: torch.Tensor
    speed: torch.Tensor


class Canvas:
    """The device constants of one clip geometry: batch x seq_len frames of
    image_size^2, composited from `sprites` ((K, S, S) float in [0, 1];
    default the 10-glyph font)."""

    def __init__(self, batch: int, seq_len: int, image_size: int, sprites=None, device="cuda"):
        if sprites is None:
            sprites = sprite_table()
        self.sprites = torch.as_tensor(np.asarray(sprites, np.float32), device=device)
        sp = self.sprites.shape[-1]
        if sp > image_size:
            raise ValueError(f"sprite size {sp} exceeds image_size {image_size}")
        self.shape = (batch, seq_len, image_size, image_size)
        self.lim = float(image_size - sp)
        self.device = torch.device(device)
        self.t = torch.arange(seq_len, dtype=torch.float32, device=device)
        # flat offset of each frame, and of each pixel of a window in a frame
        self.frame_base = (torch.arange(batch * seq_len, device=device)
                           * image_size * image_size).view(batch, seq_len)
        win = torch.arange(sp, device=device)
        self.window = win[:, None] * image_size + win[None, :]

    def draw(self, seed: Union[int, torch.Tensor], num_digits: int) -> Draws:
        """The draws of `seed` (an int, or a 0-d int64 tensor on this
        device): word w of sprite d of clip b is `bits32(seed, (b * D + d)
        * 5 + w)`; the digit is its value mod K, the starts, angle and speed
        uniforms from its 24 high bits."""
        shape = (self.shape[0], num_digits)
        counter = torch.arange(math.prod(shape) * _WORDS, device=self.device)
        bits = bits32(seed, counter).view(*shape, _WORDS)
        u = uniform24(bits[..., 1:])
        digits = bits[..., 0] % self.sprites.shape[0]
        pos0 = u[..., 0:2] * self.lim
        theta = u[..., 2] * (2.0 * math.pi)
        speed = u[..., 3] * 2.5 + 2.0
        return Draws(digits, pos0, theta, speed)

    def positions(self, draws: Draws) -> torch.Tensor:
        """(B, D, T, 2) int64 top-left corners (y, x) of every sprite."""
        theta = draws.theta.to(self.device, torch.float64)
        unit = torch.stack([torch.cos(theta), torch.sin(theta)], -1).float()
        vel = unit * draws.speed.to(self.device, torch.float32)[..., None]
        free = (draws.pos0.to(self.device, torch.float32)[:, :, None, :]
                + vel[:, :, None, :] * self.t[None, None, :, None])
        folded = self.lim - (torch.remainder(free, 2.0 * self.lim) - self.lim).abs()
        return folded.long()  # truncation: folded >= 0

    def render(self, draws: Draws) -> torch.Tensor:
        """u8 clips (B, T, H, W) of `draws`."""
        b, t, h, w = self.shape
        yx = self.positions(draws)
        digits = draws.digits.to(self.device, torch.long)
        canvas = torch.zeros(b * t * h * w, dtype=torch.float32, device=self.device)
        for d in range(digits.shape[1]):
            corner = self.frame_base + yx[:, d, :, 0] * w + yx[:, d, :, 1]  # (B, T)
            idx = corner[:, :, None, None] + self.window                   # (B, T, S, S)
            vals = self.sprites[digits[:, d]][:, None].expand(idx.shape)
            canvas.index_add_(0, idx.reshape(-1), vals.reshape(-1))
        return canvas.clamp_(0.0, 1.0).mul_(255.0).to(torch.uint8).view(b, t, h, w)


def generate_clips(seed: Optional[int], batch: int, *, seq_len: int = 20,
                   image_size: int = 64, num_digits: int = 2, sprites=None,
                   draws: Optional[Draws] = None, device="cuda") -> torch.Tensor:
    """Fresh u8 clips (batch, seq_len, image_size, image_size) on `device`
    (the card unless the caller names the CPU; the injected draws' device
    where given): drawn from `seed`, or from the injected `draws` (then
    `seed` may be None)."""
    dev = draws.digits.device if draws is not None else device
    canvas = Canvas(batch, seq_len, image_size, sprites, dev)
    return canvas.render(draws if draws is not None else canvas.draw(seed, num_digits))


def clip_batch_fn(batch: int, sample_shape: Tuple[int, ...], *, num_digits: int = 2,
                  per_frame: bool = False, sprites=None, device="cuda"):
    """fn(seed, draws=None) -> u8 batch shaped like the training data, on
    `device` (the card unless the caller names the CPU).  `sample_shape`
    is one sample's shape: (T, H, W) for clip models, (H, W) per frame.
    Per-frame batches are 1-frame clips squeezed (a reflected position is
    uniform on [0, lim] at any t).  Each call draws from `seed` (an int, or
    a 0-d int64 tensor on `device`: the train step's ONGEN stream seed), or
    renders the injected `draws`."""
    per_frame = per_frame or len(sample_shape) == 2
    h, w = sample_shape[-2:]
    if h != w:
        raise ValueError(f"square frames only, got {sample_shape}")
    canvas = Canvas(batch, 1 if per_frame else sample_shape[0], h, sprites, device)

    def fn(seed, draws: Optional[Draws] = None) -> torch.Tensor:
        if draws is None:
            draws = canvas.draw(seed, num_digits)
        clips = canvas.render(draws)
        return clips[:, 0] if per_frame else clips

    return fn
