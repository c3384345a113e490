"""Sampling, reconstruction and rollout (port of mmvae_tpu/sample/generate.py).

Three entry points, each under `torch.no_grad()` on the model's device:

- `reconstruct(model, x, seed)`: encode -> sample -> decode -> sigmoid;
- `prior_sample(model, seed, batch, ...)`: the model's `prior_logits`
  (z ~ N(0, I) decoded, or the learned prior chain of the hierarchical
  model) -> sigmoid;
- `rollout(model, ctx, n_future, seed)`: context frames -> the posterior
  latent -> the decoder rolled out n_future steps (the prediction model).

Every posterior draw goes through the step sampler of `seed`
(`ops.dispatch.make_sample_fn`), so each head takes the fused head-and-sample
kernel on the card; without grad the recurrences take their kernels' forward
without residuals.  `eps` ({salt: tensor}) injects the posterior draws, and
`prior_sample`'s keyword arguments the prior's (`z`; `z_g` and `eps` for the
hierarchical model).  All return f32 numpy frames in [0, 1], the sigmoid
taken on f32 logits, copied to the host once at the end.  `save_grid` and
`save_gif` write PNG grids and GIFs (PIL, imported when called).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mmvae_torch.ops.dispatch import make_sample_fn

Eps = Optional[Dict[int, torch.Tensor]]


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _frames(logits: torch.Tensor) -> np.ndarray:
    return torch.sigmoid(logits.float()).cpu().numpy()


@torch.no_grad()
def reconstruct(model, x, seed: int, *, eps: Eps = None) -> np.ndarray:
    """Posterior reconstruction of frames x (f32 in [0, 1])."""
    out = model(torch.as_tensor(x).to(_device(model)), make_sample_fn(seed, eps))
    return _frames(out.logits)


@torch.no_grad()
def prior_sample(model, seed: int, batch: int, *, seq_len: Optional[int] = None,
                 **draws) -> np.ndarray:
    """Decode latents from the prior.

    Dispatch is a protocol, not a type check: every model implements
    `prior_logits(seed, batch, seq_len, **draws) -> logits`, so subclasses
    and renamed models keep working."""
    fn = getattr(model, "prior_logits", None)
    if fn is None:
        raise TypeError(
            f"prior_sample: {type(model).__name__} does not implement the "
            "prior-sampling protocol (a `prior_logits(seed, batch, seq_len)` "
            "method returning frame logits)"
        )
    return _frames(fn(seed, batch, seq_len, **draws))


@torch.no_grad()
def rollout(model, ctx, n_future: int, seed: int, *, eps: Eps = None) -> np.ndarray:
    """Context frames -> n_future predicted frames (prediction model).

    ctx: (B, Tc, H, W) f32 in [0, 1].  The latent is drawn from the posterior
    q(z | ctx) through the model's head (salt 0); the decoder ConvLSTM
    starts from the context encoder's terminal state (see models.pred_vae)."""
    state_t = model.context_state(torch.as_tensor(ctx).to(_device(model)))
    _, _, z = model.head.sample(state_t[1], make_sample_fn(seed, eps))
    return _frames(model.rollout(state_t, z, n_future))


# -- image/video dumping -----------------------------------------------------


def _to_u8(frames: np.ndarray) -> np.ndarray:
    return (np.clip(frames, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_grid(frames: np.ndarray, path: str, ncols: Optional[int] = None) -> None:
    """Tile (N, H, W) frames into a PNG grid."""
    from PIL import Image

    frames = _to_u8(frames.reshape(-1, *frames.shape[-2:]))
    n, h, w = frames.shape
    ncols = ncols or int(np.ceil(np.sqrt(n)))
    nrows = int(np.ceil(n / ncols))
    grid = np.zeros((nrows * h, ncols * w), np.uint8)
    for i, f in enumerate(frames):
        r, c = divmod(i, ncols)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = f
    Image.fromarray(grid, mode="L").save(path)


def save_gif(seq: np.ndarray, path: str, fps: int = 8) -> None:
    """(T, H, W) or (B, T, H, W) -> animated GIF (batch tiled horizontally)."""
    from PIL import Image

    if seq.ndim == 4:  # tile batch side by side
        seq = np.concatenate(list(seq), axis=-1)
    u8 = _to_u8(seq)
    imgs = [Image.fromarray(f, mode="L") for f in u8]
    imgs[0].save(
        path,
        save_all=True,
        append_images=imgs[1:],
        duration=int(1000 / fps),
        loop=0,
    )
