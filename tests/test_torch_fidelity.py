"""Trained generation fidelity of mmvae_torch (the port of
tests/test_fidelity.py).

Contract (BASELINE.json:5): "the sampling/rollout path reproduces reference
frame generations to output fidelity".  After a short deterministic train
on the CPU (the port's `fit` on the JAX tests' tiny configs,
tests/test_train_smoke.py), per-pixel reconstruction BCE and context ->
future rollout BCE must beat the base-rate predictor (a constant
mean-pixel frame) with margin, at the JAX test's own limits on the same
procedural clips (seeds 5 and 6).
"""

import numpy as np
import pytest
import torch

from test_train_smoke import NARROW, SMALL_MODEL, TINY_OVERRIDES

from mmvae_torch.configs import get_config
from mmvae_torch.data import transforms
from mmvae_torch.data.loader import generate_moving_mnist
from mmvae_torch.sample import generate as gen
from mmvae_torch.train.loop import fit


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tiny_config(name):
    cfg = get_config(name, tuple(TINY_OVERRIDES[name] + SMALL_MODEL))
    cfg.model.kwargs.update(NARROW.get(name, {}))
    return cfg


def _bce_per_pixel(probs: np.ndarray, target: np.ndarray) -> float:
    eps = 1e-6
    p = np.clip(probs, eps, 1 - eps)
    return float(np.mean(-(target * np.log(p) + (1 - target) * np.log(1 - p))))


def _binarized(clips: np.ndarray) -> np.ndarray:
    x = transforms.normalize(torch.from_numpy(clips)).numpy()
    return (x > 0.5).astype(np.float32)


def test_mlp_recon_beats_base_rate():
    cfg = _tiny_config("mlp_vae")
    cfg.train.steps = 200
    cfg.train.log_every = 200
    state, _ = fit(cfg, device="cpu")

    frames = _binarized(generate_moving_mnist(8, seq_len=4, seed=5))[:, 0]
    recon = gen.reconstruct(state.model, frames, seed=1)
    bce = _bce_per_pixel(recon, frames)
    base = _bce_per_pixel(np.full_like(frames, frames.mean()), frames)
    assert bce < 0.9 * base, f"recon bce/px {bce:.3f} vs base-rate {base:.3f}"
    assert bce < 0.20, f"recon bce/px {bce:.3f} above absolute threshold"


def test_pred_rollout_beats_base_rate():
    cfg = _tiny_config("pred_vae")
    cfg.train.steps = 300
    cfg.train.log_every = 300
    state, _ = fit(cfg, device="cpu")

    clips = _binarized(generate_moving_mnist(8, seq_len=4, seed=6))
    ctx, future = clips[:, :2], clips[:, 2:]
    ro = gen.rollout(state.model, ctx, 2, seed=0)
    bce = _bce_per_pixel(ro, future)
    base = _bce_per_pixel(np.full_like(future, future.mean()), future)
    assert bce < 0.95 * base, f"rollout bce/px {bce:.3f} vs base-rate {base:.3f}"
    assert bce < 0.20, f"rollout bce/px {bce:.3f} above absolute threshold"
