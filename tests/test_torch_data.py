"""mmvae_torch's data package against mmvae_tpu's: the loader copy
(`data/loader.py`) and on-device clip generation (`data/ongen.py`).

- The host generator is byte-identical to the reference's from the same
  seed, and so are the sprite tables.
- With the draws the JAX generator makes injected (its
  `jax.random.split(key, 4)` reproduced here), the port's clips equal
  `mmvae_tpu.data.ongen.generate_clips` byte for byte; the port's own draws
  (a torch.Generator) hold the invariants of tests/test_ongen.py.
- One stated divergence: an integer sprite bank of 0s and 1s stays a mask in
  the port, where the reference divides it by 255.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mmvae_tpu.data import ongen as jongen
from mmvae_tpu.data.loader import generate_moving_mnist as jgenerate
from mmvae_tpu.data.loader import load_sprite_bank as jload_sprite_bank
from mmvae_torch.data import loader, ongen


def test_host_generator_is_byte_identical():
    for kw in (dict(num_sequences=6, seq_len=5, seed=3),
               dict(num_sequences=4, seq_len=3, image_size=48, num_digits=3, seed=11)):
        a, b = loader.generate_moving_mnist(**kw), jgenerate(**kw)
        assert a.dtype == np.uint8 and np.array_equal(a, b)


def test_sprite_tables_are_equal():
    np.testing.assert_array_equal(ongen.sprite_table(), jongen.sprite_table())
    for d in range(10):
        np.testing.assert_array_equal(loader._digit_sprite(d, 24),
                                      jongen._digit_sprite(d, 24))


def test_sprite_bank_loading_and_the_mask_divergence(tmp_path):
    """Float and u8 banks load as the reference loads them; an integer bank
    of 0s and 1s is kept as a mask (the reference: 1/255, almost black)."""
    rng = np.random.default_rng(0)
    banks = {"float": rng.uniform(-0.2, 1.2, size=(3, 8, 8)).astype(np.float32),
             "u8": rng.integers(0, 256, size=(3, 8, 8)).astype(np.uint8),
             "mask": rng.integers(0, 2, size=(3, 8, 8)).astype(np.int64)}
    for name, bank in banks.items():
        path = tmp_path / f"{name}.npy"
        np.save(path, bank)
        got, ref = loader.load_sprite_bank(str(path)), jload_sprite_bank(str(path))
        assert got.dtype == np.float32
        if name == "mask":
            np.testing.assert_array_equal(got, bank.astype(np.float32))
            np.testing.assert_allclose(ref, bank / 255.0, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, ref)
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((3, 8, 6)))
    with pytest.raises(ValueError, match="square"):
        loader.load_sprite_bank(str(bad))


def _jax_draws(key, batch, num_digits, n_sprites, lim) -> ongen.Draws:
    """The draws of mmvae_tpu.data.ongen.generate_clips for `key`, in its order."""
    k_digit, k_pos, k_theta, k_speed = jax.random.split(key, 4)
    shape = (batch, num_digits)
    draws = (jax.random.randint(k_digit, shape, 0, n_sprites),
             jax.random.uniform(k_pos, shape + (2,), maxval=lim),
             jax.random.uniform(k_theta, shape, maxval=2.0 * np.pi),
             jax.random.uniform(k_speed, shape, minval=2.0, maxval=4.5))
    return ongen.Draws(*(torch.from_numpy(np.array(d)) for d in draws))


def _const_bank():
    vals = np.array([0.25, 0.5, 0.75], np.float32)
    return np.broadcast_to(vals[:, None, None], (3, 8, 8)).copy()


@pytest.mark.parametrize("batch,seq_len,image,digits,bank", [
    (8, 20, 64, 2, None),
    (5, 40, 48, 3, None),
    (6, 7, 32, 1, "const"),
])
def test_ongen_with_jax_draws_is_byte_identical(batch, seq_len, image, digits, bank):
    sprites = _const_bank() if bank else None
    table = sprites if bank else jongen.sprite_table()
    key = jax.random.PRNGKey(batch * 100 + seq_len)
    want = np.asarray(jongen.generate_clips(key, batch, seq_len=seq_len, image_size=image,
                                            num_digits=digits, sprites=sprites))
    draws = _jax_draws(key, batch, digits, table.shape[0], float(image - table.shape[-1]))
    got = ongen.generate_clips(None, batch, seq_len=seq_len, image_size=image,
                               num_digits=digits, sprites=sprites, draws=draws)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert int(got.max()) > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_ongen_per_frame_branch_with_jax_draws_is_byte_identical():
    key = jax.random.PRNGKey(4)
    want = np.asarray(jongen.clip_batch_fn(9, (64, 64), per_frame=True)(key))
    fn = ongen.clip_batch_fn(9, (64, 64), per_frame=True, device="cpu")
    got = fn(0, draws=_jax_draws(key, 9, 2, 10, 48.0))
    assert got.shape == (9, 64, 64)
    np.testing.assert_array_equal(got.numpy(), want)


def _clips(seed, batch, **kw):
    return ongen.generate_clips(seed, batch, device="cpu", **kw)


def test_generate_clips_runs_on_the_card_unless_told():
    """Like `Canvas` and the port's other entry points, `generate_clips`
    takes the card by default; a caller on the CPU names it."""
    import inspect

    for fn in (ongen.generate_clips, ongen.Canvas):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    clips = ongen.generate_clips(3, 2, seq_len=3, image_size=32, device="cpu")
    assert clips.device.type == "cpu" and clips.shape == (2, 3, 32, 32)


def test_ongen_shapes_and_determinism():
    a = _clips(7, 4, seq_len=5)
    assert a.shape == (4, 5, 64, 64) and a.dtype == torch.uint8
    assert torch.equal(a, _clips(7, 4, seq_len=5))
    assert not torch.equal(a, _clips(8, 4, seq_len=5))
    fn = ongen.clip_batch_fn(6, (5, 64, 64), device="cpu")
    assert torch.equal(fn(3), fn(3)) and not torch.equal(fn(3), fn(4))
    assert fn(3).shape == (6, 5, 64, 64)
    frames = ongen.clip_batch_fn(6, (48, 48), device="cpu")(0)
    assert frames.shape == (6, 48, 48) and int(frames.max()) > 0
    with pytest.raises(ValueError, match="square"):
        ongen.clip_batch_fn(2, (3, 64, 32), device="cpu")


def test_ongen_sprites_never_leave_the_canvas():
    """Every corner in [0, lim] at every frame of 100-frame clips, and every
    frame keeps at least one sprite's mass (tests/test_ongen.py)."""
    canvas = ongen.Canvas(8, 100, 64, device="cpu")
    draws = canvas.draw(3, 2)
    yx = canvas.positions(draws)
    assert int(yx.min()) >= 0 and int(yx.max()) <= canvas.lim
    mass = canvas.render(draws).float().sum(dim=(2, 3))
    assert bool((mass >= 255.0 * float(ongen.sprite_table().sum(axis=(1, 2)).min())).all())


def test_ongen_closed_form_matches_stepwise_bounces():
    """The truncated closed-form corners equal the host generator's step-wise
    reflection, for the same starts and velocities."""
    canvas = ongen.Canvas(16, 60, 64, device="cpu")
    draws = canvas.draw(5, 1)
    yx = canvas.positions(draws)[:, 0].numpy()  # (B, T, 2)
    theta = draws.theta.double()[:, 0]
    vel = (torch.stack([torch.cos(theta), torch.sin(theta)], -1).float()
           * draws.speed[:, 0, None]).numpy()
    pos = draws.pos0[:, 0].numpy().copy()
    lim = canvas.lim
    for t in range(60):
        np.testing.assert_array_equal(yx[:, t], pos.astype(np.int64), err_msg=f"t={t}")
        pos = pos + vel
        over, under = pos > lim, pos < 0
        pos = np.where(over, 2 * lim - pos, np.where(under, -pos, pos)).astype(np.float32)
        vel = np.where(over | under, -vel, vel)


def test_ongen_distribution_matches_the_host_generator():
    host = loader.generate_moving_mnist(192, seq_len=10, seed=11).astype(np.float64)
    dev = _clips(11, 192, seq_len=10).double().numpy()
    assert abs(dev.mean() - host.mean()) / host.mean() < 0.05

    def band_ratio(x):
        return x[..., 16:48, 16:48].mean() / x.mean()

    assert abs(band_ratio(dev) - band_ratio(host)) < 0.15
    assert dev.max() <= 255 and dev.min() == 0


def test_ongen_custom_bank_identities_are_uniform():
    """One digit a clip from a bank of three constant sprites: every frame is
    one 8x8 block of one bank value at an integer offset, and each value
    appears a fair share of the clips."""
    bank = _const_bank()
    values = (bank[:, 0, 0] * 255).astype(np.uint8)
    clips = ongen.generate_clips(5, 48, seq_len=4, image_size=32, num_digits=1, sprites=bank,
                                 device="cpu").numpy()
    for frame in clips.reshape(-1, 32, 32):
        nz = np.argwhere(frame > 0)
        assert len(nz) == 64 and tuple(nz.max(0) - nz.min(0)) == (7, 7)
        assert len(np.unique(frame[frame > 0])) == 1 and frame.max() in values
    counts = np.bincount(np.searchsorted(values, clips[:, 0].max(axis=(1, 2))), minlength=3)
    assert counts.min() >= 4
