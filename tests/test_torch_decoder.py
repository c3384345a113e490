"""mmvae_torch's ConvDecoder against mmvae_tpu's, in every `upsample` mode,
and the flax -> torch mapping of the leaves the modes add (`mid_mix`, a
plain conv, and `k4_tail`, a 4x4/s2 SAME transposed conv).

The same flax params go into the port through `convert.state_dict_from_flax`;
forward and gradients of a random cotangent are compared in f32 at 5e-4 of
each tensor's largest magnitude (as tests/test_torch_models.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mmvae_tpu.configs import get_config as jget_config
from mmvae_tpu.models.base import ConvDecoder as JConvDecoder
from mmvae_tpu.models.seq_vae import ConvLSTMSeqVAE as JSeqVAE
from mmvae_torch.configs import get_config
from mmvae_torch.convert import _map_leaf, state_dict_from_flax
from mmvae_torch.models.base import DECODER_MODES, ConvDecoder
from mmvae_torch.train.loop import build_model

CHANNELS = (16, 8, 4)  # seq_vae's (128, 64, 32) at tiny widths
CIN, GRID, N = 8, 8, 3


@pytest.fixture(autouse=True)
def _full_precision_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def test_the_port_has_every_mode_of_the_reference():
    import inspect

    src = inspect.getsource(JConvDecoder)
    assert {m for m in DECODER_MODES if f'"{m}"' in src} == set(DECODER_MODES)
    with pytest.raises(ValueError, match="not one of"):
        ConvDecoder(CIN, CHANNELS, upsample="fast_lq")


@pytest.mark.parametrize("mode", DECODER_MODES)
def test_decoder_mode_matches_flax(mode):
    rng = np.random.default_rng(0)
    h = rng.normal(size=(N, GRID, GRID, CIN)).astype(np.float32)  # NHWC, as flax
    jm = JConvDecoder(channels=CHANNELS, upsample=mode)
    # random weights and biases of the mode's param shapes (biases nonzero,
    # so that their mapping is tested too)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(3), jnp.asarray(h))
    params = jax.tree.map(
        lambda s: jnp.asarray(rng.normal(size=s.shape).astype(np.float32)
                              / np.sqrt(np.prod(s.shape[:-1]))), shapes)
    logits = jax.jit(jm.apply)(params, jnp.asarray(h))
    assert logits.shape == (N, 64, 64, 1)
    cot = rng.normal(size=logits.shape).astype(np.float32)
    jgh, jgp = jax.jit(jax.grad(lambda x, p: jnp.sum(jm.apply(p, x) * cot), argnums=(0, 1)))(
        jnp.asarray(h), params)

    tm = ConvDecoder(CIN, CHANNELS, upsample=mode)
    tm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    th = torch.from_numpy(h).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = tm(th)
    assert out.dtype == torch.float32 and out.shape == (N, 1, 64, 64)
    (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    _close(out.permute(0, 2, 3, 1), logits, 5e-4, f"{mode} logits")
    _close(th.grad.permute(0, 2, 3, 1), jgh, 5e-4, f"{mode} d input")
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgp))
    assert set(want) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        _close(p.grad, want[name].numpy(), 5e-4, f"{mode} d {name}")


@pytest.mark.parametrize("mode,leaf", [("fast_mid", "mid_mix"), ("fast_k4tail", "k4_tail")])
def test_seq_vae_tree_with_the_mode_maps_every_leaf(mode, leaf):
    """The production seq_vae tree with the mode: its new leaf is there, every
    leaf maps exactly once and loads strictly into the port's model."""
    overrides = (f"model.kwargs.dec_upsample={mode}",)
    cfg = jget_config("seq_vae", overrides)
    jm = JSeqVAE(**cfg.model.kwargs, fused=False)
    x = jnp.zeros((1, 2, 64, 64), jnp.float32)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, lambda m, v, salt=0: m))
    fake = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), params)
    assert leaf in fake["params"]["frame_dec"]
    sd = state_dict_from_flax(fake)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    port = build_model(get_config("seq_vae", overrides), device="cpu")
    assert set(sd) == set(port.state_dict())
    for name, t in port.state_dict().items():
        assert sd[name].shape == t.shape, name
    port.load_state_dict(sd, strict=True)


def test_mid_mix_maps_as_a_conv_and_k4_tail_as_a_transpose():
    k = np.arange(4 * 4 * 3 * 2, dtype=np.float32).reshape(4, 4, 3, 2)  # HWIO
    mid = _map_leaf(("frame_dec", "mid_mix", "kernel"), k, {})
    np.testing.assert_array_equal(mid, k.transpose(3, 2, 0, 1))
    tail = _map_leaf(("frame_dec", "k4_tail", "kernel"), k, {})
    np.testing.assert_array_equal(tail, k[::-1, ::-1].transpose(2, 3, 0, 1))
    assert tail.shape == (3, 2, 4, 4)  # ConvTranspose2d (in, out, kh, kw)
