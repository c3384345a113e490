"""Configs 1 and 2 (`mlp_vae`, `conv_vae`) of mmvae_torch against mmvae_tpu:
the param bridge on the production trees, and the forward and every
gradient at tiny widths with the same flax params, frames and eps.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mmvae_tpu.configs import get_config as jget_config
from mmvae_tpu.models import MODEL_REGISTRY as JREGISTRY
from mmvae_tpu.ops.elbo_ref import elbo_parts_ref as jelbo
from mmvae_torch.configs import get_config
from mmvae_torch.convert import state_dict_from_flax
from mmvae_torch.models import MODEL_REGISTRY
from mmvae_torch.ops.elbo_kernels import elbo_reduce
from mmvae_torch.train.loop import build_model

B = 3
TINY = {
    "mlp_vae": dict(latent_dim=8, hidden_dim=32),
    "conv_vae": dict(latent_dim=8, channels=(4, 8, 8, 8)),
}
# flax leaves of the production trees: 5 Dense (mlp_vae); 4 convs, the
# head's 2 Dense, dec_in, 4 transposes and the final conv (conv_vae)
LEAVES = {"mlp_vae": 10, "conv_vae": 24}


@pytest.fixture(autouse=True)
def _full_precision_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", ["mlp_vae", "conv_vae"])
def test_state_dict_from_flax_consumes_every_leaf(name):
    """The production tree: every leaf mapped exactly once by the existing
    rules (Dense, HWIO conv, `ConvTranspose_i`), loading strictly into the
    port's module with matching shapes and the same parameter count."""
    cfg = jget_config(name)
    jm = JREGISTRY[name](**cfg.model.kwargs)
    x = jnp.zeros((1, 64, 64), jnp.float32)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, lambda m, v, salt=0: m))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == LEAVES[name]
    sd = state_dict_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), params))
    port = build_model(get_config(name), device="cpu")
    assert set(sd) == set(port.state_dict())
    for key, t in port.state_dict().items():
        assert sd[key].shape == t.shape, key
    port.load_state_dict(sd, strict=True)
    assert sum(math.prod(leaf.shape) for _, leaf in leaves) == sum(
        p.numel() for p in port.parameters())


def _run_pair(name):
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(B, 64, 64)) < 0.35).astype(np.float32)
    eps = rng.normal(size=(B, TINY[name]["latent_dim"])).astype(np.float32)
    jm = JREGISTRY[name](**TINY[name])
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), lambda m, v, salt=0: m)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), lambda m, v, salt=0: m + jnp.exp(0.5 * v) * eps)
        bce, kl = jelbo(out.logits, out.target, out.mu, out.logvar)
        return (bce + kl) / B, (out.logits, out.mu, out.logvar, out.z)

    (_, jouts), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm = MODEL_REGISTRY[name](**TINY[name])
    tm.load_state_dict(state_dict_from_flax(_np_tree(params)))
    teps = torch.from_numpy(eps)
    out = tm(torch.from_numpy(x), lambda m, v, salt=0: m + torch.exp(0.5 * v) * teps)
    bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
    ((bce + kl) / B).backward()
    return (out.logits, out.mu, out.logvar, out.z), jouts, tm, state_dict_from_flax(_np_tree(jg))


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("name", ["mlp_vae", "conv_vae"])
def test_forward_and_gradients_match_flax(name):
    """f32: logits, mu, logvar, z and every parameter gradient to 5e-4 of
    each tensor's largest magnitude (as tests/test_torch_models.py holds
    seq_vae).  conv_vae's flatten and dec_in reshape follow flax's NHWC
    order; a wrong order fails this at the head's and dec_in's gradients."""
    outs, jouts, tm, jgrads = _run_pair(name)
    assert outs[0].shape == (B, 64, 64)
    for what, a, b in zip(("logits", "mu", "logvar", "z"), outs, jouts):
        _close(a, b, 5e-4, what)
    assert set(jgrads) == {n for n, _ in tm.named_parameters()}
    for what, p in tm.named_parameters():
        _close(p.grad, jgrads[what].numpy(), 5e-4, what)


@pytest.mark.parametrize("name", ["mlp_vae", "conv_vae"])
def test_sampling_goes_through_the_fused_head(name, monkeypatch):
    """With the train step's sample function the model samples through
    `gaussian_head_sample` (the fused head; its plain version on the CPU),
    never through the bare (mu, logvar) sampler."""
    from mmvae_torch.models import base
    from mmvae_torch.ops import dispatch

    calls = []
    real = base.gaussian_head_sample
    monkeypatch.setattr(base, "gaussian_head_sample",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    monkeypatch.setattr(dispatch.StepSampler, "__call__",
                        lambda *a, **k: pytest.fail("the bare sampler was called"))
    model = MODEL_REGISTRY[name](**TINY[name])
    out = model(torch.zeros(B, 64, 64), dispatch.make_sample_fn(5))
    assert out.z.shape == (B, 8) and len(calls) == 1
