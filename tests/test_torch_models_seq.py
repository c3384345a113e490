"""Configs 4 and 5 in the port against mmvae_tpu: PredSeqVAE and HierVideoVAE
forward and gradients (fused=True and fused=False, f32 and bf16), the flax
GRU cell and `gaussian_kl`, the param bridge on the production trees, init,
and a 25-step Adam curve of pred_vae.

The JAX side takes the proj-fused encoder kernel (K5) and, with fused=True,
K6 in the decoder, in interpret mode: image_size=32, enc_channels=(8, 128),
enc_x_kernel=1 (as tests/test_torch_models.py).  Config 5 runs 2 chunks of 2
frames.  The same flax params go into the port; frames and eps are injected.
"""

import functools
import math
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as nn

from mmvae_tpu.configs import get_config as jget_config
from mmvae_tpu.models.hier_vae import HierVideoVAE as JHier
from mmvae_tpu.models.hier_vae import gaussian_kl as jgaussian_kl
from mmvae_tpu.models.pred_vae import PredSeqVAE as JPred
from mmvae_tpu.ops.elbo_pallas import elbo_reduce_pallas
from mmvae_tpu.ops.elbo_ref import elbo_parts_ref as jelbo
from mmvae_torch.configs import get_config
from mmvae_torch.convert import state_dict_from_flax
from mmvae_torch.models.hier_vae import GRUCell, HierVideoVAE, gaussian_kl
from mmvae_torch.models.pred_vae import PredSeqVAE
from mmvae_torch.ops.elbo_kernels import elbo_reduce
from mmvae_torch.train.loop import build_model
from mmvae_torch.train.state import create_train_state

B, T = 2, 4
_ENC = dict(enc_channels=(8, 128), lstm_features=8, image_size=32, enc_x_kernel=1)
_MODELS = {
    "pred_vae": (JPred, PredSeqVAE, dict(latent_dim=8, context_len=2, **_ENC)),
    "hier_vae": (JHier, HierVideoVAE, dict(global_latent=8, chunk_latent=4, chunk_len=2,
                                           chunk_feature=16, **_ENC)),
}


@pytest.fixture(autouse=True)
def _full_precision_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(name):
    kw = _MODELS[name][2]
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(B, T, 32, 32)) < 0.35).astype(np.float32)
    eps = {0: rng.normal(size=(B, kw.get("latent_dim", kw.get("global_latent")))).astype(
        np.float32)}
    if name == "hier_vae":
        eps[1] = rng.normal(size=(B * T // kw["chunk_len"], kw["chunk_latent"])).astype(
            np.float32)
    return x, eps


@functools.lru_cache(maxsize=None)
def _params(name):
    jcls, _, kw = _MODELS[name]
    x, _ = _inputs(name)
    return jcls(**kw, fused=False).init(jax.random.PRNGKey(1), jnp.asarray(x),
                                        lambda m, v, salt=0: m)


@functools.lru_cache(maxsize=None)
def _jax_run(name, fused, bf16):
    """(logits, mu, logvar, extra_kl) and the param grads as a state_dict."""
    jcls, _, kw = _MODELS[name]
    x, eps = _inputs(name)
    jm = jcls(**kw, fused=fused, dtype=jnp.bfloat16 if bf16 else jnp.float32, gate_bf16=bf16)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), lambda m, v, salt=0: m + jnp.exp(0.5 * v) * eps[salt])
        bce, kl = elbo_reduce_pallas(out.logits, out.target, out.mu, out.logvar,
                                     interpret=True)
        return (bce + kl + out.extra_kl) / B, (out.logits, out.mu, out.logvar, out.extra_kl)

    (_, outs), grads = jax.value_and_grad(jloss, has_aux=True)(_params(name))
    return [np.asarray(o, np.float32) for o in outs], state_dict_from_flax(_np_tree(grads))


def _port_run(name, fused, bf16):
    _, tcls, kw = _MODELS[name]
    x, eps = _inputs(name)
    tm = tcls(**kw, fused=fused, dtype=torch.bfloat16 if bf16 else torch.float32,
              gate_bf16=bf16)
    tm.load_state_dict(state_dict_from_flax(_np_tree(_params(name))))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # hier_vae: remat with fused=True
        out = tm(torch.from_numpy(x),
                 lambda m, v, salt=0: m + torch.exp(0.5 * v) * torch.from_numpy(eps[salt]))
    bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
    ((bce + kl + out.extra_kl) / B).backward()
    outs = [t.detach().float().numpy() for t in (out.logits, out.mu, out.logvar, out.extra_kl)]
    return outs, {n: p.grad.numpy() for n, p in tm.named_parameters()}


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


_OUT_NAMES = ("logits", "mu", "logvar", "extra_kl")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["pred_vae", "hier_vae"])
def test_f32_matches_jax(name, fused):
    """f32: logits, mu, logvar, extra_kl and every param grad to 5e-4, as
    tests/test_torch_models.py holds seq_vae.  fused=True puts the decoder
    through K6 (pred_vae: the decoder starts from the encoder's terminal
    state, so K6's dc0 and dh0 feed K5's backward)."""
    jouts, jgrads = _jax_run(name, fused, False)
    outs, grads = _port_run(name, fused, False)
    for what, a, b in zip(_OUT_NAMES, outs, jouts):
        _close(a, b, 5e-4, what)
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        _close(g, jgrads[n].numpy(), 5e-4, n)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["pred_vae", "hier_vae"])
def test_bf16_matches_jax(name, fused):
    """bf16 activations and gates.  The two frameworks round to bf16 at
    different points.  Forward: within 5% of each tensor's largest magnitude.
    Grads: the port in bf16 within 25% (relative L2) of the JAX bf16 grads,
    and no further from the f32 grads than max(2 x the JAX bf16 distance,
    5%) (tests/test_torch_models.py's bf16 rule)."""
    jouts, jgrads = _jax_run(name, fused, True)
    _, j32 = _jax_run(name, fused, False)
    outs, grads = _port_run(name, fused, True)
    for what, a, b in zip(_OUT_NAMES, outs, jouts):
        _close(a, b, 0.05, what)
    for n, g in grads.items():
        want, ref = jgrads[n].numpy(), j32[n].numpy()
        assert _rel(g, want) <= 0.25, (n, _rel(g, want))
        assert _rel(g, ref) <= max(2 * _rel(want, ref), 0.05), (n, _rel(g, ref), _rel(want, ref))


@pytest.mark.parametrize("name,n_leaves", [("pred_vae", 26), ("hier_vae", 52)])
def test_state_dict_from_flax_consumes_every_production_leaf(name, n_leaves):
    """The production flax trees: each leaf mapped exactly once, loading
    strictly into the port's module with matching shapes."""
    jcls = _MODELS[name][0]
    cfg = jget_config(name)
    jm = jcls(**cfg.model.kwargs, fused=False)
    x = jnp.zeros((1, 20, 64, 64), jnp.float32)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, lambda m, v, salt=0: m))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == n_leaves
    sd = state_dict_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), params))
    assert len(sd) == n_leaves
    port = build_model(get_config(name), device="cpu")
    assert set(sd) == set(port.state_dict())
    for key, t in port.state_dict().items():
        assert sd[key].shape == t.shape, key
    port.load_state_dict(sd, strict=True)
    assert sum(math.prod(leaf.shape) for _, leaf in leaves) == sum(
        p.numel() for p in port.parameters())


def test_gru_recurrent_kernels_orthogonal_at_init():
    """flax GRUCell init: orthogonal hr, hz, hn; truncated lecun_normal input
    kernels; zero biases."""
    gru = build_model(get_config("hier_vae"), device="cpu").prior_gru
    for n in ("hr", "hz", "hn"):
        w = getattr(gru, n).weight.detach()
        torch.testing.assert_close(w @ w.T, torch.eye(256), rtol=0, atol=1e-5)
    for n in ("ir", "iz", "in"):
        lin = getattr(gru, n)
        std = math.sqrt(1.0 / 64) / 0.87962566103423978
        assert float(lin.weight.abs().max()) <= 2 * std + 1e-7
        assert float(lin.bias.abs().max()) == 0.0
    assert gru.hr.bias is None and gru.hz.bias is None
    assert float(gru.hn.bias.abs().max()) == 0.0


def test_gru_cell_matches_flax():
    """Forward and grads of the port's GRUCell against flax nn.GRUCell on the
    same params, mapped by convert.state_dict_from_flax."""
    rng = np.random.default_rng(3)
    h = rng.normal(size=(5, 16)).astype(np.float32)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    cell = nn.GRUCell(features=16)
    params = cell.init(jax.random.PRNGKey(2), jnp.asarray(h), jnp.asarray(x))
    w = rng.normal(size=(5, 16)).astype(np.float32)

    def jloss(p, hh, xx):
        new, _ = cell.apply(p, hh, xx)
        return jnp.sum(new * w), new

    (_, jnew), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(h), jnp.asarray(x))
    port = GRUCell(6, 16)
    port.load_state_dict(state_dict_from_flax(_np_tree(params)), strict=True)
    th, tx = torch.from_numpy(h).requires_grad_(), torch.from_numpy(x).requires_grad_()
    new = port(th, tx)
    (new * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(new.detach().numpy(), np.asarray(jnew), rtol=1e-5, atol=1e-6)
    jsd = state_dict_from_flax(_np_tree(jg[0]))
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jsd[n].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    for got, want in ((th.grad, jg[1]), (tx.grad, jg[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_gaussian_kl_matches_jax():
    rng = np.random.default_rng(4)
    args = [rng.normal(size=(3, 5, 7)).astype(np.float32) for _ in range(4)]
    want = float(jgaussian_kl(*[jnp.asarray(a) for a in args]))
    got = gaussian_kl(*[torch.from_numpy(a) for a in args])
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-5)
    same = gaussian_kl(*[torch.from_numpy(a) for a in (args[0], args[1], args[0], args[1])])
    assert float(same) == pytest.approx(0.0, abs=1e-5)


def test_pred_vae_adam_curve_matches_jax():
    """Config-4 structure at tiny widths, 25 Adam steps from the same weights,
    frames and eps: optax.adam on the JAX model (lax.scan recurrences) and the
    port's model with fused=True (K5 and K6 plain versions) with the port's
    Adam; the loss curves agree to 5e-3 (tests/test_torch_train.py)."""
    import optax

    steps, kw = 25, _MODELS["pred_vae"][2]
    rng = np.random.default_rng(5)
    x_np = (rng.uniform(size=(steps, B, T, 32, 32)) < 0.35).astype(np.float32)
    eps_np = rng.normal(size=(steps, B, kw["latent_dim"])).astype(np.float32)
    jm = JPred(**kw, fused=False)
    params = _params("pred_vae")
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    def jloss(p, x, eps):
        out = jm.apply(p, x, lambda m, v, salt=0: m + jnp.exp(0.5 * v) * eps)
        bce, kl = jelbo(out.logits, out.target, out.mu, out.logvar)
        return (bce + kl) / B

    jgrad = jax.jit(jax.value_and_grad(jloss))
    model = PredSeqVAE(**kw, fused=True)
    model.load_state_dict(state_dict_from_flax(_np_tree(params)))
    state = create_train_state(model, jget_config("pred_vae").optim)
    jl, tl = [], []
    for s in range(steps):
        lval, grads = jgrad(params, jnp.asarray(x_np[s]), jnp.asarray(eps_np[s]))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        jl.append(float(lval))

        eps = torch.from_numpy(eps_np[s])
        state.optimizer.zero_grad()
        out = model(torch.from_numpy(x_np[s]), lambda m, v, salt=0: m + torch.exp(0.5 * v) * eps)
        bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
        loss = (bce + kl) / B
        loss.backward()
        state.optimizer.step()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    assert tl[-1] < tl[0]
