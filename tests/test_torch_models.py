"""mmvae_torch models against mmvae_tpu: the param bridge, init, and the whole
ConvLSTMSeqVAE forward and gradients.

The JAX side runs with fused=True at widths where its encoder really takes
the proj-fused Pallas kernel (K5, interpret mode): image_size=32,
enc_channels=(8, 128), enc_x_kernel=1.  The same flax params go into the
port through `convert.state_dict_from_flax`; frames and eps are injected.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mmvae_tpu.configs import get_config as jget_config
from mmvae_tpu.models.seq_vae import ConvLSTMSeqVAE as JSeqVAE
from mmvae_tpu.ops.elbo_pallas import elbo_reduce_pallas
from mmvae_torch.configs import get_config
from mmvae_torch.convert import state_dict_from_flax
from mmvae_torch.models.seq_vae import ConvLSTMSeqVAE
from mmvae_torch.ops.elbo_kernels import elbo_reduce
from mmvae_torch.train.loop import build_model

B, T = 2, 4
TINY = dict(latent_dim=8, enc_channels=(8, 128), lstm_features=8, image_size=32,
            enc_x_kernel=1)


@pytest.fixture(autouse=True)
def _full_precision_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_state_dict_from_flax_consumes_every_seq_vae_leaf():
    """The production seq_vae tree: 28 leaves, each mapped exactly once,
    loading strictly into the port's module with matching shapes."""
    cfg = jget_config("seq_vae")
    jm = JSeqVAE(**cfg.model.kwargs, fused=False)
    x = jnp.zeros((1, 2, 64, 64), jnp.float32)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, lambda m, v, salt=0: m))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == 28
    fake = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), params)
    sd = state_dict_from_flax(fake)
    assert len(sd) == 28
    port = build_model(get_config("seq_vae"), device="cpu")
    assert set(sd) == set(port.state_dict())
    for name, t in port.state_dict().items():
        assert sd[name].shape == t.shape, name
    port.load_state_dict(sd, strict=True)
    n_jax = sum(math.prod(leaf.shape) for _, leaf in leaves)
    assert n_jax == sum(p.numel() for p in port.parameters())


def test_flax_style_init():
    """Truncated lecun_normal weights (|w| <= 2 std, std ~ sqrt(1/fan_in) with
    the truncation correction) and zero biases."""
    port = build_model(get_config("seq_vae"), device="cpu")
    w = port.enc_lstm.step.hidden.weight.detach()  # HWIO (3, 3, 128, 512)
    std = math.sqrt(1.0 / (9 * 128)) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) / (std * 0.87962566103423978) - 1) < 0.02
    for name, p in port.named_parameters():
        if name.endswith("bias"):
            assert float(p.detach().abs().max()) == 0.0, name


def _run_pair(dtype_j, dtype_t, gate_bf16, remat):
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(B, T, 32, 32)) < 0.35).astype(np.float32)
    eps = rng.normal(size=(B, TINY["latent_dim"])).astype(np.float32)

    jm = JSeqVAE(**TINY, fused=True, dtype=dtype_j, gate_bf16=gate_bf16)
    params = JSeqVAE(**TINY, fused=False).init(
        jax.random.PRNGKey(1), jnp.asarray(x), lambda m, v, salt=0: m
    )

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), lambda m, v, salt=0: m + jnp.exp(0.5 * v) * eps)
        bce, kl = elbo_reduce_pallas(out.logits, out.target, out.mu, out.logvar,
                                     interpret=True)
        return (bce + kl) / B, (out.logits, out.mu, out.logvar)

    (_, (jl, jmu, jlv)), jg = jax.value_and_grad(jloss, has_aux=True)(params)

    tm = ConvLSTMSeqVAE(**TINY, dtype=dtype_t, gate_bf16=gate_bf16, remat=remat)
    tm.load_state_dict(state_dict_from_flax(_np_tree(params)))
    tx = torch.from_numpy(x)
    out = tm(tx, lambda m, v, salt=0: m + torch.exp(0.5 * v) * torch.from_numpy(eps))
    bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
    ((bce + kl) / B).backward()
    jgrads = state_dict_from_flax(_np_tree(jg))
    return (out.logits, out.mu, out.logvar), (jl, jmu, jlv), tm, jgrads


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def f32_pair():
    return _run_pair(jnp.float32, torch.float32, False, remat=True)


def test_seq_vae_f32_matches_jax_fused(f32_pair):
    """f32: logits, mu, logvar and every param grad; 5e-4 as
    tests/test_convlstm_fused.py::test_seq_vae_fused_end_to_end.  Both sides
    take the ELBO kernels' VJP (d logits = sigmoid(l) - x exactly)."""
    outs, jouts, tm, jgrads = f32_pair
    for name, a, b in zip(("logits", "mu", "logvar"), outs, jouts):
        _close(a, b, 5e-4, name)
    assert set(jgrads) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        _close(p.grad, jgrads[name].numpy(), 5e-4, name)


def test_seq_vae_bf16_matches_jax_fused(f32_pair):
    """bf16 activations and gates (the production dtypes).  The two
    frameworks round to bf16 at different points through ~10 layers.
    Forward: within 5% of each tensor's largest magnitude.  Grads: the port
    in bf16 lies within 25% (relative L2) of the JAX bf16 grads, and no
    further from the f32 grads than max(2 x the JAX bf16 distance, 5%)."""
    outs, jouts, tm, jgrads = _run_pair(jnp.bfloat16, torch.bfloat16, True, remat=False)
    _, _, _, j32 = f32_pair
    for name, a, b in zip(("logits", "mu", "logvar"), outs, jouts):
        _close(a, b, 0.05, name)
    for name, p in tm.named_parameters():
        got, want, ref = p.grad.numpy(), jgrads[name].numpy(), j32[name].numpy()
        assert _rel(got, want) <= 0.25, (name, _rel(got, want))
        assert _rel(got, ref) <= max(2 * _rel(want, ref), 0.05), (
            name, _rel(got, ref), _rel(want, ref))
