"""mmvae_torch's optimizer and step options against mmvae_tpu: the learning-rate
schedules, 25-step training curves under AdamW, grad clipping, EMA (with the
recipe's `fast_mid` decoder) and cosine-with-warmup, the KL warmup's
weight, and shuffled-epoch resident sampling.

The curves follow tests/test_torch_train.py::test_adam_curve_matches_jax:
config-3 structure at tiny widths, the same flax weights, frames and eps
on both sides; the JAX side is `mmvae_tpu.train.state.create_train_state`
and `TrainState.apply_gradients` from the same config.  Loss curves agree
to rtol 5e-3 and the final EMA to 2e-3 of the tree's largest magnitude;
the update rule alone, on injected gradients, agrees to 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mmvae_tpu.configs import get_config as jget_config
from mmvae_tpu.models.seq_vae import ConvLSTMSeqVAE as JSeqVAE
from mmvae_tpu.ops.elbo_ref import elbo_parts_ref as jelbo
from mmvae_tpu.train.state import create_train_state as jcreate_train_state
from mmvae_tpu.train.state import make_lr as jmake_lr
from mmvae_torch.configs import get_config
from mmvae_torch.convert import state_dict_from_flax
from mmvae_torch.models.seq_vae import ConvLSTMSeqVAE
from mmvae_torch.ops.elbo_kernels import elbo_reduce
from mmvae_torch.train import loop
from mmvae_torch.train.loop import build_model, kl_beta, make_train_step, resident_row_indices
from mmvae_torch.train.state import create_train_state, make_lr

TINY = dict(latent_dim=8, enc_channels=(4, 8), lstm_features=8, enc_x_kernel=1)
B, T, STEPS = 2, 4, 25


@pytest.fixture(autouse=True)
def _full_precision_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


# --- learning-rate schedules ----------------------------------------------

_SCHEDULES = [
    ("optim.lr_schedule=constant",),
    ("optim.lr_schedule=constant", "optim.lr_warmup_steps=7"),
    ("optim.lr_schedule=cosine", "optim.lr_decay_steps=30"),
    ("optim.lr_schedule=cosine", "optim.lr_warmup_steps=7", "optim.lr_decay_steps=30",
     "optim.lr_end_ratio=0.1"),
    ("optim.lr_schedule=linear", "optim.lr_decay_steps=30", "optim.lr_end_ratio=0.05"),
    ("optim.lr_schedule=linear", "optim.lr_warmup_steps=7", "optim.lr_decay_steps=30"),
]


@pytest.mark.parametrize("overrides", _SCHEDULES, ids=lambda o: ",".join(o))
def test_make_lr_matches_optax(overrides):
    """The rate at counts 0 .. decay + 5 against the JAX package's optax
    schedule: rtol 1e-6, and 1e-6 of the peak rate absolute (optax computes
    in float32, the port in float64: near a zero end rate the float32
    cosine's rounding is that large)."""
    overrides = ("optim.lr=3e-3", *overrides)
    cfg, jcfg = get_config("seq_vae", overrides), jget_config("seq_vae", overrides)
    mine, ref = make_lr(cfg.optim), jmake_lr(jcfg.optim)
    counts = range(cfg.optim.lr_decay_steps + 6 if cfg.optim.lr_decay_steps else 15)
    got = np.array([mine(n) for n in counts])
    want = np.array([float(ref(n)) if callable(ref) else ref for n in counts])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * cfg.optim.lr)
    if cfg.optim.lr_warmup_steps:
        assert got[0] == 0.0  # the first update runs at the count-0 rate


def test_make_lr_refuses_what_the_reference_refuses():
    """Both raise for an unknown schedule, a decay horizon <= 0 and a warmup
    that leaves the cosine no steps."""
    for field, value, match in (("lr_schedule", "step", "unknown optim.lr_schedule"),
                                ("lr_decay_steps", 0, "lr_decay_steps > 0"),
                                ("lr_warmup_steps", 40, "positive decay_steps")):
        cfg = get_config("seq_vae", ("optim.lr_schedule=cosine", "optim.lr_decay_steps=30"))
        jcfg = jget_config("seq_vae", ("optim.lr_schedule=cosine", "optim.lr_decay_steps=30"))
        setattr(cfg.optim, field, value)
        setattr(jcfg.optim, field, value)
        for fn, c in ((make_lr, cfg), (jmake_lr, jcfg)):
            with pytest.raises(ValueError, match=match):
                fn(c.optim)


# --- 25-step curves -------------------------------------------------------


def _jloss_fn(jm):
    def jloss(p, x, eps):
        out = jm.apply(p, x, lambda m, v, salt=0: m + jnp.exp(0.5 * v) * eps)
        bce, kl = jelbo(out.logits, out.target, out.mu, out.logvar)
        return (bce + kl) / B

    return jax.jit(jax.value_and_grad(jloss))


def _curves(overrides, model_kw=()):
    """Both sides trained STEPS steps under `overrides`: (torch losses, JAX
    losses, torch state, JAX state, global grad norm of the first step)."""
    kw = {**TINY, **dict(model_kw)}
    rng = np.random.default_rng(0)
    x_np = (rng.uniform(size=(STEPS, B, T, 64, 64)) < 0.35).astype(np.float32)
    eps_np = rng.normal(size=(STEPS, B, TINY["latent_dim"])).astype(np.float32)

    jcfg = jget_config("seq_vae", ("train.steps=25", *overrides))
    jm = JSeqVAE(**kw, fused=False)
    jstate = jcreate_train_state(jm, jcfg.optim, jax.random.PRNGKey(0), (B, T, 64, 64))
    model = ConvLSTMSeqVAE(**kw, remat=True)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, jstate.params)))
    state = create_train_state(model, get_config("seq_vae", ("train.steps=25", *overrides)).optim)

    jgrad, japply = _jloss_fn(jm), jax.jit(lambda s, g: s.apply_gradients(g))
    jl, tl, norm0 = [], [], None
    for s in range(STEPS):
        lval, grads = jgrad(jstate.params, jnp.asarray(x_np[s]), jnp.asarray(eps_np[s]))
        jstate = japply(jstate, grads)
        jl.append(float(lval))

        eps = torch.from_numpy(eps_np[s])
        state.optimizer.zero_grad()
        out = model(torch.from_numpy(x_np[s]), lambda m, v, salt=0: m + torch.exp(0.5 * v) * eps)
        bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
        loss = (bce + kl) / B
        loss.backward()
        if norm0 is None:
            norm0 = float(torch.linalg.vector_norm(torch.stack(
                [p.grad.norm() for p in model.parameters()])))
        state.apply_gradients()
        tl.append(float(loss.detach()))
    assert state.step == int(jstate.step) == STEPS
    return tl, jl, state, jstate, norm0


def _tree_close(got, want_tree, tol, what):
    """Every tensor of `got` within tol x the largest magnitude of the whole
    reference tree."""
    want = state_dict_from_flax(jax.tree.map(np.asarray, want_tree))
    assert set(got) == set(want)
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(), rtol=tol,
                                   atol=tol * scale, err_msg=f"{what} {name}")


_OPTIONS = {
    "adamw": ("optim.weight_decay=5.0",),
    "clip": ("optim.grad_clip=1.0",),
    "ema": ("optim.ema_decay=0.9",),
    "cosine_warmup": ("optim.lr_schedule=cosine", "optim.lr_warmup_steps=5",
                      "optim.lr=3e-3"),
}


@pytest.mark.parametrize("option", list(_OPTIONS))
def test_curve_matches_jax(option):
    """Losses to rtol 5e-3; under EMA (with the recipe's fast_mid decoder)
    the final EMA to 2e-3 of the tree's largest magnitude.  The final live
    parameters are not compared: Adam turns the float noise of gradients
    near zero into whole steps (plain Adam moves z_to_state's weights 0.3 %
    of the tree's scale apart over these 25 steps), which the EMA averages."""
    model_kw = {"dec_upsample": "fast_mid"} if option == "ema" else {}
    tl, jl, state, jstate, norm0 = _curves(_OPTIONS[option], model_kw)
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    assert tl[-1] < tl[0]
    if option == "adamw":
        assert isinstance(state.optimizer, torch.optim.AdamW)
    if option == "clip":
        assert norm0 > 1.0  # the clip fired on the first step
    if option == "ema":
        _tree_close(state.ema_params, jstate.ema_params, 2e-3, "ema")
        live = dict(state.model.named_parameters())
        assert all(not torch.equal(e, live[n]) for n, e in state.ema_params.items())
    else:
        assert state.ema_params is None and jstate.ema_params is None


class _Params(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.p = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in tree.items()})


@pytest.mark.parametrize("option", [*_OPTIONS, "all"])
def test_update_matches_optax(option):
    """The update rule alone, on injected gradients: 12 updates of a small
    tree by `TrainState.apply_gradients` against the reference's
    `make_optimizer` and `TrainState.apply_gradients` (clip, Adam / AdamW at
    the scheduled rate, EMA, in optax's order), parameters and EMA to 1e-5
    of the tree's largest magnitude.  The clip's max norm sits between the
    gradients' norms, so it fires on some steps and not on others."""
    from mmvae_tpu.train.state import TrainState as JTrainState
    from mmvae_tpu.train.state import make_optimizer as jmake_optimizer

    overrides = [o for k, v in _OPTIONS.items() if option in (k, "all") for o in v]
    overrides = [o.replace("grad_clip=1.0", "grad_clip=2.5") for o in overrides]
    overrides = ("train.steps=12", "optim.lr=0.05", *overrides)
    jcfg, cfg = jget_config("seq_vae", overrides), get_config("seq_vae", overrides)
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * rng.uniform(0.2, 1.5)).astype(np.float32)
              for k, v in tree.items()} for _ in range(12)]
    tx = jmake_optimizer(jcfg.optim)
    params = jax.tree.map(jnp.asarray, tree)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         tx=tx, apply_fn=None,
                         ema_params=jax.tree.map(jnp.copy, params)
                         if jcfg.optim.ema_decay else None,
                         ema_decay=float(jcfg.optim.ema_decay))
    module = _Params(tree)
    state = create_train_state(module, cfg.optim)
    norms = []
    for g in grads:
        jstate = jstate.apply_gradients(jax.tree.map(jnp.asarray, g))
        for k, p in module.p.items():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(float(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))))
        state.apply_gradients()

    def as_torch_names(t):
        return {f"p.{k}": v for k, v in jax.tree.map(np.asarray, t).items()}

    for got, want in ((dict(module.named_parameters()), jstate.params),
                      (state.ema_params, jstate.ema_params)):
        if want is None:
            assert got is None
            continue
        want = as_torch_names(want)
        scale = max(float(np.abs(w).max()) for w in want.values())
        for name, t in got.items():
            np.testing.assert_allclose(t.detach().numpy(), want[name], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=name)
    if cfg.optim.grad_clip:
        assert min(norms) < cfg.optim.grad_clip < max(norms)


# --- KL warmup ------------------------------------------------------------


def test_kl_warmup_weight_and_scaled_loss(monkeypatch):
    """beta_t against the JAX step's float32 expression, bit for bit; and the
    step's loss is (bce + beta_t kl) / B with that weight."""
    beta, warm = 0.7, 6
    for step in range(10):
        want = jnp.float32(beta) * jnp.minimum(1.0, jnp.asarray(step, jnp.int32)
                                               .astype(jnp.float32) / warm)
        assert kl_beta(step, beta, warm) == float(want)
    assert kl_beta(3, beta, 0) == float(jnp.float32(beta))

    seen = []
    real = loop.make_loss_fn

    def recording(model, **kw):
        fn = real(model, **kw)

        def wrapped(data, idx, seed, beta_t):
            loss, metrics = fn(data, idx, seed, beta_t)
            seen.append((beta_t, float(loss.detach()), float(metrics["bce"]), float(metrics["kl"])))
            return loss, metrics

        return wrapped

    monkeypatch.setattr(loop, "make_loss_fn", recording)
    cfg = get_config("seq_vae")
    cfg.model.kwargs.update(TINY)
    cfg.data.batch_size, cfg.data.seq_len = 2, 4
    model = build_model(cfg, device="cpu")
    state = create_train_state(model, cfg.optim)
    step = make_train_step(model, resident_batch=2, beta=beta, kl_warmup_steps=warm)
    data = torch.randint(0, 256, (6, 4, 64, 64), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))
    for _ in range(8):
        step(state, data)
    assert [s[0] for s in seen] == [kl_beta(n, beta, warm) for n in range(8)]
    assert seen[0][0] == 0.0
    for beta_t, loss, bce, kl in seen:
        want = (np.float32(bce) + np.float32(beta_t) * np.float32(kl))
        np.testing.assert_allclose(loss, want, rtol=1e-6)


# --- shuffled-epoch resident sampling ----------------------------------------


def test_resident_row_indices_epochs():
    n, b = 23, 5  # 4 steps an epoch, 3 rows left out of each
    rows = [resident_row_indices(s, n, b, 7, "cpu") for s in range(12)]
    epochs = [torch.cat(rows[e * 4:(e + 1) * 4]) for e in range(3)]
    for e in epochs:
        assert len(set(e.tolist())) == 20 and int(e.min()) >= 0 and int(e.max()) < n
    assert not torch.equal(epochs[0], epochs[1]) and not torch.equal(epochs[1], epochs[2])
    # a restart at any step draws the same rows
    for s in (0, 5, 11):
        assert torch.equal(resident_row_indices(s, n, b, 7, "cpu"), rows[s])
    assert not torch.equal(resident_row_indices(5, n, b, 8, "cpu"), rows[5])
    with pytest.raises(ValueError, match="n_rows"):
        resident_row_indices(0, 4, 5, 0, "cpu")


def test_train_step_under_resident_epochs_covers_every_row(monkeypatch):
    """The step takes its rows from `resident_row_indices` under
    resident_epochs: one epoch of steps gathers every row once."""
    cfg = get_config("seq_vae")
    cfg.model.kwargs.update(TINY)
    model = build_model(cfg, device="cpu")
    state = create_train_state(model, cfg.optim)
    gathered = []
    real = loop.dispatch.preprocess_gather

    def recording(data, idx, seed, **kw):
        gathered.append(idx.clone())
        return real(data, idx, seed, **kw)

    monkeypatch.setattr(loop.dispatch, "preprocess_gather", recording)
    step = make_train_step(model, resident_batch=2, resident_epochs=True, resident_seed=3)
    data = torch.randint(0, 256, (6, 2, 64, 64), dtype=torch.uint8)
    for _ in range(3):
        step(state, data)
    assert sorted(torch.cat(gathered).tolist()) == list(range(6))
