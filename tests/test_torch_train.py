"""mmvae_torch training against mmvae_tpu: an Adam loss curve with frames and
eps injected, the port's own train step on a resident u8 tensor, and the
import boundary (the port and its configs never load jax).
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mmvae_tpu.configs import get_config as jget_config
from mmvae_tpu.models.seq_vae import ConvLSTMSeqVAE as JSeqVAE
from mmvae_tpu.ops.elbo_ref import elbo_parts_ref as jelbo
from mmvae_torch import ops
from mmvae_torch.configs import get_config
from mmvae_torch.convert import state_dict_from_flax
from mmvae_torch.models.seq_vae import ConvLSTMSeqVAE
from mmvae_torch.ops.elbo_kernels import elbo_reduce
from mmvae_torch.train.loop import build_model, make_train_step
from mmvae_torch.train.state import create_train_state

REPO = Path(__file__).resolve().parents[1]
TINY = dict(latent_dim=8, enc_channels=(4, 8), lstm_features=8, enc_x_kernel=1)


@pytest.fixture(autouse=True)
def _full_precision_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def test_adam_curve_matches_jax():
    """Config-3 structure at tiny widths, trained 25 steps with optax.adam and
    with the port's module + Adam from the same weights, frames and eps;
    the loss curves agree to 5e-3 (tests/test_parity_torch.py:410-530)."""
    import optax

    B, T, steps, lr = 2, 4, 25, 1e-3
    rng = np.random.default_rng(0)
    x_np = (rng.uniform(size=(steps, B, T, 64, 64)) < 0.35).astype(np.float32)
    eps_np = rng.normal(size=(steps, B, TINY["latent_dim"])).astype(np.float32)

    jm = JSeqVAE(**TINY, fused=False)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x_np[0]), lambda m, v, salt=0: m)
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    def jloss(p, x, eps):
        out = jm.apply(p, x, lambda m, v, salt=0: m + jnp.exp(0.5 * v) * eps)
        bce, kl = jelbo(out.logits, out.target, out.mu, out.logvar)
        return (bce + kl) / B

    jgrad = jax.jit(jax.value_and_grad(jloss))

    model = ConvLSTMSeqVAE(**TINY, remat=True)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    state = create_train_state(model, jget_config("seq_vae").optim)

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


def _tiny_cfg():
    cfg = get_config("seq_vae")
    cfg.model.kwargs.update(TINY)
    cfg.data.batch_size, cfg.data.seq_len = 2, 4
    return cfg


def _run_steps(cfg, data, n):
    model = build_model(cfg, device="cpu")
    state = create_train_state(model, cfg.optim)
    step = make_train_step(model, binarize=True, resident_batch=cfg.data.batch_size)
    metrics = [{k: float(v) for k, v in step(state, data).items()} for _ in range(n)]
    return state, metrics


def test_train_step_on_resident_u8_cpu():
    """Three steps of the port's own step (gather + binarize + model + ELBO +
    Adam) on a resident u8 tensor: finite, deterministic, params move."""
    cfg = _tiny_cfg()
    data = torch.randint(0, 256, (10, 4, 64, 64), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in build_model(cfg, device="cpu").state_dict().items()}
    ops.reset_launch_counts()
    state, metrics = _run_steps(cfg, data, 3)
    assert set(ops.launch_counts().values()) == {0}  # CPU tensors: plain versions
    assert state.step == 3
    for m in metrics:
        assert all(np.isfinite(v) for v in m.values())
        assert m["loss"] == pytest.approx(m["bce"] + m["kl"], rel=1e-6)
    moved = [k for k, v in state.model.state_dict().items() if not torch.equal(v, init[k])]
    assert len(moved) == len(init)
    _, again = _run_steps(cfg, data, 3)
    assert again == metrics


def test_make_optimizer_builds_adamw_and_refuses_unknown_schedules():
    """Every optimizer option is ported: Adam by default, weight_decay makes
    AdamW (decay on every parameter), and an unknown lr_schedule raises as
    the reference's make_lr does."""
    from mmvae_torch.train.state import make_optimizer

    cfg = _tiny_cfg()
    model = build_model(cfg, device="cpu")
    assert type(make_optimizer(model.parameters(), cfg.optim)) is torch.optim.Adam
    cfg.optim.weight_decay = 1e-4
    opt = make_optimizer(model.parameters(), cfg.optim)
    assert type(opt) is torch.optim.AdamW
    assert [g["weight_decay"] for g in opt.param_groups] == [1e-4]
    assert len(opt.param_groups[0]["params"]) == len(list(model.parameters()))
    cfg.optim.lr_schedule, cfg.optim.lr_decay_steps = "exponential", 100
    with pytest.raises(ValueError, match="unknown optim.lr_schedule"):
        make_optimizer(model.parameters(), cfg.optim)


def test_bench_refuses_steps_per_call():
    """The bench runs train.steps_per_call = K steps a call: run_benchmark
    refuses bench steps that K does not divide, with the JAX bench's message
    (mmvae_tpu/bench/throughput.py:95-100), before it looks for a card; and
    setup_resident_training's step (run_benchmark's and bench.profile's) is
    the chunk, on the CPU the K-step loop, its metrics stacked (K,)."""
    from mmvae_torch.bench.throughput import run_benchmark, setup_resident_training

    cfg = get_config("seq_vae", ("train.steps_per_call=4", "data.num_sequences=8"))
    cfg.model.kwargs.update(TINY)
    cfg.data.batch_size, cfg.data.seq_len = 2, 4
    with pytest.raises(ValueError, match=r"bench steps \(10\) must be a multiple of "
                                         r"train.steps_per_call \(4\)"):
        run_benchmark(cfg, steps=10)
    state, data, step = setup_resident_training(cfg, torch.device("cpu"))
    metrics = step(state, data)
    assert state.step == int(state.step_t) == 4
    assert set(metrics) == {"loss", "bce", "kl"}
    assert all(v.shape == (4,) and bool(torch.isfinite(v).all()) for v in metrics.values())


@pytest.mark.parametrize("name", ["mlp_vae", "seq_vae"])
def test_bench_resident_set_has_the_train_splits_rows(name):
    """The bench's resident set is the train split's size: clips for a
    sequence config, every frame of them as a row for a per-frame one
    (n_clips x seq_len frames, as mmvae_tpu/bench/throughput.py packs it)."""
    from mmvae_torch.bench.throughput import resident_set

    cfg = get_config(name, ("data.num_sequences=20",))
    data = resident_set(cfg, torch.device("cpu"))
    n_clips = max(int(20 * 0.9), cfg.data.batch_size)
    want = (n_clips * 20, 64, 64) if name == "mlp_vae" else (n_clips, 20, 64, 64)
    assert data.shape == want and data.dtype == torch.uint8


def test_frames_per_step_counts_single_frames_for_a_per_frame_config():
    """The frames a step consumes, which the bench, its profile and fit's
    logger turn into frames/s: 64 single frames for config 1, 64 clips x 20
    frames for config 3."""
    from mmvae_torch.train.loop import frames_per_step

    assert frames_per_step(get_config("mlp_vae")) == 64
    assert frames_per_step(get_config("seq_vae")) == 64 * 20


def test_bench_ongen_step_generates_its_batch(monkeypatch):
    """Under data.on_device_generate the bench's step generates its clips:
    no dataset is made, every step gathers all of a fresh (B, T, 64, 64) u8
    batch through the preprocess wrapper, and two steps draw different clips."""
    from mmvae_torch.bench.throughput import setup_resident_training
    from mmvae_torch.train import loop

    cfg = get_config("seq_vae", ("data.on_device_generate=true", "data.batch_size=2",
                                 "data.seq_len=3"))
    cfg.model.kwargs.update(TINY)
    state, data, step = setup_resident_training(cfg, torch.device("cpu"))
    assert data is None
    seen = []
    real = loop.dispatch.preprocess_gather

    def recording(batch, idx, seed, **kw):
        seen.append((batch.clone(), idx.clone()))
        return real(batch, idx, seed, **kw)

    monkeypatch.setattr(loop.dispatch, "preprocess_gather", recording)
    metrics = [step(state, data) for _ in range(2)]
    assert all(np.isfinite(float(m["loss"])) for m in metrics)
    (a, ia), (b, ib) = seen
    assert a.shape == b.shape == (2, 3, 64, 64) and a.dtype == torch.uint8
    assert ia.tolist() == ib.tolist() == [0, 1]
    assert int(a.max()) > 0 and not torch.equal(a, b)


def test_build_model_defaults_to_the_card():
    """build_model puts the model on the card unless the caller names the CPU."""
    import inspect

    assert inspect.signature(build_model).parameters["device"].default == "cuda"
    cfg = _tiny_cfg()
    if torch.cuda.is_available():
        assert next(build_model(cfg).parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build_model(cfg)
    assert not next(build_model(cfg, device="cpu").parameters()).is_cuda


def test_configs_are_the_jax_packages_dataclasses():
    for name in ("seq_vae", "mlp_vae", "hier_vae"):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jget_config(name))


_SLICE = """
import json, sys, torch
from mmvae_torch.configs import get_config
from mmvae_torch.train.loop import build_model, make_train_step
from mmvae_torch.train.state import create_train_state
cfg = get_config("seq_vae")
cfg.model.kwargs.update(latent_dim=8, enc_channels=(4, 8), lstm_features=8)
cfg.data.batch_size, cfg.data.seq_len = 2, 3
model = build_model(cfg, device="cpu")
state = create_train_state(model, cfg.optim)
step = make_train_step(model, resident_batch=2)
data = torch.randint(0, 256, (4, 3, 64, 64), dtype=torch.uint8)
loss = float(step(state, data)["loss"])
print(json.dumps({"loss": loss, "loaded": [m for m in ("jax", "flax", "mmvae_tpu")
                                           if m in sys.modules]}))
"""


def test_port_never_imports_jax():
    """A fresh process that imports the port and runs its CPU slice has not
    loaded jax, flax or the mmvae_tpu package."""
    out = subprocess.run([sys.executable, "-c", _SLICE], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and np.isfinite(res["loss"])


def test_jax_configs_import_without_jax():
    """mmvae_tpu.configs is pure dataclasses: importing it does not load jax."""
    code = "import sys, mmvae_tpu.configs; print('jax' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "False"
