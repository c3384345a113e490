"""`train.steps_per_call` in mmvae_torch: K train steps a call
(`train.loop.chunk_steps`; one CUDA graph on a card, the K-step loop on the
CPU), the device-side seeds, draws and schedules that make a graph of
steps replay each step's own values, and the bench's FLOP count, on the CPU
at tiny widths against the JAX package where the two are compared.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.configs import get_config as jget_config
from mmvae_tpu.train.loop import fit as jfit
from mmvae_tpu.train.state import make_lr as jmake_lr

from mmvae_torch.bench.flops import flops_per_step, peak_bf16_tflops
from mmvae_torch.bench.roofline import kernel_products
from mmvae_torch.configs import get_config
from mmvae_torch.ops import preprocess_kernels, seeds
from mmvae_torch.train import loop
from mmvae_torch.train.loop import fit, kl_beta, resident_row_indices, uniform_rows
from mmvae_torch.train.state import make_lr

TINY = {
    "mlp_vae": ["model.kwargs.latent_dim=8", "model.kwargs.hidden_dim=32",
                "data.batch_size=32"],
    "seq_vae": ["model.kwargs.latent_dim=8", "data.batch_size=4", "data.seq_len=4"],
}
COMMON = ["data.num_sequences=32", "train.log_every=2", "optim.lr=3e-3",
          "model.dtype=float32", "train.eval_every=4", "train.eval_batches=2",
          "optim.ema_decay=0.9"]
NARROW = {"seq_vae": {"enc_channels": (4, 8), "lstm_features": 8}}
PATHS = {
    "uniform": ["data.device_resident=true"],
    "epochs": ["data.device_resident=true", "data.resident_epochs=true"],
    "ongen": ["data.on_device_generate=true"],
}


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny(name, *overrides):
    cfg = get_config(name, tuple(TINY[name] + COMMON + list(overrides)))
    cfg.model.kwargs.update(NARROW.get(name, {}))
    return cfg


def _tensors(state):
    out = {f"param {n}": p.detach() for n, p in state.model.named_parameters()}
    names = dict(zip(map(id, state.model.parameters()),
                     (n for n, _ in state.model.named_parameters())))
    for p, st in state.optimizer.state.items():
        out.update((f"{k} {names[id(p)]}", v) for k, v in st.items())
    out.update((f"ema {n}", e) for n, e in state.ema_params.items())
    return out


def _no_rates(history):
    return [{k: v for k, v in h.items() if "per_sec" not in k} for h in history]


# --- fit at K steps a call ------------------------------------------------------


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", list(TINY))
def test_fit_chunked_equals_one_step_a_call(name, path, tmp_path):
    """K = 2 ends bit-identical to K = 1: parameters, Adam's state, the EMA,
    the step counters and every logged line (eval included)."""
    runs = []
    for k in (1, 2):
        cfg = tiny(name, *PATHS[path], f"train.steps_per_call={k}",
                   f"train.checkpoint_dir={tmp_path / str(k)}", "train.checkpoint_every=4")
        state, history = fit(cfg, max_steps=8, device="cpu")
        runs.append((state, history))
    (one, h1), (two, h2) = runs
    assert [h["step"] for h in h2] == [2, 4, 6, 8] and _no_rates(h1) == _no_rates(h2)
    assert one.step == two.step == int(two.step_t) == 8
    a, b = _tensors(one), _tensors(two)
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def _jax_cfg(*overrides):
    cfg = jget_config("mlp_vae", tuple(TINY["mlp_vae"] + COMMON + list(overrides)))
    cfg.train.eval_every = 0
    return cfg


def test_chunked_fit_logs_the_steps_jax_logs():
    """JAX's fit and the port's at steps_per_call=2 on the same tiny
    resident config log the same steps: the chunk's last."""
    over = ("data.device_resident=true", "train.steps_per_call=2", "train.eval_every=0")
    _, jhist = jfit(_jax_cfg(*over), max_steps=6)
    _, hist = fit(tiny("mlp_vae", *over), max_steps=6, device="cpu")
    assert [h["step"] for h in hist] == [int(h["step"]) for h in jhist] == [2, 4, 6]


@pytest.mark.parametrize("case", ["streaming", "log_every", "steps"])
def test_chunked_fit_refuses_with_the_jax_message(case):
    """A streaming run and a cadence or run length that K does not divide
    raise in both packages, with the same message."""
    over = {"streaming": ("data.device_resident=false",),
            "log_every": ("data.device_resident=true", "train.log_every=3"),
            "steps": ("data.device_resident=true",)}[case]
    over = (*over, "train.steps_per_call=2", "train.eval_every=0")
    steps = 5 if case == "steps" else 6
    with pytest.raises(ValueError) as want:
        jfit(_jax_cfg(*over), max_steps=steps)
    with pytest.raises(ValueError) as got:
        fit(tiny("mlp_vae", *over), max_steps=steps, device="cpu")
    assert str(got.value) == str(want.value)


def test_chunked_resume_refuses_a_step_off_the_chunks(tmp_path):
    cfg = tiny("mlp_vae", "data.device_resident=true", f"train.checkpoint_dir={tmp_path}")
    fit(cfg, max_steps=3, device="cpu")
    cfg.train.resume, cfg.train.steps_per_call = True, 2
    with pytest.raises(ValueError, match=r"^resumed step 3 is not a multiple of "
                                         r"train.steps_per_call \(2\)$"):
        fit(cfg, max_steps=6, device="cpu")


def test_chunked_resume_equals_an_uninterrupted_run(tmp_path):
    cfg = tiny("mlp_vae", "data.device_resident=true", "train.steps_per_call=2",
               f"train.checkpoint_dir={tmp_path / 'a'}", "train.checkpoint_every=2")
    whole, _ = fit(cfg, max_steps=6, device="cpu")
    cfg.train.checkpoint_dir = str(tmp_path / "b")
    fit(cfg, max_steps=2, device="cpu")
    cfg.train.resume = True
    resumed, history = fit(cfg, max_steps=6, device="cpu")
    assert [h["step"] for h in history] == [4, 6]
    a, b = _tensors(whole), _tensors(resumed)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_debug_nans_refuses_a_chunk():
    with pytest.raises(ValueError, match="anomaly mode cannot run in a CUDA graph"):
        fit(tiny("mlp_vae", "data.device_resident=true", "train.steps_per_call=2",
                 "train.debug_nans=true"), max_steps=2, device="cpu")


def test_the_cpu_chunk_is_the_loop():
    """On the CPU the chunk calls the step K times: the state advances by K
    on the host and the device, the metrics come back stacked (K,), equal
    to K single calls'."""
    cfg = tiny("mlp_vae")
    outs = []
    for k in (1, 3):
        model = loop.build_model(cfg, "cpu")
        state = loop.create_train_state(model, cfg.optim)
        step = loop.make_train_step(model, resident_batch=8)
        data = torch.randint(0, 256, (40, 64, 64), dtype=torch.uint8,
                             generator=torch.Generator().manual_seed(0))
        if k == 1:
            ms = [step(state, data) for _ in range(3)]
            outs.append(torch.stack([m["loss"] for m in ms]))
        else:
            outs.append(loop.chunk_steps(step, 3)(state, data)["loss"])
        assert state.step == int(state.step_t) == 3
    assert outs[1].shape == (3,) and torch.equal(outs[0], outs[1])


# --- device seeds ---------------------------------------------------------------

STEPS = [0, 1, 2, 7, 1000, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1, 2**32, 2**32 + 5,
         3_000_000_000, 2**40 + 12345]


def test_device_step_seeds_equal_the_int_seeds_over_int32_wraps():
    t = torch.tensor(STEPS, dtype=torch.int64)
    assert seeds.step_seed_t(t).tolist() == [seeds.step_seed(s) for s in STEPS]
    base = seeds.step_seed_t(t)
    for rank in (0, 1, 3, 1000):
        assert seeds.shard_seed_t(base, rank).tolist() == \
            [seeds.shard_seed(seeds.step_seed(s), rank) for s in STEPS]
    for stream in (1, 2, 3, 4, 5):
        for salt in (0, 1, 2, 3000):
            want = [seeds.stream_seed(seeds.step_seed(s), stream, salt) for s in STEPS]
            assert seeds.stream_seed_t(base, stream, salt).tolist() == want
            assert [seeds.host_seed(seeds.SeedRef(b, stream, salt)) for b in base] == want


def test_kernels_take_a_device_seed_as_its_stream_seed():
    """A `SeedRef` reaches a kernel's plain version as its stream seed; its
    kernel arguments carry the step seed's tensor, stream and salt."""
    data = torch.randint(0, 256, (6, 3, 64, 64), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    idx = torch.tensor([4, 0, 2])
    step = seeds.step_seed_t(torch.tensor(9))
    ref = seeds.SeedRef(step, seeds.STREAM_PREPROCESS)
    got = preprocess_kernels.preprocess_gather(data, idx, ref)
    want = preprocess_kernels.preprocess_gather(
        data, idx, seeds.stream_seed(seeds.step_seed(9), seeds.STREAM_PREPROCESS))
    assert torch.equal(got, want)
    assert seeds.kernel_seed(ref, "cpu") == (0, step.data_ptr(), seeds.STREAM_PREPROCESS, 0)
    assert seeds.kernel_seed(-5, "cpu") == ((-5) & 0xFFFFFFFF, None, 0, 0)
    with pytest.raises(ValueError, match="one int64"):
        seeds.kernel_seed(seeds.SeedRef(step.int(), 1), "cpu")


# --- device schedules -----------------------------------------------------------

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
def test_tensor_schedules_equal_optax_in_float32(overrides):
    """The rate of an int64 step tensor, against optax's float32 schedule of
    the same count, in the same order of float32 operations: within one
    float32 spacing of the peak rate (XLA's cos and torch's may differ in
    their last bit, which 1 + cos amplifies near the end of a decay)."""
    overrides = ("optim.lr=3e-3", *overrides)
    mine = make_lr(get_config("seq_vae", overrides).optim)
    ref = jmake_lr(jget_config("seq_vae", overrides).optim)
    for n in range(40):
        got = mine(torch.tensor(n, dtype=torch.int64))
        want = np.float32(ref(n)) if callable(ref) else np.float32(ref)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=np.spacing(np.float32(3e-3)))


def test_tensor_kl_weight_equals_the_jax_steps_bit_for_bit():
    beta, warm = 0.7, 6
    for step in range(10):
        want = jnp.float32(beta) * jnp.minimum(1.0, jnp.asarray(step, jnp.int32)
                                               .astype(jnp.float32) / warm)
        got = kl_beta(torch.tensor(step), beta, warm)
        assert got.dtype == torch.float32 and float(got) == float(want)
        assert float(got) == kl_beta(step, beta, warm)
    assert kl_beta(torch.tensor(3), beta, 0) == float(jnp.float32(beta))


# --- row draws ------------------------------------------------------------------


def test_uniform_rows_are_a_pure_function_of_the_step_seed():
    n, b = 37, 4096
    seed = seeds.step_seed(11)
    rows = uniform_rows(seed, n, b, "cpu")
    assert torch.equal(rows, uniform_rows(torch.tensor(seed), n, b, "cpu"))
    assert int(rows.min()) == 0 and int(rows.max()) == n - 1
    counts = torch.bincount(rows, minlength=n).double()
    assert float(((counts - b / n) ** 2 / (b / n)).sum()) < 80  # chi^2, 36 dof
    assert not torch.equal(rows, uniform_rows(seeds.step_seed(12), n, b, "cpu"))


def test_epoch_rows_cover_every_row_once_and_decorrelate_shards():
    n, b = 23, 5  # 4 steps an epoch, 3 rows left out of each
    for shard in (0, 1):
        rows = [resident_row_indices(torch.tensor(s), n, b, 7, "cpu", shard_index=shard)
                for s in range(12)]
        for s, r in enumerate(rows):  # the device step and the host step draw alike
            assert torch.equal(r, resident_row_indices(s, n, b, 7, "cpu", shard_index=shard))
        epochs = [torch.cat(rows[e * 4:(e + 1) * 4]) for e in range(3)]
        for e in epochs:
            assert len(set(e.tolist())) == 20 and int(e.min()) >= 0 and int(e.max()) < n
        assert not torch.equal(epochs[0], epochs[1])
    big = [resident_row_indices(0, 1000, 1000, 7, "cpu", shard_index=r) for r in (0, 1)]
    assert int((big[0] == big[1]).sum()) < 10  # ~1 of 1000 agree by chance
    corr = np.corrcoef(big[0].numpy(), big[1].numpy())[0, 1]
    assert abs(corr) < 0.1


def test_ongen_draws_are_a_pure_function_of_the_seed():
    from mmvae_torch.data import ongen

    canvas = ongen.Canvas(64, 3, 64, device="cpu")
    seed = seeds.stream_seed(seeds.step_seed(4), seeds.STREAM_ONGEN)
    a, b = canvas.draw(seed, 2), canvas.draw(torch.tensor(seed), 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a.digits.min()) == 0 and int(a.digits.max()) == 9
    assert float(a.pos0.min()) >= 0 and float(a.pos0.max()) < canvas.lim
    assert float(a.speed.min()) >= 2.0 and float(a.speed.max()) < 4.5
    assert float(a.theta.min()) >= 0 and float(a.theta.max()) < 2 * math.pi
    c = canvas.draw(seed + 1, 2)
    assert not torch.equal(a.digits, c.digits)


# --- FLOPs ----------------------------------------------------------------------


def _taps(h, w):
    return (3 * h - 2) * (3 * w - 2)


def test_flops_per_step_of_mlp_vae_equals_a_hand_count():
    """Forward products once, backward twice, the first layer's weight
    gradient only (the frames need none)."""
    cfg = tiny("mlp_vae")
    b, d, h, lat = 32, 64 * 64, 32, 8
    fwd = {"enc_fc": 2 * b * d * h, "heads": 2 * 2 * b * h * lat, "dec_fc": 2 * b * lat * h,
           "dec_out": 2 * b * h * d}
    want = 2 * fwd["enc_fc"] + 3 * (fwd["heads"] + fwd["dec_fc"] + fwd["dec_out"])
    assert flops_per_step(cfg) == want


def test_flops_per_step_of_seq_vae_equals_a_hand_count():
    """Config 3's layers at tiny widths: the frame encoder's convs (the
    first without its input gradient), K5 from its shapes (the x projection
    and the hidden conv over the taps inside the image), the head, the
    decoder's init linears, its ConvLSTM's input conv and T hidden convs
    (cuDNN's: padded taps), the frame decoder's transposes and mix; remat
    off, so no recompute."""
    cfg = tiny("seq_vae")
    b, t, lat, f, tok = 4, 4, 8, 8, 16
    n, g = b * t, 16  # frames; the grid after two stride-2 convs
    enc0 = 2 * n * 4 * 32 * 32 * 1 * 16
    enc1 = 2 * n * 8 * 16 * 16 * 4 * 16
    k5 = 2 * b * t * g * g * 8 * 4 * f + 2 * b * t * _taps(g, g) * f * 4 * f
    assert k5 == kernel_products("convlstm_proj_forward", (b, t, g, g, 8, f))
    head = 2 * 2 * b * (g * g * f) * lat
    z_state = 2 * b * lat * (2 * g * g * f)
    z_token = 2 * b * lat * (g * g * tok)
    dec_in = 2 * b * 4 * f * g * g * tok * 9
    dec_h = t * 2 * b * 4 * f * g * g * f * 9
    up0 = 2 * n * 8 * 32 * 32 * 8       # 2x2 / stride 2: one tap an output pixel
    mix = 2 * n * 4 * 32 * 32 * 8 * 9
    up1 = 2 * n * 1 * 64 * 64 * 4
    want = 2 * enc0 + 3 * (enc1 + k5 + head + z_state + z_token + dec_in + dec_h + up0
                           + mix + up1)
    assert flops_per_step(cfg) == want


def test_the_peak_table_knows_the_h100s():
    assert peak_bf16_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert peak_bf16_tflops("NVIDIA H100 PCIe") == 756.0
    assert peak_bf16_tflops("NVIDIA A100-SXM4-80GB") is None
