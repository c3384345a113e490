"""`python -m mmvae_torch` on the CPU (`--device cpu`): sample in its three
modes from checkpoints the port's `fit` wrote, the missing-checkpoint exit
and `--allow-init`, `--ema` leaving the caller's config as it was, `eval`'s
JSON line against `evaluate`, `bench` without a card, an unknown config,
`--help` in a subprocess, `utils.profiling.trace` and the bench's profiled
window with `vs_baseline` null.
"""

import argparse
import contextlib
import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmvae_torch import cli
from mmvae_torch.configs import get_config
from mmvae_torch.data.loader import load_or_generate
from mmvae_torch.data.transforms import normalize
from mmvae_torch.sample import generate as gen
from mmvae_torch.train import checkpoint as ckpt
from mmvae_torch.train.loop import build_model, evaluate, fit
from mmvae_torch.train.state import create_train_state
from mmvae_tpu.configs import get_config as jget_config

REPO = Path(__file__).resolve().parents[1]
MLP = ("model.kwargs.latent_dim=8", "model.kwargs.hidden_dim=32", "data.batch_size=32",
       "data.num_sequences=32", "model.dtype=float32", "train.log_every=5")
PRED = ("model.kwargs.latent_dim=8", "model.kwargs.context_len=2",
        "model.kwargs.enc_channels=4,8", "model.kwargs.lstm_features=8",
        "data.batch_size=4", "data.seq_len=4", "data.num_sequences=16", "model.dtype=float32",
        "train.log_every=2")


def _argv(cmd, name, overrides, *rest):
    argv = [cmd, "--config", name, "--device", "cpu", *rest]
    for ov in overrides:
        argv += ["--set", ov]
    return argv


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{name: checkpoint dir} of a few CPU `fit` steps of tiny mlp_vae and
    pred_vae."""
    root = tmp_path_factory.mktemp("ck")
    out = {}
    for name, overrides, steps in (("mlp_vae", MLP, 5), ("pred_vae", PRED, 2)):
        cfg = get_config(name, overrides)
        cfg.train.checkpoint_dir = str(root / name)
        fit(cfg, max_steps=steps, device="cpu")
        out[name] = cfg.train.checkpoint_dir
    return out


def _sample_args(ckpt_dir, mode, batch, **kw):
    return argparse.Namespace(ckpt=ckpt_dir, mode=mode, batch=batch, seed=kw.get("seed", 0),
                              ema=kw.get("ema", False), allow_init=False, device="cpu")


def test_sample_modes_write_their_files(ckpts, tmp_path):
    """prior and reconstruct on mlp_vae (PNG grids), rollout on pred_vae (a
    GIF), each exit 0 from the checkpoint `fit` wrote."""
    from PIL import Image

    for mode in ("prior", "reconstruct"):
        out = tmp_path / f"{mode}.png"
        assert cli.main(_argv("sample", "mlp_vae", MLP, "--ckpt", ckpts["mlp_vae"], "--mode",
                              mode, "--out", str(out), "--batch", "4")) == 0
        assert Image.open(out).size == (128, 128)  # 2x2 grid of 64x64
    gif = tmp_path / "roll.gif"
    assert cli.main(_argv("sample", "pred_vae", PRED, "--ckpt", ckpts["pred_vae"], "--mode",
                          "rollout", "--out", str(gif), "--batch", "2")) == 0
    anim = Image.open(gif)
    assert anim.n_frames == 2 and anim.size == (128, 64)  # 2 future frames, batch tiled


@pytest.mark.parametrize("mode", ["prior", "reconstruct", "rollout"])
def test_sample_frames_equal_the_generate_api(ckpts, mode):
    """What `sample` writes is the generate API's result on the restored
    weights: the clips turned into frames by the preprocess kernel's u8/255
    mode equal `normalize`."""
    name, overrides = ("mlp_vae", MLP) if mode != "rollout" else ("pred_vae", PRED)
    cfg = get_config(name, overrides)
    got = cli.sample_frames(cfg, _sample_args(ckpts[name], mode, 3, seed=4))
    model = build_model(cfg, "cpu")
    ckpt.restore_latest(ckpts[name], create_train_state(model, cfg.optim))
    if mode == "prior":
        want = gen.prior_sample(model, 4, 3)
    else:
        ds = load_or_generate(cfg.data.path, num_sequences=4, seq_len=cfg.data.seq_len,
                              seed=cfg.data.seed + 1, train_fraction=0.0, train=False)
        clips = normalize(torch.from_numpy(ds.data[:3]))
        if mode == "reconstruct":
            want = gen.reconstruct(model, clips[:, 0], 4)
        else:
            want = gen.rollout(model, clips[:, :2], cfg.data.seq_len - 2, 4)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_missing_checkpoint_exits_2_and_allow_init_samples(tmp_path, capsys):
    out = tmp_path / "s.png"
    missing = tmp_path / "nonexistent"
    argv = _argv("sample", "mlp_vae", MLP, "--ckpt", str(missing), "--out", str(out),
                 "--batch", "2")
    assert cli.main(argv) == 2
    captured = capsys.readouterr()
    assert "error" in captured.err and "no checkpoint" in captured.err
    assert not out.exists() and not missing.exists()
    assert cli.main(argv + ["--allow-init"]) == 0
    assert out.exists() and not missing.exists()
    assert "using init params" in capsys.readouterr().err


def test_eval_of_a_missing_checkpoint_exits_2(tmp_path, capsys):
    assert cli.main(_argv("eval", "mlp_vae", MLP, "--ckpt", str(tmp_path / "none"))) == 2
    assert "error" in capsys.readouterr().err


def test_ema_leaves_the_config_as_it_was(ckpts, tmp_path):
    """--ema on an EMA-less config: `sample_frames`, `evaluate` and the CLI
    leave optim.ema_decay unset on the caller's config, and a pre-EMA
    checkpoint's EMA is its parameters."""
    cfg = get_config("mlp_vae", MLP)
    before = copy.deepcopy(cfg)
    ema = cli.sample_frames(cfg, _sample_args(ckpts["mlp_vae"], "prior", 2, ema=True))
    assert cfg == before and cfg.optim.ema_decay == 0.0
    raw = cli.sample_frames(cfg, _sample_args(ckpts["mlp_vae"], "prior", 2))
    np.testing.assert_array_equal(ema, raw)
    res = evaluate(cfg, ckpts["mlp_vae"], use_ema=True, device="cpu")
    assert np.isfinite(res["val_loss"]) and cfg == before
    assert cli.main(_argv("sample", "mlp_vae", MLP, "--ckpt", ckpts["mlp_vae"], "--ema",
                          "--out", str(tmp_path / "ema.png"), "--batch", "2")) == 0
    assert cli.main(_argv("eval", "mlp_vae", MLP, "--ckpt", ckpts["mlp_vae"], "--ema")) == 0


def test_eval_json_equals_evaluate(ckpts, capsys):
    capsys.readouterr()
    assert cli.main(_argv("eval", "mlp_vae", MLP, "--ckpt", ckpts["mlp_vae"], "--batches",
                          "2", "--seed", "3")) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    want = evaluate(get_config("mlp_vae", MLP), ckpts["mlp_vae"], max_batches=2, seed=3,
                    device="cpu")
    assert json.loads(line) == want
    assert want["step"] == 5 and want["batches"] == 2


def test_train_steps_and_the_card_default(tmp_path):
    """`train --steps` trains that many steps on the device it names; with
    no --device it runs on the card, and without one says why."""
    ck = tmp_path / "ck"
    assert cli.main(_argv("train", "mlp_vae", MLP, "--steps", "3", "--set",
                          f"train.checkpoint_dir={ck}")) == 0
    assert ckpt.latest_step(str(ck)) == 3
    if not torch.cuda.is_available():
        argv = _argv("train", "mlp_vae", MLP, "--steps", "1")
        argv.remove("--device")
        argv.remove("cpu")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)


def test_unknown_config_gives_the_jax_clis_message():
    with pytest.raises(KeyError) as want:
        jget_config("nope")
    with pytest.raises(KeyError) as got:
        cli.main(["eval", "--config", "nope", "--ckpt", "x", "--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "unknown config 'nope'; available" in str(got.value)


def _module(*args):
    return subprocess.run([sys.executable, "-m", "mmvae_torch", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_module_help():
    out = _module("--help")
    assert out.returncode == 0, out.stderr
    for cmd in ("train", "eval", "sample", "bench"):
        assert cmd in out.stdout


def test_bench_without_a_card_exits_nonzero_with_its_message():
    if torch.cuda.is_available():
        pytest.skip("checks the message on a machine without a card")
    out = _module("bench", "--config", "mlp_vae", "--steps", "2", "--warmup", "1")
    assert out.returncode != 0
    assert "run_benchmark measures a CUDA device; none is available" in out.stderr


def test_profiling_trace_writes_a_trace_on_the_cpu(tmp_path):
    from mmvae_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path)) as prof:
        with annotate("sample_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    path = Path(prof.trace_path)
    assert path.parent == tmp_path and path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "sample_region" in names


def test_bench_profiled_window_and_vs_baseline(monkeypatch, tmp_path):
    """`run_benchmark` with `profile_dir` on a CPU-safe path (the card's
    calls stubbed): one traced window of min(steps, 20) steps after the
    warmup and outside the three timed windows, and `vs_baseline` null (the
    JAX bench divides by a rate set for a TPU)."""
    from mmvae_torch.bench import throughput
    from mmvae_torch.utils import profiling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    real_trace = profiling.trace

    @contextlib.contextmanager
    def cpu_trace(logdir):  # the CPU's activity only: this torch traces no card
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: False)
            with real_trace(logdir) as prof:
                yield prof

    monkeypatch.setattr(profiling, "trace", cpu_trace)
    cfg = get_config("mlp_vae", MLP)
    res = throughput.run_benchmark(cfg, steps=2, warmup=1, device="cpu",
                                   profile_dir=str(tmp_path / "prof"))
    assert "vs_baseline" in res and res["vs_baseline"] is None
    assert not hasattr(throughput, "NORTH_STAR_FRAMES_PER_SEC")
    assert len(res["losses"]) == 1 + 2 + 3 * 2
    assert Path(res["trace"]).exists() and Path(res["trace"]).parent == tmp_path / "prof"
