"""mmvae_torch's training loop: `fit`, `evaluate`, checkpoints, metrics
and the SIGTERM save, on the CPU at tiny widths, against the JAX package
where the two are compared (the CSV, `evaluate`, the checkpoint quirk).
"""

import dataclasses
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from mmvae_torch.configs import get_config
from mmvae_torch.train import checkpoint as ckpt
from mmvae_torch.train import loop
from mmvae_torch.train.loop import evaluate, fit
from mmvae_torch.train.state import create_train_state

REPO = Path(__file__).resolve().parents[1]

# CPU-sized configs: the JAX package's tests' tiny overrides (f32, 32 clips).
TINY = {
    "mlp_vae": ["model.kwargs.latent_dim=8", "model.kwargs.hidden_dim=32",
                "data.batch_size=32"],
    "conv_vae": ["model.kwargs.latent_dim=8", "data.batch_size=16"],
    "seq_vae": ["model.kwargs.latent_dim=8", "data.batch_size=4", "data.seq_len=4"],
}
COMMON = ["data.num_sequences=32", "train.log_every=2", "optim.lr=3e-3",
          "model.dtype=float32", "train.eval_every=0"]
NARROW = {"seq_vae": {"enc_channels": (4, 8), "lstm_features": 8},
          "conv_vae": {"channels": (4, 8, 8, 8)}}


@pytest.fixture(autouse=True)
def _one_thread():
    """The tiny models gain nothing from intra-op threads; one thread keeps
    these runs short when the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny(name, *overrides):
    cfg = get_config(name, tuple(TINY[name] + COMMON + list(overrides)))
    cfg.model.kwargs.update(NARROW.get(name, {}))
    return cfg


def _tensors(state):
    """Parameters, Adam's moments and step counts, and the EMA, by name."""
    out = {f"param {n}": p.detach() for n, p in state.model.named_parameters()}
    names = dict(zip(map(id, state.model.parameters()),
                     (n for n, _ in state.model.named_parameters())))
    for p, st in state.optimizer.state.items():
        out.update((f"{k} {names[id(p)]}", v) for k, v in st.items())
    for n, e in (state.ema_params or {}).items():
        out[f"ema {n}"] = e
    return out


def _assert_states_close(a, b, rtol=1e-6, atol=1e-7):
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb) and a.step == b.step
    for name in ta:
        np.testing.assert_allclose(ta[name].float().numpy(), tb[name].float().numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


RESUME_CASES = {
    "mlp_vae streaming": ("mlp_vae", ["data.device_resident=false"]),
    "seq_vae streaming": ("seq_vae", ["data.device_resident=false"]),
    "mlp_vae cosine": ("mlp_vae", ["data.device_resident=false", "optim.lr_schedule=cosine",
                                   "optim.lr_warmup_steps=1", "optim.lr_decay_steps=4",
                                   "optim.lr_end_ratio=0.1"]),
    "mlp_vae ongen ema": ("mlp_vae", ["data.on_device_generate=true", "optim.ema_decay=0.9"]),
    "conv_vae resident epochs": ("conv_vae", ["data.device_resident=true",
                                              "data.resident_epochs=true"]),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_equals_uninterrupted(case, tmp_path):
    """4 steps against 2, a checkpoint and a resume to 4: parameters, Adam's
    moments and step counts and the EMA agree to rtol 1e-6, atol 1e-7 (as
    tests/test_checkpoint.py holds the JAX package)."""
    name, overrides = RESUME_CASES[case]
    whole, _ = fit(tiny(name, *overrides), max_steps=4, device="cpu")
    cfg = tiny(name, *overrides, f"train.checkpoint_dir={tmp_path}")
    fit(cfg, max_steps=2, device="cpu")
    assert ckpt.latest_step(str(tmp_path)) == 2
    cfg.train.resume = True
    resumed, history = fit(cfg, max_steps=4, device="cpu")
    assert [h["step"] for h in history] == [4]
    _assert_states_close(whole, resumed)


def _record_batches(monkeypatch):
    seen = []
    real = loop.dispatch.preprocess_gather

    def recording(data, idx, seed, **kw):
        seen.append(data[idx].clone())
        return real(data, idx, seed, **kw)

    monkeypatch.setattr(loop.dispatch, "preprocess_gather", recording)
    return seen


@pytest.mark.parametrize("name", ["mlp_vae", "seq_vae"])
def test_resumed_stream_draws_the_batches_of_an_uninterrupted_run(name, tmp_path,
                                                                 monkeypatch):
    """The data cursor: a streaming run resumed at step 2 is fed the host
    batches 3 and 4 of an uninterrupted run, not the first two again."""
    seen = _record_batches(monkeypatch)
    fit(tiny(name, "data.device_resident=false"), max_steps=4, device="cpu")
    whole = list(seen)
    cfg = tiny(name, "data.device_resident=false", f"train.checkpoint_dir={tmp_path}")
    fit(cfg, max_steps=2, device="cpu")
    seen.clear()
    cfg.train.resume = True
    fit(cfg, max_steps=4, device="cpu")
    assert len(whole) == 4 and len(seen) == 2
    for a, b in zip(seen, whole[2:]):
        assert torch.equal(a, b)
    assert not torch.equal(seen[0], whole[0])


def _state(cfg):
    return create_train_state(loop.build_model(cfg, device="cpu"), cfg.optim)


def test_ema_restore_both_ways(tmp_path):
    """A checkpoint without an EMA restored under optim.ema_decay starts the
    EMA at the restored parameters; a checkpoint with one restored without
    ema_decay drops it (checkpoint.py:147-221 of the JAX package)."""
    plain, with_ema = tmp_path / "plain", tmp_path / "ema"
    a, _ = fit(tiny("mlp_vae", f"train.checkpoint_dir={plain}"), max_steps=2, device="cpu")
    b, _ = fit(tiny("mlp_vae", "optim.ema_decay=0.9", f"train.checkpoint_dir={with_ema}"),
               max_steps=2, device="cpu")
    state, step, data_step = ckpt.restore_latest(
        str(plain), _state(tiny("mlp_vae", "optim.ema_decay=0.9")))
    assert (step, data_step, state.step) == (2, 2, 2)
    for n, p in a.model.named_parameters():
        assert torch.equal(state.ema_params[n], p.detach())
        assert torch.equal(dict(state.model.named_parameters())[n], p)
    state, step, _ = ckpt.restore_latest(str(with_ema), _state(tiny("mlp_vae")))
    assert step == 2 and state.ema_params is None
    for n, p in b.model.named_parameters():
        assert torch.equal(dict(state.model.named_parameters())[n], p)
    again, _, _ = ckpt.restore_latest(str(with_ema),
                                      _state(tiny("mlp_vae", "optim.ema_decay=0.9")))
    for n, e in b.ema_params.items():
        assert torch.equal(again.ema_params[n], e)


def test_missing_checkpoint_and_stray_entries(tmp_path):
    """`evaluate` on a directory with no checkpoint raises FileNotFoundError;
    `latest_step` does not create the directory, and skips entries that are
    not step directories.  Divergence from the reference, decided: where a
    step entry is a file, the reference's `_ckpt_top_keys` raises
    NotADirectoryError; the port skips it."""
    from mmvae_tpu.train.checkpoint import _ckpt_top_keys

    missing = tmp_path / "nowhere"
    with pytest.raises(FileNotFoundError):
        evaluate(tiny("mlp_vae"), str(missing), device="cpu")
    assert ckpt.latest_step(str(missing)) is None and not missing.exists()
    ckdir = tmp_path / "ck"
    fit(tiny("mlp_vae", f"train.checkpoint_dir={ckdir}"), max_steps=2, device="cpu")
    (ckdir / "7").write_text("not a checkpoint")
    (ckdir / "9").mkdir()  # a step directory with no state file
    (ckdir / "notes").mkdir()
    assert ckpt.latest_step(str(ckdir)) == 2
    assert ckpt.restore_latest(str(ckdir), _state(tiny("mlp_vae")))[1] == 2
    with pytest.raises(NotADirectoryError):
        _ckpt_top_keys(str(ckdir), 7)


def test_checkpoints_keep_the_newest_three_and_write_whole(tmp_path):
    """Periodic saves every step: only the newest three step directories
    stay, and no temporary directory is left."""
    fit(tiny("mlp_vae", "train.checkpoint_every=1", f"train.checkpoint_dir={tmp_path}"),
        max_steps=5, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5"]


def test_periodic_save_holds_host_copies(tmp_path):
    """The background writer holds its own host copies: updating the state
    in place after a periodic save does not change what is written."""
    state = _state(tiny("mlp_vae"))
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    ckpt.save(str(tmp_path), state, 1, data_step=1)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    ckpt.wait_until_finished(str(tmp_path))
    got = torch.load(tmp_path / "1" / "state.pt", weights_only=True)
    assert got["step"] == 0 and got["data_step"] == 1
    for k, v in want.items():
        assert torch.equal(got["model"][k], v)


def test_csv_matches_the_jax_logger_and_appends_on_resume(tmp_path):
    """The CSV header and columns equal the JAX MetricsLogger's for the same
    values; a resumed run appends to the file, a fresh one truncates it."""
    from mmvae_tpu.train.metrics import MetricsLogger as JLogger

    from mmvae_torch.train.metrics import MetricsLogger

    vals = {"loss": 3.5, "bce": 3.0, "kl": 0.5, "val_loss": 4.0, "val_bce_ema": 2.25,
            "extra": 1.0}
    for cls, path in ((JLogger, tmp_path / "j.csv"), (MetricsLogger, tmp_path / "t.csv")):
        lg = cls(csv_path=str(path), print_fn=lambda *a: None)
        lg.log(10, vals, throughput=False)
        lg.close()
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()

    csv = tmp_path / "m.csv"
    cfg = tiny("mlp_vae", f"train.metrics_csv={csv}", f"train.checkpoint_dir={tmp_path / 'c'}")
    fit(cfg, max_steps=2, device="cpu")
    cfg.train.resume = True
    fit(cfg, max_steps=4, device="cpu")
    lines = csv.read_text().splitlines()
    assert lines[0].startswith("step,loss,bce,kl,val_loss") and len(lines) == 3
    assert [ln.split(",")[0] for ln in lines[1:]] == ["2", "4"]
    cfg.train.resume = False
    fit(cfg, max_steps=2, device="cpu")  # a fresh run in the same place truncates
    assert len(csv.read_text().splitlines()) == 2


def test_tensorboard_without_its_package_says_so(tmp_path, monkeypatch):
    from mmvae_torch.train.metrics import MetricsLogger

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="tensorboard_dir"):
        MetricsLogger(tensorboard_dir=str(tmp_path))


@pytest.mark.parametrize("override", ["train.steps_per_call=2", "train.multihost=true",
                                      "train.transfer_guard=true",
                                      "train.use_pallas=false"])
def test_refused_options(override, capsys):
    """Options the port does not run raise, naming the ROADMAP item where
    there is one.  `train.multihost`, which the port runs since data
    parallelism landed (tests/test_torch_dp.py), trains in this process
    when no torchrun environment names a group, and says so.
    `train.steps_per_call`, which the port runs since chunking landed
    (tests/test_torch_chunk.py), still refuses a streaming run (the CPU's
    default path) with the JAX package's message."""
    if override == "train.multihost=true":
        _, history = fit(tiny("mlp_vae", override), max_steps=1, device="cpu")
        assert "multihost init skipped" in capsys.readouterr().out
        assert [h["step"] for h in history] == [1]
        return
    with pytest.raises((NotImplementedError, ValueError),
                       match=override.split("=")[0].split(".")[1]) as err:
        fit(tiny("mlp_vae", override), max_steps=1, device="cpu")
    if override == "train.steps_per_call=2":
        assert "streaming mode needs one host batch per step" in str(err.value)
    elif override != "train.use_pallas=false":
        assert "ROADMAP" in str(err.value)


def test_fit_on_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit(tiny("mlp_vae"), max_steps=1)


def test_debug_nans_raises_on_an_injected_nan(monkeypatch):
    """Under train.debug_nans a NaN weight makes the first backward raise;
    without it the run goes on with a NaN loss."""
    real = loop.build_model

    def poisoned(cfg, device="cuda", generator=None):
        model = real(cfg, device, generator)
        with torch.no_grad():
            model.enc_fc.weight[0, 0] = float("nan")
        return model

    monkeypatch.setattr(loop, "build_model", poisoned)
    with pytest.raises(RuntimeError, match="nan"):
        fit(tiny("mlp_vae", "train.debug_nans=true"), max_steps=2, device="cpu")
    assert not torch.is_anomaly_enabled()
    _, history = fit(tiny("mlp_vae"), max_steps=2, device="cpu")
    assert np.isnan(history[-1]["loss"])


def test_standalone_evaluate_reproduces_the_in_training_eval(tmp_path):
    """`evaluate` on the checkpoint of step 4 scores the same val batches
    with the same seeds as the in-training eval at step 4, raw and EMA;
    use_ema leaves the caller's config as it was."""
    cfg = tiny("conv_vae", "optim.ema_decay=0.9", "train.eval_every=4", "train.eval_batches=3",
               f"train.checkpoint_dir={tmp_path}")
    _, history = fit(cfg, max_steps=4, device="cpu")
    logged = history[-1]
    raw = evaluate(cfg, str(tmp_path), max_batches=3, device="cpu")
    assert (raw["step"], raw["batches"], raw["samples"]) == (4, 3, 48)
    for k in ("val_loss", "val_bce", "val_kl"):
        assert raw[k] == pytest.approx(logged[k], rel=1e-6)
    plain = tiny("conv_vae", "train.eval_every=4")
    before = dataclasses.asdict(plain)
    ema = evaluate(plain, str(tmp_path), max_batches=3, use_ema=True, device="cpu")
    assert dataclasses.asdict(plain) == before
    for k in ("val_loss", "val_bce", "val_kl"):
        assert ema[k] == pytest.approx(logged[f"{k}_ema"], rel=1e-6)


def test_evaluate_matches_jax_evaluate():
    """The same flax parameters, converted, on the same val split with
    binarize=false: the batch and sample counts equal, val_kl to rtol 1e-5
    (mu and logvar do not depend on eps), val_bce within three times the
    spread of the JAX package's own evaluate between seeds 1 and 2 (the eps
    draws differ)."""
    import jax

    from mmvae_tpu.configs import get_config as jget_config
    from mmvae_tpu.models import MLPVAE as JMLP
    from mmvae_tpu.train.loop import evaluate as jevaluate

    from mmvae_torch.convert import state_dict_from_flax

    overrides = tuple(TINY["mlp_vae"] + COMMON + ["data.binarize=false",
                                                   "train.data_parallel=false"])
    jcfg = jget_config("mlp_vae", overrides)
    params = JMLP(**jcfg.model.kwargs).init(jax.random.PRNGKey(3), np.zeros((1, 64, 64),
                                                                          np.float32),
                                            lambda m, v, salt=0: m)
    with jax.default_matmul_precision("highest"):
        j1 = jevaluate(jcfg, params=params, seed=1)
        j2 = jevaluate(jcfg, params=params, seed=2)
    port = evaluate(get_config("mlp_vae", overrides),
                    params=state_dict_from_flax(jax.tree.map(np.asarray, params)),
                    device="cpu")
    assert (port["batches"], port["samples"]) == (j1["batches"], j1["samples"]) == (3, 80)
    assert port["val_kl"] == pytest.approx(j1["val_kl"], rel=1e-5)
    spread = abs(j1["val_bce"] - j2["val_bce"])
    assert spread > 0 and abs(port["val_bce"] - j1["val_bce"]) <= 3 * spread


_SIGTERM_CHILD = r"""
from mmvae_torch.configs import get_config
from mmvae_torch.train.loop import fit

cfg = get_config("mlp_vae", {overrides!r})
cfg.train.steps = 10**9          # never finishes: SIGTERM is the only way out
cfg.train.checkpoint_every = 10**9
fit(cfg, device="cpu")
"""


def test_sigterm_saves_the_last_whole_step(tmp_path):
    """A real SIGTERM to a training child that imports only torch and the
    port: it exits by the signal, leaving a checkpoint of a step > 0 whose
    data cursor is that step.  The test ends the child itself after 100 s."""
    overrides = tuple(TINY["mlp_vae"] + COMMON + ["data.device_resident=false",
                                                   f"train.checkpoint_dir={tmp_path}"])
    code = _SIGTERM_CHILD.format(overrides=overrides)
    proc = subprocess.Popen([sys.executable, "-u", "-c", code], cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    watchdog = threading.Timer(100.0, proc.kill)
    watchdog.start()
    log = []
    try:
        for line in proc.stdout:
            log.append(line)
            if line.startswith("step"):
                break  # training is live
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait()
        log.extend(proc.stdout)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
    assert rc == -signal.SIGTERM, "".join(log)
    assert "sigterm checkpoint failed" not in "".join(log)
    state, step, data_step = ckpt.restore_latest(str(tmp_path), _state(tiny("mlp_vae")))
    assert step > 0 and data_step == step == state.step, "".join(log)
