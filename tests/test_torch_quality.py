"""The trained-quality protocols of mmvae_torch (`mmvae_torch.bench.quality`).

Each protocol's config equals the JAX package's under the same overrides;
the reference numbers it holds are what its statistic computes from the
reference's CSVs in docs/assets; `run` trains a tiny protocol on the CPU
at K = 10 and writes a CSV that `compare` reads; `compare` holds a band;
the entry point refuses to run without a card unless told the CPU.
"""

import csv
import dataclasses
import json
import math
import os

import pytest
import torch

from mmvae_torch.bench import quality
from mmvae_tpu.configs import get_config as jget_config

# the JAX tests' tiny widths (tests/test_train_smoke.py), as overrides
_TINY_SEQ = ("model.kwargs.latent_dim=8", "data.batch_size=4", "data.seq_len=4",
             "data.num_sequences=32", "model.dtype=float32", "model.kwargs.enc_channels=4,8",
             "model.kwargs.lstm_features=8", "train.log_every=10", "train.eval_every=10",
             "train.eval_batches=2", "train.checkpoint_every=10",
             # resident on the CPU too (the card's default for the split): K = 10
             "data.device_resident=true")
_TINY = {"seq_vae_default": _TINY_SEQ,
         "pred_vae_ongen": _TINY_SEQ + ("model.kwargs.context_len=2", "model.kwargs.unroll=2")}


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", sorted(quality.PROTOCOLS))
def test_protocol_config_equals_the_reference(name):
    p = quality.PROTOCOLS[name]
    ours = quality.protocol_config(name)
    theirs = jget_config(p.config, quality.protocol_overrides(name))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.train.steps, ours.train.log_every, ours.train.eval_every,
            ours.train.eval_batches, ours.train.steps_per_call) == (p.steps, p.log_every,
                                                                    1000, 4, 10)
    # K divides every cadence, so fit accepts the protocol
    for cadence in (p.steps, p.log_every, ours.train.eval_every, ours.train.checkpoint_every):
        assert cadence % ours.train.steps_per_call == 0


_CSV_NUMBERS = [(name, n) for name, p in sorted(quality.PROTOCOLS.items()) if p.reference_csv
                for n in (*p.held, *p.printed)]


@pytest.mark.parametrize("name,number", _CSV_NUMBERS,
                         ids=[f"{name}-{n.label}" for name, n in _CSV_NUMBERS])
def test_reference_numbers_are_the_csvs(name, number):
    path = os.path.join(quality.REFERENCE_DIR, quality.PROTOCOLS[name].reference_csv)
    rows = quality.read_rows(path)
    assert round(quality.statistic(rows, number), 1) == pytest.approx(number.ref, abs=1e-9)
    # a mean averages the CSV's rows of the window: its cadence is the protocol's
    window = [r for r in rows if number.lo < int(r["step"]) <= number.hi]
    assert len(window) == (number.hi - number.lo) // quality.PROTOCOLS[name].log_every or \
        number.hi - number.lo == 1


def test_the_held_constants():
    held = {(name, n.label): n.ref for name, p in quality.PROTOCOLS.items() for n in p.held}
    assert held[("seq_vae_default", "loss mean over (19000, 20000]")] == 3317.9
    assert held[("seq_vae_default", "val_loss at 20000")] == 4812.3
    assert held[("recipe", "val_loss_ema at 20000")] == 3039.5
    assert held[("pred_vae_ongen", "val_loss at 20000")] == 1828.2
    assert held[("hier_vae_ongen_ema", "val_loss_ema at 10000")] == 17801.3
    assert held[("mlp_vae", "val_loss at 20000")] == 249.11
    assert held[("conv_vae", "val_loss at 20000")] == 166.78
    bands = {name: {n.band for n in p.held} for name, p in quality.PROTOCOLS.items()}
    assert bands.pop("hier_vae_ongen_ema") == {0.05}
    assert all(b == {0.03} for b in bands.values())


@pytest.mark.parametrize("name", sorted(_TINY))
def test_run_writes_the_reference_columns(name, tmp_path):
    res = quality.run(name, steps=20, out=str(tmp_path), device="cpu",
                      overrides=_TINY[name], print_fn=lambda *a: None)
    assert res["steps_per_call"] == 10 and res["device"] == "cpu"
    assert res["losses_finite"] and res["fit_frames_per_sec"] > 0
    with open(tmp_path / "metrics.csv", newline="") as f:
        header = next(csv.reader(f))
    ref = os.path.join(quality.REFERENCE_DIR, quality.PROTOCOLS[name].reference_csv)
    with open(ref, newline="") as f:
        ref_header = next(csv.reader(f))
    assert set(ref_header) <= set(header)
    number = quality.at("val_loss", 20, 1.0, "test")
    got = quality.compare(str(tmp_path / "metrics.csv"), ref, [number], print_fn=lambda *a: None)
    assert got["numbers"][0]["port"] == pytest.approx(
        float(quality.read_rows(str(tmp_path / "metrics.csv"))[-1]["val_loss"]))
    fid = res["fidelity"]
    assert fid["mode"] == quality.PROTOCOLS[name].fidelity
    assert 0 < fid["bce_per_pixel"] and 0 < fid["base_rate_bce_per_pixel"] < 1
    assert (tmp_path / "result.json").exists()


def _write(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["step", "loss", "val_loss"])
        w.writeheader()
        w.writerows(rows)
    return str(path)


@pytest.mark.parametrize("gap,ok", [(0.02, True), (-0.02, True), (0.04, False), (-0.04, False)])
def test_compare_holds_the_band(tmp_path, gap, ok):
    ref_rows = [{"step": s, "loss": 100.0 + s / 100, "val_loss": 200.0 if s % 1000 == 0 else ""}
                for s in range(200, 4001, 200)]
    port_rows = [{"step": r["step"], "loss": r["loss"] * (1 + gap),
                  "val_loss": r["val_loss"] and r["val_loss"] * (1 + gap)} for r in ref_rows]
    numbers = [quality.mean("loss", 3000, 4000, 136.0, "test", 0.03),
               quality.at("val_loss", 4000, 200.0, "test", 0.03),
               quality.at("val_loss", 2000, 200.0, "test")]
    lines = []
    got = quality.compare(_write(tmp_path / "port.csv", port_rows),
                          _write(tmp_path / "ref.csv", ref_rows), numbers, print_fn=lines.append)
    assert got["ok"] is ok
    assert [r.get("pass") for r in got["numbers"]] == [ok, ok, None]
    assert got["numbers"][0]["port"] == pytest.approx(136.0 * (1 + gap))
    assert all(r["gap"] == pytest.approx(gap) for r in got["numbers"])
    # the curve every 2,000 steps, port beside reference
    assert [r["step"] for r in got["curve"]] == [2000, 4000]
    assert got["curve"][1]["ref_val_loss"] == 200.0
    assert got["curve"][1]["val_loss"] == pytest.approx(200.0 * (1 + gap))
    assert sum("curve step" in line for line in lines) == 2


def test_a_number_past_the_run_is_not_reached(tmp_path):
    path = _write(tmp_path / "port.csv", [{"step": 1000, "loss": 1.0, "val_loss": 2.0}])
    got = quality.compare(path, None, [quality.at("val_loss", 2000, 2.0, "test", 0.03)],
                          print_fn=lambda *a: None)
    assert got["numbers"][0]["port"] is None and got["numbers"][0]["pass"] is False
    assert not got["ok"] and got["curve"] == []


def test_the_entry_point_needs_a_card_unless_told_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quality.main(["--protocol", "mlp_vae", "--steps", "10", "--out", str(tmp_path)])


def test_compare_runs_holds_the_mean(tmp_path):
    """Two seeds at -4 % and +6 %: each outside a 3 % band, their mean (+1 %)
    inside it; the runs' values are kept beside the mean."""
    paths = [_write(tmp_path / f"run{i}.csv", [{"step": 2000, "loss": 100.0 * f,
                                                  "val_loss": 200.0 * f}])
             for i, f in enumerate((0.96, 1.06))]
    number = quality.at("val_loss", 2000, 200.0, "test", 0.03)
    got = quality.compare_runs(paths, [number], print_fn=lambda *a: None)
    row = got["numbers"][0]
    assert got["ok"] and row["pass"] and row["port"] == pytest.approx(202.0)
    assert row["runs"] == pytest.approx([192.0, 212.0])
    alone = quality.compare(paths[1], None, [number], print_fn=lambda *a: None)
    assert not alone["ok"]
    cut = _write(tmp_path / "cut.csv", [{"step": 1000, "loss": 1.0, "val_loss": 200.0}])
    assert not quality.compare_runs([paths[0], cut], [number], print_fn=lambda *a: None)["ok"]


def test_the_runs_option_trains_nothing(tmp_path, capsys):
    for i, f in enumerate((0.99, 1.01)):
        (tmp_path / f"s{i}").mkdir()
        _write(tmp_path / f"s{i}" / "metrics.csv",
               [{"step": 1000, "loss": 1.0, "val_loss": 1.0},
                {"step": 2000, "loss": 5724.5 * f, "val_loss": 5990.1 * f}])
    rc = quality.main(["--protocol", "seq_vae_default", "--runs", str(tmp_path / "s0"),
                       str(tmp_path / "s1")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the 20k numbers are past the runs' end: only the printed 2k ones
    assert rc == 0 and [n["label"] for n in out["numbers"]] == ["val_loss at 2000",
                                                                  "loss at 2000"]
    assert out["numbers"][0]["port"] == pytest.approx(5990.1)


def test_the_plain_route_runs_at_one_step_a_call(tmp_path):
    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import kernel_checks

    before = ck.proj_forward_cuda
    with kernel_checks.plain_route():
        assert ck.proj_forward_cuda is ck.proj_forward_plain
    assert ck.proj_forward_cuda is before
    res = quality.run("seq_vae_default", steps=20, out=str(tmp_path), device="cpu",
                      overrides=_TINY_SEQ, route="plain", print_fn=lambda *a: None)
    assert res["route"] == "plain" and res["steps_per_call"] == 1 and res["losses_finite"]
    with pytest.raises(ValueError, match="route"):
        quality.run("seq_vae_default", steps=20, out=str(tmp_path), device="cpu",
                    overrides=_TINY_SEQ, route="triton")


def test_the_row_draws_of_a_long_run_are_uniform_and_uncorrelated():
    """Config 3's resident rows over 5,000 steps (`ops.seeds.bits32`): each
    of the 9,000 train clips drawn as often as a uniform draw with
    replacement draws it (Poisson counts), duplicates within a batch and
    rows shared by consecutive steps at their expected rates."""
    import numpy as np

    from mmvae_torch.ops.seeds import step_seed
    from mmvae_torch.train.loop import uniform_rows

    n, b, steps = 9000, 64, 5000
    rows = np.stack([uniform_rows(step_seed(s), n, b, "cpu").numpy() for s in range(steps)])
    counts = np.bincount(rows.ravel(), minlength=n)
    mean = steps * b / n
    assert counts.mean() == pytest.approx(mean)
    assert counts.var() == pytest.approx(mean, rel=0.1)   # Poisson: var = mean
    assert (counts == 0).sum() <= 2 * n * np.exp(-mean)
    dups = np.mean([b - len(set(r)) for r in rows])
    assert dups == pytest.approx(b * (b - 1) / 2 / n, rel=0.15)
    for lag in (1, 2, 10):
        shared = np.mean([len(set(rows[s]) & set(rows[s + lag])) for s in range(steps - lag)])
        assert shared == pytest.approx(b * b / n, rel=0.15), lag


@pytest.mark.parametrize("overrides", [(), ("model.kwargs.dec_upsample=fast_mid",)],
                         ids=["default", "fast_mid"])
def test_full_width_init_matches_flax_per_parameter(overrides):
    """The port's init of config 3 at full width (`build_model`'s flax-style
    init from torch's generator) against flax's init of the JAX model: each
    weight's mean and standard deviation within its sampling error, every
    bias zero.  The draws differ (torch's generator, not threefry); the
    distributions do not."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mmvae_torch.configs import get_config
    from mmvae_torch.convert import state_dict_from_flax
    from mmvae_torch.train.loop import build_model
    from mmvae_tpu.models import MODEL_REGISTRY as JAX_MODELS

    jcfg = jget_config("seq_vae", overrides)
    jm = JAX_MODELS["seq_vae"](**jcfg.model.kwargs, fused=False, dtype=jnp.float32)
    params = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 2, 64, 64)),
                                       lambda m, v, salt=0: m))(jax.random.PRNGKey(0))
    theirs = state_dict_from_flax(jax.tree.map(np.asarray, params))
    ours = build_model(get_config("seq_vae", overrides), device="cpu").state_dict()
    assert set(ours) == set(theirs)
    for name, t in ours.items():
        a, b = theirs[name].double(), t.double()
        if name.endswith("bias"):
            assert not a.any() and not b.any(), name
            continue
        tol = 4.0 / math.sqrt(2 * b.numel())  # ~4 sampling errors of a std
        assert b.std().item() == pytest.approx(a.std().item(), rel=tol + 0.01), name
        assert abs(b.mean().item() - a.mean().item()) <= 4 * a.std().item() / math.sqrt(
            b.numel()), name


def test_run_starts_from_the_jax_init(tmp_path):
    """`--init`: the JAX package's init of a tiny config at train.seed 3
    (`tests/_jax_init.py`, as its `fit` draws it), written as a .npz, is
    what the run starts from: at a zero rate the trained parameters are it,
    and they differ from the port's own init of that seed."""
    import numpy as np

    from _jax_init import jax_init
    from mmvae_torch.train import checkpoint as ckpt
    from mmvae_torch.train.loop import build_model
    from mmvae_torch.train.state import create_train_state

    tiny = ("model.kwargs.hidden_dim=32", "model.kwargs.latent_dim=8", "data.batch_size=32",
            "data.num_sequences=32", "train.log_every=10", "train.eval_every=10",
            "train.eval_batches=2", "train.checkpoint_every=10", "data.device_resident=true",
            "optim.lr=0.0")
    theirs = jax_init("mlp_vae", tiny, seed=3)
    path = tmp_path / "seed3.npz"
    np.savez(path, **theirs)
    res = quality.run("mlp_vae", seed=3, steps=10, out=str(tmp_path / "run"), device="cpu",
                      overrides=tiny, init=str(path), print_fn=lambda *a: None)
    assert res["init"] == str(path) and res["losses_finite"]
    cfg = quality.protocol_config("mlp_vae", tiny + ("train.seed=3",))
    seeded = create_train_state(build_model(cfg, device="cpu"), cfg.optim)
    ours = {k: v.clone() for k, v in seeded.model.state_dict().items()}
    trained, step, _ = ckpt.restore_latest(str(tmp_path / "run" / "ckpt"), seeded)
    assert step == 10 and set(ours) == set(theirs)
    for k, v in trained.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    assert any(not np.array_equal(ours[k].numpy(), theirs[k]) for k in theirs)
