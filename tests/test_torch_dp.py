"""Data parallelism of the port (`mmvae_torch.parallel`) on the CPU: two gloo
ranks (processes of `tests/_torch_dp_child.py`, joined through a `file://`
store under the test's directory, so no port is shared between the suite's
workers) against the port's single-process step and the JAX package's
`shard_map` + `pmean` step on 2 of the 8 fake CPU devices, with the same
flax weights (through `convert.py`), frames and eps.

- the ranks' averaged gradients equal the single-process full-batch ones
  (rel L2 <= 1e-5, f32) and JAX's pmean'd ones (5e-4 of each tensor's
  largest magnitude, the repo's f32 tolerance); three data-parallel Adam
  steps follow JAX's data-parallel loss curve; the parameters are
  bit-identical across the ranks;
- the ranks' step seeds are JAX's `seed + idx * 1000003`, their rows the
  JAX loader's per-process shards;
- `fit` under two ranks on the resident, streaming and generated paths:
  equal metrics on both ranks, checkpoints from rank 0 alone, a resume
  equal to an uninterrupted run, a single-process checkpoint resumed by the
  group, a resume from directories the ranks do not share refused, the
  group's checkpoint read by single-process `evaluate` and `sample`;
  SIGTERM to one rank stops both after the same step, saved;
- `torchrun --nproc_per_node 2 -m mmvae_torch train --device cpu`;
- world size 1 (no group) trains as `train.data_parallel=false` does;
  torchrun's environment with `train.data_parallel=false` is refused.
"""

import os
import re
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mmvae_tpu.configs import get_config as jget_config
from mmvae_tpu.data import loader as jloader
from mmvae_tpu.models import MODEL_REGISTRY as JREGISTRY
from mmvae_tpu.ops.elbo_ref import elbo_parts_ref as jelbo
from mmvae_torch import cli
from mmvae_torch.configs import get_config
from mmvae_torch.convert import state_dict_from_flax
from mmvae_torch.ops import dispatch
from mmvae_torch.ops.seeds import shard_seed, step_seed
from mmvae_torch.train import checkpoint as ckpt
from mmvae_torch.train import loop

REPO = Path(__file__).resolve().parents[1]
CHILD = REPO / "tests" / "_torch_dp_child.py"
sys.path.insert(0, str(REPO / "tests"))
from _torch_dp_child import FIT, FIT_PATHS  # noqa: E402

B = 4  # the global batch of the step checks: 2 a rank
# (config overrides, model kwargs, steps) of the step checks, at tiny widths in f32
STEP_MODELS = {
    "mlp_vae": (["model.kwargs.latent_dim=8", "model.kwargs.hidden_dim=32",
                 "model.dtype=float32"], {}, 1),
    "seq_vae": (["model.kwargs.latent_dim=8", "data.seq_len=4", "model.dtype=float32"],
                {"enc_channels": (4, 8), "lstm_features": 8, "enc_x_kernel": 1,
                 "gate_bf16": False, "unroll": 1}, 3),
}


@pytest.fixture(autouse=True)
def _full_precision():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_num_threads(before)


def _spawn(mode: str, workdir: Path, *extra, timeout: float = 240.0):
    """Run MODE in two ranks; returns ([rank 0's results, rank 1's], outputs)."""
    procs = [subprocess.Popen([sys.executable, str(CHILD), str(r), "2",
                               str(workdir / f"init_{mode}"), mode, str(workdir), *extra],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return [torch.load(workdir / f"{mode}.rank{r}.pt", weights_only=False) for r in range(2)], outs


def _configs(name):
    overrides, kwargs, _ = STEP_MODELS[name]
    cfg, jcfg = get_config(name, tuple(overrides)), jget_config(name, tuple(overrides))
    cfg.model.kwargs.update(kwargs)
    jcfg.model.kwargs.update(kwargs)
    return cfg, jcfg


def _inputs(name, rng):
    """Global u8 batches (S, B, ...) and eps (S, B, L) of a model's steps."""
    cfg, _ = _configs(name)
    steps = STEP_MODELS[name][2]
    shape = (B, 64, 64) if cfg.data.per_frame else (B, cfg.data.seq_len, 64, 64)
    u8 = rng.integers(0, 256, (steps, *shape), dtype=np.uint8)
    eps = rng.normal(size=(steps, B, cfg.model.kwargs["latent_dim"])).astype(np.float32)
    return u8, eps


def _jax_dp(name, params, u8, eps):
    """JAX's data-parallel run on 2 fake devices: per-shard loss and grads
    with the shard's eps injected, pmean'd, then optax.adam.  Returns (the
    first step's grads, the pmean'd losses)."""
    import optax

    _, jcfg = _configs(name)
    jm = JREGISTRY[name](**jcfg.model.kwargs)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))

    def shard_loss(p, x, e):
        out = jm.apply(p, x, lambda m, v, salt=0: m + jnp.exp(0.5 * v) * e)
        bce, kl = jelbo(out.logits, out.target, out.mu, out.logvar)
        return (bce + kl + out.extra_kl) / out.mu.shape[0]

    def shard_step(p, x, e):
        loss, g = jax.value_and_grad(shard_loss)(p, x, e)
        return jax.lax.pmean(loss, "data"), jax.lax.pmean(g, "data")

    step = jax.jit(jax.shard_map(shard_step, mesh=mesh, in_specs=(P(), P("data"), P("data")),
                                 out_specs=(P(), P()), check_vma=False))
    tx = optax.adam(jcfg.optim.lr)
    opt_state = tx.init(params)
    first, losses = None, []
    for s in range(u8.shape[0]):
        x = jnp.asarray(u8[s].astype(np.float32) * np.float32(1.0 / 255.0))
        loss, g = step(params, x, jnp.asarray(eps[s]))
        first = first if first is not None else g
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return state_dict_from_flax(jax.tree.map(np.asarray, first)), losses


def _full_batch_grads(name, state_dict, u8, eps, monkeypatch):
    """The port's single-process step on the whole batch (eps injected):
    the gradients its update sees."""
    cfg, _ = _configs(name)
    model = loop.build_model(cfg, "cpu")
    model.load_state_dict(state_dict)
    state = loop.create_train_state(model, cfg.optim)
    real = dispatch.make_sample_fn
    monkeypatch.setattr(dispatch, "make_sample_fn",
                        lambda seed, e=None: real(seed, {0: torch.from_numpy(eps[0])}))
    seen = {}
    state.apply_gradients = lambda: seen.update(
        (n, p.grad.clone()) for n, p in model.named_parameters())
    loop.make_train_step(model, binarize=False)(state, torch.from_numpy(u8[0]))
    return seen


@pytest.fixture(scope="module")
def steps_run(tmp_path_factory):
    """Inputs, JAX's run, and the two ranks' run of every step model."""
    workdir = tmp_path_factory.mktemp("dp_steps")
    rng = np.random.default_rng(0)
    inputs, jax_runs = {}, {}
    for name in STEP_MODELS:
        cfg, jcfg = _configs(name)
        u8, eps = _inputs(name, rng)
        jm = JREGISTRY[name](**jcfg.model.kwargs)
        params = jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(1),
                                                    jnp.asarray(u8[0], jnp.float32), _mean)
        # Off flax's zero biases: behind a ReLU they make logits of exactly
        # 0, where the JAX BCE's max / abs form has the gradient -x, not 1/2 - x.
        params = jax.tree.map(
            lambda w: w + np.float32(0.01) * rng.normal(size=w.shape).astype(np.float32), params)
        sd = state_dict_from_flax(jax.tree.map(np.asarray, params))
        inputs[name] = {"name": name, "overrides": STEP_MODELS[name][0],
                        "kwargs": STEP_MODELS[name][1], "state_dict": sd,
                        "u8": torch.from_numpy(u8), "eps": {0: torch.from_numpy(eps)}}
        with jax.default_matmul_precision("highest"):
            jax_runs[name] = _jax_dp(name, params, u8, eps)
    torch.save(inputs, workdir / "inputs.pt")
    ranks, _ = _spawn("steps", workdir)
    return inputs, jax_runs, ranks


def _mean(mu, logvar, salt=0):
    return mu


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("name", list(STEP_MODELS))
def test_averaged_grads_equal_full_batch_and_jax_pmean(name, steps_run, monkeypatch):
    inputs, jax_runs, ranks = steps_run
    spec = inputs[name]
    dp = ranks[0][name]["grads"]
    full = _full_batch_grads(name, spec["state_dict"], spec["u8"].numpy(),
                             spec["eps"][0].numpy(), monkeypatch)
    jgrads, _ = jax_runs[name]
    assert set(dp) == set(full) == set(jgrads)
    for n in dp:
        assert torch.equal(dp[n], ranks[1][name]["grads"][n]), n
        assert _rel_l2(dp[n], full[n]) <= 1e-5, (n, _rel_l2(dp[n], full[n]))
        want = jgrads[n].numpy()
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(dp[n].numpy(), want, rtol=5e-4, atol=5e-4 * scale, err_msg=n)


def test_three_dp_adam_steps_follow_jax_and_keep_ranks_identical(steps_run):
    _, jax_runs, ranks = steps_run
    port = ranks[0]["seq_vae"]
    np.testing.assert_allclose(port["losses"], jax_runs["seq_vae"][1], rtol=5e-4)
    assert port["losses"] == ranks[1]["seq_vae"]["losses"]
    for n, p in port["params"].items():
        assert torch.equal(p, ranks[1]["seq_vae"]["params"][n]), n


@pytest.mark.parametrize("rank", [0, 1, 5, 1000])
def test_shard_seed_is_the_jax_steps(rank):
    for step in (0, 1, 7, 123456, 2 ** 31 - 5):
        base = jnp.int32(step) * jnp.int32(1103515245) + jnp.int32(12345)
        want = int(base + jnp.int32(rank) * jnp.int32(1000003))
        assert shard_seed(step_seed(step), rank) == want
    assert shard_seed(step_seed(3), 0) == step_seed(3)


@pytest.fixture(scope="module")
def fit_run(tmp_path_factory):
    """A single-process checkpoint of 2 steps, then the two ranks' fit runs."""
    workdir = tmp_path_factory.mktemp("dp_fit")
    torch.set_num_threads(1)
    single = get_config("mlp_vae", (*FIT, *FIT_PATHS["streaming"],
                                    f"train.checkpoint_dir={workdir / 'single'}"))
    loop.fit(single, max_steps=2, device="cpu")
    single.train.checkpoint_dir = str(workdir / "own0")
    loop.fit(single, max_steps=2, device="cpu")
    ranks, _ = _spawn("fit", workdir)
    return workdir, ranks


@pytest.mark.parametrize("path", list(FIT_PATHS))
def test_fit_under_two_ranks(path, fit_run):
    """Both ranks log the same averaged metrics, val metrics included; the
    final states are bit-identical across the ranks; 2 steps and a resume
    to 4 end bit-identical to 4 steps at once."""
    _, ranks = fit_run
    hist = [r[path]["history"] for r in ranks]
    assert [h["step"] for h in hist[0]] == [2, 4]
    assert [{k: v for k, v in h.items() if "per_sec" not in k} for h in hist[0]] == \
        [{k: v for k, v in h.items() if "per_sec" not in k} for h in hist[1]]
    assert all(np.isfinite(h["val_loss"]) for h in hist[0])
    if path == "ongen":
        assert all(np.isfinite(h["val_loss_ema"]) for h in hist[0])
    for r in ranks:
        whole, resumed = r[path]["whole"], r[path]["resumed"]
        assert set(whole) == set(resumed)
        for k in whole:
            assert torch.equal(whole[k], resumed[k]), k
            assert torch.equal(whole[k], ranks[0][path]["whole"][k]), k
    assert [h["step"] for h in ranks[0][path]["resumed_history"]] == [4]


def test_fit_chunked_under_two_ranks_equals_one_step_a_call(fit_run):
    """`train.steps_per_call=2` under two gloo ranks (the K-step loop on the
    CPU) logs what one step a call logs, and ends bit-identical to it on
    both ranks."""
    _, ranks = fit_run
    for r in ranks:
        got, want = r["chunked"], r["resident"]
        assert [h["step"] for h in got["history"]] == [2, 4]
        assert [{k: v for k, v in h.items() if "per_sec" not in k} for h in got["history"]] \
            == [{k: v for k, v in h.items() if "per_sec" not in k} for h in want["history"]]
        assert set(got["whole"]) == set(want["whole"])
        for k in want["whole"]:
            assert torch.equal(got["whole"][k], want["whole"][k]), k


def test_rank_zero_alone_writes_the_checkpoints(fit_run):
    workdir, ranks = fit_run
    assert ranks[1]["writes"] == []
    assert sorted(ranks[0]["writes"]) == sorted(
        [(str(workdir / f"{p}_{run}"), s) for p in FIT_PATHS for run in ("whole", "split")
         for s in (2, 4)] + [(str(workdir / "single"), 4)])


@pytest.mark.parametrize("rank", [0, 1])
def test_each_rank_trains_on_the_jax_loaders_process_shard(rank, fit_run):
    """Resident: the rank's rows are the JAX loader's train split for
    process `rank` of 2.  Streaming: its batches are that loader's
    frame_batches(batch // 2, seed) in order."""
    _, ranks = fit_run
    cfg = get_config("mlp_vae", tuple(FIT))
    jds = jloader.load_or_generate(None, num_sequences=cfg.data.num_sequences,
                                   seq_len=cfg.data.seq_len, num_digits=cfg.data.num_digits,
                                   seed=cfg.data.seed, train_fraction=cfg.data.train_fraction,
                                   process_index=rank, process_count=2)
    resident = ranks[rank]["resident"]["resident"]
    np.testing.assert_array_equal(resident.numpy(), jds.split_data.reshape(-1, 64, 64))
    want = jds.frame_batches(cfg.data.batch_size // 2, seed=cfg.data.seed)
    for got, w in zip(ranks[rank]["streaming"]["batches"], want):
        np.testing.assert_array_equal(got.numpy(), w)
    assert len(ranks[rank]["streaming"]["batches"]) == 4


def test_a_single_process_checkpoint_resumes_under_two_ranks(fit_run):
    _, ranks = fit_run
    for r in ranks:
        assert [h["step"] for h in r["single"]["history"]] == [4]
        assert r["single"]["state"]["step " + "enc_fc.weight"] == 4
    for k, v in ranks[0]["single"]["state"].items():
        assert torch.equal(v, ranks[1]["single"]["state"][k]), k


def test_a_resume_from_unshared_directories_raises_on_every_rank(fit_run):
    """Rank 0's directory holds step 2, rank 1's nothing (each node its own
    disk): both ranks refuse to train instead of running different step
    counts into a collective that never completes."""
    _, ranks = fit_run
    for r in ranks:
        assert r["unshared"] is not None and "steps 0..2" in r["unshared"], r["unshared"]
        assert "shared by every node" in r["unshared"]


def test_torchruns_environment_without_data_parallel_is_refused(monkeypatch):
    """Under torchrun's environment of 2 ranks, `train.data_parallel=false`
    would have each process train alone into one checkpoint directory:
    `fit` refuses before it joins a group.  Outside a group the process's
    rank is torchrun's RANK, so only rank 0 prints the CLI's result."""
    from mmvae_torch import parallel

    env = {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = get_config("mlp_vae", (*FIT, "train.data_parallel=false"))
    with pytest.raises(ValueError, match="data_parallel=false under 2 ranks"):
        loop.fit(cfg, max_steps=1, device="cpu")
    assert parallel.rank() == 1 and not cli._lead()
    monkeypatch.setenv("RANK", "0")
    assert parallel.rank() == 0 and cli._lead()


def test_the_groups_checkpoint_serves_single_process_evaluate_and_sample(fit_run, capsys):
    workdir, ranks = fit_run
    cfg = get_config("mlp_vae", tuple(FIT))
    res = loop.evaluate(cfg, str(workdir / "resident_whole"), device="cpu")
    assert res["step"] == 4 and np.isfinite(res["val_loss"])
    out = workdir / "samples.png"
    rc = cli.main(["sample", "--config", "mlp_vae", "--device", "cpu", "--ckpt",
                   str(workdir / "resident_whole"), "--out", str(out), "--batch", "4",
                   *(a for o in FIT for a in ("--set", o))])
    assert rc == 0 and out.exists()
    state = loop.create_train_state(loop.build_model(cfg, "cpu"), cfg.optim)
    _, step, _ = ckpt.restore_latest(str(workdir / "resident_whole"), state)
    assert step == 4
    for n, p in state.model.named_parameters():
        assert torch.equal(p.detach(), ranks[0]["resident"]["whole"][f"param {n}"]), n


def test_evaluate_counts_every_val_row_once():
    """The port's `evaluate` is one process, so the JAX quirk of a batch
    not rounded to the mesh (mmvae_tpu/train/loop.py:428) cannot arise:
    a batch that does not divide the val split still scores every row
    once, the short tail by its size."""
    cfg = get_config("mlp_vae", (*FIT, "data.batch_size=32"))
    res = loop.evaluate(cfg, params={n: p.detach() for n, p in
                                     loop.build_model(cfg, "cpu").named_parameters()},
                        device="cpu")
    val = jloader.load_or_generate(None, num_sequences=cfg.data.num_sequences,
                                   seq_len=cfg.data.seq_len, seed=cfg.data.seed,
                                   train_fraction=cfg.data.train_fraction, train=False)
    rows = val.split_data.shape[0] * val.split_data.shape[1]
    assert rows % 32 and res["samples"] == rows and res["batches"] == -(-rows // 32)


def test_sigterm_to_one_rank_stops_both_after_the_same_step(tmp_path):
    """SIGTERM to rank 1 (not the writer) while both train: both stop after
    the same step, exit by the signal, and that step is on disk, its data
    cursor the step.  The test ends the ranks itself after 120 s."""
    procs = [subprocess.Popen([sys.executable, "-u", str(CHILD), str(r), "2",
                               str(tmp_path / "init"), "sigterm", str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    watchdogs = [threading.Timer(120.0, p.kill) for p in procs]
    for w in watchdogs:
        w.start()
    logs = [[], []]
    try:
        for line in procs[0].stdout:
            logs[0].append(line)
            if line.startswith("step"):
                break  # both ranks are past a collective step
        procs[1].send_signal(signal.SIGTERM)
        rcs = [p.wait() for p in procs]
        logs[0].extend(procs[0].stdout)
        logs[1].extend(procs[1].stdout)
    finally:
        for w in watchdogs:
            w.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
    text = ["".join(log) for log in logs]
    assert rcs == [-signal.SIGTERM, -signal.SIGTERM], text
    stops = [re.findall(r"SIGTERM: saving step (\d+)", t) for t in text]
    assert len(stops[0]) == 1 and stops[0] == stops[1], text
    step = int(stops[0][0])
    cfg = get_config("mlp_vae", tuple(FIT))
    state = loop.create_train_state(loop.build_model(cfg, "cpu"), cfg.optim)
    _, saved, data_step = ckpt.restore_latest(str(tmp_path / "sigterm"), state)
    assert saved == data_step == step > 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_torchrun_trains_two_ranks_from_the_cli(tmp_path):
    """`torchrun --nproc_per_node 2 -m mmvae_torch train --device cpu`: the
    group comes from torchrun's environment (gloo), rank 0 alone logs, and
    the checkpoint of the last step is written once."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    sets = [a for o in FIT for a in ("--set", o)]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(_free_port()), "-m",
           "mmvae_torch", "train", "--config", "mlp_vae", "--device", "cpu", "--steps", "4",
           *sets, "--set", f"train.checkpoint_dir={tmp_path}"]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert [ln.split()[1] for ln in lines] == ["2", "4"], out.stdout
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_world_size_one_is_the_single_card_step():
    """No group: `train.data_parallel=true` (the default) trains bit for bit
    as `false`, and the shard-0 rows and seeds are the single-card ones."""
    runs = []
    for dp in ("true", "false"):
        cfg = get_config("mlp_vae", (*FIT, "train.eval_every=0", f"train.data_parallel={dp}"))
        state, history = loop.fit(cfg, max_steps=4, device="cpu")
        runs.append(({n: p.detach().clone() for n, p in state.model.named_parameters()},
                     [h["loss"] for h in history]))
    assert runs[0][1] == runs[1][1]
    for n, p in runs[0][0].items():
        assert torch.equal(p, runs[1][0][n]), n
    a = loop.resident_row_indices(5, 40, 8, 3, "cpu")
    assert torch.equal(a, loop.resident_row_indices(5, 40, 8, 3, "cpu", shard_index=0))
    assert not torch.equal(a, loop.resident_row_indices(5, 40, 8, 3, "cpu", shard_index=1))


_BUILD_CHILD = r"""
import sys, time
from pathlib import Path
from mmvae_torch.ops import _build

_build.BUILD_DIR = Path(sys.argv[1])


def compile_(out, flags):
    print("compiled", flush=True)
    time.sleep(1.0)
    out.write_bytes(b"library")
    return ""


_build._compile = compile_
_build.KernelLibrary = lambda path, seconds, log: path
print("loaded", _build.library().name, flush=True)
"""


def test_ranks_starting_together_build_the_kernels_once(tmp_path):
    """Three processes asking for the kernel library at once (nvcc stood in
    by a compile of 1 s): the directory's lock lets one build and the
    others load its library."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert sum(o.count("compiled") for o in outs) == 1, outs
    names = {o.split("loaded ")[1].strip() for o in outs}
    assert len(names) == 1 and (tmp_path / names.pop()).exists()


def test_a_bench_rank_keeps_its_rows_of_the_resident_set():
    from mmvae_torch.bench import throughput
    from mmvae_torch.parallel import GradSync

    cfg = get_config("mlp_vae", tuple(FIT))
    whole = throughput.resident_set(cfg, torch.device("cpu"))
    _, data, _ = throughput.setup_resident_training(cfg, torch.device("cpu"),
                                                    GradSync(1, 2, "cpu"))
    assert torch.equal(data, whole[1::2])
