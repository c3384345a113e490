"""One rank of a data-parallel group for tests/test_torch_dp.py and
tests/test_torch_cuda.py.  Not a pytest module.

    python tests/_torch_dp_child.py RANK WORLD INIT_FILE MODE WORKDIR [BACKEND DEVICE]

Joins a group of WORLD ranks through `file://INIT_FILE` (gloo on the CPU
unless BACKEND and DEVICE say otherwise: "gloo cuda:0", or "nccl cuda:{rank}",
where `{rank}` becomes the rank),
runs MODE and saves what the test compares to WORKDIR/MODE.rankRANK.pt.
Imports torch and the port only, so it runs on a host without jax:

- steps: the train steps of `WORKDIR/inputs.pt` (per model: its config
  overrides, the weights, u8 batches and eps, all global), each rank on its
  share with its eps injected; the averaged gradients of the first step,
  the averaged losses, the final parameters;
- fit: `fit` on the resident, streaming and on-card-generated paths (4
  steps, eval every 2, checkpoints), then 2 steps and a resume to 4, and a
  resume of a single-process checkpoint, and a resume from a directory of
  each rank's own; the rows each step consumed, the checkpoint writes of
  this rank, the histories and final states, the resume's error;
- sigterm: `fit` with no end on the streaming path, with checkpoints; the
  test sends SIGTERM to one rank.
"""

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mmvae_torch import parallel  # noqa: E402
from mmvae_torch.configs import get_config  # noqa: E402
from mmvae_torch.ops import dispatch  # noqa: E402
from mmvae_torch.train import checkpoint as ckpt  # noqa: E402
from mmvae_torch.train import loop  # noqa: E402
from mmvae_torch.train.state import create_train_state  # noqa: E402


def tensors(state) -> dict:
    """Parameters, the optimizer's moments and counts, and the EMA, by name."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {f"param {n}": p.detach().cpu().clone() for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        out.update((f"{k} {names[id(p)]}", v.detach().cpu().clone()) for k, v in st.items())
    out.update((f"ema {n}", e.detach().cpu().clone()) for n, e in (state.ema_params or {}).items())
    return out


def config(spec: dict):
    cfg = get_config(spec["name"], tuple(spec["overrides"]))
    cfg.model.kwargs.update(spec.get("kwargs", {}))
    return cfg


def run_steps(rank: int, world: int, workdir: str, device) -> dict:
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    sync = parallel.grad_sync(device)
    out = {}
    for key, spec in inputs.items():
        cfg = config(spec)
        model = loop.build_model(cfg, device)
        model.load_state_dict(spec["state_dict"])
        state = create_train_state(model, cfg.optim)
        step = loop.make_train_step(model, binarize=False, sync=sync)
        u8, eps = spec["u8"], spec["eps"]
        b = u8.shape[1] // world
        rows = slice(rank * b, (rank + 1) * b)
        noise = {}
        real = dispatch.make_sample_fn
        dispatch.make_sample_fn = lambda seed, eps=None: real(seed, noise)
        grads = []
        apply = state.apply_gradients

        def capture():
            if not grads:
                grads.append({n: p.grad.detach().cpu().clone()
                              for n, p in model.named_parameters()})
            apply()

        state.apply_gradients = capture
        losses = []
        try:
            for s in range(u8.shape[0]):
                noise.clear()
                noise.update({salt: e[s, _site_rows(e, rank, world)]
                              for salt, e in eps.items()})
                metrics = step(state, u8[s, rows].to(device))
                losses.append(float(metrics["loss"]))
        finally:
            dispatch.make_sample_fn = real
        out[key] = {"grads": grads[0], "losses": losses,
                    "params": {n: p.detach().cpu().clone() for n, p in model.named_parameters()}}
    return out


def _site_rows(e: torch.Tensor, rank: int, world: int) -> slice:
    """A rank's rows of a sampling site's eps (S, rows, L): its share of
    the global rows, which are batch-major (config 5's chunks too)."""
    n = e.shape[1] // world
    return slice(rank * n, (rank + 1) * n)


# the fit runs: mlp_vae at tiny widths, batch 32 (16 a rank)
FIT = ["model.kwargs.latent_dim=8", "model.kwargs.hidden_dim=32", "data.batch_size=32",
       "data.num_sequences=48", "train.log_every=2", "optim.lr=3e-3", "model.dtype=float32",
       "train.eval_every=2", "train.eval_batches=2", "train.checkpoint_every=2"]
FIT_PATHS = {
    "resident": ["data.device_resident=true"],
    "streaming": ["data.device_resident=false"],
    "ongen": ["data.on_device_generate=true", "optim.ema_decay=0.9"],
}


def run_fit(rank: int, world: int, workdir: str, device) -> dict:
    writes = []
    real_write = ckpt._write
    ckpt._write = lambda d, step, snap: (writes.append((d, step)), real_write(d, step, snap))
    seen = []
    real_gather = loop.dispatch.preprocess_gather

    def recording(data, idx, seed, **kw):
        if torch.is_grad_enabled():  # a train step's batch, not an eval batch's
            seen.append((data.clone() if not seen else None, data[idx].clone()))
        return real_gather(data, idx, seed, **kw)

    loop.dispatch.preprocess_gather = recording
    out = {}
    try:
        for path, overrides in FIT_PATHS.items():
            whole_dir = os.path.join(workdir, f"{path}_whole")
            cfg = get_config("mlp_vae", (*FIT, *overrides, f"train.checkpoint_dir={whole_dir}"))
            seen.clear()
            whole, history = loop.fit(cfg, max_steps=4, device=device)
            rows = [b for _, b in seen]
            split_dir = os.path.join(workdir, f"{path}_split")
            cfg = get_config("mlp_vae", (*FIT, *overrides, f"train.checkpoint_dir={split_dir}"))
            loop.fit(cfg, max_steps=2, device=device)
            cfg.train.resume = True
            resumed, resumed_history = loop.fit(cfg, max_steps=4, device=device)
            out[path] = {"history": history, "resumed_history": resumed_history,
                         "whole": tensors(whole), "resumed": tensors(resumed),
                         "resident": seen[0][0] if path == "resident" else None,
                         "batches": rows}
        # the resident path at train.steps_per_call=2 (no checkpoints): the
        # K-step loop on the CPU, which must end where one step a call does
        cfg = get_config("mlp_vae", (*FIT, *FIT_PATHS["resident"], "train.steps_per_call=2"))
        chunked, chunked_history = loop.fit(cfg, max_steps=4, device=device)
        out["chunked"] = {"history": chunked_history, "whole": tensors(chunked)}
        # a single-process checkpoint (written by the test) resumed under the group
        cfg = get_config("mlp_vae", (*FIT, *FIT_PATHS["streaming"], "train.resume=true",
                                     f"train.checkpoint_dir={os.path.join(workdir, 'single')}"))
        state, history = loop.fit(cfg, max_steps=4, device=device)
        out["single"] = {"history": history, "state": tensors(state)}
        # a resume from directories that are not shared: rank 0's holds the
        # test's step-2 checkpoint, rank 1's none
        cfg = get_config("mlp_vae", (*FIT, *FIT_PATHS["streaming"], "train.resume=true",
                                     f"train.checkpoint_dir={os.path.join(workdir, f'own{rank}')}"))
        try:
            loop.fit(cfg, max_steps=4, device=device)
            out["unshared"] = None
        except ValueError as e:
            out["unshared"] = str(e)
    finally:
        ckpt._write = real_write
        loop.dispatch.preprocess_gather = real_gather
    out["writes"] = writes
    return out


def run_sigterm(rank: int, world: int, workdir: str, device) -> dict:
    cfg = get_config("mlp_vae", (*FIT, "data.device_resident=false", "train.eval_every=0",
                                 "train.checkpoint_every=1000000000",
                                 f"train.checkpoint_dir={os.path.join(workdir, 'sigterm')}"))
    cfg.train.steps = 10 ** 9  # SIGTERM is the only way out
    print(f"rank {rank} training", flush=True)
    loop.fit(cfg, device=device)
    return {}


MODES = {"steps": run_steps, "fit": run_fit, "sigterm": run_sigterm}


def main(argv) -> int:
    rank, world, init_file, mode, workdir = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    backend, device = (argv[5], argv[6].format(rank=rank)) if len(argv) > 6 else ("gloo", "cpu")
    torch.set_num_threads(1)
    dev = parallel.init_from_env(device, backend=backend, init_method=f"file://{init_file}",
                                 rank=rank, world_size=world)
    try:
        res = MODES[mode](rank, world, workdir, dev)
        torch.save(res, os.path.join(workdir, f"{mode}.rank{rank}.pt"))
        parallel.barrier(dev)
    finally:
        parallel.shutdown()
    print(f"rank {rank}: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
