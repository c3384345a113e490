"""Training throughput: frames/s/GPU (port of mmvae_tpu/bench/throughput.py).

Real train steps (forward, backward, the optimizer) on the data path the
config names: a u8 dataset resident on the card at the config's production
size, each step gathering its batch there, or with `data.on_device_generate`
clips generated on the card every step (`data.ongen`) and no dataset.
Warmup is left out; three timed windows of `steps` steps, each ended by
`torch.cuda.synchronize()`; frames/s is reported as the median window with
min, max and spread.  Under `train.steps_per_call` = K every call runs K
steps (`train.loop.chunk_steps`: one CUDA graph replay; its capture happens
in the warmup), and `steps` must be a multiple of K, as in the JAX bench.
Same JSON keys as the JAX bench.  `flops_per_step` is the model FLOPs of
one train step of the global batch (`bench.flops.flops_per_step`: the
forward's products once, the backward's as autograd computes them, remat's
recompute not counted), counted once a run off the timed windows;
`tflops_per_sec_chip` is that over the median window's step time a card;
`mfu` divides it by the card's dense bf16 peak (989 TFLOP/s for the H100
SXM, 756 for the PCIe card, null for a card not listed), the JAX bench's
convention, applied to the f32 configs too; `card` is the card's name and
power limit (nvidia-smi), since a card set below its 700 W runs slower.
JAX's MFU is not comparable: XLA counts a scan body once and counts
remat.  `vs_baseline` is null: the JAX bench divides by its north-star
rate, which was set for a TPU.  With `profile_dir`, one window of
min(steps, 20) steps after the warmup and outside the timed ones is traced
(`utils.profiling.trace`); with `device_profile`, one more window of
`steps` steps runs under torch.profiler for the device's busy ms a step,
its idle share in that window, the kernels a step and the host's launches
a step.  TF32 is off for both cuDNN and matmuls (the f32 heads run in full
f32).

Under torchrun (`torchrun --nproc_per_node N -m mmvae_torch bench ...`)
every rank trains data-parallel on its share of the batch and its shard of
the resident set; frames/s/GPU is the global batch's frames over the time
over N, and `n_devices` is N, as the JAX bench counts a mesh.
"""

from __future__ import annotations

import subprocess
import time
from typing import Dict, Optional

import torch


def setup_resident_training(cfg, dev: torch.device, sync=None):
    """(state, data, step_fn) for the config on `dev`: TF32 off, the
    flax-initialized model with its optimizer, and the config's train step
    (its KL weight and sampling options too), K steps a call under
    `train.steps_per_call` = K (`train.loop.chunk_steps`).  `data` is
    `resident_set`, or None under `data.on_device_generate`, whose step
    generates its clips (from `data.sprite_bank` where one is named).  An
    option the port does not run raises (`train.loop.check_supported`).
    With `sync` (a `parallel.GradSync`), a data-parallel rank's step and
    rows."""
    from mmvae_torch import parallel as pmesh
    from mmvae_torch.train.loop import (build_model, check_supported, chunk_steps,
                                        make_config_step, steps_per_call)
    from mmvae_torch.train.state import create_train_state

    check_supported(cfg)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = create_train_state(build_model(cfg, dev), cfg.optim)
    ongen = cfg.data.on_device_generate
    sprites = None
    if ongen and cfg.data.sprite_bank:
        from mmvae_torch.data.loader import load_sprite_bank

        sprites = load_sprite_bank(cfg.data.sprite_bank)
    step_fn = make_config_step(cfg, state.model, resident=True, sprites=sprites, sync=sync)
    if steps_per_call(cfg) > 1:
        step_fn = chunk_steps(step_fn, steps_per_call(cfg), sync=sync)
    if ongen:
        return state, None, step_fn
    rank, world = pmesh.place(sync)
    return state, resident_set(cfg, dev)[rank::world].contiguous(), step_fn


def resident_set(cfg, dev: torch.device) -> torch.Tensor:
    """The bench's resident u8 set on `dev`, made from seed 0 at the size of
    the config's train split: its clips (N, T, 64, 64), or for a per-frame
    config every frame of them as a row (N * T, 64, 64), as the JAX bench
    packs it.  A data-parallel rank keeps rows [rank::world]."""
    n_clips = max(int(cfg.data.num_sequences * cfg.data.train_fraction),
                  cfg.data.batch_size)
    t = max(cfg.data.seq_len, 1)
    shape = (n_clips * t, 64, 64) if cfg.data.per_frame else (n_clips, t, 64, 64)
    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)


def card() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them, None where
    it does not run."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def run_benchmark(cfg, *, steps: int = 200, warmup: int = 20,
                  device: Optional[str] = None, return_state: bool = False,
                  profile_dir: Optional[str] = None, device_profile: bool = False):
    """The bench's result dict; with `return_state`, (result, the trained
    TrainState).  `profile_dir`: one traced window (its steps' losses are
    kept with the others), the trace's path under "trace" in the result.
    `device_profile`: the device's share of one more window (see the module
    docstring).  Joins torchrun's group where its environment names one
    (`parallel.join`)."""
    from mmvae_torch import parallel as pmesh
    from mmvae_torch.bench.flops import flops_per_step, peak_bf16_tflops
    from mmvae_torch.train.loop import frames_per_step, steps_per_call

    spc = steps_per_call(cfg)
    if steps % spc:
        raise ValueError(f"bench steps ({steps}) must be a multiple of "
                         f"train.steps_per_call ({spc})")
    if not torch.cuda.is_available():
        raise RuntimeError("run_benchmark measures a CUDA device; none is available")
    dev = pmesh.join(device or "cuda")
    sync = pmesh.grad_sync(dev)
    n_dev = pmesh.place(sync)[1]
    state, data, step_fn = setup_resident_training(cfg, dev, sync)
    flops = flops_per_step(cfg)

    losses = []

    def call():
        losses.append(step_fn(state, data)["loss"].reshape(-1))

    # a chunk's first call runs its steps eagerly and captures them
    for _ in range(max(warmup // spc, 1) + (spc > 1)):
        call()
    torch.cuda.synchronize(dev)

    trace_path = None
    if profile_dir:
        from mmvae_torch.utils.profiling import trace

        with trace(profile_dir) as prof:
            for _ in range(max(min(steps, 20) // spc, 1)):
                call()
        trace_path = prof.trace_path

    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps // spc):
            call()
        torch.cuda.synchronize(dev)
        windows.append(time.perf_counter() - t0)
    windows_sorted = sorted(windows)
    dt = windows_sorted[1]
    profiled = {}
    if device_profile:
        from mmvae_torch.bench.profile import device_busy_ms, profile_calls

        kernels, host, wall = profile_calls(call, steps // spc)
        busy = device_busy_ms(kernels) / steps
        profiled = {"device_busy_ms": busy, "idle_share": 1.0 - busy * steps / wall,
                    "kernels_per_step": len(kernels) / steps,
                    "host_launches_per_step": None if host is None else host / steps}

    frames = frames_per_step(cfg)  # of the global batch
    fps = frames * steps / dt / n_dev
    fps_all = sorted(frames * steps / w / n_dev for w in windows)
    loss_values = torch.cat(losses).float().cpu().tolist()
    peak = peak_bf16_tflops(torch.cuda.get_device_name(dev))
    tflops = flops * steps / dt / 1e12 / n_dev
    res = {
        "metric": f"training frames/sec/GPU ({cfg.data.seq_len}-frame clips)"
        if not cfg.data.per_frame
        else "training frames/sec/GPU (single frames)",
        "value": round(fps, 1),
        "unit": "frames/sec/GPU",
        "vs_baseline": None,
        "config": cfg.name,
        "data": "on_device_generate" if cfg.data.on_device_generate else "resident",
        "batch_frames": frames,
        "steps": steps,
        "steps_per_call": spc,
        "wall_sec": round(dt, 3),
        "step_ms": dt / steps * 1e3,
        "windows_sec": [round(w, 3) for w in windows],
        "value_min": round(fps_all[0], 1),
        "value_max": round(fps_all[-1], 1),
        "spread_pct": round(100.0 * (fps_all[-1] - fps_all[0]) / fps, 2),
        "n_devices": n_dev,
        "device": torch.cuda.get_device_name(dev),
        "card": card(),
        "final_loss": loss_values[-1],
        "flops_per_step": flops,
        "tflops_per_sec_chip": tflops,
        "mfu": None if peak is None else tflops / peak,
        **profiled,
        "losses": loss_values,
    }
    if trace_path:
        res["trace"] = trace_path
    return (res, state) if return_state else res
