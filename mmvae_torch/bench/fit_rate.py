"""Frames/s of the training loop, by its own logger, beside the bench's.

    python -m mmvae_torch.bench.fit_rate [--config seq_vae] [--steps 120]
                                         [--set data.device_resident=false ...]
    torchrun --nproc_per_node N -m mmvae_torch.bench.fit_rate ...

Runs `train.loop.fit` of the config at full width on the card, logging
every 20 steps with eval and checkpoints off (unless `--set` turns them
on), on the data path the config names (resident by default; streamed
from the host through `DeviceFeed` under `data.device_resident=false`;
generated on the card under `data.on_device_generate`).  The logger's
windows give frames/s (host clock between two logged lines, each read one
interval late; the first logged line opens the first window).  Then
`bench.throughput.run_benchmark` times the same config on its resident
set or generated clips.  Prints one JSON line with both, the card's name
and power limit.  Under `train.steps_per_call` = K both run K steps a call
(one CUDA graph replay); K must divide the 20-step log interval.  Fails
without a CUDA device.  Under torchrun both run
data-parallel over the N ranks (one a card); the logger's frames/s is the
global batch's, the per-GPU figure divides it by N, and rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

LOG_EVERY = 20


def fit_rate(cfg, steps: int) -> dict:
    from mmvae_torch import parallel
    from mmvae_torch.bench.throughput import card, run_benchmark
    from mmvae_torch.train.loop import fit

    if not torch.cuda.is_available():
        raise RuntimeError("fit_rate measures a CUDA device; none is available")
    cfg.train.log_every = LOG_EVERY
    _, history = fit(cfg, max_steps=steps, device="cuda")
    windows = [h["frames_per_sec"] for h in history if "frames_per_sec" in h]
    world = parallel.world()
    if cfg.data.on_device_generate:
        path = "on_device_generate"
    elif cfg.data.device_resident is False:
        path = "streaming"
    else:
        path = "resident"
    bench = run_benchmark(cfg, steps=20, warmup=5)
    return {
        "config": cfg.name, "fit_path": path, "steps": steps, "log_every": LOG_EVERY,
        "fit_frames_per_sec_windows": [round(w, 1) for w in windows],
        "fit_frames_per_sec_median": round(statistics.median(windows), 1),
        "n_devices": world,
        "fit_frames_per_sec_per_gpu_median": round(statistics.median(windows) / world, 1),
        "bench_data": bench["data"], "bench_frames_per_sec": bench["value"],
        "bench_min": bench["value_min"], "bench_max": bench["value_max"],
        "steps_per_call": cfg.train.steps_per_call, "card": card(),
    }


def main(argv=None) -> None:
    from mmvae_torch import parallel
    from mmvae_torch.configs import get_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="seq_vae")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    cfg = get_config(args.config, ("train.eval_every=0", *args.set))
    try:
        res = fit_rate(cfg, args.steps)
        if parallel.rank() == 0:
            print(json.dumps(res))
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    main()
