"""Where a train step's time goes on one GPU.

    python -m mmvae_torch.bench.profile [--config seq_vae] [--steps 10]
                                        [--set model.kwargs.remat=false ...]
                                        [--regions [--depth 2]]

Runs real train steps of the config at full width on the data path it names
(a resident u8 dataset, or clips generated on the card under
`data.on_device_generate`: `bench.throughput.setup_resident_training`), K
steps a call under `train.steps_per_call` = K (one CUDA graph replay), then
prints one JSON line: the step time on the host clock (steps ended by
`torch.cuda.synchronize()`), the device-busy time per step from
`torch.profiler` (the union of kernel intervals on the card), the idle share
(1 - busy / step), the kernels the card runs per step, the launches the
host makes per step (CUDA runtime launch calls: a graph replay is one), the
kernels with the most device time, and the process's peak of allocated
device memory (`memory_peak_bytes`).  Fails without a CUDA device.

`--regions` adds `regions`: the per-region device budget of a step (the
kernels' ms a step by the port's named regions, forward and backward apart),
from one more window of `steps` steps traced with the host's activity too,
apart from the windows above (tracing the host slows it).  At
`train.steps_per_call` = K > 1 it reads the graph replays of that window by
the chunk's region map (`bench.regions.replay_budget`: each row's idle gaps
inside a replay beside its device time; `regions` is null, and the reason
on stderr, where a replay does not match the map); at K = 1 it reads the
eager steps (`bench.regions.budget`).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from collections import defaultdict
from typing import Optional

import torch


def _busy_ms(intervals) -> float:
    """Length of the union of [start, end) intervals (us) in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


# CUDA API calls (runtime cuda*, low-level cu*) that put work on the card: the host's launches
_HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                  "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                  "cudaMemsetAsync")


def profile_calls(fn, calls: int) -> tuple:
    """(the CUDA kernel events, the host's launch calls or None where the
    trace holds no runtime events, the window's ms on the host clock) of
    `calls` calls of `fn` under torch.profiler, ended by a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    host = sum(e.name in _HOST_LAUNCHES for e in events)
    return ([e for e in events if e.device_type == torch.autograd.DeviceType.CUDA],
            host or None, wall)



def device_busy_ms(kernels) -> float:
    """Device-busy ms of kernel events: the union of their intervals."""
    return _busy_ms((e.time_range.start, e.time_range.end) for e in kernels)


def replay_regions(fn, regions_map, calls: int, steps: int, depth: int = 2) -> Optional[dict]:
    """`calls` graph replays (`fn`, `steps` steps in all) traced by
    `utils.profiling.trace` and read by `bench.regions.replay_budget`: the
    rows, largest first (ms a step: forward, backward, of which idle gaps,
    their sum and share), and the replays' span a step; None where a replay
    does not match `regions_map`."""
    from mmvae_torch.bench.regions import load_trace, replay_budget
    from mmvae_torch.utils.profiling import trace

    with tempfile.TemporaryDirectory(prefix="mmvae_replay_") as d:
        with trace(d) as prof:
            for _ in range(calls):
                fn()
        rows = replay_budget(load_trace(prof.trace_path), regions_map, steps, depth)
    if rows is None:
        return None
    span = sum(f + b for f, b, _ in rows.values())
    table = [{"region": r, "fwd_ms": f, "bwd_ms": b, "gap_ms": g, "ms": f + b,
              "share": (f + b) / span if span else 0.0} for r, (f, b, g) in rows.items()]
    table.sort(key=lambda r: -r["ms"])
    return {"timeline": "replay", "steps": steps, "depth": depth, "span_ms": span,
            "work_nodes": len(regions_map.nodes), "graph_nodes": regions_map.graph_nodes,
            "rows": table}


def profile_train_step(cfg, *, steps: int = 10, warmup: int = 5, top: int = 12,
                       regions: bool = False, depth: int = 2) -> dict:
    """`steps` train steps timed and profiled after `warmup` (both rounded
    up to whole calls of `train.steps_per_call` steps); with `regions`, the
    per-region budget of `steps` more, cut to `depth` region names."""
    from mmvae_torch.bench.throughput import setup_resident_training
    from mmvae_torch.train.loop import frames_per_step, steps_per_call

    if not torch.cuda.is_available():
        raise RuntimeError("profile_train_step measures a CUDA device; none is available")
    spc = steps_per_call(cfg)
    calls, steps = -(-steps // spc), -(-steps // spc) * spc
    torch.cuda.reset_peak_memory_stats()
    state, data, step = setup_resident_training(cfg, torch.device("cuda"))
    for _ in range(-(-warmup // spc) + (spc > 1)):  # a chunk's first call captures
        step(state, data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        step(state, data)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3

    kernels, host, _ = profile_calls(lambda: step(state, data), calls)
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    busy = device_busy_ms(kernels) / steps
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    budget = {}
    if regions and spc > 1:
        budget = {"regions": replay_regions(lambda: step(state, data), step.regions(), calls,
                                            steps, depth)}
    elif regions:
        from mmvae_torch.bench.regions import profile_regions

        budget = {"regions": profile_regions(lambda: step(state, data), calls, steps, depth)}
    return {
        "config": cfg.name,
        "model_kwargs": {k: v for k, v in cfg.model.kwargs.items()},
        "device": torch.cuda.get_device_name(),
        "steps_per_call": spc,
        "step_ms": round(step_ms, 3),
        "frames_per_sec": round(frames_per_step(cfg) / step_ms * 1e3, 1),
        "device_busy_ms": round(busy, 3),
        "idle_share": round(1.0 - busy / step_ms, 4),
        "kernel_launches_per_step": round(len(kernels) / steps, 1),
        "host_launches_per_step": None if host is None else round(host / steps, 2),
        "top_kernels_ms_per_step": [[name[:90], round(ms / steps, 4)] for name, ms in ranked],
        "memory_peak_bytes": torch.cuda.max_memory_allocated(),
        **budget,
    }


def main(argv=None) -> None:
    from mmvae_torch.configs import get_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="seq_vae")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--regions", action="store_true",
                    help="add the per-region device budget of a step")
    ap.add_argument("--depth", type=int, default=2, help="region path depth of the budget")
    args = ap.parse_args(argv)
    cfg = get_config(args.config, tuple(args.set))
    print(json.dumps(profile_train_step(cfg, steps=args.steps, regions=args.regions,
                                        depth=args.depth)))


if __name__ == "__main__":
    main()
