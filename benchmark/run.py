"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cards the cell asks
for.  `--trace 0` prints the cell's end-to-end metrics (`BENCHMARK.json`),
`--trace 1` its per-layer metrics and the device's busy seconds and
window.  A cell over several ranks starts one process a card itself, with
torchrun's environment, and rank 0 prints the line.  Without a
card, or with fewer cards than the cell asks for, it prints no result and
exits 2; where a module of `jax`, `jaxlib`, `flax` or `mmvae_tpu` is loaded
after the window, it names them and exits 3.  The kernels build into
`build/kernels/`, Triton caches into `build/triton/` and Python keeps the
bytecode of every module the run imports in `build/pycache/`, all inside
the checkout, so only a checkout's first run compiles.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "mmvae_tpu")
MIN_CALLS = 20


def process_start() -> float:
    """The epoch second this process started (/proc's start time after
    boot, in clock ticks), or now.  The boot's epoch second is now less
    /proc/uptime, to a hundredth of a second: /proc/stat's `btime` is
    truncated to a whole second, which would put the start up to a second
    early by an amount fixed for each machine."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            boot = time.time() - float(f.read().split()[0])
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def bytecode_cache() -> None:
    """Python's bytecode of what this process imports goes to and comes
    from `build/pycache/` in the checkout, also where the environment turns
    its writing off: else every run compiles torch's modules again, most
    of set-up, and that time moves with the host's load."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(Path(__file__).resolve().parents[1] / "build" / "pycache")


def _start_epoch() -> float:
    return float(os.environ.get("PERFBENCH_T0") or process_start())


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the port may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: no card"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(args, ranks: int) -> int:
    """This command again in one process a card, each with the environment
    that torchrun would give it (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT, one OpenMP thread), started from this process, which
    imports no torch: torchrun's launcher would import it once more before
    the ranks start, a serial third of the cell's set-up.  Waits for every
    rank; where one fails or this process is ended, ends the others.  The
    first nonzero exit code of a rank is the run's."""
    base = dict(os.environ, PERFBENCH_T0=repr(_start_epoch()), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), WORLD_SIZE=str(ranks))
    base.setdefault("OMP_NUM_THREADS", "1")
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", args.workload,
           "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
    procs = [subprocess.Popen(cmd, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(ranks)]

    def stop(*_):
        for p in procs:
            if p.poll() is None:
                p.terminate()

    def ended(signum, _frame):
        stop()
        raise SystemExit(128 + signum)

    kept = {s: signal.signal(s, ended) for s in (signal.SIGTERM, signal.SIGINT)}
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode]
            if failed and not rc:
                rc = failed[0]
                stop()
            time.sleep(0.2)
        rc = rc or next((p.returncode for p in procs if p.returncode), 0)
    finally:
        stop()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for s, h in kept.items():
            signal.signal(s, h)
    return rc


def run_rank(cell, args, t_start: float) -> int:
    import torch

    from benchmark import check, harness, window

    t_imports = time.perf_counter()
    import mmvae_torch.train.loop  # noqa: F401  (the program's imports, timed apart)

    t_program_imports = time.perf_counter() - t_imports
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev, sync = harness.program_device(world)
    rank = 0 if sync is None else sync.rank
    t_imported = time.perf_counter()
    prog = harness.Program(cell, args.seed, dev, sync, rank, world)
    first = prog.first_calls()
    t = time.perf_counter()
    calls = max(math.ceil(args.seconds / prog.call_seconds()), MIN_CALLS)
    prog.phases["timing_calls_s"] = time.perf_counter() - t
    prog.phases = {"process_to_imports_s": t_imports - t_start,
                   "program_imports_s": t_program_imports,
                   "devices_s": t_imported - t_imports - t_program_imports, **prog.phases}
    if world > 1:
        import torch.distributed as dist

        agreed = torch.tensor([calls], device=dev)
        dist.all_reduce(agreed, op=dist.ReduceOp.MAX)
        calls = int(agreed)
    if args.trace:
        timed = prog.traced(cell.traffic["trace_calls"], cell.traffic["region_steps"])
    else:
        timed = prog.window(calls, t_start)
    peak = torch.cuda.max_memory_allocated(dev)
    if world > 1:
        import torch.distributed as dist

        stats = torch.tensor([float(peak), timed.get("busy_s", 0.0), timed["window_s"],
                              timed.get("nccl_s", 0.0)], dtype=torch.float64, device=dev)
        top = stats.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
        dist.all_reduce(stats)
        peak = int(top[0])
        if args.trace:
            timed["busy_s"], timed["nccl_s"] = float(stats[1]) / world, float(stats[3]) / world
            timed["window_s"] = float(stats[2]) / world
    phases = prog.phases
    prog.close()  # the graph holds the group's collectives: free it while the group lives
    if world > 1:
        dist.barrier(device_ids=[dev.index])
        dist.destroy_process_group()
    if rank != 0:
        return 0

    ref = harness.reference_steps(cell, args.seed, dev, world)
    numbers = check.gaps(first, ref, harness.initial_cpu(cell, args.seed, dev))
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"loaded after the window: {', '.join(forbidden)}", file=sys.stderr)
        return 3
    s = cell.config["sizes"]
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if args.trace:
        ctx = harness.per_layer_context(cell, timed, world)
        from benchmark.cells import reader

        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        frames = s["batch_size"] * s["seq_len"]
        values = {
            "train_frames_per_s": window.frames_per_s(frames, prog.k, calls, timed["window_s"],
                                                      world),
            "step_ms_p95": window.step_ms_p95(timed["call_ends_ms"], prog.k),
            "setup_s": timed["setup_s"],
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": units[m["name"]]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": world,
              "memory_peak_bytes": int(peak)}
    if args.trace:
        device.update(busy_s=timed["busy_s"], window_s=timed["window_s"])
    limits = cell.limits
    correct = check.verdict(numbers, limits) and timed.get("failed", 0) == 0
    out = {"correct": correct, "attempted": timed["steps"], "failed": timed.get("failed", 0),
           "metrics": metrics, "device": device}
    if args.trace:
        out["breakdown"] = {"device_ops": timed["device_ops"], "idle_gaps": timed["idle_gaps"]}
    out["card"] = card_line()
    out["losses_first_steps"] = first["losses"] + ref["losses"]
    out["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    print("setup phases: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr)
    for k, v in numbers.items():
        print(f"check {k} {v!r} limit {limits.get(k)!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    t_start_epoch = _start_epoch()
    bytecode_cache()
    t_start = time.perf_counter() - (time.time() - t_start_epoch)
    args = _args(argv)
    from benchmark.cells import ROOT, load_cell

    cell = load_cell(args.workload)
    cache = ROOT / "build" / "triton"
    cache.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(cache)
    ranks = int(cell.traffic["ranks"])
    if ranks > 1 and "LOCAL_RANK" not in os.environ:
        return _launch(args, ranks)  # each rank looks for the cards below
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s), found {have}: no result",
              file=sys.stderr)
        return 2
    return run_rank(cell, args, t_start)


if __name__ == "__main__":
    sys.exit(main())
