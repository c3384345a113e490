"""The readings that the limits of `correct` are set from.  Not run by the
benchmark's runs.

    python3 -m benchmark.calibrate --workload NAME --seeds S1 S2 ... \\
        [--control] [--controls-f32] [--faults half eps_zero ...] \
        [--program-faults unchanged half ...] [--leaves PATH]

For each seed it prints one JSON line of `check.gaps` readings:

- "program": the program's first three steps (the eager first call and a
  graph replay) against the reference, as a run compares them;
- "control" (`--control`): the reference computed with every tensor the
  configuration keeps in bf16 rounded to fp8 (e4m3), put in the program's
  place;
- "control_tf32", "control_bf16" (`--controls-f32`): the reference with the
  inputs and weights of every product the configuration keeps in f32 (its
  Dense layers) rounded to TF32 or to bf16, the rest in f32;
- "ref_fault:<name>" (`--faults`): a fault planted in the reference put in
  the program's place (`harness.reference_steps`: half, eps_zero,
  no_exchange);
- "program_fault:<name>" (`--program-faults`): a fault planted in the
  program (`benchmark.faults`).

Each reading carries "correct", the verdict of the cell's limits on it.
`--leaves PATH` appends, for each seed, every leaf's gaps of every reading
(`check.leaf_gaps`) as a JSON line.

A cell over several ranks starts itself under torchrun (a run starts its
ranks itself, with the same environment); rank 0 prints.  Set-up and the
reference run once a seed in one process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--controls-f32", action="store_true")
    ap.add_argument("--leaves")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--program-faults", nargs="*", default=[])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    from benchmark import check, faults, harness
    from benchmark.cells import ROOT, load_cell
    from benchmark.reference import common

    cell = load_cell(args.workload)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    ranks = int(cell.traffic["ranks"])
    if ranks > 1 and "LOCAL_RANK" not in os.environ:
        import subprocess

        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(ranks), "-m", "benchmark.calibrate", *sys.argv[1:]]
        return subprocess.run(cmd).returncode
    world = ranks
    dev, sync = harness.program_device(world)
    rank = 0 if sync is None else sync.rank

    def program(seed, fault=None):
        with faults.planted(fault) if fault else contextlib.nullcontext():
            prog = harness.Program(cell, seed, dev, sync, rank, world)
            first = prog.first_calls()
            prog.close()
        return first

    for seed in args.seeds:
        runs = {"program": program(seed)}
        for f in args.program_faults:
            runs[f"program_fault:{f}"] = program(seed, f)
        if rank == 0:
            ref = harness.reference_steps(cell, seed, dev, world)
            initial = harness.initial_cpu(cell, seed, dev)
            if args.control:
                runs["control"] = harness.reference_steps(cell, seed, dev, world, lowp=common.fp8)
            if args.controls_f32:
                for name, fn in (("control_tf32", common.tf32), ("control_bf16", common.bf16)):
                    runs[name] = harness.reference_steps(cell, seed, dev, world, lowp32=fn)
            for f in args.faults:
                runs[f"ref_fault:{f}"] = harness.reference_steps(cell, seed, dev, world, fault=f)
            out = {"seed": seed}
            for name, run in runs.items():
                out[name] = check.gaps(run, ref, initial)
                out[name]["correct"] = check.verdict(out[name], cell.limits)
            if args.leaves:
                leaves = {name: dict(zip(("grad", "update"), check.leaf_gaps(run, ref, initial)))
                          for name, run in runs.items()}
                with open(args.leaves, "a") as f:
                    f.write(json.dumps({"seed": seed, **leaves}) + "\n")
            out["worst_leaves"] = check.worst_leaves(runs["program"], ref, initial)
            out["losses"] = {"reference": ref["losses"][0], "program": runs["program"]["losses"]}
            print(json.dumps(out), flush=True)
    if world > 1:
        import torch.distributed as dist

        dist.barrier(device_ids=[dev.index])
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
