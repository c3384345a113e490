"""One run of a cell with a fault planted in the program (`benchmark.faults`):
the harness's run past its look for a card, its result line printed.

    python3 -m benchmark.tests._fault_run --workload NAME --seed N --fault NAME

Under several ranks start it with `torchrun --standalone --nproc_per_node N`.
"""

import argparse
import sys
import time

from benchmark import faults, run
from benchmark.cells import load_cell

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--fault", required=True)
    a = ap.parse_args()
    args = argparse.Namespace(workload=a.workload, seed=a.seed, seconds=1.0, trace=0)
    with faults.planted(a.fault):
        sys.exit(run.run_rank(load_cell(a.workload), args, time.perf_counter()))
