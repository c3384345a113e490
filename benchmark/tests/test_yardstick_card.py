"""The comparison that decides `correct`, shown to fail: the fp8 control and
faults planted in the program, at each cell's own size on the card.

    python -m pytest benchmark/tests/test_yardstick_card.py -m cuda -q

Skips without a card (a data-parallel cell without as many cards as it
asks for).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import cells, check

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (2 ** 31 + 11, 977, 3_000_000_019)
WORKLOADS = [w["name"] for w in cells.manifest()["workloads"]]


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_fp8_control_is_not_correct(cards, workload):
    from benchmark import harness
    from benchmark.reference import common

    cell = cells.load_cell(workload)
    dev = torch.device("cuda", 0)
    world = int(cell.traffic["ranks"])
    for seed in SEEDS:
        ref = harness.reference_steps(cell, seed, dev, world)
        ctl = harness.reference_steps(cell, seed, dev, world, lowp=common.fp8)
        numbers = check.gaps(ctl, ref, harness.initial_cpu(cell, seed, dev))
        assert not check.verdict(numbers, cell.limits), numbers


def _faults(workload):
    ranks = int(cells.load_cell(workload).traffic["ranks"])
    names = ["unchanged", "half", "eps_zero"] + (["no_exchange"] if ranks > 1 else [])
    return [(workload, f) for f in names]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", [p for w in WORKLOADS for p in _faults(w)])
def test_a_planted_fault_makes_the_run_not_correct(cards, workload, fault):
    cell = cells.load_cell(workload)
    ranks = int(cell.traffic["ranks"])
    if cards < ranks:
        pytest.skip(f"{workload} needs {ranks} cards")
    launch = [sys.executable] if ranks == 1 else [
        sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
        str(ranks)]
    res = subprocess.run(launch + ["-m", "benchmark.tests._fault_run", "--workload", workload,
                                   "--seed", str(SEEDS[0]), "--fault", fault],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
