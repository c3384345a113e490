"""Finding a cell's parts by name.

`BENCHMARK.json` (at the root of the checkout) names every cell, its
configuration and traffic mix, and every metric.  Each part sits in a file
of its own, found by the names there:

- a configuration: `configs/<config>.json` (the program's config and
  overrides, the sizes, the reference model's module under `reference/`,
  and under "regions" the names its program opens beyond `trace.REGIONS`);
- a reference model: `reference/<name>.py` (`spec`, `eps_shapes`, `loss`,
  and `recurrences`: each recurrence call of a step with its region, work
  and hidden products, from which `counts` takes the bounds and FLOPs);
- a traffic mix: `traffic/<traffic>.json` (the data path, steps a call,
  ranks, the traced window);
- a cell's limits of the comparison that decides `correct`:
  `limits/<workload>.json`;
- a per-layer metric: `metrics/<metric>.py`, whose `read(ctx)` returns the
  number or None where the run has nothing to read.

A new cell, configuration, architecture, traffic mix or metric is new
files and new entries in `BENCHMARK.json`; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The workload `name` of the manifest under `root`, its files under
    `here`."""
    man = manifest(root)
    found = [w for w in man["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{', '.join(w['name'] for w in man['workloads'])}")
    w = found[0]
    config = _json(here / "configs" / f"{w['config']}.json")
    limits_path = here / "limits" / f"{name}.json"
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=_json(limits_path) if limits_path.exists() else {},
        end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in man["per_layer"] if _applies(m, name)],
    )


def reader(metric: str, here: Path = HERE) -> Callable:
    """`read(ctx)` of `metrics/<metric>.py`."""
    path = here / "metrics" / f"{metric}.py"
    name = "benchmark_metric_" + metric.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
