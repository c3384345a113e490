"""The numbers that decide `correct`, each against its limit.

Of the program's first three train steps and the reference's from the
same seed (`harness`):

- `loss_gap`: the largest |loss - reference loss| / |reference loss| over
  the three steps, of the eager first call and of the graph replay;
- `grad_gap`: the first gradient as the optimizer got it, by the worst
  leaf: | ||g|| - ||g_ref|| | over the larger of the reference's norm of
  that leaf and of the median leaf;
- `update_gap`: the parameters' change over the three steps, by the worst
  leaf in the same way, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's (below it a leaf moves under
  Adam by rounding alone).

A number that is not finite, a loss that is not finite, or a number over
its limit makes the run not correct.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Mapping

import torch

SMALL_GRAD = 1e-3


def _norms(leaves: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in leaves.items()}


def _ratios(prog: Mapping[str, float], ref: Mapping[str, float]) -> Dict[str, float]:
    """|prog - ref| / max(ref, the median of ref), by leaf."""
    med = statistics.median(ref.values())
    return {n: abs(prog[n] - r) / max(r, med) for n, r in ref.items()}


def leaf_gaps(prog: dict, ref: dict, initial: Mapping[str, torch.Tensor]):
    """({leaf: the first gradient's gap}, {leaf: the change's gap}), the
    change over the leaves whose reference gradient is not nought to
    rounding."""
    g_ref = _norms(ref["grad"])
    med = statistics.median(g_ref.values())
    moved = [n for n, g in g_ref.items() if g >= SMALL_GRAD * med]
    d_prog = _norms({n: prog["after"][n] - initial[n] for n in moved})
    d_ref = _norms({n: ref["after"][n] - initial[n] for n in moved})
    return _ratios(_norms(prog["grad"]), g_ref), _ratios(d_prog, d_ref)


def gaps(prog: dict, ref: dict, initial: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """The three numbers (see the module docstring).  `prog` and `ref` hold
    "losses" (lists of per-step losses: the program's eager and replayed,
    the reference's one), "grad" and "after" ({name: tensor}); `initial`
    the seed's parameters."""
    ref_losses = ref["losses"][0]
    loss_gap = max(abs(p - r) / abs(r) for run in prog["losses"]
                   for p, r in zip(run, ref_losses))
    if any(not math.isfinite(v) for run in prog["losses"] for v in run):
        loss_gap = math.inf
    grad, update = leaf_gaps(prog, ref, initial)
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "update_gap": max(update.values())}


def worst_leaves(prog: dict, ref: dict, initial: Mapping[str, torch.Tensor]) -> Dict[str, str]:
    """The leaf that sets `grad_gap` and the one that sets `update_gap`."""
    grad, update = leaf_gaps(prog, ref, initial)
    return {"grad_gap": max(grad, key=grad.get), "update_gap": max(update, key=update.get)}


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number finite and at or under its limit; a missing limit fails."""
    return all(k in limits and math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
