"""Flax param tree -> the port's state_dict.

The input is the JAX model's params as nested dicts of numpy arrays (the
port never imports flax).  Module and parameter names in the port mirror the
flax paths: `a/b/kernel` -> `a.b.weight`, `a/b/bias` -> `a.b.bias`.

Layout mappings (flax -> torch):
- Dense kernel (in, out) -> Linear weight (out, in): transposed.
- Conv kernel HWIO -> Conv2d weight OIHW.
- ConvTranspose kernel (kh, kw, in, out) -> ConvTranspose2d weight
  (in, out, kh, kw): flipped in space, then permuted (2, 3, 0, 1).  With
  k == stride == 2 flax's SAME padding is torch's padding 0, at k4/s2 it is
  padding 1.  `_is_transposed` names the owners: `ConvTranspose_i` and
  the `fast_k4tail` decoder's `k4_tail`.
- A ConvLSTM whose input kernel is 1x1 (the encoder, kernel path):
  `input/kernel` (1, 1, C, 4F) -> a (C, 4F) matrix, and
  `step/hidden/kernel` stays HWIO (3, 3, F, 4F).  Otherwise (the decoder)
  both are OIHW convs.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def _is_transposed(owner: str) -> bool:
    """Whether `owner`'s 4-D kernel is a transposed conv's: flax's
    `ConvTranspose_i` (and `Upsample2x2`, named so) or `k4_tail`."""
    return owner.startswith("ConvTranspose_") or owner == "k4_tail"


def _is_proj_lstm(leaves: Dict[tuple, np.ndarray], lstm: tuple) -> bool:
    k = leaves.get(lstm + ("input", "kernel"))
    return k is not None and k.ndim == 4 and k.shape[:2] == (1, 1)


def _map_leaf(path: tuple, arr: np.ndarray, leaves) -> np.ndarray:
    leaf, owner = path[-1], path[-2]
    if leaf == "bias":
        return arr
    if leaf != "kernel":
        raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
    if arr.ndim == 2:
        return arr.T
    if arr.ndim != 4:
        raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
    if owner == "input" and _is_proj_lstm(leaves, path[:-2]):
        return arr.reshape(arr.shape[2], arr.shape[3])
    if path[-3:-1] == ("step", "hidden") and _is_proj_lstm(leaves, path[:-3]):
        return arr
    if _is_transposed(owner):
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr.transpose(3, 2, 0, 1)


def state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Map every leaf of a flax param tree (`{"params": ...}` or its inside)
    to the port's state_dict; each leaf is consumed exactly once."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    leaves = dict(_flatten(tree))
    out: Dict[str, torch.Tensor] = {}
    for path, arr in leaves.items():
        name = ".".join(path[:-1] + ("weight" if path[-1] == "kernel" else path[-1],))
        if name in out:
            raise KeyError(f"two flax leaves map to {name}")
        mapped = _map_leaf(path, arr, leaves)
        out[name] = torch.tensor(np.ascontiguousarray(mapped, dtype=np.float32))
    return out
