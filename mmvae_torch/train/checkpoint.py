"""Checkpoints of the TrainState: the port's own format (the reference
writes orbax's; the port neither reads nor writes that).

Layout: `<dir>/<step>/state.pt`, a `torch.save` of {"step", "model" (the
state_dict), "optimizer" (its state_dict: Adam's per-parameter step and
moments), "ema" (by parameter name, only where the run keeps one),
"data_step"}, read back with `weights_only=True`.  A save writes
`<dir>/.<step>.tmp` and renames it into place, so a step directory is
whole or absent; the newest `MAX_TO_KEEP` steps are kept.

A periodic save copies every tensor to the host on the caller's thread,
then writes on a background thread: the writer never holds a tensor that
the next step updates in place.  A forced save first drains any write in
flight.  The state carries no RNG: every draw derives from the step, which
is saved, and `data_step` is the count of host batches a streaming run has
consumed, so a resumed run draws what an uninterrupted one would.

Under data parallelism (`train.loop.fit` in a process group) rank 0 alone
saves, since the ranks' states are bit-identical; every rank waits at a
barrier after a forced save and restores the same directory, so a
checkpoint of N ranks restores in one process and the other way round.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Dict, Optional, Tuple

import torch

MAX_TO_KEEP = 3
_FILE = "state.pt"

# One write in flight at most per directory: {abs dir: (step, thread, errors)}.
_inflight: Dict[str, tuple] = {}
_lock = threading.Lock()


def _steps(directory: str):
    """Step directories of `directory`: entries that are directories named
    by an integer and hold a state file; anything else is skipped."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(e.name) for e in os.scandir(directory)
                  if e.name.isdigit() and e.is_dir()
                  and os.path.isfile(os.path.join(e.path, _FILE)))


def latest_step(directory: str) -> Optional[int]:
    """Newest saved step in `directory`, or None.  Never creates the
    directory."""
    wait_until_finished(directory)
    return max(_steps(os.path.abspath(directory)), default=None)


def wait_until_finished(directory: str) -> None:
    """Wait for the write in flight to `directory`, if any, and raise its
    error if it failed."""
    key = os.path.abspath(directory)
    with _lock:
        entry = _inflight.pop(key, None)
    if entry is not None:
        _, thread, errors = entry
        thread.join()
        if errors:
            raise RuntimeError(f"checkpoint write to {key} failed") from errors[0]


def _host_copy(obj):
    """`obj` with every tensor copied to fresh host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _snapshot(state, data_step: int) -> dict:
    snap = {"step": int(state.step), "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(), "data_step": int(data_step)}
    if state.ema_params is not None:
        snap["ema"] = dict(state.ema_params)
    return _host_copy(snap)


def _write(directory: str, step: int, snap: dict) -> None:
    tmp = os.path.join(directory, f".{step}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(snap, os.path.join(tmp, _FILE))
    os.replace(tmp, os.path.join(directory, str(step)))
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)


def save(directory: str, state, step: int, *, data_step: int = 0, force: bool = False,
         wait: bool = False) -> None:
    """Checkpoint `state` as `step`; written in the background unless `wait`.
    `force` (the final save, the SIGTERM save) drains the write in flight
    first.  A step already saved or being written is not written again; with
    `wait` its write is waited for."""
    key = os.path.abspath(directory)
    if force:
        wait_until_finished(key)
    with _lock:
        entry = _inflight.get(key)
    if (entry is not None and entry[0] == step) or step in _steps(key):
        if wait:
            wait_until_finished(key)
        return
    snap = _snapshot(state, data_step)
    os.makedirs(key, exist_ok=True)
    wait_until_finished(key)  # the previous write ends before this one starts
    errors: list = []

    def run():
        try:
            _write(key, step, snap)
        except BaseException as e:  # raised on the caller's side by wait_until_finished
            errors.append(e)

    thread = threading.Thread(target=run, name=f"checkpoint-{step}", daemon=False)
    with _lock:
        _inflight[key] = (step, thread, errors)
    thread.start()
    if wait:
        wait_until_finished(key)


def restore_latest(directory: str, state) -> Tuple[object, int, int]:
    """Load the newest checkpoint of `directory` into `state` in place;
    returns (state, step, data_step), or (state, 0, 0) when there is none.
    A checkpoint without an EMA restored into a state that keeps one starts
    the EMA at the restored parameters; an EMA in the checkpoint that the
    state does not keep is dropped."""
    step = latest_step(directory)
    if step is None:
        return state, 0, 0
    path = os.path.join(os.path.abspath(directory), str(step), _FILE)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    # the groups keep their own rates: a capturable optimizer's is a tensor
    # on its card, and every update sets it from the schedule
    rates = [g["lr"] for g in state.optimizer.param_groups]
    state.optimizer.load_state_dict(ckpt["optimizer"])
    for group, rate in zip(state.optimizer.param_groups, rates):
        group["lr"] = rate
    if state.ema_params is not None:
        src = ckpt.get("ema") or {n: p.detach() for n, p in state.model.named_parameters()}
        with torch.no_grad():
            for name, ema in state.ema_params.items():
                ema.copy_(src[name])
    state.set_step(int(ckpt["step"]))
    return state, state.step, int(ckpt["data_step"])
