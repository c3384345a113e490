"""Per-step metrics: stdout, CSV and frames/s (port of mmvae_tpu/train/metrics.py).

Loss is reported sum-per-sample.  The caller hands `log` the device tensors
of a step one log interval late (`train.loop.fit`), so reading them here
(`.item()`) does not stall the step that is running.  The stdout line, the
CSV columns and their order, and the append-on-resume rule are the
reference's.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional

import torch

CSV_COLUMNS = [
    "step", "loss", "bce", "kl",
    "val_loss", "val_bce", "val_kl",
    "val_loss_ema", "val_bce_ema", "val_kl_ema",
    "steps_per_sec", "frames_per_sec",
]


def _value(v) -> float:
    return v.item() if isinstance(v, torch.Tensor) else float(v)


class MetricsLogger:
    def __init__(self, csv_path: Optional[str] = None, frames_per_step: int = 0,
                 print_fn=print, tensorboard_dir: Optional[str] = None,
                 append: bool = False):
        self._csv_path = csv_path
        self._csv_append = append
        self._csv_file = None
        self._csv_writer = None
        self._frames_per_step = frames_per_step

        # A run watched through a pipe sees each line as it is logged.
        def _flush_print(*a, **k):
            print(*a, **k, flush=True)

        self._print = _flush_print if print_fn is print else print_fn
        self._last_time = time.perf_counter()
        self._last_step = None
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    f"train.tensorboard_dir={tensorboard_dir!r} needs the `tensorboard` "
                    "package, which is not installed; unset train.tensorboard_dir") from e
            self._tb = SummaryWriter(tensorboard_dir)

    def log(self, step: int, metrics: Dict[str, object], *,
            throughput: bool = True) -> Dict[str, float]:
        vals = {k: _value(v) for k, v in metrics.items()}
        now = time.perf_counter()
        if throughput and self._last_step is not None and step > self._last_step:
            dt = now - self._last_time
            steps_done = step - self._last_step
            vals["steps_per_sec"] = steps_done / dt
            vals["frames_per_sec"] = steps_done * self._frames_per_step / dt
        self._last_time = now
        self._last_step = step
        vals["step"] = step

        parts = [f"step {step:>7d}"]
        for k in ("loss", "bce", "kl", "val_loss", "val_loss_ema"):
            if k in vals:
                parts.append(f"{k} {vals[k]:.2f}")
        if "frames_per_sec" in vals:
            parts.append(f"{vals['frames_per_sec']:,.0f} frames/s")
        self._print("  ".join(parts))

        if self._csv_path:
            if self._csv_writer is None:
                # A resumed run appends, so the earlier history survives; a
                # fresh run truncates.
                fresh = not (self._csv_append and os.path.exists(self._csv_path)
                             and os.path.getsize(self._csv_path) > 0)
                self._csv_file = open(self._csv_path, "w" if fresh else "a", newline="")
                self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=CSV_COLUMNS,
                                                  extrasaction="ignore")
                if fresh:
                    self._csv_writer.writeheader()
            self._csv_writer.writerow({k: vals.get(k, "") for k in CSV_COLUMNS})
            self._csv_file.flush()
        if self._tb is not None:
            for k, v in vals.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)
        return vals

    def close(self) -> None:
        if self._csv_file:
            self._csv_file.close()
            self._csv_file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
