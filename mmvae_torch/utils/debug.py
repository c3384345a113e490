"""Debug guards and preemption handling (port of mmvae_tpu/utils/debug.py).

- `debug_nans`: NaN checks over a run, as `train.debug_nans` asks: autograd's
  anomaly mode with `check_nan`, so a backward op that returns NaN raises
  and names the forward op that made it.
- `install_sigterm_checkpoint`: on SIGTERM (preemption) a checkpoint of the
  last whole step, then the default action.  The optimizer and the EMA
  update the state in place, so a save made the moment the signal lands
  could catch a half-applied step (parameters at n + 1, the EMA at n).  The
  handler therefore only sets a flag; the train loop reads it after each
  step and calls `SigtermCheckpoint.save_and_exit`.  Under data
  parallelism a rank's flag rides in the train step's all-reduce
  (`parallel.GradSync`), so a signal to any rank stops every rank after
  the same step, which is saved.
"""

from __future__ import annotations

import contextlib
import signal
import sys
import threading
import traceback
from typing import Callable

import torch


def debug_nans(enabled: bool = True):
    """A context under which a NaN returned by a backward op raises; a
    no-op context when not `enabled`."""
    if not enabled:
        return contextlib.nullcontext()
    return torch.autograd.detect_anomaly(check_nan=True)


class SigtermCheckpoint:
    """SIGTERM sets `requested`; `save_and_exit(save_fn)` runs `save_fn()`
    once (a failure is printed to stderr), restores the default action and
    raises SIGTERM again, which ends the process.  `uninstall()` puts the
    previous handler back."""

    def __init__(self):
        self.requested = False
        self._previous = signal.signal(signal.SIGTERM, self._handler)

    def _handler(self, signum, frame) -> None:
        self.requested = True

    def save_and_exit(self, save_fn: Callable[[], None]) -> None:
        try:
            save_fn()
        except BaseException:
            # The process dies on the signal below either way; the trace
            # tells a failed save from a missing one.
            print("sigterm checkpoint failed:", file=sys.stderr)
            traceback.print_exc()
            sys.stderr.flush()
        finally:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.raise_signal(signal.SIGTERM)

    def uninstall(self) -> None:
        # None: the previous handler was not installed from Python
        signal.signal(signal.SIGTERM,
                      signal.SIG_DFL if self._previous is None else self._previous)


def install_sigterm_checkpoint():
    """A `SigtermCheckpoint` installed as the SIGTERM handler, or None off
    the main thread, where Python cannot install signal handlers."""
    if threading.current_thread() is not threading.main_thread():
        return None
    return SigtermCheckpoint()
