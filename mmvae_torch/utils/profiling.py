"""Tracing (port of mmvae_tpu/utils/profiling.py).

`trace(logdir)` profiles everything inside the context with
`torch.profiler`: CPU activity, and on a machine with a CUDA device the
card's kernels too.  It writes one Chrome / Perfetto JSON trace into
`logdir` (open it in ui.perfetto.dev or chrome://tracing; no tensorboard
package is needed).  `annotate(name)` names a region in that trace: the
port opens the JAX package's `jax.named_scope` regions under the same names
at the counterpart sites, and `bench.regions` sums a trace's time by them.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_NO_REGION = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block into `logdir`/trace_<pid>_<ns>.json; the path is
    left in the profiler's `trace_path` attribute."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """Named region for profiler attribution: `with annotate('encoder'): ...`.

    A `record_function` range while a profiler runs; otherwise nothing but
    the check (no range is opened, so the train step's host time is that
    of an unannotated step)."""
    return record_function(name) if torch.autograd._profiler_enabled() else _NO_REGION
