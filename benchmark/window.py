"""The arithmetic of a timed window.

A window is `calls` calls of the train step, each of `steps_per_call`
steps, timed from one synchronize before the first call to one after the
last.  The rate is every frame trained over the whole window; the step's
tail is the 95th percentile over all calls of the time between consecutive
call ends (the first from the window's start), divided by the steps a call.
"""

from __future__ import annotations

import math
from typing import Sequence


def frames_per_s(frames_per_step: int, steps_per_call: int, calls: int, window_s: float,
                 gpus: int = 1) -> float:
    """All frames trained in the window over the window, a GPU."""
    return frames_per_step * steps_per_call * calls / window_s / gpus


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    s = sorted(values)
    if not s:
        raise ValueError("percentile of no values")
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def step_ms_p95(call_ends_ms: Sequence[float], steps_per_call: int) -> float:
    """The p95 of the calls' durations over the steps a call; `call_ends_ms`
    holds each call's end from the window's start (ms, rising)."""
    prev, durations = 0.0, []
    for end in call_ends_ms:
        durations.append(end - prev)
        prev = end
    return percentile(durations, 95.0) / steps_per_call

