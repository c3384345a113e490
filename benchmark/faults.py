"""Faults planted in the program, to show that the comparison catches them.

Each is a context manager that patches the port while a run is set up and
runs, and undoes it after:

- `unchanged`: every step leaves the parameters and the optimizer's state
  as they were (only the step counters advance);
- `half`: each rank trains on half of its batch, the loss the mean over it;
- `eps_zero`: the Gaussian heads sample with eps = 0, so z = mu (a draw
  altered where it is produced);
- `no_exchange`: under data parallelism the gradients are not averaged
  across the ranks (each rank updates by its own).

Used by `benchmark.calibrate` and the card's tests, never by a run.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(name: str):
    from unittest import mock

    if name == "unchanged":
        from mmvae_torch.train.state import TrainState

        def keep(self):
            self.step_t += 1
            self.step += 1

        with mock.patch.object(TrainState, "apply_gradients", keep):
            yield
    elif name == "half":
        from mmvae_torch.train import loop

        real = loop.local_batch
        with mock.patch.object(loop, "local_batch", lambda cfg, world: real(cfg, world) // 2):
            yield
    elif name == "eps_zero":
        import torch

        from mmvae_torch.models import base

        real = base.gaussian_head_sample

        def zero_eps(x, w_mu, b_mu, w_lv, b_lv, seed, eps=None):
            eps = torch.zeros(x.shape[0], w_mu.shape[0], device=x.device, dtype=torch.float32)
            return real(x, w_mu, b_mu, w_lv, b_lv, seed, eps)

        with mock.patch.object(base, "gaussian_head_sample", zero_eps):
            yield
    elif name == "no_exchange":
        from mmvae_torch.parallel.mesh import GradSync

        def local(self, params, metrics):
            self._captured_flag = self._stop_buf
            return metrics

        with mock.patch.object(GradSync, "__call__", local):
            yield
    else:
        raise KeyError(f"no fault {name!r}")
