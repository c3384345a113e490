"""Data parallelism, one process per card (port of mmvae_tpu/parallel/mesh.py).

The JAX package runs its data-parallel step under `shard_map` over a 1-D
`data` mesh and `pmean`s the gradients and metrics between `jax.grad` and
the optimizer.  The port runs one process a card, started by `torchrun
--nproc_per_node N` on one node or several (or by a caller that joins the
group itself, as the tests and `chip_smoke.py` do), which is the JAX
package's multi-process path with one local device a process.  A single
process on a host with several cards trains on one of them.

Rank r trains on the batch's r-th share (`data.batch_size // world`); its
step seed is `ops.seeds.shard_seed(step_seed, r)`, its resident rows are
the loader's `split[r::world]`.  After the backward, `GradSync` averages
the gradients, the step's metrics and the ranks' stop requests in one
all-reduce of a flat f32 buffer, so clipping, the optimizer and the EMA
see the averaged gradients on every rank, and the parameters stay
bit-identical across ranks (the all-reduce hands every rank the same
sums).  No `DistributedDataParallel`: it would overlap the all-reduce with
the backward, but it wraps the module (its state dict gains `module.`),
wants hooks on every parameter through the remat and `functional_call`
paths, and cannot carry the metrics and the stop flag in its collective.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# torchrun's variables; a process started without them is world size 1
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched_by_torchrun() -> bool:
    """Whether torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, ...)
    names this process's place in a group."""
    return all(k in os.environ for k in _ENV)


def env_world() -> int:
    """WORLD_SIZE of the environment, 1 without torchrun's."""
    return int(os.environ["WORLD_SIZE"]) if launched_by_torchrun() else 1


def rank() -> int:
    """This process's rank: the group's where one is up, else torchrun's
    RANK (a one-process command such as `eval` under torchrun), else 0."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ["RANK"]) if launched_by_torchrun() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device="cuda") -> torch.device:
    """The rank's device: a bare "cuda" under torchrun is `cuda:LOCAL_RANK`,
    made the current device; anything else as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def init_from_env(device="cuda", *, backend: Optional[str] = None,
                  init_method: str = "env://", rank: Optional[int] = None,
                  world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return the rank's device.

    By default from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR / MASTER_PORT), with NCCL for a card and gloo for the CPU.
    The tests and `chip_smoke.py` name the backend, an `init_method` such as
    `file://<path>`, the rank and the world size; gloo also all-reduces
    card tensors (through the host), so two ranks can share one card."""
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if rank is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def join(device="cuda") -> torch.device:
    """The rank's device, after joining torchrun's group where the
    environment names one of more than one rank and no group is up yet.
    The group stays up for the process's later calls; `shutdown` ends it."""
    if not dist.is_initialized() and env_world() > 1:
        return init_from_env(device)
    return local_device(device)


def grad_sync(device) -> Optional["GradSync"]:
    """The step's `GradSync` in a group of more than one rank, else None."""
    return GradSync(rank(), world(), device) if world() > 1 else None


def place(sync: Optional["GradSync"]) -> Tuple[int, int]:
    """(rank, world) of a step's `sync`; (0, 1) without one."""
    return (0, 1) if sync is None else (sync.rank, sync.world)


def barrier(device) -> None:
    """Every rank reaches this point: an all-reduce of one element on
    `device`, the same call for NCCL and gloo."""
    if world() > 1:
        dist.all_reduce(torch.zeros(1, device=device))


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class GradSync:
    """The train step's one collective: after the backward, the gradients,
    the step's metrics and the ranks' stop requests in one all-reduce (sum)
    of a flat f32 buffer, divided by the world size.  The gradients and
    the metrics come back as the ranks' means (JAX's `pmean`), the stop
    flag as the share of ranks that asked to stop.

    `stop` is this rank's request, set by the training loop before a step
    (the SIGTERM flag); it lives in a one-element device buffer that the
    host writes when the request changes, so a CUDA graph of several steps
    (`train.loop.chunk_steps`, NCCL only) reads the value of its replay.
    `stop_agreed()` reads the reduced flag of the step (or graph replay)
    before the last one: every rank reads the same value after the same
    step, so all stop together, and the host waits on a collective that
    finished a step ago, never on the one in flight.  A step captured in a
    graph notes its reduced flag at each replay (`replayed`)."""

    def __init__(self, rank: int, world: int, device):
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self.backend = dist.get_backend() if dist.is_initialized() else None
        self._stop = False
        self._stop_buf = torch.zeros(1, device=self.device)
        self._captured_flag: Optional[torch.Tensor] = None
        self._flags = collections.deque(maxlen=2)  # (reduced flag on the host, its event)

    @property
    def stop(self) -> bool:
        return self._stop

    @stop.setter
    def stop(self, value: bool) -> None:
        if bool(value) != self._stop:
            self._stop = bool(value)
            self._stop_buf.fill_(float(self._stop))

    def __call__(self, params: Iterable[torch.nn.Parameter],
                 metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Average the `.grad` of `params` in place across the ranks (a
        parameter without one on every rank is left so) and return the
        ranks' mean of `metrics` (0-d tensors)."""
        grads = [p.grad for p in params if p.grad is not None]
        keys = list(metrics)
        buf = torch.cat([g.reshape(-1).float() for g in grads]
                        + [torch.stack([metrics[k].float() for k in keys]), self._stop_buf])
        dist.all_reduce(buf)
        buf.div_(self.world)
        sizes = [g.numel() for g in grads]
        n = sum(sizes)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(buf[:n].split(sizes), grads)])
        tail = buf[n:].clone()
        if buf.is_cuda and torch.cuda.is_current_stream_capturing():
            self._captured_flag = tail[-1:]  # noted after each replay
        else:
            self._note_flag(tail[-1:])
        return dict(zip(keys, tail[:-1].unbind()))

    def replayed(self) -> None:
        """Note the reduced flag of a replayed graph's last step."""
        self._note_flag(self._captured_flag)

    def _note_flag(self, flag: torch.Tensor) -> None:
        if flag.is_cuda:
            host = torch.empty(1, pin_memory=True)
            host.copy_(flag, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._flags.append((host, done))
        else:
            self._flags.append((flag, None))

    def stop_agreed(self) -> bool:
        """Whether any rank had asked to stop by the step before the last."""
        if len(self._flags) < 2:
            return False
        host, done = self._flags[0]
        if done is not None:
            done.synchronize()
        return bool(host.item() > 0)

    def span(self, values: Sequence[int]) -> Tuple[List[int], List[int]]:
        """(the least, the greatest) of each of `values` (ints) over the
        ranks, in one all-reduce."""
        both = torch.tensor([*values, *(-v for v in values)], dtype=torch.int64,
                            device=self.device)
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        n = len(values)
        return [-v for v in both[n:].tolist()], both[:n].tolist()

    def mean(self, values: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of `values` (an eval batch's metrics)."""
        out = values.float().clone()
        dist.all_reduce(out)
        return out.div_(self.world)
