"""Tracing (port of mmvae_tpu/utils/profiling.py).

`trace(logdir)` profiles everything inside the context with
`torch.profiler`: CPU activity, and on a machine with a CUDA device the
card's kernels too.  It writes one Chrome / Perfetto JSON trace into
`logdir` (open it in ui.perfetto.dev or chrome://tracing; no tensorboard
package is needed).  `annotate(name)` names a region in that trace: the
port opens the JAX package's `jax.named_scope` regions under the same names
at the counterpart sites, and its own `PORT_REGIONS` where the JAX package
names none, and `bench.regions` sums a trace's time by them.  `span(name)`
names a stretch of host time in the trace and nothing else.

Regions in a captured CUDA graph.  A graph replay runs no host code, so no
range opens in it.  While `record_regions()` is active (the capture of
`train.loop.chunk_steps`), each `annotate` also records a boundary at the
capture's frontier on entry and on exit: the graph nodes that the next
captured operation will depend on (`cudaStreamGetCaptureInfo`).  Backward
work gets the same boundaries: `backward(loss)` hooks every autograd node
of the loss's graph before it runs, and each node's hook records the
region of the forward operation that made the node (by its autograd
sequence number) as backward.  So a custom Function's backward, the
gradient sums the engine adds after a node, and a checkpoint's recompute
(which runs inside the backward of a node of the checkpointed region) land
in the region of their forward, as `bench.regions` attributes a traced
eager step.  Hooks and boundaries launch nothing: the graph holds the same
nodes as without them.  After the capture, `RegionRecorder.walk(graph)`
puts every work node of the graph (kernel, memset, memcpy) in its region:
`GraphRegions`, which `bench.regions.replay_budget` matches to the device
trace of the replays.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import os
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_NO_REGION = contextlib.nullcontext()

# The port's own regions, beside the JAX package's `jax.named_scope` names
# (`bench.regions.JAX_REGIONS`), opened in `train.loop.make_train_step`
# around work the JAX package leaves outside every scope.  `rows`: the step
# seed and the batch's row draw; `ongen`: the clips generated on the card;
# `optimizer`: all of `TrainState.apply_gradients` (clip, rate, Adam, EMA,
# the step counter); `grad_sync`: `parallel.GradSync`'s all-reduce.  Outside
# every region (the row `?`) stay the loss arithmetic of
# `train.loop.make_loss_fn`, its backward and the backward's seed gradient,
# the gradients' hand-over to `.grad` (`AccumulateGrad`), and
# `chunk_steps`' stack of the chunk's metrics.
PORT_REGIONS = ("rows", "ongen", "optimizer", "grad_sync")

RegionPath = Tuple[str, ...]

# cudaGraphNodeType of a graph's work nodes
WORK_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


# The profiler keeps a device record only inside its window, on the host's
# clock, to which the card's timestamps are converted with a drift: without
# a pause at each end the first or the last graph replay of a traced window
# lost up to 2,000 of its 11,511 kernels (an H100, 26 traces of 3 replays).
_SETTLE_S = 0.05


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block into `logdir`/trace_<pid>_<ns>.json; the path is
    left in the profiler's `trace_path` attribute."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if cuda:
            time.sleep(_SETTLE_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()  # the block's kernels end inside the trace
            time.sleep(_SETTLE_S)
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def span(name: str):
    """A named stretch of host time: a `record_function` range while a
    profiler runs, otherwise nothing.  It records no region boundary."""
    return record_function(name) if torch.autograd._profiler_enabled() else _NO_REGION


def annotate(name: str):
    """Named region for profiler attribution: `with annotate('encoder'): ...`.

    A `record_function` range while a profiler runs; otherwise nothing but
    the check (no range is opened, so the train step's host time is that
    of an unannotated step).  While `record_regions()` is active it also
    records the region's boundaries in the capture."""
    if _RECORDER is not None:
        return _RECORDER.region(name)
    return record_function(name) if torch.autograd._profiler_enabled() else _NO_REGION


def backward(loss: torch.Tensor) -> None:
    """`loss.backward()`.  While `record_regions()` is active, every
    autograd node of the loss's graph first gets a hook that records its
    forward region as backward at the capture's frontier."""
    rec = _RECORDER
    if rec is None:
        loss.backward()
        return
    rec.hook_graph(loss.grad_fn)
    rec.in_backward = True
    try:
        loss.backward()
    finally:
        rec.in_backward = False
        rec.mark(rec.path, "fwd")


class GraphRegions(NamedTuple):
    """The region of every work node of a captured graph."""

    # (kind: "kernel" | "memcpy" | "memset", the kernel's demangled name or
    #  None, region path, "fwd" | "bwd") of each work node, in the order of
    # execution where the graph is a chain, else in cudaGraphGetNodes' order
    nodes: Tuple[Tuple[str, Optional[str], RegionPath, str], ...]
    chain: bool  # one path of nodes: its work runs in `nodes`' order
    graph_nodes: int  # every node of the graph, work or not


class RegionRecorder:
    """The region boundaries of one capture.

    `frontier()` gives the capture's frontier (a tuple of node ids) or None
    where the current stream does not capture; `mark` records the region
    that work captured after that frontier belongs to."""

    def __init__(self, frontier: Callable[[], Optional[tuple]]):
        self.frontier = frontier
        self.path: RegionPath = ()  # the forward region path
        self.marks: List[Tuple[tuple, RegionPath, str]] = []
        self.in_backward = False
        self._seqs: List[int] = []  # autograd sequence number at each forward boundary
        self._seq_paths: List[RegionPath] = []

    def mark(self, path: RegionPath, where: str) -> None:
        f = self.frontier()
        if f is not None:
            self.marks.append((f, path, where))

    def _forward_boundary(self) -> None:
        self._seqs.append(torch._C._autograd._get_sequence_nr())
        self._seq_paths.append(self.path)
        self.mark(self.path, "fwd")

    @contextlib.contextmanager
    def region(self, name: str):
        profiled = (record_function(name) if torch.autograd._profiler_enabled()
                    else _NO_REGION)
        if self.in_backward:  # a checkpoint's recompute: the node's region holds it
            with profiled:
                yield
            return
        outer = self.path
        self.path = outer + (name,)
        self._forward_boundary()
        try:
            with profiled:
                yield
        finally:
            self.path = outer
            self._forward_boundary()

    def forward_path(self, seq: int, limit: int) -> RegionPath:
        """The forward region in which the autograd node numbered `seq`
        was made; () for a node not made in this capture's forward (at or
        past `limit`, the next number, such as `AccumulateGrad`'s)."""
        i = bisect.bisect_right(self._seqs, seq) - 1
        return self._seq_paths[i] if 0 <= i and seq < limit else ()

    def hook_graph(self, root) -> None:
        """A pre-hook on every node reachable from `root` that marks the
        node's forward region as backward."""
        limit = torch._C._autograd._get_sequence_nr()
        seen, todo = set(), [root] if root is not None else []
        while todo:
            node = todo.pop()
            if node in seen:
                continue
            seen.add(node)
            path = self.forward_path(node._sequence_nr(), limit)
            node.register_prehook(lambda grads, path=path: self.mark(path, "bwd"))
            todo.extend(n for n, _ in node.next_functions if n is not None)

    def place(self, order: Sequence) -> List[Tuple[RegionPath, str]]:
        """(region path, "fwd" | "bwd") of each node of `order` (node ids in
        an order of execution): that of the last mark recorded whose
        frontier (its latest node; an empty one lies before the first)
        lies before the node; ((), "fwd") before every mark.  A mark whose
        frontier holds no node of `order` places nothing."""
        pos = {n: i for i, n in enumerate(order)}
        at = sorted((max((pos[n] for n in f if n in pos), default=-1), k)
                    for k, (f, _, _) in enumerate(self.marks)
                    if not f or any(n in pos for n in f))
        out, j, last = [], 0, -1
        for i in range(len(order)):
            while j < len(at) and at[j][0] < i:
                last = max(last, at[j][1])
                j += 1
            out.append(self.marks[last][1:] if last >= 0 else ((), "fwd"))
        return out

    def walk(self, graph: "torch.cuda.CUDAGraph") -> GraphRegions:
        """The regions of `graph`'s work nodes (a graph captured with
        `keep_graph=True` while this recorder was active)."""
        lib = _library()
        g = ctypes.c_void_p(graph.raw_cuda_graph())
        chain = ctypes.c_int()
        n = lib.mmvae_graph_nodes(g, None, None, ctypes.addressof(chain), 0)
        if n < 0:
            raise RuntimeError(f"cudaGraphGetNodes / cudaGraphGetEdges: CUDA error {-n}")
        handles, kinds = (ctypes.c_ulonglong * n)(), (ctypes.c_int * n)()
        lib.mmvae_graph_nodes(g, ctypes.addressof(handles), ctypes.addressof(kinds),
                              ctypes.addressof(chain), n)
        places = self.place(list(handles))
        buf = ctypes.create_string_buffer(4096)
        nodes = []
        for h, kind, (path, where) in zip(handles, kinds, places):
            if kind not in WORK_KINDS:
                continue
            name = None
            if kind == 0 and lib.mmvae_graph_kernel_name(h, buf, len(buf)) >= 0:
                name = buf.value.decode(errors="replace")
            nodes.append((WORK_KINDS[kind], name, path, where))
        return GraphRegions(tuple(nodes), bool(chain.value), n)


# The active recorder: module-wide, since the `annotate` sites deep in the
# models hold no handle to it, and a checkpoint's recompute calls them from
# the autograd engine's thread.
_RECORDER: Optional[RegionRecorder] = None


def _library():
    from mmvae_torch.ops import _build

    return _build.library()


def capture_frontier() -> Optional[tuple]:
    """The frontier of the capture on the current CUDA stream, or None where
    it does not capture."""
    out = (ctypes.c_ulonglong * 64)()
    n = _library().mmvae_capture_frontier(torch.cuda.current_stream().cuda_stream,
                                          ctypes.addressof(out), len(out))
    if n == -2:
        raise RuntimeError("cudaStreamGetCaptureInfo failed")
    return tuple(out[:min(n, len(out))]) if n >= 0 else None


@contextlib.contextmanager
def record_regions(frontier: Callable[[], Optional[tuple]] = capture_frontier):
    """Record the boundaries of `annotate`'s regions and of the backward's
    nodes in the block (a CUDA graph capture); yields the
    `RegionRecorder`."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("record_regions is already active")
    _RECORDER = RegionRecorder(frontier)
    try:
        yield _RECORDER
    finally:
        _RECORDER = None
