"""Host-side prefetching feed: host u8 batches -> device tensors (port of
mmvae_tpu/data/feed.py).

A background thread stages batches k+1..k+depth while the device runs step
k.  On a CUDA device each batch goes host -> a pinned buffer -> the card by
a `non_blocking` copy on a side stream: a ring of `depth + 1` pinned
buffers, each refilled only after its previous copy's event has completed,
and each device batch handed over with its copy's event, which the
consumer's stream waits on, and `record_stream`, so the caching allocator
does not reuse its memory while the consumer's kernels may still read it.
On the CPU the feed hands over the host batches as CPU tensors.  The queue
is bounded (backpressure); a sentinel ends the stream, and an exception
raised by the host iterator or the copies is raised on the consumer's
side.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


class DeviceFeed:
    """Background-thread prefetcher: host numpy batches -> tensors on `device`.

    Args:
      host_iter: yields host (numpy) batches, e.g. `MovingMNIST.batches(...)`.
      device: where the batches go (the card unless the caller names the CPU).
      depth: batches in flight (2 = double buffering).
    """

    def __init__(self, host_iter: Iterator[np.ndarray], device="cuda", depth: int = 2):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._ring = max(depth, 1) + 1
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, args=(host_iter,),
                                        name="DeviceFeed", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, host_iter: Iterator[np.ndarray]) -> None:
        try:
            if self.device.type == "cuda":
                self._cuda_worker(host_iter)
            else:
                for batch in host_iter:
                    if self._stop.is_set() or not self._put(
                            (torch.from_numpy(np.ascontiguousarray(batch)), None)):
                        return
        except BaseException as e:  # raised on the consumer's side
            self._err = e
        finally:
            self._put(_SENTINEL)

    def _cuda_worker(self, host_iter: Iterator[np.ndarray]) -> None:
        torch.cuda.set_device(self.device)
        stream = torch.cuda.Stream(self.device)
        slots = [None] * self._ring  # (pinned buffer, event of its last copy)
        for k, batch in enumerate(host_iter):
            if self._stop.is_set():
                return
            src = torch.from_numpy(np.ascontiguousarray(batch))
            i = k % self._ring
            if slots[i] is not None:
                pinned, copied = slots[i]
                copied.synchronize()  # the buffer's previous copy has read it
                if pinned.shape != src.shape or pinned.dtype != src.dtype:
                    slots[i] = None
            if slots[i] is None:
                slots[i] = (torch.empty(src.shape, dtype=src.dtype, pin_memory=True), None)
            pinned = slots[i][0]
            pinned.copy_(src)
            with torch.cuda.stream(stream):
                dev = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                dev.copy_(pinned, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            slots[i] = (pinned, done)
            if not self._put((dev, done)):
                return

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        item = self._q.get()
        if item is _SENTINEL:
            self._q.put(_SENTINEL)  # a later call ends too
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            batch.record_stream(consumer)
        return batch

    def stop(self) -> None:
        """Stop the worker and drain the queue; safe to call more than once."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
