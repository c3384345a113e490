"""mmvae_torch.data.feed.DeviceFeed on the CPU: what it hands over, its
errors and its shutdown.  Its CUDA path (pinned ring, side stream, events)
is held on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import itertools
import time

import numpy as np
import pytest
import torch

from mmvae_torch.data.feed import DeviceFeed
from mmvae_torch.data.loader import MovingMNIST, generate_moving_mnist


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_order_and_bytes_equal_the_host_iterator(depth):
    ds = MovingMNIST(data=generate_moving_mnist(24, seq_len=5, seed=0))
    want = list(itertools.islice(ds.batches(4, seed=3, num_epochs=2), 100))
    with DeviceFeed(ds.batches(4, seed=3, num_epochs=2), "cpu", depth=depth) as feed:
        got = list(feed)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert a.dtype == torch.uint8 and a.device.type == "cpu"
        assert np.array_equal(a.numpy(), b)


def test_an_iterator_error_is_raised_on_the_consumer_side():
    def host():
        yield np.zeros((2, 3), np.uint8)
        raise OSError("disk gone")

    feed = DeviceFeed(host(), "cpu")
    assert next(feed).shape == (2, 3)
    with pytest.raises(OSError, match="disk gone"):
        next(feed)
    with pytest.raises(OSError, match="disk gone"):
        next(feed)  # a later call raises too, it does not block
    feed.stop()


def test_stop_early_joins_and_is_idempotent():
    """An endless stream stopped after two batches: the worker, blocked on a
    full queue, ends within the join; a second stop is harmless."""
    def endless():
        for k in itertools.count():
            yield np.full((2, 2), k % 256, np.uint8)

    feed = DeviceFeed(endless(), "cpu", depth=2)
    assert [int(next(feed)[0, 0]) for _ in range(2)] == [0, 1]
    time.sleep(0.05)  # let the worker fill the queue and block
    t0 = time.perf_counter()
    feed.stop()
    feed.stop()
    assert time.perf_counter() - t0 < 5.0
    assert not feed._thread.is_alive()
