"""Device timers, and the Gaussian head region timed beside the route it replaced.

`chip_smoke.py` and `bench.ab` both time through this module; `bench.ab`
loads it by path, so the same timers run in every checkout it compares.
It imports nothing of the package at import time.  Fails without a CUDA
device.
"""

from __future__ import annotations

GRAPH_CALLS = 20


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds a call by CUDA events around `iters` calls back to back
    (the host's launch path included where it is the longer)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(calls, reps: int = 10) -> float:
    """Device time of one call: a CUDA graph of the calls in `calls`, in
    order, replayed `reps` times between two CUDA events, so the host's
    launch path is not timed (the tiny kernels take tens of microseconds,
    less than a launch from Python).  Where each call reads its own copy of
    the inputs, the 19 calls between two reads of one copy move more than
    the card's 50 MB of L2, so every call reads its inputs from HBM, as the
    bound counts them; one call repeated reads them from L2."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(calls) * reps)


def head_region_ms(dev, shape, seed: int = 12345):
    """The head region at (M, K, N, x dtype) in CUDA graphs of GRAPH_CALLS
    calls, each on its own copy of the inputs (`kernel_checks.head_inputs`,
    cold L2): {"fused_fwd", "fused_bwd": each kernel alone;
    "fused_fwd_bwd": the op through autograd; "parent_fwd",
    "parent_fwd_bwd", "parent_bwd" (their difference): the route the
    fused op replaced, a cast, two F.linear and the Triton K2, with its
    autograd backward}, ms a call.  None in a checkout without the fused
    head."""
    import torch
    import torch.nn.functional as F

    try:
        from mmvae_torch.ops import head_kernels as hk
        from mmvae_torch.ops import kernel_checks as kc
        from mmvae_torch.ops.elbo_kernels import reparameterize
    except ImportError:
        return None
    m, k, n, x_dtype = shape
    copies = [kc.head_inputs(dev, m, k, n, x_dtype, 40 + i) for i in range(GRAPH_CALLS)]
    cots = kc.head_cotangents(dev, m, n, 41)[1:]
    diffs = [hk.head_sample_forward_cuda(*c, seed)[3] for c in copies]
    res = {
        "fused_fwd": graph_ms([lambda c=c: hk.head_sample_forward_cuda(*c, seed) for c in copies]),
        "fused_bwd": graph_ms([lambda c=c, d=d: hk.head_sample_backward_cuda(
            c[0], c[1], c[3], d, *cots) for c, d in zip(copies, diffs)]),
    }
    del diffs
    leaves = [[t.detach().clone().requires_grad_() for t in c] for c in copies]

    def parent(c, backward):  # the route before the fusion, in the models' order
        xf = c[0].float()
        mu, lv = F.linear(xf, c[1], c[2]), F.linear(xf, c[3], c[4])
        z = reparameterize(mu, lv, seed)
        if backward:
            torch.autograd.backward((mu, lv, z), cots)

    res["fused_fwd_bwd"] = graph_ms([lambda c=c: torch.autograd.backward(
        hk.gaussian_head_sample(*c, seed), cots) for c in leaves])
    res["parent_fwd"] = graph_ms([lambda c=c: parent(c, False) for c in leaves])
    res["parent_fwd_bwd"] = graph_ms([lambda c=c: parent(c, True) for c in leaves])
    res["parent_bwd"] = res["parent_fwd_bwd"] - res["parent_fwd"]
    return res
