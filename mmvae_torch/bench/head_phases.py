"""Where the Gaussian head's kernels spend a launch, phase by phase.

    python -m mmvae_torch.bench.head_phases [--reps 3]

Builds the kernel library through `ops/_build` with `-DHEAD_PHASE_TIMES`
added to its flags (`csrc/head_sample.cu`'s HEAD_PHASE stamps: the global
timer at the end of each phase, in the first CTA and the last CTA along
x), a library of its own beside the package's, runs the forward and the
backward at the sampling sites of configs 3 and 5 and at a latent width of
1024 (eps drawn, cotangents on mu, logvar and z), and prints each phase's
end in microseconds after the first CTA's start, for the last of `--reps`
launches.  Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes

SHAPES = ((64, 8192, 128, "bfloat16"), (16, 256, 128, "float32"), (160, 256, 64, "float32"),
          (64, 8192, 1024, "bfloat16"))
FORWARD = ("start", "ring issued", "chunks summed", "partials written", "ticket taken",
           "outputs written (last CTA of a tile)")
BACKWARD = ("start", "W issued", "D formed", "x^T formed", "operands landed", "dW",
            "dx", "dW written", "db written", "dx summed (last CTA of a K tile)")


def build():
    """The kernel library with the HEAD_PHASE stamps."""
    from mmvae_torch.ops import _build

    lib = _build.library(("-DHEAD_PHASE_TIMES",))
    lib.mmvae_head_phase_times.argtypes = [ctypes.c_void_p]
    return lib


def phases(dll, shape, reps: int) -> dict:
    """{"forward" | "backward": {"first" | "last": [us after the first CTA's
    start, by phase]}} of the last of `reps` launches at (M, K, N, x dtype)."""
    import numpy as np
    import torch

    from mmvae_torch.ops import head_kernels as hk
    from mmvae_torch.ops import kernel_checks as kc

    m, k, n, xdt = shape
    xdt = getattr(torch, xdt)
    dev = torch.device("cuda")
    geo = hk.head_geometry(m, k, n, torch.finfo(xdt).bits // 8)
    x, w_mu, b_mu, w_lv, b_lv = kc.head_inputs(dev, m, k, n, xdt, 40)
    cots = kc.head_cotangents(dev, m, n, 41)[1:]
    f32 = dict(device=dev, dtype=torch.float32)
    outs = [torch.empty(m, n, **f32) for _ in range(4)]
    splits, tiles_n, tiles_m = geo["fwd_grid"]
    partials = torch.empty(tiles_n * tiles_m * splits * 64 * 16, **f32)
    tiles, blocks = geo["bwd_grid"]
    tickets = torch.zeros(max(tiles, tiles_n * tiles_m), device=dev, dtype=torch.int32)
    dx = torch.empty_like(x)
    dw = [torch.empty(n, k, **f32) for _ in range(2)]
    db = [torch.empty(n, **f32) for _ in range(2)]
    scratch = torch.empty(max(tiles * blocks * m * 64, 1), **f32)
    code = 1 if xdt == torch.bfloat16 else 0
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(reps):
        err = dll.mmvae_head_sample_fwd(
            x.data_ptr(), w_mu.data_ptr(), b_mu.data_ptr(), w_lv.data_ptr(), b_lv.data_ptr(),
            None, *(o.data_ptr() for o in outs), partials.data_ptr(), tickets.data_ptr(), m, k,
            n, code, 7, None, 0, 0, stream)
        err = err or dll.mmvae_head_sample_bwd(
            x.data_ptr(), w_mu.data_ptr(), w_lv.data_ptr(), outs[3].data_ptr(),
            *(t.data_ptr() for t in cots), dx.data_ptr(), dw[0].data_ptr(), dw[1].data_ptr(),
            db[0].data_ptr(), db[1].data_ptr(), scratch.data_ptr(), tickets.data_ptr(), m, k, n,
            code, stream)
        if err:
            raise RuntimeError(f"head kernels at {shape}: CUDA error {err}")
        torch.cuda.synchronize()
    t = np.zeros((2, 2, 16), np.uint64)
    if dll.mmvae_head_phase_times(t.ctypes.data):
        raise RuntimeError("reading the phase times failed")
    res = {}
    for kernel, names in ((0, FORWARD), (1, BACKWARD)):
        base = int(t[kernel, 0, 0])
        res[("forward", "backward")[kernel]] = {
            cta: [round((int(v) - base) / 1e3, 3) if int(v) >= base else None
                  for v in t[kernel, i, :len(names)]]
            for i, cta in enumerate(("first", "last"))}
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dll = build()
    for shape in SHAPES:
        res = phases(dll, shape, args.reps)
        for kernel, names in (("forward", FORWARD), ("backward", BACKWARD)):
            for cta, ends in res[kernel].items():
                cells = [f"{nm} {v}" for nm, v in zip(names, ends) if v is not None]
                print(f"[head_phases] {shape} {kernel}, {cta} CTA, us: " + "; ".join(cells))


if __name__ == "__main__":
    main()
