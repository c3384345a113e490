"""The general ConvLSTM kernels' launches, one by one, on the card.

    python -m mmvae_torch.bench.general_profile [--calls 3] [--phases]

For each full-width shape of the general route (`SHAPES`: the 16x16 grid at
F = 128 with bf16 and f32 activations, the lstm_features=192 probe in f32),
runs K5's saving forward and backward and K6's (time-constant xg, per-step
dhs) under `torch.profiler` and prints every CUDA kernel each call launches
with its device milliseconds a call (the recurrence, the dbx reduce, dx, the
weight GEMM and its split reduce), bf16 gates as the configs run them.  Then
prints what ptxas said of the general kernels (registers, spills) where
this process built the library.  `--phases` builds the library with
`-DGEN_PHASE_TIMES` (a library of its own: `ops/_build.library(defines)`)
and prints, for K6's forward and BPTT at each shape, the clock cycles a
step of thread 0 of the first CTA by phase (forward: the slabs' products,
the waits for the ring, the pass's last slab, the epilogue, the exchange
of h; BPTT: the pointwise pass, the products, the reduction of dh and its
barriers).  Prints one JSON line at the end.  Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from collections import defaultdict

# (B, T, H, W, C, F), activations
SHAPES = (((64, 20, 16, 16, 128, 128), "bfloat16"), ((64, 20, 16, 16, 128, 128), "float32"),
          ((64, 20, 8, 8, 128, 192), "float32"))


def _per_kernel(fn, calls: int) -> dict:
    """{kernel name: device ms a call} of `calls` calls of `fn`."""
    from mmvae_torch.bench.profile import profile_calls

    fn()
    kernels, _, _ = profile_calls(fn, calls)
    out = defaultdict(float)
    for e in kernels:
        out[e.name[:120]] += (e.time_range.end - e.time_range.start) / 1e3 / calls
    return {k: round(v, 4) for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def ptxas_lines(log: str, marker: str = "gen_") -> list:
    """ptxas's register and spill lines of the kernels whose mangled name
    holds `marker`, each after its kernel's name."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else None
        elif entry and marker in entry and ("registers" in line or "spill" in line):
            out.append(f"{entry[entry.find(marker):][:60]}: {line.split(':', 2)[-1].strip()}")
    return out


_FWD_PHASES = ("slabs", "ring waits", "last slab", "epilogue", "exchange")
_BWD_PHASES = ("pointwise", "products", "reduce")


def phase_cycles(dev, calls: int) -> dict:
    """{row: {phase: cycles a step}} of K6 at `SHAPES` through the
    GEN_PHASE_TIMES library (bf16 gates, time-constant xg)."""
    import torch

    from mmvae_torch.ops import _build
    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import kernel_checks as kc

    lib = _build.library(("-DGEN_PHASE_TIMES",))
    read = lib.lib.mmvae_gen_phase_times
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    kept = _build.library
    _build.library = lambda defines=(): lib
    ck._checked_route.cache_clear()
    ck._general_layout.cache_clear()

    def cycles():
        buf = (ctypes.c_ulonglong * 16)()
        torch.cuda.synchronize()
        _build.check(read(buf), "mmvae_gen_phase_times")
        return list(buf)

    out = {}
    try:
        for (b, t, h, w, _, f), act_name in SHAPES:
            act, bf16 = getattr(torch, act_name), torch.bfloat16
            xg, wh, c0, h0 = kc.scan_inputs(dev, b, 1, h, w, f, seed=10, dtype=act)
            res = ck.scan_forward_cuda(xg, wh, c0, h0, t, bf16, "save")
            dhs = torch.randn(res[0].shape, device=dev)
            for name, fn, names, first in (
                    ("K6 fwd", lambda: ck.scan_forward_cuda(xg, wh, c0, h0, t, bf16, "save"),
                     _FWD_PHASES, 0),
                    ("K6 bwd", lambda: ck.scan_backward_cuda(wh, c0, h0, *res, dhs, dhs[:, -1],
                                                             True, False), _BWD_PHASES, 8)):
                cycles()
                for _ in range(calls):
                    fn()
                got = cycles()
                key = f"{name} {(b, t, h, w, f)} {act_name}"
                out[key] = {n: round(got[first + i] / (calls * t)) for i, n in enumerate(names)}
                print(f"[general_profile] phases {key}, cycles a step: {out[key]}")
    finally:
        _build.library = kept
        ck._checked_route.cache_clear()
        ck._general_layout.cache_clear()
    return out


def main(argv=None) -> None:
    import torch

    from mmvae_torch.ops import _build
    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import kernel_checks as kc

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--phases", action="store_true",
                    help="the phase timers' cycles a step (a GEN_PHASE_TIMES build)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("general_profile measures a CUDA device; none is available")
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    lib = _build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[general_profile] card: {smi}")
    result = {"device": torch.cuda.get_device_name(0), "card": smi, "rows": {}}
    for shape, act_name in SHAPES:
        act = getattr(torch, act_name)
        b, t, h, w_, c, f = shape
        x, wx, bx, w, c0, h0 = kc.proj_inputs(dev, *shape, seed=6, dtype=act)
        res = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, bf16, True)
        dh = torch.randn(c0.shape, device=dev)
        xg, wh, sc0, sh0 = kc.scan_inputs(dev, b, 1, h, w_, f, seed=10, dtype=act)
        sres = ck.scan_forward_cuda(xg, wh, sc0, sh0, t, bf16, "save")
        dhs = torch.randn(sres[0].shape, device=dev)
        calls = {
            "K5 fwd": lambda: ck.proj_forward_cuda(x, wx, bx, w, c0, h0, bf16, True),
            "K5 bwd": lambda: ck.proj_backward_cuda(x, wx, w, c0, h0, *res, dh, dh),
            "K6 fwd": lambda: ck.scan_forward_cuda(xg, wh, sc0, sh0, t, bf16, "save"),
            "K6 bwd": lambda: ck.scan_backward_cuda(wh, sc0, sh0, *sres, dhs, dhs[:, -1], True,
                                                    False),
        }
        for name, fn in calls.items():
            row = _per_kernel(fn, args.calls)
            key = f"{name} {shape} {act_name}"
            result["rows"][key] = row
            print(f"[general_profile] {key}: total {sum(row.values()):.3f} ms a call")
            for kname, ms in row.items():
                print(f"[general_profile]   {ms:9.4f} ms  {kname}")
        del res, sres
        torch.cuda.empty_cache()
    lines = ptxas_lines(lib.log)
    for line in lines:
        print(f"[general_profile] ptxas {line}")
    if not lines:
        print("[general_profile] ptxas: the library was not built in this process")
    result["ptxas"] = lines
    if args.phases:
        result["phases"] = phase_cycles(dev, args.calls)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
