"""Two checkouts of the package timed side by side on one card.

    python -m mmvae_torch.bench.ab OTHER_ROOT [--steps 10] [--kernels-only]

OTHER_ROOT is the root of another checkout of the repository, for example
an earlier commit unpacked with `git archive` into a directory that
`.gitignore` lists.  In the order other, this, this, other, one process per
run imports that checkout's `mmvae_torch` and measures K5 and K6 forward
(saving residuals) and backward at the path shapes (CUDA events over 20
calls, bf16 gates) and hashes K5's outputs (forward and gradients, from
seeded inputs) so that the two checkouts' K5 can be held bit-identical; the
wall time of a K5 forward and backward call at one step of one sample,
where the wrappers' host work and the launches take the time; the
Gaussian head region at each sampling site (`HEAD_SHAPES`), where the
checkout has the fused head (`bench/timing.head_region_ms`: each kernel
alone, the op through autograd, and the route it replaced, a cast, two
F.linear and the Triton K2, on the same inputs); K5 and K6 on the general
route at `GENERAL_SHAPES` (the 16x16 grid at full width, bf16 and f32, and
the lstm_features=192 probe in f32: forward saving residuals and backward,
bf16 gates, K6 time-constant); with `--probe`, `run_benchmark` of the probe
in f32 (`PROBE_F32`) at K = 1 and 10; and
`bench.profile.profile_train_step` of each path (config 3; configs 4 and 5
with fused=true; config 3 with fused=true; configs 1 and 2; not with
`--kernels-only`).  Every run times with this
tree's `bench/timing.py`, loaded by path.  Each run prints one JSON line,
then one line per path sums it up.  Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# (B, T, H, W, C, F): K5 on configs 3, 4 and 5
K5_SHAPES = ((64, 20, 8, 8, 128, 128), (64, 10, 8, 8, 128, 128), (160, 10, 8, 8, 128, 128))
# (B, T, H, W, F, const xg): K6 as the decoders of configs 4, 5 and 3 fused
# run it (per-step dhs), and enc_x_kernel=3's streaming last-only encoder
K6_SHAPES = ((64, 10, 8, 8, 128, True), (160, 10, 8, 8, 128, True), (64, 20, 8, 8, 128, True),
             (64, 20, 8, 8, 128, False))
# (M, K, N, x dtype): the heads of configs 3 and 4, config 5's global and chunk heads
HEAD_SHAPES = ((64, 8192, 128, "bfloat16"), (16, 256, 128, "float32"),
               (160, 256, 64, "float32"))
# (B, T, H, W, C, F, activations): the general route's full-width rows
GENERAL_SHAPES = ((64, 20, 16, 16, 128, 128, "bfloat16"), (64, 20, 16, 16, 128, 128, "float32"),
                  (64, 20, 8, 8, 128, 192, "float32"))
# the reference's lstm_features=192 probe (recipe) at the JAX package's f32
PROBE_F32 = ("model.kwargs.dec_upsample=fast_mid", "data.on_device_generate=true",
             "optim.ema_decay=0.999", "model.kwargs.lstm_features=192", "model.dtype=float32")
PATHS = (("seq_vae", ()), ("pred_vae", ("model.kwargs.fused=true",)),
         ("hier_vae", ("model.kwargs.fused=true",)), ("seq_vae", ("model.kwargs.fused=true",)),
         ("mlp_vae", ()), ("conv_vae", ()))


# this tree's timers, whichever checkout the worker imports the package from
_spec = importlib.util.spec_from_file_location("_mmvae_bench_timing",
                                               Path(__file__).with_name("timing.py"))
timing = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(timing)


def _time_ms(fn) -> float:
    return timing.event_ms(fn, 20)


def _host_ms(fn, iters: int = 200) -> float:
    """Milliseconds a call on the host clock, synchronized at the ends only."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def measure(steps: int, paths=PATHS, probe: bool = False) -> dict:
    """K5 and K6 times (wgmma and general routes), the probe's benchmark
    and the paths' profiles, with the `mmvae_torch` on sys.path."""
    import torch

    from mmvae_torch.bench.profile import profile_train_step
    from mmvae_torch.configs import get_config
    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import kernel_checks as kc

    dev = torch.device("cuda")
    out = {"root": os.getcwd(), "k5_fwd_bwd_ms": {}, "k5_sha256": {}, "k6_fwd_bwd_ms": {},
           "profiles": {}}
    for shape in K5_SHAPES:
        x, wx, bx, w, c0, h0 = kc.proj_inputs(dev, *shape, seed=6)
        hs, cs, ga = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, torch.bfloat16, True)
        dh = torch.randn(c0.shape, device=dev)
        out["k5_fwd_bwd_ms"][str(shape)] = [
            _time_ms(lambda: ck.proj_forward_cuda(x, wx, bx, w, c0, h0, torch.bfloat16, True)),
            _time_ms(lambda: ck.proj_backward_cuda(x, wx, w, c0, h0, hs, cs, ga, dh, dh)),
        ]
        dh = torch.randn(c0.shape, generator=torch.Generator(device=dev).manual_seed(7),
                         device=dev)
        digest = hashlib.sha256()
        for t in (hs, cs, ga, *ck.proj_backward_cuda(x, wx, w, c0, h0, hs, cs, ga, dh, dh)):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        out["k5_sha256"][str(shape)] = digest.hexdigest()
    for b, t, h, w_, f, const in K6_SHAPES:
        xg, wh, c0, h0 = kc.scan_inputs(dev, b, 1 if const else t, h, w_, f, seed=10)
        res = ck.scan_forward_cuda(xg, wh, c0, h0, t, torch.bfloat16, "save")
        dhs = torch.randn(res[0].shape, device=dev)
        dh = dhs if const else dhs[:, -1]  # the streaming encoder returns h_T alone
        out["k6_fwd_bwd_ms"][str((b, t, h, w_, f, const))] = [
            _time_ms(lambda: ck.scan_forward_cuda(xg, wh, c0, h0, t, torch.bfloat16, "save")),
            _time_ms(lambda: ck.scan_backward_cuda(wh, c0, h0, *res, dh, dhs[:, -1], const,
                                                   not const)),
        ]
    # the wrappers' host path: at one step of one sample the kernels are short
    x, wx, bx, w, c0, h0 = kc.proj_inputs(dev, 1, 1, 8, 8, 16, 16, seed=6)
    hs, cs, ga = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, torch.bfloat16, True)
    dh = torch.randn(c0.shape, device=dev)
    out["k5_host_fwd_bwd_ms"] = [
        _host_ms(lambda: ck.proj_forward_cuda(x, wx, bx, w, c0, h0, torch.bfloat16, True)),
        _host_ms(lambda: ck.proj_backward_cuda(x, wx, w, c0, h0, hs, cs, ga, dh, dh)),
    ]
    out["general_ms"] = {}
    for *shape, act_name in GENERAL_SHAPES:
        act = getattr(torch, act_name)
        b, t, h, w_, _, f = shape
        x, wx, bx, w, c0, h0 = kc.proj_inputs(dev, *shape, seed=6, dtype=act)
        res = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, torch.bfloat16, True)
        dh = torch.randn(c0.shape, device=dev)
        xg, wh, sc0, sh0 = kc.scan_inputs(dev, b, 1, h, w_, f, seed=10, dtype=act)
        sres = ck.scan_forward_cuda(xg, wh, sc0, sh0, t, torch.bfloat16, "save")
        dhs = torch.randn(sres[0].shape, device=dev)
        out["general_ms"][str((*shape, act_name))] = [timing.event_ms(fn, 3, 1) for fn in (
            lambda: ck.proj_forward_cuda(x, wx, bx, w, c0, h0, torch.bfloat16, True),
            lambda: ck.proj_backward_cuda(x, wx, w, c0, h0, *res, dh, dh),
            lambda: ck.scan_forward_cuda(xg, wh, sc0, sh0, t, torch.bfloat16, "save"),
            lambda: ck.scan_backward_cuda(wh, sc0, sh0, *sres, dhs, dhs[:, -1], True, False))]
        del res, sres
        torch.cuda.empty_cache()
    if probe:
        from mmvae_torch.bench.throughput import run_benchmark

        out["probe_f32"] = {}
        for k in (1, 10):
            r = run_benchmark(get_config("seq_vae", (*PROBE_F32, f"train.steps_per_call={k}")),
                              steps=20, warmup=10, device_profile=True)
            out["probe_f32"][k] = {key: r[key] for key in (
                "value", "value_min", "value_max", "step_ms", "device_busy_ms", "idle_share",
                "tflops_per_sec_chip", "mfu", "card")}
            torch.cuda.empty_cache()
    heads = {str(shape): timing.head_region_ms(dev, (*shape[:3], getattr(torch, shape[3])))
             for shape in HEAD_SHAPES}
    if all(heads.values()):
        out["head_ms"] = {key: {k: round(v, 5) for k, v in res.items()}
                          for key, res in heads.items()}
    for name, overrides in paths:
        res = profile_train_step(get_config(name, overrides), steps=steps, top=6)
        out["profiles"][" ".join((name, *overrides))] = res
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout (in a worker: its own root)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels and the head, not the paths' profiles")
    ap.add_argument("--probe", action="store_true",
                    help="run_benchmark of the probe in f32 at K = 1 and 10 in each run")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(measure(args.steps, () if args.kernels_only else PATHS, args.probe)))
        return
    here = Path(__file__).resolve().parents[2]
    other = Path(args.other).resolve()
    runs = []
    for root in (other, here, here, other):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", "--steps",
             str(args.steps), *(["--kernels-only"] if args.kernels_only else []),
             *(["--probe"] if args.probe else []), str(root)],
            cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"the run in {root} failed ({proc.returncode}):\n"
                               f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for path in runs[0]["profiles"]:
        cells = [f"{Path(r['root']).name}: "
                 + " ".join(f"{k} {r['profiles'][path][k]}" for k in
                            ("step_ms", "frames_per_sec", "device_busy_ms", "idle_share",
                             "kernel_launches_per_step"))
                 for r in runs]
        print(f"[ab] {path}: " + "; ".join(cells))
    print("[ab] K5 host ms a call (1 x 1 x 8x8, C=F=16), fwd, bwd: "
          + "; ".join(f"{Path(r['root']).name}: {r['k5_host_fwd_bwd_ms']}" for r in runs))
    same = all(r["k5_sha256"] == runs[0]["k5_sha256"] for r in runs)
    from mmvae_torch.bench.roofline import bound

    print(f"[ab] K5 outputs (forward and gradients, bf16 gates) at {len(K5_SHAPES)} shapes: "
          f"{'bit-identical in every run' if same else 'DIFFER between runs'}")
    for shape in next((r["head_ms"] for r in runs if "head_ms" in r), {}):
        print(f"[ab] head {shape} ms: " + "; ".join(
            f"{Path(r['root']).name}: {r['head_ms'][shape]}" for r in runs if "head_ms" in r))
        # both checkouts' kernels against this tree's bound (one yardstick)
        m, k, n, xdt = ast.literal_eval(shape)
        key = (m, k, n, 2 if xdt == "bfloat16" else 4)
        for kernel, col in (("forward", "fused_fwd"), ("backward", "fused_bwd")):
            ms, by = bound(f"head_sample_{kernel}", key)
            print(f"[ab] head {shape} {kernel}: bound {ms:.5f} ms ({by}); share " + "; ".join(
                f"{Path(r['root']).name}: {100 * ms / r['head_ms'][shape][col]:.1f} %"
                for r in runs if "head_ms" in r))
    for kernel in ("k5", "k6"):
        for shape in runs[0][f"{kernel}_fwd_bwd_ms"]:
            print(f"[ab] {kernel.upper()} {shape} fwd, bwd ms: " + "; ".join(
                f"{Path(r['root']).name}: {r[f'{kernel}_fwd_bwd_ms'][shape]}" for r in runs))
    names = ("convlstm_proj_forward", "convlstm_proj_backward", "convlstm_scan_forward",
             "convlstm_scan_backward")
    for key in runs[0]["general_ms"]:
        b, t, h, w, c, f, act = ast.literal_eval(key)
        es = 2 if act == "bfloat16" else 4
        shapes = ((b, t, h, w, c, f, es),) * 2 + ((b, t, h, w, f, True, es),) * 2
        for i, (name, shape) in enumerate(zip(names, shapes)):
            ms, by = bound(name, shape)
            print(f"[ab] general {name} {key}: bound {ms:.4f} ms ({by}); " + "; ".join(
                f"{Path(r['root']).name}: {r['general_ms'][key][i]:.3f} ms "
                f"({100 * ms / r['general_ms'][key][i]:.2f} %)" for r in runs))
    for k in (runs[0].get("probe_f32") or {}):
        print(f"[ab] probe f32 K={k}: " + "; ".join(
            f"{Path(r['root']).name}: {json.dumps(r['probe_f32'][k])}" for r in runs))


if __name__ == "__main__":
    sys.path[0] = os.getcwd()  # run by path in a worker: import the checkout it runs in
    main()
