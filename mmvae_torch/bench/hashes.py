"""The bf16 ConvLSTM kernels' outputs hashed, to hold two checkouts bit-identical.

    python -m mmvae_torch.bench.hashes OTHER_ROOT

OTHER_ROOT is the root of another checkout of the repository, for example
an earlier commit unpacked with `git archive` into a directory that
`.gitignore` lists.  One process per checkout (other, this) imports that
checkout's `mmvae_torch` and hashes (sha256) every output of K5 and K6 with
bf16 activations at three shapes each (`K5_SHAPES`, `K6_SHAPES`), from
seeded inputs, both gate dtypes: K5's saving and residual-free forwards and
its backward; K6's "save", "hs" and "last" forwards and its backward with
per-step dhs and with dh_T once.  It prints both runs' digests and whether
they are equal, and exits 1 where they differ.  `digests()` is what each
run computes; `chip_smoke.py` prints it for the tree.  Fails without a CUDA
device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

# (B, T, H, W, C, F): unaligned positions, config 3, config 5's batch
K5_SHAPES = ((3, 7, 5, 6, 48, 32), (64, 20, 8, 8, 128, 128), (160, 10, 8, 8, 128, 128))
# (B, T, H, W, F, const xg): unaligned, config 4's decoder, the streaming encoder
K6_SHAPES = ((3, 7, 5, 6, 32, True), (64, 10, 8, 8, 128, True), (64, 20, 8, 8, 128, False))


def _digest(tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def digests() -> dict:
    """{"K5 shape gates": sha256, "K6 shape gates": sha256} of the bf16
    kernels' outputs, through the wrappers of the `mmvae_torch` on sys.path."""
    import torch

    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import kernel_checks as kc

    dev = torch.device("cuda")
    out = {}
    for gdt in (torch.float32, torch.bfloat16):
        for shape in K5_SHAPES:
            x, wx, bx, w, c0, h0 = kc.proj_inputs(dev, *shape, seed=6)
            res = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, gdt, True)
            last = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, gdt, False)
            g = torch.Generator(device=dev).manual_seed(7)
            dh = torch.randn(c0.shape, generator=g, device=dev)
            dc = torch.randn(c0.shape, generator=g, device=dev)
            grads = ck.proj_backward_cuda(x, wx, w, c0, h0, *res, dh, dc)
            out[f"K5 {shape} gates {gdt}"] = _digest((*res, *last, *grads))
        for b, t, h, w_, f, const in K6_SHAPES:
            xg, wh, c0, h0 = kc.scan_inputs(dev, b, 1 if const else t, h, w_, f, seed=10)
            res = ck.scan_forward_cuda(xg, wh, c0, h0, t, gdt, "save")
            hs = ck.scan_forward_cuda(xg, wh, c0, h0, t, gdt, "hs")
            last = ck.scan_forward_cuda(xg, wh, c0, h0, t, gdt, "last")
            g = torch.Generator(device=dev).manual_seed(11)
            dhs = torch.randn(res[0].shape, generator=g, device=dev)
            dc = torch.randn(c0.shape, generator=g, device=dev)
            grads = [t_ for last_only in (False, True) for t_ in ck.scan_backward_cuda(
                wh, c0, h0, *res, dhs[:, -1] if last_only else dhs, dc, const, last_only)]
            out[f"K6 {(b, t, h, w_, f, const)} gates {gdt}"] = _digest(
                (*res, *hs, *last, *grads))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout (in a worker: its own root)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(digests()))
        return 0
    here = Path(__file__).resolve().parents[2]
    runs = []
    for root in (Path(args.other).resolve(), here):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", str(root)],
            cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"the run in {root} failed ({proc.returncode}):\n"
                               f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    differ = [k for k in runs[1] if runs[0].get(k) != runs[1][k]]
    for key, value in runs[1].items():
        note = "equal" if key not in differ else f"DIFFERS from {runs[0].get(key, 'absent')}"
        print(f"[hashes] {key}: {value} ({note} in {args.other})")
    print(f"[hashes] bf16 K5 and K6 outputs at {len(K5_SHAPES)} + {len(K6_SHAPES)} shapes, "
          f"both gate dtypes: {'bit-identical' if not differ else f'{len(differ)} differ'}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.path[0] = os.getcwd()  # run by path in a worker: import the checkout it runs in
    sys.exit(main())
