"""The ConvLSTM kernels' outputs hashed, to hold two checkouts bit-identical.

    python -m mmvae_torch.bench.hashes OTHER_ROOT

OTHER_ROOT is the root of another checkout of the repository, for example
an earlier commit unpacked with `git archive` into a directory that
`.gitignore` lists.  One process per checkout (other, this) imports that
checkout's `mmvae_torch` and hashes (sha256) every output of K5 and K6 with
bf16 activations at three shapes each (`K5_SHAPES`, `K6_SHAPES`) and with
f32 activations at configs 3-5's shapes (`F32_K5_SHAPES`, `F32_K6_SHAPES`),
from seeded inputs, both gate dtypes: K5's saving and residual-free
forwards and its backward; K6's "save", "hs" and "last" forwards and its
backward with per-step dhs and with dh_T once.  It hashes the Gaussian
head's forward (eps drawn from a seed) and backward at the sampling sites
(`HEAD_SHAPES`), and the loss and every gradient of one step of two paths
(`PATHS`: config 1, whose only kernels of the repo are the head and K1,
and config 3, whose K5 has bf16 gates) at full width on a small seeded
input with eps injected, each run twice in the worker with cuDNN
deterministic ("not reproducible" where the two differ).  It prints both runs'
digests and whether they are equal, then how far K5's bf16 forward at
config 3's shape moved between the checkouts (`FORWARD_SHAPE`: hs, cs and
the gates, both gate dtypes; the largest difference in bf16 ulps of the
other checkout's largest magnitude and the share of elements that differ),
and exits 1 where the digests differ.  `digests()` is what each
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
# f32 activations: config 3 and config 5's batch of 160 (K5); config 4's
# decoder, the streaming encoder and config 5's decoder (K6)
F32_K5_SHAPES = ((64, 20, 8, 8, 128, 128), (160, 10, 8, 8, 128, 128))
F32_K6_SHAPES = ((64, 10, 8, 8, 128, True), (64, 20, 8, 8, 128, False),
                 (160, 10, 8, 8, 128, True))
# K5's bf16 forward compared element by element between the checkouts
FORWARD_SHAPE = (64, 20, 8, 8, 128, 128)
# (M, K, N, x dtype): the head at configs 3, 5 (two), 1 and 2, and unaligned
HEAD_SHAPES = ((64, 8192, 128, "bfloat16"), (16, 256, 128, "float32"),
               (160, 256, 64, "float32"), (64, 512, 20, "float32"),
               (128, 4096, 64, "float32"), (5, 37, 3, "bfloat16"))
# (config, clips or frames of the input, frames a clip): one train step's loss and gradients
PATHS = (("mlp_vae", 4, 0), ("seq_vae", 2, 4))


def _digest(tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def digests() -> dict:
    """{"K5 shape gates": sha256, "K6 shape gates": sha256} of the bf16
    kernels' outputs, and {"K5 f32 shape gates": ..., "K6 f32 ...": ...} of
    the f32 ones, through the wrappers of the `mmvae_torch` on sys.path."""
    import torch

    dev = torch.device("cuda")
    out = {}
    for act, k5_shapes, k6_shapes in ((torch.bfloat16, K5_SHAPES, K6_SHAPES),
                                      (torch.float32, F32_K5_SHAPES, F32_K6_SHAPES)):
        out.update(_act_digests(dev, act, k5_shapes, k6_shapes))
    out.update(_head_digests(dev))
    for name, batch, frames in PATHS:
        first, second = (_path_digest(dev, name, batch, frames) for _ in range(2))
        out[f"path {name} step"] = first if first == second else "not reproducible"
    return out


def _head_digests(dev) -> dict:
    import torch

    from mmvae_torch.ops import head_kernels as hk
    from mmvae_torch.ops import kernel_checks as kc

    out = {}
    for m, k, n, xdt in HEAD_SHAPES:
        x, w_mu, b_mu, w_lv, b_lv = kc.head_inputs(dev, m, k, n, getattr(torch, xdt), 14)
        fwd = hk.head_sample_forward_cuda(x, w_mu, b_mu, w_lv, b_lv, 77)
        cots = kc.head_cotangents(dev, m, n, 15)[1:]
        grads = hk.head_sample_backward_cuda(x, w_mu, w_lv, fwd[3], *cots)
        out[f"head {(m, k, n, xdt)}"] = _digest((*fwd, *grads))
    return out


def _path_digest(dev, name: str, batch: int, frames: int) -> str:
    """One step of config `name` at full width: the loss and every
    parameter gradient of a seeded batch (`frames` frames a clip; 0: single
    frames), eps injected, from the config's own initial parameters."""
    import torch

    from mmvae_torch.configs import get_config
    from mmvae_torch.ops.dispatch import make_sample_fn
    from mmvae_torch.ops.elbo_kernels import elbo_reduce
    from mmvae_torch.train.loop import build_model

    torch.backends.cudnn.deterministic = True
    cfg = get_config(name)
    g = torch.Generator().manual_seed(9)
    shape = (batch, frames, 64, 64) if frames else (batch, 64, 64)
    x = (torch.rand(shape, generator=g) < 0.35).float().to(dev)
    eps = torch.randn(batch, cfg.model.kwargs["latent_dim"], generator=g)
    model = build_model(cfg, device="cpu").to(dev)
    out = model(x, make_sample_fn(0, {0: eps}))
    bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
    loss = (bce + kl + out.extra_kl) / batch
    loss.backward()
    return _digest((loss.reshape(1), *(p.grad for p in model.parameters())))


def _act_digests(dev, act, k5_shapes, k6_shapes) -> dict:
    import torch

    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import kernel_checks as kc

    tag = " f32" if act == torch.float32 else ""
    out = {}
    for gdt in (torch.float32, torch.bfloat16):
        for shape in k5_shapes:
            x, wx, bx, w, c0, h0 = kc.proj_inputs(dev, *shape, seed=6, dtype=act)
            res = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, gdt, True)
            last = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, gdt, False)
            g = torch.Generator(device=dev).manual_seed(7)
            dh = torch.randn(c0.shape, generator=g, device=dev)
            dc = torch.randn(c0.shape, generator=g, device=dev)
            grads = ck.proj_backward_cuda(x, wx, w, c0, h0, *res, dh, dc)
            out[f"K5{tag} {shape} gates {gdt}"] = _digest((*res, *last, *grads))
        for b, t, h, w_, f, const in k6_shapes:
            xg, wh, c0, h0 = kc.scan_inputs(dev, b, 1 if const else t, h, w_, f, seed=10,
                                            dtype=act)
            res = ck.scan_forward_cuda(xg, wh, c0, h0, t, gdt, "save")
            hs = ck.scan_forward_cuda(xg, wh, c0, h0, t, gdt, "hs")
            last = ck.scan_forward_cuda(xg, wh, c0, h0, t, gdt, "last")
            g = torch.Generator(device=dev).manual_seed(11)
            dhs = torch.randn(res[0].shape, generator=g, device=dev)
            dc = torch.randn(c0.shape, generator=g, device=dev)
            grads = [t_ for last_only in (False, True) for t_ in ck.scan_backward_cuda(
                wh, c0, h0, *res, dhs[:, -1] if last_only else dhs, dc, const, last_only)]
            out[f"K6{tag} {(b, t, h, w_, f, const)} gates {gdt}"] = _digest(
                (*res, *hs, *last, *grads))
    return out


def save_forward(out_dir: str) -> None:
    """K5's bf16 forward outputs (hs, cs, gates) at `FORWARD_SHAPE`, both
    gate dtypes, as raw bf16 bits, one .npy file each in `out_dir`."""
    import numpy as np
    import torch

    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import kernel_checks as kc

    dev = torch.device("cuda")
    x, wx, bx, w, c0, h0 = kc.proj_inputs(dev, *FORWARD_SHAPE, seed=6)
    for gdt in (torch.float32, torch.bfloat16):
        outs = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, gdt, True)
        for name, t in zip(("hs", "cs", "gates"), outs):
            np.save(Path(out_dir) / f"{name} gates {gdt}.npy",
                    t.contiguous().view(torch.int16).cpu().numpy())


def forward_moves(a_dir: str, b_dir: str) -> dict:
    """{tensor: (max |a - b| in bf16 ulps of max |b|, share of elements
    that differ)} between two `save_forward` directories."""
    import math

    import numpy as np

    def load(path):
        bits = np.load(path).astype(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)

    out = {}
    for path in sorted(Path(b_dir).glob("*.npy")):
        a, b = load(Path(a_dir) / path.name), load(path)
        top = float(np.abs(b).max())
        ulp = 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -126))) - 7)
        out[path.stem] = (float(np.abs(a - b).max()) / ulp, float(np.mean(a != b)))
    return out


def main(argv=None) -> int:
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout (in a worker: its own root)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        save_forward(args.save)
        print(json.dumps(digests()))
        return 0
    here = Path(__file__).resolve().parents[2]
    runs = []
    saved = tempfile.TemporaryDirectory(prefix="mmvae_hashes_")
    dirs = [os.path.join(saved.name, str(k)) for k in range(2)]
    for root, out_dir in zip((Path(args.other).resolve(), here), dirs):
        os.makedirs(out_dir)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", "--save", out_dir,
             str(root)],
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
    print(f"[hashes] K5 and K6 outputs, bf16 at {len(K5_SHAPES)} + {len(K6_SHAPES)} shapes and "
          f"f32 at {len(F32_K5_SHAPES)} + {len(F32_K6_SHAPES)}, both gate dtypes; the head at "
          f"{len(HEAD_SHAPES)} shapes; {len(PATHS)} paths' steps: "
          f"{'bit-identical' if not differ else f'{len(differ)} differ: ' + '; '.join(differ)}")
    for name, (ulps, share) in forward_moves(*dirs).items():
        print(f"[hashes] K5 bf16 forward {FORWARD_SHAPE}, {name}: at most {ulps:.2f} bf16 ulps "
              f"of the other checkout's largest magnitude from it, {100 * share:.2f} % of the "
              f"elements differ")
    saved.cleanup()
    return 1 if differ else 0


if __name__ == "__main__":
    sys.path[0] = os.getcwd()  # run by path in a worker: import the checkout it runs in
    sys.exit(main())
