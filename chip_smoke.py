#!/usr/bin/env python3
"""On-card smoke of the PyTorch / CUDA port's main path (config 3, seq_vae).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each raising on failure (the script catches nothing):
1. card and toolchain: the card's name and power limit, torch / CUDA / nvcc /
   triton versions, the TF32 settings (both off);
2. build: the CUDA kernels from mmvae_torch/csrc/ with nvcc (into
   build/kernels/), and the Triton kernels at first launch;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at one unaligned shape, with its tolerance, and the
   time of both; then the full-width model's forward and gradients on a
   small input, on the card through the kernels against the CPU through
   the plain versions;
4. the slice: `run_benchmark(get_config("seq_vae"))` at full width (64 clips
   x 20 frames x 64x64, bf16, a 9,000-clip resident u8 dataset), 3 timed
   windows of 20 train steps after 5 warmup steps; losses finite and falling; every
   kernel's launch counter above 0 for that run; no jax imported.
The last three lines are the card, the kernels' JSON line, and
{"ok": true, "device": {...}}.  Exits non-zero with no result when CUDA is
not available.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

_KERNELS = {
    # wrapper name: (route, source, the TPU kernel it replaces)
    "preprocess_gather": ("cuda", "mmvae_torch/csrc/preprocess.cu",
                          "mmvae_tpu/ops/preprocess_pallas.py:138"),
    "elbo_reduce": ("triton", "mmvae_torch/ops/elbo_kernels.py",
                    "mmvae_tpu/ops/elbo_pallas.py:173"),
    "reparameterize": ("triton", "mmvae_torch/ops/elbo_kernels.py",
                       "mmvae_tpu/ops/elbo_pallas.py:272"),
    "convlstm_proj_forward": ("cuda", "mmvae_torch/csrc/convlstm_proj.cu",
                              "mmvae_tpu/ops/convlstm_pallas.py:760"),
    "convlstm_proj_backward": ("cuda", "mmvae_torch/csrc/convlstm_proj.cu",
                               "mmvae_tpu/ops/convlstm_pallas.py:741"),
}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def _maxerr(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def phase_card() -> str:
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import triton

    from mmvae_torch.ops import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} nvcc '{nvcc}' "
          f"triton {triton.__version__} python {sys.version.split()[0]}")
    print(f"[card] tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return card


def phase_build() -> None:
    from mmvae_torch.ops import _build

    lib = _build.library()
    print(f"[build] {lib.path.name} in {lib.build_seconds:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


# --- phase 3: kernels against their plain versions -------------------------


def check_preprocess(dev) -> dict:
    import torch

    from mmvae_torch.ops.preprocess_kernels import preprocess_gather, preprocess_gather_plain

    g = torch.Generator(device=dev).manual_seed(1)
    data = torch.randint(0, 256, (512, 20, 64, 64), generator=g, device=dev, dtype=torch.uint8)
    idx = torch.randint(0, 512, (64,), generator=g, device=dev)
    err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        k = preprocess_gather(data, idx, 7, binarize=False, out_dtype=dt)
        p = preprocess_gather_plain(data, idx, 7, binarize=False, out_dtype=dt)
        err = max(err, _maxerr(k, p))
    odd = torch.randint(0, 256, (37, 3, 17, 5), generator=g, device=dev, dtype=torch.uint8)
    oidx = torch.randint(0, 37, (7,), generator=g, device=dev)
    oidx[:2] = torch.tensor([-4, 40])  # out of range: both versions clamp
    err = max(err, _maxerr(preprocess_gather(odd, oidx, 7, binarize=False),
                           preprocess_gather_plain(odd, oidx, 7, binarize=False)))
    _require(err == 0.0, f"preprocess binarize=False max|err| {err} (tolerance 0)")

    # binarize=True: per-u8-value hit rates within 5 sigma of u8/255.
    ramp = (torch.arange(20 * 64 * 64, device=dev) % 256).to(torch.uint8).view(1, 20, 64, 64)
    ramp_set = ramp.expand(64, 20, 64, 64).contiguous()
    ar = torch.arange(64, device=dev)
    b1 = preprocess_gather(ramp_set, ar, 12345, binarize=True, out_dtype=torch.bfloat16)
    b2 = preprocess_gather(ramp_set, ar, 12345, binarize=True, out_dtype=torch.bfloat16)
    b3 = preprocess_gather(ramp_set, ar, 54321, binarize=True, out_dtype=torch.bfloat16)
    _require(torch.equal(b1, b2), "preprocess: same seed gave different bits")
    _require(not torch.equal(b1, b3), "preprocess: different seeds gave the same bits")
    vals = ramp_set.flatten().long()
    hits = torch.zeros(256, device=dev).index_add_(0, vals, b1.flatten().float())
    counts = torch.bincount(vals, minlength=256).float()
    p = torch.arange(256, device=dev).float() / 255.0
    sigma = torch.sqrt(p * (1 - p) / counts).clamp_min(1.0 / counts)
    z = ((hits / counts - p).abs() / sigma).max().item()
    _require(z <= 5.0, f"preprocess binarize hit rates off by {z:.2f} sigma (limit 5)")
    # odd row length, binarize, both dtypes: values in {0, 1}
    ob = preprocess_gather(odd, oidx, 3, binarize=True)
    _require(bool(((ob == 0) | (ob == 1)).all()), "preprocess: non-binary output")

    big = torch.randint(0, 256, (9000, 20, 64, 64), generator=g, device=dev, dtype=torch.uint8)
    bidx = torch.randint(0, 9000, (64,), generator=g, device=dev)
    ms = _time_ms(lambda: preprocess_gather(big, bidx, 5, binarize=True,
                                            out_dtype=torch.bfloat16), 50)
    plain_ms = _time_ms(lambda: preprocess_gather_plain(big, bidx, 5, binarize=True,
                                                        out_dtype=torch.bfloat16), 50)
    print(f"[kernel] preprocess_gather: binarize=False max|err| {err} (tolerance 0, exact); "
          f"binarize=True worst hit-rate deviation {z:.2f} sigma (limit 5); "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_elbo(dev) -> dict:
    import torch

    from mmvae_torch.ops.elbo_kernels import elbo_reduce, elbo_reduce_plain

    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for big, small in (((64, 20, 64, 64), (64, 128)), ((3, 17), (3, 5))):
        logits = (torch.randn(big, generator=g, device=dev) * 2).requires_grad_()
        x = (torch.rand(big, generator=g, device=dev) < 0.4).to(torch.bfloat16)
        mu = torch.randn(small, generator=g, device=dev).requires_grad_()
        lv = (torch.randn(small, generator=g, device=dev) * 0.5).requires_grad_()
        bk, kk = elbo_reduce(logits, x, mu, lv)
        (bk + 0.7 * kk).backward()
        gk = [t.grad.clone() for t in (logits, mu, lv)]
        for t in (logits, mu, lv):
            t.grad = None
        with torch.no_grad():
            bp, kp = elbo_reduce_plain(logits, x, mu, lv)
        l32 = logits.detach()
        gp = [torch.sigmoid(l32) - x.float(), 0.7 * mu.detach(),
              0.7 * 0.5 * (torch.exp(lv.detach()) - 1.0)]
        rb = abs(bk.item() - bp.item()) / abs(bp.item())
        rk = abs(kk.item() - kp.item()) / max(abs(kp.item()), 1.0)
        ge = max(_maxerr(a, b) for a, b in zip(gk, gp))
        _require(rb <= 2e-5 and rk <= 1e-5 and ge <= 1e-6,
                 f"elbo {big}: rel err bce {rb:.2e} (2e-5) kl {rk:.2e} (1e-5) grad {ge:.2e} (1e-6)")
        worst = max(worst, abs(bk.item() - bp.item()), abs(kk.item() - kp.item()))
        print(f"[kernel] elbo_reduce {big}: bce rel err {rb:.2e} (tolerance 2e-5), "
              f"kl rel err {rk:.2e} (1e-5), grads max|err| {ge:.2e} (1e-6)")
    logits = torch.randn((64, 20, 64, 64), generator=g, device=dev)
    x = (torch.rand((64, 20, 64, 64), generator=g, device=dev) < 0.4).to(torch.bfloat16)
    mu = torch.randn((64, 128), generator=g, device=dev)
    ms = _time_ms(lambda: elbo_reduce(logits, x, mu, mu), 50)
    plain_ms = _time_ms(lambda: elbo_reduce_plain(logits, x, mu, mu), 50)
    print(f"[kernel] elbo_reduce: {ms:.4f} ms vs plain {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def check_reparam(dev) -> dict:
    import torch

    from mmvae_torch.ops.elbo_kernels import reparameterize, reparameterize_plain

    g = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    for shape in ((64, 128), (3, 5)):
        mu = torch.randn(shape, generator=g, device=dev).requires_grad_()
        lv = (torch.randn(shape, generator=g, device=dev) * 0.5).requires_grad_()
        z = reparameterize(mu, lv, 1234)
        cot = torch.randn(shape, generator=g, device=dev)
        z.backward(cot)
        d_lv = 0.5 * cot * (z.detach() - mu.detach())
        ge = max(_maxerr(mu.grad, cot), _maxerr(lv.grad, d_lv))
        _require(ge <= 1e-6, f"reparameterize {shape}: VJP max|err| {ge:.2e} (1e-6)")
        eps = (z.detach() - mu.detach()) / torch.exp(0.5 * lv.detach())
        zp, _ = reparameterize_plain(mu.detach(), lv.detach(), 0, eps=eps)
        fe = _maxerr(z, zp)
        _require(fe <= 1e-5, f"reparameterize {shape}: formula max|err| {fe:.2e} (1e-5)")
        worst = max(worst, ge, fe)
        if shape == (64, 128):
            n = eps.numel()
            m, v = eps.mean().item(), eps.var().item()
            _require(abs(m) <= 5 / math.sqrt(n) and abs(v - 1) <= 5 * math.sqrt(2 / n),
                     f"reparameterize eps moments mean {m:.4f} var {v:.4f}")
            same = reparameterize(mu.detach(), lv.detach(), 1234)
            other = reparameterize(mu.detach(), lv.detach(), 4321)
            _require(torch.equal(same, z.detach()) and not torch.equal(other, same),
                     "reparameterize: seed does not determine eps")
            print(f"[kernel] reparameterize eps moments: mean {m:.4f} var {v:.4f} "
                  f"(limits 5 sigma: {5 / math.sqrt(n):.4f}, {5 * math.sqrt(2 / n):.4f})")
        print(f"[kernel] reparameterize {shape}: VJP max|err| {ge:.2e} (tolerance 1e-6), "
              f"formula max|err| {fe:.2e} (1e-5)")
    mu = torch.randn((64, 128), generator=g, device=dev)
    ms = _time_ms(lambda: reparameterize(mu, mu, 9), 100)
    plain_ms = _time_ms(lambda: reparameterize_plain(mu, mu, 9), 100)
    print(f"[kernel] reparameterize: {ms:.4f} ms vs plain {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def _proj_inputs(dev, dtype, b, t, h, w, c, f, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    return (rn(b, t, h, w, c, scale=0.5), rn(c, 4 * f, scale=c ** -0.5),
            rn(4 * f, scale=0.1), rn(3, 3, f, 4 * f, scale=(9 * f) ** -0.5),
            rn(b, h, w, f, scale=0.5), rn(b, h, w, f, scale=0.5))


def _bf16_ulps(a, b) -> float:
    """max|a - b| in bf16 ulps of b's largest magnitude."""
    m = float(b.detach().float().abs().max())
    return _maxerr(a, b) / 2.0 ** (math.floor(math.log2(max(m, 2.0 ** -126))) - 7)


def check_convlstm(dev) -> tuple:
    """K5 with bf16 activations, the only ones its CUDA kernels take, at the main
    path's shape and at an unaligned one (5x6 positions, odd T).  Kernel
    and plain version round the same operands to bf16, so with f32 gates
    every output is held to 2 bf16 ulps of its largest value.  bf16 gates
    round the pointwise chain at each step on both sides: forward to 0.05
    absolute, the bf16 tolerance of tests/test_convlstm_fused.py.  The
    backward chain is f32 whatever the gate dtype and both backward passes
    start from the same residuals: 2 ulps in both cases."""
    import torch

    from mmvae_torch.ops import convlstm_kernels as ck

    f32, bf16 = torch.float32, torch.bfloat16
    worst_f = worst_b = 0.0
    names = ("dx", "dWx", "dbx", "dW", "dc0", "dh0")
    for shape in ((64, 20, 8, 8, 128, 128), (3, 7, 5, 6, 48, 32)):
        for gdt in (f32, bf16):
            x, wx, bx, w, c0, h0 = _proj_inputs(dev, bf16, *shape, seed=4)
            outs_k = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, gdt, True)
            outs_p = ck.proj_forward_plain(x, wx, bx, w, c0, h0, gdt, True)
            hl_k, cl_k = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, gdt, False)
            nores = max(_maxerr(hl_k, outs_k[0][:, -1]), _maxerr(cl_k, outs_k[1][:, -1]))
            _require(nores == 0.0, f"convlstm {shape}: the residual-free forward differs "
                                   f"from the saving one by {nores:.2e}")
            fe = max(_maxerr(a, b) for a, b in zip(outs_k, outs_p))
            if gdt == f32:
                fu = max(_bf16_ulps(a, b) for a, b in zip(outs_k, outs_p))
                _require(fu <= 2.0, f"convlstm fwd {shape} gates f32: {fu:.2f} bf16 ulps (2)")
                fwd_txt = f"fwd {fu:.2f} ulps (tolerance 2)"
            else:
                _require(fe <= 0.05, f"convlstm fwd {shape} gates bf16: max|err| {fe:.2e} (0.05)")
                fwd_txt = f"fwd max|err| {fe:.2e} (tolerance 0.05)"
            g = torch.Generator(device=dev).manual_seed(5)
            dh = torch.randn(hl_k.shape, generator=g, device=dev)
            dc = torch.randn(hl_k.shape, generator=g, device=dev)
            # both backward passes from the same (plain) residuals
            gk = ck.proj_backward_cuda(x, wx, w, c0, h0, *outs_p, dh, dc)
            gp = ck.proj_backward_plain(x, wx, w, c0, h0, *outs_p, dh, dc)
            errs = []
            for name, a, b in zip(names, gk, gp):
                u = _bf16_ulps(a, b)
                _require(u <= 2.0, f"convlstm bwd {shape} gates {gdt} {name}: {u:.2f} bf16 "
                                   f"ulps of max|ref| (tolerance 2)")
                errs.append(f"{name} {u:.2f}")
            worst_f = max(worst_f, fe)
            worst_b = max(worst_b, max(_maxerr(a, b) for a, b in zip(gk, gp)))
            print(f"[kernel] convlstm_proj {shape} bf16, gates {gdt}: {fwd_txt}; bwd ulps "
                  f"{', '.join(errs)} (tolerance 2 ulps of each gradient's max|ref|)")
    x, wx, bx, w, c0, h0 = _proj_inputs(dev, bf16, 64, 20, 8, 8, 128, 128, seed=6)
    hs, cs, ga = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, bf16, True)
    dh = torch.randn(64, 8, 8, 128, device=dev)
    fwd_ms = _time_ms(lambda: ck.proj_forward_cuda(x, wx, bx, w, c0, h0, bf16, True), 5)
    fwd_plain = _time_ms(lambda: ck.proj_forward_plain(x, wx, bx, w, c0, h0, bf16, True), 5)
    bwd_ms = _time_ms(lambda: ck.proj_backward_cuda(x, wx, w, c0, h0, hs, cs, ga, dh, dh), 5)
    bwd_plain = _time_ms(lambda: ck.proj_backward_plain(x, wx, w, c0, h0, hs, cs, ga, dh, dh), 5)
    print(f"[kernel] convlstm_proj forward (bf16, saves residuals): {fwd_ms:.3f} ms vs plain "
          f"{fwd_plain:.3f} ms; backward {bwd_ms:.3f} ms vs plain {bwd_plain:.3f} ms")
    return ({"max_abs_err": worst_f, "ms": fwd_ms, "plain_ms": fwd_plain},
            {"max_abs_err": worst_b, "ms": bwd_ms, "plain_ms": bwd_plain})


def _rel_l2(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check_model(dev) -> None:
    """The config-3 model at full width on a small input (2 clips x 4
    frames): forward and every parameter gradient on the card, through the
    kernels, against the same model on the CPU, through the plain versions.
    The kernels take bf16 activations, so the card runs bf16 with f32 gates
    and with bf16 gates (production).  The two devices round different
    partial sums to bf16, so each tensor is held to the CPU's f32 result:
    the card's relative L2 distance to it at most max(2 x the CPU bf16 one's,
    0.05) (as tests/test_torch_models.py holds the port's bf16 run to JAX's)."""
    import copy

    import torch

    from mmvae_torch.configs import get_config
    from mmvae_torch.ops.elbo_kernels import elbo_reduce
    from mmvae_torch.train.loop import build_model

    g = torch.Generator().manual_seed(7)
    x = (torch.rand(2, 4, 64, 64, generator=g) < 0.35).float()
    eps = torch.randn(2, 128, generator=g)

    def run(model, device):
        e = eps.to(device)
        out = model(x.to(device), lambda m, v, salt=0: m + torch.exp(0.5 * v) * e)
        bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
        ((bce + kl) / 2).backward()
        res = dict(zip(("logits", "mu", "logvar"), out[:3]))
        res.update((n, p.grad) for n, p in model.named_parameters())
        return {n: t.detach().float().cpu() for n, t in res.items()}

    def config(dtype, gate_bf16):
        cfg = get_config("seq_vae", (f"model.dtype={dtype}",))
        cfg.model.kwargs["gate_bf16"] = gate_bf16
        return cfg

    # Same seed, so the same f32 weights for every dtype.
    truth = run(build_model(config("float32", False)), torch.device("cpu"))
    for gate_bf16 in (False, True):
        ref_model = build_model(config("bfloat16", gate_bf16))
        plain = run(ref_model, torch.device("cpu"))
        kern = run(copy.deepcopy(ref_model).to(dev), dev)
        worst = (0.0, "")
        for name, b in plain.items():
            a = kern[name]
            e_k, e_p = _rel_l2(a, truth[name]), _rel_l2(b, truth[name])
            lim = max(2 * e_p, 0.05)
            _require(e_k <= lim, f"model bf16 gates {'bf16' if gate_bf16 else 'f32'} {name}: "
                                 f"rel L2 to f32 {e_k:.3f} on the card, {e_p:.3f} on the CPU "
                                 f"(limit {lim:.3f})")
            worst = max(worst, (e_k / lim, f"{name} (card {e_k:.3f}, CPU {e_p:.3f}, "
                                           f"card vs CPU {_rel_l2(a, b):.3f})"))
        print(f"[model] seq_vae bf16, gates {'bf16' if gate_bf16 else 'f32'} (2 x 4 x 64x64), "
              f"card with kernels vs CPU with plain versions, over {len(plain)} tensors: "
              f"worst rel L2 to the f32 result over its limit {worst[0]:.3f} (must be <= 1) "
              f"at {worst[1]}")


def phase_kernels(dev) -> dict:
    fwd, bwd = check_convlstm(dev)
    return {
        "preprocess_gather": check_preprocess(dev),
        "elbo_reduce": check_elbo(dev),
        "reparameterize": check_reparam(dev),
        "convlstm_proj_forward": fwd,
        "convlstm_proj_backward": bwd,
    }


def phase_slice(card: str) -> dict:
    from mmvae_torch import ops
    from mmvae_torch.bench.throughput import run_benchmark
    from mmvae_torch.configs import get_config

    cfg = get_config("seq_vae")
    _require(cfg.data.batch_size == 64 and cfg.data.seq_len == 20
             and cfg.model.dtype == "bfloat16", "seq_vae is not the full-width config")
    ops.reset_launch_counts()
    res = run_benchmark(cfg, steps=20, warmup=5)
    counts = ops.launch_counts()
    losses = res.pop("losses")
    _require(all(math.isfinite(v) for v in losses), f"non-finite loss in {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    _require(last < first, f"loss did not fall: first 5 mean {first:.1f}, last 5 {last:.1f}")
    _require(all(n > 0 for n in counts.values()), f"a kernel was not launched: {counts}")
    print(f"[slice] {len(losses)} train steps, loss first-5 mean {first:.2f} -> "
          f"last-5 mean {last:.2f}; launches {counts}")
    print(f"[slice] {json.dumps(res)}")
    print(f"[slice] {res['value']} frames/s/GPU (min {res['value_min']}, max "
          f"{res['value_max']}, spread {res['spread_pct']}%) on {card}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = phase_card()
    phase_build()
    checks = phase_kernels(dev)
    check_model(dev)
    counts = phase_slice(card)
    _require("jax" not in sys.modules and "mmvae_tpu" not in sys.modules,
             "jax or mmvae_tpu was imported")
    kernels = []
    for name, (route, source, replaces) in _KERNELS.items():
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": counts[name], **checks[name]})
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
