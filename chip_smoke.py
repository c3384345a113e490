#!/usr/bin/env python3
"""On-card smoke of the PyTorch / CUDA port: every config training, through
the bench and through the training loop (`fit`), then sampling and the CLI,
then data-parallel training, then K train steps a call in one CUDA graph,
then the per-region device budget of a step, then the first 2,000 steps of
config 3's convergence protocol at sixteen seeds against the reference's curve,
then the ConvLSTM kernels at F = 160-256 and the reference's
lstm_features=192 probe, then the ConvLSTM kernels and configs 3-5 with f32
activations, then the ConvLSTM recurrences at every other shape (the general
kernels) and the probe in f32.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each raising on failure (the script catches nothing):
1. card and toolchain: the card's name and power limit, torch / CUDA / nvcc /
   triton versions, the TF32 settings (both off);
2. build: the CUDA kernels from mmvae_torch/csrc/ with nvcc (into
   build/kernels/, one nvcc per source, all at once), each kernel's
   registers and spills and every compiler warning printed, none of them
   ptxas serializing a kernel's wgmma (C7513 / C7520); the Triton kernels at
   first launch;
3. each kernel against its plain PyTorch version on the card, at every
   shape the runs of phases 4 and 5 give it (`path_shapes`, from their
   configs: the per-frame configs' frame rows, heads and logits and the
   streamed batch included) and at one unaligned shape, with its tolerance
   (K5 and K6 through `mmvae_torch.ops.kernel_checks`), and the time of
   both at each path's shape beside the kernel's bound
   (`mmvae_torch.bench.roofline`) and its share of it; K1, K2 and K3, which
   take tens of microseconds, timed on the device by replaying a CUDA graph
   of 20 calls (the host's launch path is longer than they are; K1 and K3
   on a cold L2), K1 beside the one PyTorch call that computes its BCE sum
   (`library_ms`); the fused Gaussian head and sample
   (`head_sample_forward` / `_backward`, which replace K2 on the train
   steps) at each sampling site, at larger batches and at latent widths
   past 656, its f32 outputs in f32 units that a TF32 control must fail,
   with bf16 x (which skips its zero TF32 lo pass) bit-identical to the
   f32 kernels on x cast to f32, its forward bit-identical over
   many launches (warm, cold, two streams), timed in CUDA graphs beside the
   route it replaces (a cast, two F.linear and K2, with its autograd
   backward: `library_ms`); K5's, K6's and the head's backward (K6 with a
   time-constant and a streaming xg) run twice and required bit-identical;
   then each config's full-width model (mlp_vae and conv_vae in f32;
   seq_vae with the default and the recipe's `fast_mid` decoder; pred_vae
   and hier_vae with fused=true), forward and gradients on a small input,
   eps injected through the train step's sample function, on the card
   through the kernels against the CPU through the plain versions; the
   frame decoder alone in its four other modes, card against CPU; on-card
   clip generation (`data.ongen`): byte-identical to the CPU from the same
   draws with TF32 off and on, and from its own generator at 64 clips x 20
   frames every sprite inside the canvas and the mean intensity within 5 %
   of the host generator's;
4. the slices through `run_benchmark` at full width, each with the launch
   counters set to 0 just before it and read just after: config 3
   `seq_vae` (64 clips x 20 frames: K1, K3, K5, the head and, under the
   auto policy, K6), config 4 `pred_vae` and config 5 `hier_vae` (16 clips
   x 100 frames) with `model.kwargs.fused=true` (K1, K3, K5, K6 and the
   head), the recommended recipe (config 3 with `fast_mid`, clips generated
   on the card every step and a parameter EMA: as config 3; the EMA moved
   off both the initial and the live parameters), K6 wherever
   `models.convlstm.runs_kernel` puts the decoder, the standalone K2
   launched on none, 3 timed windows of 20 train steps after 5 warmup
   steps, losses finite and falling; then config 3 with fused=false (both
   recurrences on the eager loop: neither K5 nor K6), timed beside the
   default, as a measurement of the policy;
5. the training loop `fit` at full width (its one cut: a 2,000-clip
   procedural set), each run with the launch counters set to 0 just before
   it and read just after and held to its path's equations (K5's forward
   once a train step and once an eval batch, its backward once a train
   step, the standalone K2 never): config 3 streamed from the host through
   `DeviceFeed` (60 steps, an eval pass and a checkpoint every 20; every
   batch handed over checked against the host's stream; the checkpoint
   restored bit for bit; standalone `evaluate` against the in-training val
   metrics; one eval pass and one checkpoint save timed), then resumed to
   80 steps on the host batches an uninterrupted run would draw; configs 1
   and 2 resident (40 steps, one eval pass); config 4 with fused=true (20
   steps, one eval pass: K6's forward without residuals under eval); the
   recipe (40 steps, one eval pass raw and under the EMA);
6. sampling (`mmvae_torch.sample.generate`) at full width, each model and
   mode the CLI offers (configs 1 and 2: prior and reconstruct; config 3
   default and fused, config 5 fused: prior and reconstruct; config 4 fused:
   prior, reconstruct and rollout): on the card through the kernels against
   the CPU through the plain versions from the same weights and injected
   draws, each call held to its launch equations by kernel and mode (the
   head's forward, K5 without residuals, K6 "hs"; no backward, no K1, no
   standalone K2), and frames/s at the config's batch with each call's
   kernel and copy time and the device's idle share (profiler); the forwards without
   residuals timed at their sampling shapes beside their plain versions,
   their bounds and the saving forward, and the head at the prior chain's
   shape; then the CLI in this process on the fit phase's checkpoints:
   `eval` (its JSON equal to `evaluate`'s), `sample` in every mode, `bench
   --profile` (the trace names the head's and K1's kernels);
7. data parallelism (`mmvae_torch.parallel`), two ranks spawned once for
   the phase: NCCL, a card a rank, where the host has two cards; else both
   ranks on this card over gloo (card tensors all-reduced through the
   host), and a one-rank NCCL group in this process all-reducing a card
   tensor.  Config 5 fused (16 clips, 8 a rank) and config 3 (64, 32 a
   rank) at full width: one step with `binarize=false` and each rank's eps
   injected, its averaged gradients bit-identical on the ranks, equal to
   the two halves stepped in this process, and against one process's
   full-batch step on the card within `_DP_BF16_FACTOR` times the same
   split's gap on the plain route in bf16 (every kernel's plain version on
   the card); config 3's plain route in f32 within `_DP_F32_PLAIN_LIMIT`,
   config 5's gradients computed in f32 within `_DP_F32_LIMIT` on the
   kernels' route (phase 4 holds every kernel against its plain version at
   a rank's shapes too);
   `fit` of config 3 on the resident path (20 steps, eval every 10 on 2
   batches a rank, checkpoints from rank 0), its launch equations on each
   rank (K5 forward = train steps + eval batches, backward = train steps),
   parameters bit-identical and logged metrics equal on the ranks, the
   logger's frames/s, the step's collective timed against the step; the
   group's checkpoint scored by `evaluate` and sampled in this process;
8. `train.steps_per_call` (`train.loop.chunk_steps`: K train steps
   captured in one CUDA graph, replayed once a call): a graph of one
   step's draws (the step seed from a step counter on the card, uniform
   rows, K3's frames and the head's eps from seeds the kernels read from
   device memory) replayed twice equals two eager steps and the host
   seeds' draws bit for bit, and its two replays draw differently; at
   K = 5 and full width, config 3 (uniform rows and shuffled epochs), the
   recipe, config 5 fused and config 1: steps 5-14 as two replays equal
   the same 10 eager steps bit for bit (parameters, Adam's moments and
   step counts, the EMA, every step's metrics; where not, two eager runs'
   gap is printed and the graph held within twice it) with equal launch
   counts (a replay adds its graph's counts); `fit` of config 3 resident
   at K = 5 (40 steps, eval and checkpoint every 20; logged steps each
   chunk's last, as JAX's fit; the checkpoint restored bit for bit; a
   resume to 60 equal to an uninterrupted 60; a stand-in SIGTERM saved at
   a chunk's end); a one-rank NCCL group's chunk with GradSync's
   all-reduce captured equal to its eager steps; `run_benchmark` at K = 1
   and 10 on configs 1, 2, 3, the recipe and 5 fused: frames/s, step ms,
   device busy ms and idle share, kernels and host launches a step,
   flops_per_step, TFLOP/s and MFU (finite, in (0, 1]);
9. the named regions (`mmvae_torch.bench.regions`) at K = 1 and full width
   on config 3 (default, and fused=false: both recurrences on the eager
   loop), config 4 fused, config 5 fused and
   the recipe: a step with the profiler on bit-identical to one without,
   then 10 traced steps with the launch counters set to 0 just before them
   and read just after; each region the JAX model names has forward (and,
   but preprocess, backward) device time, the rows sum to the window's
   summed device time (kernels, memsets, copies), and each kernel kind
   lands in its region (K3 in preprocess, K1 in elbo_reduce, the head in
   latent_head on config 3, K5 in enc_lstm or chunk_lstm, K6 in dec_lstm
   where the decoder runs it, their backward and weight GEMM in those regions'
   backward); each path's budget printed; then `annotate`'s cost with no
   profiler running and configs 1 and 3's K = 1 step ms from phase 8
   beside those measured before the regions;
10. trained quality (`mmvae_torch.bench.quality`): config 3 default's
   convergence protocol (`seq_vae_default`: the full 10,000-clip set, K =
   10, a log line every 200 steps, an eval of 4 val batches every 1,000)
   cut to 2,000 steps, at train.seed 0-15, with the launch counters set to
   0 just before the first run and read just after the last and held to
   their equations; every logged loss finite, each run's val_loss at 2,000
   below its val_loss at 1,000 and its reconstruction of 256 val clips
   under the base rate, and the sixteen runs' mean val_loss at 2,000 within
   5 % of the reference's 5990.1 (`docs/assets/seq_vae_r5_default_loss.csv`,
   one run); each seed's own gap printed (one seed's spread is as wide as
   the band); the phase's seconds printed;
11. the 4-CTA widths and the probe (`phase_wide`): K5 (saving and
   residual-free forwards, backward) and K6 (save, "hs" and "last";
   time-constant and streaming xg; both backward modes) at F = 160, 192,
   224 and 256, B = 64, T = 20, 8x8, C = 128, both gate dtypes, against
   their plain versions at phase 3's readings (`kernel_checks`), each
   backward twice bit-identical at F = 192 and 256, each kernel timed
   beside its plain version and its bound; then the reference's
   architecture probe (`docs/RESULTS.md:56`: the recipe with
   lstm_features=192): its model with the default and the fused decoder
   card against CPU (`check_model`), `fit` at K = 10 (200 steps, an eval
   pass raw and under the EMA; finite, falling loss; K5 at F = 192 in its
   launch equations) and with fused=true at K = 1 (20 steps, K6
   launched), `python -m mmvae_torch train` (20 steps, its checkpoint
   written), `run_benchmark` at K = 1 and 10, and sampling (prior and
   reconstruct) card against CPU with its frames/s; the launch counters
   set to 0 just before each run and read just after;
12. f32 activations (`phase_f32`): K5 (both forwards, backward) and K6
   (every mode, both xg kinds, both backward modes) with f32 activations at
   config 3's shape, config 4's K6 (and a streaming one at T = 20) and
   config 5's batch of 160, both gate dtypes, against their plain versions
   with TF32 off (`kernel_checks`: f32 gates and every gradient within
   `REC_F32_ULPS` f32 ulps, which the TF32 control, the plain version with
   its product operands rounded to TF32, must exceed; bf16 gates at the
   bf16-gate readings); the f32 weight GEMM alone against an f64 product
   beside cuBLAS's f32; each f32 backward twice bit-identical; each f32
   kernel timed beside its plain version and its bound (3xTF32); the bf16
   kernels' output hashes (`bench.hashes`, for a parent comparison); the
   models of configs 3 (default and fused), 4 fused and 5 fused with
   model.dtype=float32 card against CPU (f32 gates against the card's own
   plain route); `fit` of config 3 f32 at K = 10 (100 steps, an eval raw
   and under the EMA, K5 in its launch equations); `python -m mmvae_torch
   train` of config 3 f32, default and fused (K6 too); `run_benchmark` at
   K = 1 and 10; sampling card against CPU with its frames/s; the launch
   counters set to 0 just before each run and read just after;
13. the general-shape kernels (`phase_general`): K5 and K6 on the general
   route (`convlstm_kernels.route`: every shape outside the wgmma kernels'
   domain) at `kernel_checks.GENERAL_SHAPES` (the JAX package's small
   widths, the README's, a 9x13 grid at F = 20 and C = 24, F = 144 and 288
   in bf16, F = 160-256 in f32, a 16x16 grid at full width in bf16 and
   f32, the f32 probe), every mode, both gate dtypes, against their plain
   versions at phase 3's limits, each backward twice bit-identical, every
   launch on the general route; the TF32 control over the f32 limit at the
   probe's shape; the cell state's readings at the two 16x16 shapes; the
   general kernels timed at full width beside their plain versions,
   bounds and PR 16's times, and the wgmma forwards without residuals
   that had not been timed (f32, the 4-CTA widths); configs 3, 4 fused and
   5 fused at the JAX package's own small widths (a 16x16 grid, F = 16;
   the smoke's copy `_JAX_TINY`), bf16 and f32, card against CPU; the
   reference's probe with f32 activations through `fit` at K = 10 and,
   fused, at K = 1, `run_benchmark` at K = 1 and 10, and sampling, each
   run's launches held to its equations and every K5 and K6 launch to the
   general route (`ops.launch_counts_by_route`; every earlier path's runs
   are held to launch K5 and K6 on the wgmma kernels only: `_counts`); the
   phase's seconds.
   No jax imported.
The last three lines are the card, the kernels' JSON line (`launches`: the
count from the kernel's own path, config 3 for K1, K3, K5 and the head,
config 4 for K6, 0 for the standalone K2; `launches_by_path`: each path's
run, the fit, sampling, CLI, data-parallel and steps_per_call runs'
included; `sampling`:
the forwards' rows at the sampling shapes; `wide`: K5's and K6's rows at F
= 160-256; `f32`: their rows with f32 activations; `nores`: the wgmma
forwards without residuals in f32 and at F = 160-256; then the general
kernels' rows, `convlstm_*_general`, launches from the f32 probe's `fit` and
`launches_by_path` phase 13's runs, times at its shape, `shapes` every timed
shape; the wgmma rows' `launches_by_path` leave phase 13's runs out), and
{"ok": true, "device":
{...}}.  Exits non-zero with no result when CUDA is not available.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
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
    "head_sample_forward": ("cuda", "mmvae_torch/csrc/head_sample.cu",
                            "mmvae_tpu/ops/elbo_pallas.py:272"),
    "head_sample_backward": ("cuda", "mmvae_torch/csrc/head_sample.cu",
                             "mmvae_tpu/ops/elbo_pallas.py:261"),
    "convlstm_proj_forward": ("cuda", "mmvae_torch/csrc/convlstm_proj.cu",
                              "mmvae_tpu/ops/convlstm_pallas.py:760"),
    "convlstm_proj_backward": ("cuda", "mmvae_torch/csrc/convlstm_proj.cu",
                               "mmvae_tpu/ops/convlstm_pallas.py:741"),
    "convlstm_scan_forward": ("cuda", "mmvae_torch/csrc/convlstm_scan.cu",
                              "mmvae_tpu/ops/convlstm_pallas.py:1143"),
    "convlstm_scan_backward": ("cuda", "mmvae_torch/csrc/convlstm_scan.cu",
                               "mmvae_tpu/ops/convlstm_pallas.py:949"),
}
_K5 = ("convlstm_proj_forward", "convlstm_proj_backward")
_K6 = ("convlstm_scan_forward", "convlstm_scan_backward")
_HEAD = ("head_sample_forward", "head_sample_backward")
_STEP = ("preprocess_gather", "elbo_reduce") + _HEAD
# The standalone sampling kernel: for a bare (mu, logvar); the train steps
# sample through the fused head and must not launch it.
_K2 = ("reparameterize",)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    from mmvae_torch.bench.timing import event_ms

    return event_ms(fn, iters, warmup)


_GRAPH_CALLS = 20


def _graph_ms(calls, reps: int = 10) -> float:
    from mmvae_torch.bench.timing import graph_ms

    return graph_ms(calls, reps)


def _bound(name: str, shape) -> tuple:
    from mmvae_torch.bench.roofline import bound

    return bound(name, shape)


def _share(ms: float, name: str, shape) -> str:
    """'bound X ms (by), share Y %' for a kernel's time at `shape`."""
    b_ms, by = _bound(name, shape)
    return f"bound {b_ms:.4f} ms ({by}), {100 * b_ms / ms:.1f} % of it"


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
    serialized, entry = [], ""
    for line in lib.log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        if "registers" in line or "spill" in line or "warning" in line.lower():
            print(f"[build] {line.strip()}")
        if "spill" in line and " 0 bytes spill stores" not in line:
            print(f"[build] the spills above are {entry}'s")
        if "C7513" in line or "C7520" in line:
            serialized.append(line.strip())
    _require(not serialized, f"ptxas serialized wgmma in {len(serialized)} places")
    from mmvae_torch.bench.general_profile import ptxas_lines

    for line in ptxas_lines(lib.log):  # the general kernels' registers and spills, by name
        print(f"[build] general {line}")


# --- phase 3: kernels against their plain versions -------------------------


def _model_kwargs(cfg) -> dict:
    """The model's constructor arguments under `cfg`: its defaults, then the
    config's kwargs."""
    import inspect

    from mmvae_torch.models import MODEL_REGISTRY

    params = inspect.signature(MODEL_REGISTRY[cfg.model.name]).parameters
    return {**{k: p.default for k, p in params.items()}, **cfg.model.kwargs}


def _dec_k6(cfg) -> bool:
    """Whether the decoder recurrence of a sequence model under `cfg` runs
    K6 on the card: `models.convlstm.runs_kernel` for its time-constant
    input at the config's activations, F and grid."""
    import torch

    from mmvae_torch.models.convlstm import runs_kernel

    if cfg.data.per_frame:
        return False
    kw = _model_kwargs(cfg)
    grid = kw["image_size"] // 2 ** len(kw["enc_channels"])
    return runs_kernel(kw["fused"], True, "cuda", getattr(torch, cfg.model.dtype),
                       kw["lstm_features"], grid * grid)


def _run_shapes(name: str, overrides, world: int = 1) -> dict:
    """{kernel kind: [shapes]} that one run of `name` under `overrides`
    gives the kernels (see `path_shapes`); with `world`, what rank 0 of
    that many data-parallel ranks gives them (its share of the batch, its
    shard of a resident set)."""
    import torch

    from mmvae_torch.configs import get_config

    cfg = get_config(name, overrides)
    kw = _model_kwargs(cfg)
    b, t, size = cfg.data.batch_size // world, cfg.data.seq_len, kw["image_size"]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.model.dtype]
    # the frames' element bytes (train.loop.make_loss_fn: bf16 for a bf16
    # model's binarized frames, else f32)
    fb = 2 if cfg.data.binarize and dtype == torch.bfloat16 else 4
    # an ongen or streamed step gathers all of the batch it was given
    streamed = cfg.data.on_device_generate or cfg.data.device_resident is False
    clips = b if streamed else -(-max(int(cfg.data.num_sequences * cfg.data.train_fraction),
                                      cfg.data.batch_size) // world)
    if cfg.data.per_frame:
        latent = kw["latent_dim"]
        if name == "mlp_vae":
            k = kw["hidden_dim"]
        else:  # conv_vae: the head reads the encoder's NHWC flatten
            k = (size // 2 ** len(kw["channels"])) ** 2 * kw["channels"][-1]
        rows = b if streamed else clips * t  # a per-frame set's rows are frames
        return {"preprocess": [(rows, 1, b, fb)], "elbo": [((b, size, size), (b, latent), fb)],
                "reparam": [((b, latent), 0)], "head": [(b, k, latent, dtype)],
                "proj": [], "scan": []}
    grid, feat = size // 2 ** len(kw["enc_channels"]), kw["lstm_features"]
    enc = dec = (b, t)
    scored = t
    if name == "pred_vae":
        ctx = kw["context_len"]
        enc, dec, scored = (b, ctx), (b, t - ctx), t - ctx
    if name == "hier_vae":
        k = t // kw["chunk_len"]
        enc = dec = (b * k, kw["chunk_len"])
        samples = [((b, kw["global_latent"]), 0), ((b * k, kw["chunk_latent"]), 1)]
        # the global head reads the pooled chunk features, the chunk head
        # q_hidden's 256 outputs, both f32
        heads = [(b, kw["chunk_feature"], kw["global_latent"], torch.float32),
                 (b * k, 256, kw["chunk_latent"], torch.float32)]
    else:
        samples = [((b, kw["latent_dim"]), 0)]
        heads = [(b, grid * grid * feat, kw["latent_dim"], dtype)]
    fused = _dec_k6(cfg)
    return {"preprocess": [(clips, t, b, fb)],
            "elbo": [((b, scored, size, size), samples[0][0], fb)],
            "reparam": samples, "head": heads,
            "proj": [(*enc, grid, grid, kw["enc_channels"][-1], feat)],
            "scan": [(*dec, grid, grid, feat)] if fused else []}


_KINDS = ("preprocess", "elbo", "reparam", "head", "proj", "scan")


def path_shapes() -> dict:
    """The shapes each kernel is given in the runs of phases 4, 5 and 7
    (_SLICES, _POLICY, _FIT_PATHS and _DP_PATHS, the last a rank's), from
    their configs and the models' defaults:
    {kernel: {shape: [the runs that give it]}}.  preprocess: (rows in the
    set, frames a row, batch, bytes of a frame element); elbo: (logits, mu,
    bytes of an x element); reparameterize: (shape, salt); convlstm_proj:
    (B, T, H, W, C, F); convlstm_scan: (B, T, H, W, F), time-constant xg;
    head: (M, K, N, x dtype) of each sampling site.  The preprocess key of
    an ongen or streamed run is its batch."""
    out = {k: {} for k in _KINDS}
    runs = [(name, overrides, _tag(name, overrides), 1, _KINDS)
            for name, overrides, _, _ in (*_SLICES, _POLICY)]
    runs += [(name, overrides, tag, 1, _KINDS) for tag, name, overrides in _FIT_PATHS]
    runs += [(name, overrides, tag, world, kinds)
             for tag, name, overrides, world, kinds in _DP_PATHS]
    for name, overrides, tag, world, kinds in runs:
        for kind, keys in _run_shapes(name, overrides, world).items():
            for key in keys if kind in kinds else ():
                out[kind].setdefault(key, []).append(tag)
    return out


def _runs(tags) -> str:
    return "; ".join(tags)


def check_preprocess(dev, shapes) -> dict:
    """K3 at each path's set (a resident set of clips or of frames, or a
    streamed or generated batch gathered whole): binarize=False exact (both
    output dtypes, and at an odd shape with out-of-range rows),
    binarize=True hit rates per u8 value within 5 sigma of u8/255 (each row
    one ramp over the u8 values), seeds that decide the bits, and the time
    of both versions."""
    import torch

    from mmvae_torch.ops.preprocess_kernels import preprocess_gather, preprocess_gather_plain

    g = torch.Generator(device=dev).manual_seed(1)
    odd = torch.randint(0, 256, (37, 3, 17, 5), generator=g, device=dev, dtype=torch.uint8)
    oidx = torch.randint(0, 37, (7,), generator=g, device=dev)
    oidx[:2] = torch.tensor([-4, 40])  # out of range: both versions clamp
    err = _maxerr(preprocess_gather(odd, oidx, 7, binarize=False),
                  preprocess_gather_plain(odd, oidx, 7, binarize=False))
    ob = preprocess_gather(odd, oidx, 3, binarize=True)
    _require(bool(((ob == 0) | (ob == 1)).all()), "preprocess: non-binary output")
    first = None
    for (n, t, b, fb), runs in shapes.items():
        row = (64, 64) if t == 1 else (t, 64, 64)  # a per-frame set's rows are frames
        out_dt = torch.bfloat16 if fb == 2 else torch.float32
        data = torch.randint(0, 256, (n, *row), generator=g, device=dev, dtype=torch.uint8)
        # a streamed or generated batch is gathered whole (idx = arange)
        idx = (torch.arange(b, device=dev) if n == b
               else torch.randint(0, n, (b,), generator=g, device=dev))
        for dt in (torch.bfloat16, torch.float32):
            err = max(err, _maxerr(preprocess_gather(data, idx, 7, binarize=False, out_dtype=dt),
                                   preprocess_gather_plain(data, idx, 7, binarize=False,
                                                           out_dtype=dt)))
        _require(err == 0.0, f"preprocess ({n}, {t}, {b}) binarize=False max|err| {err} "
                             f"(tolerance 0)")
        del data
        ramp = (torch.arange(t * 64 * 64, device=dev) % 256).to(torch.uint8)
        ramp_set = ramp.view(1, *row).expand(n, *row).contiguous()
        b1 = preprocess_gather(ramp_set, idx, 12345, binarize=True, out_dtype=out_dt)
        b2 = preprocess_gather(ramp_set, idx, 12345, binarize=True, out_dtype=out_dt)
        b3 = preprocess_gather(ramp_set, idx, 54321, binarize=True, out_dtype=out_dt)
        _require(torch.equal(b1, b2), "preprocess: same seed gave different bits")
        _require(not torch.equal(b1, b3), "preprocess: different seeds gave the same bits")
        vals = ramp.long().repeat(b)
        hits = torch.zeros(256, device=dev).index_add_(0, vals, b1.flatten().float())
        counts = torch.bincount(vals, minlength=256).float()
        p = torch.arange(256, device=dev).float() / 255.0
        sigma = torch.sqrt(p * (1 - p) / counts).clamp_min(1.0 / counts)
        z = ((hits / counts - p).abs() / sigma).max().item()
        _require(z <= 5.0, f"preprocess ({n}, {t}, {b}) binarize hit rates off by {z:.2f} "
                           f"sigma (limit 5)")
        def kern(rows=idx, src=ramp_set):
            return preprocess_gather(src, rows, 5, binarize=True, out_dtype=out_dt)

        # each graph call gathers its own rows from the set (far larger than
        # L2), or from its own copy of a streamed batch: cold L2
        if n == b:
            cold = [lambda c=ramp_set.clone(): kern(idx, c) for _ in range(_GRAPH_CALLS)]
        else:
            cold = [lambda r=torch.randint(0, n, (b,), generator=g, device=dev): kern(r)
                    for _ in range(_GRAPH_CALLS)]
        ms, host_ms = _graph_ms(cold), _time_ms(kern, 50)
        del cold
        plain_ms = _time_ms(lambda: preprocess_gather_plain(ramp_set, idx, 5, binarize=True,
                                                            out_dtype=out_dt), 50)
        del ramp_set
        key = (n, t, b, fb)
        first = first or (ms, plain_ms, key)
        print(f"[kernel] preprocess_gather {b} of {n} rows x {t} frames, {out_dt} out "
              f"({_runs(runs)}): binarize=False max|err| {err} (tolerance 0, exact); "
              f"binarize=True worst hit-rate deviation {z:.2f} sigma (limit 5); {ms:.4f} ms on "
              f"the device (CUDA graph, cold L2; {host_ms:.4f} ms back to back from the host), "
              f"{_share(ms, 'preprocess_gather', key)}; plain {plain_ms:.4f} ms; "
              f"library: none (no one PyTorch call gathers and binarizes)")
    b_ms, by = _bound("preprocess_gather", first[2])
    return {"max_abs_err": err, "ms": first[0], "plain_ms": first[1], "bound_ms": b_ms,
            "bound_by": by, "library_ms": None}


def check_elbo(dev, shapes) -> dict:
    """K1 at each path's (logits, mu) and at an unaligned shape: the sums
    and their gradients against the plain version, and the time of both."""
    import torch

    import torch.nn.functional as F

    from mmvae_torch.ops.elbo_kernels import elbo_reduce, elbo_reduce_plain

    g = torch.Generator(device=dev).manual_seed(2)
    worst, first = 0.0, None
    for big, small, xb in (*shapes, ((3, 17), (3, 5), 2)):
        logits = (torch.randn(big, generator=g, device=dev) * 2).requires_grad_()
        x = (torch.rand(big, generator=g, device=dev) < 0.4).to(
            torch.bfloat16 if xb == 2 else torch.float32)
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
        timing = ""
        if (big, small, xb) in shapes:
            l, m = logits.detach(), mu.detach()
            # one copy of the inputs for each graph call: cold L2, as the bound
            # counts it (in the step the decoder has just written part of them)
            copies = [(l.clone(), x.clone(), m.clone()) for _ in range(_GRAPH_CALLS)]
            ms = _graph_ms([lambda c=c: elbo_reduce(c[0], c[1], c[2], c[2]) for c in copies])
            host_ms = _time_ms(lambda: elbo_reduce(l, x, m, m), 50)
            lib_ms = _graph_ms([lambda c=c: F.binary_cross_entropy_with_logits(
                c[0], c[1], reduction="sum") for c in copies])
            del copies
            plain_ms = _time_ms(lambda: elbo_reduce_plain(l, x, m, m), 50)
            first = first or (ms, plain_ms, lib_ms, (big, small, xb))
            timing = (f"; {ms:.4f} ms on the device (CUDA graph, cold L2; {host_ms:.4f} ms "
                      f"back to back from the host), "
                      f"{_share(ms, 'elbo_reduce', (big, small, xb))}; "
                      f"library F.binary_cross_entropy_with_logits(logits, x, reduction='sum') "
                      f"{lib_ms:.4f} ms (CUDA graph, cold L2; BCE only, no KL); plain "
                      f"{plain_ms:.4f} ms ({_runs(shapes[(big, small, xb)])})")
        print(f"[kernel] elbo_reduce {big}, {small}, x {x.dtype}: bce rel err {rb:.2e} "
              f"(tolerance 2e-5), "
              f"kl rel err {rk:.2e} (1e-5), grads max|err| {ge:.2e} (1e-6){timing}")
    ms, plain_ms, lib_ms, shape = first
    print(f"[kernel] elbo_reduce at the main path's shape: kernel {ms:.4f} ms against the "
          f"library call's {lib_ms:.4f} ms: the kernel "
          f"{'is faster' if ms <= lib_ms else 'is SLOWER'}")
    b_ms, by = _bound("elbo_reduce", shape)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": lib_ms}


def check_reparam(dev, shapes) -> dict:
    """K2 at each path's (shape, salt) and at an unaligned shape: the VJP,
    the formula, eps's moments, seeds that decide eps, and the time of both
    versions."""
    import torch

    from mmvae_torch.ops import seeds
    from mmvae_torch.ops.elbo_kernels import reparameterize, reparameterize_plain

    g = torch.Generator(device=dev).manual_seed(3)
    worst, first = 0.0, None
    for shape, salt in (*shapes, ((3, 5), 0)):
        seed = seeds.stream_seed(1234, seeds.STREAM_REPARAM, salt)
        mu = torch.randn(shape, generator=g, device=dev).requires_grad_()
        lv = (torch.randn(shape, generator=g, device=dev) * 0.5).requires_grad_()
        z = reparameterize(mu, lv, seed)
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
        txt = ""
        if (shape, salt) in shapes:
            n = eps.numel()
            m, v = eps.mean().item(), eps.var().item()
            _require(abs(m) <= 5 / math.sqrt(n) and abs(v - 1) <= 5 * math.sqrt(2 / n),
                     f"reparameterize {shape} eps moments mean {m:.4f} var {v:.4f}")
            same = reparameterize(mu.detach(), lv.detach(), seed)
            other = reparameterize(mu.detach(), lv.detach(), seed + 1)
            _require(torch.equal(same, z.detach()) and not torch.equal(other, same),
                     f"reparameterize {shape}: seed does not determine eps")
            m_, l_ = mu.detach(), lv.detach()
            # one input repeated: warm L2, as in the step, where the head has
            # just written mu and logvar (tens of KB)
            ms = _graph_ms([lambda: reparameterize(m_, l_, seed)] * _GRAPH_CALLS)
            host_ms = _time_ms(lambda: reparameterize(m_, l_, seed), 100)
            plain_ms = _time_ms(lambda: reparameterize_plain(m_, l_, seed), 100)
            first = first or (ms, plain_ms, shape)
            txt = (f"; eps mean {m:.4f} var {v:.4f} (limits 5 sigma: {5 / math.sqrt(n):.4f}, "
                   f"{5 * math.sqrt(2 / n):.4f}); {ms:.4f} ms on the device (CUDA graph; "
                   f"{host_ms:.4f} ms back to back from the host), "
                   f"{_share(ms, 'reparameterize', shape)}; plain {plain_ms:.4f} ms; library: "
                   f"none (no one PyTorch call draws and scales) ({_runs(shapes[(shape, salt)])})")
        print(f"[kernel] reparameterize {shape} salt {salt}: VJP max|err| {ge:.2e} "
              f"(tolerance 1e-6), formula max|err| {fe:.2e} (1e-5){txt}")
    b_ms, by = _bound("reparameterize", first[2])
    return {"max_abs_err": worst, "ms": first[0], "plain_ms": first[1], "bound_ms": b_ms,
            "bound_by": by, "library_ms": None}


# Head shapes beyond the sampling sites: unaligned ones, the batches the
# configs offer beyond their defaults (config 3 at 256, config 5 at 32),
# whose backward runs the batch in several blocks, and latent widths past
# 656 (several latent blocks in the backward).
_HEAD_EXTRA = ((5, 37, 3, "bfloat16"), (70, 300, 21, "float32"), (256, 8192, 128, "bfloat16"),
               (32, 256, 128, "float32"), (320, 256, 64, "float32"),
               (64, 8192, 657, "bfloat16"), (64, 8192, 1024, "bfloat16"),
               (64, 256, 1024, "float32"))


def check_head_sample(dev, shapes) -> tuple:
    """The fused Gaussian head and sample at each sampling site's (M, K, N,
    x dtype) and at `_HEAD_EXTRA`: forward with eps injected and the three
    gradients against the plain version (`kernel_checks.compare_head` and
    its tolerances), and the TF32 control, which the f32 limit must
    reject; with bf16 x, the kernels (without x's zero lo pass)
    bit-identical to the f32 kernels on x cast to f32; at the sites and the widths past 656 the
    backward bit-identical over two calls and the forward over 200
    launches warm, cold and on two streams; at the sites eps's moments,
    seeds that decide eps, and the time of both kernels beside the parent
    route's on the same inputs (a cast, two F.linear and the Triton K2,
    with its autograd backward: `library_ms`), by
    `bench/timing.head_region_ms`; the other shapes timed so too."""
    import torch

    from mmvae_torch.bench.timing import head_region_ms
    from mmvae_torch.ops import head_kernels as hk
    from mmvae_torch.ops import kernel_checks as kc
    from mmvae_torch.ops import seeds

    worst_f = worst_b = 0.0
    extra = tuple((*s[:3], getattr(torch, s[3])) for s in _HEAD_EXTRA)
    for shape in (*shapes, *extra):
        cmp = kc.compare_head(dev, shape)
        ctrl = kc.head_tf32_control(dev, shape)
        txt = cmp.text() + "; TF32 control " + ", ".join(f"{k} {v:.1f}" for k, v in ctrl.items())
        _require(min(ctrl.values()) > kc.F32_UNITS,
                 f"head_sample {shape}: the f32 limit {kc.F32_UNITS} does not reject the "
                 f"TF32 control {ctrl}")
        if shape[3] == torch.bfloat16:
            lo = kc.head_lo_pass_same(dev, shape)
            _require(all(lo.values()), f"head_sample {shape}: the f32 kernels on x cast to f32 "
                     f"differ {lo}")
            txt += "; bit-identical to the f32 kernels on x cast to f32 (x's zero lo pass)"
        print(f"[kernel] head_sample {shape}: {txt} (limit {kc.F32_UNITS:g} f32 units)")
        cmp.check(f"head_sample {shape}")
        worst_f, worst_b = max(worst_f, cmp.fwd_err), max(worst_b, cmp.bwd_err)
    for shape in (s for s in extra if s[2] > 656):
        same = kc.head_backward_repeatable(dev, shape)
        rep = kc.head_forward_repeatable(dev, shape)
        _require(all(same.values()) and all(rep.values()),
                 f"head_sample {shape}: not bit-identical over calls: {same} {rep}")
        print(f"[kernel] head_sample {shape}: backward bit-identical over two calls, forward "
              f"over {', '.join(rep)} launches")
    first = None
    for shape, runs in shapes.items():
        m, k, n, xdt = shape
        seed = seeds.stream_seed(1234, seeds.STREAM_REPARAM)
        eps = kc.head_eps(dev, shape, 30, seed)
        cnt = eps.numel()
        mean, var = eps.mean().item(), eps.var().item()
        _require(abs(mean) <= 5 / math.sqrt(cnt) and abs(var - 1) <= 5 * math.sqrt(2 / cnt),
                 f"head_sample {shape} eps moments mean {mean:.4f} var {var:.4f}")
        _require(torch.equal(eps, kc.head_eps(dev, shape, 30, seed))
                 and not torch.equal(eps, kc.head_eps(dev, shape, 30, seed + 1)),
                 f"head_sample {shape}: the seed does not determine eps")
        same = kc.head_backward_repeatable(dev, shape)
        _require(all(same.values()), f"head_sample backward at {shape} differs between two "
                                     f"calls: {same}")
        rep = kc.head_forward_repeatable(dev, shape)
        _require(all(rep.values()), f"head_sample forward at {shape} differs between launches: "
                                    f"{rep}")
        t = head_region_ms(dev, shape, seed)
        x, w_mu, b_mu, w_lv, b_lv = kc.head_inputs(dev, m, k, n, xdt, 40)
        cots = kc.head_cotangents(dev, m, n, 41)[1:]
        d = hk.head_sample_forward_plain(x, w_mu, b_mu, w_lv, b_lv, seed)[3]
        plain = (_time_ms(lambda: hk.head_sample_forward_plain(x, w_mu, b_mu, w_lv, b_lv,
                                                               seed), 20),
                 _time_ms(lambda: hk.head_sample_backward_plain(x, w_mu, w_lv, d, *cots), 20))
        bkey = (m, k, n, torch.finfo(xdt).bits // 8)
        first = first or (t, plain, bkey)
        print(f"[kernel] head_sample {shape} ({_runs(runs)}): eps mean {mean:.4f} var {var:.4f} "
              f"(limits 5 sigma: {5 / math.sqrt(cnt):.4f}, {5 * math.sqrt(2 / cnt):.4f}); "
              f"backward bit-identical over two calls ({', '.join(same)}); forward "
              f"bit-identical over {', '.join(rep)} launches; forward "
              f"{t['fused_fwd']:.4f} ms on the device (CUDA graph, cold L2), "
              f"{_share(t['fused_fwd'], 'head_sample_forward', bkey)}; backward "
              f"{t['fused_bwd']:.4f} ms, {_share(t['fused_bwd'], 'head_sample_backward', bkey)}; "
              f"plain {plain[0]:.4f} / {plain[1]:.4f} ms; parent route (cast, 2 F.linear, "
              f"Triton K2) forward {t['parent_fwd']:.4f} ms, backward {t['parent_bwd']:.4f} ms "
              f"(forward+backward {t['parent_fwd_bwd']:.4f} against the fused op's "
              f"{t['fused_fwd_bwd']:.4f})")
    for shape in extra[2:]:  # the larger batches and widths, timed as the sites are
        t = head_region_ms(dev, shape, 1)
        bkey = (*shape[:3], torch.finfo(shape[3]).bits // 8)
        print(f"[kernel] head_sample {shape}: forward {t['fused_fwd']:.4f} ms, "
              f"{_share(t['fused_fwd'], 'head_sample_forward', bkey)}; backward "
              f"{t['fused_bwd']:.4f} ms, {_share(t['fused_bwd'], 'head_sample_backward', bkey)}; "
              f"parent route forward {t['parent_fwd']:.4f} ms, backward {t['parent_bwd']:.4f} ms")
    t, plain, bkey = first
    fb, fby = _bound("head_sample_forward", bkey)
    bb, bby = _bound("head_sample_backward", bkey)
    return ({"max_abs_err": worst_f, "ms": t["fused_fwd"], "plain_ms": plain[0], "bound_ms": fb,
             "bound_by": fby, "library_ms": t["parent_fwd"]},
            {"max_abs_err": worst_b, "ms": t["fused_bwd"], "plain_ms": plain[1], "bound_ms": bb,
             "bound_by": bby, "library_ms": t["parent_bwd"]})


def check_convlstm(dev, shapes) -> tuple:
    """K5 (bf16 activations, the paths' own; f32 in phase 12) at each path's
    (B, T, H, W, C, F) and at an unaligned one (5x6 positions, odd T), both
    gate dtypes, through `kernel_checks.compare_proj` and its tolerances;
    then the time of both versions at each path's shape (bf16 gates)."""
    import torch

    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import kernel_checks as kc

    worst_f = worst_b = 0.0
    for shape in (*shapes, (3, 7, 5, 6, 48, 32)):
        for gdt in (torch.float32, torch.bfloat16):
            cmp = kc.compare_proj(dev, shape, gdt)
            print(f"[kernel] convlstm_proj {shape} bf16, gates {gdt}: {cmp.text()}")
            cmp.check(f"convlstm_proj {shape} gates {gdt}")
            worst_f, worst_b = max(worst_f, cmp.fwd_err), max(worst_b, cmp.bwd_err)
    first = None
    for shape, runs in shapes.items():
        x, wx, bx, w, c0, h0 = kc.proj_inputs(dev, *shape, seed=6)
        hs, cs, ga = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, torch.bfloat16, True)
        dh = torch.randn(c0.shape, device=dev)
        ms = (_time_ms(lambda: ck.proj_forward_cuda(x, wx, bx, w, c0, h0, torch.bfloat16,
                                                    True), 5),
              _time_ms(lambda: ck.proj_forward_plain(x, wx, bx, w, c0, h0, torch.bfloat16,
                                                     True), 5),
              _time_ms(lambda: ck.proj_backward_cuda(x, wx, w, c0, h0, hs, cs, ga, dh, dh), 5),
              _time_ms(lambda: ck.proj_backward_plain(x, wx, w, c0, h0, hs, cs, ga, dh, dh), 5))
        first = first or (ms, shape)
        print(f"[kernel] convlstm_proj {shape} ({_runs(runs)}), bf16 gates: forward (saves "
              f"residuals) {ms[0]:.3f} ms, {_share(ms[0], 'convlstm_proj_forward', shape)}, vs "
              f"plain {ms[1]:.3f} ms; backward {ms[2]:.3f} ms, "
              f"{_share(ms[2], 'convlstm_proj_backward', shape)}, vs plain {ms[3]:.3f} ms; "
              f"library: none (no one PyTorch call runs the recurrence)")
    (fwd_ms, fwd_plain, bwd_ms, bwd_plain), shape = first
    same = kc.proj_backward_repeatable(dev, shape)
    _require(all(same.values()), f"convlstm_proj backward at {shape} differs between two "
                                 f"calls: {same}")
    print(f"[kernel] convlstm_proj backward at {shape}: two calls on the same inputs give "
          f"bit-identical {', '.join(same)}")
    fb, fby = _bound("convlstm_proj_forward", shape)
    bb, bby = _bound("convlstm_proj_backward", shape)
    return ({"max_abs_err": worst_f, "ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": fb,
             "bound_by": fby, "library_ms": None},
            {"max_abs_err": worst_b, "ms": bwd_ms, "plain_ms": bwd_plain, "bound_ms": bb,
             "bound_by": bby, "library_ms": None})


def check_convlstm_scan(dev, shapes) -> tuple:
    """K6 (bf16 activations) at each path's (B, T, H, W, F) with a
    time-constant xg, at the streaming last-only encoder of enc_x_kernel=3
    (config 3's B=64, T=20), and at an unaligned shape (5x6 positions, F=32,
    odd T) in both input kinds; both gate dtypes, every forward mode and
    both backward modes, through `kernel_checks.compare_scan` and its
    tolerances; then the time of both versions at each of those 8x8 shapes
    (bf16 gates), and the backward twice at config 4's shape, both input
    kinds, bit-identical.  The JSON line takes config 4's decoder."""
    import torch

    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import kernel_checks as kc

    cases = {(shape, True): runs for shape, runs in shapes.items()}
    cases[((64, 20, 8, 8, 128), False)] = ["enc_x_kernel=3 encoder, last-only"]
    worst_f = worst_b = 0.0
    for shape, const in (*cases, ((3, 7, 5, 6, 32), True), ((3, 7, 5, 6, 32), False)):
        tag = f"{shape} {'const' if const else 'streaming'}"
        for gdt in (torch.float32, torch.bfloat16):
            cmp = kc.compare_scan(dev, shape, const, gdt)
            print(f"[kernel] convlstm_scan {tag} bf16, gates {gdt}: {cmp.text()}")
            cmp.check(f"convlstm_scan {tag} gates {gdt}")
            worst_f, worst_b = max(worst_f, cmp.fwd_err), max(worst_b, cmp.bwd_err)
    times = {}
    for (shape, const), runs in cases.items():
        b, t, h, w, f = shape
        xg, wh, c0, h0 = kc.scan_inputs(dev, b, 1 if const else t, h, w, f, seed=10)
        res = ck.scan_forward_cuda(xg, wh, c0, h0, t, torch.bfloat16, "save")
        dh = torch.randn(res[0].shape, device=dev)
        dc = dh[:, -1]
        last = not const
        dh_in = dh[:, -1] if last else dh
        ms = (_time_ms(lambda: ck.scan_forward_cuda(xg, wh, c0, h0, t, torch.bfloat16,
                                                    "save"), 5),
              _time_ms(lambda: ck.scan_forward_plain(xg, wh, c0, h0, t, torch.bfloat16,
                                                     "save"), 5),
              _time_ms(lambda: ck.scan_backward_cuda(wh, c0, h0, *res, dh_in, dc, const,
                                                     last), 5),
              _time_ms(lambda: ck.scan_backward_plain(wh, c0, h0, *res, dh_in, dc, const,
                                                      last), 5))
        for run in runs:
            times[run] = (ms, (*shape, const))
        key = (*shape, const)
        print(f"[kernel] convlstm_scan {shape} {'const' if const else 'streaming'} "
              f"({_runs(runs)}), bf16 gates: forward (saves residuals) {ms[0]:.3f} ms, "
              f"{_share(ms[0], 'convlstm_scan_forward', key)}, vs plain {ms[1]:.3f} ms; "
              f"backward {ms[2]:.3f} ms, {_share(ms[2], 'convlstm_scan_backward', key)}, vs "
              f"plain {ms[3]:.3f} ms; library: none (no one PyTorch call runs the recurrence)")
    (fwd_ms, fwd_plain, bwd_ms, bwd_plain), key = times["pred_vae model.kwargs.fused=true"]
    for const in (True, False):
        same = kc.scan_backward_repeatable(dev, key[:5], const)
        _require(all(same.values()), f"convlstm_scan backward at {key[:5]} "
                                     f"{'const' if const else 'streaming'} differs between two "
                                     f"calls: {same}")
        print(f"[kernel] convlstm_scan backward at {key[:5]} "
              f"{'const' if const else 'streaming'}: two calls on the same inputs give "
              f"bit-identical {', '.join(same)}")
    fb, fby = _bound("convlstm_scan_forward", key)
    bb, bby = _bound("convlstm_scan_backward", key)
    return ({"max_abs_err": worst_f, "ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": fb,
             "bound_by": fby, "library_ms": None},
            {"max_abs_err": worst_b, "ms": bwd_ms, "plain_ms": bwd_plain, "bound_ms": bb,
             "bound_by": bby, "library_ms": None})

# check_model's limit for f32 activations with f32 gates: both devices in
# f32 (the card's products 3xTF32, about 2^-21 of a product), other
# summation orders
_F32_MODEL_LIMIT = 1e-4


def _rel_l2(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check_model(dev, name: str, frames: int, overrides=(), act: str = "bfloat16") -> None:
    """A config's model at full width on a small input (2 clips x `frames`
    frames): forward and every parameter gradient on the card, through the
    kernels (the heads through the fused head and sample, eps injected),
    against the same model on the CPU, through the plain versions, with
    `act` activations, f32 gates and bf16 gates (production).  Where a
    side rounds to bf16 (bf16 activations, or bf16 gates), the two devices
    round different partial sums, so each tensor is held to the CPU's f32
    result: the card's relative L2 distance to it at most max(2 x the CPU
    one's, 0.05) (as tests/test_torch_models.py holds the port's bf16 run
    to JAX's).  f32 activations with f32 gates are f32 throughout on both
    sides (TF32 off; the kernels' products 3xTF32), so each tensor is held
    to the CPU's directly: relative L2 at most max(2 x the card's own
    plain route's (`kernel_checks.plain_route`: cuDNN's and cuBLAS's f32
    on the card, no kernel of the repo), _F32_MODEL_LIMIT)."""
    import copy

    import torch

    from mmvae_torch.configs import get_config
    from mmvae_torch.ops.dispatch import make_sample_fn
    from mmvae_torch.ops.elbo_kernels import elbo_reduce
    from mmvae_torch.ops.kernel_checks import plain_route
    from mmvae_torch.train.loop import build_model

    g = torch.Generator().manual_seed(7)
    x = (torch.rand(2, frames, 64, 64, generator=g) < 0.35).float()
    # eps per sampling site (salt), drawn once on the CPU and injected through
    # the train step's sample function, so every head runs the fused op
    kw = _model_kwargs(get_config(name, overrides))
    if name == "hier_vae":
        sites = {0: (2, kw["global_latent"]),
                 1: (2 * (frames // kw["chunk_len"]), kw["chunk_latent"])}
    else:
        sites = {0: (2, kw["latent_dim"])}
    noise = {salt: torch.randn(shape, generator=g) for salt, shape in sites.items()}

    def run(model, device):
        out = model(x.to(device), make_sample_fn(0, noise))
        bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
        ((bce + kl + out.extra_kl) / 2).backward()
        res = {"logits": out.logits, "mu": out.mu, "logvar": out.logvar}
        res.update((n, p.grad) for n, p in model.named_parameters())
        return {n: t.detach().float().cpu() for n, t in res.items()}

    def config(dtype, gate_bf16):
        cfg = get_config(name, (f"model.dtype={dtype}", *overrides))
        cfg.model.kwargs["gate_bf16"] = gate_bf16
        return cfg

    # Same seed, so the same f32 weights for every dtype.
    truth = run(build_model(config("float32", False), device="cpu"), torch.device("cpu"))
    tag = "bf16" if act == "bfloat16" else "f32"
    for gate_bf16 in (False, True):
        ref_model = build_model(config(act, gate_bf16), device="cpu")
        plain = truth if act == "float32" and not gate_bf16 else run(ref_model,
                                                                    torch.device("cpu"))
        kern = run(copy.deepcopy(ref_model).to(dev), dev)
        exact = act == "float32" and not gate_bf16
        if exact:
            with plain_route():
                witness = run(copy.deepcopy(ref_model).to(dev), dev)
        worst = (0.0, "")
        for tname, b in plain.items():
            a = kern[tname]
            if exact:
                e, e_w = _rel_l2(a, b), _rel_l2(witness[tname], b)
                lim = max(2 * e_w, _F32_MODEL_LIMIT)
                _require(e <= lim, f"model {name} f32 gates f32 {tname}: rel L2 card vs CPU "
                                   f"{e:.2e}, the card's plain route {e_w:.2e} (limit "
                                   f"{lim:.2e})")
                worst = max(worst, (e / lim, f"{tname} (card vs CPU {e:.2e}, the card's plain "
                                             f"route {e_w:.2e}, limit {lim:.2e})"))
                continue
            e_k, e_p = _rel_l2(a, truth[tname]), _rel_l2(b, truth[tname])
            lim = max(2 * e_p, 0.05)
            _require(e_k <= lim, f"model {name} {tag} gates {'bf16' if gate_bf16 else 'f32'} "
                                 f"{tname}: rel L2 to f32 {e_k:.3f} on the card, {e_p:.3f} on "
                                 f"the CPU (limit {lim:.3f})")
            worst = max(worst, (e_k / lim, f"{tname} (card {e_k:.3f}, CPU {e_p:.3f}, "
                                            f"card vs CPU {_rel_l2(a, b):.3f})"))
        what = "CPU's f32 result" if exact else "f32 result"
        print(f"[model] {name} {' '.join(overrides)} {tag}, gates "
              f"{'bf16' if gate_bf16 else 'f32'} (2 x {frames} x 64x64), card with kernels vs "
              f"CPU with plain versions, over {len(plain)} tensors: worst rel L2 to the {what}, "
              f"{worst[0]:.3f} of its limit (must be <= 1), at {worst[1]}")


def check_perframe_model(dev, name: str) -> None:
    """Config 1 or 2 at full width in its own dtype (f32) on a small input
    (4 frames): forward and every parameter gradient on the card, through
    the kernels (the head through the fused head and sample, eps injected),
    against the same model on the CPU through the plain versions.  TF32 is
    off, so both run f32 throughout and differ only in summation order:
    each tensor's relative L2 distance at most 1e-4."""
    import copy

    import torch

    from mmvae_torch.configs import get_config
    from mmvae_torch.ops.dispatch import make_sample_fn
    from mmvae_torch.ops.elbo_kernels import elbo_reduce
    from mmvae_torch.train.loop import build_model

    g = torch.Generator().manual_seed(8)
    cfg = get_config(name)
    _require(cfg.model.dtype == "float32", f"{name}: expected an f32 config")
    x = (torch.rand(4, 64, 64, generator=g) < 0.35).float()
    noise = {0: torch.randn(4, _model_kwargs(cfg)["latent_dim"], generator=g)}

    def run(model, device):
        out = model(x.to(device), make_sample_fn(0, noise))
        bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
        ((bce + kl) / 4).backward()
        res = {"logits": out.logits, "mu": out.mu, "logvar": out.logvar, "z": out.z}
        res.update((n, p.grad) for n, p in model.named_parameters())
        return {n: t.detach().float().cpu() for n, t in res.items()}

    model = build_model(cfg, device="cpu")
    plain = run(model, torch.device("cpu"))
    kern = run(copy.deepcopy(model).to(dev), dev)
    worst = max((_rel_l2(kern[n], b), n) for n, b in plain.items())
    _require(worst[0] <= 1e-4, f"model {name}: {worst[1]} rel L2 card vs CPU {worst[0]:.2e} "
                               f"(limit 1e-4)")
    print(f"[model] {name} f32 (4 x 64x64), card with kernels vs CPU with plain versions, "
          f"over {len(plain)} tensors: worst rel L2 {worst[0]:.2e} at {worst[1]} (limit 1e-4)")


def check_decoder_modes(dev) -> None:
    """The frame decoder alone in each mode the recipe does not run, at
    seq_vae's channels on (16, 128, 8, 8): logits and every gradient (input
    and parameters) on the card (cuDNN) against the CPU, held as
    `check_model` holds a model: bf16 on each device against the CPU's f32,
    the card's relative L2 distance at most max(2 x the CPU bf16 one's, 0.05)."""
    import copy

    import torch

    from mmvae_torch.models.base import ConvDecoder, flax_init_

    g = torch.Generator().manual_seed(9)
    h = torch.randn(16, 128, 8, 8, generator=g)
    cot = torch.randn(16, 1, 64, 64, generator=g)
    for mode in ("fast_midw", "fast_hq", "fast_k4tail", "transpose"):
        def decoder(dtype):  # the same seed: the same f32 weights for every dtype
            return flax_init_(ConvDecoder(128, (128, 64, 32), dtype=dtype, upsample=mode),
                              torch.Generator().manual_seed(4))

        def run(m, device):
            m = copy.deepcopy(m).to(device)
            x = h.to(device).detach().requires_grad_()  # a leaf on every device
            out = m(x)
            (out * cot.to(device)).sum().backward()
            res = {"logits": out, "d input": x.grad}
            res.update((f"d {n}", p.grad) for n, p in m.named_parameters())
            return {n: t.detach().float().cpu() for n, t in res.items()}

        truth = run(decoder(torch.float32), "cpu")
        bf16 = decoder(torch.bfloat16)
        plain, kern = run(bf16, "cpu"), run(bf16, dev)
        worst = (0.0, "")
        for name, b in plain.items():
            e_k, e_p = _rel_l2(kern[name], truth[name]), _rel_l2(b, truth[name])
            lim = max(2 * e_p, 0.05)
            _require(e_k <= lim, f"decoder {mode} {name}: rel L2 to f32 {e_k:.3f} on the card, "
                                 f"{e_p:.3f} on the CPU (limit {lim:.3f})")
            worst = max(worst, (e_k / lim, f"{name} (card {e_k:.4f}, CPU {e_p:.4f})"))
        print(f"[model] ConvDecoder upsample={mode} bf16 (16 x 128 x 8 x 8 -> 64x64), card vs "
              f"CPU over {len(plain)} tensors: worst rel L2 to the f32 result over its limit "
              f"{worst[0]:.3f} (must be <= 1) at {worst[1]}")


def check_ongen(dev) -> None:
    """On-card clip generation (`data.ongen`) at the recipe's batch, 64 clips
    x 20 frames: from the same draws byte-identical to the CPU, with TF32
    off and then on; from the train step's own generator (the clip function
    a step calls, seeded as step 0 seeds it) every sprite's corner inside
    [0, lim] at every frame, every frame holding at least one sprite's
    mass, and the mean intensity within 5 % of the host generator's over
    the same count of clips; the time of one batch."""
    import torch

    from mmvae_torch.data import loader, ongen
    from mmvae_torch.ops.seeds import STREAM_ONGEN, step_seed, stream_seed

    b, t = 64, 20
    cpu, card = ongen.Canvas(b, t, 64, device="cpu"), ongen.Canvas(b, t, 64, device=dev)
    draws = cpu.draw(11, 2)
    want = cpu.render(draws)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            got = card.render(ongen.Draws(*(d.to(dev) for d in draws))).cpu()
            diff = int((got.int() - want.int()).abs().max())
            _require(diff == 0, f"ongen: the card's clips differ from the CPU's by up to {diff} "
                                f"with allow_tf32={tf32}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    seed = stream_seed(step_seed(0), STREAM_ONGEN)
    fn = ongen.clip_batch_fn(b, (t, 64, 64), device=dev)
    clips = fn(seed)
    own = card.draw(torch.tensor(seed, device=dev), 2)
    _require(torch.equal(card.render(own), clips), "ongen: the clip function's clips are not "
                                                    "those of its seed's draws")
    host_clips = ongen.clip_batch_fn(b, (t, 64, 64), device="cpu")(seed)
    _require(torch.equal(clips.cpu(), host_clips), "ongen: the card's clips of a seed differ "
                                                   "from the CPU's (counter-based draws)")
    yx = card.positions(own)
    _require(clips.dtype == torch.uint8 and clips.shape == (b, t, 64, 64)
             and int(clips.max()) > 0, f"ongen: clips {clips.dtype} {tuple(clips.shape)}")
    _require(int(yx.min()) >= 0 and int(yx.max()) <= card.lim,
             f"ongen: a corner outside [0, {card.lim}]: {int(yx.min())} .. {int(yx.max())}")
    mass = clips.float().sum(dim=(2, 3))
    least = 255.0 * float(ongen.sprite_table().sum(axis=(1, 2)).min())
    _require(bool((mass >= least).all()), "ongen: a frame lost a digit's mass")
    mean = clips.double().mean().item()
    host = float(loader.generate_moving_mnist(b, seq_len=t, seed=0).mean(dtype="float64"))
    rel = abs(mean - host) / host
    _require(rel < 0.05, f"ongen: mean intensity {mean:.3f} against the host's {host:.3f}")
    ms = _time_ms(lambda: fn(seed), 20)
    prof = _device_profile(lambda: fn(seed), 20)
    print(f"[ongen] {b} x {t} x 64x64 u8: byte-identical to the CPU from the same draws with "
          f"TF32 off and on, and from the same seed (counter-based draws); corners in [{int(yx.min())}, {int(yx.max())}] (limit 0..{card.lim:g}); "
          f"least frame mass {float(mass.min()):.0f} (>= {least:.0f}); mean intensity {mean:.3f} "
          f"against the host generator's {host:.3f} ({100 * rel:.2f} %, limit 5 %); one batch "
          f"{prof['busy_ms']:.4f} ms busy on the device in {prof['kernels']:.0f} kernel launches "
          f"(profiler), {ms:.4f} ms "
          f"back to back from the host (CUDA events)")


def _device_profile(fn, calls: int) -> dict:
    """One warm call of `fn`, then `calls` calls under the profiler: ms a
    call on the host's clock; the device's busy ms a call (the union of its
    activity's intervals), its kernel-busy and copy-busy ms; kernel
    launches a call; and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mmvae_torch.bench.profile import device_busy_ms

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / calls
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    busy = device_busy_ms(events) / calls
    return {"call_ms": wall, "busy_ms": busy, "kernel_ms": device_busy_ms(kernels) / calls,
            "copy_ms": device_busy_ms(copies) / calls, "kernels": len(kernels) / calls,
            "idle": 1 - busy / wall}


def phase_kernels(dev) -> dict:
    shapes = path_shapes()
    fwd, bwd = check_convlstm(dev, shapes["proj"])
    sfwd, sbwd = check_convlstm_scan(dev, shapes["scan"])
    hfwd, hbwd = check_head_sample(dev, shapes["head"])
    return {
        "preprocess_gather": check_preprocess(dev, shapes["preprocess"]),
        "elbo_reduce": check_elbo(dev, shapes["elbo"]),
        "reparameterize": check_reparam(dev, shapes["reparam"]),
        "head_sample_forward": hfwd,
        "head_sample_backward": hbwd,
        "convlstm_proj_forward": fwd,
        "convlstm_proj_backward": bwd,
        "convlstm_scan_forward": sfwd,
        "convlstm_scan_backward": sbwd,
    }


def phase_models(dev) -> None:
    check_perframe_model(dev, "mlp_vae")
    check_perframe_model(dev, "conv_vae")
    check_model(dev, "seq_vae", 4)
    check_model(dev, "seq_vae", 4, _RECIPE[:1])
    check_model(dev, "pred_vae", 20, ("model.kwargs.fused=true",))
    check_model(dev, "hier_vae", 20, ("model.kwargs.fused=true",))
    check_decoder_modes(dev)
    check_ongen(dev)


# The reference's recommended quality configuration (README.md:98,
# docs/RESULTS.md:891-896): config 3 with the fast_mid decoder, clips
# generated on the card every step, and a parameter EMA.
_RECIPE = ("model.kwargs.dec_upsample=fast_mid", "data.on_device_generate=true",
           "optim.ema_decay=0.999")
# (config, overrides, kernels that must launch, kernels that must not); K6
# joins one or the other by the decoder's policy (`_slice_kernels`)
_SLICES = (
    ("seq_vae", (), _STEP + _K5, _K2),
    ("pred_vae", ("model.kwargs.fused=true",), _STEP + _K5, _K2),
    ("hier_vae", ("model.kwargs.fused=true",), _STEP + _K5, _K2),
    ("seq_vae", _RECIPE, _STEP + _K5, _K2),
)
# Policy measurement: config 3 with fused=false (both recurrences on the eager
# loop), beside the default.
_POLICY = ("seq_vae", ("model.kwargs.fused=false",), _STEP, _K5 + _K2)


def _slice_kernels(name: str, overrides, launched, idle) -> tuple:
    """(launched, idle) of a slice with K6 added to the one its decoder's
    policy puts it in (`_dec_k6`)."""
    from mmvae_torch.configs import get_config

    if _dec_k6(get_config(name, overrides)):
        return launched + _K6, idle
    return launched, idle + _K6

# The fit runs' one cut: a 2,000-clip procedural set (data generation ~3 s).
_CUT = ("data.num_sequences=2000",)
_STREAMING = ("data.device_resident=false",)
# The paths the fit phase drives: (tag, config, overrides that set a shape).
_FIT_PATHS = (
    ("fit seq_vae streaming", "seq_vae", _CUT + _STREAMING),
    ("fit mlp_vae", "mlp_vae", _CUT),
    ("fit conv_vae", "conv_vae", _CUT),
    ("fit pred_vae fused", "pred_vae", _CUT + ("model.kwargs.fused=true",)),
    ("fit recipe", "seq_vae", _CUT + _RECIPE),
)


def run_slice(card: str, name: str, overrides, launched, idle) -> dict:
    """One path at full width through `run_benchmark`, with the launch
    counters set to 0 just before it and read just after."""
    from mmvae_torch import ops
    from mmvae_torch.bench.throughput import run_benchmark
    from mmvae_torch.configs import get_config

    cfg = get_config(name, overrides)
    base = get_config(name)
    _require(cfg.data.batch_size == base.data.batch_size and cfg.data.seq_len == base.data.seq_len
             and cfg.model.dtype == "bfloat16", f"{name} is not the full-width config")
    launched, idle = _slice_kernels(name, overrides, launched, idle)
    ops.reset_launch_counts()
    res, state = run_benchmark(cfg, steps=20, warmup=5, return_state=True)
    counts = _counts()
    losses = res.pop("losses")
    tag = _tag(name, overrides)
    if cfg.optim.ema_decay:
        _check_ema(tag, cfg, state)
    _require(all(math.isfinite(v) for v in losses), f"{tag}: non-finite loss in {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    _require(last < first, f"{tag}: loss did not fall: first 5 mean {first:.1f}, last 5 {last:.1f}")
    _require(all(counts[k] > 0 for k in launched), f"{tag}: a kernel was not launched: {counts}")
    _require(all(counts[k] == 0 for k in idle), f"{tag}: a kernel off this path ran: {counts}")
    _require(res["mfu"] is not None and 0 < res["mfu"] <= 1, f"{tag}: mfu {res['mfu']}")
    print(f"[slice] {tag}: {len(losses)} train steps, loss first-5 mean {first:.2f} -> "
          f"last-5 mean {last:.2f}; launches {counts}")
    print(f"[slice] {json.dumps(res)}")
    per_step = sum(counts.values()) / len(losses)
    print(f"[slice] {tag}: {res['value']} frames/s/GPU (min {res['value_min']}, max "
          f"{res['value_max']}, spread {res['spread_pct']}%), {per_step:.2f} kernel-wrapper "
          f"launches a step, on {card}")
    return counts


def _check_ema(tag: str, cfg, state) -> None:
    """After the run the EMA differs from the initial parameters (the
    config's seed rebuilds them) and from the live ones, and is finite."""
    import torch

    from mmvae_torch.train.loop import build_model

    init = {n: p.detach() for n, p in build_model(cfg, "cpu").named_parameters()}
    live = dict(state.model.named_parameters())
    ema = {n: e.detach().cpu() for n, e in state.ema_params.items()}
    _require(set(ema) == set(live), f"{tag}: the EMA's names differ from the parameters'")
    _require(all(bool(torch.isfinite(e).all()) for e in ema.values()), f"{tag}: EMA not finite")
    off_init = max(float((e - init[n]).abs().max()) for n, e in ema.items())
    off_live = max(float((e - live[n].detach().cpu()).abs().max()) for n, e in ema.items())
    _require(off_init > 0 and off_live > 0, f"{tag}: the EMA did not move off the initial "
                                            f"({off_init}) or the live ({off_live}) parameters")
    print(f"[slice] {tag}: after {state.step} steps the EMA lies up to {off_init:.3e} from the "
          f"initial parameters and up to {off_live:.3e} from the live ones")


def _tag(name: str, overrides) -> str:
    return " ".join((name, *overrides))


def phase_slice(card: str) -> dict:
    """Configs 3, 4 and 5; then config 3 with fused=false (policy
    measurement).  Returns {path: that run's launch counts}."""
    return {_tag(name, overrides): run_slice(card, name, overrides, launched, idle)
            for name, overrides, launched, idle in (*_SLICES, _POLICY)}


# --- phase 5: fit --------------------------------------------------------------


def _ckpt_dir(workdir: str, name: str) -> str:
    """Where the fit phase saves `name`'s run (config 3 streamed, config 4
    fused), which the CLI phase samples from."""
    import os

    return os.path.join(workdir, {"seq_vae": "seq_vae_streaming", "pred_vae": "pred_vae"}[name])


def _checksums(batch):
    """Two position-weighted int64 sums of a u8 batch, on its device."""
    import torch

    flat = batch.reshape(-1).long()
    w = torch.arange(flat.numel(), device=flat.device) % 65521 + 1
    return torch.stack([flat.sum(), (flat * w).sum()])


def _host_checksums(batch) -> list:
    import numpy as np

    flat = batch.reshape(-1).astype(np.int64)
    w = np.arange(flat.size, dtype=np.int64) % 65521 + 1
    return [int(flat.sum()), int((flat * w).sum())]


def _checked_feed():
    """A DeviceFeed that sums each batch it hands over on the consumer's
    stream (no host sync); `sums` holds them in order."""
    from mmvae_torch.data.feed import DeviceFeed

    class CheckedFeed(DeviceFeed):
        sums: list = []

        def __next__(self):
            batch = super().__next__()
            CheckedFeed.sums.append(_checksums(batch))
            return batch

    return CheckedFeed


def _counts(general: bool = False) -> dict:
    """`ops.launch_counts()`, after requiring that every K5 and K6 launch
    since the counts were set to 0 ran on the general route if `general`,
    else on the wgmma kernels (`ops.launch_counts_by_route`)."""
    from mmvae_torch import ops

    off = "wgmma" if general else "general"
    stray = {k: n for k, n in ops.launch_counts_by_route().items() if k.endswith(off) and n}
    _require(not stray, f"K5 / K6 launches on the {off} route: {stray}")
    return ops.launch_counts()


def _fit(card: str, tag: str, cfg, steps: int, want: dict, device,
         general: bool = False) -> tuple:
    """One `fit` run with the launch counters set to 0 just before it and
    read just after; `want` maps kernel wrappers to the count the run must
    launch (every other kernel: 0), K5 and K6 all on the general route if
    `general`, else all on the wgmma kernels.  Returns (state, history,
    counts)."""
    import torch

    from mmvae_torch import ops
    from mmvae_torch.train.loop import fit

    print(f"[fit] {tag}: {steps} steps (to {steps}), on {card}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = fit(cfg, max_steps=steps, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(general)
    _require(all(counts[k] == want.get(k, 0) for k in counts),
             f"{tag}: launches {counts}, expected {want} (others 0)")
    _require(history and all(math.isfinite(h["loss"]) for h in history),
             f"{tag}: a non-finite loss in {history}")
    fps = [h["frames_per_sec"] for h in history if "frames_per_sec" in h]
    print(f"[fit] {tag}: {len(history)} lines logged, {wall:.2f} s wall (set-up and data "
          f"included); frames/s from the logger's windows {[round(v, 1) for v in fps]}; "
          f"launches {counts}")
    return state, history, counts


def _fit_cfg(name: str, overrides, *cadence):
    """The full-width config of a fit run, in one process (on a host with
    more cards too) unless `overrides` or `cadence` say otherwise."""
    from mmvae_torch.configs import get_config

    cfg = get_config(name, ("train.data_parallel=false", *overrides, *cadence))
    base = get_config(name)
    _require(cfg.data.batch_size == base.data.batch_size and cfg.data.seq_len == base.data.seq_len
             and cfg.model.dtype == base.model.dtype and cfg.model.kwargs.items()
             >= base.model.kwargs.items(), f"fit {name} is not the full-width config")
    return cfg


def _step_counts(train: int, evals: int, k5: bool = True, k6: bool = False) -> dict:
    """The launches of `train` train steps and `evals` eval batches of a
    path with one sampling site: K1, K3 and the head's forward once a train
    step and once an eval batch, the backwards once a train step; K5 and K6
    where the path runs them."""
    want = {"preprocess_gather": train + evals, "elbo_reduce": train + evals,
            "head_sample_forward": train + evals, "head_sample_backward": train}
    if k5:
        want.update(convlstm_proj_forward=train + evals, convlstm_proj_backward=train)
    if k6:
        want.update(convlstm_scan_forward=train + evals, convlstm_scan_backward=train)
    return want


def _state_tensors(state) -> dict:
    """Parameters, the optimizer's per-parameter state and the EMA, by name."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {f"param {n}": p.detach() for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        out.update((f"{k} {names[id(p)]}", v) for k, v in st.items())
    out.update((f"ema {n}", e) for n, e in (state.ema_params or {}).items())
    return out


def fit_streaming_and_resume(card: str, dev, workdir: str) -> dict:
    """Config 3 streamed from the host through DeviceFeed: 60 steps with an
    eval pass of 2 batches every 20 and a checkpoint every 20; every batch
    the feed hands over summed on the card against the host's stream; the
    checkpoint restored into a fresh state bit for bit; standalone
    `evaluate` at step 60 against the in-training val metrics; the time of
    one eval pass and one checkpoint save; then a resume to 80 steps, fed
    the host batches 60-79 and logging from step 70.  Returns the launch
    counts of both runs."""
    import itertools
    import os

    import torch

    import mmvae_torch.train.loop as loop
    from mmvae_torch.data.loader import load_or_generate
    from mmvae_torch.train import checkpoint as ckpt
    from mmvae_torch.train.loop import evaluate, make_eval_step
    from mmvae_torch.train.state import create_train_state

    ckdir = _ckpt_dir(workdir, "seq_vae")
    cfg = _fit_cfg("seq_vae", _CUT + _STREAMING, "train.log_every=10", "train.eval_every=20",
                   "train.eval_batches=2", "train.checkpoint_every=20",
                   f"train.checkpoint_dir={ckdir}")
    feed = _checked_feed()
    real_feed, loop.DeviceFeed = loop.DeviceFeed, feed
    try:
        tag = "fit seq_vae streaming"
        state, history, counts = _fit(card, tag, cfg, 60,
                                      _step_counts(60, 3 * 2, k6=_dec_k6(cfg)), dev)
        sums, feed.sums[:] = torch.stack(feed.sums).cpu().tolist(), []
        data = dict(num_sequences=cfg.data.num_sequences, seq_len=cfg.data.seq_len,
                    seed=cfg.data.seed)
        split = load_or_generate(None, **data)
        host = [_host_checksums(b) for b in itertools.islice(
            split.batches(cfg.data.batch_size, seed=cfg.data.seed), 80)]
        _require(sums == host[:60], f"{tag}: of {len(sums)} batches handed over, "
                                    f"{sum(a != b for a, b in zip(sums, host))} differ from the "
                                    f"host's")
        print(f"[fit] {tag}: all {len(sums)} batches the feed handed over equal the host "
              f"stream's (two position-weighted sums each, taken on the card)")
        _require([h["step"] for h in history] == [10, 20, 30, 40, 50, 60]
                 and all("val_loss" in history[i] for i in (1, 3, 5)),
                 f"{tag}: logged {[sorted(h) for h in history]}")

        fresh, step, data_step = ckpt.restore_latest(
            ckdir, create_train_state(loop.build_model(cfg, dev), cfg.optim))
        want, got = _state_tensors(state), _state_tensors(fresh)
        _require((step, data_step, fresh.step) == (60, 60, 60) and set(want) == set(got)
                 and all(torch.equal(want[k], got[k].to(want[k].device)) for k in want),
                 f"{tag}: the restored state differs from the saved one (step {step}, data "
                 f"{data_step}; {[k for k in want if not torch.equal(want[k], got[k])]})")
        print(f"[fit] {tag}: checkpoint of step 60 restored bit-identical over {len(want)} "
              f"tensors (parameters, Adam moments and step counts), data cursor 60")

        res = evaluate(cfg, ckdir, max_batches=2, device=dev)
        logged = history[-1]
        rel = max(abs(res[k] - logged[k]) / abs(logged[k]) for k in ("val_loss", "val_bce",
                                                                       "val_kl"))
        _require(res["step"] == 60 and res["batches"] == 2 and rel <= 1e-5,
                 f"{tag}: evaluate {res} against the in-training {logged} (rel {rel:.2e})")
        print(f"[fit] {tag}: standalone evaluate at step 60 {res}; against the in-training "
              f"val metrics worst rel diff {rel:.2e} (limit 1e-5)")

        # one eval pass (2 staged batches) and one checkpoint save, timed
        eval_step = make_eval_step(state.model, binarize=cfg.data.binarize)
        val = [(torch.from_numpy(b).to(dev), 1 + n) for n, b in zip(range(2), load_or_generate(
            None, train=False, **data).batches(cfg.data.batch_size, seed=1, num_epochs=1))]
        passes = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.stack([eval_step(None, vb, sd)["loss"] for vb, sd in val]).tolist()
            passes.append(1e3 * (time.perf_counter() - t0))
        spare = os.path.join(workdir, "timed_save")
        t0 = time.perf_counter()
        ckpt.save(spare, state, 60, data_step=60)
        t1 = time.perf_counter()
        ckpt.wait_until_finished(spare)
        t2 = time.perf_counter()
        size = os.path.getsize(os.path.join(spare, "60", "state.pt")) / 2 ** 20
        print(f"[fit] {tag}: one eval pass of 2 batches x {cfg.data.batch_size} x "
              f"{cfg.data.seq_len} frames {sorted(passes)[2]:.2f} "
              f"ms (median of 5, host clock to a synchronize); one checkpoint save "
              f"{1e3 * (t1 - t0):.1f} ms on the train loop (host copies) + "
              f"{1e3 * (t2 - t1):.1f} ms on the writer thread ({size:.1f} MiB), on {card}")

        cfg.train.resume = True
        _, resumed, counts2 = _fit(card, tag + " resumed", cfg, 80,
                                   _step_counts(20, 2, k6=_dec_k6(cfg)), dev)
        sums = torch.stack(feed.sums).cpu().tolist()
        _require(sums == host[60:80], f"{tag} resumed: the feed did not hand over the host "
                                      f"batches 60-79")
        _require([h["step"] for h in resumed] == [70, 80] and "val_loss" in resumed[-1],
                 f"{tag} resumed: logged {[h['step'] for h in resumed]}")
        print(f"[fit] {tag} resumed: fed the host batches 60-79, logged steps 70 and 80")
    finally:
        loop.DeviceFeed = real_feed
    return {tag: counts, tag + " resumed": counts2}


def phase_fit(card: str, dev, workdir: str) -> dict:
    """`fit` at full width on the card (the one cut: a 2,000-clip procedural
    set), each run with the launch equations of its path: config 3 streamed
    through DeviceFeed with checkpoints, restore, `evaluate` and a resume;
    configs 1 and 2 resident, 40 steps and one eval pass; config 4 with
    fused=true, 20 steps and one eval pass (K6's no-residual forward under
    eval) and its last step saved for the CLI phase (`_ckpt_dir`); the
    recipe, 40 steps and one eval pass raw and under the EMA.  Returns
    {path: that run's launch counts}."""
    print(f"[fit] the fit runs' one cut: {_CUT[0]} (procedural data), nothing else")
    out = {}
    out.update(fit_streaming_and_resume(card, dev, workdir))
    cadence = ("train.log_every=10", "train.eval_batches=2")
    for tag, name, overrides in _FIT_PATHS[1:]:
        steps = 20 if name == "pred_vae" else 40
        saves = (f"train.checkpoint_dir={_ckpt_dir(workdir, name)}",) if name == "pred_vae" else ()
        cfg = _fit_cfg(name, overrides, *cadence, f"train.eval_every={steps}", *saves)
        ema = bool(cfg.optim.ema_decay)
        evals = 2 * (2 if ema else 1)
        want = _step_counts(steps, evals, k5=name not in ("mlp_vae", "conv_vae"),
                            k6=_dec_k6(cfg))
        state, history, counts = _fit(card, tag, cfg, steps, want, dev)
        last = history[-1]
        _require(history[-1]["loss"] < history[0]["loss"],
                 f"{tag}: loss did not fall: {[round(h['loss'], 1) for h in history]}")
        keys = ("val_loss", "val_loss_ema") if ema else ("val_loss",)
        _require(all(math.isfinite(last.get(k, math.nan)) for k in keys),
                 f"{tag}: the last line lacks {keys}: {last}")
        if ema:
            _require(last["val_loss"] != last["val_loss_ema"], f"{tag}: the EMA scores as the "
                                                               f"live parameters")
        print(f"[fit] {tag}: loss {history[0]['loss']:.2f} at step {history[0]['step']} -> "
              f"{last['loss']:.2f} at {last['step']}; "
              + ", ".join(f"{k} {last[k]:.2f}" for k in keys))
        out[tag] = counts
    return out


# --- phase 6: sampling and the CLI ------------------------------------------

_FUSED = ("model.kwargs.fused=true",)
# Every model and mode the CLI offers: (config, overrides, modes).
_SAMPLE_PATHS = (
    ("mlp_vae", (), ("prior", "reconstruct")),
    ("conv_vae", (), ("prior", "reconstruct")),
    ("seq_vae", (), ("prior", "reconstruct")),
    ("seq_vae", _FUSED, ("prior", "reconstruct")),
    ("pred_vae", _FUSED, ("prior", "reconstruct", "rollout")),
    ("hier_vae", _FUSED, ("prior", "reconstruct")),
)
_SAMPLE_WINDOWS, _SAMPLE_CALLS, _SAMPLE_WARMUP = 3, 5, 2


def _sample_want(cfg, mode: str, cli: bool = False) -> dict:
    """One sampling call's launches by kernel and mode
    (`ops.launch_counts_by_mode`; every key not named: 0).  A posterior
    draw is one fused head forward (two on hier_vae: z_g and the chunks);
    hier_vae's prior chain one a chunk; a sequence model's encoder K5
    without residuals; a decoder on K6 (`_dec_k6`) K6's "hs" mode; the
    CLI's clips one K3 (u8 / 255)."""
    name, kw = cfg.model.name, cfg.model.kwargs
    seq = not cfg.data.per_frame
    want = {}
    if mode != "prior":
        want["head_sample_forward"] = 2 if name == "hier_vae" else 1
        if seq:
            want["convlstm_proj_forward nores"] = 1
        if cli:
            want["preprocess_gather"] = 1
    elif name == "hier_vae":
        want["head_sample_forward"] = cfg.data.seq_len // kw["chunk_len"]
    if _dec_k6(cfg):
        want["convlstm_scan_forward hs"] = 1
    return want


def _check_counts(tag: str, counts: dict, want: dict, calls: int = 1) -> None:
    full = {k: calls * want.get(k, 0) for k in counts}
    _require(set(want) <= set(counts) and counts == full,
             f"{tag}: launches {counts}, expected {full}")


def _sample_call(cfg, mode: str, batch: int, seed: int, g=None, device="cpu"):
    """(`fn(model) -> frames`, frames a call): one call of the generate API
    in `mode` at `batch`, as the CLI makes it (the prior over the config's
    clip length; rollout from `context_len` frames to the clip's end), with
    every draw injected from the CPU generator `g`, or drawn on the model's
    device from `seed` when `g` is None.  Input frames are made on the CPU
    and put on `device` once; a call moves them to its model's device."""
    import torch

    from mmvae_torch.models.hier_vae import CHAIN_SALT
    from mmvae_torch.sample import generate as gen

    kw = _model_kwargs(cfg)
    t, name = cfg.data.seq_len, cfg.model.name
    g0 = g or torch.Generator().manual_seed(seed)
    latent = kw.get("latent_dim", kw.get("global_latent"))

    def randn(*shape):
        return torch.randn(shape, generator=g0) if g is not None else None

    if mode == "prior":
        seq_len = None if cfg.data.per_frame else t
        if g is None:
            draws = {}
        elif name == "hier_vae":
            draws = {"z_g": randn(batch, latent),
                     "eps": {CHAIN_SALT + k: randn(batch, kw["chunk_latent"])
                             for k in range(t // kw["chunk_len"])}}
        else:
            draws = {"z": randn(batch, latent)}
        return (lambda m: gen.prior_sample(m, seed, batch, seq_len=seq_len, **draws),
                batch * (seq_len or 1))
    shape = (batch, 64, 64) if cfg.data.per_frame else (batch, t, 64, 64)
    x = (torch.randint(0, 256, shape, generator=g0).float() / 255.0).to(device)  # u8 / 255
    if mode == "reconstruct":
        sites = {0: (batch, latent)}
        if name == "hier_vae":
            sites[1] = (batch * t // kw["chunk_len"], kw["chunk_latent"])
        eps = None if g is None else {s: randn(*sh) for s, sh in sites.items()}
        frames = batch * (t - kw["context_len"] if name == "pred_vae" else
                          1 if cfg.data.per_frame else t)
        return (lambda m: gen.reconstruct(m, x.to(next(m.parameters()).device), seed, eps=eps),
                frames)
    ctx = kw["context_len"]
    eps = None if g is None else {0: randn(batch, latent)}
    return (lambda m: gen.rollout(m, x[:, :ctx].to(next(m.parameters()).device), t - ctx,
                                  seed, eps=eps), batch * (t - ctx))


def check_sampling(card: str, dev, name: str, overrides, modes, general: bool = False) -> dict:
    """One model at full width, each mode: on the card through the kernels
    against the CPU through the plain versions, from the same weights and
    the same injected draws on 2 clips (f32 throughout, configs 1 and 2:
    relative L2 at most 1e-4, as `check_perframe_model`; models that round
    to bf16, their activations or their gates: the card's relative L2 to
    the CPU's f32 frames with f32 gates at most max(2 x the CPU one's,
    0.05), as `check_model`; frames held less 0.5), with that call's launch
    equations; then frames/s at the config's batch, drawn on the card from
    a seed, over 3 windows of 5 calls after 2 warmup calls (each call
    copies its frames to the host), and the launch equations of those 17
    calls.  Returns {path: counts}."""
    import copy

    import numpy as np
    import torch

    from mmvae_torch import ops
    from mmvae_torch.configs import get_config
    from mmvae_torch.train.loop import build_model

    cfg = get_config(name, overrides)
    tag = _tag(name, overrides)
    plain_model = build_model(cfg, device="cpu")
    card_model = copy.deepcopy(plain_model).to(dev)
    f32 = cfg.model.dtype == "float32" and not cfg.model.kwargs.get("gate_bf16", False)
    if not f32:
        truth_cfg = get_config(name, (*overrides, "model.dtype=float32"))
        truth_cfg.model.kwargs["gate_bf16"] = False
        truth_model = build_model(truth_cfg, device="cpu")
    out = {}
    for mode in modes:
        want = _sample_want(cfg, mode)
        fn, _ = _sample_call(cfg, mode, 2, 0, torch.Generator().manual_seed(21))
        plain = torch.from_numpy(fn(plain_model))
        ops.reset_launch_counts()
        got = fn(card_model)
        _counts(general)
        counts = ops.launch_counts_by_mode()
        _check_counts(f"sample {tag} {mode}", counts, want)
        _require(got.shape == tuple(plain.shape) and got.dtype == np.float32
                 and bool(np.isfinite(got).all()) and got.min() >= 0 and got.max() <= 1,
                 f"sample {tag} {mode}: frames {got.shape} {got.dtype} in "
                 f"[{got.min()}, {got.max()}]")
        # held less 0.5: an untrained model's frames lie near 0.5, which
        # would hide a difference in the logits
        got, plain = torch.from_numpy(got) - 0.5, plain - 0.5
        if f32:
            e = _rel_l2(got, plain)
            _require(e <= 1e-4, f"sample {tag} {mode}: rel L2 card vs CPU {e:.2e} (1e-4)")
            txt = f"rel L2 card vs CPU {e:.2e} (limit 1e-4)"
        else:
            truth = torch.from_numpy(fn(truth_model)) - 0.5
            e_k, e_p = _rel_l2(got, truth), _rel_l2(plain, truth)
            lim = max(2 * e_p, 0.05)
            _require(e_k <= lim, f"sample {tag} {mode}: rel L2 to the CPU's f32 frames "
                                 f"{e_k:.4f} on the card, {e_p:.4f} on the CPU (limit {lim:.4f})")
            txt = (f"rel L2 to the CPU's f32 frames {e_k:.4f} on the card, {e_p:.4f} on the CPU "
                   f"in {cfg.model.dtype}, gates bf16 (limit {lim:.4f}); card vs CPU "
                   f"{_rel_l2(got, plain):.4f}")
        print(f"[sample] {tag} {mode}, {tuple(got.shape)} from injected draws: {txt}; "
              f"launches {', '.join(f'{k} {v}' for k, v in counts.items() if v)} "
              f"(all others 0)")

        fn, frames = _sample_call(cfg, mode, cfg.data.batch_size, 3, device=dev)
        ops.reset_launch_counts()
        for _ in range(_SAMPLE_WARMUP):
            fn(card_model)
        fps = []
        for _ in range(_SAMPLE_WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(_SAMPLE_CALLS):
                fn(card_model)
            torch.cuda.synchronize()
            fps.append(_SAMPLE_CALLS * frames / (time.perf_counter() - t0))
        calls = _SAMPLE_WARMUP + _SAMPLE_WINDOWS * _SAMPLE_CALLS
        counts = ops.launch_counts_by_mode()
        _check_counts(f"sample {tag} {mode} timed", counts, want, calls)
        out[f"sample {tag} {mode}"] = _counts(general)
        fps.sort()
        prof = _device_profile(lambda: fn(card_model), 3)
        print(f"[sample] {tag} {mode}: {fps[len(fps) // 2]:.1f} frames/s (min {fps[0]:.1f}, max "
              f"{fps[-1]:.1f}; {frames} frames a call at batch {cfg.data.batch_size}, drawn on "
              f"the card, frames copied to the host; median of {_SAMPLE_WINDOWS} windows of "
              f"{_SAMPLE_CALLS} calls after {_SAMPLE_WARMUP}), "
              f"{1e3 * frames / fps[len(fps) // 2]:.3f} ms a call; under the profiler (3 calls) "
              f"{prof['call_ms']:.3f} ms a call: kernels {prof['kernel_ms']:.3f} ms in "
              f"{prof['kernels']:.0f} launches, copies {prof['copy_ms']:.3f} ms, device idle "
              f"share {prof['idle']:.4f}; launches over the {calls} calls held to {calls} x the "
              f"equation, on {card}")
    return out


# The residual-free kernels at the sampling paths' shapes: (wrapper, mode,
# shape, the paths that give it, launches a sampling call on them).
_NORES = (
    ("convlstm_proj_forward", "nores", (64, 20, 8, 8, 128, 128),
     "config 3 reconstruct (B=64, T=20)", "1 a reconstruct or rollout of configs 3-5"),
    ("convlstm_scan_forward", "hs", (64, 10, 8, 8, 128, True),
     "config 4 fused decoder (B=64, T=10)", "1 a call of configs 3-5 fused"),
    ("convlstm_scan_forward", "hs", (160, 10, 8, 8, 128, True),
     "config 5 fused decoder (B=160, T=10)", "1 a call of configs 3-5 fused"),
    ("convlstm_scan_forward", "last", (64, 20, 8, 8, 128, False),
     "an enc_x_kernel=3 encoder (B=64, T=20), streaming", "0: no sampling path"),
)
_CHAIN_HEAD = (16, 256, 64, "float32")  # hier_vae's prior chain, one a chunk


def check_sampling_kernels(card: str, dev) -> dict:
    """The forwards without residuals at their sampling shapes (bf16 gates),
    each against its plain version (`kernel_checks.residual_free_readings`;
    phase 3 holds them equal to the saving forward at these shapes) and
    timed by CUDA events over 5 calls beside the plain version and the bound
    (`bench.roofline`: the saving forward's operations, fewer bytes); the
    fused head forward at the prior chain's shape, held by
    `kernel_checks.compare_head` and timed in CUDA graphs (cold L2) beside
    its plain version and the route it replaced.  Returns {wrapper: its
    sampling rows} for the kernels line."""
    import torch

    from mmvae_torch.bench.timing import head_region_ms
    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import head_kernels as hk
    from mmvae_torch.ops import kernel_checks as kc
    from mmvae_torch.ops import seeds

    rows = {}
    bf16 = torch.bfloat16
    for wrapper, mode, shape, where, launches in _NORES:
        if wrapper == "convlstm_proj_forward":
            args = (*kc.proj_inputs(dev, *shape, seed=6), bf16, False)
            kern, plain = ck.proj_forward_cuda, ck.proj_forward_plain
            names, rtol, bname = ("h_T", "c_T"), 0.0, "convlstm_proj_forward_nores"
        else:
            b, t, h, w, f, const = shape
            xg, wh, c0, h0 = kc.scan_inputs(dev, b, 1 if const else t, h, w, f, seed=10)
            args = (xg, wh, c0, h0, t, bf16, mode)
            kern, plain = ck.scan_forward_cuda, ck.scan_forward_plain
            names = ("hs", "c_T") if mode == "hs" else ("h_T", "c_T")
            rtol, bname = kc.CS_RTOL, f"convlstm_scan_forward_{mode}"
        outs_k, outs_p = kern(*args), plain(*args)
        rd = kc.residual_free_readings(names, outs_k, outs_p, bf16, rtol)
        kc.Comparison(rd, 0.0, 0.0).check(f"{wrapper} {mode} {shape}")
        err = max(_maxerr(a, b) for a, b in zip(outs_k, outs_p))
        # the saving forward on the same inputs, in turns: save, mode, mode, save
        saving = (*args[:-1], True if wrapper == "convlstm_proj_forward" else "save")
        turns = [_time_ms(lambda a=a: kern(*a), 20) for a in (saving, args, args, saving)]
        ms, save_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        plain_ms = _time_ms(lambda: plain(*args), 5)
        b_ms, by = _bound(bname, shape)
        print(f"[sample-kernel] {wrapper} {mode} {shape} ({where}), bf16 gates: "
              f"{', '.join(r.text for r in rd)}; {ms:.4f} ms (CUDA events, 20 calls, two "
              f"turns {turns[1]:.4f} / {turns[2]:.4f}) against the saving forward's "
              f"{save_ms:.4f} ({turns[0]:.4f} / {turns[3]:.4f}) on the same inputs, "
              f"{_share(ms, bname, shape)}; plain {plain_ms:.3f} ms; launches: {launches}; "
              f"library: none; on {card}")
        rows.setdefault(wrapper, {})[mode] = {
            "shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": by, "max_abs_err": err, "library_ms": None, "saving_ms": save_ms}
    shape = (*_CHAIN_HEAD[:3], getattr(torch, _CHAIN_HEAD[3]))
    cmp = kc.compare_head(dev, shape)
    cmp.check(f"head_sample {shape}")
    seed = seeds.stream_seed(1234, seeds.STREAM_REPARAM)
    t = head_region_ms(dev, shape, seed)
    x, w_mu, b_mu, w_lv, b_lv = kc.head_inputs(dev, *shape, 40)
    plain_ms = _time_ms(lambda: hk.head_sample_forward_plain(x, w_mu, b_mu, w_lv, b_lv, seed),
                        20)
    key = (*shape[:3], 4)
    b_ms, by = _bound("head_sample_forward", key)
    print(f"[sample-kernel] head_sample_forward {shape} (hier_vae's prior chain, one a chunk: "
          f"10 a prior sample of config 5): {cmp.text()} (limit {kc.F32_UNITS:g} f32 units); "
          f"{t['fused_fwd']:.4f} ms on the device (CUDA graph, cold L2), "
          f"{_share(t['fused_fwd'], 'head_sample_forward', key)}; plain {plain_ms:.4f} ms; "
          f"the route it replaced (cast, 2 F.linear, Triton K2) {t['parent_fwd']:.4f} ms; "
          f"on {card}")
    rows["head_sample_forward"] = {"prior_chain": {
        "shape": list(_CHAIN_HEAD), "ms": t["fused_fwd"], "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": by, "max_abs_err": cmp.fwd_err,
        "library_ms": t["parent_fwd"]}}
    return rows


def _cli(argv) -> tuple:
    """(exit code, standard output) of `cli.main(argv)` in this process."""
    import contextlib
    import io

    from mmvae_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    sys.stdout.write(text)
    return rc, text


def check_cli(card: str, dev, workdir: str) -> dict:
    """`python -m mmvae_torch` in this process on the card, from the
    checkpoints the fit phase wrote (config 3 streamed, config 4 fused):
    `eval`, whose JSON line must equal `evaluate`'s; `sample` in every
    mode (config 3: prior and reconstruct; config 4: all three), each with
    its launch equations (K3 once for the clips), frames finite in [0, 1]
    of the expected shape and equal to a second call's from the same seed;
    `bench --profile`, whose trace must name the head's two kernels and
    K1's.  The PNG / GIF writers run where PIL imports.  Returns {path:
    counts}."""
    import argparse
    import importlib.util
    import os

    import numpy as np

    from mmvae_torch import cli, ops
    from mmvae_torch.configs import get_config
    from mmvae_torch.sample import generate as gen
    from mmvae_torch.train.loop import evaluate

    have_pil = importlib.util.find_spec("PIL") is not None
    paths = {"seq_vae": _CUT + _STREAMING, "pred_vae": _CUT + _FUSED}
    out = {}

    sets = [a for ov in paths["seq_vae"] for a in ("--set", ov)]
    ck = _ckpt_dir(workdir, "seq_vae")
    rc, text = _cli(["eval", "--config", "seq_vae", "--ckpt", ck, "--batches", "2", *sets])
    got = json.loads(text.strip().splitlines()[-1])
    want = evaluate(get_config("seq_vae", paths["seq_vae"]), ck, max_batches=2, device=dev)
    _require(rc == 0 and got == want, f"cli eval: rc {rc}, {got} against evaluate's {want}")
    print(f"[cli] eval --config seq_vae --ckpt <fit's checkpoint> --batches 2: rc 0, its JSON "
          f"line equals evaluate's ({len(got)} keys, step {got['step']})")

    written = []
    real = {"save_grid": gen.save_grid, "save_gif": gen.save_gif}

    def writer(kind):
        def write(frames, path, *args, **kw):
            written.append((kind, frames, path))
            if have_pil:
                real[kind](frames, path, *args, **kw)
        return write

    gen.save_grid, gen.save_gif = writer("save_grid"), writer("save_gif")
    try:
        for name, modes in (("seq_vae", ("prior", "reconstruct")),
                            ("pred_vae", ("prior", "reconstruct", "rollout"))):
            cfg = get_config(name, paths[name])
            ck = _ckpt_dir(workdir, name)
            for mode in modes:
                target = os.path.join(workdir, f"{name}_{mode}.gif")
                argv = ["sample", "--config", name, "--ckpt", ck, "--mode", mode, "--out",
                        target, "--batch", "8", "--seed", "5"]
                argv += [a for ov in paths[name] for a in ("--set", ov)]
                ops.reset_launch_counts()
                rc, _ = _cli(argv)
                _counts()
                counts = ops.launch_counts_by_mode()
                _require(rc == 0 and written and written[-1][2] == target,
                         f"cli sample {name} {mode}: rc {rc}")
                _check_counts(f"cli sample {name} {mode}", counts,
                              _sample_want(cfg, mode, cli=True))
                kind, frames, _ = written[-1]
                t = cfg.data.seq_len
                n = t - cfg.model.kwargs["context_len"] if (
                    name == "pred_vae" and mode != "prior") else t
                again = cli.sample_frames(cfg, argparse.Namespace(
                    ckpt=ck, mode=mode, batch=8, seed=5, ema=False, allow_init=False,
                    device="cuda"))
                diff = float(np.abs(frames - again).max())
                _require(frames.shape == (8, n, 64, 64) and frames.dtype == np.float32
                         and bool(np.isfinite(frames).all()) and frames.min() >= 0
                         and frames.max() <= 1 and kind == "save_gif" and diff <= 1e-5,
                         f"cli sample {name} {mode}: {kind} of {frames.shape} {frames.dtype} "
                         f"in [{frames.min()}, {frames.max()}], {diff} from a second call")
                if have_pil:
                    _require(os.path.getsize(target) > 0, f"cli sample: {target} not written")
                print(f"[cli] sample --config {name} --mode {mode} --batch 8: rc 0, {kind} of "
                      f"{frames.shape} f32 in [{frames.min():.4f}, {frames.max():.4f}], "
                      f"{diff:.1e} from a second call from the same seed; launches "
                      f"{', '.join(f'{k} {v}' for k, v in counts.items() if v)} (all others 0)")
                out[f"cli sample {name} {mode}"] = _counts()
    finally:
        gen.save_grid, gen.save_gif = real["save_grid"], real["save_gif"]
    if not have_pil:
        print("[cli] PIL does not import on this machine, so the PNG / GIF writers were not "
              "run here: every sample mode ran up to its frames; the writers' tests run on "
              "the CPU (tests/test_torch_sample.py, tests/test_torch_cli.py)")

    prof = os.path.join(workdir, "profile")
    ops.reset_launch_counts()
    rc, text = _cli(["bench", "--config", "mlp_vae", "--steps", "20", "--warmup", "5",
                     "--profile", prof])
    out["cli bench mlp_vae"] = _counts()
    res = json.loads(text.strip().splitlines()[-1])
    with open(res["trace"]) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    named = {k: sum(k in n for n in kernels) for k in ("head_sample_fwd_kernel",
                                                        "head_sample_bwd_kernel",
                                                        "bce_partial_kernel")}
    _require(rc == 0 and res["vs_baseline"] is None and os.path.dirname(res["trace"]) == prof
             and all(named.values()),
             f"cli bench --profile: rc {rc}, trace {res.get('trace')}, kernel names {named}")
    print(f"[cli] bench --config mlp_vae --steps 20 --warmup 5 --profile DIR: rc 0, "
          f"{res['value']} frames/s, vs_baseline null; the trace "
          f"({os.path.getsize(res['trace'])} bytes, {len(kernels)} kernel names) names "
          f"{', '.join(named)}; on {card}")
    return out


def phase_sample(card: str, dev, workdir: str) -> tuple:
    """Sampling on the card: each model and mode against the CPU, with its
    launch equations and frames/s; the residual-free kernels at their
    sampling shapes; the CLI.  Returns ({path: counts}, {wrapper: sampling
    rows})."""
    out = {}
    for name, overrides, modes in _SAMPLE_PATHS:
        out.update(check_sampling(card, dev, name, overrides, modes))
    rows = check_sampling_kernels(card, dev)
    out.update(check_cli(card, dev, workdir))
    return out, rows


# --- phase 7: data parallelism ------------------------------------------------

# The data-parallel runs at full width: config 5 fused (16 clips -> 8 a rank)
# and config 3 default (64 -> 32).
_DP_CONFIGS = (("hier_vae", ("model.kwargs.fused=true",)), ("seq_vae", ()))
# The phase's runs as one rank gives the kernels their shapes, for
# `path_shapes`: (tag, config, overrides, ranks, the kernel kinds it
# runs).  Each rank's step on its half of the batch and the full-batch
# step it is held against (frames not binarized, the batch handed in
# whole), fit's resident shard and its eval batches (gathered whole), and
# this process's reconstruct of 8 clips from the group's checkpoint.
_DP_WHOLE = ("data.binarize=false", "data.device_resident=false")
_DP_PATHS = (
    *((f"dp {'step' if world == 2 else 'full batch'} {_tag(name, overrides)}", name,
       overrides + _DP_WHOLE, world, _KINDS)
      for name, overrides in _DP_CONFIGS for world in (2, 1)),
    ("dp fit seq_vae", "seq_vae", _CUT + ("data.device_resident=true",), 2, _KINDS),
    ("dp fit seq_vae eval", "seq_vae", _STREAMING, 2, _KINDS),
    ("dp sample reconstruct", "seq_vae", ("data.batch_size=8",) + _DP_WHOLE, 1,
     ("preprocess", "head", "proj")),
)
# Rel L2, a tensor at a time, of the mean of a batch's two halves' gradients
# to the whole batch's, each stepped in one process on the card.  In bf16
# the split changes the batch every bf16 op sees, and with it the
# roundings (unit roundoff 2^-9): each bf16 conv's output and gradients,
# such as the 20 per-step gradients of config 3's eager decoder, rounded
# before their f32 sum.  So the kernels' route is held to `_DP_BF16_FACTOR`
# times the gap of the same bf16 model on the plain route
# (`kernel_checks.plain_route`), on
# the same inputs in the same run; config 3 on the plain route in f32 (f32
# gates, TF32 off), where only the order of f32 sums differs, to
# `_DP_F32_PLAIN_LIMIT`.  Config 5 fused computes its heads, its prior and
# the projections of z into the decoder in f32, and K5 and K6 sum over
# time in f32: on the kernels' route those gradients
# (`_DP_F32_PARAMS`) are held to `_DP_F32_LIMIT`.
_DP_BF16_FACTOR = 2.0
_DP_F32_PLAIN_LIMIT = 1e-4
_DP_F32_LIMIT = 1e-5
_DP_F32_PARAMS = {"hier_vae": ("q_", "g_", "p_", "prior_", "chunk_proj.", "z_to_")}
_DP_FIT_STEPS = 20


def _dp_backend() -> tuple:
    """(backend, the rank's device, "{rank}" filled in): NCCL, a card a rank,
    where the host has two cards; else gloo, both ranks on card 0."""
    import torch

    if torch.cuda.device_count() >= 2:
        return "nccl", "cuda:{rank}"
    return "gloo", "cuda:0"


def _digest(tensors: dict) -> str:
    """sha256 of the tensors' bytes in name order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        h.update(name.encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dp_inputs(name: str, overrides):
    """(config, the global u8 batch, eps by sampling site) made from seed 11
    on the CPU; a site's rows are batch-major (config 5's chunks too)."""
    import torch

    from mmvae_torch.configs import get_config

    cfg = get_config(name, overrides)
    kw, b = _model_kwargs(cfg), cfg.data.batch_size
    if name == "hier_vae":
        sites = {0: (b, kw["global_latent"]),
                 1: (b * (cfg.data.seq_len // kw["chunk_len"]), kw["chunk_latent"])}
    else:
        sites = {0: (b, kw["latent_dim"])}
    g = torch.Generator().manual_seed(11)
    u8 = torch.randint(0, 256, (b, cfg.data.seq_len, 64, 64), generator=g, dtype=torch.uint8)
    return cfg, u8, {salt: torch.randn(shape, generator=g) for salt, shape in sites.items()}


def _grad_step(cfg, dev, u8, eps, sync=None) -> tuple:
    """One train step of `cfg` on `dev` (`binarize=false`, `eps` injected
    through the step's sample function; a rank's step with `sync`):
    (the gradients its update sees, by name, on the host; its loss)."""
    from mmvae_torch.ops import dispatch
    from mmvae_torch.train.loop import build_model, make_train_step
    from mmvae_torch.train.state import create_train_state

    model = build_model(cfg, dev)
    state = create_train_state(model, cfg.optim)
    grads = {}
    state.apply_gradients = lambda: grads.update(
        (n, p.grad.detach().cpu()) for n, p in model.named_parameters())
    real = dispatch.make_sample_fn
    dispatch.make_sample_fn = lambda seed, e=None: real(seed, eps)
    try:
        metrics = make_train_step(model, binarize=False, sync=sync)(state, u8.to(dev))
    finally:
        dispatch.make_sample_fn = real
    return grads, float(metrics["loss"])


def _split_gap(cfg, dev, u8, eps) -> tuple:
    """In this process on the card: ((the full batch's gradients, its
    loss), (the mean of its two halves' gradients, of their losses), {name:
    rel L2 of that mean to the full batch's}, the worst rel L2 of half 0's
    step run twice).  Gradients on the host."""
    import torch

    b = u8.shape[0] // 2
    halves = [_grad_step(cfg, dev, u8[r * b:(r + 1) * b], _rank_eps(eps, r)) for r in (0, 1, 0)]
    split = {n: (g + halves[1][0][n]) / 2 for n, g in halves[0][0].items()}
    floor = max(_rel_l2(g, halves[2][0][n]) for n, g in halves[0][0].items())
    loss = float((torch.tensor(halves[0][1]) + torch.tensor(halves[1][1])) / 2)
    full = _grad_step(cfg, dev, u8, eps)
    return full, (split, loss), {n: _rel_l2(split[n], g) for n, g in full[0].items()}, floor


def _gap_text(gap: dict) -> str:
    """The worst two and the median of {name: rel L2}."""
    rel = sorted(((v, n) for n, v in gap.items()), reverse=True)
    return (f"worst {rel[0][0]:.3e} at {rel[0][1]}, then {rel[1][0]:.3e} at {rel[1][1]}, "
            f"median {rel[len(rel) // 2][0]:.3e}")


def _rank_eps(eps: dict, rank: int) -> dict:
    """Rank `rank`'s share (of 2) of each site's batch-major eps rows."""
    return {salt: e[rank * (e.shape[0] // 2):(rank + 1) * (e.shape[0] // 2)]
            for salt, e in eps.items()}


def _dp_fit_cfg(workdir: str):
    import os

    return _fit_cfg("seq_vae", _CUT + ("data.device_resident=true", "train.data_parallel=true"),
                    "train.log_every=5", "train.eval_every=10", "train.eval_batches=2",
                    "train.checkpoint_every=10",
                    f"train.checkpoint_dir={os.path.join(workdir, 'dp_seq_vae')}")


def _dp_rank(rank: int, backend: str, device: str, init_file: str, workdir: str) -> None:
    """One rank of the phase (a spawned process): the gradient step of each
    `_DP_CONFIGS` on its share with its eps, then `fit` of config 3 on the
    resident path, then the step's collective timed; saves what the parent
    checks to `workdir/dp.rank<rank>.pt`."""
    import os

    import torch

    from mmvae_torch import ops, parallel
    from mmvae_torch.train.loop import fit

    dev = parallel.init_from_env(device.format(rank=rank), backend=backend,
                                 init_method=f"file://{init_file}", rank=rank, world_size=2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sync = parallel.grad_sync(dev)
        out = {"grads": {}, "loss": {}, "digest": {}, "step_counts": {}}
        for name, overrides in _DP_CONFIGS:
            cfg, u8, eps = _dp_inputs(name, overrides)
            b = u8.shape[0] // 2
            ops.reset_launch_counts()
            grads, loss = _grad_step(cfg, dev, u8[rank * b:(rank + 1) * b],
                                     _rank_eps(eps, rank), sync)
            tag = _tag(name, overrides)
            out["step_counts"][tag] = _counts()
            out["loss"][tag], out["digest"][tag] = loss, _digest(grads)
            if rank == 0:
                out["grads"][tag] = grads

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, history = fit(_dp_fit_cfg(workdir), max_steps=_DP_FIT_STEPS, device=dev)
        torch.cuda.synchronize(dev)
        out["fit_seconds"] = time.perf_counter() - t0
        out["counts"] = _counts()
        out["history"] = history
        out["params"] = _digest(dict(state.model.named_parameters()))

        # the step's collective on the last step's gradients: GradSync whole
        # (flatten, all-reduce, copy back) and the bare all-reduce of its buffer
        params = [p for p in state.model.parameters() if p.grad is not None]
        metrics = {k: torch.zeros((), device=dev) for k in ("loss", "bce", "kl")}
        buf = torch.cat([p.grad.reshape(-1).float() for p in params])
        timed = {}
        for what, fn in (("sync", lambda: sync(params, metrics)),
                         ("all_reduce", lambda: torch.distributed.all_reduce(buf))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize(dev)
            timed[what] = 1e3 * (time.perf_counter() - t0) / 20
        out["collective_ms"], out["grad_numel"] = timed, buf.numel()
        torch.save(out, os.path.join(workdir, f"dp.rank{rank}.pt"))
        parallel.barrier(dev)
    finally:
        parallel.shutdown()


def _nccl_one_rank(dev, workdir: str) -> None:
    """A one-rank NCCL group in this process: NCCL's init and an all-reduce
    of 4 MiB on the card, equal to its input, and its time."""
    import os

    import torch

    from mmvae_torch import parallel

    parallel.init_from_env(dev, backend="nccl", rank=0, world_size=1,
                           init_method=f"file://{os.path.join(workdir, 'nccl_init')}")
    try:
        x = torch.arange(1 << 20, device=dev, dtype=torch.float32)
        want = x.clone()
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize(dev)
        _require(torch.equal(x, want), "a one-rank NCCL all-reduce changed its input")
        ms = _time_ms(lambda: torch.distributed.all_reduce(x), 20)
    finally:
        parallel.shutdown()
    version = torch.cuda.nccl.version()
    version = version if isinstance(version, int) else ".".join(map(str, version))
    print(f"[dp] NCCL {version}: a one-rank group on "
          f"{dev} initialized and all-reduced 4 MiB on the card, equal to its input, "
          f"{ms:.4f} ms a call")


def phase_dp(card: str, dev, workdir: str) -> dict:
    """Data parallelism, two ranks (spawned once for the phase; NCCL over two
    cards where the host has them, else gloo with both on this card and a
    one-rank NCCL group here): each `_DP_CONFIGS` step's averaged gradients
    against one process's full-batch step on the card (`_DP_BF16_FACTOR`
    times the plain route's gap; `_DP_F32_PLAIN_LIMIT`, `_DP_F32_LIMIT` in
    f32),
    bit-identical on the ranks; `fit` of config 3 on the resident path (20
    steps, eval every 10 on 2 batches, checkpoints), its launch equations
    on each rank, parameters bit-identical on the ranks, the metrics equal;
    the step's collective timed; the group's checkpoint scored by
    `evaluate` and sampled in this process.  Returns {path: launch counts}."""
    import argparse
    import os

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from mmvae_torch import cli
    from mmvae_torch.configs import get_config
    from mmvae_torch.ops.kernel_checks import plain_route
    from mmvae_torch.train.loop import evaluate

    backend, device = _dp_backend()
    n_cards = torch.cuda.device_count()
    print(f"[dp] backend {backend}, world size 2, {n_cards} card(s): "
          + ("a card a rank" if backend == "nccl" else
             "both ranks on cuda:0, all-reduced over gloo through the host"))
    if backend == "gloo":
        _nccl_one_rank(dev, workdir)

    # in this process on the card: the full batch, each rank's half (half 0
    # twice: the step's own repeatability) and their mean, the split's
    # result; then the same on the plain route in bf16 and in f32
    refs, witness, k6 = {}, {}, {}
    for name, overrides in _DP_CONFIGS:
        tag = _tag(name, overrides)
        cfg, u8, eps = _dp_inputs(name, overrides)
        refs[tag], k6[tag] = _split_gap(cfg, dev, u8, eps), _dec_k6(cfg)
        with plain_route():
            witness[tag] = {
                dt: _split_gap(get_config(name, overrides + more), dev, u8, eps)[2]
                for dt, more in (("bf16", ()), ("f32", ("model.dtype=float32",
                                                        "model.kwargs.gate_bf16=false")))}
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    init = os.path.join(workdir, "dp_init")
    procs = [ctx.Process(target=_dp_rank, args=(r, backend, device, init, workdir))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=480)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    _require(all(p.exitcode == 0 for p in procs),
             f"a data-parallel rank failed: exit codes {[p.exitcode for p in procs]}")
    ranks = [torch.load(os.path.join(workdir, f"dp.rank{r}.pt"), weights_only=False)
             for r in range(2)]
    print(f"[dp] the two ranks ran in {time.perf_counter() - t0:.1f} s (spawn and start-up "
          f"included)")

    for tag, ((full, full_loss), (split, split_loss), _, floor) in refs.items():
        _require(ranks[0]["digest"][tag] == ranks[1]["digest"][tag],
                 f"dp {tag}: the ranks' averaged gradients differ")
        got, dp_loss = ranks[0]["grads"][tag], ranks[0]["loss"][tag]
        _require(set(got) == set(full) == set(split), f"dp {tag}: gradient names differ")
        same = sum(torch.equal(got[n], w) for n, w in split.items())
        off = max(_rel_l2(got[n], w) for n, w in split.items())
        _require(off <= 2 * floor and (floor > 0 or dp_loss == split_loss),
                 f"dp {tag}: the ranks' averaged gradients against the two halves' mean in "
                 f"one process: worst rel L2 {off:.3e} (limit 2 x the step's own "
                 f"repeatability, {floor:.3e}); loss {dp_loss} against {split_loss}")
        print(f"[dp] {tag}: one step, the ranks' averaged gradients (bit-identical on both) "
              f"against the mean of the same two halves stepped one after the other in this "
              f"process: {same} of {len(split)} tensors bit-identical, worst rel L2 {off:.3e} "
              f"(limit 2 x {floor:.3e}, the step's own repeatability); loss {dp_loss:.4f} "
              f"against {split_loss:.4f}")
        # a step of this path: K6 where its decoder runs it, a head each
        # sampling site (config 5: two)
        want = _step_counts(1, 0, k6=k6[tag])
        if tag.startswith("hier_vae"):
            want.update(head_sample_forward=2, head_sample_backward=2)
        for r, res in enumerate(ranks):
            counts = res["step_counts"][tag]
            _require(all(counts[k] == want.get(k, 0) for k in counts),
                     f"dp step {tag} rank {r}: launches {counts}, expected {want} (others 0)")
        print(f"[dp] {tag}: the step's launches on each rank "
              f"{', '.join(f'{k} {v}' for k, v in want.items())} (all others 0)")
        gap = {n: _rel_l2(got[n], w) for n, w in full.items()}
        plain = witness[tag]
        worst = {k: max(g.values()) for k, g in (("kernels", gap), *plain.items())}
        limit = _DP_BF16_FACTOR * worst["bf16"]
        print(f"[dp] {tag}: the ranks' averaged gradients against one process's full-batch "
              f"step on the card, rel L2 a tensor: {_gap_text(gap)} (limit {limit:.3e}: "
              f"{_DP_BF16_FACTOR:g} x the plain route's worst in bf16); loss {dp_loss:.4f} "
              f"against {full_loss:.4f}")
        held = tag.split()[0] not in _DP_F32_PARAMS
        print(f"[dp] {tag}: the same split on the plain route (every kernel's plain version "
              f"on the card): bf16 {_gap_text(plain['bf16'])}; f32 (f32 gates, TF32 off) "
              f"{_gap_text(plain['f32'])}"
              + (f" (limit {_DP_F32_PLAIN_LIMIT:g})" if held else " (not held)"))
        top = sorted(gap, key=gap.get, reverse=True)[:3]
        print(f"[dp] {tag}: by tensor, kernels / plain bf16 / plain f32: " + "; ".join(
            f"{n} {gap[n]:.3e} / {plain['bf16'][n]:.3e} / {plain['f32'][n]:.3e}" for n in top))
        _require(worst["kernels"] <= limit,
                 f"dp {tag}: the ranks' averaged gradients against the full batch's, worst rel "
                 f"L2 {worst['kernels']:.3e} (limit {limit:.3e}, {_DP_BF16_FACTOR:g} x the "
                 f"plain route's {worst['bf16']:.3e})")
        if held:
            _require(worst["f32"] <= _DP_F32_PLAIN_LIMIT,
                     f"dp {tag}: the split in f32 on the plain route, worst rel L2 "
                     f"{worst['f32']:.3e} (limit {_DP_F32_PLAIN_LIMIT:g})")
        else:
            f32 = {n: v for n, v in gap.items()
                   if n.startswith(_DP_F32_PARAMS[tag.split()[0]])}
            print(f"[dp] {tag}: the {len(f32)} gradients it computes in f32 (heads, prior, "
                  f"z into the decoder), kernels' route: {_gap_text(f32)} (limit "
                  f"{_DP_F32_LIMIT:g})")
            _require(max(f32.values()) <= _DP_F32_LIMIT,
                     f"dp {tag}: the f32 gradients against the full batch's, "
                     f"{_gap_text(f32)} (limit {_DP_F32_LIMIT:g})")

    cfg = _dp_fit_cfg(workdir)
    evals = 2 * 2  # two passes of 2 full batches of 32 (each rank's 100 val rows)
    want = _step_counts(_DP_FIT_STEPS, evals, k6=_dec_k6(cfg))
    for r, res in enumerate(ranks):
        _require(all(res["counts"][k] == want.get(k, 0) for k in res["counts"]),
                 f"dp fit rank {r}: launches {res['counts']}, expected {want} (others 0)")
    _require(ranks[0]["params"] == ranks[1]["params"],
             "dp fit: the ranks' parameters differ after fit")
    plain = [[{k: v for k, v in h.items() if "per_sec" not in k} for h in res["history"]]
             for res in ranks]
    hist = ranks[0]["history"]
    _require(plain[0] == plain[1] and [h["step"] for h in hist] == [5, 10, 15, 20]
             and all(math.isfinite(h["val_loss"]) for h in hist[1::2]),
             f"dp fit: histories {plain}")
    fps = [round(h["frames_per_sec"], 1) for h in hist if "frames_per_sec" in h]
    step_ms = 1e3 * cfg.data.batch_size * cfg.data.seq_len / float(np.median(fps))
    coll = ranks[0]["collective_ms"]
    print(f"[dp] fit seq_vae resident, {_DP_FIT_STEPS} steps of {cfg.data.batch_size} clips "
          f"({cfg.data.batch_size // 2} a rank), eval "
          f"every 10 on 2 batches a rank, checkpoints from rank 0: launches a rank held "
          f"(K5 forward = {_DP_FIT_STEPS} train steps + {evals} eval batches, backward = "
          f"{_DP_FIT_STEPS}; {ranks[0]['counts']}); parameters bit-identical on the ranks; "
          f"logged metrics equal on both; loss {hist[0]['loss']:.2f} -> {hist[-1]['loss']:.2f}, "
          f"val_loss {hist[-1]['val_loss']:.2f}; {ranks[0]['fit_seconds']:.2f} s wall a rank")
    print(f"[dp] fit's logger: {fps} frames/s of the global batch, two ranks sharing one "
          f"card ({backend}): not a scaling figure; on {card}" if backend == "gloo" else
          f"[dp] fit's logger: {fps} frames/s of the global batch over {n_cards} cards "
          f"({[round(v / 2, 1) for v in fps]} a card); on {card}")
    print(f"[dp] the step's collective ({ranks[0]['grad_numel']:,} f32 gradients + 3 metrics "
          f"+ the stop flag, {backend}): GradSync {coll['sync']:.3f} ms (flatten, all-reduce, "
          f"copy back), the bare all-reduce {coll['all_reduce']:.3f} ms (host clock to a "
          f"synchronize, mean of 20); {100 * coll['sync'] / step_ms:.1f} % of fit's "
          f"{step_ms:.2f} ms step")

    ckdir = cfg.train.checkpoint_dir
    res = evaluate(cfg, ckdir, max_batches=2, device=dev)
    frames = cli.sample_frames(cfg, argparse.Namespace(
        ckpt=ckdir, mode="reconstruct", batch=8, seed=5, ema=False, allow_init=False,
        device=str(dev)))
    _require(res["step"] == _DP_FIT_STEPS and math.isfinite(res["val_loss"])
             and frames.shape == (8, 20, 64, 64) and bool(np.isfinite(frames).all()),
             f"dp checkpoint: evaluate {res}, sample {frames.shape}")
    print(f"[dp] the group's checkpoint in this process: evaluate (2 batches) step "
          f"{res['step']}, val_loss {res['val_loss']:.2f}; sample reconstruct 8 x 20 frames "
          f"finite in [{frames.min():.4f}, {frames.max():.4f}]")
    out = {}
    for r, res in enumerate(ranks):
        out.update((f"dp step {tag} rank {r}", c) for tag, c in res["step_counts"].items())
        out[f"dp fit seq_vae rank {r}"] = res["counts"]
    return out


# --- phase 8: train.steps_per_call, K train steps in one CUDA graph -------------

_CHUNK_K = 5
# the paths whose graph of K steps must replay as their eager steps
_CHUNK_PATHS = (
    ("seq_vae", ()),
    ("seq_vae", ("data.resident_epochs=true",)),
    ("seq_vae", _RECIPE),
    ("hier_vae", ("model.kwargs.fused=true",)),
    ("mlp_vae", ()),
)
# the paths timed at steps_per_call 1 and 10
_TIMED_PATHS = (
    ("mlp_vae", ()),
    ("conv_vae", ()),
    ("seq_vae", ()),
    ("seq_vae", _RECIPE),
    ("hier_vae", ("model.kwargs.fused=true",)),
)
_TIMED_K = (1, 10)


def check_graph_draws(dev) -> None:
    """The device seeds inside a CUDA graph: a graph of one step's draws
    (the step seed from a step counter on the card, uniform rows, K3's
    binarization and the head's eps, both reading the seed from device
    memory, the counter advanced) replayed twice equals the same two steps
    run eagerly, bit for bit; the two steps' draws differ; and the kernels'
    stream seed from the device equals `ops.seeds.stream_seed` of the host's
    (the same bits from a host int)."""
    import torch

    from mmvae_torch.ops import head_kernels, preprocess_kernels, seeds
    from mmvae_torch.train.loop import uniform_rows

    g = torch.Generator(device=dev).manual_seed(31)
    data = torch.randint(0, 256, (100, 20, 64, 64), generator=g, device=dev,
                         dtype=torch.uint8)
    x = torch.randn(64, 8192, generator=g, device=dev).to(torch.bfloat16)
    w_mu, w_lv = (torch.randn(128, 8192, generator=g, device=dev) * 0.01 for _ in range(2))
    b_mu, b_lv = (torch.zeros(128, device=dev) for _ in range(2))
    step_t = torch.zeros((), dtype=torch.int64, device=dev)

    def draw():
        seed = seeds.step_seed_t(step_t)
        idx = uniform_rows(seed, data.shape[0], 64, dev)
        frames = preprocess_kernels.preprocess_gather(
            data, idx, seeds.SeedRef(seed, seeds.STREAM_PREPROCESS), out_dtype=torch.bfloat16)
        z = head_kernels.head_sample_forward(x, w_mu, b_mu, w_lv, b_lv,
                                             seeds.SeedRef(seed, seeds.STREAM_REPARAM, 1))[2]
        step_t.add_(1)
        return idx, frames, z

    eager = [tuple(t.clone() for t in draw()) for _ in range(2)]
    host = []
    for n in range(2):
        s = seeds.step_seed(n)
        idx = uniform_rows(s, data.shape[0], 64, dev)
        host.append((idx, preprocess_kernels.preprocess_gather(
            data, idx, seeds.stream_seed(s, seeds.STREAM_PREPROCESS), out_dtype=torch.bfloat16),
            head_kernels.head_sample_forward(x, w_mu, b_mu, w_lv, b_lv, seeds.stream_seed(
                s, seeds.STREAM_REPARAM, 1))[2]))
    step_t.zero_()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        draw()  # warm on the capture stream (the head's tickets)
    torch.cuda.current_stream(dev).wait_stream(side)
    step_t.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = draw()
    replayed = []
    for _ in range(2):
        graph.replay()
        replayed.append(tuple(t.clone() for t in out))
    torch.cuda.synchronize(dev)
    names = ("rows", "K3 frames", "head eps")
    for n in range(2):
        for name, a, b, h in zip(names, replayed[n], eager[n], host[n]):
            _require(torch.equal(a, b), f"graph draws: step {n}'s {name} replayed differ from "
                                        f"the eager step's")
            _require(torch.equal(b, h), f"graph draws: step {n}'s {name} from the device seed "
                                        f"differ from the host seed's")
    for name, a, b in zip(names, replayed[0], replayed[1]):
        _require(not torch.equal(a, b), f"graph draws: two replays drew the same {name}")
    print(f"[chunk] a CUDA graph of one step's draws (step seed from a step counter on the card; "
          f"uniform rows, K3's frames and the head's eps from device-resident seeds) replayed "
          f"twice: bit-identical to two eager steps and to the host seeds' draws; the two "
          f"replays' rows, frames and eps differ "
          f"({int((replayed[0][1] != replayed[1][1]).sum())} of {replayed[0][1].numel()} frame "
          f"elements)")


def _chunk_cfg(name: str, overrides, k: int):
    from mmvae_torch.configs import get_config

    return get_config(name, (*overrides, f"train.steps_per_call={k}"))


def _steps(cfg, dev, sync=None) -> tuple:
    """`setup_resident_training`'s state and step for `cfg`: the first 5
    steps (for a chunk of 5: its eager first call, then the capture), then
    10 more with the launch counters set to 0 just before them and read just
    after.  Returns (state, those 10 steps' metrics on the host, their
    launch counts by mode, the counts by wrapper)."""
    import torch

    from mmvae_torch import ops
    from mmvae_torch.bench.throughput import setup_resident_training

    k = max(cfg.train.steps_per_call, 1)
    state, data, step = setup_resident_training(cfg, dev, sync)
    for _ in range(_CHUNK_K // k):
        step(state, data)
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    ms = [step(state, data) for _ in range(2 * _CHUNK_K // k)]
    torch.cuda.synchronize(dev)
    counts = ops.launch_counts_by_mode(), _counts()
    metrics = {key: torch.cat([m[key].reshape(-1) for m in ms]).cpu() for key in ms[0]}
    return state, metrics, *counts


def _gaps(a: dict, b: dict) -> dict:
    """max |a - b| by tensor group (the name's first word)."""
    out = {}
    for k in a:
        group = k.split()[0]
        d = float((a[k].double() - b[k].double()).abs().max())
        out[group] = max(out.get(group, 0.0), d)
    return out


def check_chunk_equal(card: str, dev, name: str, overrides, sync_pair=None) -> dict:
    """Steps 5-14 of `name` as two replays of a graph of 5 steps (after its
    eager first call) against the same 10 steps run eagerly one a call:
    parameters, Adam's moments and step counts, the EMA and every step's
    metrics bit for bit, and the same launch counts.  Where they differ,
    two eager runs' gap is measured and the graph must lie within twice it
    (both are samples of the same run-to-run spread).  `sync_pair`: one
    GradSync for each run (a data-parallel rank).  Returns the replays'
    launch counts."""
    import torch

    tag = f"chunk {_tag(name, overrides)}"
    one, two = sync_pair or (None, None)
    eager, m_eager, modes_eager, _ = _steps(_chunk_cfg(name, overrides, 1), dev, one)
    t0 = time.perf_counter()
    chunk, m_chunk, modes_chunk, counts = _steps(_chunk_cfg(name, overrides, _CHUNK_K), dev, two)
    wall = time.perf_counter() - t0
    _require(chunk.step == int(chunk.step_t) == eager.step == 3 * _CHUNK_K,
             f"{tag}: steps {chunk.step}, {int(chunk.step_t)} and {eager.step}")
    _require(modes_chunk == modes_eager, f"{tag}: two replays launched {modes_chunk}, ten "
                                         f"eager steps {modes_eager}")
    a, b = _state_tensors(eager), _state_tensors(chunk)
    a.update((f"metric {k}", v) for k, v in m_eager.items())
    b.update((f"metric {k}", v) for k, v in m_chunk.items())
    _require(set(a) == set(b), f"{tag}: the states hold different tensors")
    same = [k for k in a if torch.equal(a[k], b[k].to(a[k].device))]
    if len(same) == len(a):
        verdict = "bit-identical"
    else:
        again, m_again, _, _ = _steps(_chunk_cfg(name, overrides, 1), dev)
        ref = _state_tensors(again)
        ref.update((f"metric {k}", v) for k, v in m_again.items())
        gap, off = _gaps(a, ref), _gaps(a, b)
        print(f"[chunk] {tag}: {len(a) - len(same)} of {len(a)} tensors differ from the eager "
              f"steps; the graph's gap {off}, two eager runs' {gap}")
        _require(all(off[g] <= 2 * gap[g] for g in off),
                 f"{tag}: the graph lies outside twice two eager runs' gap")
        verdict = f"within twice two eager runs' gap {gap}"
    losses = m_chunk["loss"].tolist()
    _require(all(math.isfinite(v) for v in losses), f"{tag}: a non-finite loss {losses}")
    print(f"[chunk] {tag}: steps 5-14 as 2 replays of a graph of {_CHUNK_K} steps against 10 "
          f"eager steps: {len(a)} tensors (parameters, Adam moments and step counts, EMA, "
          f"the 10 steps' metrics) {verdict}; launch counts equal ({counts}); the graph's "
          f"first call, capture and 2 replays {wall:.2f} s wall; on {card}")
    del eager, chunk
    torch.cuda.empty_cache()
    return counts


class _Stopped(Exception):
    """The stand-in SIGTERM's exit."""


class _Sigterm:
    """Stands in for `utils.debug.SigtermCheckpoint`: `requested` turns true
    at its third read (fit reads it once a call, after the call), and
    `save_and_exit` saves and raises instead of ending the process."""

    def __init__(self):
        self.reads = 0

    @property
    def requested(self) -> bool:
        self.reads += 1
        return self.reads >= 3

    def save_and_exit(self, save_fn) -> None:
        save_fn()
        raise _Stopped

    def uninstall(self) -> None:
        pass


def fit_chunked(card: str, dev, workdir: str) -> dict:
    """`fit` of config 3 on the resident path at steps_per_call=5 (one
    cut: the 2,000-clip set): 40 steps, an eval pass of 2 batches and a
    checkpoint every 20, logging every 10; the logged steps are the JAX
    fit's (each chunk's last); the launch equations (a replay adds its
    graph's counts); the checkpoint restored bit for bit; a resume to 60
    equal to an uninterrupted 60 bit for bit; and the SIGTERM save (a
    stand-in flag that turns on after the second call) on the third
    chunk's end, step 15."""
    import os

    import torch

    import mmvae_torch.train.loop as loop
    from mmvae_torch.train import checkpoint as ckpt
    from mmvae_torch.train.state import create_train_state

    def cfg_in(d, *more):
        return _fit_cfg("seq_vae", (*_CUT, "data.device_resident=true",
                                    f"train.steps_per_call={_CHUNK_K}"), "train.log_every=10",
                        "train.eval_every=20", "train.eval_batches=2",
                        "train.checkpoint_every=20", f"train.checkpoint_dir={d}", *more)

    tag = f"fit seq_vae chunked K={_CHUNK_K}"
    split_dir, whole_dir = (os.path.join(workdir, f"chunked_{n}") for n in ("split", "whole"))
    cfg = cfg_in(split_dir)
    k6 = _dec_k6(cfg)
    state, history, counts = _fit(card, tag, cfg, 40, _step_counts(40, 2 * 2, k6=k6), dev)
    _require([h["step"] for h in history] == [10, 20, 30, 40]
             and all("val_loss" in history[i] for i in (1, 3)),
             f"{tag}: logged {[sorted(h) for h in history]}")
    fresh, step, data_step = ckpt.restore_latest(
        split_dir, create_train_state(loop.build_model(cfg, dev), cfg.optim))
    want, got = _state_tensors(state), _state_tensors(fresh)
    _require((step, data_step, fresh.step, int(fresh.step_t)) == (40, 40, 40, 40)
             and all(torch.equal(want[k], got[k].to(want[k].device)) for k in want),
             f"{tag}: the restored state differs from the saved one")
    whole, _, _ = _fit(card, tag + " to 60", cfg_in(whole_dir), 60,
                       _step_counts(60, 3 * 2, k6=k6), dev)
    cfg.train.resume = True
    resumed, hist2, counts2 = _fit(card, tag + " resumed", cfg, 60,
                                   _step_counts(20, 2, k6=k6), dev)
    a, b = _state_tensors(whole), _state_tensors(resumed)
    _require([h["step"] for h in hist2] == [50, 60]
             and all(torch.equal(a[k], b[k]) for k in a),
             f"{tag}: the resume to 60 differs from the uninterrupted run "
             f"({[k for k in a if not torch.equal(a[k], b[k])][:5]})")
    print(f"[fit] {tag}: logged steps 10-40 (the JAX fit's: each chunk's last); the "
          f"checkpoint of step 40 restored bit-identical over {len(want)} tensors; a resume "
          f"to 60 bit-identical to an uninterrupted 60-step run")

    stop_dir = os.path.join(workdir, "chunked_sigterm")
    real = loop.install_sigterm_checkpoint
    loop.install_sigterm_checkpoint = _Sigterm
    try:
        loop.fit(cfg_in(stop_dir), max_steps=40, device=dev)
        stopped = False
    except _Stopped:
        stopped = True
    finally:
        loop.install_sigterm_checkpoint = real
    saved = ckpt.latest_step(stop_dir)
    _require(stopped and saved == 3 * _CHUNK_K,
             f"{tag}: the stand-in SIGTERM stopped={stopped}, saved step {saved}")
    print(f"[fit] {tag}: SIGTERM flagged during the third chunk: fit saved step {saved}, "
          f"the chunk's end, and stopped")
    return {tag: counts, tag + " resumed": counts2}


def check_chunk_nccl(card: str, dev, workdir: str) -> dict:
    """A one-rank NCCL group: config 3's chunk of 5 steps with GradSync's
    all-reduce (gradients, metrics and the stop flag) captured in the
    graph, against its eager steps (`check_chunk_equal`); the reduced stop
    flag read after each replay."""
    import os

    from mmvae_torch import parallel

    parallel.init_from_env(dev, backend="nccl", rank=0, world_size=1,
                           init_method=f"file://{os.path.join(workdir, 'nccl_chunk')}")
    try:
        pair = (parallel.GradSync(0, 1, dev), parallel.GradSync(0, 1, dev))
        counts = check_chunk_equal(card, dev, "seq_vae", (), pair)
        _require(pair[1].backend == "nccl" and not pair[1].stop_agreed(),
                 "nccl chunk: a stop was agreed that no rank asked for")
    finally:
        parallel.shutdown()
    print("[chunk] the one-rank NCCL group's chunk (the all-reduce captured) equals its "
          "eager steps")
    return {"chunk nccl seq_vae": counts}


def time_chunked(card: str) -> tuple:
    """`run_benchmark` (20 steps a window, device profile on) at
    steps_per_call 1 and 10 on configs 1, 2, 3, the recipe and 5 fused:
    frames/s, step ms, the device's busy ms and idle share, kernels and host
    launches a step, flops_per_step, TFLOP/s and MFU (finite, in (0, 1]).
    Returns (each run's launch counts, the rows printed)."""
    import torch

    from mmvae_torch import ops
    from mmvae_torch.bench.throughput import run_benchmark

    out, rows = {}, []
    for name, overrides in _TIMED_PATHS:
        for k in _TIMED_K:
            cfg = _chunk_cfg(name, overrides, k)
            tag = f"bench {_tag(name, overrides)} K={k}"
            ops.reset_launch_counts()
            res = run_benchmark(cfg, steps=20, warmup=10, device_profile=True)
            out[tag] = _counts()
            losses = res.pop("losses")
            _require(all(math.isfinite(v) for v in losses), f"{tag}: a non-finite loss")
            _require(res["mfu"] is not None and math.isfinite(res["mfu"])
                     and 0 < res["mfu"] <= 1, f"{tag}: mfu {res['mfu']}")
            row = {"path": _tag(name, overrides), "steps_per_call": k,
                   **{key: res[key] for key in (
                       "value", "value_min", "value_max", "step_ms", "device_busy_ms",
                       "idle_share", "kernels_per_step", "host_launches_per_step",
                       "flops_per_step", "tflops_per_sec_chip", "mfu", "card")}}
            rows.append(row)
            print(f"[chunk] timing {json.dumps(row)}")
            torch.cuda.empty_cache()
    for name, overrides in _TIMED_PATHS:
        one, ten = (r for r in rows if r["path"] == _tag(name, overrides))
        print(f"[chunk] {_tag(name, overrides)}: step {one['step_ms']:.3f} -> "
              f"{ten['step_ms']:.3f} ms (K 1 -> 10), device busy {one['device_busy_ms']:.3f} -> "
              f"{ten['device_busy_ms']:.3f} ms, idle {one['idle_share']:.3f} -> "
              f"{ten['idle_share']:.3f}, host launches a step {one['host_launches_per_step']} -> "
              f"{ten['host_launches_per_step']}, MFU {one['mfu']:.4f} -> {ten['mfu']:.4f}, "
              f"on {card}")
    return out, rows


def phase_chunk(card: str, dev, workdir: str) -> tuple:
    """`train.steps_per_call`: the graph's draws, the five paths' replays
    against their eager steps, the chunked `fit`, the NCCL chunk and the
    timing.  Returns ({path: its launch counts}, the timing rows)."""
    check_graph_draws(dev)
    out = {}
    for name, overrides in _CHUNK_PATHS:
        out[f"chunk {_tag(name, overrides)} K={_CHUNK_K}"] = check_chunk_equal(
            card, dev, name, overrides)
    out.update(fit_chunked(card, dev, workdir))
    out.update(check_chunk_nccl(card, dev, workdir))
    counts, rows = time_chunked(card)
    out.update(counts)
    return out, rows


# --- phase 9: the named regions ------------------------------------------------

# The paths whose per-region budget is read (K = 1: a graph replay runs no
# host code to attribute, and launches the same kernels as eager steps).
_REGION_PATHS = (  # K6 joins launched or idle as in `_SLICES`
    ("seq_vae", (), _STEP + _K5, _K2),
    ("seq_vae", ("model.kwargs.fused=false",), _STEP, _K5 + _K2),
    ("pred_vae", _FUSED, _STEP + _K5, _K2),
    ("hier_vae", _FUSED, _STEP + _K5, _K2),
    ("seq_vae", _RECIPE, _STEP + _K5, _K2),
)
_REGION_WARMUP, _REGION_STEPS = 5, 10
# The regions the JAX model names under model_fwd (mmvae_tpu/models/*.py);
# pred_vae names none.
_MODEL_REGIONS = {
    "seq_vae": ("frame_enc", "enc_lstm", "latent_head", "z_init", "dec_lstm", "frame_dec"),
    "pred_vae": (),
    "hier_vae": ("frame_enc", "chunk_lstm", "dec_lstm", "frame_dec"),
}
# The K = 1 step ms before the regions: phase 8 of this script at commit
# 1502755, on an NVIDIA H100 80GB HBM3, 700.00 W
_BEFORE_REGIONS_MS = {"mlp_vae": 2.843, "seq_vae": 46.557}


def _kernel_rows(name: str, k5: bool, k6: bool) -> dict:
    """{kernel name: the (row, pass) set its launches must fill} of a path:
    K3 in preprocess, K1 in elbo_reduce, the head in latent_head (model_fwd
    where the JAX model names no head region), K5 and K6 where the path
    runs them in the recurrences' regions, their backward (and the weight
    GEMM they share) in those regions' backward."""
    enc = {"seq_vae": "model_fwd/enc_lstm", "hier_vae": "model_fwd/chunk_lstm"}.get(
        name, "model_fwd")
    dec = "model_fwd/dec_lstm" if name != "pred_vae" else "model_fwd"
    head = "model_fwd/latent_head" if name == "seq_vae" else "model_fwd"
    rec = {r for r, runs in ((enc, k5), (dec, k6)) if runs}
    rows = {
        "preprocess_gather_kernel": {("preprocess", "fwd")},
        "bce_partial_kernel": {("elbo_reduce", "fwd")},
        "sum_partials_kernel": {("elbo_reduce", "fwd")},
        "head_sample_fwd_kernel": {(head, "fwd")},
        "head_sample_bwd_kernel": {(head, "bwd")},
    }
    if rec:
        rows.update({"rec_fwd_wgmma_kernel": {(r, "fwd") for r in rec},
                     "rec_bwd_wgmma_kernel": {(r, "bwd") for r in rec},
                     "wgrad_wgmma_kernel": {(r, "bwd") for r in rec}})
    return rows


def check_regions(card: str, dev, name: str, overrides, launched, idle) -> dict:
    """One path's per-region budget at K = 1 (`bench.regions`): a step with
    the profiler on bit-identical to one without (two fresh states), then
    `_REGION_WARMUP` steps and `_REGION_STEPS` traced ones with the launch
    counters set to 0 just before them and read just after.  Every region
    the JAX model names has device time, the rows sum to the window's
    summed device time, and each kernel kind lands in its region.  Returns
    the traced steps' launch counts."""
    import tempfile

    import torch

    from mmvae_torch import ops
    from mmvae_torch.bench import regions
    from mmvae_torch.bench.throughput import setup_resident_training
    from mmvae_torch.configs import get_config
    from mmvae_torch.utils.profiling import trace

    cfg = get_config(name, overrides)
    tag = f"regions {_tag(name, overrides)}"
    launched, idle = _slice_kernels(name, overrides, launched, idle)
    plain, (state, data, step) = (setup_resident_training(cfg, dev) for _ in range(2))
    m_plain = plain[2](plain[0], plain[1])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_regions_") as d, trace(d):
        m_traced = step(state, data)
    a, b = _state_tensors(plain[0]), _state_tensors(state)
    a.update((f"metric {k}", v) for k, v in m_plain.items())
    b.update((f"metric {k}", v) for k, v in m_traced.items())
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    _require(set(a) == set(b) and not differ,
             f"{tag}: a step under the profiler differs from one without: {differ[:5]}")
    del plain
    for _ in range(_REGION_WARMUP - 1):
        step(state, data)
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_regions_") as d:
        with trace(d) as prof:
            for _ in range(_REGION_STEPS):
                step(state, data)
        counts = _counts()
        raw = regions.load_trace(prof.trace_path)
        size = os.path.getsize(prof.trace_path)
    traced_s = time.perf_counter() - t0
    _require(all(counts[k] > 0 for k in launched), f"{tag}: a kernel was not launched: {counts}")
    _require(all(counts[k] == 0 for k in idle), f"{tag}: a kernel off this path ran: {counts}")
    timeline, work = regions.attribute(raw)
    budget = regions.tally(timeline, work, _REGION_STEPS)
    kernel_ms = sum(e["dur"] for e in raw["traceEvents"] if e.get("ph") == "X"
                    and e.get("cat") in regions.DEVICE_CATS) / 1e3 / _REGION_STEPS
    del raw
    _require(timeline == "device", f"{tag}: the trace holds no kernel")
    rows = {r["region"]: r for r in budget["rows"]}
    _require(math.isclose(sum(r["ms"] for r in rows.values()), kernel_ms, rel_tol=1e-9)
             and math.isclose(budget["total_ms"], kernel_ms, rel_tol=1e-9),
             f"{tag}: the rows sum to {budget['total_ms']} ms, the device's work to {kernel_ms}")
    want = ("preprocess", *(f"model_fwd/{r}" for r in _MODEL_REGIONS[name]), "elbo_reduce")
    if not _MODEL_REGIONS[name]:
        want += ("model_fwd",)
    for region in want:
        _require(region in rows and rows[region]["fwd_ms"] > 0,
                 f"{tag}: region {region} has no forward device time: {sorted(rows)}")
        _require(region == "preprocess" or rows[region]["bwd_ms"] > 0,
                 f"{tag}: region {region} has no backward device time")
    expect = _kernel_rows(name, _K5[0] in launched, _dec_k6(cfg))
    landed = {}
    for e, path, where in work:
        for kind in expect:
            if kind in e["name"]:
                landed.setdefault(kind, set()).add(("/".join(path or ()) or "?", where))
    for kind, rows_of_kind in expect.items():
        _require(landed.get(kind) == rows_of_kind,
                 f"{tag}: {kind} landed in {landed.get(kind)}, not {rows_of_kind}")
    print(f"[regions] {tag}: a step under the profiler bit-identical to one without "
          f"({len(a)} tensors); {_REGION_STEPS} traced steps in {traced_s:.1f} s (trace "
          f"{size / 2**20:.1f} MiB), launches {counts}; each kernel kind in its region: "
          f"{json.dumps({k: sorted(map(list, v)) for k, v in landed.items()})}")
    print(f"[regions] {tag}: {kernel_ms:.4f} ms a step of kernels, memsets and copies, "
          f"{budget['items_per_step']} of them a step, {budget['unlaunched_per_step']} with no "
          f"launch in the trace, on {card}")
    for r in budget["rows"]:
        print(f"[regions] {tag}: {r['region']:24s} fwd {r['fwd_ms']:.4f} bwd "
              f"{r['bwd_ms']:.4f} ms a step, share {r['share']:.4f}; top "
              f"{json.dumps([[n[:60], round(ms, 4)] for n, ms in r['top']])}")
    print(f"[regions] {json.dumps({'path': _tag(name, overrides), 'card': card, **budget})}")
    del state, data, step
    torch.cuda.empty_cache()
    return counts


def _gate_cost_us(calls: int = 200_000) -> tuple:
    """(us a call of `annotate` with no profiler running, us an empty
    `with` block)."""
    import contextlib

    from mmvae_torch.utils.profiling import annotate

    null = contextlib.nullcontext()
    out = []
    for ctx in (lambda: annotate("enc_lstm"), lambda: null):
        t0 = time.perf_counter()
        for _ in range(calls):
            with ctx():
                pass
        out.append((time.perf_counter() - t0) / calls * 1e6)
    return tuple(out)


def phase_regions(card: str, dev, timed_rows) -> dict:
    """The per-region budget on five paths, then the gate's cost: `annotate`
    with no profiler running, and phase 8's K = 1 step ms of configs 1 and
    3 (regions in place) beside those before the regions.  Returns {path:
    its launch counts}."""
    out = {f"regions {_tag(name, overrides)}": check_regions(card, dev, name, overrides,
                                                             launched, idle)
           for name, overrides, launched, idle in _REGION_PATHS}
    gated, empty = _gate_cost_us()
    print(f"[regions] annotate with no profiler running: {gated:.3f} us a region (an empty "
          f"with block {empty:.3f} us); 9 regions a step of config 3, 3 of config 1")
    for name, before in _BEFORE_REGIONS_MS.items():
        row = next(r for r in timed_rows if r["path"] == name and r["steps_per_call"] == 1)
        print(f"[regions] {name} K=1 step {row['step_ms']:.3f} ms with the regions in place "
              f"and no profiler running (phase 8), {before} ms before them (phase 8 at "
              f"commit 1502755), on {card}")
    return out


_QUALITY = "seq_vae_default"
_QUALITY_STEPS = 2000
_QUALITY_SEEDS = tuple(range(16))
_QUALITY_BAND = 0.05


def phase_quality(card: str) -> dict:
    """Config 3 default's convergence protocol (`mmvae_torch.bench.quality`)
    cut to its first 2,000 steps on the card, at train.seed 0-15: the full
    10,000-clip set, K = 10, logging every 200 steps, an eval of 4 val
    batches every 1,000, then each trained model's reconstruction of 256
    val clips; the launch counters set to 0 just before the first run and
    read just after the last, held to the path's equations (each run's
    2,000 train steps, 8 eval batches, and the reconstruction's head forward
    and K5 forward without residuals).  Every logged loss finite, each
    run's val_loss at 2,000 below its val_loss at 1,000, and their mean at
    2,000 within `_QUALITY_BAND` of the reference's one run
    (`docs/assets/seq_vae_r5_default_loss.csv`).  The mean, because one
    run is a draw as wide as the band: one seed's val_loss at 2,000 has a
    standard deviation of 4.7 % of the reference's number on the card, so
    the mean of 16 seeds has a standard error of about 1.2 points (8
    seeds': 1.65), and a change of rounding anywhere on the path, which
    redraws every run, moves the mean by about that much; each seed's own
    gap is printed beside the mean's.  Returns {path: its launch counts}."""
    import tempfile

    from mmvae_torch import ops
    from mmvae_torch.bench import quality

    tag = f"quality {_QUALITY} {_QUALITY_STEPS} steps, seeds {list(_QUALITY_SEEDS)}"
    protocol = quality.PROTOCOLS[_QUALITY]
    number = next(n for n in protocol.printed if n.column == "val_loss" and n.hi == _QUALITY_STEPS)
    print(f"[quality] {tag}: the protocol's config and cadences, on {card}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quality_") as out:
        dirs = [os.path.join(out, f"seed{seed}") for seed in _QUALITY_SEEDS]
        ops.reset_launch_counts()
        results = [quality.run(_QUALITY, seed=seed, steps=_QUALITY_STEPS, out=d, device="cuda",
                               print_fn=lambda *a: None)
                   for seed, d in zip(_QUALITY_SEEDS, dirs)]
        counts = _counts()
        csvs = [os.path.join(d, "metrics.csv") for d in dirs]
        runs = [quality.read_rows(c) for c in csvs]
        held = quality.compare_runs(csvs, [dataclasses.replace(number, band=_QUALITY_BAND)])
    n = len(_QUALITY_SEEDS)
    k6 = _dec_k6(quality.protocol_config(_QUALITY))
    want = _step_counts(n * _QUALITY_STEPS, n * 2 * quality.EVAL_BATCHES, k6=k6)
    want["head_sample_forward"] += n  # each seed's reconstruction
    want["convlstm_proj_forward"] += n
    if k6:  # the reconstruction's decoder, and the prior GIF's where PIL writes it
        gifs = sum("prior.gif" in res["fidelity"].get("pictures", ()) for res in results
                   if isinstance(res["fidelity"].get("pictures"), list))
        want["convlstm_scan_forward"] += n + gifs
    _require(all(counts[k] == want.get(k, 0) for k in counts),
             f"{tag}: launches {counts}, expected {want} (others 0)")
    for seed, res, rows in zip(_QUALITY_SEEDS, results, runs):
        _require(res["losses_finite"] and all(math.isfinite(float(r[c])) for r in rows
                                              for c in ("loss", "bce", "kl") if r.get(c)),
                 f"{tag}: seed {seed}: a non-finite loss in {rows}")
        val = {int(r["step"]): float(r["val_loss"]) for r in rows if r.get("val_loss")}
        fid = res["fidelity"]
        alone = val[_QUALITY_STEPS] / number.ref - 1.0
        print(f"[quality] seed {seed}: val_loss at 1000 {val.get(1000)}, at {_QUALITY_STEPS} "
              f"{val.get(_QUALITY_STEPS)} ({100 * alone:+.2f} % against the reference's, "
              f"{'inside' if abs(alone) <= _QUALITY_BAND else 'outside'} the band alone); fit {res['fit_frames_per_sec']:.1f} frames/s over "
              f"the run ({res['wall_s']:.1f} s, capture and evals included); reconstruction "
              f"BCE/px {fid['bce_per_pixel']:.4f} against the base rate's "
              f"{fid['base_rate_bce_per_pixel']:.4f}")
        _require(val[_QUALITY_STEPS] < val[1000],
                 f"{tag}: seed {seed}: val_loss did not fall from step 1000 to "
                 f"{_QUALITY_STEPS}: {val}")
        _require(fid["under_base_rate"], f"{tag}: seed {seed}: reconstruction {fid} not "
                 "under the base rate")
    print(f"[quality] {tag}: launches {counts}")
    gap = held["numbers"][0].get("gap")
    if gap is not None:
        print(f"[quality] the mean's gap {100 * gap:+.2f} % leaves "
              f"{100 * (_QUALITY_BAND - abs(gap)):.2f} points of the band")
    _require(held["ok"], f"{tag}: the mean val_loss at {_QUALITY_STEPS} {held['numbers']} is "
             f"not within {_QUALITY_BAND} of the reference's {number.ref}")
    return {tag: counts}


# --- phase 11: the 4-CTA widths and the lstm_features=192 probe ---------------

_WIDE_F = (160, 192, 224, 256)
# The reference's architecture probe (docs/RESULTS.md:56): the recipe with
# lstm_features=192, K5 at F = 192 in its encoder; with fused=true its
# decoder runs K6 at F = 192 with a time-constant xg.
_PROBE = _RECIPE + ("model.kwargs.lstm_features=192",)
_PROBE_FUSED = _PROBE + _FUSED
_PROBE_FIT_STEPS, _PROBE_FUSED_STEPS, _PROBE_CLI_STEPS = 200, 20, 20


def check_wide_kernels(dev) -> dict:
    """K5 and K6 at F = 160-256 (B = 64, T = 20, 8x8, K5's C = 128), both
    gate dtypes: K5's saving and residual-free forwards and its backward,
    K6's three forward modes and both backward modes with a time-constant
    and a streaming xg, through `kernel_checks` at its F = 128 readings;
    each backward twice bit-identical at F = 192 and 256; then each
    kernel's time (bf16 gates; K6 time-constant, per-step dhs) beside its
    plain version's and its bound.  Returns {wrapper: {"F=f": row}}."""
    import torch

    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import kernel_checks as kc

    rows = {name: {} for name in (*_K5, *_K6)}
    for f in _WIDE_F:
        k5, k6 = (64, 20, 8, 8, 128, f), (64, 20, 8, 8, f)
        err = dict.fromkeys(rows, 0.0)
        for gdt in (torch.float32, torch.bfloat16):
            cmp = kc.compare_proj(dev, k5, gdt)
            print(f"[wide] convlstm_proj {k5} bf16, gates {gdt}: {cmp.text()}")
            cmp.check(f"convlstm_proj {k5} gates {gdt}")
            err["convlstm_proj_forward"] = max(err["convlstm_proj_forward"], cmp.fwd_err)
            err["convlstm_proj_backward"] = max(err["convlstm_proj_backward"], cmp.bwd_err)
            for const in (True, False):
                cmp = kc.compare_scan(dev, k6, const, gdt)
                tag = f"{k6} {'const' if const else 'streaming'}"
                print(f"[wide] convlstm_scan {tag} bf16, gates {gdt}: {cmp.text()}")
                cmp.check(f"convlstm_scan {tag} gates {gdt}")
                err["convlstm_scan_forward"] = max(err["convlstm_scan_forward"], cmp.fwd_err)
                err["convlstm_scan_backward"] = max(err["convlstm_scan_backward"], cmp.bwd_err)
        if f in (192, 256):
            same = kc.proj_backward_repeatable(dev, k5)
            for const in (True, False):
                same.update({f"K6 {'const' if const else 'streaming'} {n}": v for n, v in
                             kc.scan_backward_repeatable(dev, k6, const).items()})
            _require(all(same.values()), f"backward at F={f} differs between two calls: {same}")
            print(f"[wide] F={f}: two calls of each backward on the same inputs give "
                  f"bit-identical {', '.join(same)}")
        x, wx, bx, w, c0, h0 = kc.proj_inputs(dev, *k5, seed=6)
        res = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, torch.bfloat16, True)
        dh = torch.randn(c0.shape, device=dev)
        xg, wh, sc0, sh0 = kc.scan_inputs(dev, 64, 1, 8, 8, f, seed=10)
        sres = ck.scan_forward_cuda(xg, wh, sc0, sh0, 20, torch.bfloat16, "save")
        dhs = torch.randn(sres[0].shape, device=dev)
        calls = {
            "convlstm_proj_forward": (
                k5, lambda: ck.proj_forward_cuda(x, wx, bx, w, c0, h0, torch.bfloat16, True),
                lambda: ck.proj_forward_plain(x, wx, bx, w, c0, h0, torch.bfloat16, True)),
            "convlstm_proj_backward": (
                k5, lambda: ck.proj_backward_cuda(x, wx, w, c0, h0, *res, dh, dh),
                lambda: ck.proj_backward_plain(x, wx, w, c0, h0, *res, dh, dh)),
            "convlstm_scan_forward": (
                (*k6, True), lambda: ck.scan_forward_cuda(xg, wh, sc0, sh0, 20, torch.bfloat16,
                                                          "save"),
                lambda: ck.scan_forward_plain(xg, wh, sc0, sh0, 20, torch.bfloat16, "save")),
            "convlstm_scan_backward": (
                (*k6, True), lambda: ck.scan_backward_cuda(wh, sc0, sh0, *sres, dhs, dhs[:, -1],
                                                           True, False),
                lambda: ck.scan_backward_plain(wh, sc0, sh0, *sres, dhs, dhs[:, -1], True,
                                               False)),
        }
        for name, (key, kern, plain) in calls.items():
            ms, plain_ms = _time_ms(kern, 5), _time_ms(plain, 3)
            b_ms, by = _bound(name, key)
            rows[name][f"F={f}"] = {"shape": list(key), "max_abs_err": err[name], "ms": ms,
                                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}
            print(f"[wide] {name} {key}, bf16 gates: {ms:.3f} ms, {_share(ms, name, key)}, "
                  f"vs plain {plain_ms:.3f} ms; library: none (no one PyTorch call runs the "
                  f"recurrence)")
        del res, sres
        torch.cuda.empty_cache()
    return rows


def _probe_cfg(overrides, *more):
    """The probe's config at full width in one process: config 3's batch,
    clip length and widths but lstm_features=192."""
    from mmvae_torch.configs import get_config

    cfg = get_config("seq_vae", ("train.data_parallel=false", *overrides, *more))
    base = get_config("seq_vae")
    kw, base_kw = _model_kwargs(cfg), _model_kwargs(base)
    _require(cfg.data.batch_size == base.data.batch_size and cfg.data.seq_len == base.data.seq_len
             and cfg.model.dtype == base.model.dtype and kw["lstm_features"] == 192
             and all(kw[k] == base_kw[k] for k in ("enc_channels", "latent_dim", "image_size")),
             "the probe is not config 3 at full width with lstm_features=192")
    return cfg


def phase_wide(card: str, dev, workdir: str) -> tuple:
    """K5 and K6 at the 4-CTA widths against their plain versions, then the
    probe: its model (default decoder and fused=true) card with kernels
    against CPU with plain versions; `fit` at K = 10 (200
    steps, one eval pass raw and under the EMA: finite, falling loss, K5 at
    F = 192 in its launch equations) and with fused=true at K = 1 (K6
    launched); `python -m mmvae_torch train` at K = 1; `run_benchmark` at K
    = 1 and 10 (frames/s, step and busy ms, idle share, MFU); sampling
    (prior and reconstruct) card against CPU and its frames/s.  Returns
    ({wrapper: wide rows}, {path: launch counts})."""
    import torch

    from mmvae_torch import ops
    from mmvae_torch.bench.throughput import run_benchmark

    t0 = time.perf_counter()
    rows = check_wide_kernels(dev)
    t1 = time.perf_counter()
    check_model(dev, "seq_vae", 4, _PROBE)
    check_model(dev, "seq_vae", 4, _PROBE_FUSED)
    t2 = time.perf_counter()
    out = {}
    cadence = ("train.eval_batches=2",) + _CUT
    for tag, overrides, steps, k in (
            ("fit probe K=10", _PROBE, _PROBE_FIT_STEPS, 10),
            ("fit probe fused", _PROBE_FUSED, _PROBE_FUSED_STEPS, 1)):
        cfg = _probe_cfg(overrides, *cadence, f"train.eval_every={steps}",
                         f"train.log_every={steps // 4}", f"train.steps_per_call={k}")
        want = _step_counts(steps, 2 * 2, k6=_dec_k6(cfg))
        _, history, counts = _fit(card, tag, cfg, steps, want, dev)
        _require(history[-1]["loss"] < history[0]["loss"],
                 f"{tag}: loss did not fall: {[round(h['loss'], 1) for h in history]}")
        _require(all(math.isfinite(history[-1].get(c, math.nan))
                     for c in ("val_loss", "val_loss_ema")), f"{tag}: {history[-1]}")
        print(f"[wide] {tag}: loss {history[0]['loss']:.2f} at step {history[0]['step']} -> "
              f"{history[-1]['loss']:.2f} at {history[-1]['step']}, val_loss "
              f"{history[-1]['val_loss']:.2f}, val_loss_ema {history[-1]['val_loss_ema']:.2f}")
        out[tag] = counts
    t3 = time.perf_counter()
    ck_dir = os.path.join(workdir, "probe_ckpt")
    sets = [a for ov in (*_PROBE, *cadence, f"train.eval_every={_PROBE_CLI_STEPS}",
                         f"train.log_every={_PROBE_CLI_STEPS // 2}",
                         f"train.checkpoint_dir={ck_dir}") for a in ("--set", ov)]
    ops.reset_launch_counts()
    rc, _ = _cli(["train", "--config", "seq_vae", "--steps", str(_PROBE_CLI_STEPS), *sets])
    counts = _counts()
    want = _step_counts(_PROBE_CLI_STEPS, 2 * 2, k6=_dec_k6(_probe_cfg(_PROBE)))
    _require(rc == 0 and all(counts[k] == want.get(k, 0) for k in counts),
             f"cli train probe: rc {rc}, launches {counts}, expected {want}")
    _require(os.path.isdir(ck_dir) and os.listdir(ck_dir), f"cli train probe: no checkpoint "
                                                           f"in {ck_dir}")
    print(f"[wide] python -m mmvae_torch train --config seq_vae --steps {_PROBE_CLI_STEPS} "
          f"{' '.join(sets)}: rc 0, launches {counts}")
    out["cli train probe"] = counts
    t4 = time.perf_counter()
    timing = []
    for k in (1, 10):
        cfg = _chunk_cfg("seq_vae", _PROBE, k)
        tag = f"bench probe K={k}"
        ops.reset_launch_counts()
        res = run_benchmark(cfg, steps=20, warmup=10, device_profile=True)
        out[tag] = _counts()
        losses = res.pop("losses")
        _require(all(math.isfinite(v) for v in losses), f"{tag}: a non-finite loss")
        _require(out[tag]["convlstm_proj_forward"] > 0
                 and (out[tag]["convlstm_scan_forward"] > 0) == _dec_k6(cfg),
                 f"{tag}: launches {out[tag]}")
        row = {"path": _tag("seq_vae", _PROBE), "steps_per_call": k,
               **{key: res[key] for key in (
                   "value", "value_min", "value_max", "step_ms", "device_busy_ms",
                   "idle_share", "kernels_per_step", "host_launches_per_step",
                   "flops_per_step", "tflops_per_sec_chip", "mfu", "card")}}
        timing.append(row)
        print(f"[wide] timing {json.dumps(row)}")
        torch.cuda.empty_cache()
    t5 = time.perf_counter()
    out.update(check_sampling(card, dev, "seq_vae", _PROBE, ("prior", "reconstruct")))
    t6 = time.perf_counter()
    print(f"[wide] seconds: kernels {t1 - t0:.1f}, models {t2 - t1:.1f}, fit {t3 - t2:.1f}, "
          f"cli {t4 - t3:.1f}, bench {t5 - t4:.1f}, sampling {t6 - t5:.1f}; on {card}")
    return rows, out


# Phase 12: f32 activations in K5 and K6 (F <= 128), the JAX package's
# default dtype, which configs 3-5 leave for bf16 in their own factories.
_F32 = ("model.dtype=float32",)
# (K5 shapes, K6 shapes): config 3 (B=64, T=20), config 4's decoder (K6
# time-constant, T=10) and its streaming encoder-length K6, config 5's batch
# of 160 (T=10)
_F32_K5 = ((64, 20, 8, 8, 128, 128), (160, 10, 8, 8, 128, 128))
_F32_K6 = (((64, 10, 8, 8, 128), True), ((64, 20, 8, 8, 128), False),
           ((160, 10, 8, 8, 128), True))
_F32_FIT_STEPS, _F32_CLI_STEPS = 100, 10


def check_f32_kernels(dev) -> dict:
    """K5 and K6 with f32 activations against their plain versions (TF32
    off) at `_F32_K5` and `_F32_K6`, both gate dtypes, every forward mode
    and both backward modes (`kernel_checks.compare_proj` / `compare_scan`
    with act=float32), beside the TF32 control (the plain version with its
    product operands rounded to TF32) at config 3's K5 and config 4's K6
    shape, which must read over the limit; each backward twice
    bit-identical; then each kernel's time (bf16 gates, as configs 3-5 run
    under model.dtype=float32; K6 time-constant, per-step dhs) beside its
    plain version's and its bound (`bench.roofline`, 3xTF32).  Returns
    {wrapper: {shape: row}}."""
    import torch

    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import kernel_checks as kc

    f32, bf16 = torch.float32, torch.bfloat16
    err = {name: 0.0 for name in (*_K5, *_K6)}
    worst = 0.0
    for shape in _F32_K5:
        for gdt in (f32, bf16):
            cmp = kc.compare_proj(dev, shape, gdt, act=f32)
            print(f"[f32] convlstm_proj {shape} f32, gates {gdt}: {cmp.text()}")
            cmp.check(f"convlstm_proj {shape} f32 gates {gdt}")
            err["convlstm_proj_forward"] = max(err["convlstm_proj_forward"], cmp.fwd_err)
            err["convlstm_proj_backward"] = max(err["convlstm_proj_backward"], cmp.bwd_err)
            worst = max([worst] + [r.value for r in cmp.readings if "f32 ulps" in r.text])
    for shape, const in _F32_K6:
        tag = f"{shape} {'const' if const else 'streaming'}"
        for gdt in (f32, bf16):
            cmp = kc.compare_scan(dev, shape, const, gdt, act=f32)
            print(f"[f32] convlstm_scan {tag} f32, gates {gdt}: {cmp.text()}")
            cmp.check(f"convlstm_scan {tag} f32 gates {gdt}")
            err["convlstm_scan_forward"] = max(err["convlstm_scan_forward"], cmp.fwd_err)
            err["convlstm_scan_backward"] = max(err["convlstm_scan_backward"], cmp.bwd_err)
            worst = max([worst] + [r.value for r in cmp.readings if "f32 ulps" in r.text])
    controls = {**{f"K5 {k}": v for k, v in kc.proj_tf32_control(dev, _F32_K5[0]).items()},
                **{f"K6 {k}": v for k, v in kc.scan_tf32_control(dev, *_F32_K6[0]).items()}}
    low = min(controls, key=controls.get)
    print(f"[f32] TF32 control (the plain version with its product operands rounded to TF32, "
          f"f32 gates), f32 ulps: " + ", ".join(f"{k} {v:.1f}" for k, v in controls.items()))
    _require(worst <= kc.REC_F32_ULPS < controls[low],
             f"the f32 limit {kc.REC_F32_ULPS:g} f32 ulps does not sit between the kernels' "
             f"worst reading {worst:.1f} and the TF32 control's least, {low} "
             f"{controls[low]:.1f}")
    print(f"[f32] limit {kc.REC_F32_ULPS:g} f32 ulps: the kernels' worst reading {worst:.1f}, "
          f"the TF32 control's least {controls[low]:.1f} ({low})")
    wg = kc.wgrad_f64_readings(dev, _F32_K5[0])
    _require(wg["kernel"] <= kc.REC_F32_ULPS < wg["TF32 operands"],
             f"the f32 weight GEMM against an f64 product: {wg}")
    print(f"[f32] the f32 weight GEMM alone at {_F32_K5[0]} against the same product in f64, "
          f"f32 ulps: " + ", ".join(f"{k} {v:.1f}" for k, v in wg.items()))
    same = {f"K5 {n}": v
            for n, v in kc.proj_backward_repeatable(dev, _F32_K5[0], act=f32).items()}
    for const in (True, False):
        same.update({f"K6 {'const' if const else 'streaming'} {n}": v for n, v in
                     kc.scan_backward_repeatable(dev, _F32_K6[0][0], const, act=f32).items()})
    _require(all(same.values()), f"an f32 backward differs between two calls: {same}")
    print(f"[f32] two calls of each f32 backward on the same inputs give bit-identical "
          f"{', '.join(same)}")

    rows = {name: {} for name in err}
    for k5 in _F32_K5[:1]:
        x, wx, bx, w, c0, h0 = kc.proj_inputs(dev, *k5, seed=6, dtype=f32)
        res = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, bf16, True)
        dh = torch.randn(c0.shape, device=dev)
        calls = {
            "convlstm_proj_forward": (
                lambda: ck.proj_forward_cuda(x, wx, bx, w, c0, h0, bf16, True),
                lambda: ck.proj_forward_plain(x, wx, bx, w, c0, h0, bf16, True)),
            "convlstm_proj_backward": (
                lambda: ck.proj_backward_cuda(x, wx, w, c0, h0, *res, dh, dh),
                lambda: ck.proj_backward_plain(x, wx, w, c0, h0, *res, dh, dh)),
        }
        key = (*k5, 4)
        _time_f32(rows, calls, key, err)
    (shape, const) = _F32_K6[0]
    xg, wh, sc0, sh0 = kc.scan_inputs(dev, shape[0], 1, *shape[2:], seed=10, dtype=f32)
    sres = ck.scan_forward_cuda(xg, wh, sc0, sh0, shape[1], bf16, "save")
    dhs = torch.randn(sres[0].shape, device=dev)
    calls = {
        "convlstm_scan_forward": (
            lambda: ck.scan_forward_cuda(xg, wh, sc0, sh0, shape[1], bf16, "save"),
            lambda: ck.scan_forward_plain(xg, wh, sc0, sh0, shape[1], bf16, "save")),
        "convlstm_scan_backward": (
            lambda: ck.scan_backward_cuda(wh, sc0, sh0, *sres, dhs, dhs[:, -1], True, False),
            lambda: ck.scan_backward_plain(wh, sc0, sh0, *sres, dhs, dhs[:, -1], True, False)),
    }
    _time_f32(rows, calls, (*shape, const, 4), err)
    return rows


def _time_f32(rows, calls, key, err) -> None:
    """Each call's kernel and plain times (CUDA events, TF32 off) into rows."""
    from mmvae_torch.ops.kernel_checks import full_f32

    for name, (kern, plain) in calls.items():
        with full_f32():
            ms, plain_ms = _time_ms(kern, 5), _time_ms(plain, 3)
        b_ms, by = _bound(name, key)
        rows[name][str(key[:-1])] = {"shape": list(key), "max_abs_err": err[name], "ms": ms,
                                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}
        print(f"[f32] {name} {key[:-1]} f32, bf16 gates: {ms:.3f} ms, {_share(ms, name, key)}, "
              f"vs plain {plain_ms:.3f} ms; library: none (no one PyTorch call runs the "
              f"recurrence)")


def _f32_cfg(overrides, *more):
    """Config 3 at full width in one process with f32 activations."""
    from mmvae_torch.configs import get_config

    cfg = get_config("seq_vae", ("train.data_parallel=false", *_F32, *overrides, *more))
    base = get_config("seq_vae")
    kw, base_kw = _model_kwargs(cfg), _model_kwargs(base)
    _require(cfg.data.batch_size == base.data.batch_size and cfg.data.seq_len == base.data.seq_len
             and cfg.model.dtype == "float32" and kw["gate_bf16"]
             and all(kw[k] == base_kw[k] for k in ("enc_channels", "latent_dim", "image_size",
                                                    "lstm_features")),
             "the f32 run is not config 3 at full width with model.dtype=float32")
    return cfg


def phase_f32(card: str, dev, workdir: str) -> tuple:
    """f32 activations: K5 and K6 against their plain versions
    (`check_f32_kernels`), the bf16 kernels' output hashes (for a parent
    comparison, `bench.hashes`), the models of configs 3 (default and
    fused), 4 fused and 5 fused with model.dtype=float32 card against CPU
    (`check_model`), `fit` of config 3 f32 at K = 10 (100 steps, an EMA,
    one eval pass raw and under the EMA: finite, falling loss, K5 in its
    launch equations), `python -m mmvae_torch train` of config 3 f32,
    default and fused (K5, and K6 where fused, in their launch equations),
    `run_benchmark` at K = 1 and 10 (frames/s, step and busy ms, idle
    share, MFU), sampling (prior and reconstruct) card against CPU with
    its frames/s; the launch counters set to 0 just before each run and
    read just after.  Returns ({wrapper: f32 rows}, {path: launch counts})."""
    import torch

    from mmvae_torch import ops
    from mmvae_torch.bench.hashes import digests
    from mmvae_torch.bench.throughput import run_benchmark

    t0 = time.perf_counter()
    rows = check_f32_kernels(dev)
    for key, value in digests().items():
        print(f"[f32] bf16 kernels' outputs {key}: sha256 {value}")
    t1 = time.perf_counter()
    check_model(dev, "seq_vae", 4, act="float32")
    check_model(dev, "seq_vae", 4, _FUSED, act="float32")
    check_model(dev, "pred_vae", 20, _FUSED, act="float32")
    check_model(dev, "hier_vae", 20, _FUSED, act="float32")
    t2 = time.perf_counter()
    out = {}
    cadence = ("train.eval_batches=2", "optim.ema_decay=0.999") + _CUT
    tag = "fit f32 K=10"
    cfg = _f32_cfg((), *cadence, f"train.eval_every={_F32_FIT_STEPS}",
                   f"train.log_every={_F32_FIT_STEPS // 5}", "train.steps_per_call=10")
    want = _step_counts(_F32_FIT_STEPS, 2 * 2, k6=_dec_k6(cfg))
    _, history, counts = _fit(card, tag, cfg, _F32_FIT_STEPS, want, dev)
    _require(history[-1]["loss"] < history[0]["loss"],
             f"{tag}: loss did not fall: {[round(h['loss'], 1) for h in history]}")
    _require(all(math.isfinite(history[-1].get(c, math.nan))
                 for c in ("val_loss", "val_loss_ema")), f"{tag}: {history[-1]}")
    print(f"[f32] {tag}: loss {history[0]['loss']:.2f} at step {history[0]['step']} -> "
          f"{history[-1]['loss']:.2f} at {history[-1]['step']}, val_loss "
          f"{history[-1]['val_loss']:.2f}, val_loss_ema {history[-1]['val_loss_ema']:.2f}")
    out[tag] = counts
    t3 = time.perf_counter()
    for fused in (False, True):
        more = _FUSED if fused else ()
        ck_dir = os.path.join(workdir, f"f32_ckpt{'_fused' if fused else ''}")
        sets = [a for ov in (*_F32, *more, "train.eval_batches=2", "optim.ema_decay=0.999",
                             *_CUT, f"train.eval_every={_F32_CLI_STEPS}",
                             f"train.log_every={_F32_CLI_STEPS // 2}",
                             f"train.checkpoint_dir={ck_dir}") for a in ("--set", ov)]
        ops.reset_launch_counts()
        rc, _ = _cli(["train", "--config", "seq_vae", "--steps", str(_F32_CLI_STEPS), *sets])
        counts = _counts()
        want = _step_counts(_F32_CLI_STEPS, 2 * 2, k6=_dec_k6(_f32_cfg(more)))
        _require(rc == 0 and all(counts[k] == want.get(k, 0) for k in counts),
                 f"cli train f32{' fused' if fused else ''}: rc {rc}, launches {counts}, "
                 f"expected {want}")
        print(f"[f32] python -m mmvae_torch train --config seq_vae --steps {_F32_CLI_STEPS} "
              f"{' '.join(sets)}: rc 0, launches {counts}")
        out[f"cli train f32{' fused' if fused else ''}"] = counts
    t4 = time.perf_counter()
    timing = []
    for k in (1, 10):
        cfg = _chunk_cfg("seq_vae", _F32, k)
        tag = f"bench f32 K={k}"
        ops.reset_launch_counts()
        res = run_benchmark(cfg, steps=20, warmup=10, device_profile=True)
        out[tag] = _counts()
        losses = res.pop("losses")
        _require(all(math.isfinite(v) for v in losses), f"{tag}: a non-finite loss")
        _require(out[tag]["convlstm_proj_forward"] > 0
                 and (out[tag]["convlstm_scan_forward"] > 0) == _dec_k6(cfg),
                 f"{tag}: launches {out[tag]}")
        row = {"path": _tag("seq_vae", _F32), "steps_per_call": k,
               **{key: res[key] for key in (
                   "value", "value_min", "value_max", "step_ms", "device_busy_ms",
                   "idle_share", "kernels_per_step", "host_launches_per_step",
                   "flops_per_step", "tflops_per_sec_chip", "mfu", "card")}}
        timing.append(row)
        print(f"[f32] timing {json.dumps(row)}")
        torch.cuda.empty_cache()
    t5 = time.perf_counter()
    out.update(check_sampling(card, dev, "seq_vae", _F32, ("prior", "reconstruct")))
    t6 = time.perf_counter()
    print(f"[f32] seconds: kernels {t1 - t0:.1f}, models {t2 - t1:.1f}, fit {t3 - t2:.1f}, "
          f"cli {t4 - t3:.1f}, bench {t5 - t4:.1f}, sampling {t6 - t5:.1f}; on {card}")
    return rows, out


# --- phase 13: the general-shape kernels --------------------------------------

# The JAX package's own small widths of configs 3-5 (`__graft_entry__.py`'s
# _DRYRUN_TINY, which tests/test_torch_general.py holds this copy equal to):
# a 16x16 latent grid at F = 16, C = 16, outside the wgmma kernels' domain.
_JAX_TINY = {
    "seq_vae": {"enc_channels": (8, 16), "lstm_features": 16, "latent_dim": 16},
    "pred_vae": {
        "enc_channels": (8, 16), "lstm_features": 16, "latent_dim": 16,
        "context_len": 2,
    },
    "hier_vae": {
        "enc_channels": (8, 16), "lstm_features": 16, "chunk_feature": 16,
        "global_latent": 8, "chunk_latent": 4, "chunk_len": 2, "remat": True,
    },
}


# The general kernels' rows of the kernels line: the K5 and K6 wrappers whose
# launches they count on phase 13's paths, the TPU kernels they replace.
_GENERAL = {f"{name}_general": (name, "mmvae_torch/csrc/convlstm_general.cu", _KERNELS[name][2])
            for name in (*_K5, *_K6)}
# The reference's probe (docs/RESULTS.md:56) at the JAX package's default
# activation dtype: K5 at (64, 20, 8, 8, 128, 192) f32 on the general route,
# and with fused=true K6 at F = 192 f32 (time-constant xg).
_PROBE_F32 = _PROBE + _F32
_PROBE_F32_FUSED = _PROBE_F32 + _FUSED
_GENERAL_FIT_STEPS, _GENERAL_FUSED_STEPS = 20, 4
# The shapes timed on the general route (bf16 gates, as the configs run):
# the 16x16 grid at full width in bf16 and f32, and the f32 probe.
_GENERAL_TIMED = (((64, 20, 16, 16, 128, 128), "bfloat16"),
                  ((64, 20, 16, 16, 128, 128), "float32"),
                  ((64, 20, 8, 8, 128, 192), "float32"))
# Their times before the tensor-core redesign (the f32 FMA kernels of PR 15,
# PR 16's log 16 on an "NVIDIA H100 80GB HBM3, 700.00 W"; PERF.md), by
# (wrapper, activation bytes, F): printed beside each new time.
_GENERAL_LOG16_MS = {
    ("convlstm_proj_forward", 2, 128): 62.796, ("convlstm_proj_forward", 4, 128): 62.299,
    ("convlstm_proj_forward", 4, 192): 44.589, ("convlstm_proj_backward", 2, 128): 129.343,
    ("convlstm_proj_backward", 4, 128): 136.921, ("convlstm_proj_backward", 4, 192): 82.700,
    ("convlstm_scan_forward", 2, 128): 58.548, ("convlstm_scan_forward", 4, 128): 58.745,
    ("convlstm_scan_forward", 4, 192): 43.084, ("convlstm_scan_backward", 2, 128): 126.631,
    ("convlstm_scan_backward", 4, 128): 134.550, ("convlstm_scan_backward", 4, 192): 76.256,
}


def _tiny_overrides(name: str) -> tuple:
    """`_JAX_TINY[name]` as `--set`s."""
    def text(v):
        if isinstance(v, bool):
            return str(v).lower()
        return ",".join(map(str, v)) if isinstance(v, tuple) else str(v)

    return tuple(f"model.kwargs.{k}={text(v)}" for k, v in _JAX_TINY[name].items())


def _routes(cfg) -> tuple:
    """(K5's route, K6's route) of a sequence config: its encoder's last
    channels and its latent grid (64 / 2^stages), lstm_features, its
    activation dtype (`convlstm_kernels.route`)."""
    import torch

    from mmvae_torch.ops import convlstm_kernels as ck

    kw = _model_kwargs(cfg)
    side = 64 >> len(kw["enc_channels"])
    act = getattr(torch, cfg.model.dtype)
    f = kw["lstm_features"]
    return (ck.route(act, f, side * side, kw["enc_channels"][-1]),
            ck.route(act, f, side * side))


def _timed_row(what: str, name: str, key, kern, plain, iters: int, before=None) -> dict:
    """`kern`'s and its plain version's ms (CUDA events over `iters` calls,
    TF32 off) beside the bound of kernel `name` at `key` (and its time
    `before`, where given), printed; the row."""
    from mmvae_torch.ops.kernel_checks import full_f32

    with full_f32():
        ms, plain_ms = _time_ms(kern, iters, 1), _time_ms(plain, 3, 1)
    b_ms, by = _bound(name, key)
    was = "" if before is None else f" (PR 16 log 16: {before:.3f} ms, {before / ms:.1f}x)"
    print(f"[general] {what} {name} {key}, bf16 gates: {ms:.3f} ms{was}, "
          f"{_share(ms, name, key)}, vs plain {plain_ms:.3f} ms; library: none (no one "
          f"PyTorch call runs the recurrence)")
    return {"kernel": name, "shape": list(key), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def check_general_kernels(dev) -> tuple:
    """K5 and K6 on the general route at every shape of
    `kernel_checks.GENERAL_SHAPES` (the JAX package's small widths, the
    README's, odd grids and widths, F off the wgmma multiples, f32 above F =
    128, a 16x16 grid at full width, the f32 probe), both gate dtypes,
    every mode, against their plain versions at phase 3's limits
    (`kernel_checks.check_general`), each backward twice bit-identical, the
    launches all on the general route; the TF32 control at the f32 probe's
    shape over the f32 limit; then the general kernels timed at
    `_GENERAL_TIMED` beside their plain versions and bounds, and the wgmma
    forwards without residuals that PERF.md had not timed (f32 at configs
    3 and 4's shapes, the 4-CTA widths).  Returns ({general wrapper:
    {shape: row}}, {shape: wgmma no-residual row})."""
    import torch

    from mmvae_torch import ops
    from mmvae_torch.ops import convlstm_kernels as ck
    from mmvae_torch.ops import kernel_checks as kc

    bf16, f32 = torch.bfloat16, torch.float32
    err = dict.fromkeys((*_K5, *_K6), 0.0)
    worst = 0.0
    for shape, acts in kc.GENERAL_SHAPES:
        for act in acts:
            ops.reset_launch_counts()
            got = kc.check_general(dev, shape, act)
            counts = _counts(general=True)
            for label, cmp in got["comparisons"]:
                print(f"[general] {label}: {cmp.text()}")
                if act == f32:
                    worst = max([worst] + [r.value for r in cmp.readings if "f32 ulps" in r.text])
                if shape[2:4] == (16, 16) and shape[0] == 64 and "bfloat16" in label.split(
                        "gates")[-1]:
                    cs = next(r for r in cmp.readings if r.text.startswith("cs "))
                    print(f"[general] cell state at full width, {label}: {cs.value:.2f} of its "
                          f"bound ({cs.text})")
            _require(all(got["same"].values()), f"{shape} {act}: a backward differs between "
                                                 f"two calls: {got['same']}")
            _require(all(counts[n] > 0 for n in (*_K5, *_K6)),
                     f"{shape} {act}: not every K5 and K6 kernel launched: {counts}")
            print(f"[general] {shape} {act}: every launch general ({counts['convlstm_proj_forward']}"
                  f" K5 forwards, {counts['convlstm_scan_backward']} K6 backwards); two calls of "
                  f"each backward bit-identical ({', '.join(got['same'])})")
            for name, e in got["err"].items():
                err[name] = max(err[name], e)
    probe = (64, 20, 8, 8, 128, 192)
    control = kc.proj_tf32_control(dev, probe)
    low = min(control, key=control.get)
    _require(worst <= kc.REC_F32_ULPS < control[low],
             f"the f32 limit {kc.REC_F32_ULPS:g} does not sit between the general kernels' "
             f"worst f32 reading {worst:.1f} and the TF32 control's least at {probe}, {low} "
             f"{control[low]:.1f}")
    print(f"[general] f32 limit {kc.REC_F32_ULPS:g} f32 ulps: the general kernels' worst "
          f"reading {worst:.1f}, the TF32 control's least at {probe} {control[low]:.1f} ({low})")

    rows = {f"{n}_general": {} for n in (*_K5, *_K6)}
    for shape, act_name in _GENERAL_TIMED:
        act = getattr(torch, act_name)
        x, wx, bx, w, c0, h0 = kc.proj_inputs(dev, *shape, seed=6, dtype=act)
        res = ck.proj_forward_cuda(x, wx, bx, w, c0, h0, bf16, True)
        dh = torch.randn(c0.shape, device=dev)
        b, t, h, w_, _, f = shape
        xg, wh, sc0, sh0 = kc.scan_inputs(dev, b, 1, h, w_, f, seed=10, dtype=act)
        sres = ck.scan_forward_cuda(xg, wh, sc0, sh0, t, bf16, "save")
        dhs = torch.randn(sres[0].shape, device=dev)
        k5, k6 = (*shape, ck._es(act)), (b, t, h, w_, f, True, ck._es(act))
        calls = {
            "convlstm_proj_forward": (
                k5, lambda: ck.proj_forward_cuda(x, wx, bx, w, c0, h0, bf16, True),
                lambda: ck.proj_forward_plain(x, wx, bx, w, c0, h0, bf16, True)),
            "convlstm_proj_backward": (
                k5, lambda: ck.proj_backward_cuda(x, wx, w, c0, h0, *res, dh, dh),
                lambda: ck.proj_backward_plain(x, wx, w, c0, h0, *res, dh, dh)),
            "convlstm_scan_forward": (
                k6, lambda: ck.scan_forward_cuda(xg, wh, sc0, sh0, t, bf16, "save"),
                lambda: ck.scan_forward_plain(xg, wh, sc0, sh0, t, bf16, "save")),
            "convlstm_scan_backward": (
                k6, lambda: ck.scan_backward_cuda(wh, sc0, sh0, *sres, dhs, dhs[:, -1], True,
                                                  False),
                lambda: ck.scan_backward_plain(wh, sc0, sh0, *sres, dhs, dhs[:, -1], True,
                                               False)),
        }
        for name, (key, kern, plain) in calls.items():
            row = _timed_row("general", name, key, kern, plain, 3,
                             _GENERAL_LOG16_MS.get((name, ck._es(act), f)))
            rows[f"{name}_general"][str(key)] = {**row, "max_abs_err": err[name]}
        del res, sres
        torch.cuda.empty_cache()

    # the wgmma forwards without residuals PERF.md had not timed
    nores = {}
    for shape, act in (((64, 20, 8, 8, 128, 128), f32),
                       *(((64, 20, 8, 8, 128, f), bf16) for f in _WIDE_F)):
        x, wx, bx, w, c0, h0 = kc.proj_inputs(dev, *shape, seed=6, dtype=act)
        key = (*shape, ck._es(act))
        nores[str(key)] = _timed_row(
            "wgmma", "convlstm_proj_forward_nores", key,
            lambda: ck.proj_forward_cuda(x, wx, bx, w, c0, h0, bf16, False),
            lambda: ck.proj_forward_plain(x, wx, bx, w, c0, h0, bf16, False), 5)
    for (b, t, h, w_, f), act in (((64, 10, 8, 8, 128), f32),
                                  *(((64, 20, 8, 8, f), bf16) for f in _WIDE_F)):
        xg, wh, sc0, sh0 = kc.scan_inputs(dev, b, 1, h, w_, f, seed=10, dtype=act)
        for mode in ("hs", "last"):
            key = (b, t, h, w_, f, True, ck._es(act))
            nores[f"{key} {mode}"] = _timed_row(
                "wgmma", f"convlstm_scan_forward_{mode}", key,
                lambda: ck.scan_forward_cuda(xg, wh, sc0, sh0, t, bf16, mode),
                lambda: ck.scan_forward_plain(xg, wh, sc0, sh0, t, bf16, mode), 5)
    return rows, nores


def _probe_f32_cfg(overrides, *more):
    """The f32 probe's config at full width in one process: config 3's
    batch, clip length and widths but lstm_features=192, f32 activations."""
    from mmvae_torch.configs import get_config

    cfg = get_config("seq_vae", ("train.data_parallel=false", *overrides, *more))
    base = get_config("seq_vae")
    kw, base_kw = _model_kwargs(cfg), _model_kwargs(base)
    _require(cfg.data.batch_size == base.data.batch_size and cfg.data.seq_len == base.data.seq_len
             and cfg.model.dtype == "float32" and kw["lstm_features"] == 192
             and all(kw[k] == base_kw[k] for k in ("enc_channels", "latent_dim", "image_size")),
             "the f32 probe is not config 3 at full width with lstm_features=192 in f32")
    return cfg


def phase_general(card: str, dev) -> tuple:
    """The general-shape kernels: (a) K5 and K6 on the general route
    against their plain versions, timed (`check_general_kernels`); (b)
    configs 3, 4 fused and 5 fused at the JAX package's own small widths
    (`_JAX_TINY`: a 16x16 grid at F = 16), bf16 and f32, card with kernels
    against CPU with plain versions (`check_model`), every K5 and K6 launch
    on the general route; (c) the f32 probe: `fit` at K = 10 (20 steps, an
    eval pass raw and under the EMA) and with fused=true at K = 1 (4 steps,
    K6 launched), `run_benchmark` at K = 1 and 10, sampling (prior and
    reconstruct) card against CPU, each run's launches held to its
    equations, K5's (and K6's) all on the general route; (d) the phase's
    seconds.  Returns ({general wrapper: rows}, {shape: wgmma no-residual
    row}, {path: launch counts})."""
    import torch

    from mmvae_torch import ops
    from mmvae_torch.bench.throughput import run_benchmark
    from mmvae_torch.configs import get_config

    t0 = time.perf_counter()
    rows, nores = check_general_kernels(dev)
    t1 = time.perf_counter()
    for name, frames, more in (("seq_vae", 4, ()), ("pred_vae", 8, _FUSED),
                               ("hier_vae", 20, _FUSED)):
        overrides = (*_tiny_overrides(name), *more)
        for act in ("bfloat16", "float32"):
            cfg = get_config(name, (f"model.dtype={act}", *overrides))
            _require(_routes(cfg)[0] == "general", f"{name} {overrides}: K5 not general")
            ops.reset_launch_counts()
            check_model(dev, name, frames, overrides, act=act)
            counts = _counts(general=True)
            k6 = bool(more)
            _require(all(counts[n] > 0 for n in (*_K5, *(_K6 if k6 else ()))),
                     f"model {name} {act} at the JAX package's widths: {counts}")
            print(f"[general] model {name} {act} at {_JAX_TINY[name]}: K5{' and K6' if k6 else ''}"
                  f" on the general route ({counts['convlstm_proj_forward']} K5 forwards)")
    t2 = time.perf_counter()
    out = {}
    cadence = ("train.eval_batches=2",) + _CUT
    for tag, overrides, steps, k in (
            ("fit probe f32 K=10", _PROBE_F32, _GENERAL_FIT_STEPS, 10),
            ("fit probe f32 fused", _PROBE_F32_FUSED, _GENERAL_FUSED_STEPS, 1)):
        cfg = _probe_f32_cfg(overrides, *cadence, f"train.eval_every={steps}",
                             f"train.log_every={steps // 2}", f"train.steps_per_call={k}")
        fused = overrides == _PROBE_F32_FUSED
        _require(_routes(cfg) == ("general", "general"), f"{tag}: routes {_routes(cfg)}")
        want = _step_counts(steps, 2 * 2, k6=_dec_k6(cfg))
        _, history, counts = _fit(card, tag, cfg, steps, want, dev, general=True)
        _require(all(math.isfinite(history[-1].get(c, math.nan))
                     for c in ("val_loss", "val_loss_ema")), f"{tag}: {history[-1]}")
        print(f"[general] {tag}: loss {history[0]['loss']:.2f} at step {history[0]['step']} -> "
              f"{history[-1]['loss']:.2f} at {history[-1]['step']}, val_loss "
              f"{history[-1]['val_loss']:.2f}, val_loss_ema {history[-1]['val_loss_ema']:.2f}")
        out[tag] = counts
    t3 = time.perf_counter()
    for k in (1, 10):
        cfg = _chunk_cfg("seq_vae", _PROBE_F32, k)
        tag = f"bench probe f32 K={k}"
        ops.reset_launch_counts()
        res = run_benchmark(cfg, steps=20, warmup=10, device_profile=True)
        out[tag] = c = _counts(general=True)
        losses = res.pop("losses")
        _require(all(math.isfinite(v) for v in losses), f"{tag}: a non-finite loss")
        _require(c["convlstm_proj_forward"] > 0 and c["convlstm_proj_backward"] > 0
                 and (c["convlstm_scan_forward"] > 0) == _dec_k6(cfg), f"{tag}: launches {c}")
        row = {"path": _tag("seq_vae", _PROBE_F32), "steps_per_call": k,
               **{key: res[key] for key in (
                   "value", "value_min", "value_max", "step_ms", "device_busy_ms",
                   "idle_share", "kernels_per_step", "host_launches_per_step",
                   "flops_per_step", "tflops_per_sec_chip", "mfu", "card")}}
        print(f"[general] timing {json.dumps(row)}")
        torch.cuda.empty_cache()
    t4 = time.perf_counter()
    out.update(check_sampling(card, dev, "seq_vae", _PROBE_F32, ("prior", "reconstruct"),
                              general=True))
    t5 = time.perf_counter()
    print(f"[general] seconds: kernels {t1 - t0:.1f}, models {t2 - t1:.1f}, fit {t3 - t2:.1f}, "
          f"bench {t4 - t3:.1f}, sampling {t5 - t4:.1f}, phase {t5 - t0:.1f}; on {card}")
    return rows, nores, out


def _own_path(kernel: str):
    """The first slice whose path launches `kernel`: config 3 (the main
    path) for K1, K3, K5, the head and, where its decoder runs it, K6; None
    for the standalone K2, which no train step launches."""
    return next((_tag(name, overrides) for name, overrides, launched, idle in _SLICES
                 if kernel in _slice_kernels(name, overrides, launched, idle)[0]), None)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 1
    import tempfile

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = phase_card()
    phase_build()
    checks = phase_kernels(dev)
    phase_models(dev)
    by_path = phase_slice(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        by_path.update(phase_fit(card, dev, workdir))
        t1 = time.perf_counter()
        sampled, sampling_rows = phase_sample(card, dev, workdir)
        by_path.update(sampled)
        print(f"[sample] the sampling phase took {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        by_path.update(phase_dp(card, dev, workdir))
        print(f"[dp] the data-parallel phase took {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        chunked, timed_rows = phase_chunk(card, dev, workdir)
        by_path.update(chunked)
        print(f"[chunk] the steps_per_call phase took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    by_path.update(phase_regions(card, dev, timed_rows))
    print(f"[regions] the regions phase took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    by_path.update(phase_quality(card))
    print(f"[quality] the quality phase took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wide_") as workdir:
        wide_rows, wide_paths = phase_wide(card, dev, workdir)
    by_path.update(wide_paths)
    print(f"[wide] the wide phase took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f32_") as workdir:
        f32_rows, f32_paths = phase_f32(card, dev, workdir)
    by_path.update(f32_paths)
    print(f"[f32] the f32 phase took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    general_rows, nores_rows, general_paths = phase_general(card, dev)
    by_path.update(general_paths)
    print(f"[general] the general phase took {time.perf_counter() - t1:.1f} s")
    _require("jax" not in sys.modules and "mmvae_tpu" not in sys.modules,
             "jax or mmvae_tpu was imported")
    kernels = []
    for name, (route, source, replaces) in _KERNELS.items():
        own = _own_path(name)
        row = {"name": name, "route": route, "source": source, "replaces": replaces,
               "launches": by_path[own][name] if own else 0, "launches_path": own,
               "launches_by_path": {tag: c[name] for tag, c in by_path.items()
                                    if tag not in general_paths},
               **checks[name]}
        if name in sampling_rows:
            row["sampling"] = sampling_rows[name]
        if name in wide_rows:
            row["wide"] = wide_rows[name]
        if name in f32_rows:
            row["f32"] = f32_rows[name]
        if name in ("convlstm_proj_forward", "convlstm_scan_forward"):
            row["nores"] = {k: r for k, r in nores_rows.items()
                            if r["kernel"].startswith(f"{name}_")}
        kernels.append(row)
    # The general kernels, each on its main path: the f32 probe (K5 from its
    # fit at K = 10, K6 from its fused fit), timed at the probe's shapes.
    for name, (wrapper, source, replaces) in _GENERAL.items():
        own = "fit probe f32 fused" if wrapper in _K6 else "fit probe f32 K=10"
        probe = next(r for r in general_rows[name].values() if r["shape"][:6] in (
            [64, 20, 8, 8, 128, 192], [64, 20, 8, 8, 192, True]))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": general_paths[own][wrapper], "launches_path": own,
            "launches_by_path": {tag: c[wrapper] for tag, c in general_paths.items()},
            **{k: probe[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
            "shapes": general_rows[name]})
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
