"""CLI: `python -m mmvae_torch train|eval|sample|bench` (port of mmvae_tpu/cli.py).

Examples:
    python -m mmvae_torch train --config seq_vae --set train.steps=2000 --set optim.lr=3e-4
    python -m mmvae_torch eval --config seq_vae --ckpt /tmp/ck
    python -m mmvae_torch sample --config conv_vae --ckpt /tmp/ck --out samples.png
    python -m mmvae_torch bench --config seq_vae --steps 200

Every command runs on the card unless `--device cpu` names the CPU; without
a card the default raises and says so.  The flags, defaults, JSON lines and
exit codes are the JAX CLI's; `--device` is the port's one addition.

Data-parallel, one process a card, on one node or several:
    torchrun --nproc_per_node 8 -m mmvae_torch train --config hier_vae
    torchrun --nproc_per_node 8 -m mmvae_torch bench --config seq_vae
`--device cuda` is then each rank's card (`cuda:LOCAL_RANK`); rank 0 alone
prints the metrics and JSON lines and writes the checkpoints and files.
`eval` and `sample` run whole on every rank.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_common(p):
    p.add_argument("--config", required=True, help="named config (BASELINE configs)")
    p.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="dotted config override, e.g. --set optim.lr=1e-4",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default: cuda; cpu runs the kernels' plain versions)",
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m mmvae_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train", help="train a model config")
    _add_common(p_train)
    p_train.add_argument("--steps", type=int, default=None, help="override step count")

    p_sample = sub.add_parser("sample", help="generate frames from a checkpoint")
    _add_common(p_sample)
    p_sample.add_argument("--ckpt", required=True, help="checkpoint directory")
    p_sample.add_argument("--out", default="samples.png")
    p_sample.add_argument("--mode", choices=["prior", "reconstruct", "rollout"], default="prior")
    p_sample.add_argument("--batch", type=int, default=8)
    p_sample.add_argument("--seed", type=int, default=0)
    p_sample.add_argument(
        "--ema", action="store_true",
        help="use the checkpoint's EMA params (optim.ema_decay runs); on a "
        "pre-EMA checkpoint this equals the raw params",
    )
    p_sample.add_argument(
        "--allow-init", action="store_true",
        help="sample from INIT params when --ckpt holds no checkpoint "
        "(default: a missing/typo'd checkpoint is an error, exit 2)",
    )

    p_eval = sub.add_parser(
        "eval", help="held-out-split ELBO from a checkpoint (one JSON line)"
    )
    _add_common(p_eval)
    p_eval.add_argument("--ckpt", required=True, help="checkpoint directory")
    p_eval.add_argument(
        "--batches", type=int, default=None,
        help="max val batches (default: the whole split once)",
    )
    p_eval.add_argument("--seed", type=int, default=1)
    p_eval.add_argument(
        "--ema", action="store_true",
        help="score the checkpoint's EMA params instead of the live ones",
    )

    p_bench = sub.add_parser("bench", help="measure training frames/sec")
    _add_common(p_bench)
    p_bench.add_argument("--steps", type=int, default=200)
    p_bench.add_argument("--warmup", type=int, default=20)
    p_bench.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler trace of 20 steps to DIR (Chrome / Perfetto JSON)",
    )

    args = parser.parse_args(argv)

    from mmvae_torch import parallel
    from mmvae_torch.configs import get_config

    cfg = get_config(args.config, tuple(args.set))
    try:
        return _run(cfg, args)
    finally:
        if parallel.launched_by_torchrun():
            parallel.shutdown()  # the group `train` or `bench` joined


def _lead() -> bool:
    """Rank 0 under torchrun, or a process started alone."""
    from mmvae_torch import parallel

    return parallel.rank() == 0


def _run(cfg, args) -> int:
    """The subcommand's work; its exit code."""
    if args.cmd == "train":
        from mmvae_torch.train.loop import fit

        if args.steps is not None:
            cfg.train.steps = args.steps
        fit(cfg, device=args.device)
        return 0

    if args.cmd == "sample":
        return _sample(cfg, args)

    if args.cmd == "eval":
        from mmvae_torch.train.loop import evaluate

        try:
            result = evaluate(
                cfg, args.ckpt, max_batches=args.batches, seed=args.seed,
                use_ema=args.ema, device=args.device,
            )
        except FileNotFoundError as e:
            # A typo'd --ckpt must fail loudly, not score init params and
            # exit 0 with a plausible JSON line (scripted use would trust it).
            print(f"error: {e}", file=sys.stderr)
            return 2
        if _lead():
            print(json.dumps(result))
        return 0

    if args.cmd == "bench":
        from mmvae_torch.bench.throughput import run_benchmark

        result = run_benchmark(
            cfg, steps=args.steps, warmup=args.warmup, device=args.device,
            profile_dir=args.profile,
        )
        result.pop("losses")
        if _lead():
            print(json.dumps(result))
        return 0

    return 1


def sample_frames(cfg, args):
    """The frames `sample` writes, as f32 numpy in [0, 1]; None (with the
    error on stderr) when --ckpt holds no checkpoint and --allow-init is not
    given.  The caller's cfg is left as it was."""
    import dataclasses

    import numpy as np
    import torch

    from mmvae_torch.data.loader import load_or_generate
    from mmvae_torch.ops.dispatch import preprocess_gather
    from mmvae_torch.sample import generate as gen
    from mmvae_torch.train import checkpoint as ckpt
    from mmvae_torch.train.loop import _device, build_model
    from mmvae_torch.train.state import create_train_state

    if ckpt.latest_step(args.ckpt) is None and not args.allow_init:
        # A typo'd --ckpt must fail loudly, not emit a plausible-looking
        # sample grid from init params with exit 0 (scripted use would trust
        # the file).  --allow-init opts back in.
        print(
            f"error: no checkpoint found in {args.ckpt!r} "
            "(pass --allow-init to sample from init params deliberately)",
            file=sys.stderr,
        )
        return None
    dev = _device(args.device)
    model = build_model(cfg, dev)
    optim_cfg = cfg.optim
    if args.ema and not optim_cfg.ema_decay:
        # The restore template must keep an EMA to take the checkpoint's; a
        # local copy, NOT a cfg mutation: a later fit(cfg) in-process must
        # not inherit EMA.
        optim_cfg = dataclasses.replace(optim_cfg, ema_decay=0.999)
    state, step, _ = ckpt.restore_latest(args.ckpt, create_train_state(model, optim_cfg))
    if step == 0:
        print(f"warning: no checkpoint found in {args.ckpt}; using init params",
              file=sys.stderr)
    if args.ema and state.ema_params is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(state.ema_params[name])

    if args.mode == "prior":
        return gen.prior_sample(
            model, args.seed, args.batch,
            seq_len=None if cfg.data.per_frame else cfg.data.seq_len,
        )
    ds = load_or_generate(
        cfg.data.path,
        num_sequences=max(args.batch, 4),
        seq_len=cfg.data.seq_len,
        seed=cfg.data.seed + 1,
        train_fraction=0.0,
        train=False,
    )
    u8 = ds.data[: args.batch]
    if cfg.data.per_frame:
        u8 = u8[:, 0]
    # u8 / 255 on the card by the preprocess kernel (`normalize` exactly)
    u8 = torch.from_numpy(np.ascontiguousarray(u8)).to(dev)
    clips = preprocess_gather(u8, torch.arange(u8.shape[0], device=dev), args.seed,
                              binarize=False, out_dtype=torch.float32)
    if args.mode == "reconstruct":
        return gen.reconstruct(model, clips, args.seed)
    ctx_len = getattr(model, "context_len", cfg.data.seq_len // 2)
    return gen.rollout(model, clips[:, :ctx_len], cfg.data.seq_len - ctx_len, args.seed)


def _sample(cfg, args) -> int:
    from mmvae_torch.sample import generate as gen

    frames = sample_frames(cfg, args)
    if frames is None:
        return 2
    if not _lead():
        return 0
    if frames.ndim == 4 and args.out.endswith(".gif"):
        gen.save_gif(frames, args.out)
    else:
        gen.save_grid(frames, args.out)
    print(f"wrote {args.out} ({frames.shape})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
