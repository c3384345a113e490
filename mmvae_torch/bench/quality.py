"""Trained quality: the JAX reference's convergence protocols through `fit`.

    python -m mmvae_torch.bench.quality --protocol NAME [--seed S] [--steps N]
                                        [--out DIR] [--ckpt DIR] [--device cuda|cpu]
                                        [--set KEY=VALUE ...] [--init NPZ]
                                        [--route kernels|plain] [--runs DIR ...]

The port's counterpart of the protocols in `docs/RESULTS.md` ("Quality /
ELBO parity", with their curves in `docs/assets/`) and of
`scripts/plot_loss.py`'s reading of a metrics CSV, without matplotlib.  A
protocol (`PROTOCOLS`) is a named config with its overrides, a step count,
the log cadence of the reference CSV (so a mean over a window averages the
same rows on both sides), `train.eval_every=1000` and
`train.eval_batches=4` (the reference's defaults) and
`train.steps_per_call=10` (a replay equals eager steps bit for bit, so K
changes no number).  Its held numbers are the reference's, each with the
line of `docs/RESULTS.md` that states it and a band; its printed numbers
are shown beside the reference's and held to nothing.

`run` trains the protocol with `train.loop.fit` (`train.seed` = `--seed`;
the data seed stays the reference's, so the splits are its own), its
metrics CSV under `--out` and its checkpoints under `--ckpt`, then `compare` holds the port's
CSV against the numbers and prints both curves every 2,000 steps as text.
On the card a fixed-data protocol's split is resident (`fit`'s default for
a split that fits), as the reference's was.  `--init` starts from given
parameters in place of the seeded init: a .npz of the port's state_dict
(`tests/_jax_init.py` writes the JAX package's init so).
Where the protocol names a fidelity mode, the trained parameters (the EMA
where the run keeps one) are scored by `mmvae_torch.sample` on 256 val
clips: the reconstruction, or the 10-frame rollout from a 10-frame
context, BCE per pixel beside the base-rate predictor's (a constant
mean-pixel frame), and a reconstruction grid and a prior or rollout GIF are
written under `--out`.  Prints one JSON line with every number, fit's own
frames/s over the run and the card's name and power limit; exits 1 when a
held number misses its band.  The device defaults to the card and raises
without one, as `fit` does; `--device cpu` runs the plain versions (the
tests, at tiny widths through `--set`).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import math
import os
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

REFERENCE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "assets")

STEPS_PER_CALL = 10
EVAL_EVERY = 1000
EVAL_BATCHES = 4
CURVE_EVERY = 2000
FIDELITY_CLIPS = 256


@dataclasses.dataclass(frozen=True)
class Number:
    """A statistic of a metrics CSV: the mean of `column` over the rows
    with `lo < step <= hi` (one row where `lo = hi - 1`), the reference's
    value `ref` as `cite` states it, held within `band` (relative), or
    printed only where `band` is None."""

    label: str
    column: str
    lo: int
    hi: int
    ref: float
    cite: str
    band: Optional[float] = None


def at(column: str, step: int, ref: float, cite: str, band: Optional[float] = None) -> Number:
    """`column` at `step`."""
    return Number(f"{column} at {step}", column, step - 1, step, ref, cite, band)


def mean(column: str, lo: int, hi: int, ref: float, cite: str,
         band: Optional[float] = None) -> Number:
    """The mean of `column` over the steps (lo, hi]."""
    return Number(f"{column} mean over ({lo}, {hi}]", column, lo, hi, ref, cite, band)


@dataclasses.dataclass(frozen=True)
class Protocol:
    config: str
    overrides: Tuple[str, ...]
    steps: int
    log_every: int
    reference_csv: Optional[str]
    held: Tuple[Number, ...]
    printed: Tuple[Number, ...] = ()
    fidelity: Optional[str] = None      # "reconstruct" | "rollout" | None
    # the full val split scored once, EMA where kept, after the run
    full_eval: Optional[Number] = None


_RECIPE = ("model.kwargs.dec_upsample=fast_mid", "data.on_device_generate=true",
           "optim.ema_decay=0.999")
_ONGEN = ("data.on_device_generate=true",)
_FUSED = ("model.kwargs.fused=true",)

PROTOCOLS: Dict[str, Protocol] = {
    # config 3 at its defaults on the fixed 10,000-clip procedural set
    "seq_vae_default": Protocol(
        "seq_vae", (), 20_000, 200, "seq_vae_r5_default_loss.csv",
        held=(mean("loss", 19_000, 20_000, 3317.9, "docs/RESULTS.md:945", 0.03),
              at("val_loss", 20_000, 4812.3, "docs/RESULTS.md:945", 0.03)),
        printed=(at("val_loss", 2_000, 5990.1, "seq_vae_r5_default_loss.csv"),
                 at("loss", 2_000, 5724.5, "docs/RESULTS.md:945")),
        fidelity="reconstruct"),
    # the recommended quality recipe (README.md), clips generated every
    # step; `--steps 60000` runs it on to the reference's 60k numbers and its
    # full-split EMA eval (a constant rate: no step depends on the run's length)
    "recipe": Protocol(
        "seq_vae", _RECIPE, 20_000, 50, "seq_vae_r9_ongen_ema60k_loss.csv",
        held=(at("val_loss_ema", 20_000, 3039.5, "docs/RESULTS.md:489,894", 0.03),
              at("val_loss_ema", 60_000, 2920.5, "docs/RESULTS.md:491,895", 0.03)),
        printed=(at("val_loss", 20_000, 3269.9, "docs/RESULTS.md:489"),
                 mean("loss", 19_000, 20_000, 3260.1, "seq_vae_r9_ongen_ema60k_loss.csv"),
                 at("val_loss", 60_000, 3006.2, "docs/RESULTS.md:491")),
        fidelity="reconstruct",
        full_eval=Number("full-split val_loss, EMA", "val_loss", 59_999, 60_000, 2929.6,
                         "docs/RESULTS.md:494-497", 0.03)),
    # config 4 on clips generated every step, its decoder through K6
    "pred_vae_ongen": Protocol(
        "pred_vae", _ONGEN + _FUSED, 20_000, 50, "pred_vae_r9_ongen_loss.csv",
        held=(at("val_loss", 20_000, 1828.2, "docs/RESULTS.md:477", 0.03),),
        printed=(mean("loss", 19_000, 20_000, 1876.3, "docs/RESULTS.md:477"),),
        fidelity="rollout"),
    # config 5 on clips generated every step with an EMA, through K6; the
    # wider band: a 200-clip val split, and the reference's raw series moved
    # ~2 % between two of its runs (docs/RESULTS.md:503-506)
    "hier_vae_ongen_ema": Protocol(
        "hier_vae", _ONGEN + ("optim.ema_decay=0.999",) + _FUSED, 10_000, 50,
        "hier_vae_r9_ongen_ema_loss.csv",
        held=(at("val_loss_ema", 10_000, 17801.3, "docs/RESULTS.md:502", 0.05),),
        printed=(at("val_loss", 10_000, 18334.4, "docs/RESULTS.md:502"),)),
    "mlp_vae": Protocol(
        "mlp_vae", (), 20_000, 50, None,
        held=(at("val_loss", 20_000, 249.11, "docs/RESULTS.md:516", 0.03),)),
    "conv_vae": Protocol(
        "conv_vae", (), 20_000, 50, None,
        held=(at("val_loss", 20_000, 166.78, "docs/RESULTS.md:517", 0.03),)),
}


def protocol_overrides(name: str) -> Tuple[str, ...]:
    """The `--set` overrides of protocol `name` over its config."""
    p = PROTOCOLS[name]
    return (*p.overrides, f"train.steps={p.steps}", f"train.log_every={p.log_every}",
            f"train.eval_every={EVAL_EVERY}", f"train.eval_batches={EVAL_BATCHES}",
            f"train.steps_per_call={STEPS_PER_CALL}")


def protocol_config(name: str, extra: Sequence[str] = ()):
    """Protocol `name`'s config, `extra` overrides applied last."""
    from mmvae_torch.configs import get_config

    return get_config(PROTOCOLS[name].config, (*protocol_overrides(name), *extra))


def read_rows(path: str) -> List[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def statistic(rows: List[dict], number: Number) -> Optional[float]:
    """`number`'s mean over its rows of a metrics CSV; None where no row of
    the window has the column."""
    vals = [float(r[number.column]) for r in rows
            if number.lo < int(r["step"]) <= number.hi and r.get(number.column)]
    return sum(vals) / len(vals) if vals else None


def held_row(number: Number, port: Optional[float]) -> dict:
    """The port's value beside the reference's: the relative gap, and for a
    held number its band and whether the gap lies inside it."""
    row = {"label": number.label, "port": port, "reference": number.ref,
           "cite": number.cite}
    if port is not None:
        row["gap"] = port / number.ref - 1.0
    if number.band is not None:
        row["band"] = number.band
        row["pass"] = port is not None and math.isfinite(port) and \
            abs(row["gap"]) <= number.band
    return row


def curve(port_rows: List[dict], ref_rows: List[dict], every: int = CURVE_EVERY) -> List[dict]:
    """Train `loss` and the val columns the reference logged, port beside
    reference, every `every` steps."""
    cols = ["loss"] + [c for c in ("val_loss", "val_loss_ema")
                       if any(r.get(c) for r in ref_rows)]
    by_step = {int(r["step"]): r for r in port_rows}
    ref_by_step = {int(r["step"]): r for r in ref_rows}
    out = []
    for step in sorted(s for s in by_step if s % every == 0):
        row = {"step": step}
        for c in cols:
            mine, theirs = by_step[step].get(c), ref_by_step.get(step, {}).get(c)
            row[c] = float(mine) if mine else None
            row[f"ref_{c}"] = float(theirs) if theirs else None
        out.append(row)
    return out


def compare_runs(port_csvs: Sequence[str], numbers: Sequence[Number], print_fn=print) -> dict:
    """One run or several (seeds, routes) of a protocol against the
    reference: each number's statistic in every run and their mean, the
    mean held to the band (`held_row`, with the runs' values): {"numbers":
    a row a Number, "ok": every held number reached in every run and its
    mean inside the band}.  Prints the numbers."""
    runs = [read_rows(p) for p in port_csvs]
    out_numbers = []
    for n in numbers:
        vals = [statistic(rows, n) for rows in runs]
        row = held_row(n, None if None in vals else sum(vals) / len(vals))
        row["runs"] = vals
        out_numbers.append(row)
        held = (f"band +-{100 * row['band']:.0f} %: {'pass' if row['pass'] else 'MISS'}"
                if "band" in row else "printed")
        gap = f"{100 * row['gap']:+.2f} %" if "gap" in row else "not reached"
        of = "" if len(runs) == 1 else f", mean of [{', '.join(map(_fmt, vals))}]"
        print_fn(f"[quality] {n.label}{of}: port {_fmt(row['port'])}, reference {n.ref} "
                 f"({n.cite}), {gap}; {held}")
    return {"numbers": out_numbers, "ok": all(r.get("pass", True) for r in out_numbers)}


def compare(port_csv: str, ref_csv: Optional[str], numbers: Sequence[Number],
            print_fn=print) -> dict:
    """The port's metrics CSV against the reference: `compare_runs` of the
    one run, and "curve": `curve`'s rows (none without a reference CSV),
    printed as text."""
    out = compare_runs([port_csv], numbers, print_fn=print_fn)
    out["curve"] = curve(read_rows(port_csv), read_rows(ref_csv)) if ref_csv else []
    for r in out["curve"]:
        print_fn("[quality] curve step {:>6d}: ".format(r["step"]) + "; ".join(
            f"{c} {_fmt(r[c])} (reference {_fmt(r['ref_' + c])})"
            for c in r if c != "step" and not c.startswith("ref_")))
    return out


def _fmt(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.1f}"


def _bce_per_pixel(probs: np.ndarray, target: np.ndarray) -> float:
    eps = 1e-6
    p = np.clip(probs, eps, 1 - eps)
    return float(np.mean(-(target * np.log(p) + (1 - target) * np.log(1 - p))))


def fidelity(cfg, model, mode: str, out_dir: Optional[str], seed: int = 0) -> dict:
    """`model` scored on the first `FIDELITY_CLIPS` clips of the val split,
    threshold-binarized: the reconstruction (mode "reconstruct") or the
    rollout of the second half of each clip from the first ("rollout") BCE
    per pixel, beside the base-rate predictor's (the clips' mean pixel).
    Writes a reconstruction grid and a prior GIF, or a rollout GIF, under
    `out_dir` where PIL imports."""
    from mmvae_torch.data import transforms
    from mmvae_torch.data.loader import load_sprite_bank
    from mmvae_torch.sample import generate as gen
    from mmvae_torch.train.loop import _load_split

    sprites = load_sprite_bank(cfg.data.sprite_bank) if cfg.data.sprite_bank else None
    val = _load_split(cfg, sprites, train=False)
    u8 = np.ascontiguousarray(val.split_data[:FIDELITY_CLIPS])
    clips = (transforms.normalize(torch.from_numpy(u8)).numpy() > 0.5).astype(np.float32)
    if mode == "reconstruct":
        target = clips
        probs = gen.reconstruct(model, clips, seed=seed)
        pictures = {"reconstruction.png": lambda path: gen.save_grid(
            np.stack([clips[:4], probs[:4]], 1).reshape(-1, *clips.shape[2:]), path,
            ncols=clips.shape[1]),
                    "prior.gif": lambda path: gen.save_gif(
            gen.prior_sample(model, seed, 8, seq_len=clips.shape[1]), path)}
    elif mode == "rollout":
        ctx_len = model.context_len
        target = clips[:, ctx_len:]
        probs = gen.rollout(model, clips[:, :ctx_len], clips.shape[1] - ctx_len, seed=seed)
        pictures = {"rollout.gif": lambda path: gen.save_gif(
            np.concatenate([clips[:8, :ctx_len], probs[:8]], 1), path)}
    else:
        raise ValueError(f"fidelity mode {mode!r}: 'reconstruct' or 'rollout'")
    bce = _bce_per_pixel(probs, target)
    base = _bce_per_pixel(np.full_like(target, target.mean()), target)
    out = {"mode": mode, "clips": int(clips.shape[0]), "bce_per_pixel": bce,
           "base_rate_bce_per_pixel": base, "under_base_rate": bce < base}
    if out_dir:
        try:
            import PIL  # noqa: F401
        except ImportError:
            out["pictures"] = "not written: PIL does not import"
        else:
            for fname, write in pictures.items():
                write(os.path.join(out_dir, fname))
            out["pictures"] = sorted(pictures)
    return out


def load_init(path: str) -> Dict[str, torch.Tensor]:
    """The parameters of a .npz, one array a state_dict name."""
    with np.load(path) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def run(name: str, *, seed: int = 0, steps: Optional[int] = None,
        out: Optional[str] = None, ckpt_dir: Optional[str] = None, device="cuda",
        overrides: Sequence[str] = (), route: str = "kernels", init: Optional[str] = None,
        print_fn=print) -> dict:
    """Train protocol `name` (`train.seed` = `seed`; `steps` cuts the run,
    default the protocol's) on `device` and compare it with the reference:
    the result `main` prints.  The metrics CSV, pictures and result.json go
    to `out`, the checkpoints to `ckpt_dir` (default `out`/ckpt).
    `overrides` apply after the protocol's (the tests shrink the model with
    them).  `route="plain"` trains with every kernel wrapper's CUDA branch
    swapped for its plain version (`ops.kernel_checks.plain_route`), at
    K = 1: the witness for a result of the kernels' route.  `init` names a
    .npz of parameters by state_dict name to start from (`load_init`)."""
    import contextlib

    from mmvae_torch.bench.throughput import card
    from mmvae_torch.ops.kernel_checks import plain_route
    from mmvae_torch.train.loop import evaluate, fit, frames_per_step

    if route not in ("kernels", "plain"):
        raise ValueError(f"route {route!r}: 'kernels' or 'plain'")
    if route == "plain":
        overrides = (*overrides, "train.steps_per_call=1")
    protocol = PROTOCOLS[name]
    out = out or os.path.join("build", "quality", name)
    os.makedirs(out, exist_ok=True)
    csv_path = os.path.join(out, "metrics.csv")
    ckpt_dir = ckpt_dir or os.path.join(out, "ckpt")
    cfg = protocol_config(name, (f"train.seed={seed}", f"train.metrics_csv={csv_path}",
                                 f"train.checkpoint_dir={ckpt_dir}", *overrides))
    steps = steps or protocol.steps
    t0 = time.perf_counter()
    with plain_route() if route == "plain" else contextlib.nullcontext():
        state, history = fit(cfg, max_steps=steps, device=device,
                             init=load_init(init) if init else None)
    if state.step_t.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    windows = [h["frames_per_sec"] for h in history if "frames_per_sec" in h]
    ref_csv = (os.path.join(REFERENCE_DIR, protocol.reference_csv)
               if protocol.reference_csv else None)
    numbers = [n for n in (*protocol.held, *protocol.printed) if n.hi <= steps]
    result = {"protocol": name, "config": protocol.config,
              "overrides": list(protocol_overrides(name)) + list(overrides), "seed": seed,
              "steps": steps, "steps_per_call": cfg.train.steps_per_call, "route": route,
              "init": init or "seeded",
              "device": str(state.step_t.device)}
    result.update(compare(csv_path, ref_csv, numbers, print_fn=print_fn))
    result["losses_finite"] = all(math.isfinite(h[k]) for h in history for k in h
                                  if k in ("loss", "val_loss", "val_loss_ema"))
    result["ok"] = result["ok"] and result["losses_finite"]
    if protocol.full_eval is not None and protocol.full_eval.hi <= steps:
        ev = evaluate(cfg, ckpt_dir, use_ema=bool(cfg.optim.ema_decay), device=device)
        row = held_row(protocol.full_eval, ev["val_loss"])
        row["samples"] = ev["samples"]
        result["full_eval"] = row
        result["ok"] = result["ok"] and row["pass"]
        print_fn(f"[quality] {row['label']} over {ev['samples']} clips: port "
                 f"{row['port']:.1f}, reference {row['reference']} ({row['cite']}), "
                 f"{100 * row['gap']:+.2f} %; {'pass' if row['pass'] else 'MISS'}")
    if protocol.fidelity:
        model = state.model
        if state.ema_params is not None:
            with torch.no_grad():
                for pname, p in model.named_parameters():
                    p.copy_(state.ema_params[pname])
        result["fidelity"] = fid = fidelity(cfg, model, protocol.fidelity, out)
        fid["params"] = "ema" if state.ema_params is not None else "trained"
        print_fn(f"[quality] fidelity ({fid['params']} parameters, {fid['clips']} val clips): "
                 f"{fid['mode']} BCE/px {fid['bce_per_pixel']:.4f}, base rate "
                 f"{fid['base_rate_bce_per_pixel']:.4f}")
    result.update({
        "wall_s": wall,
        "fit_frames_per_sec": steps * frames_per_step(cfg) / wall,
        "fit_frames_per_sec_median_window": statistics.median(windows) if windows else None,
        "card": card() if result["device"].startswith("cuda") else None,
    })
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--protocol", required=True, choices=sorted(PROTOCOLS))
    ap.add_argument("--seed", type=int, default=0, help="train.seed (the data's stays 0)")
    ap.add_argument("--steps", type=int, default=None, help="cut the run (default: the "
                    "protocol's); held numbers past the cut are not reached")
    ap.add_argument("--out", default=None, help="metrics CSV, checkpoints, pictures and "
                    "result.json (default build/quality/NAME)")
    ap.add_argument("--ckpt", default=None, help="checkpoints (default OUT/ckpt)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="overrides applied after the protocol's")
    ap.add_argument("--route", default="kernels", choices=("kernels", "plain"),
                    help="plain: every kernel's plain version on the card, at K = 1")
    ap.add_argument("--init", default=None, metavar="NPZ",
                    help="start from these parameters (a .npz by state_dict name)")
    ap.add_argument("--runs", nargs="+", default=None, metavar="DIR",
                    help="train nothing: hold the mean of these runs' metrics CSVs "
                    "(DIR/metrics.csv, e.g. seeds) against the reference")
    args = ap.parse_args(argv)
    if args.runs:
        protocol = PROTOCOLS[args.protocol]
        csvs = [os.path.join(d, "metrics.csv") for d in args.runs]
        last = min(max(int(r["step"]) for r in read_rows(c)) for c in csvs)
        numbers = [n for n in (*protocol.held, *protocol.printed) if n.hi <= last]
        result = {"protocol": args.protocol, "runs": args.runs,
                  **compare_runs(csvs, numbers)}
        print(json.dumps(result), flush=True)
        return 0 if result["ok"] else 1
    result = run(args.protocol, seed=args.seed, steps=args.steps, out=args.out,
                 ckpt_dir=args.ckpt, device=args.device, overrides=args.set,
                 route=args.route, init=args.init)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
