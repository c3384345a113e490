"""One run of a cell: set-up, the timed window, the traced window, and the
comparison that decides `correct`.

Set-up builds the program's objects through its own entry points
(`configs.get_config`, `train.loop.build_model`,
`train.state.create_train_state`, `train.loop.make_config_step` and
`chunk_steps`; `parallel.join` / `grad_sync` under several ranks), puts the
benchmark's weights into the model (`reference.common.init_params`, made on
the card from the seed) and the resident u8 set on the card
(`draws.resident_set`, from the seed; a rank keeps rows [rank::world]),
and starts the step counter at `draws.start_step(seed)`, so each seed
draws its own rows, Bernoulli bits and eps.

The chunk's first call runs its K steps eagerly and captures them in a
CUDA graph; the step function it runs is wrapped by `Observer`, which keeps
the first gradient as Adam got it (its first moment after one step, over
1 - b1) and the parameters after three steps.  Then the state is put back
to the seed's (weights, Adam's moments and counts, the step counter) and
one graph replay runs the same steps again; its first three losses are
compared too.  The window is graph replays only.

After the window the program's state is freed and the reference
(`benchmark/reference`, plain f32) follows the first three steps from the
seed, with the rows, Bernoulli bits and eps worked out again
(`benchmark.draws`); `check.gaps` compares.
"""

from __future__ import annotations

import gc
import inspect
import math
import os
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from benchmark import counts, draws
from benchmark.reference import common

CHECK_STEPS = 3


def sizes_of(cell) -> dict:
    return cell.config["sizes"]


def program_config(cell):
    """The program's config of the cell: its config, overrides and the
    traffic's steps a call; raises where its sizes are not the file's."""
    from mmvae_torch.configs import get_config
    from mmvae_torch.models import MODEL_REGISTRY

    prog = cell.config["program"]
    cfg = get_config(prog["config"], tuple(prog["overrides"]) + (
        f"train.steps_per_call={cell.traffic['steps_per_call']}",))
    s = sizes_of(cell)
    defaults = {k: p.default for k, p in
                inspect.signature(MODEL_REGISTRY[cfg.model.name]).parameters.items()}
    kwargs = {**defaults, **cfg.model.kwargs}
    have = {"batch_size": cfg.data.batch_size, "seq_len": cfg.data.seq_len,
            "num_sequences": cfg.data.num_sequences, "train_fraction": cfg.data.train_fraction,
            "lr": cfg.optim.lr, "b1": cfg.optim.b1, "b2": cfg.optim.b2, "dtype": cfg.model.dtype}
    for key, want in s.items():
        got = have.get(key, kwargs.get(key))
        if isinstance(got, tuple):
            got = list(got)
        if got != want:
            raise ValueError(f"{cell.name}: the program's {key} is {got!r}, the configuration's "
                             f"file says {want!r}")
    o = cfg.optim
    if (o.grad_clip, o.weight_decay, o.ema_decay, o.beta, o.kl_warmup_steps, o.lr_schedule,
            o.lr_warmup_steps, cfg.data.binarize, cfg.data.per_frame,
            cfg.data.on_device_generate, cfg.data.resident_epochs) != \
            (None, 0.0, 0.0, 1.0, 0, "constant", 0, True, False, False, False):
        raise ValueError(f"{cell.name}: the reference follows Adam at a constant rate on "
                         "binarized resident clips drawn with replacement; the config asks "
                         "for more")
    return cfg


def n_clips(cell) -> int:
    s = sizes_of(cell)
    return max(int(s["num_sequences"] * s["train_fraction"]), s["batch_size"])


class Observer:
    """The program's step function, wrapped: after its first call it keeps
    each parameter's first gradient as Adam got it, after its third the
    parameters; later calls (the capture) only pass through."""

    def __init__(self, step):
        self.step = step
        self.calls = 0
        self.grad: Dict[str, torch.Tensor] = {}
        self.after: Dict[str, torch.Tensor] = {}

    def __call__(self, state, data):
        metrics = self.step(state, data)
        self.calls += 1
        named = list(state.model.named_parameters())
        if self.calls == 1:
            b1 = state.optimizer.param_groups[0]["betas"][0]
            moments = {n: state.optimizer.state.get(p, {}).get("exp_avg") for n, p in named}
            self.grad = {n: torch.zeros(p.shape) if moments[n] is None else
                         moments[n].detach().to("cpu", copy=True) / (1.0 - b1)
                         for n, p in named}
        elif self.calls == CHECK_STEPS:
            self.after = {n: p.detach().to("cpu", copy=True) for n, p in named}
        return metrics


class Program:
    """The program's train step on the card, set up from the seed."""

    def __init__(self, cell, seed: int, dev, sync=None, rank: int = 0, world: int = 1):
        from mmvae_torch.train.loop import build_model, chunk_steps, make_config_step
        from mmvae_torch.train.state import create_train_state

        self.cell, self.seed, self.dev = cell, seed, dev
        self.phases: Dict[str, float] = {}
        t = time.perf_counter()
        self.cfg = program_config(cell)
        self.spec = _reference(cell).spec(sizes_of(cell))
        model = build_model(self.cfg, dev)
        sync_dev(dev)
        self.phases["build_model_s"] = time.perf_counter() - t
        t = time.perf_counter()
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        want = {n: tuple(shape) for n, shape, _ in self.spec}
        if shapes != want:
            raise ValueError(f"{cell.name}: the program's parameters are not the reference's: "
                             f"{sorted(set(shapes.items()) ^ set(want.items()))[:6]}")
        self.state = create_train_state(model, self.cfg.optim)
        self._put_initial()
        sync_dev(dev)
        self.phases["state_and_weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        full = draws.resident_set(n_clips(cell), sizes_of(cell)["seq_len"], seed, dev)
        self.data = full[rank::world].contiguous()
        del full
        sync_dev(dev)
        self.phases["resident_set_s"] = time.perf_counter() - t
        self.step_fn = make_config_step(self.cfg, model, resident=True, sync=sync)
        self.observer = Observer(self.step_fn)
        self.chunk = chunk_steps(self.observer, self.cfg.train.steps_per_call, sync=sync)
        self.k = self.cfg.train.steps_per_call

    @torch.no_grad()
    def _put_initial(self) -> None:
        """The seed's weights, Adam's state at its start, the start step."""
        init = common.init_params(self.spec, self.seed, self.dev)
        for n, p in self.state.model.named_parameters():
            p.copy_(init[n])
        for st in self.state.optimizer.state.values():
            for v in st.values():
                if isinstance(v, torch.Tensor):
                    v.zero_()
        self.state.set_step(draws.start_step(self.seed))

    def first_calls(self) -> dict:
        """The eager first call and, from the seed's state again, one graph
        replay: the losses of their first steps, the first gradient and the
        parameters after three steps."""
        t = time.perf_counter()
        eager = self.chunk(self.state, self.data)["loss"][:CHECK_STEPS].float().cpu()
        self.phases["eager_and_capture_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self._put_initial()
        replay = self.chunk(self.state, self.data)["loss"][:CHECK_STEPS].float().cpu()
        self.phases["reset_and_replay_s"] = time.perf_counter() - t
        return {"losses": [eager.tolist(), replay.tolist()], "grad": self.observer.grad,
                "after": self.observer.after}

    def call_seconds(self, calls: int = 3) -> float:
        sync_dev(self.dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            self.chunk(self.state, self.data)
        sync_dev(self.dev)
        return (time.perf_counter() - t0) / calls

    def window(self, calls: int, t_start: float) -> dict:
        """`calls` calls with an event after each and one synchronize at the
        end; the window's seconds, each call's end (ms from the start), the
        steps, how many of their losses are not finite, and the set-up
        seconds (`t_start` to the first call)."""
        start = torch.cuda.Event(enable_timing=True)
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
        losses = []
        sync_dev(self.dev)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        start.record()
        for i in range(calls):
            losses.append(self.chunk(self.state, self.data)["loss"])
            ends[i].record()
        sync_dev(self.dev)
        window_s = time.perf_counter() - t0
        call_ends = [start.elapsed_time(e) for e in ends]
        loss = torch.cat([v.reshape(-1) for v in losses]).float().cpu()
        return {"window_s": window_s, "call_ends_ms": call_ends, "setup_s": setup_s,
                "steps": calls * self.k, "failed": int((~torch.isfinite(loss)).sum())}

    def traced(self, calls: int, region_steps: int) -> dict:
        """A window of `calls` graph replays under the profiler (the device's
        busy seconds, NCCL's, the top kernels and idle gaps), then
        `region_steps` eager steps of the step function traced with the
        host (the device ms a step by region)."""
        from torch.profiler import ProfilerActivity, profile

        from benchmark import trace as tr

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with tempfile.TemporaryDirectory(prefix="perfbench_") as d:
            with profile(activities=acts) as prof:
                sync_dev(self.dev)
                t0 = time.perf_counter()
                for _ in range(calls):
                    self.chunk(self.state, self.data)
                sync_dev(self.dev)
                window_s = time.perf_counter() - t0
            prof.export_chrome_trace(os.path.join(d, "window.json"))
            del prof
            t = tr.load(os.path.join(d, "window.json"))
            dev_ev = tr.device_events(t)
            out = {"window_s": window_s, "steps": calls * self.k,
                   "busy_s": tr.busy_us(dev_ev) / 1e6,
                   "nccl_s": sum(e.get("dur", 0) for e in dev_ev if "nccl" in e["name"].lower())
                   / 1e6,
                   "device_ops": tr.device_ops(dev_ev), "idle_gaps": tr.idle_gaps(t, dev_ev)}
            del t, dev_ev
            with profile(activities=acts) as prof:
                for _ in range(region_steps):
                    self.step_fn(self.state, self.data)
                sync_dev(self.dev)
            prof.export_chrome_trace(os.path.join(d, "regions.json"))
            del prof
            out["regions"] = tr.regions(tr.load(os.path.join(d, "regions.json")), region_steps,
                                        names=region_names(self.cell))
        return out

    def close(self) -> None:
        for name in ("chunk", "observer", "step_fn", "state", "data"):
            setattr(self, name, None)
        gc.collect()
        torch.cuda.empty_cache()


def program_device(world: int):
    """(the rank's card, the step's GradSync or None) as the program's own
    entry gives them: `train.loop._device`, which also sets the program's
    precision policy, then under several ranks `parallel.join` and
    `grad_sync`."""
    from mmvae_torch.train.loop import _device

    dev = _device("cuda" if world > 1 else torch.device("cuda", 0))
    if world == 1:
        return dev, None
    from mmvae_torch import parallel

    dev = parallel.join(dev)
    return dev, parallel.grad_sync(dev)


def sync_dev(dev) -> None:
    torch.cuda.synchronize(dev)


def _reference(cell):
    import importlib

    return importlib.import_module(f"benchmark.reference.{cell.config['reference']}")


def reference_steps(cell, seed: int, dev, world: int, lowp=None, fault: Optional[str] = None,
                    steps: int = CHECK_STEPS, lowp32=None) -> dict:
    """The reference (or, with `lowp`, the control of the layers the
    configuration keeps in bf16; with `lowp32`, of those it keeps in f32;
    with `fault`, a planted fault) put in the program's place: `steps`
    steps of the global batch over `world` ranks from the seed, in f32 with
    TF32 off, Adam as torch computes it.  Returns what
    `Program.first_calls` returns (the losses once).

    Faults: "half" (each rank's loss over the first half of its batch),
    "eps_zero" (every sample's eps zero: z = mu), "no_exchange" (the
    update takes rank 0's gradient alone)."""
    kept = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _reference_steps(cell, seed, dev, world, lowp, fault, steps, lowp32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = kept


def _reference_steps(cell, seed, dev, world, lowp, fault, steps, lowp32) -> dict:
    ref, s = _reference(cell), sizes_of(cell)
    spec = ref.spec(s)
    P = common.init_params(spec, seed, dev)
    for p in P.values():
        p.requires_grad_(True)
    full = draws.resident_set(n_clips(cell), s["seq_len"], seed, dev)
    b = s["batch_size"] // world
    b1, b2, lr = s["b1"], s["b2"], s["lr"]
    m = {n: torch.zeros_like(p) for n, p in P.items()}
    v = {n: torch.zeros_like(p) for n, p in P.items()}
    losses, grad = [], {}
    for i in range(steps):
        step = draws.start_step(seed) + i
        total = 0.0
        for r in range(world if fault != "no_exchange" else 1):
            rs = draws.rank_seed(step, r)
            n_local = len(range(r, full.shape[0], world))
            rows = r + world * draws.uniform_rows(rs, n_local, b, dev)
            x = draws.binarize(full[rows], draws.stream_seed(rs, draws.STREAM_PREPROCESS))
            eps = {salt: draws.normal(*shape, draws.stream_seed(rs, draws.STREAM_REPARAM, salt),
                                      dev) for salt, shape in ref.eps_shapes(s, b).items()}
            if fault == "eps_zero":
                eps = {k: torch.zeros_like(e) for k, e in eps.items()}
            if fault == "half":
                x = x[: b // 2]
                eps = {k: e[: e.shape[0] // 2] for k, e in eps.items()}
            loss = ref.loss(P, x, eps, s, lowp, lowp32=lowp32)
            share = 1 if fault == "no_exchange" else world
            (loss / share).backward()
            total += float(loss.detach()) / share
        losses.append(total)
        with torch.no_grad():
            if i == 0:
                grad = {n: p.grad.detach().to("cpu", copy=True) for n, p in P.items()}
            t = i + 1
            for n, p in P.items():
                g = p.grad
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(1e-8)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
                p.grad = None
    after = {n: p.detach().to("cpu", copy=True) for n, p in P.items()}
    return {"losses": [losses], "grad": grad, "after": after}


def initial_cpu(cell, seed: int, dev) -> Dict[str, torch.Tensor]:
    spec = _reference(cell).spec(sizes_of(cell))
    return {n: t.to("cpu") for n, t in common.init_params(spec, seed, dev).items()}


def region_names(cell) -> tuple:
    """The names of the regions a traced run attributes device work to: the
    benchmark's `trace.REGIONS` and those the configuration's file lists
    under "regions" (names its program opens beyond them)."""
    from benchmark import trace

    return trace.REGIONS + tuple(cell.config.get("regions", ()))


def per_layer_context(cell, traced: dict, world: int) -> SimpleNamespace:
    """What a per-layer metric reads (`metrics/<name>.py`): the traced run's
    regions (device ms a step, forward and backward), busy, window and NCCL
    seconds and steps, and a rank's work a step from the reference's
    declarations: its model FLOPs, its recurrences' least ms by region
    (`bound_ms`) and in all (`recurrence_bound_ms`)."""
    s, ref = sizes_of(cell), cell.config["reference"]
    b = s["batch_size"] // world
    declared = counts.recurrences(s, ref, b)
    return SimpleNamespace(
        regions=traced["regions"], busy_s=traced["busy_s"], window_s=traced["window_s"],
        steps=traced["steps"], nccl_s=traced["nccl_s"], world=world,
        flops_per_step=counts.flops_per_step(s, ref, b),
        bound_ms=counts.bound_ms_by_region(declared),
        recurrence_bound_ms=counts.recurrence_bound_ms(declared))

