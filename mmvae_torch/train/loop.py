"""Loss, train and eval steps and the training loop (port of
mmvae_tpu/train/loop.py).

One train step: derive the step seed from the step counter on the device
(`TrainState.step_t`), get the batch's u8 clips (rows of the resident set
by index, uniform with replacement or by shuffled epochs, a batch streamed
from the host by `data.feed.DeviceFeed`, or clips generated on the card by
`data.ongen`), binarize them on the card (preprocess kernel), run the model
with kernel-sampled latents, reduce the ELBO (kernel) with the KL weight of
the step, backward, and `TrainState.apply_gradients` (clip, Adam or AdamW
at the step's rate, EMA).  No host sync: metrics come back as device
tensors.  Every per-step value (the seeds the kernels read, the rows, the
generated clips' draws, the KL weight, the rate) is computed on the device
from `step_t`, so `chunk_steps` can capture K steps in one CUDA graph and
replay it: `train.steps_per_call`, the port of the JAX package's
`chunk_steps`.  `fit` drives the steps with eval, EMA eval, metrics,
checkpoints, resume and the SIGTERM save; `evaluate` scores a checkpoint on
the val split.

Data parallelism (`parallel`): one process a card, each rank training on
its share of the batch with its own step seed and rows, the gradients and
metrics averaged by `parallel.GradSync` before the update.  Without a
process group every step is the single-card step.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mmvae_torch.data.feed import DeviceFeed
from mmvae_torch.data.loader import load_or_generate, load_sprite_bank
from mmvae_torch.models import MODEL_REGISTRY, flax_init_
from mmvae_torch import parallel as pmesh
from mmvae_torch import ops
from mmvae_torch.ops import dispatch
from mmvae_torch.ops.seeds import (STREAM_ONGEN, STREAM_ROWS, bits32, shard_seed,
                                   shard_seed_t, step_seed_t, stream_seed, stream_seed_t)
from mmvae_torch.train import checkpoint as ckpt
from mmvae_torch.train.metrics import MetricsLogger
from mmvae_torch.train.state import TrainState, create_train_state
from mmvae_torch.utils.debug import debug_nans, install_sigterm_checkpoint
from mmvae_torch.utils.profiling import (GraphRegions, RegionRecorder, annotate, backward,
                                         record_regions, span)

Metrics = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_loss_fn(model, *, binarize: bool):
    """loss_fn(data_u8, idx, seed, beta=1.0, params=None) -> (loss per
    sample, metrics).

    `data_u8[idx]` are the batch's clips; `params` ({name: tensor}, e.g. the
    EMA) stand in for the model's own parameters where given.
    Loss = (BCE sum + beta * KL sum) / B; the metrics report the unscaled
    ELBO terms per sample."""
    # Binarized {0, 1} frames are exact in bf16: a bf16 model gets bf16 frames.
    frame_dtype = (
        torch.bfloat16 if binarize and model.dtype == torch.bfloat16 else torch.float32
    )

    def loss_fn(data_u8, idx, seed: dispatch.StepSeed, beta=1.0, params=None):
        with annotate("preprocess"):
            x = dispatch.preprocess_gather(
                data_u8, idx, seed, binarize=binarize, out_dtype=frame_dtype
            )
        sample_fn = dispatch.make_sample_fn(seed)
        with annotate("model_fwd"):
            if params is None:
                out = model(x, sample_fn)
            else:
                out = torch.func.functional_call(model, params, (x, sample_fn))
        with annotate("elbo_reduce"):
            bce, kl = dispatch.elbo_parts(out.logits, out.target, out.mu, out.logvar)
        b = out.mu.shape[0]
        kl_total = kl + out.extra_kl
        loss = (bce + beta * kl_total) / b
        metrics = {
            "loss": ((bce + kl_total) / b).detach(),
            "bce": (bce / b).detach(),
            "kl": (kl_total / b).detach(),
        }
        return loss, metrics

    return loss_fn


def kl_beta(step, beta: float, kl_warmup_steps: int):
    """The step's KL weight, beta * min(1, step / kl_warmup_steps), in float32
    arithmetic as the JAX step computes it: a float for an int step or
    without warmup (exact as a Python float), else a 0-d float32 tensor on
    the step tensor's device."""
    if isinstance(step, torch.Tensor) and kl_warmup_steps > 0:
        return beta * torch.clamp(step.to(torch.float32) / kl_warmup_steps, max=1.0)
    b = np.float32(beta)
    if kl_warmup_steps > 0:
        b = b * np.minimum(np.float32(1.0), np.float32(step) / np.float32(kl_warmup_steps))
    return float(b)


def uniform_rows(seed, n_rows: int, batch: int, device) -> torch.Tensor:
    """`batch` row indices uniform on [0, n_rows) with replacement, from the
    ROWS stream of the step seed `seed` (an int, or a 0-d int64 tensor on
    `device`): `bits32` of that stream seed over 0 .. batch - 1, mod
    n_rows.  Not threefry's draws: the rows differ from the JAX step's, the
    distribution does not."""
    key = (stream_seed_t(seed, STREAM_ROWS) if isinstance(seed, torch.Tensor)
           else stream_seed(seed, STREAM_ROWS))
    return bits32(key, torch.arange(batch, device=device)) % n_rows


def resident_row_indices(step, n_rows: int, batch: int, seed_base: int, device,
                         shard_index: int = 0) -> torch.Tensor:
    """Shuffled-epoch batch indices for the resident path: each row exactly
    once per epoch, a fresh permutation every epoch, a pure function of the
    step (an int, or a 0-d int64 tensor on `device`; a restart draws the
    same).  epoch = step // (n_rows // batch); the epoch's permutation
    sorts the rows by `bits32` of a key of (`seed_base`, epoch,
    `shard_index`) over the row numbers (distinct for distinct rows: no
    ties), and the step takes its slice of it, all on the device.
    `shard_index` (a data-parallel rank; 0 draws the single-card rows)
    decorrelates the ranks' permutations of their own rows.  The
    permutation is not threefry's: the rows differ from the JAX step's, the
    semantics do not."""
    steps_per_epoch = n_rows // batch
    if steps_per_epoch < 1:
        raise ValueError(f"resident epoch sampling needs n_rows ({n_rows}) >= batch ({batch})")
    epoch, pos = step // steps_per_epoch, step % steps_per_epoch
    key = ((epoch + (seed_base * 2654435761 & 0xFFFFFFFF)) ^ (shard_index * 0x85EBCA77)) \
        & 0xFFFFFFFF
    perm = torch.argsort(bits32(key, torch.arange(n_rows, device=device)))
    return perm[pos * batch + torch.arange(batch, device=device)]


def make_train_step(
    model,
    *,
    binarize: bool = True,
    resident_batch: Optional[int] = None,
    per_frame: bool = False,
    beta: float = 1.0,
    kl_warmup_steps: int = 0,
    resident_epochs: bool = False,
    resident_seed: int = 0,
    ongen_batch: Optional[int] = None,
    ongen_shape: Optional[Tuple[int, ...]] = None,
    ongen_num_digits: int = 2,
    ongen_sprites=None,
    sync: Optional[pmesh.GradSync] = None,
) -> Callable[[TrainState, Optional[torch.Tensor]], Metrics]:
    """Build step(state, data) -> metrics; updates `state` in place.

    With `resident_batch` set, `data` is the whole u8 dataset on the device
    and each step gathers `resident_batch` rows: uniformly with replacement
    (`uniform_rows`, from the step seed), or under `resident_epochs` by
    `resident_row_indices` (keyed by `resident_seed`).  With `ongen_batch`
    set, each step generates its `ongen_batch` clips of `ongen_shape` (one
    sample's u8 shape) on the model's device (`data.ongen`, from the step
    seed's ONGEN stream) and `data` is ignored.  Otherwise `data` is the
    batch itself.  The KL term is weighted by `kl_beta(step, beta,
    kl_warmup_steps)`.  The step seed and every value above are computed on
    the device from `state.step_t`: no host value changes from step to
    step, so the step can be captured in a CUDA graph (`chunk_steps`).

    With `sync` (a data-parallel rank), the batch sizes are the rank's
    share and `data` its rows; the step seed is the rank's
    (`ops.seeds.shard_seed`), which every draw derives from, the epoch
    permutation takes the rank as its shard index, and the gradients and
    metrics are averaged across the ranks before the update.  Without one
    the rank is 0, whose seed and rows are the single card's."""
    loss_fn = make_loss_fn(model, binarize=binarize)
    rank, _ = pmesh.place(sync)
    gen_fn = None
    if ongen_batch is not None:
        from mmvae_torch.data import ongen

        device = next(model.parameters()).device
        gen_fn = ongen.clip_batch_fn(
            ongen_batch, ongen_shape or ((64, 64) if per_frame else (20, 64, 64)),
            num_digits=ongen_num_digits, per_frame=per_frame, sprites=ongen_sprites,
            device=device,
        )
        ongen_idx = torch.arange(ongen_batch, device=device)  # the whole generated batch

    def step(state: TrainState, data: Optional[torch.Tensor]) -> Metrics:
        with annotate("rows"):
            seed = shard_seed_t(step_seed_t(state.step_t), rank)
            if gen_fn is not None:
                idx = ongen_idx
            elif resident_batch is not None and resident_epochs:
                idx = resident_row_indices(state.step_t, data.shape[0], resident_batch,
                                           resident_seed, data.device, shard_index=rank)
            elif resident_batch is not None:
                idx = uniform_rows(seed, data.shape[0], resident_batch, data.device)
            else:
                idx = torch.arange(data.shape[0], device=data.device)
        if gen_fn is not None:
            with annotate("ongen"):
                data = gen_fn(stream_seed_t(seed, STREAM_ONGEN))
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(data, idx, seed, kl_beta(state.step_t, beta, kl_warmup_steps))
        backward(loss)
        if sync is not None:
            with annotate("grad_sync"):
                metrics = sync(state.model.parameters(), metrics)
        with annotate("optimizer"):
            state.apply_gradients()
        return metrics

    return step


def _bindings(state: TrainState, data: Optional[torch.Tensor]) -> tuple:
    """The addresses a captured step reads and writes: the parameters, the
    optimizer's state and rates, the EMA, the step counter and the data."""
    tensors = [*state.model.parameters(), state.step_t, *(state.ema_params or {}).values()]
    for group in state.optimizer.param_groups:
        tensors += [group["lr"]] if isinstance(group["lr"], torch.Tensor) else []
    for st in state.optimizer.state.values():
        tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return tuple(t.data_ptr() for t in tensors) + (None if data is None else data.data_ptr(),)


class _Captured(NamedTuple):
    """One CUDA graph of K train steps and what a replay hands back."""

    graph: "torch.cuda.CUDAGraph"
    bindings: tuple  # `_bindings` at capture
    stacked: torch.Tensor  # the K steps' metrics (K, keys), rewritten by each replay
    keys: List[str]
    launches: dict  # the kernel launches the graph holds (`ops.launch_delta`)
    recorder: RegionRecorder  # the capture's region boundaries, walked on demand


def chunk_steps(step: Callable[[TrainState, Optional[torch.Tensor]], Metrics], n_steps: int,
                *, sync: Optional[pmesh.GradSync] = None):
    """chunk(state, data) -> metrics stacked (n_steps,): `n_steps`
    consecutive train steps, the port of `mmvae_tpu.train.loop.chunk_steps`
    (one `lax.scan` in one dispatch there) and the same as calling `step`
    n_steps times.

    On a card the chunk is one CUDA graph of the K steps (forward,
    backward, clip, the optimizer, the EMA and under data parallelism the
    all-reduce), replayed once per call: the steps' seeds, rows, draws, KL
    weight and rate all derive from `state.step_t` on the device, which the
    graph advances, so each replay draws its own steps' values.  The first
    call, and any call whose state or data lie at other addresses than the
    graph's (a restored optimizer), runs the K steps eagerly on a side
    stream (real steps: the warmup that Adam's state, the kernels' first
    launch and the libraries' choices need) and then captures them; the
    capture executes nothing, so `state.step` is put back after it, and
    each replay advances it by K.  The kernels' launch counters count at
    capture, not at replay: each replay adds the counts its graph captured.
    A capture or replay that fails raises; nothing falls back to the eager
    loop.  On the CPU the chunk is the K-step loop itself.

    The capture records the step's regions (`utils.profiling.record_regions`)
    and keeps the captured graph: `chunk.regions()` walks it, at its first
    call after a capture, into the region of each of its work nodes
    (`utils.profiling.GraphRegions`), by which `bench.regions.replay_budget`
    reads a traced replay; None before the first capture.  Under a
    profiler a replay is the host span `chunk.replay`.

    Under data parallelism the chunk needs NCCL on a card (gloo's
    collectives cannot be captured), and `sync.stop` reaches the ranks
    through a device buffer the host writes before each replay
    (`parallel.GradSync`)."""
    captured: Optional[_Captured] = None
    walked: Optional[GraphRegions] = None

    def loop(state: TrainState, data: Optional[torch.Tensor]) -> list:
        return [step(state, data) for _ in range(n_steps)]

    def stack(ms: list) -> Metrics:
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def capture(state: TrainState, data: Optional[torch.Tensor]) -> Metrics:
        nonlocal captured, walked
        dev = state.step_t.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = stack(loop(state, data))
        torch.cuda.current_stream(dev).wait_stream(side)
        host_step, counted = state.step, ops.launch_snapshot()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with record_regions() as recorder, torch.cuda.graph(graph, stream=side):
            ms = loop(state, data)
            keys = list(ms[0])
            stacked = torch.stack([torch.stack([m[k].float() for k in keys]) for m in ms])
        graph.instantiate()
        state.step = host_step  # the capture ran nothing
        launches = ops.launch_delta(counted)
        ops.add_launches({key: -n for key, n in launches.items()})
        captured = _Captured(graph, _bindings(state, data), stacked, keys, launches, recorder)
        walked = None
        return warm

    def chunk(state: TrainState, data: Optional[torch.Tensor]) -> Metrics:
        if state.step_t.device.type != "cuda":
            return stack(loop(state, data))
        if captured is None or captured.bindings != _bindings(state, data):
            return capture(state, data)
        with span("chunk.replay"):
            captured.graph.replay()
            state.step += n_steps
            ops.add_launches(captured.launches)
            if sync is not None:
                sync.replayed()
            out = captured.stacked.clone()
            return {k: out[:, j] for j, k in enumerate(captured.keys)}

    if sync is not None and sync.device.type == "cuda" and sync.backend != "nccl":
        raise ValueError(f"train.steps_per_call={n_steps} on a card under data parallelism "
                         f"needs the NCCL backend: {sync.backend}'s collectives cannot be "
                         "captured in a CUDA graph")
    def regions() -> Optional[GraphRegions]:
        """The region map of the graph the chunk replays."""
        nonlocal walked
        if walked is None and captured is not None:
            walked = captured.recorder.walk(captured.graph)
        return walked

    chunk.regions = regions
    return chunk


def local_batch(cfg, world: int) -> int:
    """A rank's share of `data.batch_size` (the global batch)."""
    batch = cfg.data.batch_size // world
    if batch * world != cfg.data.batch_size:
        raise ValueError(f"data.batch_size={cfg.data.batch_size} does not divide over "
                         f"{world} data-parallel ranks")
    return batch


def make_config_step(cfg, model, *, resident: bool, sprites=None,
                     sync: Optional[pmesh.GradSync] = None):
    """The config's train step for `model` (`make_train_step` with the
    config's data path, KL weight and sampling options): clips generated on
    the card under `data.on_device_generate` (from `sprites` where given),
    else rows of a resident set when `resident`, else the batch it is
    handed.  With `sync`, a data-parallel rank's step on its share of the
    batch."""
    ongen = cfg.data.on_device_generate
    batch = local_batch(cfg, pmesh.place(sync)[1])
    return make_train_step(
        model, binarize=cfg.data.binarize, per_frame=cfg.data.per_frame,
        resident_batch=batch if resident and not ongen else None,
        ongen_batch=batch if ongen else None, ongen_shape=_sample_shape(cfg)[1:],
        ongen_num_digits=cfg.data.num_digits, ongen_sprites=sprites,
        beta=cfg.optim.beta, kl_warmup_steps=cfg.optim.kl_warmup_steps,
        resident_epochs=cfg.data.resident_epochs, resident_seed=cfg.data.seed, sync=sync,
    )


def build_model(cfg, device="cuda", generator: Optional[torch.Generator] = None):
    """The config's model on `device` (the card unless the caller names the
    CPU) with flax-style init from `generator` (default: a CPU generator
    seeded with cfg.train.seed, so every device gets the same weights)."""
    cls = MODEL_REGISTRY[cfg.model.name]
    model = cls(**dict(cfg.model.kwargs), dtype=_DTYPES[cfg.model.dtype], device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    return flax_init_(model, generator)


def frames_per_step(cfg) -> int:
    """Frames a train step consumes: the batch of single frames of a
    per-frame config, batch x clip length otherwise."""
    if cfg.data.per_frame:
        return cfg.data.batch_size
    return cfg.data.batch_size * cfg.data.seq_len


def _sample_shape(cfg) -> tuple:
    s = 64
    if cfg.data.per_frame:
        return (cfg.data.batch_size, s, s)
    return (cfg.data.batch_size, cfg.data.seq_len, s, s)


def check_supported(cfg) -> None:
    """Raise for a config option the port does not run."""
    if cfg.train.use_pallas is False:
        raise ValueError("train.use_pallas=false: the port has no plain path on the "
                         "card; its kernels always run there")
    if cfg.train.steps_per_call > 1 and cfg.train.debug_nans:
        raise ValueError(f"train.steps_per_call={cfg.train.steps_per_call} with "
                         "train.debug_nans=true: autograd's anomaly mode cannot run in a "
                         "CUDA graph; set train.steps_per_call=1 to check for NaNs")
    if cfg.train.transfer_guard:
        raise ValueError("train.transfer_guard=true: dropped in the port (ROADMAP, the drop "
                         "list): its step makes no implicit host sync to guard; the only "
                         "host reads are the metrics, one log interval late")


def _device(device) -> torch.device:
    """`device` as a torch.device, a bare "cuda" under torchrun the rank's card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} but CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        # The f32 heads and decoders run in full f32, as the bench runs them.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return pmesh.local_device(dev)


def _load_split(cfg, sprites, train: bool = True, rank: int = 0, world: int = 1):
    """The train or val split; rank `rank` of `world` holds rows
    `split[rank::world]` (the loader's per-process shard)."""
    return load_or_generate(
        cfg.data.path, num_sequences=cfg.data.num_sequences, seq_len=cfg.data.seq_len,
        num_digits=cfg.data.num_digits, seed=cfg.data.seed,
        train_fraction=cfg.data.train_fraction, sprites=sprites, train=train,
        process_index=rank, process_count=world,
    )


def _val_batches(cfg, val_dataset, batch: int, seed: int, full_only: bool = False):
    """The val split once, every row, the short tail batch included unless
    `full_only`."""
    if cfg.data.per_frame:
        return val_dataset.frame_batches(batch, seed=seed, num_epochs=1,
                                         drop_remainder=full_only)
    return val_dataset.batches(batch, seed=seed, num_epochs=1, drop_remainder=full_only)


def _val_rows(cfg, val_dataset) -> int:
    if cfg.data.per_frame:
        return len(val_dataset) * max(val_dataset.data.shape[1], 1)
    return len(val_dataset)


def make_eval_step(model, *, binarize: bool = True, sync: Optional[pmesh.GradSync] = None):
    """eval_step(params, batch_u8, seed) -> metrics (device tensors): the
    loss terms per sample of the whole u8 batch under `torch.no_grad()`, so
    the recurrences take their kernels' forward without residuals.
    `params` ({name: tensor}, e.g. the EMA) stand in for the model's own
    where given; None scores the model's own.  With `sync` (a
    data-parallel rank, the batch its share) the seed is the rank's and the
    metrics the ranks' mean, as the JAX package's sharded eval step."""
    loss_fn = make_loss_fn(model, binarize=binarize)
    rank, _ = pmesh.place(sync)

    @torch.no_grad()
    def eval_step(params, batch_u8: torch.Tensor, seed: int) -> Metrics:
        idx = torch.arange(batch_u8.shape[0], device=batch_u8.device)
        metrics = loss_fn(batch_u8, idx, shard_seed(seed, rank), params=params)[1]
        if sync is None:
            return metrics
        keys = list(metrics)
        return dict(zip(keys, sync.mean(torch.stack([metrics[k] for k in keys])).unbind()))

    return eval_step


def _weighted_mean(parts) -> Dict[str, float]:
    """{key: mean per sample} of [(rows b, metrics per sample)], each batch
    weighted by its rows (a short tail batch counts by its size); one host
    read."""
    keys = list(parts[0][1])
    total = torch.stack([torch.stack([m[k].float() * b for k in keys]) for b, m in parts])
    seen = sum(b for b, _ in parts)
    return {k: v / seen for k, v in zip(keys, total.sum(0).tolist())}


def evaluate(cfg, ckpt_dir: Optional[str] = None, *, params=None,
             max_batches: Optional[int] = None, seed: int = 1, use_ema: bool = False,
             device="cuda") -> dict:
    """Val-split ELBO, BCE and KL (sum per sample) of a checkpoint: the whole
    split once by default, the short tail batch weighted by its size.  Batch
    n is scored with seed `seed + n`, the in-training eval's stream, so at
    step N this reproduces the in-training val metrics when the batch size
    matches.  Raises FileNotFoundError when `ckpt_dir` holds no checkpoint;
    `params` ({name: tensor}) scores those weights instead (step -1).
    `use_ema` scores the checkpoint's EMA (the parameters themselves for a
    checkpoint without one) and leaves `cfg` as it was.  Returns {"step",
    "batches", "samples", "val_loss", "val_bce", "val_kl"}."""
    dev = _device(device)
    model = build_model(cfg, dev)
    if params is None:
        if not ckpt_dir:
            raise ValueError("evaluate() needs ckpt_dir or params")
        if ckpt.latest_step(ckpt_dir) is None:
            raise FileNotFoundError(f"no checkpoint found in {ckpt_dir!r}")
        optim_cfg = cfg.optim
        if use_ema and not optim_cfg.ema_decay:
            # a state that keeps an EMA, to take the checkpoint's; a copy, so
            # a later fit(cfg) does not train with an EMA
            optim_cfg = dataclasses.replace(optim_cfg, ema_decay=0.999)
        state, step, _ = ckpt.restore_latest(ckpt_dir, create_train_state(model, optim_cfg))
        params = state.ema_params if use_ema else None
    else:
        step = -1
        params = {k: v.to(dev) for k, v in params.items()}
    sprites = load_sprite_bank(cfg.data.sprite_bank) if cfg.data.sprite_bank else None
    val_dataset = _load_split(cfg, sprites, train=False)
    avail = _val_rows(cfg, val_dataset)
    vbs = min(cfg.data.batch_size, avail)
    if vbs == 0:
        return {"step": step, "batches": 0, "samples": 0}
    n_batches = -(-avail // vbs)
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    eval_step = make_eval_step(model, binarize=cfg.data.binarize)
    parts = []
    for n, vb in zip(range(n_batches), _val_batches(cfg, val_dataset, vbs, seed)):
        parts.append((vb.shape[0], eval_step(params, torch.from_numpy(vb).to(dev), seed + n)))
    out = {"step": int(step), "batches": len(parts), "samples": sum(b for b, _ in parts)}
    out.update({f"val_{k}": v for k, v in _weighted_mean(parts).items()})
    return out


def steps_per_call(cfg) -> int:
    return max(int(cfg.train.steps_per_call), 1)


def check_chunking(cfg, spc: int, *, streaming: bool, steps: int, start_step: int) -> None:
    """`fit`'s refusals of `train.steps_per_call` > 1, with the JAX
    package's messages (mmvae_tpu/train/loop.py:578-601)."""
    if spc <= 1:
        return
    if streaming:
        raise ValueError(
            "train.steps_per_call > 1 requires the device-resident or "
            "on-device-generate data path (streaming mode needs one host "
            "batch per step)")
    cadences = {
        "train.steps": steps,
        "train.log_every": cfg.train.log_every,
        "train.eval_every": cfg.train.eval_every,
        "train.checkpoint_every": cfg.train.checkpoint_every,
    }
    for name, v in cadences.items():
        if v and v % spc:
            raise ValueError(f"{name} ({v}) must be a multiple of train.steps_per_call ({spc})")
    if start_step % spc:
        raise ValueError(f"resumed step {start_step} is not a multiple of "
                         f"train.steps_per_call ({spc})")


def _check_ongen_val(cfg, dataset, sprite_bank) -> None:
    """On-card generation draws sprites while the val split resolved to the
    canonical file (real digits): with the built-in font that is a train/val
    mismatch, refused when an eval would run."""
    if not (cfg.data.on_device_generate and dataset.source == "canonical"):
        return
    if sprite_bank is None:
        if cfg.train.eval_every:
            raise ValueError(
                "data.on_device_generate=true trains on the built-in font sprites, but the "
                "validation split resolved to the canonical Moving MNIST file "
                f"({cfg.data.path or 'auto-detected'}): real digit crops the font can never "
                "match.  Provide a real digit bank via data.sprite_bank=<path to (K,S,S) "
                ".npy>, disable on_device_generate to train on the canonical data, or point "
                "data.path elsewhere.")
        print("warning: on_device_generate with the built-in font sprites while the "
              "canonical file is present; eval is disabled (train.eval_every=0) so "
              "proceeding, but any later eval against this val split would be a train/val "
              "mismatch.", file=sys.stderr)
    else:
        print("warning: on_device_generate trains on the data.sprite_bank sprites while "
              "validation uses the canonical file; ensure the bank holds real digit crops "
              "from a matching distribution.", file=sys.stderr)


def _data_parallel(cfg, dev) -> Tuple[torch.device, Optional[pmesh.GradSync]]:
    """(the rank's device, its GradSync or None) for `fit`: a process group
    already up, or torchrun's of more than one rank under
    `train.data_parallel` or `train.multihost`, trains data-parallel;
    `train.multihost` without torchrun's environment trains in this process
    and says so, as the JAX package does when its runtime will not start."""
    if cfg.train.data_parallel or cfg.train.multihost:
        if cfg.train.multihost and pmesh.world() == 1 and pmesh.env_world() == 1:
            print("multihost init skipped: no torchrun environment (RANK, WORLD_SIZE, "
                  "LOCAL_RANK, MASTER_ADDR, MASTER_PORT); training in this process",
                  flush=True)
        dev = pmesh.join(dev)
    sync = pmesh.grad_sync(dev)
    ranks = max(pmesh.world(), pmesh.env_world())
    if ranks > 1 and not cfg.train.data_parallel:
        raise ValueError(f"train.data_parallel=false under {ranks} ranks: each would train "
                         "alone and write the same checkpoints; set "
                         "train.data_parallel=true or start one process")
    if (sync is None and dev.type == "cuda" and cfg.train.data_parallel
            and torch.cuda.device_count() > 1):
        n = torch.cuda.device_count()
        raise ValueError(f"train.data_parallel=true on a host with {n} cards in one process: "
                         f"the port trains one process a card; start it with `torchrun "
                         f"--nproc_per_node {n} -m mmvae_torch train ...`, or set "
                         "train.data_parallel=false to train on one card")
    return dev, sync


def fit(cfg, *, max_steps: Optional[int] = None, device="cuda",
        init: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[TrainState, List[dict]]:
    """Train `cfg` for `max_steps` (default `train.steps`) on `device` (the
    card unless the caller names the CPU); returns (state, history), the
    history one dict a logged line.  `init` (a state_dict) replaces the
    seeded initial parameters.

    Data: clips generated on the card every step (`data.on_device_generate`),
    the train split resident on the card (`data.device_resident`, by default
    when the device is a card and the split fits
    `data.device_resident_max_bytes`; a per-frame config's rows are frames),
    or batches streamed from the host through `DeviceFeed`.  Every
    `eval_every` steps the first `eval_batches` val batches (staged on the
    device once, seeds 1 + n) are scored, and with an EMA scored again under
    it (`val_*_ema`).  Metrics are read one log interval late.  Every
    `checkpoint_every` steps a checkpoint is written in the background
    (data cursor = step), and the last step always; `train.resume` restores
    the newest and a streaming run skips the batches it consumed.  SIGTERM
    saves the last whole step and ends the process.

    Data-parallel (a process group of N > 1 ranks: one a card under
    torchrun, which this joins, or one the caller started): every rank runs
    this with the same config.  Rank r trains on `batch_size // N` rows a
    step from its shard of the splits (`split[r::N]`: resident, streamed or
    generated from its own seed), its eval on full val batches of its
    shard, the metrics the ranks' means.  Rank 0 logs and writes the
    checkpoints; every rank restores from `train.checkpoint_dir`, which
    must be one directory that all the nodes share, and a resume whose
    ranks found different steps there raises on every rank.  All meet
    after the final save.  SIGTERM to any rank stops every rank after the
    same step, which is saved.

    `train.steps_per_call` = K > 1 runs K steps a call (`chunk_steps`: one
    CUDA graph replay on a card, the K-step loop on the CPU), as the JAX
    package's fit: on the resident and generated paths only, with every
    cadence and the resumed step multiples of K; the chunk's last step is
    logged, and evals, checkpoints and the SIGTERM save fall on chunk
    ends."""
    check_supported(cfg)
    dev, sync = _data_parallel(cfg, _device(device))
    rank, world = pmesh.place(sync)
    lead = rank == 0
    steps = max_steps or cfg.train.steps
    model = build_model(cfg, dev)
    if init is not None:
        model.load_state_dict(init)
    ongen = cfg.data.on_device_generate
    sprite_bank = load_sprite_bank(cfg.data.sprite_bank) if cfg.data.sprite_bank else None
    dataset = _load_split(cfg, sprite_bank, rank=rank, world=world)
    _check_ongen_val(cfg, dataset, sprite_bank)
    state = create_train_state(model, cfg.optim)
    start_step = data_step = 0
    if cfg.train.resume and cfg.train.checkpoint_dir:
        state, start_step, data_step = ckpt.restore_latest(cfg.train.checkpoint_dir, state)
        if sync is not None:
            least, most = sync.span([start_step, data_step])
            if least != most:
                raise ValueError(
                    f"resume: the ranks restored steps {least[0]}..{most[0]} (data cursors "
                    f"{least[1]}..{most[1]}) from train.checkpoint_dir="
                    f"{cfg.train.checkpoint_dir!r}: it must be one directory shared by "
                    "every node (rank 0 alone writes it)")

    split = dataset.split_data
    resident = cfg.data.device_resident
    if resident is None:
        resident = dev.type == "cuda" and split.nbytes <= cfg.data.device_resident_max_bytes
    resident = resident and not ongen
    spc = steps_per_call(cfg)
    check_chunking(cfg, spc, streaming=not (resident or ongen), steps=steps,
                   start_step=start_step)
    step_fn = make_config_step(cfg, model, resident=resident, sprites=sprite_bank, sync=sync)
    if spc > 1:
        step_fn = chunk_steps(step_fn, spc, sync=sync)
    batch = local_batch(cfg, world)
    data_dev, host_iter = None, None
    if resident:
        rows = split.reshape(-1, *split.shape[2:]) if cfg.data.per_frame else split
        data_dev = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    elif not ongen:
        # skip what the run being resumed consumed: resume == uninterrupted
        batches = dataset.frame_batches if cfg.data.per_frame else dataset.batches
        host_iter = batches(batch, seed=cfg.data.seed, skip_batches=data_step)

    val_dataset = _load_split(cfg, sprite_bank, train=False, rank=rank, world=world)
    eval_step = make_eval_step(model, binarize=cfg.data.binarize, sync=sync)
    val_cache: list = []  # (rows, batch on the device, seed), staged by the first pass

    def run_eval(params) -> Dict[str, float]:
        if not val_cache:
            # every rank scores the same count of full batches of its shard
            avail = _val_rows(cfg, val_dataset)
            if sync is not None:
                avail = sync.span([avail])[0][0]
            vbs = min(batch, avail)
            if vbs == 0:
                return {}
            n_batches = cfg.train.eval_batches if sync is None else \
                min(cfg.train.eval_batches, avail // vbs)
            for n, vb in zip(range(n_batches), _val_batches(cfg, val_dataset, vbs, seed=1,
                                                            full_only=sync is not None)):
                val_cache.append((vb.shape[0], torch.from_numpy(vb).to(dev), 1 + n))
        if not val_cache:
            return {}
        parts = [(b, eval_step(params, vb, seed)) for b, vb, seed in val_cache]
        return {f"val_{k}": v for k, v in _weighted_mean(parts).items()}

    logger = MetricsLogger(csv_path=cfg.train.metrics_csv if lead else None,
                           frames_per_step=frames_per_step(cfg),
                           print_fn=print if lead else _silent,
                           tensorboard_dir=cfg.train.tensorboard_dir if lead else None,
                           append=cfg.train.resume and start_step > 0)
    history: List[dict] = []
    ckpt_dir = cfg.train.checkpoint_dir

    def forced_save(step: int) -> None:
        if ckpt_dir:
            if lead:
                ckpt.save(ckpt_dir, state, step, data_step=step, force=True, wait=True)
            pmesh.barrier(dev)  # no rank goes on before the step is on disk

    sigterm = install_sigterm_checkpoint() if ckpt_dir else None
    feed = (DeviceFeed(host_iter, dev, depth=cfg.data.prefetch_depth)
            if host_iter is not None else None)
    try:
        with debug_nans(cfg.train.debug_nans):
            pending = None  # (step, metrics), read one interval late: no sync stall
            val_metrics: Dict[str, float] = {}
            for end in range(start_step + spc, steps + 1, spc):
                if sync is not None:
                    sync.stop = sigterm is not None and sigterm.requested
                metrics = step_fn(state, data_dev if feed is None else next(feed))
                if spc > 1:  # stacked (K,): log the chunk's last step, as JAX's fit
                    metrics = {k: v[-1] for k, v in metrics.items()}
                if sigterm is not None and (sigterm.requested if sync is None
                                            else sync.stop_agreed()):
                    print(f"SIGTERM: saving step {end} and stopping", file=sys.stderr,
                          flush=True)
                    sigterm.save_and_exit(lambda: forced_save(end))
                if end % cfg.train.log_every == 0 or end == steps:
                    if pending is not None:
                        history.append(logger.log(pending[0], {**pending[1], **val_metrics}))
                        val_metrics = {}
                    pending = (end, metrics)
                if cfg.train.eval_every and end % cfg.train.eval_every == 0:
                    val_metrics = run_eval(None)
                    if state.ema_params is not None:
                        # the same batches and seeds: only the parameters differ
                        val_metrics.update({f"{k}_ema": v
                                            for k, v in run_eval(state.ema_params).items()})
                if ckpt_dir and lead and end % cfg.train.checkpoint_every == 0:
                    # one host batch a step: the data cursor is the step
                    ckpt.save(ckpt_dir, state, end, data_step=end)
            if pending is not None:
                # read right after the last step: no throughput for this window
                history.append(logger.log(pending[0], {**pending[1], **val_metrics},
                                          throughput=False))
        forced_save(steps)
        if sigterm is not None and sigterm.requested:
            sigterm.save_and_exit(lambda: None)  # the last step is saved
    finally:
        if feed is not None:
            feed.stop()
        if sigterm is not None:
            sigterm.uninstall()
        logger.close()
    return state, history


def _silent(*args, **kwargs) -> None:
    """The logger's print on a rank other than 0."""
