"""Named configs: the port's own copy of the reference's config system.

A copy of `mmvae_tpu/configs/base.py` (dataclasses, `_coerce`, the five
`config_*` builders and `get_config`), kept so that the port imports
nothing of the JAX package.  Field names, defaults and the dotted override
syntax are the reference's (``--set optim.lr=1e-4``);
`tests/test_torch_isolation.py` checks that the two stay equal.  Comments
citing `BASELINE.json` and measurements describe the JAX reference on the
TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class DataConfig:
    path: Optional[str] = None          # canonical .npy; None -> procedural
    num_sequences: int = 10000          # procedural dataset size
    seq_len: int = 20
    num_digits: int = 2
    batch_size: int = 64                # clips (sequence models) or frames (per-frame)
    per_frame: bool = False             # True: feed single frames (configs 1-2)
    binarize: bool = True               # stochastic Bernoulli binarization
    device_resident: Optional[bool] = None  # dataset lives in HBM; None = auto
    device_resident_max_bytes: int = 4 << 30  # auto threshold
    # Resident-mode batch sampling: False = uniform with replacement (one
    # on-device randint, the throughput default); True = shuffled epochs
    # without replacement (reference/streaming semantics: an in-graph
    # per-epoch permutation, each row exactly once per epoch).
    resident_epochs: bool = False
    # Generate fresh clips ON DEVICE inside the jitted step (data/ongen.py):
    # no fixed train dataset, unlimited data, exact resume (step-counter RNG).
    # Val stays the fixed held-out split for comparable curves.  Measured
    # rationale in docs/RESULTS.md (the fixed 10k-clip split overfits by 20k
    # steps; fresh data removes the train/val gap at its source).
    on_device_generate: bool = False
    # Path to a (K, S, S) .npy sprite bank (loader.load_sprite_bank): both
    # the host generator and the on-device generator composite from it, with
    # uniform identity sampling over K.  None = the built-in 10-glyph font.
    # The hook for training on REAL digit crops when a digit source exists
    # (the canonical val file is real MNIST; the font can never match it).
    sprite_bank: Optional[str] = None
    train_fraction: float = 0.9
    prefetch_depth: int = 2
    seed: int = 0


@dataclasses.dataclass
class ModelConfig:
    name: str = "mlp_vae"
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dtype: str = "float32"              # activation dtype: float32 | bfloat16


@dataclasses.dataclass
class OptimConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: Optional[float] = None   # global-norm clip; None = off
    beta: float = 1.0                   # KL weight (beta-VAE); 1.0 = plain ELBO
    kl_warmup_steps: int = 0            # linear beta ramp 0 -> beta over N steps
    # Learning-rate schedule (the reference trains at a fixed Adam LR, so
    # "constant" is the parity default; decay is a pure framework knob).
    lr_schedule: str = "constant"       # constant | cosine | linear
    lr_warmup_steps: int = 0            # linear 0 -> lr ramp before the decay
    lr_decay_steps: int = 0             # decay horizon; 0 = train.steps
                                        # (resolved by get_config/fit)
    lr_end_ratio: float = 0.0           # final lr as a fraction of peak lr
    weight_decay: float = 0.0           # decoupled (AdamW) weight decay; 0 = adam
    ema_decay: float = 0.0              # param EMA for eval (0 = off);
                                        # val_*_ema metrics report its quality


@dataclasses.dataclass
class TrainConfig:
    steps: int = 10000
    log_every: int = 50
    eval_every: int = 1000
    checkpoint_every: int = 1000
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    seed: int = 0
    use_pallas: Optional[bool] = None   # None = auto (Pallas on TPU)
    data_parallel: bool = True
    metrics_csv: Optional[str] = None
    tensorboard_dir: Optional[str] = None
    eval_batches: int = 4               # val batches per eval pass
    multihost: bool = False             # jax.distributed.initialize() at startup
    debug_nans: bool = False            # jax_debug_nans guard around training
    transfer_guard: bool = False        # disallow implicit host<->device syncs
                                        # around every train step (hazard guard)
    steps_per_call: int = 1             # fuse K steps into one dispatch via
                                        # lax.scan (resident mode only; K must
                                        # divide log/eval/checkpoint cadences)


@dataclasses.dataclass
class Config:
    name: str = "default"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def override(self, dotted: str, value: str) -> None:
        """Apply `a.b=value` with type coercion from the field's current type."""
        keys = dotted.split(".")
        obj: Any = self
        for k in keys[:-1]:
            obj = getattr(obj, k) if not isinstance(obj, dict) else obj[k]
        leaf = keys[-1]
        if isinstance(obj, dict):
            obj[leaf] = _coerce(value, obj.get(leaf))
        else:
            setattr(obj, leaf, _coerce(value, getattr(obj, leaf)))


_TRUTHY = ("true", "1", "yes", "on")
_FALSY = ("false", "0", "no", "off")


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool) or value.lower() in ("true", "false"):
        v = value.lower()
        if v in _TRUTHY:
            return True
        if v in _FALSY:
            return False
        if v in ("none", "null") and not isinstance(current, bool):
            return None
        raise ValueError(
            f"cannot coerce {value!r} to bool (use one of {_TRUTHY + _FALSY})"
        )
    if value.lower() in ("none", "null"):
        return None
    if isinstance(current, (tuple, list)) or "," in value:
        # Comma-separated tuple, e.g. --set model.kwargs.enc_channels=4,8;
        # elements coerce against the current tuple's first element (or by
        # int/float/str inference when the key is new).
        parts = [p.strip() for p in value.split(",") if p.strip()]
        elem = (
            current[0] if isinstance(current, (tuple, list)) and current else None
        )
        return tuple(_coerce(p, elem) for p in parts)
    if isinstance(current, int) and not isinstance(current, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if current is None:
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
    return value


def _mk(name: str, **kw) -> Config:
    c = Config(name=name, **kw)
    return c


def config_mlp_vae() -> Config:
    """BASELINE.json:7 — MLP VAE on single 64x64 frames, latent 20, batch 64."""
    return _mk(
        "mlp_vae",
        data=DataConfig(batch_size=64, per_frame=True),
        model=ModelConfig(name="mlp_vae", kwargs={"latent_dim": 20}),
    )


def config_conv_vae() -> Config:
    """BASELINE.json:8 — per-frame Conv VAE, 4-layer enc/dec, latent 64, batch 128."""
    return _mk(
        "conv_vae",
        data=DataConfig(batch_size=128, per_frame=True),
        model=ModelConfig(name="conv_vae", kwargs={"latent_dim": 64}),
    )


def config_seq_vae() -> Config:
    """BASELINE.json:9 — ConvLSTM sequence VAE on 20-frame clips."""
    return _mk(
        "seq_vae",
        data=DataConfig(batch_size=64, seq_len=20),
        # bf16 activations: MXU-native; params, posterior heads, and the ELBO
        # reduction stay f32 (see models.base docstring).  unroll=T fully
        # unrolls the 20-step time scan (XLA schedules the whole chain, keeps
        # cell state in VMEM: +17% measured); gate_bf16 runs the pointwise
        # gate math + cell state in bf16 (+5%).  enc_x_kernel=1 makes the
        # encoder LSTM's input projection a pure matmul (+15% end-to-end;
        # the 3x3 projection was the step's largest op group) at a measured
        # ~3% train-ELBO cost at 20k steps.  The quality knob (measured
        # fresh in rounds 4/8, docs/RESULTS.md):
        #   --set model.kwargs.dec_upsample=fast_mid    (20k train ELBO 3032,
        #       best known, at 143.4k fps fenced — dominates fast_hq's
        #       3128/139.2k on train ELBO; fast_hq keeps a ~2% val edge)
        # enc_x_kernel=3 on top of fast_hq costs a further -13% fps and buys
        # NO additional ELBO at 20k (3161 vs 3128) — not a step worth taking.
        # remat=True: nn.remat on the DECODER scan body (the encoder runs the
        # proj-fused Pallas kernel, which keeps its own residuals) — the
        # backward recomputes gates instead of streaming the scan's saved
        # residuals from HBM, which buys overlap: 160.1k -> 163.5k frames/s
        # measured e2e (round 7), bit-identical loss.  pred_vae measured the
        # same knob as a LOSS (309.5k -> 298.7k) and keeps it off.
        model=ModelConfig(
            name="seq_vae",
            kwargs={
                "latent_dim": 128, "unroll": 20, "gate_bf16": True,
                "enc_x_kernel": 1, "remat": True,
            },
            dtype="bfloat16",
        ),
    )


def config_pred_vae() -> Config:
    """BASELINE.json:10 — 10 context frames -> 10 future frames."""
    return _mk(
        "pred_vae",
        data=DataConfig(batch_size=64, seq_len=20),
        model=ModelConfig(
            name="pred_vae",
            kwargs={
                "context_len": 10, "unroll": 10, "gate_bf16": True,
                "enc_x_kernel": 1,
            },
            dtype="bfloat16",
        ),
    )


def config_hier_vae() -> Config:
    """BASELINE.json:11 — hierarchical temporal latents, 100-frame clips, DP."""
    return _mk(
        "hier_vae",
        data=DataConfig(batch_size=16, seq_len=100, num_sequences=2000),
        # unroll=chunk_len fully unrolls the 10-step chunk scans (remat stays
        # on for 100-frame backprop memory; measured free under full unroll).
        model=ModelConfig(
            name="hier_vae",
            kwargs={
                "chunk_len": 10, "remat": True, "gate_bf16": True, "unroll": 10,
                "enc_x_kernel": 1,
            },
            dtype="bfloat16",
        ),
    )


CONFIG_REGISTRY = {
    "mlp_vae": config_mlp_vae,
    "conv_vae": config_conv_vae,
    "seq_vae": config_seq_vae,
    "pred_vae": config_pred_vae,
    "hier_vae": config_hier_vae,
}


def get_config(name: str, overrides: Tuple[str, ...] = ()) -> Config:
    if name not in CONFIG_REGISTRY:
        raise KeyError(
            f"unknown config {name!r}; available: {', '.join(CONFIG_REGISTRY)}"
        )
    cfg = CONFIG_REGISTRY[name]()
    for ov in overrides:
        key, _, val = ov.partition("=")
        cfg.override(key.strip(), val.strip())
    if cfg.optim.lr_schedule != "constant" and cfg.optim.lr_decay_steps <= 0:
        # A decaying schedule needs a horizon; default it to the run length.
        cfg.optim.lr_decay_steps = cfg.train.steps
    return cfg


__all__ = ["CONFIG_REGISTRY", "Config", "get_config"]
