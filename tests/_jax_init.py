"""The JAX package's initial parameters of a config, as its `fit` draws them
(`create_train_state` under `jax.random.PRNGKey(train.seed)`), written in
the port's state_dict layout (`mmvae_torch.convert.state_dict_from_flax`),
one .npz a seed:

    JAX_PLATFORMS=cpu python tests/_jax_init.py --config seq_vae --seeds 0 1 \\
        --out DIR [--set KEY=VALUE ...]

`python -m mmvae_torch.bench.quality --init DIR/seed0.npz` trains the port
from it.  A parameter's value depends on the key, its module path and its
shape only, so the init traces one clip of two frames.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from mmvae_torch.convert import state_dict_from_flax  # noqa: E402
from mmvae_tpu.configs import get_config  # noqa: E402
from mmvae_tpu.train.loop import build_model  # noqa: E402
from mmvae_tpu.train.state import create_train_state  # noqa: E402


def jax_init(config: str, overrides=(), seed: int = 0) -> dict:
    """{state_dict name: array} of the JAX model's init at `train.seed` =
    `seed` (the overrides' own `train.seed` is ignored)."""
    cfg = get_config(config, tuple(overrides))
    shape = (1, 64, 64) if cfg.data.per_frame else (1, 2, 64, 64)
    model = build_model(cfg)
    params = jax.jit(lambda key: create_train_state(model, cfg.optim, key, shape).params)(
        jax.random.PRNGKey(seed))
    sd = state_dict_from_flax(jax.tree.map(np.asarray, params))
    return {k: v.numpy() for k, v in sd.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for seed in args.seeds:
        path = os.path.join(args.out, f"seed{seed}.npz")
        np.savez(path, **jax_init(args.config, args.set, seed))
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
