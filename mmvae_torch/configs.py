"""Named configs: the dataclasses of `mmvae_tpu/configs/base.py`, reused.

That file is pure Python (dataclasses, no jax).  It is loaded here by path,
as its own module, so the port uses the very same definitions without
importing the `mmvae_tpu` package (whose other modules need jax and flax,
which a GPU host may not have).
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_BASE = Path(__file__).resolve().parents[1] / "mmvae_tpu" / "configs" / "base.py"
_NAME = "mmvae_torch._config_base"


def _load():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    spec = importlib.util.spec_from_file_location(_NAME, _BASE)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_NAME] = mod  # dataclasses resolve their module while defined
    spec.loader.exec_module(mod)
    return mod


_base = _load()
Config = _base.Config
CONFIG_REGISTRY = _base.CONFIG_REGISTRY
get_config = _base.get_config

__all__ = ["CONFIG_REGISTRY", "Config", "get_config"]
