"""The port stands alone: mmvae_torch and chip_smoke.py need nothing of the JAX
package, and the port's copy of the configs has not drifted from it.

- every module of `mmvae_torch`, and `chip_smoke`, imports in a process where
  a meta-path finder refuses `jax`, `flax` and `mmvae_tpu`;
- a scan of their syntax trees finds no import of those packages and no file
  path into `mmvae_tpu/` built or opened (comments and docstrings, which
  cite the reference's files, are exempt);
- `mmvae_torch.configs.get_config` equals `mmvae_tpu.configs.get_config`
  field by field for the five configs, with and without overrides.
"""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

from mmvae_torch.configs import CONFIG_REGISTRY, get_config
from mmvae_tpu.configs import get_config as jget_config

REPO = Path(__file__).resolve().parents[1]
_REFUSED = ("jax", "flax", "mmvae_tpu")

_IMPORT_ALL = """
import importlib, importlib.abc, json, pkgutil, sys

REFUSED = ("jax", "flax", "mmvae_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import mmvae_torch
names = ["mmvae_torch"] + [m.name for m in pkgutil.walk_packages(mmvae_torch.__path__,
                                                                   "mmvae_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"modules": names, "loaded": [m for m in sys.modules
                                                if m.split(".")[0] in REFUSED]}))
"""


def test_port_imports_with_the_jax_package_refused():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert {"mmvae_torch.configs", "mmvae_torch.ops.convlstm_kernels",
            "mmvae_torch.ops.head_kernels",
            "mmvae_torch.bench.roofline", "mmvae_torch.train.loop", "mmvae_torch.train.state",
            "mmvae_torch.data.loader", "mmvae_torch.data.ongen", "mmvae_torch.data.feed",
            "mmvae_torch.train.checkpoint", "mmvae_torch.train.metrics",
            "mmvae_torch.utils.debug", "mmvae_torch.models.mlp_vae",
            "mmvae_torch.models.conv_vae", "mmvae_torch.sample", "mmvae_torch.sample.generate",
            "mmvae_torch.cli", "mmvae_torch.__main__",
            "mmvae_torch.utils.profiling"} <= set(res["modules"])


# Calls whose string arguments name a file or module to load.
_LOADERS = {"open", "Path", "PurePath", "spec_from_file_location", "import_module",
            "__import__", "exec", "run_path", "read_text", "read_bytes", "joinpath"}


def _mentions(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str) and any(
        r in node.value for r in ("mmvae_tpu", "jax"))


def _violations(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if a.name.split(".")[0] in _REFUSED]
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.module.split(".")[0] in _REFUSED:
                found.append(node.module)
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", "")
            if name in _LOADERS and any(_mentions(a) for a in node.args):
                found.append(f"{name}(...) at line {node.lineno}")
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            if _mentions(node.left) or _mentions(node.right):
                found.append(f"path '/ ...mmvae_tpu...' at line {node.lineno}")
    return found


def _port_files():
    return sorted((REPO / "mmvae_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_or_path_into_the_jax_package(path):
    assert _violations(path) == []


def test_the_scan_catches_what_it_looks_for(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax\nfrom mmvae_tpu.configs import base\n"
                   "from pathlib import Path\np = Path(__file__) / 'mmvae_tpu' / 'x.py'\n"
                   "q = open('mmvae_tpu/configs/base.py')\n"
                   "# mmvae_tpu/ops/x.py: a comment is exempt\n")
    assert len(_violations(bad)) == 4


_OVERRIDES = (
    ("optim.lr=3e-4", "data.batch_size=8"),
    ("model.kwargs.fused=true", "model.dtype=float32", "train.use_pallas=none"),
    ("optim.lr_schedule=cosine", "train.steps=500", "model.kwargs.enc_channels=4,8"),
)


@pytest.mark.parametrize("name", list(CONFIG_REGISTRY))
def test_config_copy_equals_the_reference(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jget_config(name))
    for ov in _OVERRIDES:
        assert dataclasses.asdict(get_config(name, ov)) == dataclasses.asdict(
            jget_config(name, ov)), ov


def test_config_copy_has_the_same_fields_and_registry():
    from mmvae_tpu.configs import base as jbase

    from mmvae_torch import configs

    assert list(configs.CONFIG_REGISTRY) == list(jbase.CONFIG_REGISTRY)
    for cls in ("Config", "DataConfig", "ModelConfig", "OptimConfig", "TrainConfig"):
        mine = [(f.name, f.type) for f in dataclasses.fields(getattr(configs, cls))]
        assert mine == [(f.name, f.type) for f in dataclasses.fields(getattr(jbase, cls))]
    for value, current in (("true", False), ("none", 1), ("4,8", (1,)), ("2.5", 1.0)):
        assert configs._coerce(value, current) == jbase._coerce(value, current)
