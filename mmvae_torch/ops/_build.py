"""Build the package's CUDA kernels with nvcc and load them with ctypes.

All `mmvae_torch/csrc/*.cu` sources compile into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), one
nvcc process per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu      (each source)
    nvcc -shared -o build/kernels/libmmvae_<hash>.so *.o

The library lands in `build/kernels/` at the repository root, named by a
hash of the sources and flags, and is built at first use in a process;
processes that start together (the ranks of a data-parallel run) take a
lock on the directory, so one builds and the others load its library.
Wrappers pass tensor pointers and the current stream as `c_void_p`; every
entry point returns `cudaGetLastError()`, and `check()` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint

# C signatures of the library's entry points (all return int).
_SIGNATURES = {
    "mmvae_preprocess_gather": [_P, _P, _P, _LL, _LL, _LL, _U, _P, _I, _I, _I, _I, _P],
    "mmvae_convlstm_proj_fwd": [_P] * 8 + [_I] * 10 + [_P, _P],
    "mmvae_convlstm_proj_bwd": [_P] * 13 + [_I] * 8 + [_P, _P],
    "mmvae_convlstm_wgrad": [_P] * 6 + [_I] * 8 + [_P],
    "mmvae_convlstm_route": [_I] * 4,
    "mmvae_convlstm_proj_layout": [_I, _I, _I, _P],
    "mmvae_convlstm_scan_fwd": [_P] * 7 + [_I] * 10 + [_P, _P],
    "mmvae_convlstm_scan_bwd": [_P] * 11 + [_I] * 9 + [_P, _P],
    "mmvae_convlstm_scan_layout": [_I, _I, _P],
    "mmvae_convlstm_general_layout": [_I] * 5 + [_P],
    "mmvae_convlstm_general_splits": [_I] * 3,
    "mmvae_head_sample_fwd": [_P] * 12 + [_I] * 4 + [_U, _P, _I, _I, _P],
    "mmvae_head_sample_bwd": [_P] * 14 + [_I] * 4 + [_P],
    "mmvae_head_sample_layout": [_I] * 4 + [_P],
    "mmvae_capture_frontier": [_P, _P, _I],
    "mmvae_graph_nodes": [_P] * 4 + [_I],
    "mmvae_graph_kernel_name": [ctypes.c_ulonglong, ctypes.c_char_p, _I],
}
_RESTYPES = {"mmvae_convlstm_proj_layout": None, "mmvae_convlstm_scan_layout": None,
             "mmvae_convlstm_general_layout": None, "mmvae_head_sample_layout": None}


class KernelLibrary:
    """The built shared library plus what its build printed."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, _I)

    def __getattr__(self, name):
        return getattr(self.lib, name)


_LIBRARIES: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library(defines: tuple = ()) -> KernelLibrary:
    """Build (once per source hash) and load the kernel library; `defines`
    adds flags to NVCC_FLAGS for a diagnostic build (`bench.head_phases`:
    `-DHEAD_PHASE_TIMES`), a library of its own."""
    if defines in _LIBRARIES:
        return _LIBRARIES[defines]
    flags = (*NVCC_FLAGS, *defines)
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libmmvae_{h.hexdigest()[:16]}.so"
    log = ""
    t0 = time.perf_counter()
    if not out.exists():
        with open(BUILD_DIR / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes or the process ends
            if not out.exists():
                log = _compile(out, flags)
    _LIBRARIES[defines] = KernelLibrary(out, time.perf_counter() - t0, log)
    return _LIBRARIES[defines]


def _compile(out: Path, flags: tuple) -> str:
    """nvcc each source into an object with `flags`, all at once, then link
    `out`."""
    objdir = out.with_suffix(f".{os.getpid()}.objs")
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = objdir / f"{src.stem}.o"
        cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for obj, proc in procs:
        text, _ = proc.communicate()
        log += f"== {obj.stem}.cu\n{text}"
        if proc.returncode != 0:
            failed.append(obj.stem)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for o, _ in procs)],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)
    return log


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def on_device(fn):
    """Run a kernel launcher with the device of its first argument (a
    tensor) current, so its launch runs in that card's context, on that
    card's current stream, whatever device the caller made current.  A CPU
    tensor goes straight through, to the launcher's own refusal."""

    @functools.wraps(fn)
    def launch(first, *args, **kwargs):
        import torch

        if not first.is_cuda:
            return fn(first, *args, **kwargs)
        with torch.cuda.device(first.device):
            return fn(first, *args, **kwargs)

    return launch


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def triton_cache_env() -> None:
    """Keep Triton's compile cache inside the checkout's build directory."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR.parent / "triton"))
