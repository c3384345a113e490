"""Kernels of the port and their plain PyTorch versions.

Every kernel wrapper counts its launches in a `launches` attribute:
`preprocess_gather`, `elbo_reduce`, `reparameterize`,
`head_sample_forward`, `head_sample_backward` (the Gaussian head and its
sample, fused), `convlstm_proj_forward`, `convlstm_proj_backward` (K5),
`convlstm_scan_forward` and `convlstm_scan_backward` (K6).  The two
recurrence forwards also count by mode in a `modes` dict (K5: "save",
"nores"; K6: "save", "hs", "last"), read by `launch_counts_by_mode`.  K5's
and K6's four wrappers also count by route in a `routes` dict ("wgmma",
"general": `convlstm_kernels.route`), read by `launch_counts_by_route`.
A wrapper counts where it launches; a launch captured in a CUDA graph is
counted at capture, so `train.loop.chunk_steps` takes the counts its
capture added (`launch_snapshot`, `launch_delta`), takes them off again
and adds them at every replay (`add_launches`).
"""

from mmvae_torch.ops.convlstm_kernels import (
    convlstm_proj_backward,
    convlstm_proj_forward,
    convlstm_scan,
    convlstm_scan_backward,
    convlstm_scan_forward,
    convlstm_scan_proj,
)
from mmvae_torch.ops.elbo_kernels import elbo_reduce, reparameterize
from mmvae_torch.ops.head_kernels import (
    gaussian_head_sample,
    head_sample_backward,
    head_sample_forward,
)
from mmvae_torch.ops.preprocess_kernels import preprocess_gather

KERNEL_WRAPPERS = {
    "preprocess_gather": preprocess_gather,
    "elbo_reduce": elbo_reduce,
    "reparameterize": reparameterize,
    "head_sample_forward": head_sample_forward,
    "head_sample_backward": head_sample_backward,
    "convlstm_proj_forward": convlstm_proj_forward,
    "convlstm_proj_backward": convlstm_proj_backward,
    "convlstm_scan_forward": convlstm_scan_forward,
    "convlstm_scan_backward": convlstm_scan_backward,
}
_SPLITS = ("modes", "routes")  # the dicts a wrapper may split its count into


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
        for split in _SPLITS:
            for key in getattr(fn, split, ()):
                getattr(fn, split)[key] = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def launch_snapshot() -> dict:
    """Every count, by wrapper, mode and route: {(name, None, None): n,
    (name, "modes" or "routes", key): n}."""
    out = {}
    for name, fn in KERNEL_WRAPPERS.items():
        out[name, None, None] = fn.launches
        for split in _SPLITS:
            out.update(((name, split, key), n) for key, n in getattr(fn, split, {}).items())
    return out


def launch_delta(since: dict) -> dict:
    """The counts added after `since` (a `launch_snapshot`)."""
    now = launch_snapshot()
    return {key: now[key] - since.get(key, 0) for key in now}


def add_launches(delta: dict) -> None:
    """Add `delta` (a `launch_delta`) to the counts."""
    for (name, split, key), n in delta.items():
        fn = KERNEL_WRAPPERS[name]
        if split is None:
            fn.launches += n
        else:
            getattr(fn, split)[key] += n


def launch_counts_by_mode() -> dict:
    """`launch_counts` with each recurrence forward split by mode, as
    "convlstm_proj_forward nores" and the like."""
    out = {}
    for name, fn in KERNEL_WRAPPERS.items():
        modes = getattr(fn, "modes", None)
        if modes is None:
            out[name] = fn.launches
        else:
            out.update((f"{name} {mode}", n) for mode, n in modes.items())
    return out


def launch_counts_by_route() -> dict:
    """K5's and K6's launches by route, as "convlstm_proj_forward general"
    and the like."""
    return {f"{name} {way}": n for name, fn in KERNEL_WRAPPERS.items()
            for way, n in getattr(fn, "routes", {}).items()}


__all__ = [
    "KERNEL_WRAPPERS",
    "add_launches",
    "convlstm_proj_backward",
    "convlstm_proj_forward",
    "convlstm_scan",
    "convlstm_scan_backward",
    "convlstm_scan_forward",
    "convlstm_scan_proj",
    "elbo_reduce",
    "gaussian_head_sample",
    "head_sample_backward",
    "head_sample_forward",
    "launch_counts",
    "launch_counts_by_mode",
    "launch_counts_by_route",
    "launch_delta",
    "launch_snapshot",
    "preprocess_gather",
    "reparameterize",
    "reset_launch_counts",
]
