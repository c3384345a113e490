"""Kernels of the port and their plain PyTorch versions.

Every kernel wrapper counts its launches in a `launches` attribute:
`preprocess_gather`, `elbo_reduce`, `reparameterize`,
`head_sample_forward`, `head_sample_backward` (the Gaussian head and its
sample, fused), `convlstm_proj_forward`, `convlstm_proj_backward` (K5),
`convlstm_scan_forward` and `convlstm_scan_backward` (K6).  The two
recurrence forwards also count by mode in a `modes` dict (K5: "save",
"nores"; K6: "save", "hs", "last"), read by `launch_counts_by_mode`.
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


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
        for mode in getattr(fn, "modes", ()):
            fn.modes[mode] = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


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


__all__ = [
    "KERNEL_WRAPPERS",
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
    "preprocess_gather",
    "reparameterize",
    "reset_launch_counts",
]
