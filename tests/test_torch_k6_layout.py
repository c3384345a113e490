"""The Python around K6's Hopper kernels, on the CPU: the weight slabs of its
forward and BPTT, and its launch geometry at every shape the paths and the
CUDA tests give it (config 4 fused: B=64, T=10, 8x8, F=128, const xg)."""

import numpy as np
import pytest
import torch

from mmvae_torch.ops import convlstm_kernels as ck

# (B, T, H, W, F): configs 4, 5 and 3 fused (the decoders, const xg; at
# (64, 20) also enc_x_kernel=3's streaming encoder) and the unaligned shapes
# of the CUDA tests.
SHAPES = [(64, 10, 8, 8, 128), (160, 10, 8, 8, 128), (64, 20, 8, 8, 128), (3, 7, 5, 6, 32),
          (2, 4, 7, 9, 16), (64, 20, 8, 8, 192), (160, 10, 8, 8, 256), (3, 7, 5, 6, 160),
          (64, 10, 8, 8, 224)]
FEATS = [128, 64, 48, 32, 16, 160, 192, 224, 256]


def _w(f, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((3, 3, f, 4 * f)).astype(np.float32))


@pytest.mark.parametrize("f", FEATS)
def test_forward_slabs_unpack_to_the_weights(f):
    """K6's forward slabs are K5's with an empty Wx: per rank the 9F rows of
    W and the rank's F/2 channels of each gate, ordered (warpgroup, gate,
    channel)."""
    w = _w(f)
    pk = ck.pack_proj_forward(w.new_empty(0, 4 * f), w)
    cl = ck.cluster_size(f)
    hf, nwg = f // cl, ck.consumer_groups(f)
    assert pk.shape == (cl, 9 * f // 8, 4 * hf // 8, 8, 8)
    hfw = hf // nwg
    back = torch.zeros(9 * f, 4 * f)
    for rank in range(cl):
        per_rank = ck.unpack_cores(pk[rank])
        for wg in range(nwg):
            for q in range(4):
                lo = q * f + rank * hf + wg * hfw
                back[:, lo:lo + hfw] = per_rank[:, (wg * 4 + q) * hfw:(wg * 4 + q + 1) * hfw]
    assert torch.equal(back, w.reshape(9 * f, 4 * f))


@pytest.mark.parametrize("f", FEATS)
def test_backward_slabs_unpack_to_the_transpose(f):
    """The BPTT's slabs: W^T with rows (tap, n), rank r holding columns
    [r F/2, (r + 1) F/2), the same as K5's dh half."""
    w = _w(f, seed=1)
    pk = ck.pack_hidden_backward(w)
    cl = ck.cluster_size(f)
    assert pk.shape == (cl, 9 * 4 * f // 8, f // cl // 8, 8, 8)
    got = torch.cat([ck.unpack_cores(pk[r]) for r in range(cl)], dim=1)
    assert torch.equal(got, w.reshape(9, f, 4 * f).transpose(1, 2).reshape(9 * 4 * f, f))
    wx = torch.zeros(32, 4 * f)
    assert torch.equal(ck.pack_proj_backward(wx, w)[0], pk)


@pytest.mark.parametrize("const", [True, False], ids=["const", "streaming"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_scan_geometry_fits_the_card(shape, const):
    b, t, h, w, f = shape
    geo = ck.scan_geometry(*shape, const)
    cl = ck.cluster_size(f)
    assert geo["clusters"] == b and geo["ctas"] == cl * b
    # a 4-CTA BPTT keeps a time-constant xg's dgates sum in global memory
    assert geo["bwd_min_stages"] == (ck.SCAN_BWD_MIN_STAGES if const and cl == 2 else 4)
    assert 4 <= geo["fwd_stages"] <= 8
    assert geo["bwd_min_stages"] <= geo["bwd_stages"] <= 8
    for part in ("fwd", "bwd"):
        assert geo[f"{part}_ring_bytes"] == geo[f"{part}_stages"] * geo[f"{part}_slot_bytes"]
        assert geo[f"{part}_ring_bytes"] < geo[f"{part}_smem"] <= ck.SMEM_LIMIT == 227 * 1024
    assert geo["fwd_slot_bytes"] == 32 * 4 * (f // cl) * 2  # 32 rows of the CTA's 4F/CL columns
    # 128 rows of its F/CL columns (64 with 4 CTAs a sample)
    assert geo["bwd_slot_bytes"] == (256 // cl) * (f // cl) * 2
    # the weight GEMM: dW's 9F rows, one wave of tiles x splits, every row covered
    assert geo["wgrad_smem"] <= ck.SMEM_LIMIT
    assert geo["wgrad_tiles"] == -(-9 * f // 128) * -(-4 * f // geo["wgrad_bn"])
    assert geo["wgrad_tiles"] * geo["wgrad_splits"] <= ck.SMS
    rows = b * t * h * w
    assert geo["wgrad_splits"] * geo["wgrad_rows_per_split"] >= rows
    assert (geo["wgrad_splits"] - 1) * geo["wgrad_rows_per_split"] < rows  # no empty split
    assert geo["wgrad_rows_per_split"] % 64 == 0


def test_config4_geometry():
    """Config 4's decoder: 128 CTAs on 132 SMs; the forward holds xg in
    registers, which leaves it eight 16 KB slabs; a time-constant xg leaves
    the BPTT three (beside its 64 KB f32 dgates sum); the weight GEMM's 18
    tiles of 128 x 256 split 7 ways (126 CTAs).  The streaming encoder at
    (64, 20): eight forward slabs, seven BPTT slabs."""
    geo = ck.scan_geometry(64, 10, 8, 8, 128, True)
    assert (geo["ctas"], geo["fwd_stages"], geo["fwd_slot_bytes"]) == (128, 8, 16384)
    assert (geo["bwd_stages"], geo["bwd_slot_bytes"]) == (3, 16384)
    assert (geo["wgrad_bn"], geo["wgrad_tiles"], geo["wgrad_splits"]) == (256, 18, 7)
    stream = ck.scan_geometry(64, 20, 8, 8, 128, False)
    assert (stream["fwd_stages"], stream["bwd_stages"]) == (8, 7)
    # the const BPTT gives up ring space for its sum: 64 rows x 2F f32
    assert stream["bwd_smem"] - stream["bwd_ring_bytes"] + 64 * 256 * 4 == (
        geo["bwd_smem"] - geo["bwd_ring_bytes"])


def test_k5_geometry_is_unchanged_by_the_shared_layout():
    """K5's numbers at config 3's shape, from the helpers K6 now shares."""
    geo = ck.proj_geometry(64, 20, 8, 8, 128, 128)
    assert (geo["fwd_stages"], geo["fwd_smem"], geo["bwd_stages"], geo["bwd_smem"]) == (
        6, 217600, 6, 218368)
    assert (geo["wgrad_tiles"], geo["wgrad_splits"], geo["wgrad_rows_per_split"]) == (
        20, 6, 13696)


def _scan_args():
    z = torch.zeros
    return z(1, 2, 4, 4, 64), z(3, 3, 16, 64), z(1, 4, 4, 16), z(1, 4, 4, 16)


@pytest.mark.parametrize("path", ["forward", "backward"])
def test_scan_kernel_paths_refuse_cpu_tensors(path):
    """K6's CUDA paths raise for CPU tensors before they build or launch
    anything; the plain versions run only through the wrappers' device test."""
    xg, w, c0, h0 = _scan_args()
    with pytest.raises(ValueError, match="cuda"):
        if path == "forward":
            ck.scan_forward_cuda(xg, w, c0, h0, 2, torch.float32, "save")
        else:
            hs = torch.zeros(1, 2, 16, 16)
            ck.scan_backward_cuda(w, c0, h0, hs, hs, torch.zeros(1, 2, 16, 64), hs,
                                  torch.zeros(1, 16, 16), False, False)
