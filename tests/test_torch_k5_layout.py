"""The Python around K5's Hopper kernels, on the CPU: weight packing into
wgmma cores, the launch geometry, and the work counts of
`mmvae_torch.bench.roofline` against the figures worked out by hand from
the shapes (main path: B=64, T=20, 8x8, C=F=128)."""

import numpy as np
import pytest
import torch

from mmvae_torch.bench.roofline import bound, kernel_work
from mmvae_torch.ops import convlstm_kernels as ck

# (B, T, H, W, C, F): the path shapes (configs 3, 4, 5), the unaligned
# shapes the CUDA tests use, and the 4-CTA widths (the lstm_features=192
# probe among them, and config 5's batch at 256).
SHAPES = [(64, 20, 8, 8, 128, 128), (64, 10, 8, 8, 128, 128), (160, 10, 8, 8, 128, 128),
          (160, 20, 8, 8, 128, 128), (3, 7, 5, 6, 48, 32), (2, 4, 7, 9, 32, 16),
          (5, 3, 7, 9, 32, 16), (64, 20, 8, 8, 128, 160), (64, 20, 8, 8, 128, 192),
          (64, 20, 8, 8, 128, 224), (160, 10, 8, 8, 128, 256), (3, 7, 5, 6, 48, 192)]


def _weights(c, f, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((c, 4 * f)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((3, 3, f, 4 * f)).astype(np.float32)))


def test_pack_cores_round_trip_and_layout():
    mat = torch.arange(32 * 24, dtype=torch.float32).view(32, 24)
    pk = ck.pack_cores(mat)
    assert pk.shape == (4, 3, 8, 8) and pk.is_contiguous()
    # core (kc, nb) holds 8 n-rows of 8 consecutive k: mat[8kc + k][8nb + n]
    assert pk[1, 2, 5, 3] == mat[8 + 3, 16 + 5]
    assert torch.equal(ck.unpack_cores(pk), mat)


@pytest.mark.parametrize("c,f", [(128, 128), (48, 32), (32, 16), (128, 192), (64, 160),
                                 (32, 224), (128, 256)])
def test_forward_slabs_unpack_to_the_weights(c, f):
    wx, w = _weights(c, f)
    pk = ck.pack_proj_forward(wx, w)
    cl = ck.cluster_size(f)
    hf = f // cl
    assert pk.shape == (cl, (c + 9 * f) // 8, 4 * hf // 8, 8, 8)
    full = torch.cat([wx, w.reshape(9 * f, 4 * f)])
    back = torch.zeros_like(full)
    nwg = ck.consumer_groups(f)
    assert nwg == (2 if hf % 16 == 0 else 1)
    hfw = hf // nwg
    for rank in range(cl):
        per_rank = ck.unpack_cores(pk[rank])  # (K, 2F) ordered (warpgroup, gate, channel)
        for wg in range(nwg):
            for q in range(4):
                src = per_rank[:, (wg * 4 + q) * hfw:(wg * 4 + q + 1) * hfw]
                lo = q * f + rank * hf + wg * hfw
                back[:, lo:lo + hfw] = src
    assert torch.equal(back, full)


@pytest.mark.parametrize("c,f", [(128, 128), (48, 32), (32, 16), (160, 64), (128, 192),
                                 (48, 160), (512, 256)])
def test_backward_slabs_unpack_to_the_transposes(c, f):
    wx, w = _weights(c, f, seed=1)
    wt_pk, wx_pk = ck.pack_proj_backward(wx, w)
    cl = ck.cluster_size(f)
    hf, c2 = f // cl, c // cl
    blocks = -(-c2 // 64)
    assert wt_pk.shape == (cl, 9 * 4 * f // 8, hf // 8, 8, 8)
    assert wx_pk.shape == (cl, blocks, 4 * f // 8, 8, 8, 8)
    # W^T: rows (tap, n), columns f; rank r holds columns [r*HF, (r+1)*HF)
    wt = w.reshape(9, f, 4 * f).transpose(1, 2).reshape(9 * 4 * f, f)
    got = torch.cat([ck.unpack_cores(wt_pk[r]) for r in range(cl)], dim=1)
    assert torch.equal(got, wt)
    # Wx^T: rows n, columns c; rank r holds [r*C/CL, (r+1)*C/CL) in zero-padded blocks of 64
    for r in range(cl):
        cols = torch.cat([ck.unpack_cores(wx_pk[r, b]) for b in range(blocks)], dim=1)
        assert torch.equal(cols[:, :c2], wx.t()[:, r * c2:(r + 1) * c2])
        assert not cols[:, c2:].any()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_launch_geometry_fits_the_card(shape):
    b, t, h, w, c, f = shape
    geo = ck.proj_geometry(*shape)
    cl = ck.cluster_size(f)
    assert geo["clusters"] == b and geo["ctas"] == cl * b and geo["cluster"] == cl
    for part in ("fwd", "bwd"):
        assert 4 <= geo[f"{part}_stages"] <= 8
        assert geo[f"{part}_ring_bytes"] == geo[f"{part}_stages"] * geo[f"{part}_slot_bytes"]
        assert geo[f"{part}_ring_bytes"] < geo[f"{part}_smem"] <= ck.SMEM_LIMIT == 227 * 1024
    assert geo["fwd_slot_bytes"] == 32 * 4 * (f // cl) * 2  # 32 rows of the CTA's 4F/CL columns
    assert geo["wgrad_smem"] <= ck.SMEM_LIMIT
    assert geo["wgrad_tiles"] * geo["wgrad_splits"] <= ck.SMS
    rows = b * t * h * w
    assert geo["wgrad_splits"] * geo["wgrad_rows_per_split"] >= rows
    assert geo["wgrad_rows_per_split"] % 64 == 0


def test_main_path_geometry():
    """Config 3's numbers: 128 CTAs on 132 SMs, six 16 KB forward slabs and
    six 16 KB backward slabs in flight, the weight GEMM's 20 tiles of
    128 x 256 split 6 ways (120 CTAs)."""
    geo = ck.proj_geometry(64, 20, 8, 8, 128, 128)
    assert (geo["ctas"], geo["fwd_stages"], geo["fwd_slot_bytes"]) == (128, 6, 16384)
    assert (geo["bwd_stages"], geo["bwd_slot_bytes"]) == (6, 16384)
    assert (geo["wgrad_bn"], geo["wgrad_tiles"], geo["wgrad_splits"]) == (256, 20, 6)


def test_geometry_refuses_what_does_not_fit():
    """A C so wide that fewer than 4 forward slabs fit in one CTA's shared
    memory: `proj_geometry` reports it, and the CUDA wrapper refuses it."""
    geo = ck.proj_geometry(2, 2, 8, 8, 1024, 128)
    assert geo["fwd_stages"] < 4


def test_kernel_work_matches_the_hand_counts():
    k5 = (64, 20, 8, 8, 128, 128)
    flops, nbytes = kernel_work("convlstm_proj_forward", k5)
    # 2 B T 4F (HW C + (3H-2)(3W-2) F): only the 484 of 576 taps inside 8x8
    assert flops == pytest.approx(91.94e9, rel=1e-3)
    assert nbytes == pytest.approx(147e6, rel=0.05)
    assert bound("convlstm_proj_forward", k5) == (pytest.approx(0.0930, rel=0.01), "operations")
    flops, _ = kernel_work("convlstm_proj_backward", k5)
    # dh 81.2 + dW 81.2 + dWx 10.7 + dx 10.7
    assert flops == pytest.approx((81.20 + 81.20 + 10.74 + 10.74) * 1e9, rel=1e-3)
    assert bound("convlstm_proj_backward", k5) == (pytest.approx(0.186, rel=0.01), "operations")
    # a 5x6 image: 13 x 16 = 208 of 270 taps
    assert kernel_work("convlstm_proj_forward", (1, 1, 5, 6, 16, 16))[0] == (
        2 * 64 * (30 * 16 + 208 * 16))
    _, nbytes = kernel_work("elbo_reduce", ((64, 20, 64, 64), (64, 128)))
    assert nbytes == pytest.approx(31.5e6, rel=0.01)
    assert bound("elbo_reduce", ((64, 20, 64, 64), (64, 128))) == (
        pytest.approx(0.0094, rel=0.01), "bytes")
    _, nbytes = kernel_work("preprocess_gather", (9000, 20, 64))
    assert nbytes == pytest.approx(5.2e6 + 10.5e6, rel=0.01)
    assert bound("preprocess_gather", (9000, 20, 64))[0] == pytest.approx(0.0047, rel=0.01)
    # per-frame configs' f32 frames: 4 bytes out, and f32 x into the reduce
    _, nbytes = kernel_work("preprocess_gather", (36000, 1, 64, 4))
    assert nbytes == 64 * 4096 * (1 + 4) + 64 * 8
    _, nbytes = kernel_work("elbo_reduce", ((64, 64, 64), (64, 20), 4))
    assert nbytes == 64 * 4096 * (4 + 4) + 2 * 64 * 20 * 4 + 8
    k6 = (64, 10, 8, 8, 128, True)
    assert kernel_work("convlstm_scan_forward", k6)[0] == pytest.approx(40.60e9, rel=1e-3)
    assert bound("convlstm_scan_forward", k6) == (pytest.approx(0.0411, rel=0.01), "operations")
    assert bound("convlstm_scan_backward", k6) == (pytest.approx(0.0821, rel=0.01), "operations")
    assert bound("reparameterize", (64, 128))[1] == "bytes"
    with pytest.raises(KeyError):
        kernel_work("nope", ())


def test_kernel_work_of_the_forwards_without_residuals():
    """A forward without residuals does the saving one's operations and moves
    fewer bytes: K5 reads x, the weights and (c0, h0) and writes (h_T,
    c_T); K6 "hs" writes every h_t and c_T, "last" (h_T, c_T)."""
    k5 = (64, 20, 8, 8, 128, 128)
    ops, nbytes = kernel_work("convlstm_proj_forward_nores", k5)
    assert ops == kernel_work("convlstm_proj_forward", k5)[0]
    rows, state = 64 * 20 * 64, 4 * 64 * 64 * 128 * 2
    weights = (128 + 9 * 128) * 512 * 2 + 512 * 2
    assert nbytes == rows * 128 * 2 + weights + state
    assert bound("convlstm_proj_forward_nores", k5) == bound("convlstm_proj_forward", k5)
    for shape in ((64, 10, 8, 8, 128, True), (160, 10, 8, 8, 128, True),
                  (64, 20, 8, 8, 128, False)):
        b, t, h, w, f, const = shape
        xg = (b if const else b * t) * h * w * 4 * f * 2
        weights, state, hs = 9 * f * 4 * f * 2, b * h * w * f * 2, b * t * h * w * f * 2
        save_ops = kernel_work("convlstm_scan_forward", shape)[0]
        assert kernel_work("convlstm_scan_forward_hs", shape) == (
            save_ops, float(xg + hs + weights + 3 * state))
        assert kernel_work("convlstm_scan_forward_last", shape) == (
            save_ops, float(xg + weights + 4 * state))
        assert bound("convlstm_scan_forward_hs", shape)[1] == "operations"
