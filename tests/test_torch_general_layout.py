"""The general ConvLSTM kernels' layout on the CPU (their arithmetic runs
only on the card, `tests/test_torch_cuda.py`; their plain versions against
the Pallas kernels, `tests/test_torch_general.py`).

- `general_geometry` fits one CTA's 227 KB of shared memory and at most 16
  CTAs a sample at every `kernel_checks.GENERAL_SHAPES` entry and over the
  domain (H, W up to 32, C and F up to 288, both activation dtypes), and
  keeps h and the dgates in shared memory at the full-width shapes;
- the fragment-order packing of W (forward, rank by rank in the kernels'
  column order), Wx (K5's x projection), W^T (BPTT) and Wx^T (dx) unpacks
  to the weights;
- the f32 weights' TF32 hi / lo split;
- the forward's first step and the BPTT's rank-order sum of partial dh,
  emulated from the packed weights as the kernels read them, against the
  plain versions' conv and transposed conv.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from mmvae_torch.ops import convlstm_kernels as ck
from mmvae_torch.ops import kernel_checks as kc

_ES = {torch.bfloat16: 2, torch.float32: 4}
_FULL_WIDTH = ((64, 20, 16, 16, 128, 128), (64, 20, 8, 8, 128, 192))


def _fits(geo) -> None:
    assert 1 <= geo["cluster"] <= 16
    for key in ("fwd_smem", "bwd_smem", "wgrad_smem"):
        assert 0 < geo[key] <= ck.SMEM_LIMIT, (key, geo[key])
    assert geo["nc"] * geo["cluster"] >= 1


@pytest.mark.parametrize("k5", [True, False], ids=["K5", "K6"])
@pytest.mark.parametrize("case", [(s, a) for s, acts in kc.GENERAL_SHAPES for a in acts],
                         ids=lambda c: f"{c[0]}-{c[1]}".replace("torch.", ""))
def test_geometry_fits_the_general_shapes(case, k5):
    (b, t, h, w, c, f), act = case
    geo = ck.general_geometry(b, t, h, w, c if k5 else 0, f, _ES[act])
    _fits(geo)
    # every general shape the smoke checks keeps h's copy, the dgates tile
    # and the partials in shared memory
    assert geo["hbuf"] >= 1 and geo["dg_res"] and geo["part_res"]
    assert geo["fwd_scratch"] == geo["bwd_scratch"] == 0


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", _FULL_WIDTH, ids=["16x16", "probe"])
def test_geometry_at_full_width(shape, es):
    """The full-width rows: B x CL at least the SMs and every cell of a
    CTA's warps busy but for the padding."""
    b, t, h, w, c, f = shape
    for cin in (c, 0):
        geo = ck.general_geometry(b, t, h, w, cin, f, es)
        _fits(geo)
        assert geo["ctas"] >= ck.SMS
        assert geo["hbuf"] >= 1 and geo["dg_res"] and geo["part_res"]
        assert geo["fwd"]["passes"] == 1


@settings(max_examples=150, deadline=None)
@given(b=st.integers(1, 256), t=st.integers(1, 32), h=st.integers(1, 32), w=st.integers(1, 32),
       c=st.integers(0, 288), f=st.integers(1, 288), es=st.sampled_from([2, 4]))
def test_geometry_fits_the_domain(b, t, h, w, c, f, es):
    geo = ck.general_geometry(b, t, h, w, c, f, es)
    _fits(geo)
    # the BPTT's partials cover every channel, the forward every column
    assert geo["bwd"]["nt"] * 8 >= f and geo["fwd"]["nt"] * 8 >= 4 * geo["nc"]
    assert geo["wgrad_splits"] >= 1


def _weights(rng, c, f, dtype):
    wx = torch.from_numpy(rng.normal(size=(c, 4 * f)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(3, 3, f, 4 * f)) / np.sqrt(9 * f)).astype(
        np.float32)).to(dtype)
    return wx, w


def _ranks(f, cl):
    return [(f * r // cl, f * (r + 1) // cl) for r in range(cl)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("cf", [(24, 20), (128, 192), (8, 37)], ids=["C24F20", "C128F192", "C8F37"])
def test_forward_packing_unpacks_to_the_weights(cf, dtype):
    c, f = cf
    wx, w = _weights(np.random.default_rng(0), c, f, dtype)
    geo = ck.general_geometry(2, 2, 16, 16, c, f, _ES[dtype])
    cl = geo["cluster"]
    scheme = "f64" if dtype == torch.float32 else "bf16"
    pk = ck.pack_general_forward(w, cl)
    assert pk.shape[:3] == (cl, geo["fwd"]["nkb"], geo["fwd"]["nt"])
    got = ck.unpack_fragments(pk, scheme)  # (cl, K, N)
    fp = geo["feat_pad"]
    rows = torch.zeros(9 * fp, 4 * f)
    for tap in range(9):
        rows[tap * fp:tap * fp + f] = w.float().reshape(9, f, 4 * f)[tap]
    for r, (lo, hi) in enumerate(_ranks(f, cl)):
        want = torch.zeros(rows.shape[0], got.shape[-1])
        for lc in range(hi - lo):
            for q in range(4):
                want[:, 4 * lc + q] = rows[:, q * f + lo + lc]
        assert torch.equal(got[r], want), r
    # K5's x projection: Wx whole, gate-major, padded to 16 x 8
    xp = ck.unpack_fragments(ck.pack_general_xproj(wx), scheme)
    assert xp.shape == (-(-c // 16) * 16, -(-4 * f // 8) * 8)
    assert torch.equal(xp[:c, :4 * f], wx.float()) and not xp[c:].any() and not xp[:, 4 * f:].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("f", [20, 44, 128])
def test_backward_packing_unpacks_to_w_transposed(f, dtype):
    _, w = _weights(np.random.default_rng(1), 8, f, dtype)
    geo = ck.general_geometry(4, 2, 16, 16, 0, f, _ES[dtype])
    cl, kt = geo["cluster"], geo["tap_k"]
    scheme = "f64" if dtype == torch.float32 else "bf16"
    got = ck.unpack_fragments(ck.pack_general_backward(w, cl), scheme)  # (cl, 9 kt, F up 8)
    assert got.shape == (cl, 9 * kt, geo["bwd"]["nt"] * 8)
    w9 = w.float().reshape(9, f, 4 * f)
    for r, (lo, hi) in enumerate(_ranks(f, cl)):
        want = torch.zeros(9, kt, got.shape[-1])
        for lc in range(hi - lo):
            for q in range(4):
                want[:, 4 * lc + q, :f] = w9[:, :, q * f + lo + lc]
        assert torch.equal(got[r], want.reshape(9 * kt, -1)), r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_dx_packing_unpacks_to_wx_transposed(dtype):
    wx, _ = _weights(np.random.default_rng(2), 24, 20, dtype)
    scheme = "tf32" if dtype == torch.float32 else "bf16"
    got = ck.unpack_fragments(ck.pack_general_dx(wx), scheme)
    assert got.shape == (80, 24)
    tol = 2.0 ** -21 * float(wx.float().abs().max()) if dtype == torch.float32 else 0.0
    assert (got - wx.float().t()).abs().max() <= tol


def test_tf32_split_of_the_f32_weights():
    """hi is TF32 (its 13 low mantissa bits zero) and hi + lo is within
    2^-22 of the weight, relative, over six decades."""
    rng = np.random.default_rng(3)
    wv = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.uniform(-3, 3, 4096)).astype(
        np.float32))
    hi, lo = ck.tf32_split(wv)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double() - wv.double()).abs() / wv.double().abs()).max()
    assert float(rel) <= 2.0 ** -22
    # what the BPTT's packing holds is that split
    pk = ck.pack_fragments(wv.reshape(256, 16), "tf32")
    assert torch.equal(torch.sort(pk[..., 0, :].flatten())[0], torch.sort(hi)[0])


def _halo_rows(hmap, height, width, feat_pad):
    """(B, H, W, F) -> (B, (H + 2) (W + 2), Fp) with a zero halo and zero
    padding columns: the kernels' copy of h (or dgates)."""
    b, _, _, f = hmap.shape
    out = torch.zeros(b, height + 2, width + 2, feat_pad, dtype=hmap.dtype)
    out[:, 1:-1, 1:-1, :f] = hmap
    return out.reshape(b, -1, feat_pad)


def test_forward_first_step_from_the_packed_weights():
    """Step 0's pre-activations as the K5 kernels form them (the x
    projection against the packed Wx, then the nine taps of the haloed h_0
    against each rank's packed columns, mapped back to the gate-major
    order) equal x Wx + conv3x3(h_0, W)."""
    b, h, w_, c, f = 2, 16, 16, 24, 20
    rng = np.random.default_rng(4)
    wx, w = _weights(rng, c, f, torch.float32)
    x = torch.from_numpy(rng.normal(size=(b, h * w_, c)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(b, h, w_, f)).astype(np.float32))
    geo = ck.general_geometry(b, 1, h, w_, c, f, 4)
    cl, fp = geo["cluster"], geo["feat_pad"]
    pk = ck.unpack_fragments(ck.pack_general_forward(w, cl), "f64").double()
    xp = ck.unpack_fragments(ck.pack_general_xproj(wx), "f64").double()
    halo = _halo_rows(h0, h, w_, fp).double()
    pos = torch.arange(h * w_)
    centre = (pos // w_ + 1) * (w_ + 2) + pos % w_ + 1
    a = torch.cat([halo[:, centre + (tap // 3 - 1) * (w_ + 2) + tap % 3 - 1]
                   for tap in range(9)], -1)  # (B, HW, 9 Fp)
    got = (F.pad(x.double(), (0, xp.shape[0] - c)) @ xp)[..., :4 * f]
    for r, (lo, hi) in enumerate(_ranks(f, cl)):
        cols = a @ pk[r]
        for lc in range(hi - lo):
            for q in range(4):
                got[..., q * f + lo + lc] += cols[..., 4 * lc + q]
    conv = ck._hidden_conv(h0.reshape(b, -1, f).double(),
                           w.double().permute(3, 2, 0, 1), h, w_)
    want = x.double() @ wx.double() + conv
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("f", [20, 37])
def test_rank_order_partial_dh_equals_the_transposed_taps(f):
    """The BPTT's dh_{t-1}: each rank's partial over all F channels from its
    own dgate columns (zero-haloed tile, transposed taps, its packed W^T),
    summed over the cluster in rank order, equals the plain version's
    conv_transpose2d of the dgates to f32 summation tolerance."""
    b, h, w_ = 2, 16, 16
    rng = np.random.default_rng(5)
    _, w = _weights(rng, 8, f, torch.float32)
    dg = torch.from_numpy(rng.normal(size=(b, h, w_, 4 * f)).astype(np.float32))
    geo = ck.general_geometry(b, 1, h, w_, 0, f, 4)
    cl, kt = geo["cluster"], geo["tap_k"]
    assert cl > 1
    wt = ck.unpack_fragments(ck.pack_general_backward(w, cl), "f64")  # (cl, 9 kt, F up 8)
    pos = torch.arange(h * w_)
    centre = (pos // w_ + 1) * (w_ + 2) + pos % w_ + 1
    dh = torch.zeros(b, h * w_, wt.shape[-1])
    for r, (lo, hi) in enumerate(_ranks(f, cl)):
        own = torch.zeros(b, h, w_, kt)  # the rank's dgate columns, 4 lc + q
        for lc in range(hi - lo):
            for q in range(4):
                own[..., 4 * lc + q] = dg[..., q * f + lo + lc]
        tile = _halo_rows(own, h, w_, kt)
        part = torch.zeros_like(dh)
        for tap in range(9):
            rows = tile[:, centre + (1 - tap // 3) * (w_ + 2) + 1 - tap % 3]
            part += rows @ wt[r, tap * kt:(tap + 1) * kt]
        dh = dh + part  # in rank order
    want = F.conv_transpose2d(dg.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    want = want.permute(0, 2, 3, 1).reshape(b, h * w_, f)
    scale = float(want.abs().max())
    assert float((dh[..., :f] - want).abs().max()) <= 2.0 ** -18 * scale
    assert float(dh[..., f:].abs().max()) == 0.0
