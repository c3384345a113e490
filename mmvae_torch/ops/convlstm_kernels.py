"""The ConvLSTM recurrences: encoder with the input projection in-kernel (K5)
and the hidden recurrence given a precomputed projection (K6).

K5 replaces mmvae_tpu/ops/convlstm_pallas.py::convlstm_scan_proj_pallas with
the CUDA kernels of `csrc/convlstm_proj.cu` (see its header for the design):

    gates_t = x_t @ wx + bx + conv3x3_SAME(h_{t-1}, w)      (i, f, g, o)
    c_t = sig(f + 1) * c_{t-1} + sig(i) * tanh(g);   h_t = sig(o) * tanh(c_t)

`convlstm_scan_proj` returns only the terminal state (c_T, h_T), the
encoder's shape.  K6 replaces `convlstm_scan_pallas` with the kernels of
`csrc/convlstm_scan.cu`, which are K5's Hopper kernels
(`csrc/convlstm_wgmma.cuh`) without the x segment: `convlstm_scan` takes xg
(the hoisted projection, bias included) streaming (B, T, H, W, 4F) or
time-constant (B, 1, H, W, 4F) with `length=T`, and returns ((c_T, h_T), hs)
or, `last_only`, ((c_T, h_T), None); gates_t = xg_t + conv3x3_SAME(h_{t-1},
w), the two added in the gate dtype as the TPU kernel adds them.  Both
kernels' backward passes write their dgates in the activation dtype for one
weight-gradient GEMM (`mmvae_convlstm_wgrad`); a streaming xg's dxg is that
scratch.

Inputs share one activation dtype T, which is also the matmul operand dtype;
accumulation is f32; the pointwise chain and the cell state run in
`gate_dtype` (float32 or bfloat16), and the backward chain in f32, as in the
TPU kernels.  The forward that feeds a backward saves hs, cs and the
post-activation gates (in T); without grad a residual-free forward runs.
On the card the wrappers take T = bfloat16 or float32 at every shape
(`check_domain` refuses any other dtype) and `route` picks the kernels from
the shape and dtype alone: the wgmma kernels (`csrc/convlstm_wgmma.cuh`) in
their domain, T = bfloat16 (the production dtype) at F a multiple of 16 up
to 128 (2 CTAs a sample) or of 32 up to 256 (4 CTAs a sample) and T =
float32 (the JAX package's default) at F a multiple of 16 up to 128, its
products f32-accurate as 3xTF32 (weights split here by `tf32_split`,
`pack_proj_forward`), H*W <= 64 and, for K5, C a multiple of 16 that leaves
both rings 4 stages; the general kernels (`csrc/convlstm_general.cuh`,
mma.sync on the tensor cores, `general_geometry`) everywhere else.

The plain versions below follow the same algorithms step by step in PyTorch
(f32 convs and matmuls on operands rounded to T); they are the CPU path and
the oracle the kernels are compared with on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from mmvae_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _sigmoid(v: torch.Tensor) -> torch.Tensor:
    """The gates' sigmoid in their dtype: with bf16 gates 1 / (1 + exp(-v))
    with every op rounded to bf16, as the TPU kernel computes it
    (`convlstm_pallas.py:155-159`); with f32 gates torch's."""
    if v.dtype != torch.bfloat16:
        return torch.sigmoid(v)
    one = v.new_ones(())
    return one / (one + torch.exp(-v))


def _split_gates(gates: torch.Tensor, feat: int):
    i, f, g, o = gates.split(feat, dim=-1)
    i = _sigmoid(i)
    f = _sigmoid(f + 1.0)
    g = torch.tanh(g)
    o = _sigmoid(o)
    return i, f, g, o


def _hidden_conv(h: torch.Tensor, w_oihw: torch.Tensor, height: int, width: int):
    """(B, HW, F) f32 -> (B, HW, 4F): the 3x3 SAME conv in f32."""
    b, hw, feat = h.shape
    hn = h.view(b, height, width, feat).permute(0, 3, 1, 2)
    out = F.conv2d(hn, w_oihw, padding=1)
    return out.permute(0, 2, 3, 1).reshape(b, hw, -1)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 `t` rounded to TF32's 10 mantissa bits (to nearest, ties away,
    as the kernels' cvt.rna.tf32.f32)."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(t: torch.Tensor):
    """(hi, lo), each TF32, with hi + lo = t to about 2^-22 |t|: an f32
    operand of the kernels' 3xTF32 products."""
    hi = tf32(t)
    return hi, tf32(t.float() - hi)


def _operand(t: torch.Tensor, act, tf32_operands: bool) -> torch.Tensor:
    """A product operand as the plain versions take it: rounded to the
    activation dtype (the weights, act None, as given) and computed in f32,
    or (the TF32 control) rounded to TF32 as well."""
    t = t.float() if act is None else t.to(act).float()
    return tf32(t) if tf32_operands else t


def proj_forward_plain(x, wx, bx, w, c0, h0, gate_dtype, save: bool, tf32_operands=False):
    """Plain forward.  x (B, T, H, W, C); returns (hs, cs, gates) with shapes
    (B, T, HW, F), (B, T, HW, F), (B, T, HW, 4F) when `save`, else
    (h_T, c_T) as (B, HW, F); all in x.dtype.  `tf32_operands` rounds
    every product operand to TF32: what a 1xTF32 kernel would compute."""
    act = x.dtype
    batch, t_len, height, width, cin = x.shape
    f4 = wx.shape[1]
    feat = f4 // 4
    hw = height * width
    op = functools.partial(_operand, act=act, tf32_operands=tf32_operands)
    opw = functools.partial(_operand, act=None, tf32_operands=tf32_operands)
    xg = op(x).reshape(batch, t_len, hw, cin) @ opw(wx) + bx.float()
    w_oihw = opw(w).permute(3, 2, 0, 1)
    c = c0.reshape(batch, hw, feat).to(gate_dtype)
    h = h0.reshape(batch, hw, feat).to(gate_dtype)
    hs, cs, ga = [], [], []
    for t in range(t_len):
        hg = _hidden_conv(op(h), w_oihw, height, width)
        # the TPU kernel's rounding: the projection (with its bias) and the
        # conv each rounded to the gate dtype, then added in it
        # (convlstm_pallas.py:408-409)
        gates = xg[:, t].to(gate_dtype) + hg.to(gate_dtype)
        i, f, g, o = _split_gates(gates, feat)
        c = f * c + i * g
        h = o * torch.tanh(c)
        if save:
            hs.append(h.to(act))
            cs.append(c.to(act))
            ga.append(torch.cat([i, f, g, o], dim=-1).to(act))
    if save:
        return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(ga, 1)
    return h.to(act), c.to(act)


def proj_backward_plain(x, wx, w, c0, h0, hs, cs, ga, dh_last, dc_last, tf32_operands=False):
    """Plain BPTT: reverse time, (dh, dc) carried in f32.  Returns
    (dx, dwx, dbx, dw, dc0, dh0) in the dtypes and shapes of the inputs.
    `tf32_operands` as in `proj_forward_plain`."""
    act = x.dtype
    batch, t_len, height, width, cin = x.shape
    f4 = wx.shape[1]
    feat = f4 // 4
    hw = height * width
    op = functools.partial(_operand, act=act, tf32_operands=tf32_operands)
    w_oihw = _operand(w, None, tf32_operands).permute(3, 2, 0, 1)
    wxf = _operand(wx, None, tf32_operands)
    xf = op(x).reshape(batch, t_len, hw, cin)
    c0f = c0.reshape(batch, hw, feat).float()
    h0f = h0.reshape(batch, hw, feat).float()
    dh = dh_last.reshape(batch, hw, feat).to(act).float()
    dc = dc_last.reshape(batch, hw, feat).to(act).float()
    dx = torch.empty(batch, t_len, hw, cin, dtype=act, device=x.device)
    dwx = torch.zeros(cin, f4, device=x.device)
    dbx = torch.zeros(f4, device=x.device)
    dw = torch.zeros(f4, feat, 3, 3, device=x.device)
    for t in range(t_len - 1, -1, -1):
        c_t = cs[:, t].float()
        c_prev = cs[:, t - 1].float() if t > 0 else c0f
        h_prev = op(hs[:, t - 1]) if t > 0 else _operand(h0f, None, tf32_operands)
        i, f, g, o = ga[:, t].float().split(feat, dim=-1)
        tanh_ct = torch.tanh(c_t)
        do = dh * tanh_ct
        dct = dc + dh * o * (1.0 - tanh_ct * tanh_ct)
        dgates = torch.cat([
            dct * g * i * (1.0 - i),
            dct * c_prev * f * (1.0 - f),
            dct * i * (1.0 - g * g),
            do * o * (1.0 - o),
        ], dim=-1)
        dc = dct * f
        dg_mat = op(dgates)
        dx[:, t] = (dg_mat @ wxf.t()).to(act)
        dwx += torch.einsum("bpc,bpn->cn", xf[:, t], dg_mat)
        dbx += dgates.sum(dim=(0, 1))
        dg_n = dg_mat.view(batch, height, width, f4).permute(0, 3, 1, 2)
        h_n = h_prev.view(batch, height, width, feat).permute(0, 3, 1, 2)
        dw += torch.nn.grad.conv2d_weight(h_n, w_oihw.shape, dg_n, padding=1)
        dh = F.conv_transpose2d(dg_n, w_oihw, padding=1).permute(0, 2, 3, 1).reshape(
            batch, hw, feat
        )
    return (
        dx.view(x.shape),
        dwx.to(wx.dtype),
        dbx.to(wx.dtype),
        dw.permute(2, 3, 1, 0).contiguous().to(w.dtype),
        dc.view(c0.shape).to(c0.dtype),
        dh.view(h0.shape).to(h0.dtype),
    )


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


# The wgmma kernels' domain (`route`); the general kernels take every other
# shape.
DOMAIN = ("bfloat16 activations with F a multiple of 16 up to 128 or a multiple of 32 up to "
          "256, float32 activations with F a multiple of 16 up to 128, H*W <= 64 and (K5) C a "
          "multiple of 16 that leaves both rings 4 stages")


def _require_cuda(what, named):
    """The kernels run on the card; a CPU tensor takes the plain version."""
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not cuda")


def check_domain(what: str, dtype: torch.dtype, feat: int, hw: int, cin=None) -> None:
    """Raise TypeError unless the activations are bf16 or f32: the CUDA
    kernels take those at every F = `feat`, `hw` positions and (K5) C =
    `cin` input channels (`route`)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: activations are {dtype}; the CUDA kernels take bfloat16 or "
                        f"float32 at any shape (the wgmma kernels {DOMAIN}, the general "
                        f"kernels the rest)")


def route(dtype: torch.dtype, feat: int, hw: int, cin=None) -> str:
    """The kernels K5 (C = `cin`) or K6 (`cin` None) run for activations of
    `dtype` at F = `feat` and `hw` positions: "wgmma" in the wgmma kernels'
    domain (`DOMAIN`: for K5 also at least 4 ring stages in both of its
    recurrences), else "general".  From the shape and dtype alone, as
    `csrc/convlstm_launch.cuh`'s `route` (which `mmvae_convlstm_route`
    exposes) picks them; TypeError for another dtype."""
    check_domain("convlstm_scan_proj" if cin is not None else "convlstm_scan", dtype, feat, hw,
                 cin)
    narrow = feat % 16 == 0 and 0 < feat <= 128
    wide = dtype == torch.bfloat16 and feat % 32 == 0 and 128 < feat <= 256
    wgmma = (narrow or wide) and hw <= 64 and (cin is None or cin % 16 == 0)
    if wgmma and cin is not None:
        geo = proj_geometry(1, 1, 8, 8, cin, feat, _es(dtype))
        wgmma = min(geo["fwd_stages"], geo["bwd_stages"]) >= _MIN_STAGES
    return "wgmma" if wgmma else "general"


# The general kernels' launch geometry (`csrc/convlstm_general.cuh`'s
# gen_geometry, which computes the same numbers; the wrappers hold the two
# equal once a shape, `_general_layout`).  A cluster of `cluster` CTAs a
# sample, CTA r owning channels [F r / cl, F (r + 1) / cl) of the four
# gates; each step is a GEMM of H W positions x (the CTA's 4 nc gate
# columns forward, all F channels backward) x k-blocks of 16 (the 9 taps,
# each padded to 16; K5's x projection is one GEMM over all steps first),
# run by 8 warps of 32 x 32 blocks in passes, with weights streamed in
# slabs of `pbk` k-blocks through a 3-stage ring.  Shared memory holds, in
# this order as far as 227 KB allow: the ring, the cell state and h
# staging, two copies of h with its halo, else one, the saving forward's
# gates (forward); the ring,
# K5's column sums, the (dh, dc) carries, the CTA's zero-haloed dgates
# tile, the partial dh (BPTT).  What does not fit lives in global scratch.
_GEN_THREADS, _GEN_WARPS, _GEN_STAGES, _GEN_MAX_CLUSTER = 256, 8, 3, 16
_GEN_RED_BYTES = _GEN_THREADS * 16
_GEN_WG_BM, _GEN_WG_BN, _GEN_WG_BK, _GEN_WG_PAD = 64, 128, 32, 8


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _up(a: int, b: int) -> int:
    return _ceil(a, b) * b


def _up128(a: int) -> int:
    return _up(a, 128)


def _gen_stride(n: int, es: int) -> int:
    """A row of n elements padded so that its bytes are an odd multiple of
    16 (eight rows read by ldmatrix in eight bank groups)."""
    e = 16 // es
    s = _up(max(n, 1), e)
    return s if (s // e) % 2 else s + e


def general_cluster(batch: int, feat: int) -> int:
    """The fewest CTAs a sample the general route starts from: at most 32
    channels a CTA and B x CL at least the card's SMs (`general_geometry`
    takes more, up to 8 and then 16, where a sample's h or dgates would not
    fit shared memory).  The results do not depend on it: every output's
    sums run in the same order whichever CTA owns it."""
    return min(max(_ceil(feat, 32), _ceil(SMS, max(batch, 1))), _GEN_MAX_CLUSTER)


def _gen_tile_bytes(es: int) -> int:
    """Bytes of one k-block x n8 weight tile of the recurrences in fragment
    order: bf16, or an f32 weight as it is (the f64 tensor cores)."""
    return 256 if es == 2 else 512


def _gen_pass_tiles(p: int, mb: int, nt: int):
    """The n8 tiles [lo, hi) pass p touches (8 blocks a pass, m fastest)."""
    blocks = mb * _ceil(nt, 4)
    first = p * _GEN_WARPS
    last = min(blocks, first + _GEN_WARPS) - 1
    return first // mb * 4, min(nt, (last // mb + 1) * 4)


def _gen_plan(hw: int, nt: int, nkb: int, tile_bytes: int) -> dict:
    mb = _ceil(hw, 32)
    passes = _ceil(mb * _ceil(nt, 4), _GEN_WARPS)
    pass_tiles = max(hi - lo for lo, hi in (_gen_pass_tiles(p, mb, nt) for p in range(passes)))
    kb_bytes = pass_tiles * tile_bytes
    pbk = max(1, min(4, 8192 // kb_bytes))
    return {"nkb": nkb, "nt": nt, "mb": mb, "passes": passes, "pass_tiles": pass_tiles,
            "pbk": pbk, "stage_bytes": pbk * kb_bytes}


def general_wgrad_splits(rows: int, cin: int, feat: int) -> int:
    """Split-K of the general route's weight GEMM over `rows` rows (64
    channels of one segment x 128 columns a CTA): about two CTAs an SM,
    each split at least 8 slabs of 32 rows."""
    tiles = (_ceil(cin, _GEN_WG_BM) + 9 * _ceil(feat, _GEN_WG_BM)) * _ceil(4 * feat, _GEN_WG_BN)
    return max(1, min(_ceil(2 * SMS, tiles), rows // (8 * _GEN_WG_BK)))


@functools.lru_cache(maxsize=None)
def general_geometry(batch, t_len, height, width, cin, feat, es: int = 2) -> dict:
    """The general kernels' launch geometry at (B, T, H, W, C, F) (C = 0
    for K6; only the weight GEMM's split depends on C) for activations of
    `es` bytes: the cluster (the fewest CTAs a
    sample from `general_cluster` up to 8, then 16, that keeps h's copy,
    the dgates tile and the partials in shared memory; else 16), the
    forward's and the BPTT's GEMM plans (k-blocks, n8 tiles, passes,
    k-blocks a ring slab, slab bytes), what each keeps in shared memory,
    its bytes and its global scratch, and the weight GEMM's split and
    shared memory.  Cached: callers read the dict and never change it."""
    top = min(_GEN_MAX_CLUSTER, feat)
    cl = min(general_cluster(batch, feat), top)
    while True:
        geo = _general_geometry_cl(batch, t_len, height, width, cin, feat, es, cl)
        if (geo["hbuf"] and geo["dg_res"] and geo["part_res"]) or cl == top:
            return geo
        cl = min(cl + 1 if cl < 8 else _GEN_MAX_CLUSTER, top)


def _general_geometry_cl(batch, t_len, height, width, cin, feat, es, cl) -> dict:
    hw, halo = height * width, (height + 2) * (width + 2)
    nc = _ceil(feat, cl)
    fp = _up(feat, 16)
    cells = hw * nc
    f = _gen_plan(hw, _ceil(4 * nc, 8), 9 * fp // 16, _gen_tile_bytes(es))
    fs = _gen_stride(fp, es)
    used = _up128(_GEN_STAGES * f["stage_bytes"])
    state = _up128(cells * 4) + _up128(cells * es)
    state_res = used + state <= SMEM_LIMIT
    used += state if state_res else 0
    hb = _up128(halo * fs * es)
    hbuf = 2 if used + 2 * hb <= SMEM_LIMIT else 1 if used + hb <= SMEM_LIMIT else 0
    used += hbuf * hb
    gb = _up128(4 * cells * es)  # the saving forward's gates, staged where they fit
    gst_res = state_res and used + gb <= SMEM_LIMIT
    used += gb if gst_res else 0
    fwd_scratch = ((0 if state_res else _up128(batch * cl * cells * 4) + _up128(
        batch * cl * cells * es)) + (0 if hbuf else _up128(batch * 2 * halo * fs * es)))
    kt = _up(4 * nc, 16)
    ks = _gen_stride(kt, es)
    fq = _up(feat, 8)
    fq += (40 - fq % 32) % 32
    bp = _gen_plan(hw, _ceil(feat, 8), 9 * kt // 16, _gen_tile_bytes(es))
    used_b = _up128(_GEN_STAGES * bp["stage_bytes"]) + _GEN_RED_BYTES
    carry = _up128(cells * 4)
    carry_res = used_b + 2 * carry <= SMEM_LIMIT
    used_b += 2 * carry if carry_res else 0
    dgb = _up128(halo * ks * es)
    dg_res = used_b + dgb <= SMEM_LIMIT
    used_b += dgb if dg_res else 0
    pb = _up128(hw * fq * 4)
    part_res = used_b + pb <= SMEM_LIMIT
    used_b += pb if part_res else 0
    bwd_scratch = ((0 if carry_res else 2 * _up128(batch * cl * cells * 4))
                   + (0 if dg_res else _up128(batch * cl * halo * ks * es))
                   + (0 if part_res else _up128(batch * cl * hw * fq * 4)))
    return {
        "cluster": cl, "nc": nc, "ctas": batch * cl, "feat_pad": fp,
        "fwd": f, "h_stride": fs, "state_res": int(state_res), "hbuf": hbuf,
        "gst_res": int(gst_res),
        "fwd_smem": used, "fwd_scratch": fwd_scratch,
        "fwd_stages": _GEN_STAGES, "bwd_stages": _GEN_STAGES,
        "bwd": bp, "tap_k": kt, "dg_stride": ks, "part_stride": fq,
        "carry_res": int(carry_res), "dg_res": int(dg_res), "part_res": int(part_res),
        "bwd_smem": used_b, "bwd_scratch": bwd_scratch,
        "wgrad_splits": general_wgrad_splits(batch * t_len * hw, cin, feat),
        "wgrad_smem": _GEN_STAGES * _GEN_WG_BK * (2 * _GEN_WG_PAD + _GEN_WG_BM + _GEN_WG_BN) * es,
    }


def _general_layout_tuple(geo: dict) -> tuple:
    """The numbers `mmvae_convlstm_general_layout` returns, from a
    `general_geometry` dict."""
    f, b = geo["fwd"], geo["bwd"]
    return (geo["cluster"], geo["nc"], f["nkb"], f["nt"], f["passes"], f["pbk"],
            f["stage_bytes"], geo["state_res"], geo["hbuf"], geo["gst_res"], geo["fwd_smem"],
            geo["fwd_scratch"], b["nkb"], b["nt"], b["passes"], b["pbk"], b["stage_bytes"],
            geo["carry_res"], geo["dg_res"], geo["part_res"], geo["bwd_smem"],
            geo["bwd_scratch"], geo["wgrad_smem"])


@functools.lru_cache(maxsize=None)
def _general_layout(batch, t_len, height, width, cin, feat, es: int):
    """`general_geometry` at the shape, held against the library's
    (`mmvae_convlstm_general_layout`, and its weight GEMM split) once a
    shape: a difference raises."""
    geo = general_geometry(batch, t_len, height, width, cin, feat, es)
    want = _general_layout_tuple(geo)
    got = (ctypes.c_longlong * len(want))()
    lib = _build.library()
    lib.mmvae_convlstm_general_layout(batch, height, width, feat, _ACT_CODE[es], got)
    splits = lib.mmvae_convlstm_general_splits(batch * t_len * height * width, cin, feat)
    if tuple(got) != want or splits != geo["wgrad_splits"]:
        raise RuntimeError(f"convlstm general: kernel geometry {tuple(got)} (splits {splits}) "
                           f"differs from the wrapper's {want} ({geo['wgrad_splits']})")
    return geo


def _activations(named) -> torch.dtype:
    """The tensors' one dtype, or the first that differs from the first's
    (which `check_domain` then refuses, or the kernels would read it wrong)."""
    first = named[0][1].dtype
    odd = next((t.dtype for _, t in named if t.dtype != first), None)
    if odd is not None:
        raise TypeError(f"the CUDA kernels take one activation dtype; got {first} and {odd}")
    return first


# The launch geometry of K5 and K6, as `csrc/convlstm_wgmma.cuh`
# (rec_cluster, fwd_smem_layout, bwd_layout, wgrad_bn, wgrad_smem,
# wgrad_f32_bn, wgrad_f32_smem) computes it: a change to one is made in
# both; the wrappers hold them equal, asking the library once per (C, F,
# element size) for K5 (`_layouts`) and once per (F, element size) for K6
# (`_scan_layouts`).  One cluster of 2 CTAs per sample up to F = 128, of 4
# beyond, each CTA F/CL channels of every gate; shared memory per CTA for
# the forward (weight ring of FWD_ROWS-row slabs of the CTA's 4F/CL
# columns, K5's two x tiles, two whole h tiles, residual staging; K6 holds
# xg in registers), the BPTT (ring of BWD_ROWS-row slabs, half that with 4
# CTAs; the whole dgates tile, the residuals, K5's dbx warp partials or, in
# a 2-CTA cluster, the f32 dgates sum of K6's time-constant xg, which a
# 4-CTA cluster keeps in global memory) and the weight gradient.  With f32
# activations (`es` = 4, the element size) the tiles are twice as large, a
# weight takes 8 ring bytes (its TF32 hi and lo parts), slots hold 8 rows
# (forward) and 32 (BPTT), nothing is staged (the residuals go out and come
# in through registers), K6's dgates sum lives in global memory, and the
# weight GEMM has its own tiles (`_WF_*`).
SMEM_LIMIT = 232448  # bytes one CTA may use on the H100 (227 KB)
SMS = 132
_MROWS, _MIN_STAGES, _MAX_STAGES = 64, 4, 8
SCAN_BWD_MIN_STAGES = 3  # K6's BPTT with a time-constant xg
_FWD_ROWS, _BWD_ROWS, _DX_BLOCK = 32, 128, 64
_FWD_ROWS_F32, _BWD_ROWS_F32 = 8, 32
_WG_BM, _WG_BK, _WG_STAGES = 128, 64, 4
_WF_BK, _WF_STAGES, _WF_APAD = 32, 2, 4


def _round128(v: int) -> int:
    return (v + 127) // 128 * 128


def cluster_size(feat: int) -> int:
    """CTAs a sample (`rec_cluster`): 2 up to F = 128, 4 beyond, where two
    CTAs' weight slabs, residual staging and rings no longer fit.  f32
    activations, which take F <= 128, fit two CTAs because they stage
    nothing."""
    return 4 if feat > 128 else 2


def _bwd_rows(feat: int, es: int = 2) -> int:
    if es == 4:
        return _BWD_ROWS_F32
    return _BWD_ROWS if cluster_size(feat) == 2 else _BWD_ROWS // 2


def _weight_bytes(es: int) -> int:
    """Ring bytes of one weight: bf16, or an f32 weight's two TF32 parts."""
    return 8 if es == 4 else 2


def _stages(fixed: int, slot: int) -> int:
    return min(_MAX_STAGES, (SMEM_LIMIT - fixed) // slot)


def _fwd_fixed(cin: int, feat: int, x_tiles: bool = True, es: int = 2) -> int:
    """The forward's shared memory besides its ring (K6 has no x tiles;
    rows of the x tiles padded by 16 bytes; only bf16 stages residuals)."""
    hf = feat // cluster_size(feat)
    inputs = 2 * _round128((_MROWS + 1) * (cin + 16 // es) * es) if x_tiles else 0
    staging = _MROWS * 6 * hf * 2 if es == 2 else 0
    return 1280 + inputs + 2 * _round128((_MROWS + 1) * feat * es) + staging


def _fwd_slot(feat: int, es: int = 2) -> int:
    rows = _FWD_ROWS if es == 2 else _FWD_ROWS_F32
    return rows * 4 * (feat // cluster_size(feat)) * _weight_bytes(es)


def _bwd_fixed(feat: int, tail: int, es: int = 2) -> int:
    """The BPTT's shared memory besides its ring."""
    hf = feat // cluster_size(feat)
    res = _MROWS * 6 * hf * 2 if es == 2 else 0
    return 256 + _round128((_MROWS + 1) * 4 * feat * es) + res + tail


def _wgrad_geometry(rows: int, m: int, feat: int, es: int = 2) -> dict:
    """The weight GEMM over `rows` rows of the dgates scratch for an M x 4F
    gradient: tile width, tiles, split-K (as many splits as fill the card's
    SMs, at least 8 stages of rows each) and shared memory."""
    if es == 4:
        bn, bk = (128 if 4 * feat >= 128 else 64), _WF_BK
        smem = _WF_STAGES * (bk * (_WG_BM + _WF_APAD) * 4 + 2 * bk * bn * 4) + 256
    else:
        bn, bk = (256 if 4 * feat >= 256 else 64), _WG_BK
        smem = _WG_STAGES * (bk * _WG_BM * 2 + bk * bn * 2) + 256
    tiles = -(-m // _WG_BM) * -(-4 * feat // bn)
    splits = max(1, min(SMS // tiles, rows // (8 * bk)))
    return {
        "wgrad_bn": bn, "wgrad_tiles": tiles, "wgrad_splits": splits,
        "wgrad_rows_per_split": -(-(-(-rows // splits)) // bk) * bk,
        "wgrad_smem": smem,
    }


def _es(dtype: torch.dtype) -> int:
    return 4 if dtype == torch.float32 else 2


@functools.lru_cache(maxsize=None)
def proj_geometry(batch, t_len, height, width, cin, feat, es: int = 2) -> dict:
    """The K5 kernels' launch geometry at (B, T, H, W, C, F) for activations
    of `es` bytes (2: bf16, 4: f32): CTAs, ring stages and bytes, shared
    memory per CTA, the weight GEMM's tile width and split-K.  Cached:
    callers read the dict and never change it."""
    cl = cluster_size(feat)
    hf = feat // cl
    f_slot, f_fixed = _fwd_slot(feat, es), _fwd_fixed(cin, feat, es=es)
    b_slot = _bwd_rows(feat, es) * _DX_BLOCK * _weight_bytes(es)
    b_fixed = _bwd_fixed(feat, 4 * 4 * hf * 4, es)
    f_stages, b_stages = _stages(f_fixed, f_slot), _stages(b_fixed, b_slot)
    return {
        "cluster": cl, "clusters": batch, "ctas": cl * batch,
        "fwd_stages": f_stages, "fwd_slot_bytes": f_slot,
        "fwd_ring_bytes": f_stages * f_slot, "fwd_smem": f_fixed + f_stages * f_slot,
        "bwd_stages": b_stages, "bwd_slot_bytes": b_slot,
        "bwd_ring_bytes": b_stages * b_slot, "bwd_smem": b_fixed + b_stages * b_slot,
        "dx_blocks": -(-(cin // cl) // _DX_BLOCK),
        **_wgrad_geometry(batch * t_len * height * width, cin + 9 * feat, feat, es),
    }


@functools.lru_cache(maxsize=None)
def scan_geometry(batch, t_len, height, width, feat, const_input, es: int = 2) -> dict:
    """The K6 kernels' launch geometry at (B, T, H, W, F) for a
    time-constant xg (a 2-CTA bf16 BPTT keeps a (64, 2F) f32 dgates sum in
    shared memory, a 4-CTA or f32 one a (B, CL, 64, 4F/CL) f32 scratch in
    global memory, `dxs_scratch_floats`) or a streaming one, for activations
    of `es` bytes: CTAs, ring stages and bytes, shared memory per CTA, the
    fewest BPTT stages the kernel takes, and the weight GEMM's (K5's with C
    = 0).  Cached like `proj_geometry`."""
    cl = cluster_size(feat)
    hf = feat // cl
    sum_in_smem = const_input and cl == 2 and es == 2
    f_slot, f_fixed = _fwd_slot(feat, es), _fwd_fixed(0, feat, x_tiles=False, es=es)
    b_slot = _bwd_rows(feat, es) * hf * _weight_bytes(es)  # rows of the CTA's F/CL columns
    b_fixed = _bwd_fixed(feat, _MROWS * 4 * hf * 4 if sum_in_smem else 0, es)
    f_stages, b_stages = _stages(f_fixed, f_slot), _stages(b_fixed, b_slot)
    return {
        "cluster": cl, "clusters": batch, "ctas": cl * batch,
        "fwd_stages": f_stages, "fwd_slot_bytes": f_slot,
        "fwd_ring_bytes": f_stages * f_slot, "fwd_smem": f_fixed + f_stages * f_slot,
        "bwd_stages": b_stages, "bwd_slot_bytes": b_slot,
        "bwd_ring_bytes": b_stages * b_slot, "bwd_smem": b_fixed + b_stages * b_slot,
        "bwd_min_stages": SCAN_BWD_MIN_STAGES if sum_in_smem else _MIN_STAGES,
        "dxs_scratch_floats": (batch * _MROWS * 4 * feat
                               if const_input and not sum_in_smem else 0),
        **_wgrad_geometry(batch * t_len * height * width, 9 * feat, feat, es),
    }


def _check_cuda(x, wx, w, c0, h0, *more):
    """Raise unless the tensors suit the K5 kernels (on the card, one
    activation dtype, bf16 or f32, consistent shapes); return the library,
    the wgmma geometry (None on the general route) and the route."""
    named = (("x", x), ("wx", wx), ("w", w), ("c0", c0), ("h0", h0), *more)
    _require_cuda("convlstm_scan_proj", named)
    batch, t_len, height, width, cin = x.shape
    f4 = wx.shape[1]
    feat = f4 // 4
    if (wx.shape != (cin, f4) or w.shape != (3, 3, feat, f4)
            or c0.shape != (batch, height, width, feat) or h0.shape != c0.shape):
        raise ValueError(
            f"convlstm_scan_proj: inconsistent shapes x {tuple(x.shape)} wx "
            f"{tuple(wx.shape)} w {tuple(w.shape)} c0 {tuple(c0.shape)} h0 {tuple(h0.shape)}"
        )
    act = _activations(named)
    way = _checked_route(act, feat, height * width, cin)
    lib = _build.library()
    if way == "general":
        return lib, None, way
    es = _es(act)
    geo = proj_geometry(batch, t_len, height, width, cin, feat, es)
    got, want = _layouts(cin, feat, es)
    if got != want:
        raise RuntimeError(f"convlstm_scan_proj: kernel geometry {got} differs from "
                           f"the wrapper's {want}")
    return lib, geo, way


@functools.lru_cache(maxsize=None)
def _checked_route(act: torch.dtype, feat: int, hw: int, cin=None) -> str:
    """`route`, held once per shape against the library's
    (`mmvae_convlstm_route`): a difference raises."""
    way = route(act, feat, hw, cin)
    got = _build.library().mmvae_convlstm_route(_DTYPE_CODE[act], feat, hw, cin or 0)
    if got != (1 if way == "general" else 0):
        raise RuntimeError(f"convlstm: the library routes F={feat}, H*W={hw}, C={cin} ({act}) "
                           f"to {got}, the wrapper to {way}")
    return way


_LAYOUT_KEYS = ("fwd_stages", "fwd_smem", "bwd_stages", "bwd_smem", "wgrad_bn", "wgrad_smem",
                "cluster")
_ACT_CODE = {2: 1, 4: 0}  # element size -> the library's dtype code (_DTYPE_CODE)


@functools.lru_cache(maxsize=None)
def _layouts(cin: int, feat: int, es: int = 2):
    """(the kernels' shared-memory layout at (C, F) for `es`-byte
    activations, `proj_geometry`'s): asked of the library once per (C, F,
    es)."""
    got = (ctypes.c_int * len(_LAYOUT_KEYS))()
    _build.library().mmvae_convlstm_proj_layout(cin, feat, _ACT_CODE[es], got)
    geo = proj_geometry(1, 1, 8, 8, cin, feat, es)  # the layout depends on C, F and es alone
    return tuple(got), tuple(geo[k] for k in _LAYOUT_KEYS)


def pack_cores(mat: torch.Tensor, kc: int = 8) -> torch.Tensor:
    """(K, N) -> K-major wgmma cores [K/kc][N/8][8 n][kc k]: core (c, nb)
    holds mat[kc c + k][8nb + n] at [c][nb][n][k], 128 contiguous bytes in
    bf16 (kc = 8) and in f32 (kc = 4, the TF32 cores)."""
    k, n = mat.shape[-2:]
    lead = mat.shape[:-2]
    return mat.reshape(*lead, k // kc, kc, n // 8, 8).movedim(-3, -1).contiguous()


def unpack_cores(pk: torch.Tensor) -> torch.Tensor:
    """The inverse of `pack_cores`."""
    kc, nb, _, kk = pk.shape[-4:]
    return pk.movedim(-1, -3).reshape(*pk.shape[:-4], kc * kk, nb * 8)


def _pack(mat: torch.Tensor, tf32_parts: bool) -> torch.Tensor:
    """(..., K, N) as `pack_cores` (the bf16 kernels' cores), or for the f32
    kernels (`tf32_parts`) as the TF32 cores of its hi part, then of its lo
    part (`tf32_split`), stacked on a new first axis: the kernels read lo
    at hi's offset plus all of hi."""
    if not tf32_parts:
        return pack_cores(mat)
    return torch.stack([pack_cores(part, kc=4) for part in tf32_split(mat)])


def consumer_groups(feat: int) -> int:
    """Consumer warpgroups of a K5 or K6 forward CTA (`rec_wgs` in
    convlstm_wgmma.cuh): two when each owns a multiple of 8 of the CTA's
    F/CL channels."""
    return 2 if (feat // cluster_size(feat)) % 16 == 0 else 1


def pack_proj_forward(wx: torch.Tensor, w: torch.Tensor, tf32_parts: bool = False):
    """[Wx; W] ((C + 9F) x 4F) cut for the CL CTAs of a cluster: rank r
    keeps channels [r F/CL, (r + 1) F/CL) of each gate, 4F/CL columns
    ordered (warpgroup, gate, channel), each consumer warpgroup's F/CL /
    groups channels of the four gates together; (CL, K/8, 4F/CL/8, 8, 8),
    or for the f32 kernels (2, CL, K/4, 4F/CL/8, 8, 4) (`_pack`)."""
    cin, f4 = wx.shape
    feat = f4 // 4
    cl, nwg = cluster_size(feat), consumer_groups(feat)
    full = torch.cat([wx, w.reshape(9 * feat, f4)])
    k = full.shape[0]
    per_rank = full.view(k, 4, cl, nwg, feat // cl // nwg).permute(2, 0, 3, 1, 4)
    return _pack(per_rank.reshape(cl, k, f4 // cl), tf32_parts)


def pack_hidden_backward(w: torch.Tensor, tf32_parts: bool = False) -> torch.Tensor:
    """The BPTT's dh slabs per rank (K5 and K6): W^T with rows (tap, n) and
    the rank's F/CL columns, (CL, 9*4F/8, F/CL/8, 8, 8), or for the f32
    kernels (2, CL, 9*4F/4, F/CL/8, 8, 4)."""
    f4 = w.shape[-1]
    feat = f4 // 4
    cl = cluster_size(feat)
    wt = w.reshape(9, feat, f4).transpose(1, 2).reshape(9 * f4, feat)
    return _pack(wt.view(9 * f4, cl, feat // cl).permute(1, 0, 2), tf32_parts)


def pack_proj_backward(wx: torch.Tensor, w: torch.Tensor, tf32_parts: bool = False):
    """K5's BPTT slabs per rank: `pack_hidden_backward(w)`, and Wx^T (rows
    n) with the rank's C/CL columns in zero-padded blocks of 64, (CL,
    blocks, 4F/8, 8, 8, 8), or for the f32 kernels (2, CL, blocks, 4F/4, 8,
    8, 4)."""
    cin, f4 = wx.shape
    cl = cluster_size(f4 // 4)
    cr = cin // cl
    blocks = -(-cr // _DX_BLOCK)
    wxt = wx.t().reshape(f4, cl, cr).permute(1, 0, 2)
    wxt = F.pad(wxt, (0, blocks * _DX_BLOCK - cr)).view(cl, f4, blocks, _DX_BLOCK)
    return (pack_hidden_backward(w, tf32_parts),
            _pack(wxt.permute(0, 2, 1, 3), tf32_parts))


# The general kernels' B fragment schemes: "bf16"; f32 as TF32 (hi, lo)
# parts ("tf32", K5's dx) or as they are for the f64 tensor cores ("f64",
# the recurrences and K5's x projection).
def pack_fragments(mat: torch.Tensor, scheme: str) -> torch.Tensor:
    """(..., K, N) with K a multiple of 16 and N of 8 -> the mma.sync B
    fragments the general kernels read, one 16-deep k-block and n8 tile
    after another, lane g * 4 + tq's registers together: "bf16" (..., K/16,
    N/8, 8 g, 4 tq, 2 r, 2 e) holding mat[16 kb + 8 r + 2 tq + e][8 j + g];
    "tf32" (..., K/16, N/8, 8 g, 4 tq, 2 h, 2 part, 2 r) holding part (TF32
    hi, lo) of mat[16 kb + 8 h + 4 r + tq][8 j + g]; "f64" (..., K/16, N/8,
    8 g, 4 tq, 4 s) f32 holding mat[16 kb + 4 s + tq][8 j + g] (the B
    fragment of an f64 m16n8k16, converted in the kernel)."""
    k, n = mat.shape[-2:]
    lead = mat.shape[:-2]
    d = len(lead)
    if scheme == "bf16":
        v = mat.to(torch.bfloat16).reshape(*lead, k // 16, 2, 4, 2, n // 8, 8)
        return v.permute(*range(d), d, d + 4, d + 5, d + 2, d + 1, d + 3).contiguous()
    if scheme == "tf32":
        parts = torch.stack(tf32_split(mat.float()), -3)  # (..., 2, K, N)
        v = parts.reshape(*lead, 2, k // 16, 2, 2, 4, n // 8, 8)
        return v.permute(*range(d), d + 1, d + 5, d + 6, d + 4, d + 2, d, d + 3).contiguous()
    v = mat.float().reshape(*lead, k // 16, 4, 4, n // 8, 8)
    return v.permute(*range(d), d, d + 3, d + 4, d + 2, d + 1).contiguous()


def unpack_fragments(pk: torch.Tensor, scheme: str) -> torch.Tensor:
    """The inverse of `pack_fragments`, as f32 (the parts summed)."""
    if scheme == "bf16":
        kb, nt = pk.shape[-6:-4]
        d = pk.dim() - 6
        v = pk.permute(*range(d), d, d + 4, d + 3, d + 5, d + 1, d + 2)
        return v.reshape(*pk.shape[:-6], kb * 16, nt * 8).float()
    if scheme == "f64":
        kb, nt = pk.shape[-5:-3]
        d = pk.dim() - 5
        v = pk.permute(*range(d), d, d + 4, d + 3, d + 1, d + 2)
        return v.reshape(*pk.shape[:-5], kb * 16, nt * 8).float()
    kb, nt = pk.shape[-7:-5]
    d = pk.dim() - 7
    v = pk.permute(*range(d), d + 5, d, d + 4, d + 6, d + 3, d + 1, d + 2)
    v = v.reshape(*pk.shape[:-7], 2, kb * 16, nt * 8)
    return v[..., 0, :, :] + v[..., 1, :, :]


@functools.lru_cache(maxsize=None)
def _general_columns(feat: int, cl: int, device) -> torch.Tensor:
    """(cl, 4 nc padded to 8) indices into the gate-major columns (q F +
    ch) of the general kernels' columns: rank r's channels interleaved (4 lc
    + q), 4F (a zero column) where a rank has fewer than nc or the tile's
    padding."""
    nc = _ceil(feat, cl)
    idx = torch.full((cl, _up(4 * nc, 8)), 4 * feat, dtype=torch.long)
    for r in range(cl):
        lo, hi = feat * r // cl, feat * (r + 1) // cl
        for lc in range(hi - lo):
            for q in range(4):
                idx[r, 4 * lc + q] = q * feat + lo + lc
    return idx.to(device)


def _by_rank(mat: torch.Tensor, feat: int, cl: int) -> torch.Tensor:
    """(..., 4F) gate-major columns -> (cl, ..., 4 nc padded to 8): each
    rank's columns in the general kernels' order, zero in the padding."""
    idx = _general_columns(feat, cl, mat.device)
    full = F.pad(mat, (0, 1))  # column 4F is zero
    return full[..., idx].movedim(-2, 0)


def _fwd_scheme(w: torch.Tensor) -> str:
    return "f64" if w.dtype == torch.float32 else "bf16"


def pack_general_forward(w: torch.Tensor, cl: int) -> torch.Tensor:
    """W for the general forward: each tap's F rows padded to a multiple of
    16, rank r's columns (`_by_rank`), in fragment order: (cl, 9 F/16, N/8,
    ...) (`pack_fragments`, f32 weights for the f64 tensor cores)."""
    f4 = w.shape[-1]
    feat = f4 // 4
    taps = F.pad(w.reshape(9, feat, f4), (0, 0, 0, _up(feat, 16) - feat))
    return pack_fragments(_by_rank(taps.reshape(-1, f4), feat, cl), _fwd_scheme(w))


def pack_general_xproj(wx: torch.Tensor) -> torch.Tensor:
    """Wx (C x 4F, padded to 16 x 8, gate-major columns) in fragment order
    for K5's x projection (as the forward's weights)."""
    cin, f4 = wx.shape
    return pack_fragments(F.pad(wx, (0, _up(f4, 8) - f4, 0, _up(cin, 16) - cin)), _fwd_scheme(wx))


def _bytes(*ts: torch.Tensor) -> torch.Tensor:
    """The tensors' bytes, one after another."""
    return torch.cat([t.reshape(-1).view(torch.uint8) for t in ts])


def pack_general_backward(w: torch.Tensor, cl: int) -> torch.Tensor:
    """W^T for the general BPTT's transposed taps: rank r's rows (tap, its
    4 nc dgate columns in the kernels' order, padded to 16) against all F
    channels (padded to 8), in fragment order: (cl, 9 Kt/16, F/8, ...),
    f32 weights for the f64 tensor cores."""
    f4 = w.shape[-1]
    feat = f4 // 4
    cols = _by_rank(w.reshape(9, feat, f4), feat, cl)  # (cl, 9, F, 4 nc up 8)
    kt = _up(cols.shape[-1], 16)
    wt = F.pad(cols.transpose(-1, -2), (0, _up(feat, 8) - feat, 0, kt - cols.shape[-1]))
    return pack_fragments(wt.reshape(cl, 9 * kt, -1), _fwd_scheme(w))


def pack_general_dx(wx: torch.Tensor) -> torch.Tensor:
    """Wx^T (4F x C, padded to 16 x 8) in fragment order for K5's dx (f32:
    TF32 hi and lo parts)."""
    cin, f4 = wx.shape
    wxt = F.pad(wx.t(), (0, _up(cin, 8) - cin, 0, _up(f4, 16) - f4))
    return pack_fragments(wxt, _scheme(wx))


def _scheme(w: torch.Tensor) -> str:
    return "tf32" if w.dtype == torch.float32 else "bf16"


def _general_scratch(nbytes: int, device):
    """The general kernels' global scratch (what did not fit shared
    memory, `general_geometry`), or None."""
    return torch.empty(nbytes, device=device, dtype=torch.uint8) if nbytes else None


def _count(fn, way: str, mode=None) -> None:
    """One launch of wrapper `fn` on route `way` (and, for a forward, in
    `mode`)."""
    fn.launches += 1
    fn.routes[way] += 1
    if mode is not None:
        fn.modes[mode] += 1


@_build.on_device
def proj_forward_cuda(x, wx, bx, w, c0, h0, gate_dtype, save: bool):
    """CUDA forward; same contract as `proj_forward_plain`."""
    lib, _, way = _check_cuda(x, wx, w, c0, h0, ("bx", bx))
    if bx.shape != wx.shape[1:]:
        raise ValueError(f"convlstm_scan_proj: bx {tuple(bx.shape)}, wx {tuple(wx.shape)}")
    if gate_dtype not in _DTYPE_CODE:
        raise TypeError(f"convlstm_scan_proj: gate dtype {gate_dtype} not supported")
    batch, t_len, height, width, cin = x.shape
    f4 = wx.shape[1]
    feat = f4 // 4
    hw = height * width
    x, bx, c0, h0 = (t.contiguous() for t in (x, bx, c0, h0))
    kw = dict(device=x.device, dtype=x.dtype)
    if save:
        outs = (torch.empty(batch, t_len, hw, feat, **kw),
                torch.empty(batch, t_len, hw, feat, **kw),
                torch.empty(batch, t_len, hw, f4, **kw))
        ptrs = [o.data_ptr() for o in outs]
    else:
        outs = (torch.empty(batch, hw, feat, **kw), torch.empty(batch, hw, feat, **kw))
        ptrs = [outs[0].data_ptr(), outs[1].data_ptr(), None]
    gcl, scratch = 0, None
    if way == "general":
        geo = _general_layout(batch, t_len, height, width, cin, feat, _es(x.dtype))
        gcl = geo["cluster"]
        # the recurrence's W, then Wx for the x projection; the scratch holds
        # the projection (B T H W x 4F in the gate dtype), then the
        # recurrence's own
        wpk = _bytes(pack_general_forward(w, gcl), pack_general_xproj(wx))
        xg_bytes = _up(batch * t_len * hw * f4 * _es(gate_dtype), 256)
        bx, scratch = bx.float(), _general_scratch(xg_bytes + geo["fwd_scratch"], x.device)
    else:
        wpk = pack_proj_forward(wx, w, x.dtype == torch.float32)
    err = lib.mmvae_convlstm_proj_fwd(
        x.data_ptr(), wpk.data_ptr(), bx.data_ptr(), c0.data_ptr(), h0.data_ptr(),
        *ptrs, batch, t_len, height, width, cin, feat, _DTYPE_CODE[gate_dtype],
        int(save), _DTYPE_CODE[x.dtype], gcl, None if scratch is None else scratch.data_ptr(),
        _build.stream_ptr(x.device),
    )
    _build.check(err, "convlstm_proj_fwd")
    _count(convlstm_proj_forward, way, "save" if save else "nores")
    return outs


@_build.on_device
def proj_backward_cuda(x, wx, w, c0, h0, hs, cs, ga, dh_last, dc_last):
    """CUDA backward (BPTT with dx and dbx, then the weight-gradient GEMM);
    same contract as `proj_backward_plain`."""
    lib, geo, way = _check_cuda(x, wx, w, c0, h0, ("hs", hs), ("cs", cs), ("ga", ga))
    act = x.dtype
    batch, t_len, height, width, cin = x.shape
    f4 = wx.shape[1]
    feat = f4 // 4
    hw = height * width
    gcl, scratch = 0, None
    if way == "general":
        geo = _general_layout(batch, t_len, height, width, cin, feat, _es(x.dtype))
        gcl, splits = geo["cluster"], geo["wgrad_splits"]
        wtpk, wxpk = pack_general_backward(w, gcl), pack_general_dx(wx)
        scratch = _general_scratch(geo["bwd_scratch"], x.device)
    else:
        wtpk, wxpk = pack_proj_backward(wx, w, x.dtype == torch.float32)
        splits = geo["wgrad_splits"]
    x, c0, h0, hs, cs, ga = (t.contiguous() for t in (x, c0, h0, hs, cs, ga))
    dhl = dh_last.to(act).contiguous()
    dcl = dc_last.to(act).contiguous()
    dev = x.device
    stream = _build.stream_ptr(dev)
    # the dgates scratch in the activation dtype: bf16, or f32 as JAX rounds
    # dgates to the weights' dtype
    d_gates = torch.empty(batch, t_len, hw, f4, device=dev, dtype=act)
    dx = torch.empty(batch, t_len, hw, cin, device=dev, dtype=act)
    db_part = torch.empty(batch, f4, device=dev, dtype=torch.float32)
    db_out = torch.empty(f4, device=dev, dtype=torch.float32)
    dc0 = torch.empty(batch, hw, feat, device=dev, dtype=act)
    dh0 = torch.empty_like(dc0)
    err = lib.mmvae_convlstm_proj_bwd(
        wtpk.data_ptr(), wxpk.data_ptr(), c0.data_ptr(), cs.data_ptr(), ga.data_ptr(),
        dhl.data_ptr(), dcl.data_ptr(), d_gates.data_ptr(), dx.data_ptr(), db_part.data_ptr(),
        db_out.data_ptr(), dc0.data_ptr(), dh0.data_ptr(), batch, t_len, height, width, cin,
        feat, _DTYPE_CODE[act], gcl, None if scratch is None else scratch.data_ptr(), stream,
    )
    _build.check(err, "convlstm_proj_bwd")
    m = cin + 9 * feat
    dw_part = torch.empty(splits, m, f4, device=dev, dtype=torch.float32)
    dw_out = torch.empty(m, f4, device=dev, dtype=torch.float32)
    err = lib.mmvae_convlstm_wgrad(
        x.data_ptr(), hs.data_ptr(), h0.data_ptr(), d_gates.data_ptr(), dw_part.data_ptr(),
        dw_out.data_ptr(), batch, t_len, height, width, cin, feat, splits, _DTYPE_CODE[act],
        stream,
    )
    _build.check(err, "convlstm_proj_wgrad")
    _count(convlstm_proj_backward, way)
    return (
        dx.view(x.shape),
        dw_out[:cin].to(wx.dtype),
        db_out.to(wx.dtype),
        dw_out[cin:].view(3, 3, feat, f4).to(w.dtype),
        dc0.view(c0.shape),
        dh0.view(h0.shape),
    )


def convlstm_proj_forward(x, wx, bx, w, c0, h0, gate_dtype, save: bool):
    """Forward kernel for CUDA tensors, plain version for CPU tensors."""
    if x.is_cuda:
        return proj_forward_cuda(x, wx, bx, w, c0, h0, gate_dtype, save)
    return proj_forward_plain(x, wx, bx, w, c0, h0, gate_dtype, save)


def convlstm_proj_backward(x, wx, w, c0, h0, hs, cs, ga, dh_last, dc_last):
    """Backward kernels for CUDA tensors, plain version for CPU tensors."""
    if x.is_cuda:
        return proj_backward_cuda(x, wx, w, c0, h0, hs, cs, ga, dh_last, dc_last)
    return proj_backward_plain(x, wx, w, c0, h0, hs, cs, ga, dh_last, dc_last)


convlstm_proj_forward.launches = 0
# launches by forward mode: "save" keeps the residuals for a backward,
# "nores" (no grad) only the terminal state
convlstm_proj_forward.modes = {"save": 0, "nores": 0}
convlstm_proj_backward.launches = 0


class _ScanProjLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wx, bx, w, c0, h0, gate_dtype):
        hs, cs, ga = convlstm_proj_forward(x, wx, bx, w, c0, h0, gate_dtype, True)
        ctx.save_for_backward(x, wx, w, c0, h0, hs, cs, ga)
        return hs[:, -1].clone(), cs[:, -1].clone()

    @staticmethod
    def backward(ctx, dh_last, dc_last):
        x, wx, w, c0, h0, hs, cs, ga = ctx.saved_tensors
        grads = convlstm_proj_backward(x, wx, w, c0, h0, hs, cs, ga, dh_last, dc_last)
        return (*grads, None)


def convlstm_scan_proj(
    x: torch.Tensor,
    wx: torch.Tensor,
    bx: torch.Tensor,
    w: torch.Tensor,
    c0: torch.Tensor,
    h0: torch.Tensor,
    *,
    gate_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ConvLSTM recurrence with the 1x1 input projection inside the kernel.

    x: (B, T, H, W, C); wx: (C, 4F); bx: (4F,); w: (3, 3, F, 4F) HWIO;
    c0, h0: (B, H, W, F); all one dtype.  Returns (c_T, h_T), each
    (B, H, W, F).  Differentiable wrt all six tensors."""
    shape = c0.shape
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, wx, bx, w, c0, h0)
    ):
        h_last, c_last = _ScanProjLast.apply(x, wx, bx, w, c0, h0, gate_dtype)
    else:
        h_last, c_last = convlstm_proj_forward(x, wx, bx, w, c0, h0, gate_dtype, False)
    return c_last.view(shape).to(c0.dtype), h_last.view(shape)


# ---------------------------------------------------------------------------
# K6: the hidden recurrence given xg (streaming or time-constant)
# ---------------------------------------------------------------------------

# Forward modes: "save" returns the residuals (hs, cs, gates) for a backward;
# "hs" every h_t and c_T; "last" h_T and c_T.
_SCAN_MODES = {"save": 0, "hs": 1, "last": 2}


def scan_forward_plain(xg, w, c0, h0, length, gate_dtype, mode: str, tf32_operands=False):
    """Plain forward.  xg (B, T_in, H, W, 4F), T_in = length or 1 (a
    time-constant input); w (3, 3, F, 4F) HWIO; c0, h0 (B, H, W, F).
    Returns, in xg.dtype: "save" (hs, cs, gates) shaped (B, T, HW, F),
    (B, T, HW, F), (B, T, HW, 4F); "hs" (hs, c_T); "last" (h_T, c_T), with
    c_T and h_T (B, HW, F).  `tf32_operands` as in `proj_forward_plain`."""
    act = xg.dtype
    batch, t_in, height, width, f4 = xg.shape
    feat = f4 // 4
    hw = height * width
    xg = xg.reshape(batch, t_in, hw, f4)
    op = functools.partial(_operand, act=act, tf32_operands=tf32_operands)
    w_oihw = _operand(w, None, tf32_operands).permute(3, 2, 0, 1)
    c = c0.reshape(batch, hw, feat).to(gate_dtype)
    h = h0.reshape(batch, hw, feat).to(gate_dtype)
    hs, cs, ga = [], [], []
    for t in range(length):
        hg = _hidden_conv(op(h), w_oihw, height, width)
        gates = xg[:, t if t_in > 1 else 0].to(gate_dtype) + hg.to(gate_dtype)
        i, f, g, o = _split_gates(gates, feat)
        c = f * c + i * g
        h = o * torch.tanh(c)
        if mode != "last":
            hs.append(h.to(act))
        if mode == "save":
            cs.append(c.to(act))
            ga.append(torch.cat([i, f, g, o], dim=-1).to(act))
    if mode == "save":
        return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(ga, 1)
    if mode == "hs":
        return torch.stack(hs, 1), c.to(act)
    return h.to(act), c.to(act)


def scan_backward_plain(w, c0, h0, hs, cs, ga, dh, dc_last, const_input: bool,
                        last_only: bool, tf32_operands=False):
    """Plain BPTT: reverse time, (dh, dc) carried in f32.  dh is the per-step
    cotangent of hs (B, T, HW, F), or of h_T (B, H, W, F) when `last_only`.
    Returns (dxg, dw, dc0, dh0): dxg (B, T or 1, H, W, 4F) in hs.dtype, the
    const input's being the f32 sum over t of the dgates; the rest in the
    dtypes and shapes of w, c0, h0.  `tf32_operands` as in
    `proj_forward_plain`."""
    act = hs.dtype
    batch, t_len, hw, feat = hs.shape
    height, width = c0.shape[1:3]
    f4 = 4 * feat
    op = functools.partial(_operand, act=act, tf32_operands=tf32_operands)
    w_oihw = _operand(w, None, tf32_operands).permute(3, 2, 0, 1)
    c0f = c0.reshape(batch, hw, feat).float()
    h0f = h0.reshape(batch, hw, feat).float()
    dhs = dh.reshape(batch, -1, hw, feat).to(act).float()
    carry = dhs[:, 0] if last_only else torch.zeros_like(c0f)
    dc = dc_last.reshape(batch, hw, feat).to(act).float()
    if const_input:
        dxg = torch.zeros(batch, 1, hw, f4, device=hs.device)
    else:
        dxg = torch.empty(batch, t_len, hw, f4, dtype=act, device=hs.device)
    dw = torch.zeros(f4, feat, 3, 3, device=hs.device)
    for t in range(t_len - 1, -1, -1):
        dh_t = carry if last_only else carry + dhs[:, t]
        c_t = cs[:, t].float()
        c_prev = cs[:, t - 1].float() if t > 0 else c0f
        h_prev = op(hs[:, t - 1]) if t > 0 else _operand(h0f, None, tf32_operands)
        i, f, g, o = ga[:, t].float().split(feat, dim=-1)
        tanh_ct = torch.tanh(c_t)
        do = dh_t * tanh_ct
        dct = dc + dh_t * o * (1.0 - tanh_ct * tanh_ct)
        dgates = torch.cat([
            dct * g * i * (1.0 - i),
            dct * c_prev * f * (1.0 - f),
            dct * i * (1.0 - g * g),
            do * o * (1.0 - o),
        ], dim=-1)
        dc = dct * f
        if const_input:
            dxg[:, 0] += dgates
        else:
            dxg[:, t] = dgates.to(act)
        dg_n = op(dgates).view(batch, height, width, f4).permute(0, 3, 1, 2)
        h_n = h_prev.view(batch, height, width, feat).permute(0, 3, 1, 2)
        dw += torch.nn.grad.conv2d_weight(h_n, w_oihw.shape, dg_n, padding=1)
        carry = F.conv_transpose2d(dg_n, w_oihw, padding=1).permute(0, 2, 3, 1).reshape(
            batch, hw, feat
        )
    return (
        dxg.to(act).view(batch, -1, height, width, f4),
        dw.permute(2, 3, 1, 0).contiguous().to(w.dtype),
        dc.view(c0.shape).to(c0.dtype),
        carry.view(h0.shape).to(h0.dtype),
    )


def _check_scan(w, c0, h0, t_len, const_input, **more):
    """Raise unless the tensors suit the K6 kernels (on the card, one
    activation dtype, bf16 or f32, consistent shapes); return the library,
    the wgmma geometry (None on the general route) and the route."""
    named = (("w", w), ("c0", c0), ("h0", h0), *more.items())
    _require_cuda("convlstm_scan", named)
    batch, height, width, feat = c0.shape
    if w.shape != (3, 3, feat, 4 * feat) or h0.shape != c0.shape:
        raise ValueError(f"convlstm_scan: inconsistent shapes w {tuple(w.shape)} "
                         f"c0 {tuple(c0.shape)} h0 {tuple(h0.shape)}")
    act = _activations(named)
    way = _checked_route(act, feat, height * width)
    lib = _build.library()
    if way == "general":
        return lib, None, way
    es = _es(act)
    geo = scan_geometry(batch, t_len, height, width, feat, const_input, es)
    if geo["fwd_stages"] < _MIN_STAGES or geo["bwd_stages"] < geo["bwd_min_stages"]:
        raise ValueError(f"convlstm_scan: F={feat} ({act}) leaves too few weight stages in one "
                         f"CTA's shared memory")
    got, want = _scan_layouts(feat, es)
    if got != want:
        raise RuntimeError(f"convlstm_scan: kernel geometry {got} differs from the "
                           f"wrapper's {want}")
    return lib, geo, way


@functools.lru_cache(maxsize=None)
def _scan_layouts(feat: int, es: int = 2):
    """(the K6 kernels' shared-memory layout at F for `es`-byte activations,
    `scan_geometry`'s): the forward's stages and bytes, then the BPTT's for
    a time-constant and for a streaming xg; asked of the library once per
    (F, es)."""
    got = (ctypes.c_int * 7)()
    _build.library().mmvae_convlstm_scan_layout(feat, _ACT_CODE[es], got)
    const, stream = (scan_geometry(1, 1, 8, 8, feat, c, es) for c in (True, False))
    want = (const["fwd_stages"], const["fwd_smem"], const["bwd_stages"], const["bwd_smem"],
            stream["bwd_stages"], stream["bwd_smem"], const["cluster"])
    return tuple(got), want


@_build.on_device
def scan_forward_cuda(xg, w, c0, h0, length, gate_dtype, mode: str):
    """CUDA forward; same contract as `scan_forward_plain`."""
    batch, t_in, height, width, f4 = xg.shape
    lib, _, way = _check_scan(w, c0, h0, length, t_in == 1, xg=xg)
    if gate_dtype not in _DTYPE_CODE:
        raise TypeError(f"convlstm_scan: gate dtype {gate_dtype} not supported")
    feat = f4 // 4
    hw = height * width
    if (batch, height, width, feat) != tuple(c0.shape) or t_in not in (1, length):
        raise ValueError(f"convlstm_scan: xg {tuple(xg.shape)} does not fit c0 "
                         f"{tuple(c0.shape)} and length {length}")
    xg, c0, h0 = (t.contiguous() for t in (xg, c0, h0))
    kw = dict(device=xg.device, dtype=xg.dtype)
    if mode == "save":
        outs = (torch.empty(batch, length, hw, feat, **kw),
                torch.empty(batch, length, hw, feat, **kw),
                torch.empty(batch, length, hw, f4, **kw))
    elif mode == "hs":
        outs = (torch.empty(batch, length, hw, feat, **kw), torch.empty(batch, hw, feat, **kw))
    else:
        outs = (torch.empty(batch, hw, feat, **kw), torch.empty(batch, hw, feat, **kw))
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    gcl, scratch = 0, None
    if way == "general":
        geo = _general_layout(batch, length, height, width, 0, feat, _es(xg.dtype))
        gcl = geo["cluster"]
        wpk = pack_general_forward(w, gcl)
        scratch = _general_scratch(geo["fwd_scratch"], xg.device)
    else:
        wpk = pack_proj_forward(w.new_empty(0, f4), w, xg.dtype == torch.float32)
    err = lib.mmvae_convlstm_scan_fwd(
        xg.data_ptr(), wpk.data_ptr(), c0.data_ptr(), h0.data_ptr(), *ptrs,
        batch, length, t_in, height, width, feat, _DTYPE_CODE[gate_dtype], _SCAN_MODES[mode],
        _DTYPE_CODE[xg.dtype], gcl, None if scratch is None else scratch.data_ptr(),
        _build.stream_ptr(xg.device),
    )
    _build.check(err, "convlstm_scan_fwd")
    _count(convlstm_scan_forward, way, mode)
    return outs


@_build.on_device
def scan_backward_cuda(w, c0, h0, hs, cs, ga, dh, dc_last, const_input: bool,
                       last_only: bool):
    """CUDA backward (BPTT, then the weight-gradient GEMM); same contract as
    `scan_backward_plain`."""
    batch, t_len, hw, feat = hs.shape
    lib, geo, way = _check_scan(w, c0, h0, t_len, const_input, hs=hs, cs=cs, ga=ga)
    height, width = c0.shape[1:3]
    f4 = 4 * feat
    act = hs.dtype
    c0, h0, hs, cs, ga = (t.contiguous() for t in (c0, h0, hs, cs, ga))
    dhs = dh.to(act).contiguous()
    dcl = dc_last.to(act).contiguous()
    if (cs.shape != hs.shape or ga.shape != (batch, t_len, hw, f4)
            or hw != height * width or c0.shape[0] != batch
            or dhs.numel() != batch * (1 if last_only else t_len) * hw * feat
            or dcl.numel() != batch * hw * feat):
        raise ValueError(f"convlstm_scan: residuals {tuple(hs.shape)}, {tuple(cs.shape)}, "
                         f"{tuple(ga.shape)} or cotangents {tuple(dh.shape)}, "
                         f"{tuple(dc_last.shape)} do not fit c0 {tuple(c0.shape)}")
    dev = hs.device
    stream = _build.stream_ptr(dev)
    gcl, scratch = 0, None
    if way == "general":
        geo = _general_layout(batch, t_len, height, width, 0, feat, _es(act))
        gcl, splits = geo["cluster"], geo["wgrad_splits"]
        wtpk = pack_general_backward(w, gcl)
        scratch = _general_scratch(geo["bwd_scratch"], dev)
        # a time-constant xg's f32 dgates sum (B, HW, 4F)
        dxs_floats = batch * hw * f4 if const_input else 0
    else:
        wtpk = pack_hidden_backward(w, hs.dtype == torch.float32)
        splits, dxs_floats = geo["wgrad_splits"], geo["dxs_scratch_floats"]
    if const_input:
        dxg = torch.empty(batch, 1, height, width, f4, device=dev, dtype=act)
        d_gates = torch.empty(batch, t_len, hw, f4, device=dev, dtype=act)
    else:
        # the dgates the weight GEMM reads (in the activation dtype) are dxg itself
        dxg = torch.empty(batch, t_len, height, width, f4, device=dev, dtype=act)
        d_gates = dxg
    dc0 = torch.empty(batch, hw, feat, device=dev, dtype=act)
    dh0 = torch.empty_like(dc0)
    # a general, 4-CTA or f32 BPTT's f32 dgates sum of a time-constant xg (the
    # kernel zeroes it)
    dxs = torch.empty(dxs_floats, device=dev, dtype=torch.float32) if dxs_floats else None
    err = lib.mmvae_convlstm_scan_bwd(
        wtpk.data_ptr(), c0.data_ptr(), cs.data_ptr(), ga.data_ptr(), dhs.data_ptr(),
        dcl.data_ptr(), d_gates.data_ptr(), dxg.data_ptr(),
        None if dxs is None else dxs.data_ptr(), dc0.data_ptr(), dh0.data_ptr(),
        batch, t_len, height, width, feat, int(const_input), int(last_only), _DTYPE_CODE[act],
        gcl, None if scratch is None else scratch.data_ptr(), stream,
    )
    _build.check(err, "convlstm_scan_bwd")
    dw_part = torch.empty(splits, 9 * feat, f4, device=dev, dtype=torch.float32)
    dw_out = torch.empty(9 * feat, f4, device=dev, dtype=torch.float32)
    err = lib.mmvae_convlstm_wgrad(  # C = 0: hs stands in for the x it never reads
        hs.data_ptr(), hs.data_ptr(), h0.data_ptr(), d_gates.data_ptr(), dw_part.data_ptr(),
        dw_out.data_ptr(), batch, t_len, height, width, 0, feat, splits, _DTYPE_CODE[act],
        stream,
    )
    _build.check(err, "convlstm_wgrad")
    _count(convlstm_scan_backward, way)
    return (
        dxg,
        dw_out.view(3, 3, feat, f4).to(w.dtype),
        dc0.view(c0.shape),
        dh0.view(h0.shape),
    )


def convlstm_scan_forward(xg, w, c0, h0, length, gate_dtype, mode: str):
    """Forward kernel for CUDA tensors, plain version for CPU tensors."""
    if xg.is_cuda:
        return scan_forward_cuda(xg, w, c0, h0, length, gate_dtype, mode)
    return scan_forward_plain(xg, w, c0, h0, length, gate_dtype, mode)


def convlstm_scan_backward(w, c0, h0, hs, cs, ga, dh, dc_last, const_input: bool,
                           last_only: bool):
    """Backward kernels for CUDA tensors, plain version for CPU tensors."""
    if hs.is_cuda:
        return scan_backward_cuda(w, c0, h0, hs, cs, ga, dh, dc_last, const_input, last_only)
    return scan_backward_plain(w, c0, h0, hs, cs, ga, dh, dc_last, const_input, last_only)


convlstm_scan_forward.launches = 0
convlstm_scan_forward.modes = dict.fromkeys(_SCAN_MODES, 0)  # launches by forward mode
convlstm_scan_backward.launches = 0
# launches by route (`route`), of K5's and K6's four wrappers
for _fn in (convlstm_proj_forward, convlstm_proj_backward, convlstm_scan_forward,
            convlstm_scan_backward):
    _fn.routes = {"wgmma": 0, "general": 0}
del _fn


class _Scan(torch.autograd.Function):
    """The `_scan` and `_scan_last` VJPs: outputs (hs, c_T), or (h_T, c_T)
    when `last_only`; the backward takes the matching cotangents."""

    @staticmethod
    def forward(ctx, xg, w, c0, h0, length, gate_dtype, last_only):
        hs, cs, ga = convlstm_scan_forward(xg, w, c0, h0, length, gate_dtype, "save")
        ctx.save_for_backward(w, c0, h0, hs, cs, ga)
        ctx.const_input = xg.shape[1] == 1 and length > 1
        ctx.last_only = last_only
        if last_only:
            return hs[:, -1].clone(), cs[:, -1].clone()
        return hs, cs[:, -1].clone()

    @staticmethod
    def backward(ctx, dh, dc_last):
        grads = convlstm_scan_backward(*ctx.saved_tensors, dh, dc_last, ctx.const_input,
                                       ctx.last_only)
        return (*grads, None, None, None)


def convlstm_scan(
    xg: torch.Tensor,
    w: torch.Tensor,
    c0: torch.Tensor,
    h0: torch.Tensor,
    *,
    length: int | None = None,
    gate_dtype: torch.dtype = torch.float32,
    last_only: bool = False,
):
    """The ConvLSTM hidden recurrence as one kernel (K6).

    xg: (B, T, H, W, 4F) hoisted input projections (bias included), or
    (B, 1, H, W, 4F) with `length=T` for a time-constant input; w: (3, 3,
    F, 4F) HWIO; c0, h0: (B, H, W, F); all one dtype.  Returns ((c_T, h_T),
    hs) with hs (B, T, H, W, F), or ((c_T, h_T), None) when `last_only`.
    Differentiable wrt all four tensors."""
    batch, t_in, height, width, f4 = xg.shape
    length = length or t_in
    if t_in not in (1, length):
        raise ValueError(f"convlstm_scan: xg has {t_in} steps, length is {length}")
    shape = c0.shape
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xg, w, c0, h0)):
        h_out, c_last = _Scan.apply(xg, w, c0, h0, length, gate_dtype, last_only)
    else:
        h_out, c_last = convlstm_scan_forward(xg, w, c0, h0, length, gate_dtype,
                                              "last" if last_only else "hs")
    c_last = c_last.view(shape).to(c0.dtype)
    if last_only:
        return (c_last, h_out.view(shape)), None
    hs = h_out.view(batch, length, height, width, f4 // 4)
    return (c_last, hs[:, -1]), hs
