"""The ConvLSTM kernels' f32 activations (F <= 128) on the CPU: the domain the
wgmma kernels take and the general route above F = 128, the f32
launch geometry of K5 and K6 against a hand reckoning (the bf16 geometry
unchanged), the TF32 hi / lo weight packing, the roofline's 3xTF32 bound,
and configs 3 and 5 with model.dtype=float32 through the port's plain
versions against the JAX model with its Pallas kernels in interpret mode."""

import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvae_tpu.models.hier_vae import HierVideoVAE as JHier
from mmvae_tpu.models.seq_vae import ConvLSTMSeqVAE as JSeqVAE
from mmvae_tpu.ops.elbo_pallas import elbo_reduce_pallas
from mmvae_torch.bench.roofline import TF32_3X_FLOPS, bound, kernel_work
from mmvae_torch.convert import state_dict_from_flax
from mmvae_torch.models.hier_vae import HierVideoVAE
from mmvae_torch.models.seq_vae import ConvLSTMSeqVAE
from mmvae_torch.ops import convlstm_kernels as ck
from mmvae_torch.ops.elbo_kernels import elbo_reduce

LIMIT = 232448  # one CTA's shared memory on the H100
NARROW = (16, 32, 48, 64, 80, 96, 112, 128)


@pytest.mark.parametrize("f", [16, 64, 128])
def test_domain_takes_f32_up_to_128(f):
    ck.check_domain("convlstm_scan_proj", torch.float32, f, 64, 128)
    ck.check_domain("convlstm_scan", torch.float32, f, 30)


@pytest.mark.parametrize("f", [160, 256])
def test_domain_refuses_f32_above_128(f):
    """f32 at F > 128 would need the wgmma BPTT's f32 dgates tile, (65, 4F)
    x 4 bytes, split across the cluster, so the wgmma kernels stop at F =
    128 with f32 activations and these widths, which the wrappers refused
    before, take the general kernels; the domain check takes them, and no
    plain version runs in their place on the card."""
    for what, cin in (("convlstm_scan_proj", 128), ("convlstm_scan", None)):
        ck.check_domain(what, torch.float32, f, 64, cin)
        assert ck.route(torch.float32, f, 64, cin) == "general"
        assert ck.route(torch.bfloat16, f, 64, cin) == "wgmma"
    assert "float32 activations with F a multiple of 16 up to 128" in ck.DOMAIN


def test_domain_refuses_other_dtypes_and_mixed_inputs():
    with pytest.raises(TypeError, match="activations are torch.float16"):
        ck.check_domain("convlstm_scan", torch.float16, 64, 64)
    with pytest.raises(TypeError, match="one activation dtype"):
        ck._activations((("x", torch.zeros(1)), ("w", torch.zeros(1, dtype=torch.bfloat16))))


def _r128(v):
    return -(-v // 128) * 128


def _k5_f32(c, f):
    """K5's f32 shared memory by hand, 2 CTAs a sample: the forward's
    barriers and bias, two x tiles (rows of C + 4 floats), two whole h
    tiles and no staging, over slots of 8 rows of the CTA's 2F columns at 8
    bytes a weight; the BPTT's barriers, the whole (65, 4F) f32 dgates
    tile, no residuals, the dbx warp partials, over slots of 32 rows of 64
    dx columns."""
    fwd_fixed = 1280 + 2 * _r128(65 * (c + 4) * 4) + 2 * _r128(65 * f * 4)
    fwd_slot = 8 * 2 * f * 8
    bwd_fixed = 256 + _r128(65 * 4 * f * 4) + 4 * 4 * (f // 2) * 4
    bwd_slot = 32 * 64 * 8
    return fwd_fixed, fwd_slot, bwd_fixed, bwd_slot


@pytest.mark.parametrize("f", NARROW)
def test_f32_geometry_matches_the_reckoning(f):
    """C = 128, B = 64, T = 20: every ring keeps at least 4 stages (5 at F =
    128, 8 up to F = 80) in at most 232,448 bytes; K6's forward has no x
    tiles, its BPTT slots of 32 rows of the CTA's F/2 columns and, for a
    time-constant xg, the f32 dgates sum in a (B, 2, 64, 2F) global
    scratch."""
    fwd_fixed, fwd_slot, bwd_fixed, bwd_slot = _k5_f32(128, f)
    geo = ck.proj_geometry(64, 20, 8, 8, 128, f, 4)
    assert (geo["cluster"], geo["ctas"]) == (2, 128)
    assert geo["fwd_slot_bytes"] == fwd_slot and geo["bwd_slot_bytes"] == bwd_slot
    assert geo["fwd_stages"] == min(8, (LIMIT - fwd_fixed) // fwd_slot) >= 4
    assert geo["bwd_stages"] == min(8, (LIMIT - bwd_fixed) // bwd_slot) >= 4
    assert geo["fwd_smem"] == fwd_fixed + geo["fwd_ring_bytes"] <= LIMIT
    assert geo["bwd_smem"] == bwd_fixed + geo["bwd_ring_bytes"] <= LIMIT
    for const in (True, False):
        sg = ck.scan_geometry(64, 20, 8, 8, f, const, 4)
        s_fixed = 1280 + 2 * _r128(65 * f * 4)
        b_fixed, b_slot = 256 + _r128(65 * 4 * f * 4), 32 * (f // 2) * 8
        assert sg["fwd_stages"] == min(8, (LIMIT - s_fixed) // fwd_slot) >= 4
        assert sg["bwd_slot_bytes"] == b_slot and sg["bwd_min_stages"] == 4
        assert sg["bwd_stages"] == min(8, (LIMIT - b_fixed) // b_slot) >= 4
        assert max(sg["fwd_smem"], sg["bwd_smem"]) <= LIMIT
        assert sg["dxs_scratch_floats"] == (64 * 64 * 4 * f if const else 0)
    assert [ck.proj_geometry(64, 20, 8, 8, 128, g, 4)["fwd_stages"] for g in (80, 128)] == [8, 5]


def test_f32_weight_gemm_geometry():
    """The f32 weight GEMM: tiles of 128 x 128 (64 where 4F = 64) over M = C
    + 9F, 32 rows a stage in two stages of an A tile (rows of 128 + 4
    floats) and the hi and lo B tiles, split in K as far as the SMs allow."""
    geo = ck.proj_geometry(64, 20, 8, 8, 128, 128, 4)
    assert (geo["wgrad_bn"], geo["wgrad_tiles"]) == (128, 10 * 4)
    assert geo["wgrad_smem"] == 2 * (32 * 132 * 4 + 2 * 32 * 128 * 4) + 256 <= LIMIT
    assert geo["wgrad_splits"] == 3 and geo["wgrad_rows_per_split"] % 32 == 0
    assert geo["wgrad_splits"] * geo["wgrad_rows_per_split"] >= 64 * 20 * 64
    assert ck.scan_geometry(64, 10, 8, 8, 16, True, 4)["wgrad_bn"] == 64


# proj_geometry(64, 20, 8, 8, 128, F) and scan_geometry(64, 20, 8, 8, F,
# const) with bf16 activations, as the kernels had them before f32 came in.
_BF16_GEOMETRY = {
    64: ((8, 8192, 143616, 8, 16384, 191232, 256, 6, 22, 196864),
         (8, 108032, 8, 8192, 156416, 3, 0, 5, 26), (8, 108032, 8, 8192, 123648, 4, 0, 5, 26)),
    128: ((6, 16384, 217600, 6, 16384, 218368, 256, 20, 6, 196864),
          (8, 214784, 3, 16384, 230656, 3, 0, 18, 7), (8, 214784, 7, 16384, 230656, 4, 0, 18, 7)),
    192: ((8, 12288, 221952, 8, 8192, 205568, 256, 45, 2, 196864),
          (8, 186368, 8, 6144, 186112, 4, 3145728, 42, 3),
          (8, 186368, 8, 6144, 186112, 4, 0, 42, 3)),
}


@pytest.mark.parametrize("f", sorted(_BF16_GEOMETRY))
def test_bf16_geometry_unchanged(f):
    k5, k6c, k6s = _BF16_GEOMETRY[f]
    geo = ck.proj_geometry(64, 20, 8, 8, 128, f)
    assert geo == ck.proj_geometry(64, 20, 8, 8, 128, f, 2)
    assert tuple(geo[k] for k in ("fwd_stages", "fwd_slot_bytes", "fwd_smem", "bwd_stages",
                                  "bwd_slot_bytes", "bwd_smem", "wgrad_bn", "wgrad_tiles",
                                  "wgrad_splits", "wgrad_smem")) == k5
    for const, want in ((True, k6c), (False, k6s)):
        sg = ck.scan_geometry(64, 20, 8, 8, f, const)
        assert tuple(sg[k] for k in ("fwd_stages", "fwd_smem", "bwd_stages", "bwd_slot_bytes",
                                     "bwd_smem", "bwd_min_stages", "dxs_scratch_floats",
                                     "wgrad_tiles", "wgrad_splits")) == want


def test_tf32_split_and_packing_round_trip():
    """For the f32 kernels (`tf32_parts`) a weight is packed as the TF32
    cores [K/4][N/8][8 n][4 k] of its hi part, then of its lo part: the cores unpack to each part exactly, in
    each rank's column order (warpgroup, gate, channel), each part is TF32
    (13 low bits zero), and hi + lo is the weight to 2^-21 of its magnitude
    (lo's own rounding)."""
    g = torch.Generator().manual_seed(0)
    f, cin = 32, 48
    wx = torch.randn(cin, 4 * f, generator=g)
    w = torch.randn(3, 3, f, 4 * f, generator=g)
    k = cin + 9 * f
    pk = ck.pack_proj_forward(wx, w, tf32_parts=True)
    assert pk.shape == (2, 2, k // 4, 4 * f // 2 // 8, 8, 4) and pk.dtype == torch.float32
    hi, lo = (ck.unpack_cores(p) for p in pk)
    full = torch.cat([wx, w.reshape(9 * f, 4 * f)])
    per_rank = full.view(k, 4, 2, 2, f // 4).permute(2, 0, 3, 1, 4).reshape(2, k, 2 * f)
    assert torch.equal(hi, ck.tf32(per_rank)) and torch.equal(lo, ck.tf32(per_rank - hi))
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = ((hi.double() + lo.double()) - per_rank.double()).abs()
    assert float((err / per_rank.double().abs().clamp_min(1e-30)).max()) <= 2.0 ** -21
    # rank 1, warpgroup 0, gate f (q = 1): channel F/2 of the forget gate
    assert torch.equal(hi[1, :, f // 4], ck.tf32(full[:, f + f // 2]))
    assert torch.equal(ck.unpack_cores(ck.pack_cores(full, kc=4)), full)
    wt, wxt = ck.pack_proj_backward(wx, w, tf32_parts=True)
    assert wt.shape == (2, 2, 9 * 4 * f // 4, f // 2 // 8, 8, 4)
    assert wxt.shape == (2, 2, 1, 4 * f // 4, 8, 8, 4)
    # the same per-rank matrices as the bf16 packing's (here of w in f64)
    ref = ck.unpack_cores(ck.pack_hidden_backward(w.double())).float()
    assert torch.equal(ck.unpack_cores(wt[0]), ck.tf32(ref))
    assert torch.equal(ck.unpack_cores(wt[1]), ck.tf32(ref - ck.tf32(ref)))


def test_roofline_f32_bound_and_bytes():
    """An f32 recurrence is bounded by its products at three TF32 passes
    (494.7 / 3 TFLOP/s): config 3's K5 forward, 91.9 GFLOP, at least 0.557
    ms against bf16's 0.093; its bytes are the bf16 count's but for the
    f32 weight gradients, twice as many."""
    shape = (64, 20, 8, 8, 128, 128)
    ops, b16 = kernel_work("convlstm_proj_forward", shape)
    ops32, b32 = kernel_work("convlstm_proj_forward", (*shape, 4))
    assert ops32 == ops and b32 == 2 * b16
    assert TF32_3X_FLOPS == pytest.approx(164.9e12, rel=1e-3)
    ms, by = bound("convlstm_proj_forward", (*shape, 4))
    assert by == "operations" and ms == pytest.approx(ops / TF32_3X_FLOPS * 1e3)
    assert ms == pytest.approx(0.5575, abs=1e-3)
    assert bound("convlstm_proj_forward", (*shape, 2)) == bound("convlstm_proj_forward", shape)
    bo16, bb16 = kernel_work("convlstm_proj_backward", shape)
    bo32, bb32 = kernel_work("convlstm_proj_backward", (*shape, 4))
    grads = (128 + 9 * 128) * 512 * 4 + 512 * 4  # dW, dWx and dbx in f32 either way
    assert bo32 == bo16 and bb32 - grads == 2 * (bb16 - grads)
    k6 = (64, 10, 8, 8, 128, True)
    assert bound("convlstm_scan_forward", (*k6, 4))[0] == pytest.approx(
        6 * bound("convlstm_scan_forward", k6)[0], rel=1e-2)


# Configs 3 and 5 with model.dtype=float32 at tiny widths but a recurrence
# the JAX model runs through its Pallas kernels: the encoder's C = 128 (its
# lane-width condition), 32 x 32 frames give the 8x8 grid.
_SEQ = dict(latent_dim=8, enc_channels=(8, 128), lstm_features=16, image_size=32,
            enc_x_kernel=1)
_HIER = dict(global_latent=8, chunk_latent=4, chunk_len=2, chunk_feature=16,
             **{k: v for k, v in _SEQ.items() if k != "latent_dim"})
_MODELS = {"seq_vae": (JSeqVAE, ConvLSTMSeqVAE, _SEQ, 3),
           "hier_vae": (JHier, HierVideoVAE, _HIER, 4)}
_OUTS = ("logits", "mu", "logvar", "extra_kl")


def _inputs(name):
    _, _, kw, t = _MODELS[name]
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(1, t, 32, 32)) < 0.35).astype(np.float32)
    eps = {0: rng.normal(size=(1, 8)).astype(np.float32)}
    if name == "hier_vae":
        eps[1] = rng.normal(size=(t // kw["chunk_len"], kw["chunk_latent"])).astype(np.float32)
    return x, eps


@functools.lru_cache(maxsize=None)
def _params(name):
    jcls, _, kw, _ = _MODELS[name]
    return jcls(**kw, fused=False).init(jax.random.PRNGKey(1), jnp.asarray(_inputs(name)[0]),
                                        lambda m, v, salt=0: m)


@functools.lru_cache(maxsize=None)
def _jax_run(name, gate_bf16):
    """The JAX model with fused=True in f32: K5 and K6 as Pallas kernels
    (interpret mode).  (outputs, parameter gradients as a state_dict)."""
    jcls, _, kw, _ = _MODELS[name]
    x, eps = _inputs(name)
    jm = jcls(**kw, fused=True, gate_bf16=gate_bf16)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), lambda m, v, salt=0: m + jnp.exp(0.5 * v) * eps[salt])
        bce, kl = elbo_reduce_pallas(out.logits, out.target, out.mu, out.logvar, interpret=True)
        extra = out.extra_kl if name == "hier_vae" else 0.0
        return bce + kl + extra, (out.logits, out.mu, out.logvar, extra)

    with jax.default_matmul_precision("highest"):
        (_, outs), grads = jax.value_and_grad(jloss, has_aux=True)(_params(name))
    grads = state_dict_from_flax(jax.tree.map(np.asarray, grads))
    return [np.asarray(o, np.float32) for o in outs], {n: g.numpy() for n, g in grads.items()}


def _port_run(name, gate_bf16):
    """The port with fused=True in f32: K5 and K6 through their plain
    versions (the route the card takes through the f32 kernels)."""
    _, tcls, kw, _ = _MODELS[name]
    x, eps = _inputs(name)
    tm = tcls(**kw, fused=True, gate_bf16=gate_bf16, dtype=torch.float32)
    tm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, _params(name))))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # hier_vae: remat with fused=True
        out = tm(torch.from_numpy(x),
                 lambda m, v, salt=0: m + torch.exp(0.5 * v) * torch.from_numpy(eps[salt]))
    bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
    extra = out.extra_kl if name == "hier_vae" else torch.zeros(())
    (bce + kl + extra).backward()
    outs = [t.detach().float().numpy() for t in (out.logits, out.mu, out.logvar, extra)]
    return outs, {n: p.grad.numpy() for n, p in tm.named_parameters()}


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", ["seq_vae", "hier_vae"])
def test_f32_model_matches_jax_with_its_kernels(name):
    """Config 3 and config 5 fused with model.dtype=float32 and f32 gates,
    the port's plain versions against the JAX model's Pallas kernels, from
    the same flax params, frames and eps: logits, mu, logvar, the extra KL
    and every parameter gradient within 5e-4 of each tensor's largest
    magnitude, as tests/test_torch_models.py holds config 3 in f32."""
    jouts, jgrads = _jax_run(name, False)
    outs, grads = _port_run(name, False)
    for what, a, b in zip(_OUTS, outs, jouts):
        _close(a, b, 5e-4, what)
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        _close(g, jgrads[n], 5e-4, n)


def test_f32_model_with_bf16_gates_matches_jax():
    """Config 3 with model.dtype=float32 as its factory leaves it, bf16
    gates: both sides round the pointwise chain and the cell state to bf16
    at every step, and where their f32 pre-activations fall on either side
    of a rounding boundary a gate moves by a bf16 ulp.  At this size (one
    clip, three frames) such flips move the gradients by several percent
    between any two correct routes: JAX's own Pallas and lax.scan routes
    differ by up to 7.5 % (relative L2), the port's eager route and JAX's
    by up to 10 %.  So the outputs are held within 5 % of each tensor's
    largest magnitude and each gradient within 25 % (relative L2) of JAX's,
    tests/test_torch_models_seq.py's bf16 bounds; the f32-gate test above
    holds the arithmetic itself."""
    jouts, jgrads = _jax_run("seq_vae", True)
    outs, grads = _port_run("seq_vae", True)
    for what, a, b in zip(_OUTS, outs, jouts):
        _close(a, b, 0.05, what)
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        assert _rel(g, jgrads[n]) <= 0.25, (n, _rel(g, jgrads[n]))
