"""The ConvLSTM kernels' 4-CTA widths (F = 160-256) on the CPU: the domain
the wgmma kernels take and the general route of the shapes beyond it, the launch
geometry against the stage counts reckoned by hand for both cluster sizes,
the weight GEMM at N = 4F = 768 and 1,024, the work counts at wider
recurrences, and the reference's lstm_features=192 probe (config 3 +
fast_mid) against the JAX model with its Pallas kernels in interpret mode,
then a few of its recipe's train steps (ongen + EMA) at tiny widths."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvae_tpu.models.seq_vae import ConvLSTMSeqVAE as JSeqVAE
from mmvae_tpu.ops.elbo_pallas import elbo_reduce_pallas
from mmvae_torch.bench.flops import flops_per_step
from mmvae_torch.bench.roofline import bound, kernel_products, kernel_work
from mmvae_torch.configs import get_config
from mmvae_torch.convert import state_dict_from_flax
from mmvae_torch.models.seq_vae import ConvLSTMSeqVAE
from mmvae_torch.ops import convlstm_kernels as ck
from mmvae_torch.ops.elbo_kernels import elbo_reduce

WIDE = (160, 192, 224, 256)
LIMIT = 232448  # one CTA's shared memory on the H100


def _k5_fwd_stages(c, f, cl):
    """K5's forward ring stages by hand: shared memory less barriers and
    bias, two x tiles, two whole h tiles and the staging of the CTA's F/cl
    channels (h, c, four gates), over slots of 32 rows of its 4F/cl columns."""
    r128 = lambda v: -(-v // 128) * 128  # noqa: E731
    fixed = 1280 + 2 * r128(65 * (c + 8) * 2) + 2 * r128(65 * f * 2) + 64 * 6 * (f // cl) * 2
    return min(8, (LIMIT - fixed) // (32 * 4 * (f // cl) * 2))


def _k6_fwd_stages(f, cl):
    fixed = 1280 + 2 * (-(-65 * f * 2 // 128) * 128) + 64 * 6 * (f // cl) * 2
    return min(8, (LIMIT - fixed) // (32 * 4 * (f // cl) * 2))


def test_stage_counts_match_the_reckoning():
    """C = 128.  With 2 CTAs a sample K5's forward would keep 6, 4, 2, 1 and
    0 ring stages at F = 128-256 and K6's 8, 6, 4, 3 and 2, below the
    kernels' 4 from F = 192 (K5) and 224 (K6) on; 4 CTAs keep 8, 8, 6 and 4
    (K5) and 8, 8, 8, 7 (K6).  The geometry takes 2 CTAs up to 128 and 4
    beyond, and equals the hand count."""
    feats = (128, *WIDE)
    assert [_k5_fwd_stages(128, f, 2) for f in feats] == [6, 4, 2, 1, 0]
    assert [_k5_fwd_stages(128, f, 4) for f in WIDE] == [8, 8, 6, 4]
    assert [_k6_fwd_stages(f, 2) for f in feats] == [8, 6, 4, 3, 2]
    assert [_k6_fwd_stages(f, 4) for f in WIDE] == [8, 8, 8, 7]
    for f in feats:
        cl = ck.cluster_size(f)
        assert cl == (2 if f <= 128 else 4)
        geo = ck.proj_geometry(64, 20, 8, 8, 128, f)
        assert (geo["cluster"], geo["ctas"]) == (cl, 64 * cl)
        assert geo["fwd_stages"] == _k5_fwd_stages(128, f, cl)
        assert geo["fwd_slot_bytes"] == 32 * 4 * (f // cl) * 2
        sg = ck.scan_geometry(64, 20, 8, 8, f, True)
        assert sg["fwd_stages"] == _k6_fwd_stages(f, cl) and sg["ctas"] == 64 * cl


@pytest.mark.parametrize("f", WIDE)
def test_wide_bptt_geometry(f):
    """The 4-CTA BPTTs: 64-row slabs (8 KB at most) beside the whole (65,
    4F) dgates tile; K5 keeps 8, 8, 8 and 5 stages, K6 8, 8, 8 and 6, the
    same for a streaming and a time-constant xg, whose f32 dgates sum moves
    out of shared memory into a (B, 4, 64, F/4 x 4) global scratch."""
    hf = f // 4
    k5 = ck.proj_geometry(64, 20, 8, 8, 128, f)
    assert k5["bwd_slot_bytes"] == 64 * 64 * 2
    assert k5["bwd_stages"] == {160: 8, 192: 8, 224: 8, 256: 5}[f]
    assert k5["bwd_smem"] == (256 + -(-65 * 4 * f * 2 // 128) * 128 + 64 * 6 * hf * 2
                              + 4 * 4 * hf * 4 + k5["bwd_ring_bytes"]) <= LIMIT
    assert k5["dx_blocks"] == 1  # C / 4 = 32 columns, in one zero-padded block of 64
    for const in (True, False):
        k6 = ck.scan_geometry(64, 20, 8, 8, f, const)
        assert k6["bwd_slot_bytes"] == 64 * hf * 2
        assert k6["bwd_stages"] == {160: 8, 192: 8, 224: 8, 256: 6}[f]
        assert k6["bwd_min_stages"] == 4 and k6["bwd_smem"] <= LIMIT
        assert k6["dxs_scratch_floats"] == (64 * 64 * 4 * f if const else 0)
    assert ck.scan_geometry(64, 20, 8, 8, 128, True)["dxs_scratch_floats"] == 0


@pytest.mark.parametrize("f,tiles,splits", [(192, 15 * 3, 2), (256, 19 * 4, 1)])
def test_weight_gemm_at_n_768_and_1024(f, tiles, splits):
    """dW and dWx at N = 4F = 768 and 1,024 (C = 128, B = 64, T = 20): tiles
    of 128 x 256 over M = C + 9F, split in K as far as the SMs allow, every
    row of the scratch in one split, in shared memory."""
    geo = ck.proj_geometry(64, 20, 8, 8, 128, f)
    rows = 64 * 20 * 64
    assert geo["wgrad_bn"] == 256 and 4 * f % 256 == 0
    assert geo["wgrad_tiles"] == tiles == -(-(128 + 9 * f) // 128) * (4 * f // 256)
    assert geo["wgrad_splits"] == splits and tiles * splits <= ck.SMS
    assert geo["wgrad_splits"] * geo["wgrad_rows_per_split"] >= rows
    assert geo["wgrad_smem"] <= LIMIT


@pytest.mark.parametrize("f", [16, 64, 112, 128, 160, 192, 224, 256])
def test_domain_takes_the_kernels_widths(f):
    ck.check_domain("convlstm_scan_proj", torch.bfloat16, f, 64, 128)
    ck.check_domain("convlstm_scan", torch.bfloat16, f, 30)


@pytest.mark.parametrize("dtype,f,hw,cin", [
    (torch.bfloat16, 144, 64, 128),
    (torch.bfloat16, 288, 64, 128),
    (torch.bfloat16, 200, 64, None),
    (torch.bfloat16, 8, 64, None),
    (torch.float32, 160, 64, 128),
    (torch.float32, 192, 64, None),
    (torch.bfloat16, 128, 256, 128),
    (torch.bfloat16, 192, 256, None),
    (torch.bfloat16, 192, 64, 24),
], ids=["F144", "F288", "F200", "F8", "f32-F160", "f32-F192", "HW256", "HW256-F192", "C24"])
def test_domain_refusals_name_the_limits(dtype, f, hw, cin):
    """The shapes outside the wgmma kernels' domain (F a multiple of 16 up
    to 128 or of 32 up to 256 with bf16 activations, up to 128 with f32,
    H*W <= 64, C a multiple of 16), which the wrappers refused before the
    general kernels existed: each now takes the general route, and the
    domain check refuses none of them.  No fallback: the plain versions
    run only for CPU tensors."""
    what = "convlstm_scan_proj" if cin is not None else "convlstm_scan"
    ck.check_domain(what, dtype, f, hw, cin)
    assert ck.route(dtype, f, hw, cin) == "general"
    assert "multiple of 32 up to 256" in ck.DOMAIN and "H*W <= 64" in ck.DOMAIN


def test_work_counts_scale_with_lstm_features():
    """K5 forward at C = 128, B = 64, T = 20, 8x8: 2 B T 4F (HW C + 484 F)
    operations, 91.9 GFLOP at F = 128 and 198.8 at 192 (2.16 times), its
    bound the operations over 989 TFLOP/s; K6's products grow as F^2."""
    def k5(f):
        return 2 * 64 * 20 * 4 * f * (64 * 128 + 484 * f)

    for f in (128, 192, 256):
        shape = (64, 20, 8, 8, 128, f)
        assert kernel_work("convlstm_proj_forward", shape)[0] == k5(f)
        assert bound("convlstm_proj_forward", shape) == (
            pytest.approx(k5(f) / 989e12 * 1e3), "operations")
        assert kernel_products("convlstm_proj_backward", shape) == 2 * k5(f)
    assert k5(192) / k5(128) == pytest.approx(2.1624, rel=1e-4)
    k6 = [kernel_products("convlstm_scan_forward", (64, 20, 8, 8, f, True)) for f in (128, 256)]
    assert k6[1] == 4 * k6[0]


def test_flops_per_step_counts_the_wider_recurrence():
    """flops_per_step of config 3 with fused=true (K5 and K6) at F = 128,
    192 and 256: everything but the two recurrences' hidden convs grows
    linearly in F, so the second difference of the step's count is that of
    the kernels' products: the hidden conv of K5 (forward and its two
    backward products) and of K6, over 484 taps each at 8x8."""
    counts = [flops_per_step(get_config("seq_vae", ("model.kwargs.fused=true",
                                                    f"model.kwargs.lstm_features={f}")))
              for f in (128, 192, 256)]
    conv = [3 * 2 * 64 * 20 * 484 * f * 4 * f * 2 for f in (128, 192, 256)]
    assert counts[0] < counts[1] < counts[2]
    assert counts[2] - 2 * counts[1] + counts[0] == pytest.approx(
        conv[2] - 2 * conv[1] + conv[0], rel=1e-9)


# The probe at tiny widths but its recurrence: the JAX encoder takes K5 at
# C = 128 (its lane-width condition), image 32 gives the 8x8 grid.
PROBE = dict(latent_dim=8, enc_channels=(8, 128), lstm_features=192, image_size=32,
             enc_x_kernel=1, dec_upsample="fast_mid")


def test_probe_model_matches_jax_with_its_kernels():
    """Config 3 with fast_mid at lstm_features=192, fused: the JAX model
    runs K5 and K6 as Pallas kernels (interpret mode), the port their plain
    versions, from the same flax params, frames and eps; f32 logits, mu,
    logvar and every parameter gradient within 5e-4 of the largest
    magnitude, as tests/test_torch_models.py holds config 3."""
    b, t = 1, 3
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(b, t, 32, 32)) < 0.35).astype(np.float32)
    eps = rng.normal(size=(b, 8)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jm = JSeqVAE(**PROBE, fused=True)
        params = JSeqVAE(**PROBE, fused=False).init(jax.random.PRNGKey(1), jnp.asarray(x),
                                                    lambda m, v, salt=0: m)

        def jloss(p):
            out = jm.apply(p, jnp.asarray(x), lambda m, v, salt=0: m + jnp.exp(0.5 * v) * eps)
            bce, kl = elbo_reduce_pallas(out.logits, out.target, out.mu, out.logvar,
                                         interpret=True)
            return (bce + kl) / b, (out.logits, out.mu, out.logvar)

        (_, jouts), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tm = ConvLSTMSeqVAE(**PROBE, fused=True)
    tm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    out = tm(torch.from_numpy(x),
             lambda m, v, salt=0: m + torch.exp(0.5 * v) * torch.from_numpy(eps))
    assert tm.enc_lstm.step.hidden.weight.shape == (3, 3, 192, 768)
    bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
    ((bce + kl) / b).backward()
    jgrads = state_dict_from_flax(jax.tree.map(np.asarray, jg))

    def close(got, want, what):
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=5e-4,
                                   atol=5e-4 * scale, err_msg=what)

    for name, a, j in zip(("logits", "mu", "logvar"), (out.logits, out.mu, out.logvar), jouts):
        close(a, j, name)
    assert set(jgrads) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        close(p.grad, jgrads[name].numpy(), name)


def test_probe_recipe_trains_on_the_cpu():
    """The probe's recipe (fast_mid, clips generated every step, EMA 0.999)
    at lstm_features=192 and tiny other widths: three train steps on the
    CPU through the plain versions, finite losses, the EMA off the live
    parameters."""
    from mmvae_torch.bench.throughput import setup_resident_training

    cfg = get_config("seq_vae", ("model.kwargs.dec_upsample=fast_mid",
                                 "data.on_device_generate=true", "optim.ema_decay=0.999",
                                 "model.kwargs.lstm_features=192"))
    cfg.model.kwargs.update(latent_dim=8, enc_channels=(4, 8))
    cfg.data.batch_size, cfg.data.seq_len = 2, 3
    state, data, step = setup_resident_training(cfg, torch.device("cpu"))
    assert data is None and state.model.enc_lstm.step.hidden.weight.shape == (3, 3, 192, 768)
    losses = [float(step(state, data)["loss"]) for _ in range(3)]
    assert all(math.isfinite(v) for v in losses)
    live = dict(state.model.named_parameters())
    assert max(float((e - live[n].detach()).abs().max())
               for n, e in state.ema_params.items()) > 0
