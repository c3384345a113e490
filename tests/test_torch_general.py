"""The ConvLSTM recurrences (K5, K6) at every shape the TPU kernels take, on
the CPU.

- the plain versions (what the port runs on the CPU, and the oracle of the
  general CUDA kernels on the card) against the Pallas kernels in interpret
  mode at the shapes outside the wgmma kernels' domain: a 16x16 grid at the
  README's widths (F = C = 8), odd widths (F = 20, C = 24) and f32 at
  F = 160;
- the route each shape takes: the wgmma kernels wherever they ran before,
  the general kernels everywhere else;
- the smoke's copy of the JAX package's small widths.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvae_tpu.ops.convlstm_pallas import convlstm_scan_pallas, convlstm_scan_proj_pallas
from mmvae_torch.ops import convlstm_kernels as ck


@pytest.fixture(autouse=True)
def _full_precision_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


# (B, T, H, W, C, F) outside the wgmma kernels' domain: a 16x16 grid at the
# README's widths, odd widths on a 6x12 grid (the Pallas kernels take H*W a
# multiple of 8), f32 above F = 128.
GENERAL_K5 = {"16x16-F8-C8": (2, 2, 16, 16, 8, 8), "6x12-F20-C24": (1, 2, 6, 12, 24, 20),
              "f32-F160": (1, 2, 4, 4, 16, 160)}
_GRAD_TOL = 2e-4  # tests/test_convlstm_fused.py, f32 on the CPU
# (gate dtype, forward tolerance, gradient tolerance): bf16 gates round at
# other points in the two frameworks (tests/test_torch_convlstm.py)
_GATES = {"f32-gates": ("float32", 2e-5, _GRAD_TOL), "bf16-gates": ("bfloat16", 0.05, 0.08)}


def _normal(rng, shape, scale):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _assert_grads(names, got, want, tol):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32).reshape(g.shape)
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("gates", list(_GATES))
@pytest.mark.parametrize("shape", list(GENERAL_K5))
def test_proj_plain_matches_pallas_at_general_shapes(shape, gates):
    """K5's plain version (the general kernels' oracle on the card) against
    `convlstm_scan_proj_pallas` in interpret mode, f32 activations: (c_T,
    h_T) and all six gradients."""
    b, t, h, w, c, f = GENERAL_K5[shape]
    gate, fwd_tol, grad_tol = _GATES[gates]
    rng = np.random.default_rng(0)
    args = [_normal(rng, (b, t, h, w, c), 0.5), _normal(rng, (c, 4 * f), c ** -0.5),
            _normal(rng, (4 * f,), 0.1), _normal(rng, (3, 3, f, 4 * f), (9 * f) ** -0.5),
            _normal(rng, (b, h, w, f), 0.5), _normal(rng, (b, h, w, f), 0.5)]
    wc, wh = _normal(rng, (b, h, w, f), 1.0), _normal(rng, (b, h, w, f), 1.0)
    jgate, tgate = getattr(jnp, gate), getattr(torch, gate)

    def jloss(*a):
        c_t, h_t = convlstm_scan_proj_pallas(*a, interpret=True, gate_dtype=jgate)
        return (jnp.sum(c_t.astype(jnp.float32) * wc) + jnp.sum(h_t.astype(jnp.float32) * wh),
                (c_t, h_t))

    (_, (jc, jh)), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    c_t, h_t = ck.convlstm_scan_proj(*targs, gate_dtype=tgate)
    (torch.sum(c_t.float() * torch.from_numpy(wc))
     + torch.sum(h_t.float() * torch.from_numpy(wh))).backward()
    for got, want in ((c_t, jc), (h_t, jh)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32),
                                   atol=fwd_tol, rtol=fwd_tol)
    _assert_grads(("dx", "dWx", "dbx", "dW", "dc0", "dh0"), [a.grad for a in targs], jgrads,
                  grad_tol)


# (B, T, H, W, F): K5's shapes without the input channels
GENERAL_K6 = {name: s[:4] + s[5:] for name, s in GENERAL_K5.items()}


@pytest.mark.parametrize("const", [False, True], ids=["streaming", "const"])
@pytest.mark.parametrize("gates", list(_GATES))
@pytest.mark.parametrize("shape", list(GENERAL_K6))
def test_scan_plain_matches_pallas_at_general_shapes(shape, gates, const):
    """K6's plain version against `convlstm_scan_pallas` in interpret mode,
    f32 activations, a streaming or a time-constant xg: (c_T, h_T), every
    h_t and the gradients of xg, w, c0 and h0."""
    b, t, h, w, f = GENERAL_K6[shape]
    gate, fwd_tol, grad_tol = _GATES[gates]
    rng = np.random.default_rng(1)
    args = [_normal(rng, (b, 1 if const else t, h, w, 4 * f), 0.5),
            _normal(rng, (3, 3, f, 4 * f), (9 * f) ** -0.5), _normal(rng, (b, h, w, f), 0.5),
            _normal(rng, (b, h, w, f), 0.5)]
    wc, wh = _normal(rng, (b, h, w, f), 1.0), _normal(rng, (b, h, w, f), 1.0)
    whs = _normal(rng, (b, t, h, w, f), 1.0)
    jgate, tgate = getattr(jnp, gate), getattr(torch, gate)

    def jloss(*a):
        (c_t, h_t), hs = convlstm_scan_pallas(*a, length=t, interpret=True, gate_dtype=jgate)
        return (jnp.sum(c_t.astype(jnp.float32) * wc) + jnp.sum(h_t.astype(jnp.float32) * wh)
                + jnp.sum(hs.astype(jnp.float32) * whs)), (c_t, h_t, hs)

    (_, jouts), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    (c_t, h_t), hs = ck.convlstm_scan(*targs, length=t, gate_dtype=tgate)
    (torch.sum(c_t.float() * torch.from_numpy(wc)) + torch.sum(h_t.float() * torch.from_numpy(wh))
     + torch.sum(hs.float() * torch.from_numpy(whs))).backward()
    for got, want in zip((c_t, h_t, hs), jouts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32),
                                   atol=fwd_tol, rtol=fwd_tol)
    _assert_grads(("dxg", "dW", "dc0", "dh0"), [a.grad for a in targs], jgrads, grad_tol)


def _old_domain(dtype, f, hw, cin):
    """The shapes the CUDA wrappers took before the general kernels: bf16 at
    F a multiple of 16 up to 128 or of 32 up to 256, f32 at F a multiple of
    16 up to 128, H*W <= 64, K5's C a multiple of 16 with at least 4 stages
    in both of its rings."""
    narrow = f % 16 == 0 and 0 < f <= 128
    wide = dtype == torch.bfloat16 and f % 32 == 0 and 128 < f <= 256
    if not (narrow or wide) or hw > 64 or (cin is not None and cin % 16):
        return False
    if cin is None:
        return True
    geo = ck.proj_geometry(64, 20, 8, 8, cin, f, 4 if dtype == torch.float32 else 2)
    return min(geo["fwd_stages"], geo["bwd_stages"]) >= 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_route_keeps_every_wgmma_shape(dtype):
    """Every shape the wgmma kernels took keeps their route, and every other
    one takes the general kernels: F 1-288, H*W 1-256, K5's C 1-512 (every
    multiple of 16 and a few others) and K6."""
    feats = range(1, 289)
    for hw in (1, 30, 63, 64, 65, 81, 256):
        for cin in (None, 1, 8, 16, 24, 48, 64, 128, 160, 256, 384, 512):
            for f in feats:
                want = "wgmma" if _old_domain(dtype, f, hw, cin) else "general"
                assert ck.route(dtype, f, hw, cin) == want, (dtype, f, hw, cin)


@pytest.mark.parametrize("name,overrides,dtype,f", [
    ("seq_vae", (), torch.bfloat16, 128),
    ("pred_vae", ("model.kwargs.fused=true",), torch.bfloat16, 128),
    ("hier_vae", ("model.kwargs.fused=true",), torch.bfloat16, 128),
    ("seq_vae", ("model.kwargs.lstm_features=192",), torch.bfloat16, 192),
    ("seq_vae", ("model.dtype=float32",), torch.float32, 128),
], ids=["config3", "config4-fused", "config5-fused", "probe", "config3-f32"])
def test_route_of_the_configs_is_wgmma(name, overrides, dtype, f):
    """Configs 3-5 (8x8 latent grid, C = F = 128), the probe (F = 192) and
    config 3 in f32 run the wgmma kernels, as before; the probe in f32 runs
    the general ones."""
    from mmvae_torch.configs import get_config

    kw = get_config(name, overrides).model.kwargs
    assert kw.get("lstm_features", 128) == f
    assert ck.route(dtype, f, 64, 128) == ck.route(dtype, f, 64) == "wgmma"
    assert ck.route(torch.float32, 192, 64, 128) == "general"


def test_smoke_keeps_the_jax_packages_small_widths():
    """chip_smoke.py's copy of `__graft_entry__._DRYRUN_TINY` (the smoke
    imports neither it nor mmvae_tpu) equals it for configs 3-5."""
    import __graft_entry__
    import chip_smoke

    assert set(chip_smoke._JAX_TINY) == {"seq_vae", "pred_vae", "hier_vae"}
    for name, kw in chip_smoke._JAX_TINY.items():
        assert kw == __graft_entry__._DRYRUN_TINY[name], name


def test_roofline_counts_the_16x16_grid():
    """The bounds count a 16x16 grid's taps inside the image, (3 16 - 2)^2
    = 2,116 of 2,304 (position, tap) pairs, and the same work whichever
    kernels run: K5's forward at (64, 20, 16, 16, 128, 128) is 2 B T 4F (HW C
    + 2,116 F) operations, its backward twice that; K6's forward 2 B T
    2,116 F 4F; in bf16 over 989 TFLOP/s, in f32 over 3xTF32's rate."""
    from mmvae_torch.bench.roofline import (BF16_TENSOR_FLOPS, TF32_3X_FLOPS, _taps, bound,
                                            kernel_work)

    assert _taps(16, 16) == 2116 and _taps(8, 8) == 484
    b, t, c, f = 64, 20, 128, 128
    ops = 2 * b * t * 4 * f * (256 * c + 2116 * f)
    assert kernel_work("convlstm_proj_forward", (b, t, 16, 16, c, f))[0] == ops
    assert kernel_work("convlstm_proj_backward", (b, t, 16, 16, c, f))[0] == 2 * ops
    assert kernel_work("convlstm_scan_forward", (b, t, 16, 16, f, True))[0] == (
        2 * b * t * 2116 * f * 4 * f)
    for e, peak in ((2, BF16_TENSOR_FLOPS), (4, TF32_3X_FLOPS)):
        ms, by = bound("convlstm_proj_forward", (b, t, 16, 16, c, f, e))
        assert by == "operations" and ms == pytest.approx(ops / peak * 1e3)
