"""The fused Gaussian head and sample (`mmvae_torch.ops.head_kernels`) against
mmvae_tpu, on the CPU.

The JAX side is flax's `GaussianHead` (seq_vae and pred_vae) or the two
`nn.Dense` of hier_vae's heads, then z = mu + exp(logvar / 2) eps with eps
injected, and `jax.vjp` for the cotangents on (mu, logvar, z).  The inputs
come from numpy seeds.  On the CPU the op runs its plain version (two f32
Linears, the sample) with its own backward formulas; the CUDA kernels are
held to the same plain version on the card (tests/test_torch_cuda.py).

Tolerance: every f32 tensor within 1e-5 of its largest |ref| (f32 products
over at most 64 terms, summed in other orders); a bf16 dx within one bf16
ulp of its largest |ref| (both sides round one f32 sum once, and may fall
on two sides of a rounding boundary).
"""

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from mmvae_tpu.models.base import GaussianHead as JGaussianHead
from mmvae_torch.bench.roofline import (HBM_BYTES, TF32_3X_FLOPS, TF32_TENSOR_FLOPS, bound,
                                        kernel_work)
from mmvae_torch.configs import get_config
from mmvae_torch.models.base import GaussianHead, head_and_sample
from mmvae_torch.ops import dispatch, elbo_kernels, head_kernels, seeds
from mmvae_torch.train.loop import build_model

# (M, K, N): the sampling sites scaled down (seq_vae / pred_vae: B x g*g*F
# -> latent; hier_vae global: B x chunk_feature -> global latent; hier_vae
# chunk: B*K x 256 -> chunk latent), one unaligned shape, and a latent
# width past 656 (several latent blocks in the kernels' backward).
SITES = {"seq": (4, 2 * 2 * 8, 8), "hier_global": (3, 16, 8), "hier_chunk": (10, 16, 4),
         "unaligned": (5, 37, 3), "wide": (4, 64, 700)}


@pytest.fixture(autouse=True)
def _full_precision_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


class _TwoDense(fnn.Module):
    """hier_vae's heads: two f32 Dense on the same input."""

    latent: int

    @fnn.compact
    def __call__(self, h):
        return (fnn.Dense(self.latent, dtype=jnp.float32, name="mu")(h),
                fnn.Dense(self.latent, dtype=jnp.float32, name="logvar")(h))


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    return dict(x=f(m, k), w_mu=f(k, n, scale=k ** -0.5), b_mu=f(n, scale=0.1),
                w_lv=f(k, n, scale=k ** -0.5), b_lv=f(n, scale=0.1), eps=f(m, n),
                g_mu=f(m, n), g_lv=f(m, n), g_z=f(m, n))


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("site", list(SITES))
def test_head_sample_matches_jax(site, x_dtype):
    m, k, n = SITES[site]
    d = _inputs(m, k, n)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[x_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[x_dtype]
    x_j = jnp.asarray(d["x"]).astype(jdt)
    # hier_vae's heads read f32 features; a bf16 x is the GaussianHead's
    # case (one cast, where two Dense on a bf16 input would each cast)
    module = (_TwoDense(latent=n) if site.startswith("hier") and x_dtype == "float32"
              else JGaussianHead(latent_dim=n))
    params = {"params": {"mu": {"kernel": d["w_mu"], "bias": d["b_mu"]},
                         "logvar": {"kernel": d["w_lv"], "bias": d["b_lv"]}}}

    def jhead(x, p):
        mu, lv = module.apply(p, x)
        return mu, lv, mu + jnp.exp(0.5 * lv) * d["eps"]

    (jmu, jlv, jz), vjp = jax.vjp(jhead, x_j, params)
    jdx, jdp = vjp((jnp.asarray(d["g_mu"]), jnp.asarray(d["g_lv"]), jnp.asarray(d["g_z"])))

    x = torch.tensor(np.asarray(x_j.astype(jnp.float32))).to(tdt).requires_grad_()
    w = {name: torch.from_numpy(d[name].T.copy() if name.startswith("w") else d[name])
         .requires_grad_() for name in ("w_mu", "b_mu", "w_lv", "b_lv")}
    outs = head_kernels.gaussian_head_sample(x, w["w_mu"], w["b_mu"], w["w_lv"], w["b_lv"],
                                             0, torch.from_numpy(d["eps"]))
    torch.autograd.backward(outs, [torch.from_numpy(d[g]) for g in ("g_mu", "g_lv", "g_z")])

    for name, got, want in zip(("mu", "logvar", "z"), outs, (jmu, jlv, jz)):
        _close(got, want, 1e-5, name)
    assert x.grad.dtype == tdt
    jdx = np.asarray(jdx.astype(jnp.float32))
    if x_dtype == "bfloat16":  # one bf16 ulp of the largest |ref|
        ulp = 2.0 ** (np.floor(np.log2(np.abs(jdx).max())) - 7)
        np.testing.assert_allclose(x.grad.float().numpy(), jdx, rtol=0, atol=ulp, err_msg="dx")
    else:
        _close(x.grad, jdx, 1e-5, "dx")
    jp = jdp["params"]
    _close(w["w_mu"].grad, np.asarray(jp["mu"]["kernel"]).T, 1e-5, "dW_mu")
    _close(w["b_mu"].grad, jp["mu"]["bias"], 1e-5, "db_mu")
    _close(w["w_lv"].grad, np.asarray(jp["logvar"]["kernel"]).T, 1e-5, "dW_logvar")
    _close(w["b_lv"].grad, jp["logvar"]["bias"], 1e-5, "db_logvar")


@pytest.mark.parametrize("absent", ["g_mu", "g_lv", "g_z"])
def test_head_sample_backward_with_an_unused_output(absent):
    """An output that takes no part in the loss gets no cotangent (None):
    the backward treats it as zeros, as autograd through two Linears does."""
    m, k, n = SITES["unaligned"]
    d = _inputs(m, k, n, seed=1)
    x = torch.from_numpy(d["x"]).requires_grad_()
    w = [torch.from_numpy(d[nm].T.copy() if nm.startswith("w") else d[nm]).requires_grad_()
         for nm in ("w_mu", "b_mu", "w_lv", "b_lv")]
    used = [(o, torch.from_numpy(d[g])) for o, g in zip(
        head_kernels.gaussian_head_sample(x, *w, 0, torch.from_numpy(d["eps"])),
        ("g_mu", "g_lv", "g_z")) if g != absent]
    torch.autograd.backward([o for o, _ in used], [c for _, c in used])
    got = [x.grad] + [t.grad for t in w]
    xr = torch.from_numpy(d["x"]).requires_grad_()
    wr = [t.detach().clone().requires_grad_() for t in w]
    ref = head_kernels.gaussian_head_sample_plain(xr, *wr, 0, torch.from_numpy(d["eps"]))
    torch.autograd.backward([o for o, g in zip(ref, ("g_mu", "g_lv", "g_z")) if g != absent],
                            [c for _, c in used])
    for a, b in zip(got, [xr.grad] + [t.grad for t in wr]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_head_and_sample_dispatch_equals_the_bare_route(x_dtype):
    """The step's sample function takes the fused op; a bare callable drawing
    from the same stream takes two linear_f32 and K2.  On the CPU the two
    give the same bits, forward and backward."""
    torch.manual_seed(0)
    head = GaussianHead(2 * 2 * 8, 5, device="cpu")
    h = torch.randn(6, 2, 2, 8).to(x_dtype)
    sample_fn = dispatch.make_sample_fn(11)

    def bare(m, v, salt=0):
        return elbo_kernels.reparameterize(m, v, sample_fn.stream_seed(salt))

    cot = [torch.randn(6, 5) for _ in range(3)]
    results = []
    for fn in (sample_fn, bare):
        head.zero_grad(set_to_none=True)
        hx = h.clone().requires_grad_()
        outs = head.sample(hx, fn)
        torch.autograd.backward(outs, cot)
        results.append([*outs, hx.grad, *(p.grad for p in head.parameters())])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["seq_vae", "hier_vae"])
def test_model_step_dispatch_equals_the_bare_route(name):
    """A whole model (hier_vae: both sites, salts 0 and 1) gives the same
    loss and gradients through the fused heads as through the bare route."""
    cfg = get_config(name)
    cfg.model.kwargs.update(enc_channels=(4, 8), lstm_features=8, image_size=16)
    cfg.model.kwargs.update({"seq_vae": {"latent_dim": 6},
                             "hier_vae": {"chunk_len": 2, "global_latent": 6,
                                          "chunk_latent": 3, "chunk_feature": 12}}[name])
    x = (torch.rand(2, 4, 16, 16, generator=torch.Generator().manual_seed(0)) < 0.4).float()
    sample_fn = dispatch.make_sample_fn(5)

    def bare(m, v, salt=0):
        return elbo_kernels.reparameterize(m, v, sample_fn.stream_seed(salt))

    results = []
    for fn in (sample_fn, bare):
        model = build_model(cfg, device="cpu")
        out = model(x, fn)
        bce, kl = elbo_kernels.elbo_reduce(out.logits, out.target, out.mu, out.logvar)
        loss = bce + kl + out.extra_kl
        loss.backward()
        results.append([loss, out.z] + [p.grad for p in model.parameters()])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_sample_fn_names_its_stream_and_carries_eps():
    fn = dispatch.make_sample_fn(7, {1: torch.ones(2, 3)})
    assert fn.stream_seed(0) == seeds.stream_seed(7, seeds.STREAM_REPARAM)
    assert fn.stream_seed(1) == seeds.stream_seed(7, seeds.STREAM_REPARAM, 1)
    assert fn.noise(0) is None
    torch.testing.assert_close(fn.noise(1), torch.ones(2, 3), rtol=0, atol=0)


def test_head_and_sample_takes_the_injected_eps():
    torch.manual_seed(1)
    lin_mu, lin_lv = torch.nn.Linear(9, 4), torch.nn.Linear(9, 4)
    x, eps = torch.randn(3, 9), torch.randn(3, 4)
    mu, lv, z = head_and_sample(x, lin_mu, lin_lv, dispatch.make_sample_fn(3, {1: eps}), salt=1)
    torch.testing.assert_close(mu, lin_mu(x), rtol=0, atol=0)
    torch.testing.assert_close(z, lin_mu(x) + torch.exp(0.5 * lin_lv(x)) * eps, rtol=0, atol=0)


def test_head_roofline_counts():
    """(64, 8192, 128) with bf16 x, the flagship head: the forward is 268
    MFLOP of f32-accurate products over 9.57 MB, the backward twice the
    products over 19.0 MB.  Counted at the split-TF32 rate (two TF32 passes
    against a bf16 x, three for dx), both are bound by their bytes: 2.9 and
    5.7 us."""
    shape = (64, 8192, 128, 2)
    flops, nbytes = kernel_work("head_sample_forward", shape)
    assert flops == pytest.approx(268.4e6, rel=1e-3)
    assert nbytes == pytest.approx(9.57e6, rel=1e-3)
    assert bound("head_sample_forward", shape) == (pytest.approx(0.00286, rel=0.01), "bytes")
    assert flops / TF32_3X_FLOPS < nbytes / HBM_BYTES
    flops, nbytes = kernel_work("head_sample_backward", shape)
    assert flops == pytest.approx(536.9e6, rel=1e-3)
    assert nbytes == pytest.approx(19.0e6, rel=1e-2)
    assert bound("head_sample_backward", shape) == (pytest.approx(0.00567, rel=0.01), "bytes")
    # a latent width of 1024 at K = 256 with f32 x: 1.10 GFLOP over 19.9 MB,
    # bound by its operations at the three-pass rate
    assert bound("head_sample_forward", (1024, 256, 1024, 4)) == (
        pytest.approx(1.101e9 * 3 / TF32_TENSOR_FLOPS * 1e3, rel=1e-2), "operations")
    # a batch of 256 with bf16 x: the forward's 1.07 GFLOP take two passes
    # (4.34 us, not the 6.5 of three), the backward's dW two and dx three
    shape = (256, 8192, 128, 2)
    assert bound("head_sample_forward", shape) == (pytest.approx(0.00434, rel=0.01),
                                                   "operations")
    assert bound("head_sample_backward", shape) == (pytest.approx(0.01085, rel=0.01),
                                                    "operations")


@pytest.mark.parametrize("shape", [(64, 8192, 128, 2), (16, 256, 128, 4), (160, 256, 64, 4),
                                   (5, 37, 3, 2), (256, 8192, 128, 2), (320, 256, 64, 4),
                                   (64, 8192, 657, 2), (64, 8192, 1024, 2), (64, 256, 1024, 4)])
def test_head_geometry_fits_the_card(shape):
    """The kernels fit in shared memory at every site, at larger batches and
    at latent widths past 656; the forward's K slices cover K; the
    backward's K tiles cover K and its latent blocks N, at most 128 latent
    columns a block.  The flagship head's forward runs 128 CTAs, its
    backward 128 (one latent block).  The backward's shared bytes depend on
    neither the batch nor, past 128, the latent width, so every latent
    width fits, N = 657 among them."""
    m, k, n, xb = shape
    geo = head_kernels.head_geometry(m, k, n, xb)
    assert geo["fwd_smem"] <= head_kernels.SMEM_LIMIT
    assert geo["bwd_smem"] <= head_kernels.SMEM_LIMIT
    assert 1 <= geo["fwd_splits"] <= 8
    assert geo["fwd_splits"] * geo["fwd_kslice"] >= k
    assert (geo["fwd_splits"] - 1) * geo["fwd_kslice"] < k
    assert geo["fwd_grid"][1] * 8 >= n and geo["fwd_grid"][2] * 64 >= m
    tiles, blocks = geo["bwd_grid"]
    lb = geo["bwd_latent"]
    assert lb % 8 == 0 and 8 <= lb <= 128
    assert tiles * 64 >= k > (tiles - 1) * 64
    assert blocks * lb >= n > (blocks - 1) * lb
    assert geo["bwd_rows"] == 64
    assert lb >= min(n, 128) and lb & (lb - 1) == 0  # a power of two
    if shape == (64, 8192, 128, 2):
        assert geo["fwd_grid"] == (8, 16, 1) and geo["fwd_stages"] == 8
        assert geo["fwd_smem"] == 8 * (64 * 136 * 2 + 16 * 132 * 4) == 206848
        assert geo["bwd_grid"] == (128, 1) and lb == 128
        # the W tile in f32, D's TF32 hi and lo cores, x^T's hi and lo cores
        assert geo["bwd_smem"] == 256 * 64 * 4 * 3 + 2 * 64 * 64 * 4 == 229376
    if (k, n) == (256, 128):  # config 5's global head: 4 K tiles, one latent block
        assert geo["bwd_grid"] == (4, 1) and lb == 128
    if n > 128:
        assert lb == 128 and blocks == -(-n // 128)
    big = head_kernels.head_geometry(100_000, k, n, xb)
    assert big["bwd_smem"] == geo["bwd_smem"] and big["bwd_grid"] == geo["bwd_grid"]
    for b in (4, 2):
        widest = max(head_kernels.head_geometry(64, 8192, w, b)["bwd_smem"]
                     for w in range(1, 4097))
        assert widest <= head_kernels.SMEM_LIMIT
        assert head_kernels.head_geometry(1, 64, 657, b)["bwd_smem"] <= head_kernels.SMEM_LIMIT
