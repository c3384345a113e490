"""mmvae_torch ops against mmvae_tpu: seeds, ELBO reduce (K1), sampling (K2),
preprocess / resident gather (K3 + K4).

Inputs come from numpy seeds and go through the JAX function and the port's
counterpart.  On the CPU the port's kernel wrappers run their plain PyTorch
versions; the JAX Pallas kernels run in interpret mode.  The kernels
themselves are tested on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mmvae_tpu.data import transforms as jtransforms
from mmvae_tpu.ops import elbo_ref as jref
from mmvae_tpu.ops import seeds as jseeds
from mmvae_tpu.ops.elbo_pallas import elbo_reduce_pallas
from mmvae_tpu.ops.preprocess_pallas import preprocess_packed_pallas, preprocess_pallas
from mmvae_torch.data import transforms
from mmvae_torch.ops import convlstm_kernels, dispatch, elbo_kernels, preprocess_kernels, seeds
from mmvae_torch.ops import head_kernels

# The shapes of tests/test_elbo.py, including the deliberately unaligned one.
SHAPES = [
    ((4, 64, 64), (4, 20)),
    ((2, 8, 64, 64), (2, 64)),
    ((3, 17), (3, 5)),
    ((1, 4096), (1, 128)),
]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- seeds ------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 2, 1000, 2**20 + 7, 2**31 - 1, 3_000_000_000])
def test_step_seed_wraps_like_int32(step):
    want = int(jnp.asarray(step & 0xFFFFFFFF, jnp.uint32).astype(jnp.int32)
               * jnp.int32(1103515245) + jnp.int32(12345))
    assert seeds.step_seed(step) == want


@pytest.mark.parametrize("seed", [0, 12345, -7, 2**31 - 1, -(2**31)])
@pytest.mark.parametrize("salt", [0, 1, 5])
def test_stream_seed_matches_jax(seed, salt):
    for stream in (seeds.STREAM_PREPROCESS, seeds.STREAM_REPARAM, seeds.STREAM_ONGEN):
        want = int(jseeds.stream_seed(jnp.int32(seed), stream, salt))
        assert seeds.stream_seed(seed, stream, salt) == want


# --- K1: ELBO reduce ----------------------------------------------------------


@pytest.mark.parametrize("big,small", SHAPES)
def test_elbo_reduce_plain_matches_jax(big, small):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=big).astype(np.float32) * 2
    x = (rng.uniform(size=big) < 0.4).astype(np.float32)
    mu = rng.normal(size=small).astype(np.float32)
    lv = (rng.normal(size=small) * 0.5).astype(np.float32)

    tl = _t(logits).requires_grad_()
    tm, tv = _t(mu).requires_grad_(), _t(lv).requires_grad_()
    bce, kl = elbo_kernels.elbo_reduce(tl, _t(x), tm, tv)
    (bce + 0.7 * kl).backward()
    bce, kl = bce.detach(), kl.detach()

    for impl in (jref.elbo_parts_ref, lambda *a: elbo_reduce_pallas(*a, interpret=True)):
        jb, jk = impl(jnp.asarray(logits), jnp.asarray(x), jnp.asarray(mu), jnp.asarray(lv))
        # f32 sums of up to ~131k terms in different orders (tests/test_elbo.py).
        np.testing.assert_allclose(float(bce), float(jb), rtol=5e-6)
        np.testing.assert_allclose(float(kl), float(jk), rtol=1e-5)

    def jloss(l, m, v):
        b, k = elbo_reduce_pallas(l, jnp.asarray(x), m, v, interpret=True)
        return b + 0.7 * k

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(logits), jnp.asarray(mu), jnp.asarray(lv)
    )
    for got, want in zip((tl.grad, tm.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_elbo_reduce_grad_at_zero_logits_is_the_kernels():
    """The BCE gradient at a logit of exactly 0 differs between the
    reference's two backends, and the port takes the kernel's.  K1's plain
    backward gives sigmoid(0) - t = 1/2 - t, as `elbo_reduce_pallas`'s VJP
    does in interpret mode; `elbo_ref`'s autodiff of max(l, 0) - l t +
    log1p(exp(-|l|)) gives -t there (both kinks' subgradients are 0)."""
    t = np.array([[0.0, 1.0, 0.0, 1.0]], np.float32)
    logits = np.zeros_like(t)
    mu, lv = np.zeros((1, 2), np.float32), np.zeros((1, 2), np.float32)
    tl = _t(logits).requires_grad_()
    bce, _ = elbo_kernels.elbo_reduce(tl, _t(t), _t(mu), _t(lv))
    bce.backward()

    def grad(impl):
        return np.asarray(jax.grad(lambda l: impl(l, jnp.asarray(t), jnp.asarray(mu),
                                                  jnp.asarray(lv))[0])(jnp.asarray(logits)))

    kernel = grad(lambda *a: elbo_reduce_pallas(*a, interpret=True))
    autodiff = grad(jref.elbo_parts_ref)
    np.testing.assert_array_equal(tl.grad.numpy(), [[0.5, -0.5, 0.5, -0.5]])
    np.testing.assert_array_equal(kernel, [[0.5, -0.5, 0.5, -0.5]])
    np.testing.assert_array_equal(autodiff, [[0.0, -1.0, 0.0, -1.0]])


def test_elbo_reduce_bf16_target_grad_dtype():
    """The binarized bf16 target of the main path: values and d_logits."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
    x = (rng.uniform(size=logits.shape) < 0.5).astype(np.float32)
    tl = _t(logits).requires_grad_()
    tx = _t(x).to(torch.bfloat16)
    bce, _ = elbo_kernels.elbo_reduce(tl, tx, torch.zeros(2, 4), torch.zeros(2, 4))
    bce.backward()
    jb = jref.bce_with_logits_sum(jnp.asarray(logits), jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_allclose(float(bce.detach()), float(jb), rtol=2e-6)
    np.testing.assert_allclose(tl.grad.numpy(), 1 / (1 + np.exp(-logits)) - x, atol=1e-6)


# --- K2: reparameterized sampling --------------------------------------------


@pytest.mark.parametrize("shape", [(4, 8), (3, 5), (64, 128)])
def test_reparameterize_plain_with_injected_eps(shape):
    rng = np.random.default_rng(2)
    mu = rng.normal(size=shape).astype(np.float32)
    lv = (rng.normal(size=shape) * 0.3).astype(np.float32)
    eps = rng.normal(size=shape).astype(np.float32)
    z, sig_eps = elbo_kernels.reparameterize_plain(_t(mu), _t(lv), 0, eps=_t(eps))
    jz = jnp.asarray(mu) + jnp.exp(0.5 * jnp.asarray(lv)) * jnp.asarray(eps)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6)
    np.testing.assert_allclose(sig_eps.numpy(), np.asarray(jz - jnp.asarray(mu)), atol=1e-6)


def test_reparameterize_vjp_matches_jax():
    """The autograd Function's VJP equals the JAX VJP of z = mu + e^{lv/2} eps
    with the eps the forward drew."""
    rng = np.random.default_rng(3)
    mu = rng.normal(size=(5, 7)).astype(np.float32)
    lv = (rng.normal(size=(5, 7)) * 0.5).astype(np.float32)
    g = rng.normal(size=(5, 7)).astype(np.float32)
    tm, tv = _t(mu).requires_grad_(), _t(lv).requires_grad_()
    z = elbo_kernels.reparameterize(tm, tv, 1234)
    z.backward(_t(g))
    eps = ((z.detach() - tm.detach()) / torch.exp(0.5 * tv.detach())).numpy()
    jz, vjp = jax.vjp(lambda m, v: m + jnp.exp(0.5 * v) * jnp.asarray(eps),
                      jnp.asarray(mu), jnp.asarray(lv))
    dm, dv = vjp(jnp.asarray(g))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), atol=1e-6)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(dm), atol=1e-6)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(dv), atol=1e-6)


def test_sample_fn_uses_reparam_stream():
    mu, lv = torch.zeros(4, 16), torch.zeros(4, 16)
    a = dispatch.make_sample_fn(7)(mu, lv)
    want = torch.randn(4, 16, generator=torch.Generator().manual_seed(
        seeds.stream_seed(7, seeds.STREAM_REPARAM)))
    torch.testing.assert_close(a, want)
    assert not torch.equal(a, dispatch.make_sample_fn(7)(mu, lv, salt=1))


def _proj_args():
    z = torch.zeros
    return z(1, 2, 4, 4, 16), z(16, 64), z(64), z(3, 3, 16, 64), z(1, 4, 4, 16), z(1, 4, 4, 16)


_CUDA_PATHS = {
    "preprocess_gather": lambda: preprocess_kernels._preprocess_gather_cuda(
        torch.zeros(3, 1, 4, 4, dtype=torch.uint8), torch.arange(2), 0, True, torch.float32),
    "elbo_reduce": lambda: elbo_kernels._elbo_reduce_cuda(
        torch.zeros(2, 3), torch.zeros(2, 3), torch.zeros(2, 1), torch.zeros(2, 1)),
    "reparameterize": lambda: elbo_kernels._reparameterize_cuda(
        torch.zeros(2, 1), torch.zeros(2, 1), 0),
    "head_sample_forward": lambda: head_kernels.head_sample_forward_cuda(
        torch.zeros(2, 8), torch.zeros(3, 8), torch.zeros(3), torch.zeros(3, 8), torch.zeros(3),
        0),
    "head_sample_backward": lambda: head_kernels.head_sample_backward_cuda(
        torch.zeros(2, 8), torch.zeros(3, 8), torch.zeros(3, 8), torch.zeros(2, 3), None,
        None, torch.zeros(2, 3)),
    "convlstm_proj_forward": lambda: convlstm_kernels.proj_forward_cuda(
        *_proj_args(), torch.float32, True),
    "convlstm_proj_backward": lambda: convlstm_kernels.proj_backward_cuda(
        *[_proj_args()[i] for i in (0, 1, 3, 4, 5)], torch.zeros(1, 2, 16, 16),
        torch.zeros(1, 2, 16, 16), torch.zeros(1, 2, 16, 64), torch.zeros(1, 4, 4, 16),
        torch.zeros(1, 4, 4, 16)),
}


@pytest.mark.parametrize("name", sorted(_CUDA_PATHS))
def test_kernel_path_refuses_cpu_tensors(name):
    """A kernel's CUDA path raises for CPU tensors before it builds or
    launches anything: the plain version is reached only through the
    wrapper's device test, never as a fallback inside the kernel path."""
    with pytest.raises(ValueError, match="cuda"):
        _CUDA_PATHS[name]()


# --- K3 + K4: preprocess / resident gather ------------------------------------


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_preprocess_gather_normalize_exact(out_dtype):
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, size=(6, 4, 64, 64), dtype=np.uint8)
    idx = np.array([5, 0, 3, 3])
    got = preprocess_kernels.preprocess_gather(
        _t(u8), _t(idx), 11, binarize=False, out_dtype=out_dtype
    )
    jdt = jnp.bfloat16 if out_dtype == torch.bfloat16 else jnp.float32
    want_k3 = preprocess_pallas(jnp.asarray(u8[idx]), jnp.int32(11), binarize=False,
                                interpret=True, out_dtype=jdt)
    want_k4 = preprocess_packed_pallas(
        jnp.asarray(jtransforms.pack_resident(u8)[idx]), jnp.int32(11), (4, 64, 64),
        binarize=False, interpret=True, out_dtype=jdt,
    )
    for want in (want_k3, want_k4):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_preprocess_gather_binarize_rule_with_injected_uniforms():
    """With the uniforms injected, binarize is exactly the rule
    uniform < normalize(u8) of transforms.binarize, uniform = u24 / 2^24."""
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, size=(3, 2, 32, 32), dtype=np.uint8)
    idx = np.array([2, 0])
    u24 = rng.integers(0, 1 << 24, size=(2, 2, 32, 32))
    got = preprocess_kernels.preprocess_gather_plain(
        _t(u8), _t(idx), 0, binarize=True, u24=_t(u24)
    )
    uniform = jnp.asarray(u24, jnp.float32) * (1.0 / (1 << 24))
    want = (uniform < jtransforms.normalize(jnp.asarray(u8[idx]))).astype(jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_preprocess_gather_binarize_probability():
    """P(on) = u8 / 255 for every u8 value (binomial 5-sigma band)."""
    ramp = (torch.arange(16 * 4096) % 256).to(torch.uint8).view(16, 4096)
    out = preprocess_kernels.preprocess_gather(ramp, torch.arange(16), 99)
    vals = ramp.flatten().long()
    rate = torch.zeros(256).index_add_(0, vals, out.flatten()) / 256.0
    p = torch.arange(256) / 255.0
    sigma = torch.sqrt(p * (1 - p) / 256.0).clamp_min(1 / 256.0)
    assert float(((rate - p).abs() / sigma).max()) <= 5.0
    assert float(rate[0]) == 0.0 and float(rate[255]) == 1.0


def test_transforms_match_jax():
    """normalize is exact; binarize keeps the rule uniform < x (P(on) = u8 / 255)
    and preprocess without a generator is normalize."""
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, size=(2, 3, 16, 16), dtype=np.uint8)
    want = np.asarray(jtransforms.preprocess(jnp.asarray(u8)))
    np.testing.assert_array_equal(transforms.normalize(_t(u8)).numpy(), want)
    np.testing.assert_array_equal(transforms.preprocess(_t(u8)).numpy(), want)
    x = torch.full((200_000,), 0.3)
    gen = torch.Generator().manual_seed(0)
    rate = float(transforms.binarize(x, gen).mean())
    jrate = float(jtransforms.binarize(jnp.full((200_000,), 0.3), jax.random.PRNGKey(0)).mean())
    for r in (rate, jrate):  # 5 sigma of 200k Bernoulli(0.3) draws is 0.0051
        assert abs(r - 0.3) < 0.0051
    ramp = _t(np.arange(256, dtype=np.uint8))
    on = transforms.preprocess(ramp, torch.Generator().manual_seed(1))
    assert float(on[0]) == 0.0 and float(on[255]) == 1.0


def test_preprocess_gather_clamps_out_of_range_rows():
    u8 = torch.randint(0, 256, (3, 2, 4, 4), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(1))
    got = preprocess_kernels.preprocess_gather(u8, torch.tensor([-5, 1, 3, 99]), 0,
                                               binarize=False)
    torch.testing.assert_close(got, u8[[0, 1, 2, 2]].float() * (1.0 / 255.0), rtol=0, atol=0)


def test_preprocess_dispatch_uses_preprocess_stream():
    u8 = torch.randint(0, 256, (4, 2, 8, 8), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0))
    idx = torch.tensor([1, 3])
    got = dispatch.preprocess_gather(u8, idx, 5, binarize=True, out_dtype=torch.float32)
    want = preprocess_kernels.preprocess_gather_plain(
        u8, idx, seeds.stream_seed(5, seeds.STREAM_PREPROCESS), binarize=True
    )
    torch.testing.assert_close(got, want)
