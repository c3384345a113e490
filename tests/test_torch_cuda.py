"""mmvae_torch's CUDA and Triton kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
neither jax nor mmvae_tpu, so it runs on a GPU host that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: tests/conftest.py sets up jax for the JAX package's tests.)
"""

import math

import pytest
import torch

from mmvae_torch import ops
from mmvae_torch.configs import get_config
from mmvae_torch.ops import convlstm_kernels as ck
from mmvae_torch.ops import elbo_kernels, preprocess_kernels
from mmvae_torch.train.loop import build_model, make_train_step
from mmvae_torch.train.state import create_train_state

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_preprocess_matches_plain(dev, out_dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    data = torch.randint(0, 256, (9, 3, 17, 5), generator=g, device=dev, dtype=torch.uint8)
    idx = torch.tensor([8, 0, 4, -2, 11], device=dev)  # the last two are clamped
    got = preprocess_kernels.preprocess_gather(data, idx, 3, binarize=False, out_dtype=out_dtype)
    want = preprocess_kernels.preprocess_gather_plain(data, idx, 3, binarize=False,
                                                      out_dtype=out_dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="cuda"):
        preprocess_kernels.preprocess_gather(data, idx.cpu(), 3)


def test_preprocess_binarize_bits_follow_the_seed(dev):
    data = torch.full((4, 2, 64, 64), 128, device=dev, dtype=torch.uint8)
    idx = torch.arange(4, device=dev)
    a = preprocess_kernels.preprocess_gather(data, idx, 5)
    assert torch.equal(a, preprocess_kernels.preprocess_gather(data, idx, 5))
    assert not torch.equal(a, preprocess_kernels.preprocess_gather(data, idx, 6))
    assert abs(float(a.mean()) - 128 / 255) < 0.01  # 32k Bernoulli draws: 5 sigma = 0.014


def test_elbo_reduce_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    logits = torch.randn(3, 17, generator=g, device=dev).requires_grad_()
    x = (torch.rand(3, 17, generator=g, device=dev) < 0.5).to(torch.bfloat16)
    mu = torch.randn(3, 5, generator=g, device=dev).requires_grad_()
    lv = (torch.randn(3, 5, generator=g, device=dev) * 0.5).requires_grad_()
    bce, kl = elbo_kernels.elbo_reduce(logits, x, mu, lv)
    (bce + 0.7 * kl).backward()
    want = elbo_kernels.elbo_reduce_plain(logits.detach(), x, mu.detach(), lv.detach())
    for a, b in zip((bce, kl), want):
        torch.testing.assert_close(a.detach(), b, rtol=2e-5, atol=1e-5)
    torch.testing.assert_close(logits.grad, torch.sigmoid(logits.detach()) - x.float())
    torch.testing.assert_close(mu.grad, 0.7 * mu.detach())
    torch.testing.assert_close(lv.grad, 0.35 * (torch.exp(lv.detach()) - 1.0))


def test_reparameterize_formula_and_vjp(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    mu = torch.randn(3, 5, generator=g, device=dev).requires_grad_()
    lv = (torch.randn(3, 5, generator=g, device=dev) * 0.5).requires_grad_()
    z = elbo_kernels.reparameterize(mu, lv, 1234)
    cot = torch.randn(3, 5, generator=g, device=dev)
    z.backward(cot)
    eps = (z.detach() - mu.detach()) / torch.exp(0.5 * lv.detach())
    zp, _ = elbo_kernels.reparameterize_plain(mu.detach(), lv.detach(), 0, eps=eps)
    torch.testing.assert_close(z.detach(), zp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mu.grad, cot, rtol=0, atol=0)
    torch.testing.assert_close(lv.grad, 0.5 * cot * (z.detach() - mu.detach()))


def _proj_args(dev, dtype, b, t, h, w, c, f):
    g = torch.Generator(device=dev).manual_seed(6)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    return (rn(b, t, h, w, c, scale=0.5), rn(c, 4 * f, scale=c ** -0.5), rn(4 * f, scale=0.1),
            rn(3, 3, f, 4 * f, scale=(9 * f) ** -0.5), rn(b, h, w, f, scale=0.5),
            rn(b, h, w, f, scale=0.5))


def _assert_within_bf16_ulps(got, want, ulps):
    """max|got - want| <= `ulps` bf16 ulps of want's largest magnitude."""
    m = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(max(m, 2.0 ** -126))) - 7)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ulps * ulp, f"max|err| {err} > {ulps} bf16 ulps of {m}"


@pytest.mark.parametrize("gate_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 7, 5, 6, 48, 32), (2, 4, 7, 9, 32, 16)])
def test_proj_kernel_matches_plain(dev, shape, gate_dtype):
    """Unaligned positions (5x6, 7x9) and odd T.  The same operands are
    rounded to bf16 on both sides: 2 bf16 ulps of each tensor's largest
    value, except the bf16-gate forward, which rounds the pointwise chain at
    each step (0.05, tests/test_convlstm_fused.py's bf16 tolerance)."""
    args = _proj_args(dev, torch.bfloat16, *shape)
    outs_k = ck.proj_forward_cuda(*args, gate_dtype, True)
    outs_p = ck.proj_forward_plain(*args, gate_dtype, True)
    for a, b_ in zip(outs_k, outs_p):
        if gate_dtype == torch.float32:
            _assert_within_bf16_ulps(a, b_, 2)
        else:
            torch.testing.assert_close(a.float(), b_.float(), rtol=0, atol=0.05)
    last = ck.proj_forward_cuda(*args, gate_dtype, False)
    assert torch.equal(last[0], outs_k[0][:, -1]) and torch.equal(last[1], outs_k[1][:, -1])
    g = torch.Generator(device=dev).manual_seed(7)
    dh = torch.randn(args[4].shape, generator=g, device=dev)
    x, wx, _, wh, c0, h0 = args
    gk = ck.proj_backward_cuda(x, wx, wh, c0, h0, *outs_p, dh, dh)
    gp = ck.proj_backward_plain(x, wx, wh, c0, h0, *outs_p, dh, dh)
    for a, b_ in zip(gk, gp):
        _assert_within_bf16_ulps(a, b_, 2)


def test_proj_kernel_refuses_f32_activations(dev):
    args = _proj_args(dev, torch.float32, 2, 3, 4, 4, 16, 16)
    with pytest.raises(TypeError, match="bfloat16"):
        ck.proj_forward_cuda(*args, torch.float32, True)


def test_train_step_launches_every_kernel(dev):
    cfg = get_config("seq_vae")
    cfg.model.kwargs.update(latent_dim=8, enc_channels=(16, 32, 32), lstm_features=16)
    cfg.data.batch_size, cfg.data.seq_len = 2, 4
    model = build_model(cfg, dev)
    state = create_train_state(model, cfg.optim)
    step = make_train_step(model, resident_batch=2)
    data = torch.randint(0, 256, (6, 4, 64, 64), device=dev, dtype=torch.uint8)
    ops.reset_launch_counts()
    losses = [float(step(state, data)["loss"]) for _ in range(2)]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert all(n == 2 for n in ops.launch_counts().values()), ops.launch_counts()
