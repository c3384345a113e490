"""K6 (`convlstm_scan`) in the port against mmvae_tpu, and the `fused` policy.

K6's plain version (what the port runs on the CPU) is held against the
Pallas kernel `convlstm_scan_pallas` in interpret mode in every mode
(streaming or time-constant xg, full hs or last-only) with f32 and bf16
gates, forward and the gradients of xg, w, c0 and h0.  Then: which
recurrence each `fused` setting of the port's ConvLSTM runs, and the
seq_vae `fused` kwarg (a fault of the port: it raised TypeError) against
the JAX model with fused=True, whose decoder runs K6.
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mmvae_tpu.models.seq_vae import ConvLSTMSeqVAE as JSeqVAE
from mmvae_tpu.ops.convlstm_pallas import convlstm_scan_pallas
from mmvae_tpu.ops.elbo_pallas import elbo_reduce_pallas
from mmvae_torch.configs import get_config
from mmvae_torch.convert import state_dict_from_flax
from mmvae_torch.models import convlstm as tconvlstm
from mmvae_torch.models.seq_vae import ConvLSTMSeqVAE
from mmvae_torch.ops import convlstm_kernels as ck
from mmvae_torch.ops import kernel_checks
from mmvae_torch.ops.elbo_kernels import elbo_reduce
from mmvae_torch.train.loop import build_model

B, T, S, F = 2, 4, 4, 8
_GRAD_TOL = 2e-4  # tests/test_convlstm_fused.py, f32 on the CPU


@pytest.fixture(autouse=True)
def _full_precision_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _scan_inputs(seed, const, b=B, t=T, s=S, f=F):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(b, 1 if const else t, s, s, 4 * f)).astype(np.float32) * 0.5,
        rng.normal(size=(3, 3, f, 4 * f)).astype(np.float32) * (9 * f) ** -0.5,
        rng.normal(size=(b, s, s, f)).astype(np.float32) * 0.5,
        rng.normal(size=(b, s, s, f)).astype(np.float32) * 0.5,
    ]


# (B, T, S, F): the small shape, and a 4-CTA width of the CUDA kernels (the
# reference's lstm_features=192 probe) at the 8x8 grid of the models.
WIDE = (1, 3, 8, 192)


@pytest.mark.parametrize("last_only", [False, True])
@pytest.mark.parametrize("const", [False, True])
@pytest.mark.parametrize(
    "gate,fwd_tol,grad_tol,shape",
    [
        pytest.param("float32", 2e-5, _GRAD_TOL, (B, T, S, F), id="float32-2e-05-0.0002"),
        # bf16 gates round at different points in the two frameworks
        # (tests/test_convlstm_fused.py:249-269, tests/test_torch_convlstm.py).
        pytest.param("bfloat16", 0.05, 0.08, (B, T, S, F), id="bfloat16-0.05-0.08"),
        pytest.param("float32", 2e-5, _GRAD_TOL, WIDE, id="float32-F192"),
        pytest.param("bfloat16", 0.05, 0.08, WIDE, id="bfloat16-F192"),
    ],
)
def test_scan_plain_matches_pallas_interpret(gate, fwd_tol, grad_tol, shape, const, last_only):
    b, t, s, f = shape
    args = _scan_inputs(0, const, b, t, s, f)
    rng = np.random.default_rng(1)
    wc, wh = (rng.normal(size=(b, s, s, f)).astype(np.float32) for _ in range(2))
    whs = rng.normal(size=(b, t, s, s, f)).astype(np.float32)
    jgate = jnp.bfloat16 if gate == "bfloat16" else jnp.float32
    tgate = torch.bfloat16 if gate == "bfloat16" else torch.float32

    def jloss(*a):
        (c_t, h_t), hs = convlstm_scan_pallas(*a, length=t, interpret=True, gate_dtype=jgate,
                                              last_only=last_only)
        out = jnp.sum(c_t.astype(jnp.float32) * wc) + jnp.sum(h_t.astype(jnp.float32) * wh)
        if hs is not None:
            out = out + jnp.sum(hs.astype(jnp.float32) * whs)
        return out, (c_t, h_t, hs)

    (_, (jc, jh, jhs)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(*[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    (c_t, h_t), hs = ck.convlstm_scan(*targs, length=t, gate_dtype=tgate, last_only=last_only)
    loss = torch.sum(c_t.float() * torch.from_numpy(wc)) + torch.sum(
        h_t.float() * torch.from_numpy(wh))
    assert (hs is None) == last_only
    if hs is not None:
        loss = loss + torch.sum(hs.float() * torch.from_numpy(whs))
    loss.backward()

    outs = [(c_t, jc), (h_t, jh)] + ([(hs, jhs)] if hs is not None else [])
    for got, want in outs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32),
                                   atol=fwd_tol, rtol=fwd_tol)
    for name, ta, ja in zip(("dxg", "dW", "dc0", "dh0"), targs, jgrads):
        want = np.asarray(ja, np.float32)
        assert ta.grad.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(ta.grad.numpy(), want, rtol=grad_tol,
                                   atol=grad_tol * scale, err_msg=name)


@pytest.mark.parametrize("const", [False, True])
def test_scan_no_grad_primals_match_saving_forward(const):
    """The residual-free forwards (every h_t; last-only) give exactly the
    saving forward's hs and c_T."""
    args = [torch.from_numpy(a) for a in _scan_inputs(2, const)]
    hs, cs, ga = ck.scan_forward_plain(*args, T, torch.float32, "save")
    assert ga.shape == (B, T, S * S, 4 * F)
    with torch.no_grad():
        (c1, h1), hs1 = ck.convlstm_scan(*args, length=T)
        (c2, h2), none = ck.convlstm_scan(*args, length=T, last_only=True)
    assert none is None
    torch.testing.assert_close(hs1.reshape(hs.shape), hs, rtol=0, atol=0)
    for c, h in ((c1, h1), (c2, h2)):
        torch.testing.assert_close(c.reshape(B, -1, F), cs[:, -1], rtol=0, atol=0)
        torch.testing.assert_close(h.reshape(B, -1, F), hs[:, -1], rtol=0, atol=0)


@pytest.mark.parametrize("kernel, cs_rtol", [("K5", 0.0), ("K6", kernel_checks.CS_RTOL)])
def test_kernel_check_bf16_gate_bounds(kernel, cs_rtol):
    """The card's bf16-gate forward bounds (`kernel_checks`): hs and gates
    within 0.05; cs within 0.05 for K5 and 0.05 + 2^-6|ref| for K6, so one
    bf16 ulp at |c| = 8 (0.0625) passes K6 only; NaN fails."""
    ref = torch.tensor([0.5, 8.0, -0.25])

    def passes(hs, cs, gates):
        cmp = kernel_checks.Comparison(
            kernel_checks.forward_readings((hs, cs, gates), (ref,) * 3, torch.bfloat16,
                                           cs_rtol), 0.0, 0.0)
        try:
            cmp.check(kernel)
        except AssertionError:
            return False
        return True

    one_ulp = torch.tensor([0.5, 8.0625, -0.25])
    off = torch.tensor([0.5, 8.0, -0.19])  # 0.06 absolute
    assert passes(ref, ref, ref)
    assert passes(ref, one_ulp, ref) == (kernel == "K6")
    assert not passes(off, ref, ref) and not passes(ref, ref, off)
    assert not passes(ref, ref, torch.tensor([0.5, float("nan"), -0.25]))


def test_scan_plain_matches_eager_convlstm_loop():
    """With a time-constant input, K6's plain version equals the port's
    eager ConvLSTM loop (the reference equations) on the same weights."""
    cin = 6
    rng = np.random.default_rng(3)
    m = tconvlstm.ConvLSTM(cin, F, fused=False)
    token = torch.from_numpy(rng.normal(size=(B, 1, S, S, cin)).astype(np.float32))
    c0, h0 = (torch.from_numpy(a) for a in _scan_inputs(4, True)[2:])
    with torch.no_grad():
        (c1, h1), hs1 = m((c0, h0), token, length=T)
        m.fused = True
        (c2, h2), hs2 = m((c0, h0), token, length=T)
    for a, b in ((c1, c2), (h1, h2), (hs1, hs2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# (x_kernel, time-constant input, need_hs, fused) -> recurrence run
_PATHS = [
    (1, False, False, None, "k5"),
    (1, False, False, True, "k5"),
    (1, False, False, False, "eager"),
    (1, False, True, None, "k6"),
    (1, False, True, False, "eager"),
    (3, True, True, None, "eager"),
    (3, True, True, True, "k6"),
    (3, True, True, False, "eager"),
    (3, False, False, None, "k6-last"),
    (3, False, False, True, "k6-last"),
    (3, False, False, False, "eager"),
]


@pytest.mark.parametrize("x_kernel,const,need_hs,fused,path", _PATHS)
def test_fused_policy_picks_the_jax_path(monkeypatch, x_kernel, const, need_hs, fused, path):
    """The JAX module's choice (mmvae_tpu/models/convlstm.py:224-307) with
    auto = fused for a streaming input, on the CPU: the encoder fast path
    (K5) for a 1x1 projection with need_hs=False; K6 for every other
    recurrence under fused=True and for a streaming one under auto; the
    eager loop otherwise."""
    taken = []
    real_scan, real_proj = tconvlstm.convlstm_scan, tconvlstm.convlstm_scan_proj

    def scan(*a, last_only=False, **kw):
        taken.append("k6-last" if last_only else "k6")
        return real_scan(*a, last_only=last_only, **kw)

    def proj(*a, **kw):
        taken.append("k5")
        return real_proj(*a, **kw)

    monkeypatch.setattr(tconvlstm, "convlstm_scan", scan)
    monkeypatch.setattr(tconvlstm, "convlstm_scan_proj", proj)
    cin = 16
    m = tconvlstm.ConvLSTM(cin, F, x_kernel=x_kernel, fused=fused)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.1)
    xs = torch.randn(B, 1 if const else T, S, S, cin)
    zeros = torch.zeros(B, S, S, F)
    with torch.no_grad():
        (c_t, h_t), hs = m((zeros, zeros), xs, length=T, need_hs=need_hs)
    assert taken == ([] if path == "eager" else [path])
    assert c_t.shape == h_t.shape == (B, S, S, F)
    assert (hs is None) == (path in ("k5", "k6-last"))


def test_fused_with_remat_warns_and_runs_k6():
    m = tconvlstm.ConvLSTM(6, F, fused=True, remat=True)
    token = torch.randn(B, 1, S, S, 6, requires_grad=True)
    zeros = torch.zeros(B, S, S, F)
    with pytest.warns(UserWarning, match="remat is ignored"):
        (_, _), hs = m((zeros, zeros), token, length=T)
    hs.sum().backward()
    assert token.grad is not None and torch.isfinite(token.grad).all()
    m.fused = None  # auto: the const input runs the eager loop, remat and all
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m((zeros, zeros), token, length=T)


# Auto's choice for a time-constant input on the card, by (activations, F,
# H*W), as the H100 timed the decoder both ways: config 3's decoder in bf16
# and in f32 (the 2-CTA wgmma kernels: K6), the probe's F = 192 in bf16
# (the 4-CTA wgmma kernels: the loop), a 16x16 grid and the probe in f32
# (the general kernels: the loop); fp16, which no kernel takes; F = 16 and
# 256 at their wgmma widths.
_CARD_CONST = [
    (torch.bfloat16, 128, 64, "wgmma", True),
    (torch.float32, 128, 64, "wgmma", True),
    (torch.bfloat16, 16, 64, "wgmma", True),
    (torch.bfloat16, 192, 64, "wgmma", False),
    (torch.bfloat16, 256, 64, "wgmma", False),
    (torch.bfloat16, 128, 256, "general", False),
    (torch.float32, 192, 64, "general", False),
    (torch.float16, 128, 64, None, False),
]


@pytest.mark.parametrize("dtype,feat,hw,way,k6", _CARD_CONST,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_auto_runs_k6_for_a_const_input_where_the_card_measured_it_faster(dtype, feat, hw,
                                                                          way, k6):
    if way is not None:
        assert ck.route(dtype, feat, hw) == way
    assert tconvlstm.runs_kernel(None, True, torch.device("cuda"), dtype, feat, hw) is k6
    assert tconvlstm.runs_kernel(None, True, "cuda:0", dtype, feat, hw) is k6


_SHAPES = [(torch.bfloat16, 128, 64), (torch.float32, 128, 64), (torch.bfloat16, 192, 64),
           (torch.bfloat16, 128, 256), (torch.float32, 192, 64), (torch.bfloat16, 16, 16)]


@pytest.mark.parametrize("device", ["cpu", "meta", "cuda"])
@pytest.mark.parametrize("shape", _SHAPES, ids=lambda v: str(v).replace("torch.", ""))
def test_runs_kernel_keeps_the_explicit_settings_and_the_jax_policy(device, shape):
    """fused=True runs a kernel and fused=False the eager loop at every
    shape and on every device; under auto a streaming input always runs a
    kernel, and a time-constant one runs the eager loop off the card (the
    JAX policy: the CPU parity tests and `bench.flops` on `meta`)."""
    dtype, feat, hw = shape
    for const in (False, True):
        assert tconvlstm.runs_kernel(True, const, device, dtype, feat, hw) is True
        assert tconvlstm.runs_kernel(False, const, device, dtype, feat, hw) is False
    assert tconvlstm.runs_kernel(None, False, device, dtype, feat, hw) is True
    if device != "cuda":
        assert tconvlstm.runs_kernel(None, True, device, dtype, feat, hw) is False


@pytest.mark.parametrize("const", [False, True])
def test_auto_asks_the_rule_with_the_recurrence_it_runs(monkeypatch, const):
    """ConvLSTM's forward hands `runs_kernel` its own setting, whether the
    input is time-constant, the input's device, the activation dtype, F and
    the grid's positions."""
    asked = []

    def rule(*args):
        asked.append(args)
        return real(*args)

    real = tconvlstm.runs_kernel
    monkeypatch.setattr(tconvlstm, "runs_kernel", rule)
    m = tconvlstm.ConvLSTM(6, F, dtype=torch.bfloat16)
    xs = torch.randn(B, 1 if const else T, S, S + 1, 6)
    zeros = torch.zeros(B, S, S + 1, F)
    with torch.no_grad():
        m((zeros, zeros), xs, length=T)
    assert asked == [(None, const, xs.device, torch.bfloat16, F, S * (S + 1))]


TINY = dict(latent_dim=8, enc_channels=(8, 128), lstm_features=8, image_size=32,
            enc_x_kernel=1)


def test_seq_vae_fused_kwarg_builds():
    """The port's seq_vae takes `fused` as the JAX model does (it raised
    TypeError); both ConvLSTMs get it."""
    model = build_model(get_config("seq_vae", ("model.kwargs.fused=true",)), device="cpu")
    assert model.enc_lstm.fused is True and model.dec_lstm.fused is True


def test_seq_vae_fused_matches_jax_fused():
    """Tiny seq_vae with fused=True on both sides, f32: the encoder through
    K5 and the decoder through K6 (plain versions against Pallas in
    interpret mode); logits, mu, logvar and every param grad to 5e-4, as
    tests/test_torch_models.py."""
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(B, T, 32, 32)) < 0.35).astype(np.float32)
    eps = rng.normal(size=(B, TINY["latent_dim"])).astype(np.float32)
    jm = JSeqVAE(**TINY, fused=True)
    params = JSeqVAE(**TINY, fused=False).init(jax.random.PRNGKey(1), jnp.asarray(x),
                                               lambda m, v, salt=0: m)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), lambda m, v, salt=0: m + jnp.exp(0.5 * v) * eps)
        bce, kl = elbo_reduce_pallas(out.logits, out.target, out.mu, out.logvar,
                                     interpret=True)
        return (bce + kl) / B, (out.logits, out.mu, out.logvar)

    (_, jouts), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tm = ConvLSTMSeqVAE(**TINY, fused=True)
    tm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    out = tm(torch.from_numpy(x),
             lambda m, v, salt=0: m + torch.exp(0.5 * v) * torch.from_numpy(eps))
    bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
    ((bce + kl) / B).backward()
    jgrads = state_dict_from_flax(jax.tree.map(np.asarray, jg))
    for got, want in zip((out.logits, out.mu, out.logvar), jouts):
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=5e-4, atol=5e-4 * scale)
    assert set(jgrads) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        want = jgrads[name].numpy()
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=5e-4, atol=5e-4 * scale,
                                   err_msg=name)
