"""mmvae_torch ConvLSTM against mmvae_tpu: the encoder recurrence (K5) and the
decoder's eager const-input ConvLSTM.

K5's plain version (what the port runs on the CPU) is held against the
Pallas kernel `convlstm_scan_proj_pallas` in interpret mode, forward and all
six gradients, in f32 and with bf16 gates.  The decoder ConvLSTM (const input,
remat) is held against the JAX scanned form with the same params.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as tnf

from mmvae_tpu.models.convlstm import ConvLSTM as JConvLSTM
from mmvae_tpu.models.convlstm import ConvLSTMCell
from mmvae_tpu.ops.convlstm_pallas import convlstm_scan_proj_pallas
from mmvae_torch.convert import state_dict_from_flax
from mmvae_torch.models.convlstm import ConvLSTM
from mmvae_torch.ops import convlstm_kernels as ck

B, T, S, C, F = 2, 5, 4, 16, 8
_GRAD_TOL = 2e-4  # tests/test_convlstm_fused.py, f32 on the CPU


@pytest.fixture(autouse=True)
def _full_precision_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _proj_inputs(seed, b=B, t=T, s=S, c=C, f=F):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(b, t, s, s, c)).astype(np.float32) * 0.5,
        rng.normal(size=(c, 4 * f)).astype(np.float32) * c ** -0.5,
        rng.normal(size=(4 * f,)).astype(np.float32) * 0.1,
        rng.normal(size=(3, 3, f, 4 * f)).astype(np.float32) * (9 * f) ** -0.5,
        rng.normal(size=(b, s, s, f)).astype(np.float32) * 0.5,
        rng.normal(size=(b, s, s, f)).astype(np.float32) * 0.5,
    ]


def _probe(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


# (B, T, S, C, F): the small shape, and a 4-CTA width of the CUDA kernels
# (the reference's lstm_features=192 probe) at the 8x8 grid of the models.
WIDE = (1, 2, 8, 16, 192)


@pytest.mark.parametrize(
    "gate,fwd_tol,grad_tol,shape",
    [
        pytest.param("float32", 2e-5, _GRAD_TOL, (B, T, S, C, F), id="float32-2e-05-0.0002"),
        # bf16 gates round at different points in the two frameworks: a few
        # bf16 ulps of O(1) activations (tests/test_convlstm_fused.py:249-269).
        pytest.param("bfloat16", 0.05, 0.08, (B, T, S, C, F), id="bfloat16-0.05-0.08"),
        pytest.param("float32", 2e-5, _GRAD_TOL, WIDE, id="float32-F192"),
        pytest.param("bfloat16", 0.05, 0.08, WIDE, id="bfloat16-F192"),
    ],
)
def test_proj_plain_matches_pallas_interpret(gate, fwd_tol, grad_tol, shape):
    b, t, s, c, f = shape
    args = _proj_inputs(0, b, t, s, c, f)
    wc, wh = _probe(1, (b, s, s, f))
    jgate = jnp.bfloat16 if gate == "bfloat16" else jnp.float32
    tgate = torch.bfloat16 if gate == "bfloat16" else torch.float32

    def jloss(*a):
        c_t, h_t = convlstm_scan_proj_pallas(*a, interpret=True, gate_dtype=jgate)
        return jnp.sum(c_t.astype(jnp.float32) * wc) + jnp.sum(h_t.astype(jnp.float32) * wh), (c_t, h_t)

    (_, (jc, jh)), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(a) for a in args]
    )
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    c_t, h_t = ck.convlstm_scan_proj(*targs, gate_dtype=tgate)
    (torch.sum(c_t.float() * torch.from_numpy(wc))
     + torch.sum(h_t.float() * torch.from_numpy(wh))).backward()

    np.testing.assert_allclose(c_t.detach().numpy(), np.asarray(jc, np.float32),
                               atol=fwd_tol, rtol=fwd_tol)
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(jh, np.float32),
                               atol=fwd_tol, rtol=fwd_tol)
    for name, ta, ja in zip(("dx", "dWx", "dbx", "dW", "dc0", "dh0"), targs, jgrads):
        want = np.asarray(ja, np.float32).reshape(ta.shape)
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(ta.grad.numpy(), want, rtol=grad_tol,
                                   atol=grad_tol * scale, err_msg=name)


def test_proj_no_grad_primal_matches_saving_forward():
    """The residual-free forward (no grad) gives the saving forward's (c_T, h_T)."""
    args = [torch.from_numpy(a) for a in _proj_inputs(2)]
    with torch.no_grad():
        c1, h1 = ck.convlstm_scan_proj(*args)
    hs, cs, ga = ck.proj_forward_plain(*args, torch.float32, True)
    assert ga.shape == (B, T, S * S, 4 * F)
    torch.testing.assert_close(h1.reshape(B, -1, F), hs[:, -1], rtol=0, atol=0)
    torch.testing.assert_close(c1.reshape(B, -1, F), cs[:, -1], rtol=0, atol=0)


def test_proj_plain_matches_scanned_reference_cell():
    """K5's plain forward equals a step loop of the reference equations
    (conv over [x, h] split as in models/convlstm.py) written out here."""
    x, wx, bx, w, c0, h0 = (torch.from_numpy(a) for a in _proj_inputs(3))
    c, h = c0, h0
    w_oihw = w.permute(3, 2, 0, 1)
    for t in range(T):
        g = (x[:, t] @ wx + bx).permute(0, 3, 1, 2) + torch.nn.functional.conv2d(
            h.permute(0, 3, 1, 2), w_oihw, padding=1)
        i, f, gg, o = g.chunk(4, dim=1)
        c = (torch.sigmoid(f + 1) * c.permute(0, 3, 1, 2)
             + torch.sigmoid(i) * torch.tanh(gg)).permute(0, 2, 3, 1)
        h = torch.sigmoid(o).permute(0, 2, 3, 1) * torch.tanh(c)
    with torch.no_grad():
        c_t, h_t = ck.convlstm_scan_proj(x, wx, bx, w, c0, h0)
    torch.testing.assert_close(c_t, c, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h_t, h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_decoder_const_input_matches_jax_scan(remat):
    """Decoder shape: a (B, 1, ...) token driven for `length` steps."""
    cin, length = 6, 4
    rng = np.random.default_rng(4)
    token = rng.normal(size=(B, 1, S, S, cin)).astype(np.float32)
    c0 = (rng.normal(size=(B, S, S, F)) * 0.5).astype(np.float32)
    h0 = (rng.normal(size=(B, S, S, F)) * 0.5).astype(np.float32)
    w_hs = rng.normal(size=(B, length, S, S, F)).astype(np.float32)

    jm = JConvLSTM(features=F, fused=False, remat=remat)
    params = jm.init(jax.random.PRNGKey(0), ConvLSTMCell.initial_state(B, S, S, F),
                     jnp.asarray(token), length=length)

    def jloss(p, c, h, xs):
        (c_t, h_t), hs = jm.apply(p, (c, h), xs, length=length)
        return jnp.sum(hs * w_hs) + jnp.sum(c_t) + 0.5 * jnp.sum(h_t), (c_t, h_t, hs)

    (_, (jc, jh, jhs)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        params, jnp.asarray(c0), jnp.asarray(h0), jnp.asarray(token)
    )

    tm = ConvLSTM(cin, F, remat=remat)
    tm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    tc0, th0 = torch.from_numpy(c0).requires_grad_(), torch.from_numpy(h0).requires_grad_()
    ttok = torch.from_numpy(token).requires_grad_()
    (c_t, h_t), hs = tm((tc0, th0), ttok, length=length)
    (torch.sum(hs * torch.from_numpy(w_hs)) + torch.sum(c_t) + 0.5 * torch.sum(h_t)).backward()

    for got, want in ((c_t, jc), (h_t, jh), (hs, jhs)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    jgrad_sd = state_dict_from_flax(jax.tree.map(np.asarray, jg[0]))
    for name, p in tm.named_parameters():
        want = jgrad_sd[name].numpy()
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=_GRAD_TOL,
                                   atol=_GRAD_TOL * scale, err_msg=name)
    for got, want in ((tc0.grad, jg[1]), (th0.grad, jg[2]), (ttok.grad, jg[3])):
        scale = max(float(np.abs(np.asarray(want)).max()), 1.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=_GRAD_TOL,
                                   atol=_GRAD_TOL * scale)


def test_encoder_takes_kernel_path_only_for_terminal_state():
    """x_kernel=1 + need_hs=False runs convlstm_scan_proj; need_hs=True runs
    convlstm_scan (K6) after the hoisted projection, as the JAX auto policy
    does for a streaming input; both give the same terminal state."""
    args = [torch.from_numpy(a) for a in _proj_inputs(5)]
    m = ConvLSTM(C, F, x_kernel=1)
    with torch.no_grad():
        m.input.weight.copy_(args[1])
        m.input.bias.copy_(args[2])
        m.step.hidden.weight.copy_(args[3])
        (c1, h1), none = m((args[4], args[5]), args[0], need_hs=False)
        (c2, h2), hs = m((args[4], args[5]), args[0], need_hs=True)
    assert none is None and hs.shape == (B, T, S, S, F)
    torch.testing.assert_close(c1, c2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h1, h2, rtol=1e-5, atol=1e-5)



def _per_step_reference(m, xs, state0, t, probe):
    """The module's eager recurrence on a time-constant input, each step
    with its own f32 leaves for the hidden weight and the projected drive:
    the per-step gradients apart, summed here in f64 (JAX's scan sums a
    broadcast parameter's and a broadcast input's cotangents in f32), the
    drive's rounded once to bf16 and taken back through the projection.
    Returns the gradients of (hidden weight, input projection weight, xs)."""
    dt = m.dtype
    xs = xs.detach().clone().requires_grad_()
    wi = m.input.weight.detach().clone().requires_grad_()
    xg = tnf.conv2d(xs[:, 0].to(dt).permute(0, 3, 1, 2), wi.to(dt), m.input.bias.to(dt),
                  padding=m.x_kernel // 2)
    c, h = (v.permute(0, 3, 1, 2) for v in state0)
    ws, xgs, hs = [], [], []
    for _ in range(t):
        ws.append(m._hidden_oihw().detach().clone().requires_grad_())
        xgs.append(xg.detach().float().requires_grad_())
        c, h = m._step(xgs[-1], c, h, ws[-1].to(dt))
        hs.append(h)
    grads = torch.autograd.grad((torch.stack(hs, 1).float() * probe).sum(), ws + xgs)
    gw = sum(g.double() for g in grads[:t])
    gxg = sum(g.double() for g in grads[t:]).to(dt)
    gwi, gxs = torch.autograd.grad(xg, (wi, xs), gxg)
    return gw, gwi, gxs


@pytest.mark.parametrize("remat", [False, True])
def test_eager_recurrence_sums_its_step_gradients_in_f32(remat):
    """bf16 activations and gates, a decoder's time-constant input over 20
    steps: the hidden weight's gradient is the f32 sum of the 20 steps'
    gradients (within f32 rounding of their exact sum), and the projected
    drive's is that sum rounded once to bf16, as JAX's scan sums them.  A
    bf16 copy of either made once before the loop sums them in bf16, a
    rounding at each of the 20 additions (2e-3 to 1e-2 off)."""
    torch.manual_seed(0)
    t, f = 20, 16
    m = ConvLSTM(f, f, dtype=torch.bfloat16, gate_dtype=torch.bfloat16, remat=remat,
                 fused=False)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.2)
    xs = torch.randn(2, 1, S, S, f).requires_grad_()
    state0 = tuple((torch.randn(2, S, S, f) * 0.5).to(torch.bfloat16) for _ in range(2))
    probe = torch.randn(2, t, f, S, S)

    _, hs = m(state0, xs, length=t)
    loss = (hs.permute(0, 1, 4, 2, 3).float() * probe).sum()
    gw, gwi, gxs = torch.autograd.grad(loss, (m.step.hidden.weight, m.input.weight, xs))
    rw, rwi, rxs = _per_step_reference(m, xs, state0, t, probe)

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    assert rel(gw, rw) < 1e-6
    assert rel(gwi, rwi) < 1e-4 and rel(gxs, rxs) < 1e-4


def _bf16_once_grads(m, state0, token, t, probe):
    """The eager recurrence as it stood with one bf16 copy of the hidden
    weight and of the projected drive made before the time loop, so that
    autograd adds their 20 per-step gradients in bf16: the gradients of
    `m`'s parameters."""
    dt = m.dtype
    w = m._hidden_oihw().to(dt)
    xg = tnf.conv2d(token[:, 0].to(dt).permute(0, 3, 1, 2), m.input.weight.to(dt),
                    m.input.bias.to(dt), padding=m.x_kernel // 2)
    c, h = (v.permute(0, 3, 1, 2) for v in state0)
    hs = []
    for _ in range(t):
        c, h = m._step(xg, c, h, w)
        hs.append(h)
    loss = (torch.stack(hs, 1).float() * probe.permute(0, 1, 4, 2, 3)).sum()
    return dict(zip([n for n, _ in m.named_parameters()],
                    torch.autograd.grad(loss, list(m.parameters()))))


@pytest.mark.parametrize("gate,most", [("float32", 0.7), ("bfloat16", 1.0)])
def test_eager_decoder_weight_gradient_is_closer_to_jax_than_a_bf16_sum(gate, most):
    """Config 3's decoder shape at a small size: bf16 activations, a token
    held for 20 steps, remat, the JAX scan fully unrolled (as config 3).  The
    hidden weight's gradient is closer (rel L2) to JAX's than the same
    recurrence's with its per-step gradients added in bf16: under `most`
    times its gap with f32 gates (3.9e-3 against 6.7e-3 here); with bf16
    gates the two frameworks' gate roundings dominate both gaps (1.13e-2
    against 1.24e-2 here)."""
    t, f, cin = 20, 16, 8
    rng = np.random.default_rng(6)
    token = rng.normal(size=(B, 1, S, S, cin)).astype(np.float32)
    c0, h0 = ((rng.normal(size=(B, S, S, f)) * 0.5).astype(np.float32) for _ in range(2))
    probe = rng.normal(size=(B, t, S, S, f)).astype(np.float32)
    jgate, tgate = (jnp.bfloat16, torch.bfloat16) if gate == "bfloat16" else \
        (jnp.float32, torch.float32)

    jm = JConvLSTM(features=f, fused=False, remat=True, unroll=t, dtype=jnp.bfloat16,
                   gate_dtype=jgate)
    params = jm.init(jax.random.PRNGKey(0), ConvLSTMCell.initial_state(B, S, S, f),
                     jnp.asarray(token), length=t)
    jstate = (jnp.asarray(c0, jnp.bfloat16), jnp.asarray(h0, jnp.bfloat16))

    def jloss(p):
        _, hs = jm.apply(p, jstate, jnp.asarray(token), length=t)
        return jnp.sum(hs.astype(jnp.float32) * probe)

    want = state_dict_from_flax(jax.tree.map(np.asarray, jax.grad(jloss)(params)))

    m = ConvLSTM(cin, f, dtype=torch.bfloat16, gate_dtype=tgate, remat=True, fused=False)
    m.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    state0 = (torch.from_numpy(c0).bfloat16(), torch.from_numpy(h0).bfloat16())
    _, hs = m(state0, torch.from_numpy(token), length=t)
    loss = (hs.float() * torch.from_numpy(probe)).sum()
    got = dict(zip([n for n, _ in m.named_parameters()],
                   torch.autograd.grad(loss, list(m.parameters()))))
    once = _bf16_once_grads(m, state0, torch.from_numpy(token), t, torch.from_numpy(probe))

    def gap(g):
        ref = want["step.hidden.weight"].double()
        return ((g["step.hidden.weight"].double() - ref).norm() / ref.norm()).item()

    assert gap(got) < most * gap(once), (gap(got), gap(once))
    assert gap(got) < 2e-2
