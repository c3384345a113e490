"""The bf16 gate rounding of the port's ConvLSTM recurrences against mmvae_tpu.

With bf16 activations and bf16 gates the plain K5 and K6 (what the port runs
on the CPU, and what the card's kernels are held to) round as the Pallas
kernels do: K5 rounds the x projection (with its bias) and the 3x3 taps to
bf16 apart and adds them in bf16 (`convlstm_pallas.py:408-409`), and every
sigmoid is 1 / (1 + exp(-v)) with each op rounded to bf16 (`:155-159`).  So
their outputs equal `convlstm_scan_proj_pallas` and `convlstm_scan_pallas`
in interpret mode bit for bit, in every mode.  The eager cell keeps torch's
sigmoid: its counterpart is JAX's eager cell (`jax.nn.sigmoid`), not the
Pallas kernels.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mmvae_tpu.models.convlstm import _gate_math as j_gate_math
from mmvae_tpu.ops.convlstm_pallas import convlstm_scan_pallas, convlstm_scan_proj_pallas
from mmvae_torch.models import convlstm as tconvlstm
from mmvae_torch.ops import convlstm_kernels as ck

B, T, S, C, F = 2, 3, 4, 16, 16


@pytest.fixture(autouse=True)
def _full_precision_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _bits(t) -> np.ndarray:
    """bf16 values as their 16-bit patterns."""
    if isinstance(t, torch.Tensor):
        return t.detach().contiguous().view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


def _proj_inputs(seed=1):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(B, T, S, S, C)) * 0.5, rng.normal(size=(C, 4 * F)) * 0.25,
              rng.normal(size=(4 * F,)) * 0.1,
              rng.normal(size=(3, 3, F, 4 * F)) * (9 * F) ** -0.5,
              rng.normal(size=(B, S, S, F)) * 0.5, rng.normal(size=(B, S, S, F)) * 0.5]
    return [a.astype(np.float32) for a in arrays]


def _torch_bf16(arrays, grad):
    return [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(grad) for a in arrays]


def _jax_bf16(arrays):
    return [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]


@pytest.mark.parametrize("grad", [False, True], ids=["no-residuals", "saving"])
def test_proj_plain_equals_pallas_bit_for_bit(grad):
    """K5 with bf16 activations and gates: (c_T, h_T) of the plain version
    (the residual-free forward without grad, the saving one with it) equal
    the Pallas kernel's (its primal, or its forward under jax.vjp)."""
    arrays = _proj_inputs()
    jargs = _jax_bf16(arrays)

    def run(*a):
        return convlstm_scan_proj_pallas(*a, interpret=True, gate_dtype=jnp.bfloat16)

    want = jax.vjp(run, *jargs)[0] if grad else run(*jargs)
    with torch.set_grad_enabled(grad):
        got = ck.convlstm_scan_proj(*_torch_bf16(arrays, grad), gate_dtype=torch.bfloat16)
    for name, a, b in zip(("c_T", "h_T"), got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


@pytest.mark.parametrize("last_only", [False, True])
@pytest.mark.parametrize("grad", [False, True], ids=["no-residuals", "saving"])
@pytest.mark.parametrize("const", [False, True], ids=["streaming", "const"])
def test_scan_plain_equals_pallas_bit_for_bit(const, grad, last_only):
    """K6 with bf16 xg and gates in every mode ("save" under grad, "hs" and
    "last" without): (c_T, h_T) and hs equal the Pallas kernel's."""
    rng = np.random.default_rng(2)
    xg = rng.normal(size=(B, 1 if const else T, S, S, 4 * F)).astype(np.float32)
    arrays = [xg] + _proj_inputs()[3:]
    jargs = _jax_bf16(arrays)

    def run(*a):
        return convlstm_scan_pallas(*a, length=T, interpret=True, gate_dtype=jnp.bfloat16,
                                    last_only=last_only)

    (jc, jh), jhs = jax.vjp(run, *jargs)[0] if grad else run(*jargs)
    with torch.set_grad_enabled(grad):
        (c_t, h_t), hs = ck.convlstm_scan(*_torch_bf16(arrays, grad), length=T,
                                          gate_dtype=torch.bfloat16, last_only=last_only)
    assert (hs is None) == last_only == (jhs is None)
    pairs = [("c_T", c_t, jc), ("h_T", h_t, jh)]
    if hs is not None:
        pairs.append(("hs", hs, jhs))
    for name, a, b in pairs:
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def test_bf16_sigmoid_rounds_every_op():
    """The plain versions' bf16 sigmoid is the TPU kernel's op by op, not
    torch's once-rounded one (they differ on some inputs); with f32 gates
    it is torch's."""
    v = torch.linspace(-12, 12, 4097).to(torch.bfloat16)
    one = torch.ones((), dtype=torch.bfloat16)
    want = one / (one + torch.exp(-v))
    assert torch.equal(ck._sigmoid(v), want)
    assert not torch.equal(want, torch.sigmoid(v))
    vf = v.float()
    assert torch.equal(ck._sigmoid(vf), torch.sigmoid(vf))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_eager_cell_matches_jax_eager_cell(compute):
    """The eager cell's gate math against JAX's eager cell (`jax.nn.sigmoid`,
    `mmvae_tpu/models/convlstm.py:48-51`) on the same bf16 pre-activations:
    within one unit of the compute dtype's rounding of the largest |ref|
    (the frameworks' exp differ in the last bit); and its sigmoid is
    torch's, rounded once, not the Pallas kernels' op-by-op one."""
    rng = np.random.default_rng(3)
    gates = (rng.normal(size=(B, S, S, 4 * F)) * 2).astype(np.float32)
    c = rng.normal(size=(B, S, S, F)).astype(np.float32)
    tdt, jdt = getattr(torch, compute), getattr(jnp, compute)
    tg = torch.from_numpy(gates).to(torch.bfloat16).permute(0, 3, 1, 2)
    tc = torch.from_numpy(c).to(torch.bfloat16).permute(0, 3, 1, 2)
    got = tconvlstm._gate_math(tg, tc, torch.bfloat16, tdt)
    want = j_gate_math(jnp.asarray(gates).astype(jnp.bfloat16),
                       jnp.asarray(c).astype(jnp.bfloat16), jnp.bfloat16, jdt)
    for name, a, b in zip(("c", "h"), got, want):
        a = a.permute(0, 2, 3, 1).float().numpy()
        b = np.asarray(b, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(b).max())) - 7)  # bf16 outputs
        assert np.abs(a - b).max() <= 2 * ulp, name
    ti, tf, tgg, to = tg.to(tdt).chunk(4, dim=1)  # torch's sigmoid, rounded once
    c_own = torch.sigmoid(tf + 1.0) * tc.to(tdt) + torch.sigmoid(ti) * torch.tanh(tgg)
    h_own = torch.sigmoid(to) * torch.tanh(c_own)
    assert torch.equal(tconvlstm._gate_math(tg, tc, tdt, tdt)[1], h_own)
