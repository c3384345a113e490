"""The bf16 gate rounding of the port's ConvLSTM recurrences three ways,
against the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tests/_rounding_variants.py [--draws 0 1 2]

- `port`: the plain K5 and K6 of `mmvae_torch.ops.convlstm_kernels` as
  they are: K5 rounds the projection (with its bias) and the taps to the
  gate dtype apart, then adds them in it (`convlstm_pallas.py:408-409`),
  and with bf16 gates every sigmoid is 1 / (1 + exp(-x)) with each op
  rounded to the gate dtype, as the TPU kernels compute it (`:155-159`);
- `apart`: that rounding of K5's sum, with torch's sigmoid, rounded once;
- `once`: with bf16 activations K5 rounds x_t Wx + bx + conv3x3(h) to the
  gate dtype once, and torch's sigmoid (the port's rounding before it
  took the TPU kernels').

For each it prints how many of the terminal (c_T, h_T) elements of a bf16
recurrence (B = 2, T = 3, 4x4, C = F = 16, bf16 gates) differ from
`convlstm_scan_proj_pallas` (K5) and `convlstm_scan_pallas` (K6, hs too)
in interpret mode, then, for each draw of frames, eps and init (draw 0 is
`tests/test_torch_models.py`'s), the check of
`test_seq_vae_bf16_matches_jax_fused`: each parameter's distance from
JAX's f32 gradients over its limit, max(2 x JAX bf16's distance, 0.05),
and the largest such ratio (above 1: the test fails at that draw).
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mmvae_torch.convert import state_dict_from_flax  # noqa: E402
from mmvae_torch.models.seq_vae import ConvLSTMSeqVAE  # noqa: E402
from mmvae_torch.ops import convlstm_kernels as ck  # noqa: E402
from mmvae_torch.ops.elbo_kernels import elbo_reduce  # noqa: E402
from mmvae_tpu.models.seq_vae import ConvLSTMSeqVAE as JSeqVAE  # noqa: E402
from mmvae_tpu.ops.convlstm_pallas import (  # noqa: E402
    convlstm_scan_pallas,
    convlstm_scan_proj_pallas,
)
from mmvae_tpu.ops.elbo_pallas import elbo_reduce_pallas  # noqa: E402

# tests/test_torch_models.py's widths: the JAX side takes K5 there
B, T = 2, 4
TINY = dict(latent_dim=8, enc_channels=(8, 128), lstm_features=8, image_size=32,
            enc_x_kernel=1)
PORT_FORWARD, PORT_GATES = ck.proj_forward_plain, ck._split_gates


def _forward_once(x, wx, bx, w, c0, h0, gate_dtype, save: bool):
    """`proj_forward_plain` with x_t Wx + bx + conv3x3(h) rounded to the
    gate dtype once where the activations are bf16."""
    act = x.dtype
    batch, t_len, height, width, cin = x.shape
    feat = wx.shape[1] // 4
    hw = height * width
    op = functools.partial(ck._operand, act=act, tf32_operands=False)
    xg = op(x).reshape(batch, t_len, hw, cin) @ wx.float() + bx.float()
    w_oihw = w.float().permute(3, 2, 0, 1)
    c = c0.reshape(batch, hw, feat).to(gate_dtype)
    h = h0.reshape(batch, hw, feat).to(gate_dtype)
    hs, cs, ga = [], [], []
    for t in range(t_len):
        hg = ck._hidden_conv(op(h), w_oihw, height, width)
        if act == torch.float32:
            gates = xg[:, t].to(gate_dtype) + hg.to(gate_dtype)
        else:
            gates = (xg[:, t] + hg).to(gate_dtype)
        i, f, g, o = ck._split_gates(gates, feat)
        c = f * c + i * g
        h = o * torch.tanh(c)
        if save:
            hs.append(h.to(act))
            cs.append(c.to(act))
            ga.append(torch.cat([i, f, g, o], dim=-1).to(act))
    if save:
        return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(ga, 1)
    return h.to(act), c.to(act)


def _gates_torch(gates, feat):
    i, f, g, o = gates.split(feat, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.tanh(g), torch.sigmoid(o)


VARIANTS = {"port": (PORT_FORWARD, PORT_GATES), "apart": (PORT_FORWARD, _gates_torch),
            "once": (_forward_once, _gates_torch)}


def use(variant: str) -> None:
    ck.proj_forward_plain, ck._split_gates = VARIANTS[variant]


def kernel_counts() -> dict:
    """{name: elements of the plain version's outputs that differ from the
    Pallas kernel's}, at bf16 activations and gates."""
    rng = np.random.default_rng(1)
    b, t_len, s, cin, feat = 2, 3, 4, 16, 16
    arrays = [rng.normal(size=(b, t_len, s, s, cin)) * 0.5,
              rng.normal(size=(cin, 4 * feat)) * 0.25, rng.normal(size=(4 * feat,)) * 0.1,
              rng.normal(size=(3, 3, feat, 4 * feat)) * (9 * feat) ** -0.5,
              rng.normal(size=(b, s, s, feat)) * 0.5, rng.normal(size=(b, s, s, feat)) * 0.5]
    jargs = [jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16) for a in arrays]
    targs = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in arrays]
    xg = rng.normal(size=(b, t_len, s, s, 4 * feat)).astype(np.float32)
    want = [*convlstm_scan_proj_pallas(*jargs, interpret=True, gate_dtype=jnp.bfloat16)]
    (jc, jh), jhs = convlstm_scan_pallas(jnp.asarray(xg).astype(jnp.bfloat16), *jargs[3:],
                                         interpret=True, gate_dtype=jnp.bfloat16)
    want += [jc, jh, jhs]
    with torch.no_grad():
        got = [*ck.convlstm_scan_proj(*targs, gate_dtype=torch.bfloat16)]
        (tc, th), ths = ck.convlstm_scan(torch.from_numpy(xg).to(torch.bfloat16), *targs[3:],
                                         gate_dtype=torch.bfloat16)
    got += [tc, th, ths]
    names = ("K5 c_T", "K5 h_T", "K6 c_T", "K6 h_T", "K6 hs")
    return {n: int(np.sum(g.float().numpy() != np.asarray(w, np.float32)))
            for n, g, w in zip(names, got, want)}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _draw(draw: int):
    rng = np.random.default_rng(draw)
    x = (rng.uniform(size=(B, T, 32, 32)) < 0.35).astype(np.float32)
    eps = rng.normal(size=(B, TINY["latent_dim"])).astype(np.float32)
    params = JSeqVAE(**TINY, fused=False).init(
        jax.random.PRNGKey(draw + 1), jnp.asarray(x), lambda m, v, salt=0: m)
    return x, eps, params


def jax_grads(draw: int, dtype) -> dict:
    x, eps, params = _draw(draw)
    jm = JSeqVAE(**TINY, fused=True, dtype=dtype, gate_bf16=dtype == jnp.bfloat16)

    def loss(p):
        out = jm.apply(p, jnp.asarray(x), lambda m, v, salt=0: m + jnp.exp(0.5 * v) * eps)
        bce, kl = elbo_reduce_pallas(out.logits, out.target, out.mu, out.logvar,
                                     interpret=True)
        return (bce + kl) / B

    return state_dict_from_flax(jax.tree.map(np.asarray, jax.grad(loss)(params)))


def port_grads(draw: int) -> dict:
    x, eps, params = _draw(draw)
    tm = ConvLSTMSeqVAE(**TINY, dtype=torch.bfloat16, gate_bf16=True, remat=False)
    tm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    out = tm(torch.from_numpy(x),
             lambda m, v, salt=0: m + torch.exp(0.5 * v) * torch.from_numpy(eps))
    bce, kl = elbo_reduce(out.logits, out.target, out.mu, out.logvar)
    ((bce + kl) / B).backward()
    return {n: p.grad.numpy() for n, p in tm.named_parameters()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, nargs="+", default=list(range(8)))
    args = ap.parse_args(argv)
    with jax.default_matmul_precision("highest"):
        for name in VARIANTS:
            use(name)
            print(f"{name}: elements off the Pallas kernels {kernel_counts()}", flush=True)
        for draw in args.draws:
            j16, j32 = jax_grads(draw, jnp.bfloat16), jax_grads(draw, jnp.float32)
            for name in VARIANTS:
                use(name)
                got = port_grads(draw)
                ratio = {n: _rel(g, j32[n]) / max(2 * _rel(j16[n], j32[n]), 0.05)
                         for n, g in got.items()}
                worst = max(ratio, key=ratio.get)
                print(f"draw {draw} {name}: largest distance over its limit {ratio[worst]:.3f} "
                      f"({worst}: {_rel(got[worst], j32[worst]):.4f} from JAX f32, JAX bf16 "
                      f"{_rel(j16[worst], j32[worst]):.4f})", flush=True)
        use("port")


if __name__ == "__main__":
    main()
