"""Sampling of mmvae_torch against mmvae_tpu.sample.generate.

`reconstruct`, `prior_sample` and (pred_vae) `rollout` of each of the five
models, with `fused` true and false where the model has a ConvLSTM, in f32
and bf16, on the same flax params (carried across by
`convert.state_dict_from_flax`) with JAX's own draws injected into the port:
`normal(fold_in(rng, salt), shape)` per posterior site for `reconstruct`,
`normal(rng, (B, L))` for a flat prior, `split(rng)` then `split(rng_c, K)`
for the hierarchical chain, `normal(rng, mu.shape)` for `rollout`.  The
sequence models run at image_size=32, enc_channels=(8, 128), enc_x_kernel=1
as tests/test_torch_models_seq.py, so the JAX side takes its Pallas kernels
(interpret mode) under fused=True.  Tolerances: f32 at 5e-4 (rtol, and atol
scaled by max(1, max|want|)); bf16 within 0.05 of the largest magnitude.
Also: the protocol's TypeError, a subclassed model, the kernel routes a
sampling call takes (forwards without residuals, no backward, one head a
chunk of the prior chain, its salts), seeds, and the PNG / GIF writers
against the JAX writers' files.
"""

import functools
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mmvae_tpu.models import MODEL_REGISTRY as JREGISTRY
from mmvae_tpu.sample import generate as jgen
from mmvae_torch.convert import state_dict_from_flax
from mmvae_torch.models import MODEL_REGISTRY
from mmvae_torch.models import hier_vae as hier_module
from mmvae_torch.models.hier_vae import CHAIN_SALT
from mmvae_torch.ops import convlstm_kernels, head_kernels
from mmvae_torch.sample import generate as gen

B, T = 2, 4
_ENC = dict(enc_channels=(8, 128), lstm_features=8, image_size=32, enc_x_kernel=1)
TINY = {
    "mlp_vae": dict(latent_dim=8, hidden_dim=32),
    "conv_vae": dict(latent_dim=8, channels=(4, 8, 8, 8)),
    "seq_vae": dict(latent_dim=8, **_ENC),
    "pred_vae": dict(latent_dim=8, context_len=2, **_ENC),
    "hier_vae": dict(global_latent=8, chunk_latent=4, chunk_len=2, chunk_feature=16, **_ENC),
}
PER_FRAME = ("mlp_vae", "conv_vae")
N_FUTURE = 3  # rollout steps past pred_vae's 2 context frames


def _cases():
    for name in TINY:
        modes = ("prior", "reconstruct", "rollout") if name == "pred_vae" else (
            "prior", "reconstruct")
        for fused in ((None,) if name in PER_FRAME else (True, False)):
            for bf16 in (False, True):
                for mode in modes:
                    yield name, fused, bf16, mode


@pytest.fixture(autouse=True)
def _full_precision_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _frames_in(name):
    size = TINY[name].get("image_size", 64)
    shape = (B, size, size) if name in PER_FRAME else (B, T, size, size)
    return np.random.default_rng(0).uniform(size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _params(name):
    x = jnp.asarray(_frames_in(name))
    kw = TINY[name] if name in PER_FRAME else dict(TINY[name], fused=False)
    jm = JREGISTRY[name](**kw)
    # jitted: the same params as the eager init, at a third of its time
    return jax.jit(lambda k, x: jm.init(k, x, lambda m, v, salt=0: m))(jax.random.PRNGKey(1), x)


def _models(name, fused, bf16):
    kw = dict(TINY[name])
    if fused is not None:
        kw.update(fused=fused, gate_bf16=bf16)
    jm = JREGISTRY[name](**kw, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tm = MODEL_REGISTRY[name](**kw, dtype=torch.bfloat16 if bf16 else torch.float32)
    tm.load_state_dict(state_dict_from_flax(_np_tree(_params(name))))
    return jm, tm


def _normal(key, shape):
    return torch.from_numpy(np.asarray(jax.random.normal(key, shape, jnp.float32)))


def _latent(name):
    kw = TINY[name]
    return kw.get("latent_dim", kw.get("global_latent"))


def _run(name, fused, bf16, mode):
    """(the port's frames, JAX's frames) from the same params and draws."""
    jm, tm = _models(name, fused, bf16)
    params, rng = _params(name), jax.random.PRNGKey(7)
    x = _frames_in(name)
    seq_len = None if name in PER_FRAME else T
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # hier_vae: remat with fused=True
        if mode == "reconstruct":
            want = jgen.reconstruct(jm, params, jnp.asarray(x), rng)
            sites = {0: (B, _latent(name))}
            if name == "hier_vae":
                sites[1] = (B * T // TINY[name]["chunk_len"], TINY[name]["chunk_latent"])
            eps = {s: _normal(jax.random.fold_in(rng, s), shape) for s, shape in sites.items()}
            got = gen.reconstruct(tm, torch.from_numpy(x), 0, eps=eps)
        elif mode == "prior":
            want = jgen.prior_sample(jm, params, rng, B, seq_len=seq_len)
            if name == "hier_vae":
                rng_g, rng_c = jax.random.split(rng)
                keys = jax.random.split(rng_c, T // TINY[name]["chunk_len"])
                eps = {CHAIN_SALT + k: _normal(key, (B, TINY[name]["chunk_latent"]))
                       for k, key in enumerate(keys)}
                draws = dict(z_g=_normal(rng_g, (B, _latent(name))), eps=eps)
            else:
                draws = dict(z=_normal(rng, (B, _latent(name))))
            got = gen.prior_sample(tm, 0, B, seq_len=seq_len, **draws)
        else:
            ctx = x[:, : TINY[name]["context_len"]]
            want = jgen.rollout(jm, params, jnp.asarray(ctx), N_FUTURE, rng)
            got = gen.rollout(tm, torch.from_numpy(ctx), N_FUTURE, 0,
                              eps={0: _normal(rng, (B, _latent(name)))})
    return got, np.asarray(want)


@pytest.mark.parametrize("name,fused,bf16,mode", list(_cases()))
def test_sampling_matches_jax(name, fused, bf16, mode):
    """f32 numpy frames in [0, 1] of JAX's shape, equal to JAX's: f32 at
    5e-4, bf16 within 0.05 of the largest magnitude (the rules of
    tests/test_torch_models_seq.py)."""
    got, want = _run(name, fused, bf16, mode)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    tol = 0.05 if bf16 else 5e-4
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=f"{name} fused={fused} bf16={bf16} {mode}")


def test_prior_sample_protocol_error():
    class NotAVAE(torch.nn.Module):
        pass

    with pytest.raises(TypeError, match="prior-sampling protocol"):
        gen.prior_sample(NotAVAE(), 0, 2)


def test_prior_sample_subclassed_model():
    """Dispatch is the prior_logits protocol, not a class check: a renamed
    subclass samples as its base does."""
    base = MODEL_REGISTRY["mlp_vae"]

    class RenamedVAE(base):
        pass

    m = RenamedVAE(**TINY["mlp_vae"])
    ref = base(**TINY["mlp_vae"])
    ref.load_state_dict(m.state_dict())
    s = gen.prior_sample(m, 3, 3)
    assert s.shape == (3, 64, 64)
    np.testing.assert_array_equal(s, gen.prior_sample(ref, 3, 3))


def test_draws_follow_the_seed():
    """The port's own draws: the same seed gives the same frames, another
    seed others, in every mode of pred_vae and the hierarchical chain."""
    _, pred = _models("pred_vae", True, False)
    _, hier = _models("hier_vae", True, False)
    x = torch.from_numpy(_frames_in("pred_vae"))
    calls = {
        "pred prior": lambda s: gen.prior_sample(pred, s, B, seq_len=T),
        "pred reconstruct": lambda s: gen.reconstruct(pred, x, s),
        "pred rollout": lambda s: gen.rollout(pred, x[:, :2], N_FUTURE, s),
        "hier prior": lambda s: gen.prior_sample(hier, s, B, seq_len=T),
    }
    for what, fn in calls.items():
        a, b, c = fn(5), fn(5), fn(6)
        np.testing.assert_array_equal(a, b, err_msg=what)
        assert not np.array_equal(a, c), what


class _Spy:
    """Records the kernel wrappers a sampling call reaches (their CPU plain
    versions run all the same)."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod, name in ((convlstm_kernels, "convlstm_proj_forward"),
                          (convlstm_kernels, "convlstm_proj_backward"),
                          (convlstm_kernels, "convlstm_scan_forward"),
                          (convlstm_kernels, "convlstm_scan_backward"),
                          (head_kernels, "head_sample_forward"),
                          (head_kernels, "head_sample_backward")):
            monkeypatch.setattr(mod, name, self._wrap(name, getattr(mod, name)))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            if name == "convlstm_proj_forward":
                self.calls.append(f"{name} {'save' if args[7] else 'nores'}")
            elif name == "convlstm_scan_forward":
                self.calls.append(f"{name} {args[6]}")
            else:
                self.calls.append(name)
            return fn(*args, **kw)

        return call

    def counts(self):
        return {c: self.calls.count(c) for c in sorted(set(self.calls))}


def test_sampling_takes_the_forward_kernels_without_residuals(monkeypatch):
    """Under fused=True each sampling call reaches the head's forward, K5
    without residuals and K6 in its "hs" mode, never a backward: the
    launch equations the smoke holds on the card."""
    spy = _Spy(monkeypatch)
    _, seq = _models("seq_vae", True, True)
    _, pred = _models("pred_vae", True, True)
    _, hier = _models("hier_vae", True, True)
    x = torch.from_numpy(_frames_in("seq_vae"))
    n_chunks = 3
    runs = {
        "seq prior": (lambda: gen.prior_sample(seq, 1, B, seq_len=T),
                      {"convlstm_scan_forward hs": 1}),
        "seq reconstruct": (lambda: gen.reconstruct(seq, x, 1),
                            {"convlstm_proj_forward nores": 1, "head_sample_forward": 1,
                             "convlstm_scan_forward hs": 1}),
        "pred rollout": (lambda: gen.rollout(pred, x[:, :2], N_FUTURE, 1),
                         {"convlstm_proj_forward nores": 1, "head_sample_forward": 1,
                          "convlstm_scan_forward hs": 1}),
        "hier prior": (lambda: gen.prior_sample(hier, 1, B, seq_len=2 * n_chunks),
                       {"head_sample_forward": n_chunks, "convlstm_scan_forward hs": 1}),
        "hier reconstruct": (lambda: gen.reconstruct(hier, x, 1),
                             {"convlstm_proj_forward nores": 1, "head_sample_forward": 2,
                              "convlstm_scan_forward hs": 1}),
    }
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for what, (fn, want) in runs.items():
            spy.calls.clear()
            fn()
            assert spy.counts() == want, (what, spy.counts())


def test_prior_chain_salts(monkeypatch):
    """The chain draws chunk k with salt CHAIN_SALT + k: distinct per chunk
    and apart from the posterior's salts 0 and 1 (a reconstruction from the
    same seed)."""
    salts = []
    real = hier_module.head_and_sample

    def spy(*args, salt=0, **kw):
        salts.append(salt)
        return real(*args, salt=salt, **kw)

    monkeypatch.setattr(hier_module, "head_and_sample", spy)
    _, hier = _models("hier_vae", False, False)
    gen.prior_sample(hier, 4, B, seq_len=8)
    assert salts == [CHAIN_SALT + k for k in range(4)]
    assert not set(salts) & {0, 1}
    salts.clear()
    gen.reconstruct(hier, torch.from_numpy(_frames_in("hier_vae")), 4)
    assert salts == [0, 1]


def test_save_grid_and_gif_match_the_jax_writers(tmp_path):
    """The port's writers and the JAX package's decode to the same pixels:
    a 2x2 PNG grid of 64x64 frames and a 3-frame GIF of a tiled batch."""
    from PIL import Image

    frames = np.random.default_rng(0).uniform(size=(4, 3, 64, 64)).astype(np.float32)
    gen.save_grid(frames[:, 0], str(tmp_path / "g.png"))
    jgen.save_grid(frames[:, 0], str(tmp_path / "jg.png"))
    gen.save_gif(frames, str(tmp_path / "g.gif"))
    jgen.save_gif(frames, str(tmp_path / "jg.gif"))
    png, jpng = (np.asarray(Image.open(tmp_path / f)) for f in ("g.png", "jg.png"))
    assert png.shape == (128, 128)
    np.testing.assert_array_equal(png, jpng)
    gif, jgif = Image.open(tmp_path / "g.gif"), Image.open(tmp_path / "jg.gif")
    assert gif.n_frames == jgif.n_frames == 3
    for i in range(3):
        gif.seek(i)
        jgif.seek(i)
        a, b = np.asarray(gif.convert("L")), np.asarray(jgif.convert("L"))
        assert a.shape == (64, 256)
        np.testing.assert_array_equal(a, b)
