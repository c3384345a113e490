"""mmvae_torch's CUDA and Triton kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
neither jax nor mmvae_tpu, so it runs on a GPU host that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: tests/conftest.py sets up jax for the JAX package's tests.)
"""

import numpy as np
import pytest
import torch

from mmvae_torch import ops
from mmvae_torch.configs import get_config
from mmvae_torch.ops import convlstm_kernels as ck
from mmvae_torch.ops import elbo_kernels, head_kernels, kernel_checks, preprocess_kernels
from mmvae_torch.ops import seeds
from mmvae_torch.train.loop import build_model, make_train_step
from mmvae_torch.train.state import create_train_state

pytestmark = pytest.mark.cuda


def _general_launches() -> int:
    """K5's and K6's launches on the general route (outside the wgmma
    kernels' domain; `ops.launch_counts_by_route`)."""
    return sum(n for k, n in ops.launch_counts_by_route().items() if k.endswith(" general"))


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


@pytest.mark.parametrize("gate_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 7, 5, 6, 48, 32), (2, 4, 7, 9, 32, 16),
                                   (5, 3, 7, 9, 32, 16), (160, 10, 8, 8, 128, 128),
                                   (3, 7, 5, 6, 48, 160), (2, 3, 8, 8, 128, 256)])
def test_proj_kernel_matches_plain(dev, shape, gate_dtype):
    """K5 at unaligned positions (5x6, 7x9), odd B and T, at config 5's
    full-width shape (B=160, T=10: more clusters than the card holds at
    once) and at two 4-CTA widths, with the smoke's comparison and
    tolerances (`kernel_checks.compare_proj`)."""
    kernel_checks.compare_proj(dev, shape, gate_dtype).check(f"convlstm_proj {shape}")


@pytest.mark.parametrize("shape", [(3, 7, 5, 6, 48, 32), (64, 20, 8, 8, 128, 128)])
def test_proj_backward_is_bit_reproducible(dev, shape):
    """Two K5 backward calls on the same inputs give bit-identical gradients
    (dW, dWx and dbx included): every sum runs in a fixed order."""
    same = kernel_checks.proj_backward_repeatable(dev, shape)
    assert all(same.values()), same


@pytest.mark.parametrize("cin,feat", [(128, 128), (48, 32), (32, 16), (160, 64), (128, 160),
                                      (128, 192), (32, 224), (128, 256)])
def test_proj_layout_matches_the_wrapper(dev, cin, feat):
    """K5's shared-memory layout as the library computes it equals
    `proj_geometry`'s (the CPU tests check the Python side's sizes)."""
    got, want = ck._layouts(cin, feat)
    assert got == want


@pytest.mark.parametrize("gate_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 16, 16), (3, 7, 5, 6, 48, 32),
                                   (2, 4, 7, 9, 32, 80), (2, 3, 8, 8, 128, 128)])
def test_proj_kernel_matches_plain_in_f32(dev, shape, gate_dtype):
    """K5 with f32 activations (3xTF32 products) at small shapes, unaligned
    positions and F = 16-128, with the smoke's comparison and its f32
    limit (`kernel_checks.compare_proj`, act=float32)."""
    kernel_checks.compare_proj(dev, shape, gate_dtype, act=torch.float32).check(
        f"convlstm_proj f32 {shape}")


@pytest.mark.parametrize("shape", [(3, 7, 5, 6, 48, 32), (8, 6, 8, 8, 128, 128)])
def test_proj_backward_is_bit_reproducible_in_f32(dev, shape):
    same = kernel_checks.proj_backward_repeatable(dev, shape, act=torch.float32)
    assert all(same.values()), same


@pytest.mark.parametrize("feat", [16, 48, 80, 112, 128])
def test_f32_layouts_match_the_wrapper(dev, feat):
    """K5's and K6's f32 shared-memory layouts as the library computes them
    equal `proj_geometry`'s and `scan_geometry`'s (es = 4)."""
    for cin in (16, 128):
        got, want = ck._layouts(cin, feat, 4)
        assert got == want
    got, want = ck._scan_layouts(feat, 4)
    assert got == want


def test_kernels_refuse_f32_above_128(dev):
    """f32 at F = 160, which the wgmma kernels refuse (their f32 BPTT tile
    would not fit), runs the general kernels on the card, K5 and K6, within
    the f32 limits of their plain versions; the wgmma kernels launch none."""
    ops.reset_launch_counts()
    kernel_checks.compare_proj(dev, (1, 2, 4, 4, 16, 160), torch.float32,
                               act=torch.float32).check("convlstm_proj f32 F=160")
    kernel_checks.compare_scan(dev, (1, 2, 4, 4, 160), True, torch.float32,
                               act=torch.float32).check("convlstm_scan f32 F=160")
    counts, routes = ops.launch_counts(), ops.launch_counts_by_route()
    for name in ("convlstm_proj_forward", "convlstm_proj_backward", "convlstm_scan_forward",
                 "convlstm_scan_backward"):
        assert counts[name] == routes[f"{name} general"] > 0, routes


@pytest.mark.parametrize("feat", [144, 288])
def test_kernels_refuse_widths_outside_their_domain(dev, feat):
    """F = 144 (above 128, not a multiple of 32) and 288 (above 256), which
    the wgmma kernels do not take, run the general kernels on the card
    within the bf16 limits of their plain versions."""
    ops.reset_launch_counts()
    kernel_checks.compare_proj(dev, (1, 2, 4, 4, 16, feat), torch.float32).check(
        f"convlstm_proj F={feat}")
    kernel_checks.compare_scan(dev, (1, 2, 4, 4, feat), False, torch.bfloat16).check(
        f"convlstm_scan F={feat}")
    counts, routes = ops.launch_counts(), ops.launch_counts_by_route()
    assert routes["convlstm_proj_forward general"] == counts["convlstm_proj_forward"] > 0
    assert routes["convlstm_scan_backward general"] == counts["convlstm_scan_backward"] > 0


@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 3, 16, 16, 8, 8), (1, 1, 9, 13, 24, 20),
                                   (3, 2, 5, 6, 40, 37), (2, 2, 8, 8, 128, 144),
                                   (64, 2, 16, 16, 128, 128), (2, 3, 16, 16, 24, 44),
                                   (1, 2, 32, 32, 8, 288)])
def test_general_kernels_match_plain(dev, shape, act):
    """The general kernels (a 16x16 grid, at full width too, odd grids and
    widths, F and C off the multiples of 8 and 16, a 32x32 grid at F = 288
    whose h, dgates and partials live in global scratch), K5 and K6 in every
    mode, both gate dtypes, within the limits of `kernel_checks`, each
    backward twice bit-identical."""
    got = kernel_checks.check_general(dev, shape, act)
    assert all(got["same"].values()), got["same"]


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(64, 20, 16, 16, 128, 128), (64, 20, 8, 8, 128, 192),
                                   (2, 3, 16, 16, 24, 44), (1, 2, 32, 32, 8, 288),
                                   (2, 4, 16, 16, 16, 16), (1, 1, 9, 13, 24, 20)])
def test_general_layout_matches_the_wrapper(dev, shape, es):
    """The general kernels' geometry as the library computes it (K5 and K6)
    equals `general_geometry`'s (`_general_layout` raises otherwise)."""
    b, t, h, w, c, f = shape
    for cin in (c, 0):
        geo = ck._general_layout(b, t, h, w, cin, f, es)
        assert geo is ck.general_geometry(b, t, h, w, cin, f, es)


@pytest.mark.parametrize("side", [8, 16], ids=["wgmma", "general"])
def test_k6_rounds_f32_xg_to_bf16_gates(dev, side):
    """f32 activations, bf16 gates, one K6 step on either route (an 8x8 grid
    takes the wgmma kernels, 16x16 the general ones): xg is rounded to the
    gate dtype before the taps are added, as the TPU kernel rounds it.  The
    g gate's xg is 2^-4 + 3 2^-14 and its taps 3 2^-14 (the centre tap of
    the one live hidden channel): rounded first, 2^-4 + 0; added in f32,
    2^-4 + 2^-11.  i and o saturate and c_0 = 0, so c_1 = tanh(g) shows
    the rounding; both routes equal the plain version bit for bit."""
    feat = 16
    g = slice(2 * feat, 3 * feat)
    xg = torch.zeros(1, 1, side, side, 4 * feat, device=dev)
    xg[..., :feat] = xg[..., 3 * feat:] = 10.0
    xg[..., g] = 2.0 ** -4 + 3 * 2.0 ** -14
    w = torch.zeros(3, 3, feat, 4 * feat, device=dev)
    w[1, 1, 0, g] = 3 * 2.0 ** -14
    c0 = torch.zeros(1, side, side, feat, device=dev)
    h0 = torch.zeros_like(c0)
    h0[..., 0] = 1.0
    ops.reset_launch_counts()
    _, c_t = ck.scan_forward_cuda(xg, w, c0, h0, 1, torch.bfloat16, "last")
    way = "wgmma" if side == 8 else "general"
    assert ck.route(torch.float32, feat, side * side) == way
    assert ops.launch_counts_by_route()[f"convlstm_scan_forward {way}"] == 1
    _, want = ck.scan_forward_plain(xg, w, c0, h0, 1, torch.bfloat16, "last")
    assert torch.equal(c_t, want)
    rounded = torch.tanh(torch.tensor(2.0 ** -4, dtype=torch.bfloat16)).float()
    assert torch.all(c_t == rounded.to(dev)), c_t.unique()


def test_route_matches_the_library(dev):
    """`route` in Python and `mmvae_convlstm_route` in the library pick the
    same kernels at every F up to 300 and a spread of H*W and C."""
    lib = ck._build.library()
    for act in (torch.bfloat16, torch.float32):
        for hw in (1, 64, 65, 256):
            for cin in (None, 8, 16, 24, 128, 512):
                for feat in range(1, 301):
                    want = 1 if ck.route(act, feat, hw, cin) == "general" else 0
                    assert lib.mmvae_convlstm_route(ck._DTYPE_CODE[act], feat, hw,
                                                    cin or 0) == want, (act, feat, hw, cin)


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
    counts = ops.launch_counts()
    # the decoder runs K6 under the default (auto) policy on the card, on the
    # wgmma kernels; the head samples through the fused op, never the
    # standalone K2
    routes = ops.launch_counts_by_route()
    assert routes["convlstm_scan_forward wgmma"] == routes["convlstm_scan_backward wgmma"] == 2
    assert counts.pop("reparameterize") == 0 and _general_launches() == 0
    assert all(n == 2 for n in counts.values()), counts


def _decoder_run(dev, fused, act=torch.bfloat16, gate=torch.bfloat16):
    """Config 3's decoder ConvLSTM (token 16 -> F = 128 over 8x8, remat) on
    one draw at full width (64 clips x 20 steps): hs and the gradients of
    the token, both state tensors and both weights under per-step
    cotangents, in f32."""
    from mmvae_torch.models.convlstm import ConvLSTM

    torch.manual_seed(1)
    m = ConvLSTM(16, 128, dtype=act, gate_dtype=gate, remat=True, fused=fused, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    token = torch.randn(64, 1, 8, 8, 16, generator=g, device=dev).to(torch.bfloat16)
    c0, h0 = ((0.5 * torch.randn(64, 8, 8, 128, generator=g, device=dev)).to(torch.bfloat16)
              for _ in range(2))
    dhs = torch.randn(64, 20, 8, 8, 128, generator=g, device=dev)
    token, c0, h0 = (t.to(act).requires_grad_() for t in (token, c0, h0))
    with kernel_checks.full_f32():
        _, hs = m((c0, h0), token, length=20)
        (hs.float() * dhs).sum().backward()
    out = {"hs": hs, "dtoken": token.grad, "dc0": c0.grad, "dh0": h0.grad,
           "dW_input": m.input.weight.grad, "dW_hidden": m.step.hidden.weight.grad}
    return {k: v.detach().float() for k, v in out.items()}


def test_config3_decoder_under_auto_runs_k6_as_the_eager_loop(dev):
    """Config 3's full-width decoder under auto runs K6 once each way on the
    wgmma route, and agrees with the same module under fused=False (the
    eager loop under remat): hs within the 0.05 of K6 against its plain
    version with bf16 gates (`kernel_checks`); each gradient as close to
    the f32 result (f32 activations and gates, the eager loop, TF32 off) as
    the eager loop's, within twice its relative L2 distance (the eager
    loop's bf16 autograd rounds dc at every step, so the 2 bf16 ulps that
    K6 is held to against a plain version on the same residuals would hold
    the eager loop's rounding, not K6's)."""
    ops.reset_launch_counts()
    auto = _decoder_run(dev, None)
    routes = ops.launch_counts_by_route()
    assert routes["convlstm_scan_forward wgmma"] == routes["convlstm_scan_backward wgmma"] == 1
    ops.reset_launch_counts()
    eager = _decoder_run(dev, False)
    assert sum(ops.launch_counts().values()) == 0
    truth = _decoder_run(dev, False, torch.float32, torch.float32)
    reading = kernel_checks._scaled("hs", auto["hs"], eager["hs"], 0.0)
    assert reading.value <= reading.limit, reading.text

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    for name in ("dtoken", "dc0", "dh0", "dW_input", "dW_hidden"):
        got, want = rel(auto[name], truth[name]), rel(eager[name], truth[name])
        assert got <= 2 * want, (name, got, want)


@pytest.mark.parametrize("resident_epochs", [False, True])
def test_chunk_replays_equal_eager_steps(dev, resident_epochs):
    """`chunk_steps`: 3 calls of a graph of 2 steps (the first eager, then
    capture and 2 replays) end bit-identical to 6 eager steps, with the
    same per-step losses and launch counts."""
    from mmvae_torch.train.loop import chunk_steps

    cfg = get_config("seq_vae")
    cfg.model.kwargs.update(latent_dim=8, enc_channels=(16, 32, 32), lstm_features=16)
    data = torch.randint(0, 256, (9, 4, 64, 64), device=dev, dtype=torch.uint8,
                         generator=torch.Generator(device=dev).manual_seed(3))
    runs = []
    for k in (1, 2):
        model = build_model(cfg, dev)
        state = create_train_state(model, cfg.optim)
        step = make_train_step(model, resident_batch=2, resident_epochs=resident_epochs)
        call = step if k == 1 else chunk_steps(step, 2)
        ops.reset_launch_counts()
        losses = torch.cat([call(state, data)["loss"].reshape(-1) for _ in range(6 // k)])
        runs.append((state, losses.cpu(), ops.launch_counts()))
    (one, l1, c1), (two, l2, c2) = runs
    assert two.step == int(two.step_t) == 6 and c1 == c2
    assert torch.equal(l1, l2) and len(set(l1.tolist())) == 6
    for (name, p), q in zip(one.model.named_parameters(), two.model.parameters()):
        assert torch.equal(p, q), name


# The benchmark's cells (`BENCHMARK.json`): config, overrides, the regions
# its step opens
REGION_CELLS = {
    "seq_vae.resident.k10": ("seq_vae", (), (
        "rows", "preprocess", "model_fwd/frame_enc", "model_fwd/enc_lstm",
        "model_fwd/latent_head", "model_fwd/z_init", "model_fwd/dec_lstm",
        "model_fwd/frame_dec", "elbo_reduce", "optimizer")),
    "hier_vae_fused.resident.k10": ("hier_vae", ("model.kwargs.fused=true",), (
        "rows", "preprocess", "model_fwd", "model_fwd/frame_enc", "model_fwd/chunk_lstm",
        "model_fwd/dec_lstm", "model_fwd/frame_dec", "elbo_reduce", "optimizer")),
}


def _cell_chunk(dev, cell):
    """(state, data, chunk) of the cell's config at its widths and batch, ten
    steps a graph."""
    from mmvae_torch.bench.throughput import setup_resident_training

    name, overrides, _ = REGION_CELLS[cell]
    return setup_resident_training(get_config(name, overrides + ("train.steps_per_call=10",)),
                                   dev)


@pytest.mark.parametrize("cell", list(REGION_CELLS))
def test_region_boundaries_add_no_graph_node(dev, cell, monkeypatch):
    """A chunk captured with the region boundaries holds the same work
    nodes, in the same order and with the same kernel names, as one captured
    with the recorder stubbed out (no boundary, no backward hook); every
    kernel node is named and every region holds work; the map is walked
    once."""
    import contextlib

    from mmvae_torch.train import loop
    from mmvae_torch.utils import profiling

    @contextlib.contextmanager
    def no_boundaries(frontier=None):
        yield profiling.RegionRecorder(lambda: None)  # walks the graph, records nothing

    maps = []
    for stub in (True, False):
        with monkeypatch.context() as m:
            if stub:
                m.setattr(loop, "record_regions", no_boundaries)
            state, data, chunk = _cell_chunk(dev, cell)
            chunk(state, data)
        maps.append(chunk.regions())
        assert chunk.regions() is maps[-1]  # walked once a capture
        del state, data, chunk
        torch.cuda.empty_cache()
    plain, marked = maps
    assert plain.chain and marked.chain and plain.graph_nodes == marked.graph_nodes
    assert [n[:2] for n in plain.nodes] == [n[:2] for n in marked.nodes]
    assert all(name for kind, name, _, _ in marked.nodes if kind == "kernel")
    assert {path for _, _, path, _ in plain.nodes} == {()}
    held = {"/".join(path) for _, _, path, _ in marked.nodes}
    assert set(REGION_CELLS[cell][2]) <= held <= set(REGION_CELLS[cell][2]) | {"", "model_fwd"}


@pytest.mark.parametrize("cell", list(REGION_CELLS))
def test_traced_replays_match_the_region_map(dev, cell, tmp_path):
    """Every replay of a traced window of 3 calls is whole in the trace and
    matches the chunk's map, and the rows (regions and `?`) sum to the
    replays' span a step within 0.5 %, the rest `?` at most 3 % of it."""
    from mmvae_torch.bench import regions
    from mmvae_torch.utils import profiling

    state, data, chunk = _cell_chunk(dev, cell)
    chunk(state, data)
    chunk(state, data)
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(3):
            chunk(state, data)
    trace = regions.load_trace(prof.trace_path)
    rows = regions.replay_budget(trace, chunk.regions(), 30, depth=2)
    assert rows is not None
    launches = [e["args"]["correlation"] for e in trace["traceEvents"]
                if e.get("ph") == "X" and e.get("name") == "cudaGraphLaunch"]
    assert len(launches) == 3
    span = 0.0
    for corr in launches:
        work = [e for e in trace["traceEvents"] if e.get("ph") == "X"
                and e.get("cat") in regions.DEVICE_CATS and e["args"].get("correlation") == corr]
        assert len(work) == len(chunk.regions().nodes)
        span += max(e["ts"] + e["dur"] for e in work) - min(e["ts"] for e in work)
    span_ms = span / 1e3 / 30
    total = sum(f + b for f, b, _ in rows.values())
    assert total == pytest.approx(span_ms, rel=5e-3)
    assert set(REGION_CELLS[cell][2]) <= set(rows)
    unattributed = rows.get(regions.UNATTRIBUTED, (0.0, 0.0, 0.0))
    assert sum(unattributed[:2]) <= 0.03 * span_ms
    assert rows["optimizer"][1] == 0 and rows["model_fwd/dec_lstm"][1] > 0


def test_recipe_train_step_generates_and_keeps_an_ema(dev):
    """The recommended recipe (fast_mid, clips generated on the card, EMA) at
    small widths: finite losses, K1, K3, K5, K6 (the decoder under auto) and
    the head once a step, the standalone K2 never, and an EMA off the live
    parameters."""
    from mmvae_torch.bench.throughput import setup_resident_training

    cfg = get_config("seq_vae", ("model.kwargs.dec_upsample=fast_mid",
                                 "data.on_device_generate=true", "optim.ema_decay=0.999",
                                 "data.batch_size=2", "data.seq_len=4"))
    cfg.model.kwargs.update(latent_dim=8, enc_channels=(16, 32, 32), lstm_features=16)
    state, data, step = setup_resident_training(cfg, dev)
    assert data is None
    ops.reset_launch_counts()
    losses = [float(step(state, data)["loss"]) for _ in range(3)]
    assert all(torch.isfinite(torch.tensor(losses)))
    counts = ops.launch_counts()
    assert counts["convlstm_scan_forward"] == counts["convlstm_scan_backward"] == 3
    assert counts.pop("reparameterize") == 0 and _general_launches() == 0
    assert all(n == 3 for n in counts.values()), counts
    live = dict(state.model.named_parameters())
    assert any(not torch.equal(e, live[n]) for n, e in state.ema_params.items())


@pytest.mark.parametrize("tf32", [False, True])
def test_ongen_clips_equal_the_cpus(dev, tf32):
    """From the same draws the card's clips equal the CPU's byte for byte,
    whatever the TF32 settings."""
    from mmvae_torch.data import ongen

    cpu, card = ongen.Canvas(8, 20, 64, device="cpu"), ongen.Canvas(8, 20, 64, device=dev)
    draws = cpu.draw(2, 2)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        got = card.render(ongen.Draws(*(d.to(dev) for d in draws)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    assert torch.equal(got.cpu(), cpu.render(draws))


@pytest.mark.parametrize("gate_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("const", [True, False])
@pytest.mark.parametrize("shape", [(3, 7, 5, 6, 32), (2, 4, 7, 9, 16), (3, 7, 5, 6, 192),
                                   (2, 4, 7, 9, 224)])
def test_scan_kernel_matches_plain(dev, shape, const, gate_dtype):
    """K6 in every mode at unaligned positions (5x6, 7x9) and odd T, with the
    smoke's comparison and tolerances (`kernel_checks.compare_scan`)."""
    kernel_checks.compare_scan(dev, shape, const, gate_dtype).check(f"convlstm_scan {shape}")


@pytest.mark.parametrize("const", [True, False])
@pytest.mark.parametrize("shape", [(3, 7, 5, 6, 32), (64, 10, 8, 8, 128), (64, 20, 8, 8, 192)])
def test_scan_backward_is_bit_reproducible(dev, shape, const):
    """Two K6 backward calls on the same inputs give bit-identical gradients
    (dW and a time-constant xg's dxg sum included), at an unaligned shape
    and at config 4's decoder."""
    same = kernel_checks.scan_backward_repeatable(dev, shape, const)
    assert all(same.values()), same


@pytest.mark.parametrize("feat", [128, 112, 64, 48, 32, 16, 160, 192, 224, 256])
def test_scan_layout_matches_the_wrapper(dev, feat):
    """K6's shared-memory layout as the library computes it, for a
    time-constant and a streaming xg, equals `scan_geometry`'s."""
    got, want = ck._scan_layouts(feat)
    assert got == want


@pytest.mark.parametrize("gate_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("const", [True, False])
@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 16), (3, 7, 5, 6, 32), (2, 4, 8, 8, 128)])
def test_scan_kernel_matches_plain_in_f32(dev, shape, const, gate_dtype):
    """K6 with f32 activations in every mode at small shapes, with the
    smoke's comparison and its f32 limit (`kernel_checks.compare_scan`,
    act=float32)."""
    kernel_checks.compare_scan(dev, shape, const, gate_dtype, act=torch.float32).check(
        f"convlstm_scan f32 {shape}")


@pytest.mark.parametrize("const", [True, False])
def test_scan_backward_is_bit_reproducible_in_f32(dev, const):
    same = kernel_checks.scan_backward_repeatable(dev, (3, 7, 5, 6, 32), const,
                                                  act=torch.float32)
    assert all(same.values()), same


@pytest.mark.parametrize("name", ["pred_vae", "hier_vae"])
def test_fused_train_steps_launch_k5_and_k6(dev, name):
    """A few train steps of configs 4 and 5 with fused=true at small widths:
    finite losses, and every kernel launched once a step."""
    cfg = get_config(name, ("model.kwargs.fused=true",))
    cfg.model.kwargs.update(enc_channels=(16, 32, 32), lstm_features=16)
    cfg.model.kwargs.update({"hier_vae": {"chunk_len": 2}, "pred_vae": {"context_len": 2}}[name])
    cfg.data.batch_size, cfg.data.seq_len = 2, 4
    model = build_model(cfg, dev)
    state = create_train_state(model, cfg.optim)
    step = make_train_step(model, resident_batch=2)
    data = torch.randint(0, 256, (6, 4, 64, 64), device=dev, dtype=torch.uint8)
    ops.reset_launch_counts()
    losses = [float(step(state, data)["loss"]) for _ in range(3)]
    assert all(torch.isfinite(torch.tensor(losses)))
    counts = ops.launch_counts()
    # hier_vae samples twice a step (z_g, then the chunk latents with salt 1),
    # each through the fused head and sample
    assert counts.pop("reparameterize") == 0 and _general_launches() == 0
    for kernel in ("head_sample_forward", "head_sample_backward"):
        assert counts.pop(kernel) == (6 if name == "hier_vae" else 3)
    assert all(n == 3 for n in counts.values()), counts


# The sampling sites at full width (M, K, N, x dtype): configs 3, 5 (two),
# 1 and 2; then unaligned shapes, and batches past one 64-row block of the
# backward (config 3 at batch 256, config 5 at batch 32; an unaligned 150
# rows); then latent widths past 656 (several latent blocks in the
# backward, their dx partials summed by the last CTA of a K tile).
SITES = [(64, 8192, 128, torch.bfloat16), (16, 256, 128, torch.float32),
         (160, 256, 64, torch.float32), (64, 512, 20, torch.float32),
         (128, 4096, 64, torch.float32)]
WIDE_HEADS = [(64, 8192, 657, torch.bfloat16), (64, 8192, 1024, torch.bfloat16),
              (64, 256, 1024, torch.float32)]
HEAD_SHAPES = SITES + [(5, 37, 3, torch.bfloat16), (70, 300, 21, torch.float32),
                       (3, 1100, 9, torch.float32), (256, 8192, 128, torch.bfloat16),
                       (320, 256, 64, torch.float32), (150, 300, 21, torch.float32)] + WIDE_HEADS


@pytest.mark.parametrize("shape", HEAD_SHAPES, ids=str)
def test_head_kernels_match_plain(dev, shape):
    """The fused head's forward (eps injected) and backward against the plain
    version, with the smoke's comparison and tolerances
    (`kernel_checks.compare_head`)."""
    kernel_checks.compare_head(dev, shape).check(f"head_sample {shape}")


@pytest.mark.parametrize("shape", SITES + WIDE_HEADS, ids=str)
def test_head_backward_is_bit_reproducible(dev, shape):
    same = kernel_checks.head_backward_repeatable(dev, shape)
    assert all(same.values()), same


@pytest.mark.parametrize("shape", SITES + HEAD_SHAPES[8:10] + WIDE_HEADS, ids=str)
def test_head_forward_is_bit_reproducible(dev, shape):
    """200 launches warm, cold (a CUDA graph over 20 input copies) and on
    two streams at once, each bit-identical to the first launch."""
    same = kernel_checks.head_forward_repeatable(dev, shape)
    assert all(same.values()), same


@pytest.mark.parametrize("shape", SITES + WIDE_HEADS, ids=str)
def test_head_tolerance_rejects_tf32(dev, shape):
    """The f32 limit of `compare_head` rejects the same products with their
    operands rounded to TF32 (what a 1xTF32 head would read), and the
    kernels pass it (`test_head_kernels_match_plain`)."""
    ctrl = kernel_checks.head_tf32_control(dev, shape)
    assert min(ctrl.values()) > kernel_checks.F32_UNITS, ctrl


@pytest.mark.parametrize("shape", [s for s in HEAD_SHAPES if s[3] == torch.bfloat16], ids=str)
def test_head_bf16_x_skips_its_zero_lo_pass(dev, shape):
    """A bf16 x is exact in TF32: the bf16 kernels, without x's lo pass,
    give the bits of the f32 kernels (three passes) on x cast to f32,
    forward and backward (dx rounded to bf16)."""
    same = kernel_checks.head_lo_pass_same(dev, shape)
    assert all(same.values()), same


@pytest.mark.parametrize("shape", HEAD_SHAPES, ids=str)
def test_head_layout_matches_the_wrapper(dev, shape):
    m, k, n, x_dtype = shape
    geo = head_kernels.head_geometry(m, k, n, torch.finfo(x_dtype).bits // 8)
    want = (geo["fwd_splits"], geo["fwd_kslice"], geo["fwd_smem"], geo["bwd_smem"],
            geo["bwd_grid"][0], geo["bwd_latent"])
    assert head_kernels.library_layout(m, k, n, x_dtype) == want


def test_head_eps_is_normal_and_follows_the_seed(dev):
    shape = (64, 8192, 128, torch.bfloat16)
    seed = seeds.stream_seed(99, seeds.STREAM_REPARAM)
    eps = kernel_checks.head_eps(dev, shape, 3, seed)
    n = eps.numel()  # 8192 draws: 5 sigma of the mean 0.055, of the variance 0.078
    assert abs(float(eps.mean())) <= 5 / n ** 0.5
    assert abs(float(eps.var()) - 1) <= 5 * (2 / n) ** 0.5
    assert torch.equal(eps, kernel_checks.head_eps(dev, shape, 3, seed))
    assert not torch.equal(eps, kernel_checks.head_eps(dev, shape, 3, seed + 1))


def test_head_kernel_refuses_other_layouts(dev):
    x, w_mu, b_mu, w_lv, b_lv = kernel_checks.head_inputs(dev, 4, 32, 8, torch.float32, 1)
    with pytest.raises(ValueError, match="contiguous"):
        head_kernels.head_sample_forward_cuda(x.t().contiguous().t(), w_mu, b_mu, w_lv, b_lv, 0)
    with pytest.raises(TypeError, match="float32"):
        head_kernels.head_sample_forward_cuda(x, w_mu.half(), b_mu, w_lv, b_lv, 0)


def test_feed_on_the_card_hands_over_every_batch_intact(dev):
    """DeviceFeed on the card: 60 batches, each handed over while the
    consumer's stream is still busy, read there only after that work and
    then dropped (so the allocator may reuse its memory for a later copy),
    equal the host's bytes: the pinned ring, the copy events and
    `record_stream` hold."""
    from mmvae_torch.data.feed import DeviceFeed

    rng = np.random.default_rng(0)
    host = [rng.integers(0, 256, (16, 20, 64, 64), dtype=np.uint8) for _ in range(60)]
    weight = torch.arange(host[0][0].size, device=dev).view(host[0][0].shape)
    busy = torch.randn(2048, 2048, device=dev)
    sums = []
    with DeviceFeed(iter(host), dev, depth=2) as feed:
        for batch in feed:
            assert batch.is_cuda and batch.dtype == torch.uint8
            for _ in range(4):  # delay this stream's read of the batch
                busy = torch.tanh(busy @ busy)
            sums.append(torch.stack([batch.long().sum(), (batch.long() * weight).sum()]))
            del batch
    want = [[int(h.sum(dtype=np.int64)),
             int((h.astype(np.int64) * np.arange(h[0].size).reshape(h[0].shape)).sum())]
            for h in host]
    assert torch.stack(sums).cpu().tolist() == want


def test_fit_on_the_card_evaluates_and_checkpoints(dev, tmp_path):
    """`fit` of config 1 at small width on the card: resident by default,
    the fused head once a train step and once an eval batch, the standalone
    K2 never; a checkpoint that restores to the trained state bit for bit."""
    from mmvae_torch.train import checkpoint as ckpt
    from mmvae_torch.train.loop import fit

    cfg = get_config("mlp_vae", ("model.kwargs.hidden_dim=64", "data.num_sequences=40",
                                 "train.log_every=2", "train.eval_every=4",
                                 "train.eval_batches=2", f"train.checkpoint_dir={tmp_path}"))
    ops.reset_launch_counts()
    state, history = fit(cfg, max_steps=4, device=dev)
    counts = ops.launch_counts()
    assert counts["reparameterize"] == 0
    assert counts["head_sample_forward"] == 4 + 2 and counts["head_sample_backward"] == 4
    assert counts["preprocess_gather"] == 4 + 2 and counts["elbo_reduce"] == 4 + 2
    assert all(np.isfinite(h["loss"]) for h in history) and "val_loss" in history[-1]
    again, step, data_step = ckpt.restore_latest(
        str(tmp_path), create_train_state(build_model(cfg, dev), cfg.optim))
    assert step == data_step == 4
    for (n, p), (_, q) in zip(state.model.named_parameters(), again.model.named_parameters()):
        assert torch.equal(p, q), n


def test_hier_prior_sample_on_the_card(dev):
    """`prior_sample` of config 5 with fused=true at full width: 16 clips of
    100 frames through the prior chain, one fused head forward a chunk (10),
    K6 once in its "hs" mode, no backward, no K1, no standalone K2; frames
    finite in [0, 1]; with the draws injected, within 0.05 of the same
    model's frames on the CPU (the bf16 rule of the port's sampling tests)."""
    from mmvae_torch.models.hier_vae import CHAIN_SALT
    from mmvae_torch.sample import generate as gen

    cfg = get_config("hier_vae", ("model.kwargs.fused=true",))
    model = build_model(cfg, dev)
    ops.reset_launch_counts()
    frames = gen.prior_sample(model, 3, 16, seq_len=100)
    counts = ops.launch_counts_by_mode()
    assert frames.shape == (16, 100, 64, 64) and frames.dtype == np.float32
    assert np.isfinite(frames).all() and frames.min() >= 0 and frames.max() <= 1
    want = dict.fromkeys(counts, 0)
    want.update({"head_sample_forward": 10, "convlstm_scan_forward hs": 1})
    assert counts == want
    g = torch.Generator().manual_seed(0)
    draws = dict(z_g=torch.randn(2, 128, generator=g),
                 eps={CHAIN_SALT + k: torch.randn(2, 64, generator=g) for k in range(10)})
    card = gen.prior_sample(model, 0, 2, seq_len=100, **draws)
    cpu = gen.prior_sample(build_model(cfg, "cpu"), 0, 2, seq_len=100, **draws)
    assert float(np.abs(card - cpu).max()) <= 0.05


# --- data parallelism on the card (ranks of tests/_torch_dp_child.py) ---------

_DP_CFG = ("model.kwargs.latent_dim=8", "model.kwargs.hidden_dim=32", "model.dtype=float32")


def _dp_inputs(workdir, device) -> tuple:
    """mlp_vae's weights, 4 u8 frames and eps written for the ranks, and the
    single-process full-batch gradients on `device` (eps injected)."""
    from mmvae_torch.ops import dispatch

    cfg = get_config("mlp_vae", _DP_CFG)
    g = torch.Generator().manual_seed(0)
    u8 = torch.randint(0, 256, (1, 4, 64, 64), generator=g, dtype=torch.uint8)
    eps = torch.randn(1, 4, 8, generator=g)
    model = build_model(cfg, device)
    state = create_train_state(model, cfg.optim)
    torch.save({"mlp_vae": {"name": "mlp_vae", "overrides": list(_DP_CFG),
                            "state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                            "u8": u8, "eps": {0: eps}}}, workdir / "inputs.pt")
    full = {}
    state.apply_gradients = lambda: full.update(
        (n, p.grad.detach().cpu().clone()) for n, p in model.named_parameters())
    real = dispatch.make_sample_fn
    dispatch.make_sample_fn = lambda seed, e=None: real(seed, {0: eps[0]})
    try:
        make_train_step(model, binarize=False)(state, u8[0].to(device))
    finally:
        dispatch.make_sample_fn = real
    return full


def _dp_ranks(workdir, backend: str, device: str):
    import subprocess
    import sys
    from pathlib import Path

    child = Path(__file__).resolve().parent / "_torch_dp_child.py"
    procs = [subprocess.Popen([sys.executable, str(child), str(r), "2", str(workdir / "init"),
                               "steps", str(workdir), backend, device],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return [torch.load(workdir / f"steps.rank{r}.pt", weights_only=False)["mlp_vae"]
            for r in range(2)]


def _check_dp(full, ranks) -> None:
    """The ranks' averaged gradients: bit-identical across the ranks, and
    within rel L2 1e-5 of the full batch's (f32, TF32 off; the split changes
    only the order of the batch sums)."""
    for n, want in full.items():
        got = ranks[0]["grads"][n]
        assert torch.equal(got, ranks[1]["grads"][n]), n
        rel = float((got.double() - want.double()).norm() / want.double().norm())
        assert rel <= 1e-5, (n, rel)


def test_two_ranks_on_one_card_over_gloo(dev, tmp_path):
    full = _dp_inputs(tmp_path, torch.device("cuda", 0))
    _check_dp(full, _dp_ranks(tmp_path, "gloo", "cuda:0"))


def test_two_cards_over_nccl(dev, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    full = _dp_inputs(tmp_path, torch.device("cuda", 0))
    _check_dp(full, _dp_ranks(tmp_path, "nccl", "cuda:{rank}"))


def test_kernels_launch_on_the_second_card_with_the_first_current(dev):
    """Each wrapper runs its kernel on its tensors' card, whatever device is
    current: the preprocess, K1 and the head on cuda:1 from device 0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    d1 = torch.device("cuda", 1)
    g = torch.Generator(device=d1).manual_seed(0)
    data = torch.randint(0, 256, (6, 2, 64, 64), generator=g, device=d1, dtype=torch.uint8)
    idx = torch.tensor([5, 0, 3], device=d1)
    x = torch.randn(4, 64, generator=g, device=d1)
    w_mu, w_lv = torch.randn(8, 64, generator=g, device=d1), torch.randn(8, 64, generator=g, device=d1)
    b = torch.zeros(8, device=d1)
    eps = torch.randn(4, 8, generator=g, device=d1)
    with torch.cuda.device(0):
        frames = preprocess_kernels.preprocess_gather(data, idx, 3, binarize=False)
        bce, kl = elbo_kernels.elbo_reduce(frames, (frames > 0.5).float(), x, x)
        head = head_kernels.head_sample_forward(x, w_mu, b, w_lv, b, 0, eps)
        torch.cuda.synchronize(d1)
    assert torch.cuda.current_device() == 0
    torch.testing.assert_close(frames, preprocess_kernels.preprocess_gather_plain(
        data, idx, 3, binarize=False, out_dtype=torch.float32), rtol=0, atol=0)
    want = elbo_kernels.elbo_reduce_plain(frames, (frames > 0.5).float(), x, x)
    torch.testing.assert_close(torch.stack([bce, kl]), torch.stack(list(want)), rtol=1e-5,
                               atol=1e-3)
    plain = head_kernels.head_sample_forward_plain(x, w_mu, b, w_lv, b, 0, eps)
    for a, p in zip(head, plain):
        torch.testing.assert_close(a, p, rtol=1e-5, atol=1e-5)
