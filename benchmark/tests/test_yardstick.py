"""CPU tests of the benchmark: finding its parts by name, the window's
arithmetic, the trace's union, the comparison, and the frozen copies held
against the port's modules as they are today.

    python -m pytest benchmark/tests -q

The tests marked `cuda` need a card and skip without one; on the card:
`python -m pytest benchmark/tests -m cuda -q`.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import cells, check, counts, draws, trace, window
from benchmark.reference import common

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


# --- finding the parts -------------------------------------------------------------


def test_every_cell_finds_its_files():
    man = cells.manifest()
    for w in man["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["steps_per_call"] >= harness_check_steps()
        assert cell.limits, f"{w['name']} has no limits file"
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"]))
    for c in man["configs"]:
        assert (ROOT / c["file"]).exists()


def harness_check_steps():
    from benchmark.harness import CHECK_STEPS

    return CHECK_STEPS


def test_a_new_cell_is_new_files_only(tmp_path):
    """One more configuration, traffic mix, cell and per-layer metric, each
    by a new file and a manifest entry, are found with no file edited."""
    here = tmp_path / "benchmark"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(here): p.read_bytes() for p in here.rglob("*") if p.is_file()}
    man = cells.manifest()
    (here / "configs" / "seq_vae_wide.json").write_text(json.dumps(
        {**json.loads((HERE / "configs" / "seq_vae.json").read_text()), "name": "seq_vae_wide"}))
    (here / "traffic" / "resident.k5.json").write_text(json.dumps(
        {"data": "resident", "steps_per_call": 5, "ranks": 1, "trace_calls": 4,
         "region_steps": 2}))
    (here / "limits" / "seq_vae_wide.resident.k5.json").write_text(json.dumps(
        {"loss_gap": 1.0, "grad_gap": 1.0, "update_gap": 1.0}))
    (here / "metrics" / "steps_traced.py").write_text("def read(ctx):\n    return ctx.steps\n")
    man["configs"].append({"name": "seq_vae_wide", "source": "x",
                           "file": "benchmark/configs/seq_vae_wide.json", "reduced": [],
                           "why": "x"})
    man["workloads"].append({"name": "seq_vae_wide.resident.k5", "config": "seq_vae_wide",
                             "traffic": "resident.k5", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                             "source": "device_trace", "layer": "x",
                             "moves": "train_frames_per_s",
                             "workloads": ["seq_vae_wide.resident.k5"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = cells.load_cell("seq_vae_wide.resident.k5", root=tmp_path, here=here)
    assert cell.traffic["steps_per_call"] == 5 and cell.limits["grad_gap"] == 1.0
    assert "steps_traced" in [m["name"] for m in cell.per_layer]
    assert cells.reader("steps_traced", here=here)(type("C", (), {"steps": 7})) == 7
    old = cells.load_cell("seq_vae.resident.k10", root=tmp_path, here=here)
    assert "steps_traced" not in [m["name"] for m in old.per_layer]
    for rel, data in before.items():
        assert (here / rel).read_bytes() == data


# --- the window ---------------------------------------------------------------------


def test_rate_is_every_frame_over_the_whole_window():
    assert window.frames_per_s(1280, 10, 200, 32.0) == pytest.approx(1280 * 10 * 200 / 32.0)
    assert window.frames_per_s(1600, 10, 100, 10.0, gpus=4) == pytest.approx(40000.0)


def test_p95_is_over_every_call_and_a_stall_moves_both():
    calls = 20
    ends = [100.0 * (i + 1) for i in range(calls)]
    assert window.step_ms_p95(ends, 10) == pytest.approx(10.0)
    stalled = ends[:10] + [e + 1900.0 for e in ends[10:]]  # call 11 takes 2 s
    assert window.step_ms_p95(stalled, 10) > 15.0
    rate = window.frames_per_s(1280, 10, calls, ends[-1] / 1e3)
    assert window.frames_per_s(1280, 10, calls, stalled[-1] / 1e3) < 0.6 * rate
    # at 200 calls the tail needs ten slow calls beyond it
    many = [10.0] * 189 + [50.0] * 11
    ends, t = [], 0.0
    for d in many:
        t += d
        ends.append(t)
    assert window.step_ms_p95(ends, 10) == pytest.approx(5.0)


def test_busy_time_is_the_union_of_intervals():
    assert trace.union_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    ev = [{"ts": 0, "dur": 10, "name": "a"}, {"ts": 5, "dur": 10, "name": "b"},
          {"ts": 40, "dur": 5, "name": "a"}]
    assert trace.busy_us(ev) == 20
    assert trace.device_ops(ev)[0] == ["a", pytest.approx(15e-6)]
    host = {"traceEvents": [{"ph": "X", "cat": "cpu_op", "name": "wait", "ts": 14, "dur": 30}]}
    assert trace.idle_gaps(host, ev) == [["wait", pytest.approx(25e-6)]]


def test_regions_attribute_kernels_by_their_launch():
    t = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "frame_enc", "ts": 0, "dur": 100,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 5,
         "pid": 1, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 200, "dur": 5,
         "pid": 1, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "conv", "ts": 20, "dur": 2000, "pid": 0, "tid": 7,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "adam", "ts": 3000, "dur": 1000, "pid": 0,
         "tid": 7, "args": {"correlation": 8}}]}
    assert trace.regions(t, steps=2) == {"frame_enc": (1.0, 0.0), "?": (0.5, 0.0)}


# --- the comparison -----------------------------------------------------------------


def _leaves(scale):
    return {"a": torch.full((4,), 1.0 * scale), "b": torch.full((9,), 2.0 * scale),
            "c": torch.full((2,), 1e-9 * scale)}


def test_gaps_by_the_worst_leaf():
    init = {k: torch.zeros_like(v) for k, v in _leaves(1).items()}
    ref = {"losses": [[10.0, 9.0, 8.0]], "grad": _leaves(1), "after": _leaves(1)}
    same = {"losses": [[10.0, 9.0, 8.0], [10.0, 9.0, 8.0]], "grad": _leaves(1),
            "after": _leaves(1)}
    assert check.gaps(same, ref, init) == {"loss_gap": 0, "grad_gap": 0, "update_gap": 0}
    off = {"losses": [[10.0, 9.0, 8.0], [10.0, 9.9, 8.0]], "grad": _leaves(1.5),
           "after": {**_leaves(1), "a": torch.zeros(4), "c": torch.ones(2)}}
    g = check.gaps(off, ref, init)
    assert g["loss_gap"] == pytest.approx(0.1)
    assert g["grad_gap"] == pytest.approx(0.5)
    assert g["update_gap"] == pytest.approx(0.5)  # "a" left unmoved; "c" is left out
    assert check.verdict(g, {"loss_gap": 0.2, "grad_gap": 0.6, "update_gap": 1.5})
    assert not check.verdict(g, {"loss_gap": 0.2, "grad_gap": 0.6, "update_gap": 0.4})
    assert not check.verdict(g, {"loss_gap": 0.2, "grad_gap": 0.6})


# --- frozen copies against the port ---------------------------------------------------


def test_seeds_and_rows_match_the_port():
    from mmvae_torch.ops import seeds
    from mmvae_torch.train.loop import uniform_rows

    for step in (0, 1, 7, 12345, 2 ** 31 - 1, 2 ** 31 + 5, 3 * 2 ** 32 + 11, 2 ** 40 + 3):
        for rank in (0, 1, 3):
            want = seeds.shard_seed(seeds.step_seed(step), rank)
            assert draws.rank_seed(step, rank) == want
            t = seeds.shard_seed_t(seeds.step_seed_t(torch.tensor(step)), rank)
            assert int(t) == want
            for stream in (1, 2, 5):
                for salt in (0, 1):
                    assert draws.stream_seed(want, stream, salt) == \
                        seeds.stream_seed(want, stream, salt) & draws.M32
            assert torch.equal(draws.uniform_rows(want, 450, 16, "cpu"),
                               uniform_rows(want, 450, 16, "cpu"))
            assert torch.equal(draws.uniform_rows(want, 9000, 64, "cpu"),
                               uniform_rows(torch.tensor(want), 9000, 64, "cpu"))


def test_philox_known_answers():
    """Random123's known-answer vectors of Philox-4x32-10."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    cases = [((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        out = draws.philox4x32(tuple(t(c) for c in ctr), key[0], key[1])
        assert tuple(int(o) for o in out) == want


def test_draws_have_their_distributions():
    pix = torch.full((4, 3, 64, 64), 64, dtype=torch.uint8)
    on = draws.binarize(pix, 12345).mean().item()
    assert on == pytest.approx(64 / 255, abs=0.01)
    eps = draws.normal(64, 128, 777, "cpu")
    assert eps.mean().abs() < 0.05 and (eps.std() - 1).abs() < 0.05


def test_resident_set_matches_the_port():
    from mmvae_torch.bench.throughput import resident_set
    from mmvae_torch.configs import get_config

    cfg = get_config("seq_vae", ("data.num_sequences=80", "data.seq_len=3"))
    assert torch.equal(draws.resident_set(72, 3, 0, "cpu"), resident_set(cfg, torch.device("cpu")))


def test_recurrence_counts_match_the_port():
    from mmvae_torch.bench import roofline

    for shape in ((64, 20, 8, 8, 128, 128), (160, 10, 8, 8, 128, 128), (40, 10, 8, 8, 128, 128)):
        assert counts.k5_work(*shape, False) == roofline.kernel_work("convlstm_proj_forward", shape)
        assert counts.k5_work(*shape, True) == roofline.kernel_work("convlstm_proj_backward", shape)
        k6 = (*shape[:4], shape[5], True)
        assert counts.k6_work(*k6[:5], True, False) == \
            roofline.kernel_work("convlstm_scan_forward", k6)
        assert counts.k6_work(*k6[:5], True, True) == \
            roofline.kernel_work("convlstm_scan_backward", k6)
    seq = json.loads((HERE / "configs" / "seq_vae.json").read_text())["sizes"]
    want = sum(roofline.bound(n, s)[0] for n, s in (
        ("convlstm_proj_forward", (64, 20, 8, 8, 128, 128)),
        ("convlstm_proj_backward", (64, 20, 8, 8, 128, 128)),
        ("convlstm_scan_forward", (64, 20, 8, 8, 128, True)),
        ("convlstm_scan_backward", (64, 20, 8, 8, 128, True))))
    assert counts.recurrence_bound_ms(seq, 64) == pytest.approx(want, rel=1e-12)


def test_flop_count_matches_the_port():
    """Config 5 fused: the port's count.  Config 3: the port's count less the
    eager decoder's products on its zero padding, which the port counts as
    cuDNN would and the benchmark does not (it counts a recurrence's taps
    inside the image whatever computes it)."""
    from mmvae_torch.bench.flops import flops_per_step
    from mmvae_torch.configs import get_config

    hier = json.loads((HERE / "configs" / "hier_vae_fused.json").read_text())["sizes"]
    port = flops_per_step(get_config("hier_vae", ("model.kwargs.fused=true",)))
    assert counts.flops_per_step(hier, "hier_vae", 16) == pytest.approx(port, rel=1e-9)
    seq = json.loads((HERE / "configs" / "seq_vae.json").read_text())["sizes"]
    padded = 3 * 2.0 * 64 * 20 * (9 * 64 - counts.taps(8, 8)) * 128 * 512
    port = flops_per_step(get_config("seq_vae"))
    assert counts.flops_per_step(seq, "seq_vae", 64) == pytest.approx(port - padded, rel=1e-9)


@pytest.mark.parametrize("name", ["seq_vae", "hier_vae_fused"])
def test_reference_matches_the_ports_plain_route(name):
    """At tiny widths in f32 on the CPU, with the same frames and eps: the
    reference's loss and gradients against the port's model and ELBO."""
    from mmvae_torch.configs import get_config
    from mmvae_torch.ops import dispatch
    from mmvae_torch.train.loop import build_model

    import importlib

    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    s = dict(conf["sizes"], enc_channels=[4, 8, 16], lstm_features=8, batch_size=2)
    ov = list(conf["program"]["overrides"]) + [
        "model.dtype=float32", "model.kwargs.gate_bf16=false", "model.kwargs.enc_channels=4,8,16",
        "model.kwargs.lstm_features=8"]
    if name == "seq_vae":
        s.update(latent_dim=8, seq_len=3)
        ov += ["model.kwargs.latent_dim=8"]
    else:
        s.update(global_latent=8, chunk_latent=4, chunk_feature=16, chunk_len=2, seq_len=4)
        ov += ["model.kwargs.global_latent=8", "model.kwargs.chunk_latent=4",
               "model.kwargs.chunk_feature=16", "model.kwargs.chunk_len=2"]
    ref = importlib.import_module(f"benchmark.reference.{conf['reference']}")
    params = common.init_params(ref.spec(s), 5, "cpu")
    model = build_model(get_config(conf["program"]["config"], tuple(ov)), "cpu")
    model.load_state_dict(params)
    gen = torch.Generator().manual_seed(1)
    x = (torch.rand(2, s["seq_len"], 64, 64, generator=gen) < 0.3).float()
    eps = {k: torch.randn(*shape, generator=torch.Generator().manual_seed(2 + k))
           for k, shape in ref.eps_shapes(s, 2).items()}
    out = model(x, dispatch.make_sample_fn(0, eps))
    bce, kl = dispatch.elbo_parts(out.logits, out.target, out.mu, out.logvar)
    port = (bce + kl + out.extra_kl) / 2
    port.backward()
    leaves = {n: p.clone().requires_grad_(True) for n, p in params.items()}
    mine = ref.loss(leaves, x, eps, s)
    mine.backward()
    assert float(mine.detach()) == pytest.approx(float(port.detach()), rel=1e-5)
    for n, p in model.named_parameters():
        torch.testing.assert_close(leaves[n].grad, p.grad, rtol=1e-4, atol=1e-5 * float(
            p.grad.abs().max()) + 1e-8, msg=n)


def test_control_rounds_to_fp8():
    x = torch.tensor([1.0 + 2 ** -6, 500.0, -1000.0, 3.0])
    assert common.fp8(x).tolist() == [1.0, 448.0, -448.0, 3.0]


def test_controls_of_the_f32_layers_round_to_tf32_and_bf16():
    x = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -10 + 2 ** -12, 3.0])
    assert common.tf32(x).tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0 + 2 ** -10, 3.0]
    assert common.bf16(torch.tensor([1.0 + 2 ** -9, 3.0])).tolist() == [1.0, 3.0]


@pytest.mark.parametrize("name", ["seq_vae", "hier_vae"])
def test_the_f32_controls_round_only_the_dense_layers(name):
    """At tiny widths on the CPU: `lowp32` moves the gradients (bf16 the
    loss too), and only through the Dense layers: with every Dense weight
    zero it changes nothing."""
    import importlib

    ref = importlib.import_module(f"benchmark.reference.{name}")
    s = dict(enc_channels=[4, 8, 16], lstm_features=8, token_ch=4, latent_dim=8, seq_len=4,
             global_latent=8, chunk_latent=4, chunk_feature=16, chunk_len=2)
    P = common.init_params(ref.spec(s), 5, "cpu")
    x = (torch.rand(2, 4, 64, 64, generator=torch.Generator().manual_seed(1)) < 0.3).float()
    eps = {k: torch.randn(*shape, generator=torch.Generator().manual_seed(2 + k))
           for k, shape in ref.eps_shapes(s, 2).items()}
    def grads(lowp32):
        leaves = {n: t.clone().requires_grad_(True) for n, t in P.items()}
        loss = ref.loss(leaves, x, eps, s, lowp32=lowp32)
        loss.backward()
        return float(loss), {n: t.grad for n, t in leaves.items()}

    plain, g_plain = grads(None)
    assert grads(common.bf16)[0] != plain
    for lowp32 in (common.tf32, common.bf16):
        g = grads(lowp32)[1]
        assert any(not torch.equal(g[n], g_plain[n]) for n in g)
    dense = {n for n, shape, _ in ref.spec(s) if n.rsplit(".", 1)[0].split(".")[0] in (
        "head", "z_to_state", "z_to_token", "chunk_proj", "g_mu", "g_logvar", "q_hidden",
        "q_mu", "q_logvar", "prior_gru", "prior_init", "p_mu", "p_logvar")}
    Z = {n: torch.zeros_like(t) if n in dense else t for n, t in P.items()}
    assert float(ref.loss(Z, x, eps, s, lowp32=common.bf16)) == float(ref.loss(Z, x, eps, s))


# --- what a run loads -----------------------------------------------------------------


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.seq_vae, benchmark.reference.hier_vae, "
            "benchmark.draws, benchmark.counts, benchmark.check, benchmark.window, "
            "benchmark.trace, benchmark.cells; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mmvae_torch', 'mmvae_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_forbidden_modules_are_named_by_their_whole_top_level_name(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "mmvae_tpux", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert "mmvae_tpu" not in run.loaded_forbidden() and "jax" not in run.loaded_forbidden() \
        or "jax" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert "flax" in run.loaded_forbidden()


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "seq_vae.resident.k10", "--seed", str(2 ** 31 + 77), "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 2 and res.stdout.strip() == ""
