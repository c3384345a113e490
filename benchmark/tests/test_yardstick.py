"""CPU tests of the benchmark: finding its parts by name, the window's
arithmetic, the trace's union, the comparison, and the frozen copies held
against the port's modules as they are today.

    python -m pytest benchmark/tests -q

The tests marked `cuda` need a card and skip without one; on the card:
`python -m pytest benchmark/tests -m cuda -q`.
"""

from __future__ import annotations

import inspect
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

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


_TOY_REFERENCE = '''"""A toy of a stacked ConvLSTM at a 16x16 grid: 64x64 frames cut into 4x4
patches, `layers` ConvLSTMs of `hidden` features with k x k hidden taps,
each driven by a 1x1 projection of the layer below, a 1x1 read-out to the
patches' logits; BCE over the batch."""

import torch

from benchmark import counts
from benchmark.reference import common as c


def _dims(sizes):
    p = sizes["patch"]
    return p, 64 // p, sizes["hidden"], sizes["k"]


def spec(sizes):
    p, g, f, k = _dims(sizes)
    out, cin = [], p * p
    for i in range(sizes["layers"]):
        out += [(f"st{i}.hidden", (4 * f, f, k, k), k * k * f), (f"st{i}.input", (cin, 4 * f), cin)]
        cin = f
    return out + [("readout", (f, p * p), f)]


def eps_shapes(sizes, batch):
    return {}


def recurrences(sizes, batch):
    p, g, f, k = _dims(sizes)
    cins = [p * p] + [f] * (sizes["layers"] - 1)
    return [counts.k5_call("st_lstm", batch, sizes["seq_len"], g, g, cin, f, k=k) for cin in cins]


def loss(P, x, eps, sizes, lowp=None, hidden_conv=None, lowp32=None):
    b, t = x.shape[:2]
    p, g, f, k = _dims(sizes)
    feats = x.reshape(b, t, g, p, g, p).permute(0, 1, 2, 4, 3, 5).reshape(b, t, g, g, p * p)
    for i in range(sizes["layers"]):
        xg = (feats @ P[f"st{i}.input"]).permute(0, 1, 4, 2, 3)
        zeros = x.new_zeros(b, f, g, g)
        _, _, hs = c.convlstm(xg, P[f"st{i}.hidden"], zeros, zeros, t, lowp, hidden_conv)
        feats = torch.stack(hs, 1).permute(0, 1, 3, 4, 2)
    logits = (feats @ P["readout"]).reshape(b, t, g, g, p, p).permute(0, 1, 2, 4, 3, 5)
    return c.bce_sum(logits.reshape(b, t, 64, 64), x) / b
'''

_TOY_ROOFLINE = '''"""The stacked recurrences' share of their roofline, %."""

NAMES = ("st_lstm",)


def read(ctx):
    ms = sum(sum(v) for r, v in ctx.regions.items() if r.split("/")[-1] in NAMES)
    if ms <= 0:
        return None
    return 100.0 * sum(ctx.bound_ms.get(n, 0.0) for n in NAMES) / ms
'''

_TOY_CHECK = '''import json

from benchmark import cells, counts, harness, trace
from recorded import recorded_trace

cell = cells.load_cell("st_toy.resident.k2")
s = cell.config["sizes"]
t = recorded_trace()
names = harness.region_names(cell)
traced = {"regions": trace.regions(t, steps=2, names=names), "busy_s": 0.9, "window_s": 1.0,
          "steps": 20, "nccl_s": 0.0}
ctx = harness.per_layer_context(cell, traced, 1)
print(json.dumps({
    "module": counts.__file__, "names": list(names), "limits": cell.limits,
    "traffic": cell.traffic, "per_layer": [m["name"] for m in cell.per_layer],
    "flops": counts.flops_per_step(s, "st_toy", s["batch_size"]),
    "bound_ms": ctx.bound_ms, "recurrence_bound_ms": ctx.recurrence_bound_ms,
    "regions": {k: list(v) for k, v in traced["regions"].items()},
    "regions_without": {k: list(v) for k, v in trace.regions(t, steps=2).items()},
    "metrics": {m["name"]: cells.reader(m["name"])(ctx) for m in cell.per_layer}}))
'''


def test_a_new_architecture_is_new_files_only(tmp_path):
    """A configuration of another architecture (two stacked ConvLSTMs with
    5x5 taps at a 16x16 grid, under a region of its own) goes from new
    files and manifest entries to its FLOP count, its bounds by region, the
    trace's attribution and a roofline metric of its own, with no file
    under `benchmark/` edited."""
    here = tmp_path / "benchmark"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(here): p.read_bytes() for p in here.rglob("*") if p.is_file()}
    sizes = {"batch_size": 3, "seq_len": 4, "patch": 4, "hidden": 8, "k": 5, "layers": 2}
    (here / "configs" / "st_toy.json").write_text(json.dumps(
        {"name": "st_toy", "program": {"config": "none", "overrides": []},
         "reference": "st_toy", "regions": ["st_lstm"], "sizes": sizes}))
    (here / "reference" / "st_toy.py").write_text(_TOY_REFERENCE)
    (here / "metrics" / "st_lstm_roofline.py").write_text(_TOY_ROOFLINE)
    (here / "traffic" / "resident.k2.json").write_text(json.dumps(
        {"data": "resident", "steps_per_call": 2, "ranks": 1, "trace_calls": 10,
         "region_steps": 2}))
    (here / "limits" / "st_toy.resident.k2.json").write_text(json.dumps(
        {"loss_gap": 1.0, "grad_gap": 1.0, "update_gap": 1.0}))
    man = cells.manifest()
    man["configs"].append({"name": "st_toy", "source": "x", "file": "benchmark/configs/st_toy.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "st_toy.resident.k2", "config": "st_toy",
                             "traffic": "resident.k2", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "st_lstm_roofline", "unit": "%", "better": "higher",
                             "source": "device_trace", "layer": "x",
                             "moves": "train_frames_per_s", "workloads": ["st_toy.resident.k2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (tmp_path / "recorded.py").write_text(inspect.getsource(recorded_trace))
    (tmp_path / "check.py").write_text(_TOY_CHECK)
    res = subprocess.run([sys.executable, str(tmp_path / "check.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert Path(got["module"]).resolve() == (here / "counts.py").resolve()
    assert got["names"][-1] == "st_lstm" and got["traffic"]["steps_per_call"] == 2
    assert got["limits"]["grad_gap"] == 1.0
    assert "st_lstm_roofline" in got["per_layer"]
    # the products by hand: the first layer's projection of the frames
    # (no gradient to the data: forward and dW), the second's and the
    # read-out's (forward, dx and dW), and each layer's 5x5 hidden conv over
    # the taps inside the 16x16 grid, forward, dh and dW
    b, t, f, cp = 3, 4, 8, 16
    rows = b * t * 16 * 16
    in_image = sum(1 for y in range(16) for x in range(16) for dy in range(-2, 3)
                   for dx in range(-2, 3) if 0 <= y + dy < 16 and 0 <= x + dx < 16)
    hand = (2 * 2 * rows * cp * 4 * f + 3 * 2 * rows * f * 4 * f + 3 * 2 * rows * f * cp
            + 2 * 3 * 2 * b * t * in_image * f * 4 * f)
    assert got["flops"] == pytest.approx(hand, rel=1e-12)
    bound = sum(counts.bound_ms(*counts.k5_work(b, t, 16, 16, cin, f, bw, k=5))
                for cin in (cp, f) for bw in (False, True))
    assert got["bound_ms"] == {"st_lstm": pytest.approx(bound, rel=1e-12)}
    assert got["recurrence_bound_ms"] == pytest.approx(bound, rel=1e-12)
    # the trace: the kernel under `st_lstm` is the configuration's; without
    # its names it falls into `?`
    assert got["regions"]["st_lstm"] == [0.3, 0.0]
    assert "st_lstm" not in got["regions_without"]
    assert got["regions_without"]["?"][0] == pytest.approx(got["regions"]["?"][0] + 0.3)
    assert got["metrics"]["st_lstm_roofline"] == pytest.approx(100.0 * bound / 0.3, rel=1e-12)
    assert got["metrics"]["idle_share"] == pytest.approx(10.0)
    for rel, data in before.items():
        assert (here / rel).read_bytes() == data


def test_allreduce_ms_reads_the_nccl_time_a_step():
    read = cells.reader("allreduce_ms")
    assert read(SimpleNamespace(nccl_s=0.02, steps=100)) == pytest.approx(0.2)
    assert read(SimpleNamespace(nccl_s=0.0, steps=100)) is None


# --- the work a step declares, pinned -----------------------------------------------


def recorded_trace():
    """A small trace of two eager steps in the shape the profiler writes: a
    kernel in each of the regions configs 3 and 5 open, one under the
    optimizer, a backward kernel found by its sequence number, and one under
    a region (`st_lstm`) that no configuration in `BENCHMARK.json` opens."""
    host, dev = (1, 1), (0, 7)
    ev = []

    def span(name, ts, dur, cat="user_annotation", tid=host, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": tid[0],
                   "tid": tid[1], "args": args})

    def launch(ts, corr, kernel, dur, tid=host):
        span("cudaLaunchKernel", ts, 2, cat="cuda_runtime", tid=tid, correlation=corr)
        span(kernel, 5000 + corr * 1000, dur, cat="kernel", tid=dev, correlation=corr)

    span("model_fwd", 0, 1000)
    span("frame_enc", 10, 100)
    launch(20, 1, "conv_fwd", 300)
    span("enc_lstm", 120, 100)
    launch(130, 2, "rec_fwd", 200)
    span("chunk_lstm", 230, 50)
    launch(240, 3, "rec_fwd", 150)
    launch(300, 4, "gemm_f32", 120)
    span("dec_lstm", 400, 100)
    span("aten::conv2d", 410, 50, cat="cpu_op", **{"Sequence number": 11})
    launch(420, 5, "conv_fwd", 250)
    span("frame_dec", 520, 100)
    launch(530, 6, "conv_t", 400)
    span("optimizer", 1100, 50)
    launch(1110, 7, "adam", 80)
    node = "autograd::engine::evaluate_function: ConvolutionBackward0"
    span(node, 2000, 100, cat="cpu_op", tid=(1, 2), **{"Sequence number": 11})
    launch(2010, 8, "dgrad", 500, tid=(1, 2))
    span("st_lstm", 3000, 100)
    launch(3010, 9, "st_kernel", 600)
    return {"traceEvents": ev}


# The six per-layer metrics of the two one-card cells on `recorded_trace`,
# as the benchmark read them before configurations declared their own
# recurrences (commit 31129a5).
PINNED_METRICS = {
    "seq_vae.resident.k10": {
        "region_ms.frame_conv": 0.35, "region_ms.recurrence": 0.55,
        "recurrence_roofline": 95.49087367588929, "idle_share": 4.0000000000000036,
        "mfu": 6.8651892885096055},
    "hier_vae_fused.resident.k10": {
        "region_ms.frame_conv": 0.35, "region_ms.recurrence": 0.55,
        "recurrence_roofline": 119.36359209486167, "region_ms.hier_latent": 0.06,
        "idle_share": 4.0000000000000036, "mfu": 8.628497591263903},
}


@pytest.mark.parametrize("workload", sorted(PINNED_METRICS))
def test_the_per_layer_metrics_are_pinned_on_a_recorded_trace(workload):
    from benchmark import harness

    cell = cells.load_cell(workload)
    traced = {"regions": trace.regions(recorded_trace(), 2, names=harness.region_names(cell)),
              "busy_s": 1.2, "window_s": 1.25, "steps": 100, "nccl_s": 0.0}
    ctx = harness.per_layer_context(cell, traced, 1)
    got = {m["name"]: cells.reader(m["name"])(ctx) for m in cell.per_layer}
    assert got == pytest.approx(PINNED_METRICS[workload], rel=1e-12)


# (configuration file, reference, a rank's batch): the FLOPs of a step, its
# recurrences' least ms and their hidden products, as counted before the
# references declared their recurrences (commit 31129a5)
PINNED_COUNTS = [
    ("seq_vae", "seq_vae", 64, 848709025792.0, 0.5251998052173912, 487210352640.0),
    ("hier_vae_fused", "hier_vae", 16, 1066698014720.0, 0.6564997565217392, 609012940800.0),
    ("hier_vae_fused", "hier_vae", 4, 266674503680.0, 0.1641249391304348, 152253235200.0),
]


@pytest.mark.parametrize("config,reference,batch,flops,bound,hidden", PINNED_COUNTS)
def test_the_counts_of_configs_3_and_5_are_pinned(config, reference, batch, flops, bound, hidden):
    s = json.loads((HERE / "configs" / f"{config}.json").read_text())["sizes"]
    assert counts.flops_per_step(s, reference, batch) == pytest.approx(flops, rel=1e-12)
    declared = counts.recurrences(s, reference, batch)
    assert counts.recurrence_bound_ms(declared) == pytest.approx(bound, rel=1e-12)
    assert sum(counts.bound_ms_by_region(declared).values()) == pytest.approx(bound, rel=1e-12)
    assert sum(r.hidden_flops for r in declared) == pytest.approx(hidden, rel=1e-12)
    assert [r.region for r in declared] == [
        "enc_lstm" if reference == "seq_vae" else "chunk_lstm", "dec_lstm"]


@pytest.mark.parametrize("h,w,want", [(8, 8, 484), (16, 16, 2116), (4, 4, 100), (1, 1, 1),
                                      (64, 64, 36100), (8, 16, 1012)])
def test_taps_of_a_3x3_conv_are_pinned(h, w, want):
    assert counts.taps(h, w) == counts.taps(h, w, 3) == want


@pytest.mark.parametrize("k", [3, 5, 7])
def test_taps_are_the_pairs_inside_the_image(k):
    p = k // 2
    for h, w in ((16, 16), (8, 8), (5, 9), (p + 1, 12)):
        brute = sum(1 for y in range(h) for x in range(w) for dy in range(-p, p + 1)
                    for dx in range(-p, p + 1) if 0 <= y + dy < h and 0 <= x + dx < w)
        assert counts.taps(h, w, k) == brute
    assert counts.taps(16, 16, 5) == 74 * 74


@pytest.mark.parametrize("k", [3, 5])
def test_the_uncounted_conv_is_a_same_conv(k):
    """`counts._Uncounted` against `F.conv2d` at SAME padding on the CPU:
    the output and both gradients."""
    gen = torch.Generator().manual_seed(k)
    h = torch.randn(2, 6, 9, 7, generator=gen, dtype=torch.float64)
    w = torch.randn(8, 6, k, k, generator=gen, dtype=torch.float64)
    g = torch.randn(2, 8, 9, 7, generator=gen, dtype=torch.float64)
    grads = []
    for fn in (counts._Uncounted.apply,
               lambda a, b: torch.nn.functional.conv2d(a, b, padding=k // 2)):
        a, b = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = fn(a, b)
        out.backward(g)
        grads.append((out.detach(), a.grad, b.grad))
    for mine, want in zip(*grads):
        torch.testing.assert_close(mine, want, rtol=1e-12, atol=1e-12)


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
    assert counts.recurrence_bound_ms(counts.recurrences(seq, "seq_vae", 64)) == \
        pytest.approx(want, rel=1e-12)


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


def test_a_run_over_four_ranks_without_cards_prints_no_result_and_leaves_no_rank():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "hier_vae_fused.dp4.k10", "--seed", str(2 ** 31 + 78), "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 2 and res.stdout.strip() == ""
    assert res.stderr.count("needs 4 CUDA device(s), found 0: no result") == 4


def test_process_start_is_the_start_of_the_process_to_a_tenth_of_a_second():
    code = ("import time; from benchmark.run import process_start; "
            "print(repr(process_start()), repr(time.time()))")
    t = time.time()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
    start, now = float(out[0]), float(out[1])
    assert t - 0.1 <= start <= now
