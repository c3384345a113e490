"""mmvae_torch's named regions and the per-region step budget
(`mmvae_torch.bench.regions`), on the CPU at tiny widths.

The port opens the JAX package's `jax.named_scope` regions, under the same
names and at the counterpart sites (read from the `mmvae_tpu` sources), and
its own (`utils.profiling.PORT_REGIONS`) where the JAX package names none;
a traced CPU train step puts every operator, the backward's and the decoder
remat's recompute included, in its region; the reader attributes a
hand-built GPU-style trace's kernels by their launches; a profiled step
equals an unprofiled one bit for bit; `annotate` opens no range without a
profiler.  The boundaries a capture records (`utils.profiling.record_regions`)
are held here with a stand-in for the capture's frontier, a dispatch mode
that numbers the aten ops: every op of a step lands in its region, forward
and backward, and the boundaries add no op; `replay_budget` reads
hand-built traces of graph replays by a region map.
"""

import contextlib
import re
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mmvae_torch.bench import regions
from mmvae_torch.bench.throughput import setup_resident_training
from mmvae_torch.configs import get_config
from mmvae_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
# (the JAX file, its port) for every file that names a region
SITES = [("train/loop.py", "train/loop.py"), ("models/seq_vae.py", "models/seq_vae.py"),
         ("models/hier_vae.py", "models/hier_vae.py")]

TINY = {
    "seq_vae": (["model.kwargs.latent_dim=8", "data.batch_size=2", "data.seq_len=4"],
                {"enc_channels": (4, 8), "lstm_features": 8}),
    "hier_vae": (["model.kwargs.chunk_len=2", "model.kwargs.global_latent=8",
                  "model.kwargs.chunk_latent=4", "data.batch_size=2", "data.seq_len=4"],
                 {"enc_channels": (4, 8), "lstm_features": 8, "chunk_feature": 16}),
}
COMMON = ["data.num_sequences=8", "model.dtype=float32"]


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _names(path: Path, pattern: str) -> list:
    """The region names a source opens, each once, in order of first use."""
    found = re.findall(pattern, path.read_text())
    return list(dict.fromkeys(found))


_JAX = r'jax\.named_scope\("(\w+)"\)'
_PORT = r'annotate\("(\w+)"\)'


@pytest.mark.parametrize("jax_file,port_file", SITES)
def test_regions_equal_the_jax_named_scopes(jax_file, port_file):
    """The JAX package's names at their sites, in order; the train step's
    own regions (`profiling.PORT_REGIONS`) beside them are left out there,
    and a model file opens none of them."""
    want = _names(REPO / "mmvae_tpu" / jax_file, _JAX)
    assert want, f"{jax_file} names no scope"
    port = _names(REPO / "mmvae_torch" / port_file, _PORT)
    if port_file == "train/loop.py":
        port = [n for n in port if n not in profiling.PORT_REGIONS]
    assert port == want


def test_no_other_region_is_opened():
    """Only the counterpart sites open regions (pred_vae, conv_vae and
    mlp_vae name none in the JAX package), the port's own among them in
    its train step, and the reader's names are the JAX package's, then the
    port's."""
    jax_files = {p.relative_to(REPO / "mmvae_tpu").as_posix()
                 for p in (REPO / "mmvae_tpu").rglob("*.py")
                 if re.search(_JAX, p.read_text())}
    port_files = {p.relative_to(REPO / "mmvae_torch").as_posix()
                  for p in (REPO / "mmvae_torch").rglob("*.py")
                  if re.search(_PORT, p.read_text())}
    assert jax_files == port_files == {j for j, _ in SITES}
    every = {n for j, _ in SITES for n in _names(REPO / "mmvae_tpu" / j, _JAX)}
    assert set(regions.JAX_REGIONS) == every
    assert regions.REGIONS == regions.JAX_REGIONS + profiling.PORT_REGIONS
    own = set(_names(REPO / "mmvae_torch" / "train/loop.py", _PORT)) - every
    assert own == set(profiling.PORT_REGIONS)


def _tiny(name, *overrides):
    over, narrow = TINY[name]
    cfg = get_config(name, tuple(over + COMMON + list(overrides)))
    cfg.model.kwargs.update(narrow)
    return cfg


def _traced_step(cfg, tmp_path):
    state, data, step = setup_resident_training(cfg, torch.device("cpu"))
    step(state, data)
    with profiling.trace(str(tmp_path)) as prof:
        step(state, data)
    return regions.load_trace(prof.trace_path)


def _node_regions(trace) -> dict:
    """{autograd node name: the set of (region path, pass) it resolves to}."""
    t = regions._Trace(trace)
    out = {}
    for i, e in enumerate(t.host):
        if e["cat"] == "cpu_op" and e["name"].startswith(regions._NODE):
            out.setdefault(e["name"][len(regions._NODE):], set()).add(t.place(i))
    return out


def _recomputed(trace) -> set:
    """Where the forward operators run inside a backward node land: the
    remat recompute's."""
    t = regions._Trace(trace)
    out = set()
    for i, e in enumerate(t.host):
        args = e.get("args") or {}
        if e["cat"] != "cpu_op" or "Sequence number" not in args or args.get("Fwd thread id"):
            continue
        j = t.parent[i]
        while j is not None and not t.host[j]["name"].startswith(regions._NODE):
            j = t.parent[j]
        if j is not None and not e["name"].startswith(regions._NODE):
            out.add(t.place(i))
    return out


SEQ = ("model_fwd/frame_enc", "model_fwd/enc_lstm", "model_fwd/latent_head",
       "model_fwd/z_init", "model_fwd/dec_lstm", "model_fwd/frame_dec")
HIER = ("model_fwd/frame_enc", "model_fwd/chunk_lstm", "model_fwd/dec_lstm",
        "model_fwd/frame_dec")
STEP_CASES = {
    # (config, overrides, the model's regions, where each custom Function's
    #  backward must land, whether the decoder recomputes under remat)
    "seq_vae remat": ("seq_vae", (), SEQ, {
        "_ElboReduceBackward": ("elbo_reduce",),
        "_ScanProjLastBackward": ("model_fwd", "enc_lstm"),
        "_GaussianHeadSampleBackward": ("model_fwd", "latent_head")}, True),
    "seq_vae no remat": ("seq_vae", ("model.kwargs.remat=false",), SEQ, {}, False),
    "seq_vae fused": ("seq_vae", ("model.kwargs.fused=true",), SEQ, {
        "_ScanProjLastBackward": ("model_fwd", "enc_lstm"),
        "_ScanBackward": ("model_fwd", "dec_lstm")}, False),
    "hier_vae remat": ("hier_vae", (), HIER, {
        "_ElboReduceBackward": ("elbo_reduce",),
        "_ScanProjLastBackward": ("model_fwd", "chunk_lstm"),
        "_GaussianHeadSampleBackward": ("model_fwd",)}, True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_cpu_step_lands_in_its_regions(case, tmp_path):
    name, overrides, model_regions, nodes, remat = STEP_CASES[case]
    trace = _traced_step(_tiny(name, *overrides), tmp_path)
    b = regions.budget(trace, steps=1)
    assert b["timeline"] == "host"
    rows = {r["region"]: r for r in b["rows"]}
    for region in ("rows", "preprocess", *model_regions, "elbo_reduce", "optimizer"):
        assert rows[region]["fwd_ms"] > 0, region
    # every region with parameters, or with a differentiable input, has a backward
    for region in (*model_regions, "elbo_reduce"):
        assert rows[region]["bwd_ms"] > 0, region
    for region in ("rows", "preprocess", "optimizer"):  # nothing to differentiate
        assert rows[region]["bwd_ms"] == 0, region
    assert set(rows) <= {"rows", "preprocess", "model_fwd", *model_regions, "elbo_reduce",
                         "optimizer", regions.UNATTRIBUTED}
    assert sum(r["ms"] for r in b["rows"]) == pytest.approx(b["total_ms"], rel=1e-12)
    assert sum(r["share"] for r in b["rows"]) == pytest.approx(1.0)

    by_node = _node_regions(trace)
    for node, region in nodes.items():
        assert by_node[node] == {(region, "bwd")}, node
    recomputed = _recomputed(trace)
    if remat:
        assert recomputed == {(("model_fwd", "dec_lstm"), "bwd")}
    else:
        assert recomputed == set()
    # depth 1: the model's regions fold into model_fwd
    shallow = {r["region"] for r in regions.budget(trace, steps=1, depth=1)["rows"]}
    assert shallow == {"rows", "preprocess", "model_fwd", "elbo_reduce", "optimizer",
                       regions.UNATTRIBUTED}


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _kernel(name, corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


NODE = regions._NODE


def _gpu_style_trace() -> dict:
    """Two forward regions on the main thread (tid 1), a memset in one,
    their autograd nodes on the engine's thread (tid 2: one found by its
    fwdbwd flow, though another operator shares its sequence number, one by
    its sequence number alone), an optimizer launch outside
    every region, and a kernel whose launch the trace lost."""
    seq = {"Sequence number": 5, "Fwd thread id": 0}
    seq2 = {"Sequence number": 6, "Fwd thread id": 0}
    return {"traceEvents": [
        _x("user_annotation", "model_fwd", 1, 0.0, 100.0),
        _x("user_annotation", "enc_lstm", 1, 10.0, 40.0),
        _x("cpu_op", "_ScanProjLast", 1, 12.0, 30.0, **seq),
        _x("cuda_runtime", "cudaLaunchKernelExC", 1, 15.0, 5.0, correlation=1),
        _x("user_annotation", "latent_head", 1, 60.0, 30.0),
        _x("cpu_op", "_GaussianHeadSample", 1, 62.0, 20.0, **seq2),
        _x("cuda_runtime", "cudaLaunchKernel", 1, 65.0, 3.0, correlation=2),
        _x("user_annotation", "Optimizer.step#FusedAdam.step", 1, 300.0, 20.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1, 305.0, 2.0, correlation=5),
        {"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "id": 12, "pid": 1, "tid": 1,
         "ts": 62.0},
        # an operator of the engine's thread whose own sequence number
        # collides with the head's: only the flow tells them apart
        _x("cpu_op", "aten::tanh", 2, 150.0, 5.0, **seq2),
        _x("cpu_op", NODE + "_GaussianHeadSampleBackward", 2, 200.0, 20.0,
           **{"Sequence number": 6, "Fwd thread id": 1}),
        _x("cpu_op", "_GaussianHeadSampleBackward", 2, 201.0, 15.0,
           **{"Sequence number": 6, "Fwd thread id": 1}),
        {"ph": "f", "cat": "fwdbwd", "name": "fwdbwd", "id": 12, "pid": 1, "tid": 2,
         "ts": 201.0, "bp": "e"},
        _x("cuda_driver", "cuLaunchKernel", 2, 205.0, 2.0, correlation=3),
        _x("cpu_op", NODE + "_ScanProjLastBackward", 2, 230.0, 20.0,
           **{"Sequence number": 5, "Fwd thread id": 1}),
        _x("cuda_runtime", "cudaLaunchKernelExC", 2, 235.0, 4.0, correlation=4),
        _kernel("rec_fwd_wgmma_kernel", 1, 20.0, 10.0),
        _kernel("head_sample_fwd_kernel", 2, 70.0, 4.0),
        _kernel("head_sample_bwd_kernel", 3, 210.0, 6.0),
        _kernel("rec_bwd_wgmma_kernel", 4, 240.0, 20.0),
        _kernel("multi_tensor_apply_kernel", 5, 310.0, 2.0),
        _kernel("orphan_kernel", 99, 400.0, 1.0),
        {**_kernel("Memset (Device)", 6, 50.0, 1.0), "cat": "gpu_memset"},
        _x("cuda_runtime", "cudaMemsetAsync", 1, 45.0, 1.0, correlation=6),
        {"ph": "X", "cat": "cpu_instant_event", "name": "not work", "pid": 1, "tid": 1,
         "ts": 46.0, "dur": 0.0},
    ]}


def test_reader_on_a_gpu_style_trace():
    b = regions.budget(_gpu_style_trace(), steps=2)
    assert b["timeline"] == "device" and b["items_per_step"] == 3.5
    assert b["unlaunched_per_step"] == 0.5
    rows = {r["region"]: (r["fwd_ms"], r["bwd_ms"]) for r in b["rows"]}
    assert rows == {"model_fwd/enc_lstm": (0.0055, 0.010),
                    "model_fwd/latent_head": (0.002, 0.003),
                    regions.UNATTRIBUTED: (0.0015, 0.0)}
    assert b["total_ms"] == pytest.approx(0.022)
    assert sum(r["ms"] for r in b["rows"]) == pytest.approx(b["total_ms"])
    unattributed = next(r for r in b["rows"] if r["region"] == regions.UNATTRIBUTED)
    assert [n for n, _ in unattributed["top"]] == ["multi_tensor_apply_kernel",
                                                   "orphan_kernel"]
    assert [r["region"] for r in b["rows"]][0] == "model_fwd/enc_lstm"  # by ms
    shallow = regions.budget(_gpu_style_trace(), steps=2, depth=1)["rows"]
    assert {r["region"]: (r["fwd_ms"], r["bwd_ms"]) for r in shallow}["model_fwd"] == (
        pytest.approx(0.0075), pytest.approx(0.013))


def test_reader_cli_prints_the_budget(tmp_path, capsys):
    import json

    (tmp_path / "trace.json").write_text(json.dumps(_gpu_style_trace()))
    regions.main([str(tmp_path), "--steps", "2", "--depth", "1"])
    out = json.loads(capsys.readouterr().out)
    assert out["depth"] == 1 and {r["region"] for r in out["rows"]} == {
        "model_fwd", regions.UNATTRIBUTED}


def _state_tensors(state) -> dict:
    out = {f"param {n}": p.detach() for n, p in state.model.named_parameters()}
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        out.update((f"{k} {names[id(p)]}", v) for k, v in st.items())
    return out


@pytest.mark.parametrize("name", ["seq_vae", "hier_vae"])
def test_a_profiled_step_equals_an_unprofiled_one(name, tmp_path):
    cfg = _tiny(name)
    plain, traced = (setup_resident_training(cfg, torch.device("cpu")) for _ in range(2))
    m_plain = plain[2](plain[0], plain[1])
    with profiling.trace(str(tmp_path)):
        m_traced = traced[2](traced[0], traced[1])
    a, b = _state_tensors(plain[0]), _state_tensors(traced[0])
    assert set(a) == set(b) and len(a) > 10
    for key in a:
        assert torch.equal(a[key], b[key]), key
    for key in m_plain:
        assert torch.equal(m_plain[key], m_traced[key]), key


def test_annotate_opens_no_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: opened.append(name) or torch.profiler.record_function(name))
    with profiling.annotate("enc_lstm"):
        pass
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("enc_lstm"):
            torch.ones(2) + 1
    assert opened == ["enc_lstm"]
    assert "enc_lstm" in {e.name for e in prof.events()}


# --- regions in a captured graph ------------------------------------------------------


class _Numbered(TorchDispatchMode):
    """Numbers the aten ops it sees, forward and backward: a stand-in for
    the nodes of a captured graph, whose frontier is the last op."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))

    def frontier(self):
        return (len(self.ops) - 1,) if self.ops else ()


def _recorded_step(cfg, record: bool = True):
    """(the aten ops of one train step, each op's (region path, pass), the
    recorder, the state after the step) under `record_regions` with the
    numbered ops as the frontier (or with no recorder)."""
    state, data, step = setup_resident_training(cfg, torch.device("cpu"))
    step(state, data)
    mode = _Numbered()
    with (profiling.record_regions(mode.frontier) if record
          else contextlib.nullcontext()) as rec, mode:
        step(state, data)
    places = rec.place(range(len(mode.ops))) if record else None
    return mode.ops, places, rec, state


def _ops_by_row(ops, places) -> dict:
    rows = {}
    for op, (path, where) in zip(ops, places):
        rows.setdefault(("/".join(path) or regions.UNATTRIBUTED, where), Counter())[op] += 1
    return rows


# What stays outside every region (`profiling.PORT_REGIONS`' note): the loss
# arithmetic, its backward and the backward's seed gradient, the gradients'
# hand-over to `.grad` (AccumulateGrad: a detach, or a copy where the layout
# differs), and the host's record of `zero_grad`.
FWD_RESIDUE = {"add", "mul", "div", "detach", "ones_like", "_record_function_enter_new",
               "_record_function_exit"}
BWD_RESIDUE = {"div", "mul", "detach", "new_empty_strided", "copy_"}

CAPTURE_CASES = {"seq_vae": ("seq_vae", SEQ), "hier_vae": ("hier_vae", HIER)}


@pytest.mark.parametrize("case", list(CAPTURE_CASES))
def test_recorded_regions_hold_every_op_of_a_step(case):
    """Configs 3 and 5 (the decoder under remat): the forward's regions open
    and close in the order of the JAX package's, each closed at the step's
    end; each model region and elbo_reduce has backward work, met in the
    reverse order; the optimizer's step is in `optimizer`; only the
    residue is outside every region."""
    name, model_regions = CAPTURE_CASES[case]
    ops, places, rec, _ = _recorded_step(_tiny(name))
    fwd = [path for _, path, where in rec.marks if where == "fwd"]
    opened = [fwd[0]] + [b for a, b in zip(fwd, fwd[1:]) if len(b) > len(a)]
    for a, b in zip(fwd, fwd[1:]):  # one region opened or closed at a time
        assert a == b or b[:-1] == a or a[:-1] == b, (a, b)
    want = ("rows", "preprocess", "model_fwd", *model_regions, "elbo_reduce", "optimizer")
    assert ["/".join(p) for p in opened] == list(want)
    assert fwd[-1] == ()
    met = list(dict.fromkeys("/".join(p) for _, p, where in rec.marks
                             if where == "bwd" and p not in ((), ("model_fwd",))))
    assert met == ["elbo_reduce", *reversed(model_regions)]
    rows = _ops_by_row(ops, places)
    assert rows[("optimizer", "fwd")]["_fused_adam_"] == 1
    assert sum(c["_fused_adam_"] for r, c in rows.items() if r != ("optimizer", "fwd")) == 0
    assert set(rows[(regions.UNATTRIBUTED, "fwd")]) <= FWD_RESIDUE
    assert set(rows[(regions.UNATTRIBUTED, "bwd")]) <= BWD_RESIDUE
    for region in (*model_regions, "elbo_reduce"):
        assert sum(rows[(region, "bwd")].values()) > 0, region
    assert {r for r, _ in rows} <= {*want, "model_fwd", regions.UNATTRIBUTED}


def test_the_decoders_recompute_lands_in_its_backward():
    """Config 3 under remat runs the ops it runs without remat in the same
    rows (less the decoder's saves for the backward), and its recompute's
    ops besides, all in dec_lstm's backward."""
    remat, p_remat, _, _ = _recorded_step(_tiny("seq_vae"))
    plain, p_plain, _, _ = _recorded_step(_tiny("seq_vae", "model.kwargs.remat=false"))
    a, b = _ops_by_row(remat, p_remat), _ops_by_row(plain, p_plain)
    extra = {r: c - b.get(r, Counter()) for r, c in a.items() if c - b.get(r, Counter())}
    assert set(extra) == {("model_fwd/dec_lstm", "bwd")}
    assert extra[("model_fwd/dec_lstm", "bwd")]["convolution"] > 0  # the recomputed taps
    saved = {r: c - a.get(r, Counter()) for r, c in b.items() if c - a.get(r, Counter())}
    assert set(saved) <= {("model_fwd/dec_lstm", "fwd")}
    assert set(saved.get(("model_fwd/dec_lstm", "fwd"), ())) <= {"detach"}


@pytest.mark.parametrize("name", ["seq_vae", "hier_vae"])
def test_region_boundaries_add_no_op(name):
    """The boundaries and the backward's hooks run no op: a step recorded
    runs the ops of a step not recorded, in the same order, and ends in the
    same state bit for bit."""
    ops, _, _, state = _recorded_step(_tiny(name))
    plain_ops, _, _, plain = _recorded_step(_tiny(name), record=False)
    assert ops == plain_ops and len(ops) > 100
    a, b = _state_tensors(state), _state_tensors(plain)
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_a_chunk_that_captures_nothing_has_no_region_map():
    """On the CPU a chunk is the K-step loop: nothing is captured, so
    `chunk.regions()` is None, before a call and after one."""
    state, data, chunk = setup_resident_training(_tiny("seq_vae", "train.steps_per_call=2"),
                                                 torch.device("cpu"))
    assert chunk.regions() is None
    assert chunk(state, data)["loss"].shape == (2,)
    assert chunk.regions() is None


def test_recorder_places_nodes_after_their_last_boundary():
    """A node belongs to the last mark recorded whose frontier lies before
    it; a mark's frontier is its latest node; nodes before every mark are
    outside every region."""
    rec = profiling.RegionRecorder(lambda: None)
    rec.marks = [((), ("a",), "fwd"), ((1,), ("a", "b"), "fwd"), ((1,), ("a",), "fwd"),
                 ((0, 3), ("c",), "bwd"), ((9,), (), "fwd")]
    assert rec.place([0, 1, 2, 3, 4]) == [(("a",), "fwd"), (("a",), "fwd"), (("a",), "fwd"),
                                           (("a",), "fwd"), (("c",), "bwd")]
    rec.marks = [((2,), ("x",), "fwd")]
    assert rec.place([0, 1, 2, 3]) == [((), "fwd")] * 3 + [(("x",), "fwd")]


# A region map of four work nodes (a memcpy among them) and two replays of it
MAP = profiling.GraphRegions(nodes=(
    ("kernel", "fwd_kernel", ("model_fwd", "enc_lstm"), "fwd"),
    ("memcpy", None, ("model_fwd",), "fwd"),
    ("kernel", "bwd_kernel", ("model_fwd", "enc_lstm"), "bwd"),
    ("kernel", "adam_kernel", ("optimizer",), "fwd"),
), chain=True, graph_nodes=5)


def _replays(*replays) -> dict:
    """A GPU-style trace: each replay a `cudaGraphLaunch` and its device
    events [(category, name, ts, dur)] under the launch's correlation."""
    events = []
    for r, work in enumerate(replays):
        events.append(_x("cuda_runtime", "cudaGraphLaunch", 1, 1000.0 * r, 5.0,
                         correlation=100 + r))
        events.append(_x("user_annotation", "chunk.replay", 1, 1000.0 * r - 1, 10.0))
        for cat, name, ts, dur in work:
            events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
                           "ts": 1000.0 * r + ts, "dur": dur,
                           "args": {"correlation": 100 + r}})
    events.append(_kernel("eager_kernel", 7, 5000.0, 3.0))  # not a replay's
    return {"traceEvents": events}


REPLAY = [("kernel", "fwd_kernel", 10.0, 20.0),  # span 10 .. 110
          ("kernel", "memcpy32_post", 34.0, 2.0),  # the graph's memcpy, run as a copy kernel
          ("kernel", "bwd_kernel", 36.0, 40.0),
          ("kernel", "adam_kernel", 90.0, 20.0)]


def test_replay_budget_gives_each_node_the_gap_before_it():
    rows = regions.replay_budget(_replays(REPLAY, REPLAY), MAP, steps=4)
    # a step: (fwd, bwd, of which gaps) ms; two replays of two steps each
    assert rows == {
        "model_fwd/enc_lstm": (pytest.approx(0.020 * 2 / 4), pytest.approx(0.040 * 2 / 4),
                               pytest.approx(0.0)),
        "model_fwd": (pytest.approx(0.006 * 2 / 4), 0.0, pytest.approx(0.004 * 2 / 4)),
        "optimizer": (pytest.approx(0.034 * 2 / 4), 0.0, pytest.approx(0.014 * 2 / 4))}
    span = 0.100 * 2 / 4
    assert sum(f + b for f, b, _ in rows.values()) == pytest.approx(span)
    shallow = regions.replay_budget(_replays(REPLAY, REPLAY), MAP, steps=4, depth=1)
    assert set(shallow) == {"model_fwd", "optimizer"}
    assert sum(f + b for f, b, _ in shallow.values()) == pytest.approx(span)
    # a node that ends inside its predecessor adds no time; overlap is not counted twice
    nested = [REPLAY[0], ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 12.0, 2.0),
              *REPLAY[2:]]
    rows = regions.replay_budget(_replays(nested), MAP, steps=2)
    assert rows["model_fwd"] == (0.0, 0.0, 0.0)
    assert sum(f + b for f, b, _ in rows.values()) == pytest.approx(0.100 / 2)


@pytest.mark.parametrize("fault", ["reordered", "shortened", "renamed", "memset for memcpy",
                                   "a node lost at the end", "branched", "no map", "no replay",
                                   "steps over replays"])
def test_replay_budget_refuses_what_does_not_match(fault, capsys):
    second, regions_map, steps = list(REPLAY), MAP, 6
    if fault == "reordered":
        second[0], second[2] = (*REPLAY[2][:2], *REPLAY[0][2:]), (*REPLAY[0][:2], *REPLAY[2][2:])
    elif fault == "shortened":  # a middle replay: no window cut it
        second = second[:3]
    elif fault == "renamed":
        second[3] = ("kernel", "sgd_kernel", 90.0, 20.0)
    elif fault == "memset for memcpy":
        second[1] = ("gpu_memset", "Memset (Device)", 34.0, 2.0)
    elif fault == "branched":
        regions_map = MAP._replace(chain=False)
    elif fault == "no map":
        regions_map = None
    elif fault == "steps over replays":
        steps = 4
    trace = _replays(REPLAY, second, REPLAY) if fault != "no replay" else _replays()
    if fault == "a node lost at the end":  # the last replay, short of a node not its last
        trace = _replays(REPLAY, REPLAY, REPLAY[:2] + REPLAY[3:])
    assert regions.replay_budget(trace, regions_map, steps=steps) is None
    assert "replay_budget: " in capsys.readouterr().err
    if fault not in ("branched", "no map"):
        assert regions.replay_budget(_replays(REPLAY), MAP, steps=2) is not None


def test_replay_budget_leaves_out_replays_the_window_cut(capsys):
    """The trace's first replay without the map's first nodes and its last
    without the last ones are left out, and the whole replay between them
    is read; a trace with no whole replay gives None."""
    whole = regions.replay_budget(_replays(REPLAY), MAP, steps=2)
    assert capsys.readouterr().err == ""
    rows = regions.replay_budget(_replays(REPLAY[1:], REPLAY, REPLAY[:3]), MAP, steps=6)
    assert rows == whole
    err = capsys.readouterr().err
    assert "replay 0 (3 of 4 nodes)" in err and "replay 2 (3 of 4 nodes)" in err
    assert regions.replay_budget(_replays(REPLAY[2:], REPLAY[:1]), MAP, steps=4) is None
    assert "no replay whole" in capsys.readouterr().err


def test_the_benchmarks_readers_ignore_the_ports_own_spans():
    """The benchmark's frozen reader (`benchmark/trace.py`) and its six
    per-layer metrics read a trace the same with the port's own regions and
    host spans in it (`optimizer`, `rows`, `chunk.replay`) as without them:
    they name only the JAX package's regions."""
    from types import SimpleNamespace

    from benchmark import cells, trace as frozen

    plain = _gpu_style_trace()
    spans = {"traceEvents": plain["traceEvents"] + [
        _x("user_annotation", "chunk.replay", 1, -5.0, 500.0),
        _x("user_annotation", "rows", 1, -4.0, 3.0),
        _x("user_annotation", "optimizer", 1, 299.0, 25.0),
        _x("user_annotation", "grad_sync", 1, 290.0, 5.0)]}
    names = [m["name"] for m in cells.manifest()["per_layer"]]
    assert len(names) == 6

    def read(t):
        dev = frozen.device_events(t)
        ctx = SimpleNamespace(regions=frozen.regions(t, 2), busy_s=frozen.busy_us(dev) / 1e6,
                              window_s=1e-3, steps=2, nccl_s=0.0, world=1,
                              flops_per_step=1e6, recurrence_bound_ms=1e-3)
        return ctx.regions, frozen.device_ops(dev), {n: cells.reader(n)(ctx) for n in names}

    assert read(spans) == read(plain)
    assert read(plain)[2]["region_ms.recurrence"] == pytest.approx(0.0155)
