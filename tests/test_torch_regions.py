"""mmvae_torch's named regions and the per-region step budget
(`mmvae_torch.bench.regions`), on the CPU at tiny widths.

The port opens the JAX package's `jax.named_scope` regions, under the same
names and at the counterpart sites (read from the `mmvae_tpu` sources); a
traced CPU train step puts every operator, the backward's and the decoder
remat's recompute included, in its region; the reader attributes a
hand-built GPU-style trace's kernels by their launches; a profiled step
equals an unprofiled one bit for bit; `annotate` opens no range without a
profiler.
"""

import re
from pathlib import Path

import pytest
import torch

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
    want = _names(REPO / "mmvae_tpu" / jax_file, _JAX)
    assert want, f"{jax_file} names no scope"
    assert _names(REPO / "mmvae_torch" / port_file, _PORT) == want


def test_no_other_region_is_opened():
    """Only the counterpart sites open regions (pred_vae, conv_vae and
    mlp_vae name none in the JAX package), and the reader's names are the
    JAX package's."""
    jax_files = {p.relative_to(REPO / "mmvae_tpu").as_posix()
                 for p in (REPO / "mmvae_tpu").rglob("*.py")
                 if re.search(_JAX, p.read_text())}
    port_files = {p.relative_to(REPO / "mmvae_torch").as_posix()
                  for p in (REPO / "mmvae_torch").rglob("*.py")
                  if re.search(_PORT, p.read_text())}
    assert jax_files == port_files == {j for j, _ in SITES}
    every = {n for j, _ in SITES for n in _names(REPO / "mmvae_tpu" / j, _JAX)}
    assert set(regions.REGIONS) == every


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
    for region in ("preprocess", *model_regions, "elbo_reduce"):
        assert rows[region]["fwd_ms"] > 0, region
    # every region with parameters, or with a differentiable input, has a backward
    for region in (*model_regions, "elbo_reduce"):
        assert rows[region]["bwd_ms"] > 0, region
    assert rows["preprocess"]["bwd_ms"] == 0  # u8 in: nothing to differentiate
    assert set(rows) <= {"preprocess", "model_fwd", *model_regions, "elbo_reduce",
                         regions.UNATTRIBUTED}
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
    assert shallow == {"preprocess", "model_fwd", "elbo_reduce", regions.UNATTRIBUTED}


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
