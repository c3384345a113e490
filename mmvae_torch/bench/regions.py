"""Per-region budget of a train step from a Chrome trace (the port of
scripts/profile_step.py).

    python -m mmvae_torch.bench.regions TRACE [--steps 20] [--depth 2]

TRACE is a trace file, or a directory whose newest `*.json` is read: the
format `utils.profiling.trace` writes (`torch.profiler`'s
`export_chrome_trace`), which `python -m mmvae_torch bench --profile DIR`
leaves.  Prints one JSON object: for each region path (`model_fwd/frame_enc`,
cut to `depth` names as the JAX script's scope depth), the time a step of
the work inside it, forward and backward apart, and its share of the
window's total; work outside every region goes to the row `?`.  Each row
names its three largest kernels.  Every item of work lands in exactly one row, so the
rows sum to the total.

The work is the card's kernels, memsets and copies where the trace holds
any (`timeline` "device": their ms, summed, not their union) and otherwise
the host's leaf operators (`timeline` "host": a CPU trace, host ms, no
device metric).

Attribution.  A region is a `utils.profiling.annotate` range whose name is
one of `REGIONS`, the JAX package's `jax.named_scope` names.  A kernel
(or memset or copy) belongs to the host event that launched it (the
runtime or driver call with its `correlation`); a host event's region is the path of the
region ranges that enclose it on its thread.  A host event inside an
autograd node (`autograd::engine::evaluate_function: ...`, innermost) is
backward work: the node is followed to the forward operator that made it
(the trace's `fwdbwd` flow, or else its `Sequence number`), and the work
goes to that operator's region as backward.  So a custom
`torch.autograd.Function`'s backward lands in the region of its `apply`,
and a non-reentrant checkpoint's recompute, which runs inside the backward
of a node of the checkpointed region (the decoder's remat), lands in that
region's backward, as JAX's remat does under the scope's transpose.

A graph replay (`train.steps_per_call` = K > 1) runs no host code, so no
range opens in it; `replay_budget` reads the replays instead, by the
region map the capture recorded (`chunk.regions()`, see
`utils.profiling`): each replay's device work, taken by the correlation of
its `cudaGraphLaunch` and ordered by start, is matched to the map's work
nodes by position, kind and kernel name.  Inside a replay the idle gap
before a node goes to the node's region, so the rows (regions and `?`)
sum to the replays' span; every time is the device trace's own.  A count,
kind or name that differs, a graph that is not one chain of nodes (the
data-parallel graph branches into NCCL's stream) or no map gives None and
the reason on stderr; a first or last replay that the trace's window cut
is left out.  `budget` stays the reader of eager steps and of CPU
traces.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os
import sys
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from mmvae_torch.utils.profiling import PORT_REGIONS

# The JAX package's region names (its `jax.named_scope`s in train/loop.py,
# models/seq_vae.py and models/hier_vae.py), which the port opens with
# `utils.profiling.annotate` at the counterpart sites, then the port's own.
JAX_REGIONS = ("preprocess", "model_fwd", "elbo_reduce", "frame_enc", "enc_lstm",
               "latent_head", "z_init", "dec_lstm", "frame_dec", "chunk_lstm")
REGIONS = JAX_REGIONS + PORT_REGIONS
UNATTRIBUTED = "?"
_TOP = 3  # kernels named a row

_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
_NODE = "autograd::engine::evaluate_function: "


def load_trace(path: str) -> dict:
    """The trace at `path`, or the newest `*.json` / `*.json.gz` under it."""
    if os.path.isdir(path):
        found = [p for pat in ("*.json", "*.json.gz")
                 for p in glob.glob(os.path.join(path, "**", pat), recursive=True)]
        if not found:
            raise FileNotFoundError(f"no trace (*.json) under {path}")
        path = max(found, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


class _Trace:
    """The host events by thread, each with its enclosing event; the fwdbwd
    flows; the launches by correlation."""

    def __init__(self, trace: dict):
        events = trace.get("traceEvents", [])
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in _HOST_CATS]
        self.device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        by_thread = defaultdict(list)
        for e in host:
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
        self.host: List[dict] = []
        self.parent: List[Optional[int]] = []
        self.starts: Dict[tuple, Tuple[list, list]] = {}  # thread -> (ts, index) sorted
        for thread, evs in by_thread.items():
            evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
            stack: List[int] = []
            for e in evs:
                while stack and self._end(self.host[stack[-1]]) <= e["ts"]:
                    stack.pop()
                self.parent.append(stack[-1] if stack else None)
                self.host.append(e)
                stack.append(len(self.host) - 1)
            first = len(self.host) - len(evs)
            self.starts[thread] = ([e["ts"] for e in evs], list(range(first, len(self.host))))
        self.launch = {e["args"]["correlation"]: i for i, e in enumerate(self.host)
                       if e["cat"] in _LAUNCH_CATS and "correlation" in (e.get("args") or {})}
        self.flow_s, self.flow_f = {}, defaultdict(list)
        for e in events:
            if e.get("cat") == "fwdbwd" and e.get("ph") in ("s", "f"):
                key = (e.get("pid"), e.get("tid"))
                if e["ph"] == "s":
                    self.flow_s[e["id"]] = (key, e["ts"])
                else:
                    self.flow_f[key].append((e["ts"], e["id"]))
        for v in self.flow_f.values():
            v.sort()
        self.by_seq = defaultdict(list)  # forward operators by sequence number
        for i, e in enumerate(self.host):
            args = e.get("args") or {}
            if e["cat"] == "cpu_op" and "Sequence number" in args \
                    and not args.get("Fwd thread id") and not e["name"].startswith(_NODE):
                self.by_seq[args["Sequence number"]].append((e["ts"], i))
        self._places: Dict[int, Tuple[tuple, str]] = {}

    @staticmethod
    def _end(e: dict) -> float:
        return e["ts"] + e.get("dur", 0)

    def _thread(self, i: int) -> tuple:
        e = self.host[i]
        return (e.get("pid"), e.get("tid"))

    def _at(self, thread: tuple, ts: float) -> Optional[int]:
        """The outermost host event that starts at `ts` on `thread`."""
        tss, idx = self.starts.get(thread, ([], []))
        k = bisect.bisect_left(tss, ts)
        return idx[k] if k < len(tss) and tss[k] == ts else None

    def forward_of(self, node: int) -> Optional[int]:
        """The forward operator whose autograd node is the host event `node`."""
        e = self.host[node]
        flows = self.flow_f.get(self._thread(node), [])
        k = bisect.bisect_left(flows, (e["ts"],))
        if k < len(flows) and flows[k][0] <= self._end(e) and flows[k][1] in self.flow_s:
            thread, ts = self.flow_s[flows[k][1]]
            fwd = self._at(thread, ts)
            if fwd is not None:
                return fwd
        seq = (e.get("args") or {}).get("Sequence number")
        earlier = [i for ts, i in self.by_seq.get(seq, ()) if ts <= e["ts"]]
        return earlier[-1] if earlier else None

    def place(self, i: int) -> Tuple[tuple, str]:
        """(region path, "fwd" or "bwd") of the host event `i`."""
        if i in self._places:
            return self._places[i]
        path, j, where = [], i, None
        while j is not None:
            e = self.host[j]
            if e["cat"] == "user_annotation" and e["name"] in REGIONS:
                path.append(e["name"])
            elif e["cat"] == "cpu_op" and e["name"].startswith(_NODE):
                fwd = self.forward_of(j)
                where = ((self.place(fwd)[0] if fwd is not None else ()), "bwd")
                break
            j = self.parent[j]
        if where is None:
            where = (tuple(reversed(path)), "fwd")
        self._places[i] = where
        return where


def attribute(trace: dict) -> Tuple[str, List[Tuple[dict, tuple, str]]]:
    """(timeline, [(work event, region path, "fwd" or "bwd")]): the kernels,
    memsets and copies ("device") where the trace holds any, else the
    host's leaf operators ("host").  Device work whose launch is not in the
    trace gets the path None (the row `?`)."""
    t = _Trace(trace)
    if t.device:
        out = []
        for k in t.device:
            i = t.launch.get((k.get("args") or {}).get("correlation"))
            out.append((k, *(t.place(i) if i is not None else (None, "fwd"))))
        return "device", out
    inner = {p for i, p in enumerate(t.parent)
             if p is not None and t.host[i]["cat"] == "cpu_op"}
    return "host", [(e, *t.place(i)) for i, e in enumerate(t.host)
                    if e["cat"] == "cpu_op" and i not in inner]


def budget(trace: dict, steps: int, depth: int = 2) -> dict:
    """The per-region budget of a trace of `steps` steps (see the module
    docstring): ms a step by region path cut to `depth` names, forward and
    backward apart, each row's share of the total and its largest kernels."""
    return tally(*attribute(trace), steps, depth)


def tally(timeline: str, work, steps: int, depth: int = 2) -> dict:
    """`budget` of `attribute`'s result."""
    fwd, bwd, names = defaultdict(float), defaultdict(float), defaultdict(lambda: defaultdict(float))
    for e, path, where in work:
        row = "/".join((path or ())[:depth]) or UNATTRIBUTED
        ms = e.get("dur", 0) / 1e3 / steps
        (fwd if where == "fwd" else bwd)[row] += ms
        names[row][e["name"]] += ms
    total = sum(fwd.values()) + sum(bwd.values())
    rows = []
    for row in set(fwd) | set(bwd):
        ms = fwd[row] + bwd[row]
        ranked = sorted(names[row].items(), key=lambda kv: -kv[1])[:_TOP]
        rows.append({"region": row, "fwd_ms": fwd[row], "bwd_ms": bwd[row], "ms": ms,
                     "share": ms / total if total else 0.0,
                     "top": [[n[:90], v] for n, v in ranked]})
    rows.sort(key=lambda r: -r["ms"])
    return {"timeline": timeline, "steps": steps, "depth": depth,
            "items_per_step": len(work) / steps,
            "unlaunched_per_step": sum(path is None for _, path, _ in work) / steps,
            "total_ms": total, "rows": rows}


_CATEGORY = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


def _same_work(e: dict, kind: str, name: Optional[str]) -> bool:
    """Whether the device event `e` is the work node (`kind`, `name`): a
    kernel by its name; a graph's memcpy or memset as such, or as the copy
    kernel CUDA runs for it (`memcpy32_post` and the like)."""
    if kind == "kernel":
        return e["cat"] == "kernel" and e["name"] == name
    return _CATEGORY[e["cat"]] == kind or (e["cat"] == "kernel" and e["name"].startswith(kind))


def _refuse(reason: str) -> None:
    print(f"replay_budget: {reason}", file=sys.stderr)
    return None


def _matches(work: List[dict], nodes) -> bool:
    return all(_same_work(e, *n[:2]) for e, n in zip(work, nodes))


def replay_budget(trace: dict, regions_map, steps: int,
                  depth: int = 2) -> Optional[Dict[str, Tuple[float, float, float]]]:
    """{region path cut to `depth` names: (forward ms, backward ms, of which
    idle gap ms)} a step of the graph replays in `trace` (`steps` steps in
    all, as many a replay), by `regions_map` (`utils.profiling.GraphRegions`,
    the chunk's `regions`); None, with the reason on stderr, where a replay
    does not match it (see the module docstring).

    The profiler keeps a device record only inside its window, so the
    trace's first replay can lack the map's first nodes and its last replay
    the map's last ones: such a replay, whose events are the rest of the
    map's in order, is left out (said on stderr), and the others are read."""
    if regions_map is None:
        return _refuse("no region map (the chunk has not captured a graph)")
    if not regions_map.chain:
        return _refuse("the graph is not one chain of nodes (it branches, as into NCCL's "
                       "stream): its work has no one order to match")
    events = trace.get("traceEvents", [])
    launches = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in _LAUNCH_CATS
                       and e.get("name", "").startswith("cudaGraphLaunch")),
                      key=lambda e: e["ts"])
    if not launches:
        return _refuse("no cudaGraphLaunch in the trace")
    if steps % len(launches):
        return _refuse(f"{steps} steps do not divide over {len(launches)} replays")
    by_corr = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            by_corr[(e.get("args") or {}).get("correlation")].append(e)
    nodes = regions_map.nodes
    read, cut = [], []
    for r, launch in enumerate(launches):
        work = sorted(by_corr.get((launch.get("args") or {}).get("correlation"), ()),
                      key=lambda e: e["ts"])
        if len(work) == len(nodes) and _matches(work, nodes):
            read.append(work)
        elif 0 < len(work) < len(nodes) and (
                (r == 0 and _matches(work, nodes[len(nodes) - len(work):]))
                or (r == len(launches) - 1 and _matches(work, nodes))):
            cut.append(f"replay {r} ({len(work)} of {len(nodes)} nodes)")
        else:
            same = next((i for i, (e, n) in enumerate(zip(work, nodes))
                         if not _same_work(e, *n[:2])), min(len(work), len(nodes)))
            return _refuse(f"replay {r} of {len(launches)}: {len(work)} device events, the "
                           f"map has {len(nodes)} work nodes, the first {same} match")
    if not read:
        return _refuse(f"no replay whole in the trace: {', '.join(cut)}")
    if cut:
        print(f"replay_budget: left out, cut by the trace's window: {', '.join(cut)}",
              file=sys.stderr)
    per_step = 1e3 * (steps // len(launches)) * len(read)  # us to ms, over the steps read
    fwd, bwd, gap = defaultdict(float), defaultdict(float), defaultdict(float)
    for work in read:
        prev_end = None
        for e, (_, _, path, where) in zip(work, nodes):
            start, end = e["ts"], e["ts"] + e.get("dur", 0)
            idle = 0.0 if prev_end is None else max(0.0, start - prev_end)
            us = end - start if prev_end is None else max(end, prev_end) - prev_end
            prev_end = end if prev_end is None else max(end, prev_end)
            row = "/".join(path[:depth]) or UNATTRIBUTED
            (fwd if where == "fwd" else bwd)[row] += us / per_step
            gap[row] += idle / per_step
    return {row: (fwd[row], bwd[row], gap[row]) for row in set(fwd) | set(bwd)}


def profile_regions(fn, calls: int, steps: int, depth: int = 2) -> dict:
    """`calls` calls of `fn` (`steps` train steps in all) traced by
    `utils.profiling.trace` (CPU activity, and the card's where there is
    one) into a scratch directory, and their `budget`."""
    from mmvae_torch.utils.profiling import trace

    with tempfile.TemporaryDirectory(prefix="mmvae_regions_") as d:
        with trace(d) as prof:
            for _ in range(calls):
                fn()
        return budget(load_trace(prof.trace_path), steps, depth)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="a trace file, or a directory holding one")
    ap.add_argument("--steps", type=int, default=20,
                    help="steps the trace covers (bench --profile traces 20)")
    ap.add_argument("--depth", type=int, default=2, help="region path depth")
    args = ap.parse_args(argv)
    print(json.dumps(budget(load_trace(args.trace), args.steps, args.depth)))


if __name__ == "__main__":
    main()
