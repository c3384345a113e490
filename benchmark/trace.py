"""Reading a `torch.profiler` Chrome trace: the device's busy time, its
idle gaps, the kernels that took most time, and each kernel's region.

Busy time is the union of the intervals in which a kernel, memset or copy
ran on the device.  A region is a `record_function` range the program
opens under one of the names `regions` is given: `REGIONS` (the
`utils.profiling.annotate` sites of configs 3 and 5), and those a
configuration's file lists under "regions" (`harness.region_names`); a
kernel belongs to the host event that launched it (matched by the trace's
`correlation`), and a host event's region is the path of the region ranges
around it on its thread.  A host event inside an autograd node is backward
work: the node is followed to the forward operator that made it (the
`fwdbwd` flow, or else its sequence number) and the work goes to that
operator's region as backward; so a custom Function's backward and a
checkpoint's recompute land in the region of the forward.  A frozen copy
of the attribution of `mmvae_torch/bench/regions.py` as of this benchmark.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

REGIONS = ("preprocess", "model_fwd", "elbo_reduce", "frame_enc", "enc_lstm",
           "latent_head", "z_init", "dec_lstm", "frame_dec", "chunk_lstm")
UNATTRIBUTED = "?"

_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
_NODE = "autograd::engine::evaluate_function: "


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def device_events(trace: dict) -> List[dict]:
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(events: List[dict]) -> float:
    return union_us((e["ts"], e["ts"] + e.get("dur", 0)) for e in events)


def device_ops(events: List[dict], top: int = 10) -> List[list]:
    """[[kernel name, seconds]] of the `top` kernels by total device time."""
    by = defaultdict(float)
    for e in events:
        by[e["name"][:120]] += e.get("dur", 0) / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: dict, events: List[dict], top: int = 10) -> List[list]:
    """[[what the host ran at the gap's start, seconds]] of the `top` longest
    gaps between device work, named by the innermost host event running
    then ("host: none" where none ran)."""
    spans = _merged((e["ts"], e["ts"] + e.get("dur", 0)) for e in events)
    gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1]) for i in range(len(spans) - 1)),
                  reverse=True)[:top]
    host = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                   for e in trace.get("traceEvents", [])
                   if e.get("ph") == "X" and e.get("cat") in _HOST_CATS), key=lambda h: h[0])
    starts = [h[0] for h in host]
    out = []
    for length, at in gaps:
        name, best = "host: none", None
        for s, e, n in host[:bisect.bisect_right(starts, at)][-2000:]:
            if s <= at < e and (best is None or s >= best):
                name, best = n[:120], s
        out.append([name, length / 1e6])
    return out


class _Trace:
    """The host events by thread with their enclosing event, the fwdbwd
    flows and the launches by correlation."""

    def __init__(self, trace: dict, names: Iterable[str] = REGIONS):
        self.names = frozenset(names)
        events = trace.get("traceEvents", [])
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in _HOST_CATS]
        self.device = device_events(trace)
        by_thread = defaultdict(list)
        for e in host:
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
        self.host: List[dict] = []
        self.parent: List[Optional[int]] = []
        self.starts: Dict[tuple, Tuple[list, list]] = {}
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
        self.by_seq = defaultdict(list)
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
        tss, idx = self.starts.get(thread, ([], []))
        k = bisect.bisect_left(tss, ts)
        return idx[k] if k < len(tss) and tss[k] == ts else None

    def forward_of(self, node: int) -> Optional[int]:
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
        """(region path, "fwd" or "bwd") of host event `i`."""
        if i in self._places:
            return self._places[i]
        path, j, where = [], i, None
        while j is not None:
            e = self.host[j]
            if e["cat"] == "user_annotation" and e["name"] in self.names:
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


def regions(trace: dict, steps: int, depth: int = 2,
            names: Iterable[str] = REGIONS) -> Dict[str, Tuple[float, float]]:
    """{region path cut to `depth` names: (forward ms, backward ms) a step}
    of the device work in `trace`, a region being a range named in
    `names`; work outside every region (or whose launch the trace lacks)
    goes to `?`."""
    t = _Trace(trace, names)
    fwd, bwd = defaultdict(float), defaultdict(float)
    for k in t.device:
        i = t.launch.get((k.get("args") or {}).get("correlation"))
        path, where = t.place(i) if i is not None else (None, "fwd")
        row = "/".join((path or ())[:depth]) or UNATTRIBUTED
        (fwd if where == "fwd" else bwd)[row] += k.get("dur", 0) / 1e3 / steps
    return {row: (fwd[row], bwd[row]) for row in set(fwd) | set(bwd)}
