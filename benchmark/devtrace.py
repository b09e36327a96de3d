"""The device's side of a traced run, from torch.profiler (CUPTI).

The profiler runs over the whole window; a `bench.window` annotation on the
host marks the window's start and end on the trace's clock. Every CUDA
kernel, memcpy and memset inside it is device activity: their union is the
time the card was busy, the rest is idle. Each idle gap is named by the
gateway stage the host was in at its midpoint.
"""

from __future__ import annotations

import collections
import json
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "bench.window"


def union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


class DeviceTrace:
    def __init__(self, path: str):
        self.path = path

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def go(self) -> float:
        """Open the window's mark; returns the host's perf_counter there."""
        import torch

        self.mark = torch.profiler.record_function(MARK)
        self.mark.__enter__()
        self.t_go = time.perf_counter()
        return self.t_go

    def stop(self) -> dict:
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        mark = next(e for e in events if e.get("name") == MARK and e.get("ph") == "X"
                    and not str(e.get("cat", "")).startswith("gpu_"))
        lo, hi = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
        dev = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            s, t = max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e.get("dur", 0)))
            if t > s:
                dev.append((s, t, e["name"], e["cat"]))
        ops: dict = collections.defaultdict(float)
        for s, t, name, _ in dev:
            ops[name] += (t - s) / 1e6
        merged = []
        for s, t, _, _ in sorted(dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        edges = [lo] + [x for m in merged for x in m] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        to_host = lambda us: self.t_go + (us - lo) / 1e6  # noqa: E731
        return {
            "window_s": (hi - lo) / 1e6,
            "busy_s": union((s, t) for s, t, _, _ in dev) / 1e6,
            "ops": dict(ops),
            "gaps": [(to_host(s), to_host(t)) for s, t in gaps],
        }


def stage_at(spans: list[dict], t: float) -> str:
    """What the gateway was doing at host time t: the stage most spans were
    in, else the operation in flight, else nothing."""
    stages: collections.Counter = collections.Counter()
    ops: collections.Counter = collections.Counter()
    for sp in spans:
        if not sp["start"] <= t < sp["start"] + sp["dur"]:
            continue
        ops[sp["op"]] += 1
        for name, s, d in sp["stages"]:
            if s <= t < s + d:
                stages[f"{sp['op']}.{name}"] += 1
    if stages:
        return stages.most_common(1)[0][0]
    if ops:
        return f"{ops.most_common(1)[0][0]} (between stages)"
    return "no request in flight"


def breakdown(dev: dict, spans: list[dict]) -> dict:
    ops = sorted(dev["ops"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(dev["gaps"], key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[name, s] for name, s in ops],
            "idle_gaps": [[stage_at(spans, (s + t) / 2), t - s] for s, t in gaps]}
