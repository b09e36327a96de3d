"""Arithmetic the per-layer readers (benchmark/metrics/<name>.py) share.

A reader takes the run's context and returns its number, or None when the
run holds nothing for it to read; the harness then leaves the metric out.

The context: `spans` (the gateway's finished access.put / access.get spans
of the window: op, start, dur, stages as (name, start, dur) on the host's
perf_counter), `codec` (the codec service's counters over the window:
batches, jobs, dispatch_s), `traced_s` (the window from GO until its last
answer), `device` (devtrace.DeviceTrace.stop(), or None) and `records`
(the client's records of the window's requests: op, key, offset, length,
due, sent, done, status, bytes, on time.monotonic(); where the mix loses
disks, each GET's also `want`, the bytes it asks for, and `degraded`,
whether it reads a lost shard: reads_lost_shard).
"""

from __future__ import annotations

import statistics

from benchmark import devtrace
from benchmark.reference import codes


def get_p95_ms(records: list[dict]) -> float | None:
    """95th percentile of every GET of the window, from when it was due to
    its last byte; a failed GET counts as infinite."""
    lat = [(r["done"] - r["due"]) * 1e3 if r["status"] in (200, 206) else float("inf")
           for r in records if r["op"] == "get"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]


def get_mibps(records: list[dict], t0: float, seconds: float) -> float | None:
    """Bytes of every GET answered over the window's time: from its start
    until its last answer, and never less than its seconds (every GET due
    in the window counts, however late its answer)."""
    gets = [r for r in records if r["op"] == "get"]
    if not gets:
        return None
    span = max(seconds, max(r["done"] for r in gets) - t0)
    return sum(r["bytes"] for r in gets) / 2**20 / span


def reads_lost_shard(loc: dict, offset: int, length: int | None,
                     lost: dict[int, set[int]]) -> bool:
    """Whether a GET of `length` bytes at `offset` (the whole object where
    length is None) of the object stored at `loc` (its Location: code mode,
    size, blobs by vid) asks for bytes of a data shard that a lost disk
    held (`lost`: vid -> the volume's unit indices on the lost disks), so
    that the gateway reconstructs them. In each blob the range touches, the
    gateway reads only the data shards its part of the range covers."""
    mode = codes.by_code(loc["code_mode"])
    end = loc["size"] if length is None else offset + length
    pos = 0
    for blob in loc["blobs"]:
        lo, hi = max(offset, pos) - pos, min(end, pos + blob["size"]) - pos
        pos += blob["size"]
        if hi > lo:
            k = mode.shard_size(blob["size"])
            if lost.get(blob["vid"], set()) & set(range(lo // k, (hi - 1) // k + 1)):
                return True
    return False


# a degraded GET's twin: a healthy GET of the same kind (whole or ranged),
# due within TWIN_S of it, asking for a size (whole) or length (ranged)
# within a factor TWIN_SIZE of its own
TWIN_S, TWIN_SIZE = 2.0, 1.5
MIN_TWINS = 120


def twins(records: list[dict]) -> list[tuple[float, float]]:
    """Each degraded GET of the window (`degraded` true, in the order they
    were due) with its twin: of the healthy GETs of its kind due within
    TWIN_S s and asking for a size within a factor TWIN_SIZE (`want`: the
    object's size, or the range's length), the one due nearest in time and
    not yet in a pair. As (degraded, healthy) seconds from due to last
    byte, a failed GET as infinite; a degraded GET with no twin is left
    out."""
    gets = sorted((r for r in records if r["op"] == "get" and r.get("degraded") is not None),
                  key=lambda r: r["due"])
    healthy = [r for r in gets if not r["degraded"]]
    used: set[int] = set()
    pairs = []
    for d in (r for r in gets if r["degraded"]):
        cands = [i for i, h in enumerate(healthy)
                 if i not in used and (h["length"] is None) == (d["length"] is None)
                 and abs(h["due"] - d["due"]) <= TWIN_S
                 and max(h["want"], d["want"]) <= TWIN_SIZE * min(h["want"], d["want"])]
        if cands:
            i = min(cands, key=lambda i: (abs(healthy[i]["due"] - d["due"]), i))
            used.add(i)
            pairs.append(tuple(r["done"] - r["due"] if r["status"] in (200, 206)
                               else float("inf") for r in (d, healthy[i])))
    return pairs


def get_degraded_x(records: list[dict]) -> float | None:
    """What the broken disk costs a read: the median over twins of the
    degraded GET's latency over its healthy twin's; None under MIN_TWINS
    pairs."""
    pairs = twins(records)
    if len(pairs) < MIN_TWINS:
        return None
    return statistics.median(d / h for d, h in pairs)


def twin_p50_ms(records: list[dict], side: int) -> float | None:
    """Median latency of one side of the twins (0 degraded, 1 healthy), in
    ms; None where get_degraded_x is."""
    pairs = twins(records)
    if len(pairs) < MIN_TWINS:
        return None
    return statistics.median(p[side] for p in pairs) * 1e3


def stage_share(ctx: dict, op: str, stages: tuple[str, ...]) -> float | None:
    """Percent of the `op` spans' wall time inside the named stages (each
    span's stage intervals merged, so overlapping stages count once)."""
    spans = [s for s in ctx["spans"] if s["op"] == op]
    wall = sum(s["dur"] for s in spans)
    if not spans or wall <= 0:
        return None
    inside = 0.0
    for s in spans:
        lo, hi = s["start"], s["start"] + s["dur"]
        inside += devtrace.union((max(lo, st), min(hi, st + d))
                                 for name, st, d in s["stages"]
                                 if name in stages and min(hi, st + d) > max(lo, st))
    return 100.0 * inside / wall


def span_share(ctx: dict, op: str, stage: str) -> float | None:
    """Percent of the `op` spans that hold at least one `stage` stage."""
    spans = [s for s in ctx["spans"] if s["op"] == op]
    if not spans:
        return None
    return 100.0 * sum(any(n == stage for n, _, _ in s["stages"]) for s in spans) / len(spans)


def jobs_per_batch(ctx: dict) -> float | None:
    c = ctx["codec"]
    return c["jobs"] / c["batches"] if c["batches"] > 0 else None


def codec_busy_pct(ctx: dict) -> float | None:
    """The codec's one dispatcher thread: seconds inside batches over the
    window's seconds."""
    if ctx["codec"]["batches"] <= 0:
        return None
    return 100.0 * ctx["codec"]["dispatch_s"] / ctx["traced_s"]


def device_idle_pct(ctx: dict) -> float | None:
    dev = ctx["device"]
    if dev is None or dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
