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
whether it reads a lost shard: reads_lost_shard; a range pair's halves
also `pair` and `role`: traffic.range_pairs).
"""

from __future__ import annotations

import math
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


# a degraded GET's healthy baseline: the median latency of up to NEIGHBOURS
# healthy GETs of its kind (whole or ranged), due within NEAR_S of it and
# asking for a size (whole) or length (ranged) within a factor NEAR_SIZE of
# its own, nearest in log size first; the ratio is a trimmed geometric mean
# that drops TRIM_PCT percent of the log ratios at each end. MIN_BASELINED:
# the fewest degraded GETs with a baseline in 12 runs of get_one_disk on an
# H100 (203), less a quarter, rounded down to a multiple of ten.
NEAR_S, NEAR_SIZE, NEIGHBOURS, TRIM_PCT = 2.0, 1.5, 3, 10
MIN_BASELINED = 150


def latency(r: dict) -> float:
    """Seconds from due to last byte; a failed GET as infinite."""
    return r["done"] - r["due"] if r["status"] in (200, 206) else math.inf


def baselined(records: list[dict]) -> list[tuple[float, float]]:
    """Each degraded GET of the window (`degraded` true, in the order they
    were due), answered or failed, with its healthy baseline: the median
    latency of up to NEIGHBOURS healthy GETs of its kind due within NEAR_S
    s and asking for a size within a factor NEAR_SIZE (`want`: the object's
    size, or the range's length), taken nearest in log size first, then
    nearest in time; a healthy GET may serve several degraded ones. As
    (degraded, baseline) seconds; a degraded GET with no healthy neighbour
    is left out."""
    gets = sorted((r for r in records if r["op"] == "get" and r.get("degraded") is not None),
                  key=lambda r: r["due"])
    healthy = [r for r in gets if not r["degraded"]]
    out = []
    for d in (r for r in gets if r["degraded"]):
        near = [h for h in healthy
                if (h["length"] is None) == (d["length"] is None)
                and abs(h["due"] - d["due"]) <= NEAR_S
                and max(h["want"], d["want"]) <= NEAR_SIZE * min(h["want"], d["want"])]
        near.sort(key=lambda h: (abs(math.log(h["want"] / d["want"])), abs(h["due"] - d["due"])))
        if near:
            out.append((latency(d), statistics.median(latency(h) for h in near[:NEIGHBOURS])))
    return out


def trimmed_geomean(ratios: list[float]) -> float:
    """exp of the mean of the log ratios left after dropping TRIM_PCT
    percent (rounded down) at each end; an infinite ratio (a failed
    degraded GET) sorts into the top tail, so past that share it reads
    inf."""
    logs = sorted(math.log(x) if x > 0 else -math.inf for x in ratios)
    k = len(logs) * TRIM_PCT // 100
    kept = logs[k:len(logs) - k]
    if kept[-1] == math.inf:
        return math.inf
    return math.exp(statistics.fmean(kept))


def lost_disk_ratio(records: list[dict]) -> tuple[float | None, int]:
    """The trimmed geometric mean over degraded GETs of their latency over
    their healthy baseline (a failed degraded GET as an infinite ratio),
    and the number of degraded GETs with a baseline; None where none has
    one."""
    pairs = baselined(records)
    if not pairs:
        return None, 0
    return trimmed_geomean([math.inf if d == math.inf else d / b for d, b in pairs]), len(pairs)


def get_degraded_x(records: list[dict]) -> float | None:
    """What the broken disk costs a read: lost_disk_ratio, None under
    MIN_BASELINED degraded GETs with a baseline."""
    x, n = lost_disk_ratio(records)
    return x if n >= MIN_BASELINED else None


def baselined_p50_ms(records: list[dict], side: int) -> float | None:
    """Median of one side of get_degraded_x's pairs (0 the degraded GETs,
    1 their baselines), in ms; None where get_degraded_x is."""
    pairs = baselined(records)
    if len(pairs) < MIN_BASELINED:
        return None
    return statistics.median(p[side] for p in pairs) * 1e3


# Range pairs (traffic.range_pairs): each pair's degraded and healthy halves
# read the same blob, length and in-shard offset, due at the same instant,
# so the host's moment, the bytes and the blob cancel out of a pair's
# ratio, and what is left is the degraded path (the failed direct read, the
# windowed survivor gather, which also reads the healthy half's shard, the
# codec's queue, dispatch and decode). MIN_PAIRS: the
# fewest pairs in the 12 runs of the cell's two sets on an H100 (510, every
# pair of a 51 s window at 10 a second), less a quarter, rounded down to a
# multiple of ten.
MIN_PAIRS = 380


def pair_latencies(records: list[dict]) -> list[tuple[float, float]]:
    """(degraded, healthy) seconds, due to last byte, of each range pair of
    the window with both halves recorded, by pair; a failed half as
    infinite."""
    halves: dict[int, dict[str, float]] = {}
    for r in records:
        if r["op"] == "get" and r.get("pair") is not None:
            halves.setdefault(r["pair"], {})[r["role"]] = latency(r)
    return [(h["degraded"], h["healthy"]) for _, h in sorted(halves.items()) if len(h) == 2]


def get_range_lost_x(records: list[dict]) -> float | None:
    """R: the trimmed geometric mean over range pairs of degraded over
    healthy latency (a failed degraded half as an infinite ratio, a failed
    healthy half beside an answered degraded one as 0); None under
    MIN_PAIRS."""
    pairs = pair_latencies(records)
    if len(pairs) < MIN_PAIRS:
        return None
    return trimmed_geomean([math.inf if d == math.inf else d / h for d, h in pairs])


def range_p50_ms(records: list[dict], side: int) -> float | None:
    """Median of one side of the range pairs (0 the degraded halves, 1 the
    healthy ones), in ms; None under MIN_PAIRS."""
    pairs = pair_latencies(records)
    if len(pairs) < MIN_PAIRS:
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
