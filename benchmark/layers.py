"""Arithmetic the per-layer readers (benchmark/metrics/<name>.py) share.

A reader takes the run's context and returns its number, or None when the
run holds nothing for it to read; the harness then leaves the metric out.

The context: `spans` (the gateway's finished access.put / access.get spans
of the window: op, start, dur, stages as (name, start, dur) on the host's
perf_counter), `codec` (the codec service's counters over the window:
batches, jobs, dispatch_s), `traced_s` (the window from GO until its last
answer), `device` (devtrace.DeviceTrace.stop(), or None) and `records`
(the client's records of the window's requests: op, due, sent, done,
status, bytes, on time.monotonic()) and `loss` (a mix that loses its
disks inside the window: `split`, the monotonic time between its halves,
and `start` and `end`, when the loss began and ended; else None).
"""

from __future__ import annotations

import statistics

from benchmark import devtrace


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


# a pair is dropped where either GET was due from GUARD_BEFORE_S before the
# loss began until GUARD_AFTER_S after it ended: those GETs wait out the
# loss's own pause and the first decode of each shape after it
GUARD_BEFORE_S, GUARD_AFTER_S = 0.5, 2.0
MIN_PAIRS = 200


def loss_pairs(records: list[dict], loss: dict) -> tuple[list[tuple[float, float]], int]:
    """Each object's whole GET in the window's first half and its whole GET
    in the second (a halved stream reads each object whole once a half), as
    (before, after) seconds from due to last byte, a failed GET as
    infinite; and how many such pairs the loss's guard dropped."""
    halves: tuple[dict, dict] = ({}, {})
    for r in records:
        if r["op"] == "get" and r["length"] is None:
            halves[r["due"] >= loss["split"]][r["key"]] = r
    lo, hi = loss["start"] - GUARD_BEFORE_S, loss["end"] + GUARD_AFTER_S
    pairs, dropped = [], 0
    for key in sorted(halves[0].keys() & halves[1].keys()):
        pair = (halves[0][key], halves[1][key])
        if any(lo <= r["due"] <= hi for r in pair):
            dropped += 1
            continue
        pairs.append(tuple(r["done"] - r["due"] if r["status"] == 200 else float("inf")
                           for r in pair))
    return pairs, dropped


def get_loss_x(records: list[dict], loss: dict | None) -> float | None:
    """What a lost disk costs a whole-object read: the median over objects
    of its latency after the loss over its latency before it, the guard's
    pairs left out; None under MIN_PAIRS pairs."""
    pairs = loss_pairs(records, loss)[0] if loss else []
    if len(pairs) < MIN_PAIRS:
        return None
    return statistics.median(after / before for before, after in pairs)


def loss_p50_ms(ctx: dict, half: int) -> float | None:
    """Median of the paired whole-object GETs of one half (0 before the
    loss, 1 after it), in ms."""
    pairs = loss_pairs(ctx["records"], ctx["loss"])[0] if ctx.get("loss") else []
    if not pairs:
        return None
    return statistics.median(p[half] for p in pairs) * 1e3


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
