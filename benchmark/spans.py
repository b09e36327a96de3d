"""Arithmetic the readers of the program's own stages share: the codec's
queue wait and batch stages and the read pool's waits, which the program
records inside each `access.get` span (codec/service.py, blobstore/access.py),
and the card's share of the same spans, from the profiler.

A share is percent of the op's span wall inside some stages, each span's
intervals merged and clipped to the span, as layers.stage_share computes it.
A name that ends in "." matches every stage it starts. A share reads nothing
where no span of the op holds the stage it needs: a program that records no
such stage has nothing for it to read.
"""

from __future__ import annotations

import statistics

from benchmark import devtrace


def _matches(name: str, names: tuple[str, ...]) -> bool:
    return any(name == n or (n.endswith(".") and name.startswith(n)) for n in names)


def share(ctx: dict, op: str, names: tuple[str, ...], outside: tuple[str, ...] = (),
          needs: tuple[str, ...] | None = None) -> float | None:
    """Percent of the `op` spans' wall inside the `names` stages and outside
    every `outside` stage; None unless some `op` span holds a `needs` stage
    (by default one of `names`)."""
    spans = [s for s in ctx["spans"] if s["op"] == op]
    wall = sum(s["dur"] for s in spans)
    if wall <= 0 or not any(_matches(n, needs or names) for s in spans
                            for n, _, _ in s["stages"]):
        return None
    inside = 0.0
    for s in spans:
        lo, hi = s["start"], s["start"] + s["dur"]

        def clipped(want):
            return [(max(lo, st), min(hi, st + d)) for n, st, d in s["stages"]
                    if _matches(n, want) and min(hi, st + d) > max(lo, st)]

        kept = clipped(outside)
        inside += devtrace.union(clipped(names) + kept) - devtrace.union(kept)
    return 100.0 * inside / wall


def p95_ms(ctx: dict, op: str) -> float | None:
    """95th percentile of the window's `op` span durations (inclusive
    quantiles, as layers.get_p95_ms takes the client's)."""
    durs = [s["dur"] * 1e3 for s in ctx["spans"] if s["op"] == op]
    if len(durs) < 2:
        return None
    return statistics.quantiles(durs, n=20, method="inclusive")[18]


def device_share(ctx: dict, op: str) -> float | None:
    """Percent of the `op` spans' wall in which the card worked for them:
    the profiler's busy seconds of the window (kernels, copies, memsets),
    counted once for each job of the batch they served, over the spans'
    wall. Every job of a batch waits out its batch's copies and kernel
    inside its span, and one dispatcher runs the batches one at a time, so
    the sum over spans of each span's card time is the busy seconds times
    the jobs a batch (the codec's counters, over the same window). That
    holds where the window's only device work is the codec's batches for
    `op` requests. None without a device trace, busy seconds or batches."""
    dev, codec = ctx["device"], ctx["codec"]
    wall = sum(s["dur"] for s in ctx["spans"] if s["op"] == op)
    if dev is None or dev["busy_s"] <= 0 or codec["batches"] <= 0 or wall <= 0:
        return None
    return 100.0 * dev["busy_s"] * codec["jobs"] / codec["batches"] / wall
