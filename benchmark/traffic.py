"""The one traffic generator: turns a mix file's parameters and a seed into
the requests of a run.

A mix (`benchmark/mixes/<name>.json`) names a preload, the disks a run
loses (and the AZ it loses whole, under `lose_az`), the task switches it
turns off and the streams of its window: open-loop PUTs, GETs, or range
pairs (range_pairs: built after the loss, from the stored layout). Every
seed gets the same set of work in another order: sizes, arrival gaps and
ranges are fixed quantiles of the mix's distributions, and the seed only
permutes them, picks the keys and makes the bytes. So two seeds differ in
order and content, not in how much work a run holds.

Imports numpy and the standard library only: the client process uses it.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# request streams: the preload's objects, the window's requests, the
# warm-up requests before the window
PRELOAD, WINDOW, WARM = 1, 2, 3


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "mixes", f"{name}.json")) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64([seed % (1 << 64), *tags]))


def payload(seed: int, stream: int, idx: int, size: int) -> np.ndarray:
    """The bytes of object `idx` of a payload stream, uint8, from the seed."""
    words = _rng(seed, 100 + stream, idx).bit_generator.random_raw(-(-size // 8))
    return words.view(np.uint8)[:size]


def quantiles(dist: dict, n: int) -> np.ndarray:
    """n midpoint quantiles of a distribution, ascending (float)."""
    q = (np.arange(n) + 0.5) / n
    if dist["dist"] == "log_uniform":
        lo, hi = math.log(dist["min"]), math.log(dist["max"])
        return np.exp(lo + (hi - lo) * q)
    if dist["dist"] == "uniform":
        return dist["min"] + (dist["max"] - dist["min"]) * q
    if dist["dist"] == "exponential":
        return -np.log1p(-q) * dist["mean"]
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def sizes(dist: dict, n: int, seed: int, stream: int) -> list[int]:
    """n object sizes: the distribution's quantiles in the seed's order."""
    s = np.maximum(1, np.round(quantiles(dist, n))).astype(np.int64)
    return [int(v) for v in _rng(seed, stream, 0).permutation(s)]


@dataclass(frozen=True)
class Put:
    due_s: float  # from the window's start
    idx: int
    size: int


def arrivals(rate_per_s: float, seed: int, seconds: float, tag: int) -> list[float]:
    """Open-loop due times from the window's start: rate x seconds arrivals
    whose gaps are the quantiles of a Poisson process's exponential gaps, in
    the seed's order, scaled to span the window exactly (the first at 0)."""
    n = max(1, round(rate_per_s * seconds))
    gaps = _rng(seed, WINDOW, tag).permutation(
        quantiles({"dist": "exponential", "mean": 1.0}, n))
    gaps *= seconds / gaps.sum()
    return [float(d) for d in np.concatenate([[0.0], np.cumsum(gaps)[:-1]])]


def put_schedule(stream: dict, seed: int, seconds: float) -> list[Put]:
    """Open-loop PUTs at the stream's rate, sizes in the seed's order."""
    due = arrivals(stream["rate_per_s"], seed, seconds, 1)
    return [Put(d, i, s)
            for i, (d, s) in enumerate(zip(due, sizes(stream["sizes"], len(due), seed, WINDOW)))]


@dataclass(frozen=True)
class Get:
    key: int  # preload object index
    offset: int
    length: int | None  # None: the whole object, no Range header


def get_block(stream: dict, dataset: list[int]) -> list[Get]:
    """One block of GETs over the preloaded dataset, in a fixed order: every
    object once whole and once ranged, by size rank.

    A ranged GET's length and offset are tied to its object's size rank, not
    to the seed: rank r takes the r-th length quantile and offset quantile
    under a fixed pairing, clipped to the object. So every seed reads the
    same set of (object size, offset, length), from other keys and bytes."""
    n = len(dataset)
    by_rank = sorted(range(n), key=lambda k: (dataset[k], k))
    fixed = np.random.default_rng(0)  # the pairing is the mix's, not the seed's
    lengths = fixed.permutation(np.round(quantiles(stream["range_len"], n)))
    fracs = fixed.permutation(quantiles({"dist": "uniform", "min": 0, "max": 1}, n))
    ranged = []
    for r, k in enumerate(by_rank):
        size = dataset[k]
        off = min(int(fracs[r] * size), size - 1)
        ranged.append(Get(k, off, int(min(lengths[r], size - off))))
    return [Get(k, 0, None) for k in by_rank] + ranged


def get_schedule(stream: dict, dataset: list[int], seed: int,
                 seconds: float) -> list[tuple[float, Get]]:
    """Open-loop GETs: (due time, request) at the stream's rate. The
    requests are whole blocks, then a share of one block that is the mix's
    and not the seed's, so every seed sends the same set of work; the seed
    orders them and the arrival gaps."""
    due = arrivals(stream["rate_per_s"], seed, seconds, 3)
    block = get_block(stream, dataset)
    reps, rest = divmod(len(due), len(block))
    part = sorted(np.random.default_rng(1).permutation(len(block))[:rest])
    reqs = block * reps + [block[i] for i in part]
    order = _rng(seed, WINDOW, 2).permutation(len(reqs))
    return [(d, reqs[i]) for d, i in zip(due, order)]


def warm_gets(stream: dict, dataset: list[int], seed: int) -> list[Get]:
    """The warm-up GETs: `warm_requests` of one block, in the seed's order."""
    block = get_block(stream, dataset)
    order = _rng(seed, WARM, 2).permutation(len(block))
    return [block[i] for i in order[: stream["warm_requests"]]]


@dataclass(frozen=True)
class Half(Get):
    """One half of a range pair: a ranged GET of a data shard the loss took
    (`role` "degraded") or of a healthy data shard of the same blob
    ("healthy"), at the same length and in-shard offset as its twin."""
    pair: int  # the pair's index in the mix's order
    role: str


def pair_blobs(dataset: dict, lost: dict[int, set[int]]) -> list[tuple[int, int, int, int]]:
    """The blobs a range pair can read, in a fixed order by their object's
    size rank, as (key, object offset of data shard i, of data shard j,
    room): i a data shard the loss took (`lost`: vid -> unit indices lost,
    as run.lose_mix gives it), j the next data shard after it, wrapping,
    that the loss left, and room the real bytes both hold (a blob's last
    data shards hold fewer than the shard size, or none)."""
    from benchmark.reference import codes

    sizes, out = dataset["sizes"], []
    for key in sorted(range(len(sizes)), key=lambda k: (sizes[k], k)):
        loc = json.loads(dataset["locations"][key])
        mode, pos = codes.by_code(loc["code_mode"]), 0
        for blob in loc["blobs"]:
            k, gone = mode.shard_size(blob["size"]), lost.get(blob["vid"], set())
            real = [min(k, max(0, blob["size"] - s * k)) for s in range(mode.N)]
            for i in sorted(x for x in gone if x < mode.N):
                j = next((s % mode.N for s in range(i + 1, i + mode.N)
                          if s % mode.N not in gone), None)
                if j is not None:
                    out.append((key, pos + i * k, pos + j * k, min(real[i], real[j])))
            pos += blob["size"]
    return out


def range_pairs(stream: dict, dataset: dict, lost: dict[int, set[int]], seed: int,
                seconds: float) -> tuple[list[tuple[float, Half]], list[Half]]:
    """Open-loop range pairs at the stream's rate (pairs a second): the
    window's schedule, (due time, half) with both halves of a pair due at
    once, and the warm-up's halves.

    Pair p takes the p-th length quantile, clipped to one data shard (the
    most room of pair_blobs), and the p-th in-shard fraction quantile under
    a fixed pairing (the mix's, not the seed's, as in get_block), and the
    next blob of pair_blobs, cycling, whose room holds its length L; at
    u = fraction x (room - L) into both shards, its degraded half reads L
    bytes of the lost shard i, its healthy half the same L bytes of shard j.
    The seed orders the pairs and sets the gaps; which half is handed to a
    sender first alternates from pair to pair. The warm-up is
    `warm_requests` / 2 of the window's pairs, evenly spaced by length, in
    the seed's order. ValueError where the loss took no data shard."""
    due = arrivals(stream["rate_per_s"], seed, seconds, 4)
    n, blobs = len(due), pair_blobs(dataset, lost)
    if not blobs:
        raise ValueError("no blob lost a data shard beside a healthy one")
    cap = max(b[3] for b in blobs)
    fixed = np.random.default_rng(0)
    lengths = fixed.permutation(np.round(quantiles(stream["range_len"], n)))
    fracs = fixed.permutation(quantiles({"dist": "uniform", "min": 0, "max": 1}, n))
    pairs, at = [], 0
    for p in range(n):
        length = min(int(lengths[p]), cap)
        step = next(s for s in range(len(blobs)) if blobs[(at + s) % len(blobs)][3] >= length)
        key, lost_at, healthy_at, room = blobs[(at + step) % len(blobs)]
        at = (at + step + 1) % len(blobs)
        u = int(fracs[p] * (room - length))
        pairs.append((Half(key, lost_at + u, length, p, "degraded"),
                      Half(key, healthy_at + u, length, p, "healthy")))
    order = _rng(seed, WINDOW, 5).permutation(n)
    sched = [(d, h) for q, (d, p) in enumerate(zip(due, order))
             for h in (pairs[p] if q % 2 == 0 else pairs[p][::-1])]
    w = min(stream["warm_requests"] // 2, n)
    by_len = sorted(range(n), key=lambda p: (pairs[p][0].length, p))
    picks = [by_len[(2 * m + 1) * n // (2 * w)] for m in range(w)]
    warm = [h for p in _rng(seed, WARM, 5).permutation(picks) for h in pairs[p]]
    return sched, warm


def stored_bytes(policies: list[dict], object_sizes: list[int]) -> int:
    """Shard bytes a set of objects stores under a policy table."""
    from benchmark.reference import codes

    return sum(codes.stripe_bytes(codes.pick_mode(policies, s), s) for s in object_sizes)
