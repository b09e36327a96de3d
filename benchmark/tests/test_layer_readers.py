"""The per-layer readers on a hand-made context: each returns its number,
and nothing when the run holds nothing for it to read."""

import os

import pytest

from benchmark import devtrace, layers, run

SPAN = {"op": "access.put", "start": 10.0, "dur": 1.0,
        "stages": [("encode", 10.0, 0.1), ("write", 10.2, 0.4), ("write", 10.4, 0.4)]}
GET = {"op": "access.get", "start": 20.0, "dur": 2.0,
       "stages": [("read", 20.0, 0.5), ("gather", 20.5, 0.5), ("decode", 21.0, 0.2)]}
HEALTHY = {"op": "access.get", "start": 30.0, "dur": 0.0, "stages": [("read", 30.0, 0.0)]}


def ctx(**kw):
    base = {"spans": [SPAN, GET], "codec": {"batches": 4, "jobs": 10, "dispatch_s": 0.5},
            "traced_s": 10.0, "device": {"busy_s": 0.25, "window_s": 10.0},
            "records": [{"op": "get", "due": 1.0, "done": 1.0 + i / 1e3, "status": 200}
                        for i in range(1, 101)]}
    base.update(kw)
    return base


READERS = sorted(f[:-3] for f in os.listdir(os.path.join(os.path.dirname(run.__file__),
                                                          "metrics")) if f.endswith(".py"))


@pytest.mark.parametrize("name,want", [
    ("access.get.decode_pct", 10.0),
    ("access.get.read_pct", 50.0),
    ("access.get.degraded_pct", 50.0),  # one GET of two holds a decode stage
    ("codec.jobs_per_batch.get", 2.5),
    ("codec.busy_pct.get", 5.0),
    ("device.idle_pct.get", 97.5),
    ("client.get_p95_ms", 95.05),  # 1..100 ms, inclusive quantiles
])
def test_reader_value(name, want):
    assert run.load_reader(name)(ctx(spans=[SPAN, GET, HEALTHY])) == pytest.approx(want)


def test_stage_union_counts_overlap_once():
    """Two overlapping stages of one span: their union, 0.6 s of 1 s."""
    assert layers.stage_share(ctx(), "access.put", ("write",)) == pytest.approx(60.0)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name):
    empty = ctx(spans=[], codec={"batches": 0, "jobs": 0, "dispatch_s": 0.0}, device=None,
                records=[])
    assert run.load_reader(name)(empty) is None


def test_idle_gaps_named_by_the_host_stage():
    assert devtrace.stage_at([GET], 21.1) == "access.get.decode"
    assert devtrace.stage_at([GET], 21.5) == "access.get (between stages)"
    assert devtrace.stage_at([GET], 30.0) == "no request in flight"
    assert devtrace.union([(0, 2), (1, 3), (5, 6)]) == 4


def test_get_rate_counts_every_answer_over_the_window_or_longer():
    """Every GET answered counts; the time is the window's seconds, or until
    the last answer where that comes later."""
    recs = [{"op": "get", "done": 100.0 + t, "bytes": 2**20, "status": 200} for t in (1, 5)]
    assert layers.get_mibps(recs, 100.0, 10.0) == pytest.approx(0.2)
    assert layers.get_mibps(recs, 100.0, 4.0) == pytest.approx(0.4)
    assert layers.get_mibps([], 100.0, 4.0) is None


# a synthetic layout in EC6P6: shards of ceil(blob / 6) bytes; volume 1
# lost its unit 2 (a data shard), volume 2 lost its unit 8 (a parity shard)
LOST = {1: {2}, 2: {8}}
ONE_BLOB = {"code_mode": 2, "size": 6000, "blobs": [{"vid": 1, "bid": 7, "size": 6000}]}
# 4 MiB in volume 2, then 1 MiB in volume 1: shard 2 of the second blob is
# bytes 4 MiB + [2 x 174763, 3 x 174763)
TWO_BLOBS = {"code_mode": 2, "size": 5 << 20, "blobs": [
    {"vid": 2, "bid": 8, "size": 4 << 20}, {"vid": 1, "bid": 9, "size": 1 << 20}]}


@pytest.mark.parametrize("loc,offset,length,want", [
    (ONE_BLOB, 0, None, True),  # whole: every data shard
    (ONE_BLOB, 4096, 1, True),  # the lost shard's first byte (shards of 2048 B)
    (ONE_BLOB, 2048, 2048, False),  # shard 1 whole, ending a byte short of shard 2
    (ONE_BLOB, 4096, 1904, True),  # shard 2 to the end
    (ONE_BLOB, 4095, 2, True),  # shard 1's last byte and shard 2's first
    (TWO_BLOBS, 0, None, True),  # whole: the second blob has a lost shard
    (TWO_BLOBS, 0, 4 << 20, False),  # the first blob only: its lost unit is parity
    (TWO_BLOBS, (4 << 20) + 2 * 174763, 1, True),
    (TWO_BLOBS, (4 << 20) + 174763, 174763, False),  # shard 1, a byte short of shard 2
])
def test_lost_shard_classifier_on_a_synthetic_layout(loc, offset, length, want):
    assert layers.reads_lost_shard(loc, offset, length, LOST) is want


def get(due, lat_ms, degraded, want=1000, ranged=False, status=200):
    return {"op": "get", "key": 0, "offset": 0, "length": want if ranged else None,
            "due": due, "done": due + lat_ms / 1e3, "status": status, "want": want,
            "degraded": degraded}


def window(n=60, k=3.0, slow=None):
    """n degraded whole GETs, each at 10 s + 2j s with three healthy
    neighbours of its size due 0.1-0.3 s after it, the neighbours taking
    5-11 ms and the degraded GET k times theirs; `slow` (lo, hi) makes every
    GET due in those seconds 3x slower."""
    recs = []
    for j in range(n):
        t, base = 10.0 + 2 * j, 5.0 + j % 7
        recs += [get(t, k * base, True)] + [get(t + dt, base, False) for dt in (0.1, 0.2, 0.3)]
    if slow:
        for r in recs:
            if slow[0] <= r["due"] < slow[1]:
                r["done"] = r["due"] + 3 * (r["done"] - r["due"])
    return recs


def failed(recs, n):
    """recs with its first n degraded GETs failed."""
    out, left = [], n
    for r in recs:
        if r["degraded"] and left:
            r, left = {**r, "status": -1}, left - 1
        out.append(r)
    return out


ONE = get(10.0, 30.0, True)
INF = float("inf")
CASES = {
    # each degraded GET k times its size-matched neighbours
    "k_times_its_neighbours": (window(k=2.5), 2.5, 60),
    # one 5 s episode of a 3x slower host: each ratio's two sides slow together
    "a_slow_episode_cancels": (window(k=2.5, slow=(20.0, 25.0)), 2.5, 60),
    # a neighbour is due within 2 s, before or after
    "due_2s_after": ([ONE, get(12.0, 10.0, False)], 3.0, 1),
    "due_2.01s_after": ([ONE, get(12.01, 10.0, False)], None, 0),
    "due_2s_before": ([ONE, get(8.0, 10.0, False)], 3.0, 1),
    "due_2.01s_before": ([ONE, get(7.99, 10.0, False)], None, 0),
    # ... of a size (whole) or length (ranged) within 1.5x of the degraded GET's
    **{f"{kind}_size_{size}": ([get(10.0, 30.0, True, ranged=kind == "ranged"),
                                get(10.1, 10.0, False, want=size, ranged=kind == "ranged")],
                               3.0 if n else None, n)
       for kind in ("whole", "ranged") for size, n in ((1500, 1), (1501, 0), (667, 1), (666, 0))},
    # ... and of its kind: a range is no whole GET's neighbour
    "of_its_kind": ([ONE, get(10.1, 10.0, False, ranged=True)], None, 0),
    # the 3 nearest in log size (10, 20, 20 ms: median 20), not the nearest
    # in time (the 5 ms one of 1.4x, due at once)
    "nearest_in_size_first": ([get(10.0, 60.0, True), get(10.0, 5.0, False, want=1400),
                               get(10.5, 10.0, False), get(11.0, 20.0, False, want=1050),
                               get(11.9, 20.0, False, want=950)], 3.0, 1),
    # one healthy GET serves two degraded ones: ratios 3 and 6
    "a_neighbour_serves_several": ([ONE, get(10.2, 60.0, True), get(10.1, 10.0, False)],
                                   18 ** 0.5, 2),
    # 6 of 60 failed: the top tenth, trimmed
    "failed_within_the_trim": (failed(window(), 6), 3.0, 60),
    # 7 of 60 failed: past the trimmed tenth
    "failed_past_the_trim": (failed(window(), 7), INF, 60),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lost_disk_ratio(case):
    recs, value, count = CASES[case]
    x, n = layers.lost_disk_ratio(recs)
    assert n == count
    assert x == (value if value in (None, INF) else pytest.approx(value))


def test_a_failed_degraded_get_raises_it():
    """Ratios that differ: one failed degraded GET sorts to the top, so the
    kept tenths move up."""
    recs = [r for j in range(30)
            for r in (get(10.0 + 2 * j, 10.0 * (j + 1), True), get(10.1 + 2 * j, 10.0, False))]
    assert layers.lost_disk_ratio(failed(recs, 1))[0] > layers.lost_disk_ratio(recs)[0]


def test_degraded_x_needs_the_minimum_of_degraded_gets_with_a_baseline():
    least = layers.MIN_BASELINED
    assert layers.get_degraded_x(window(least)) == pytest.approx(3.0)
    assert layers.get_degraded_x(window(least - 1)) is None
    assert layers.baselined_p50_ms(window(least - 1), 0) is None
    unclassed = [{k: v for k, v in r.items() if k != "degraded"} for r in window(least)]
    assert layers.get_degraded_x(unclassed) is None


def test_baselined_readers():
    """get_degraded_x and each side's median over the degraded GETs with a
    baseline: window()'s neighbours take 5-11 ms, the degraded GETs 3x as
    long."""
    c = ctx(records=window(layers.MIN_BASELINED))
    assert run.load_reader("get_degraded_x")(c) == pytest.approx(3.0)
    assert run.load_reader("client.get_degraded_p50_ms")(c) == pytest.approx(24.0)
    assert run.load_reader("client.get_healthy_p50_ms")(c) == pytest.approx(8.0)
    assert run.load_reader("client.get_degraded_p50_ms")(ctx()) is None
