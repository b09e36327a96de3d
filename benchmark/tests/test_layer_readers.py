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


def window(n=250):
    """n degraded whole GETs of 30 ms, each at 10 s + 3k s with a healthy
    twin of 10 ms due 0.5 s later, of 1.2x its size."""
    recs = []
    for k in range(n):
        recs += [get(10.0 + 3 * k, 30.0, True), get(10.5 + 3 * k, 10.0, False, want=1200)]
    return recs


def test_twins_pair_the_nearest_healthy_get_of_the_same_kind():
    recs = [get(10.0, 30.0, True), get(11.9, 5.0, False), get(10.3, 8.0, False, ranged=True),
            get(9.0, 10.0, False), get(10.2, 9.0, True, ranged=True)]
    assert layers.twins(recs) == [(pytest.approx(0.03), pytest.approx(0.01)),
                                  (pytest.approx(0.009), pytest.approx(0.008))]


@pytest.mark.parametrize("gap,want", [(2.0, 1), (2.01, 0), (-2.0, 1), (-2.01, 0)])
def test_twin_is_due_within_two_seconds(gap, want):
    assert len(layers.twins([get(10.0, 30.0, True), get(10.0 + gap, 10.0, False)])) == want


@pytest.mark.parametrize("size,want", [(1500, 1), (1501, 0), (667, 1), (666, 0)])
def test_twin_asks_for_a_size_within_a_factor_of_one_and_a_half(size, want):
    recs = [get(10.0, 30.0, True), get(10.1, 10.0, False, want=size)]
    assert len(layers.twins(recs)) == want
    ranged = [get(10.0, 30.0, True, ranged=True), get(10.1, 10.0, False, want=size, ranged=True)]
    assert len(layers.twins(ranged)) == want


def test_a_healthy_get_serves_one_pair():
    """Two degraded GETs, one healthy GET near both: the first due takes it,
    the second takes the next nearest, and a third finds none."""
    recs = [get(10.0, 30.0, True), get(10.1, 40.0, True), get(10.2, 50.0, True),
            get(10.05, 10.0, False), get(11.0, 20.0, False)]
    assert layers.twins(recs) == [(pytest.approx(0.03), pytest.approx(0.01)),
                                  (pytest.approx(0.04), pytest.approx(0.02))]


def test_degraded_x_is_the_median_ratio_and_needs_the_minimum_of_pairs():
    assert layers.get_degraded_x(window()) == pytest.approx(3.0)
    assert layers.get_degraded_x(window(layers.MIN_TWINS)) == pytest.approx(3.0)
    assert layers.get_degraded_x(window(layers.MIN_TWINS - 1)) is None
    unclassed = [{k: v for k, v in r.items() if k != "degraded"} for r in window()]
    assert layers.get_degraded_x(unclassed) is None


def test_a_failed_get_counts_as_infinite():
    recs = window()
    recs[0] = get(10.0, 30.0, True, status=-1)
    assert layers.twins(recs)[0] == (float("inf"), pytest.approx(0.01))


def test_twin_readers():
    c = ctx(records=window())
    assert run.load_reader("get_degraded_x")(c) == pytest.approx(3.0)
    assert run.load_reader("client.get_degraded_p50_ms")(c) == pytest.approx(30.0)
    assert run.load_reader("client.get_healthy_p50_ms")(c) == pytest.approx(10.0)
    assert run.load_reader("client.get_degraded_p50_ms")(ctx()) is None
