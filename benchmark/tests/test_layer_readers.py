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
                        for i in range(1, 101)], "loss": None}
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


# a window of 300 objects read whole once in each half: before the loss in
# 10 ms (object k: 10 + k/100 ms), after it in 25 ms; the loss runs 50.0-50.5
# s, the halves split at 50.0
LOSS = {"split": 50.0, "start": 50.0, "end": 50.5}


def whole(key, due, lat_ms, status=200):
    return {"op": "get", "key": key, "offset": 0, "length": None, "due": due,
            "done": due + lat_ms / 1e3, "status": status}


def halves(n=300, guard_keys=()):
    """Before: due at 1 + k/10 s; after: due at 54 + k/10 s (past the
    guard), or at 51.0 s (inside it) for the guard_keys."""
    recs = []
    for k in range(n):
        recs.append(whole(k, 1.0 + k / 10, 10 + k / 100))
        recs.append(whole(k, 51.0 if k in guard_keys else 54.0 + k / 10, 25.0))
        recs.append({**whole(k, 60.0, 1.0), "offset": 5, "length": 7})  # ranged: never paired
    return recs


def test_loss_pairs_pair_each_objects_whole_reads_across_the_split():
    pairs, dropped = layers.loss_pairs(halves(), LOSS)
    assert dropped == 0 and len(pairs) == 300
    assert pairs[7] == pytest.approx((0.01007, 0.025))


@pytest.mark.parametrize("due,dropped", [
    (49.49, 0), (49.5, 1), (52.5, 1), (52.51, 0)])  # the guard: 0.5 s before, 2 s after
def test_loss_guard_drops_pairs_due_around_the_loss(due, dropped):
    recs = halves(n=250)
    recs[0] = whole(0, due, 10.0) if due < LOSS["split"] else recs[0]
    recs[1] = whole(0, due, 25.0) if due >= LOSS["split"] else recs[1]
    pairs, got = layers.loss_pairs(recs, LOSS)
    assert got == dropped and len(pairs) == 250 - dropped


def test_loss_x_is_the_median_ratio_and_needs_200_pairs():
    # ratios 25 / (10 + k/100) over k = 0..299: the median of 150 and 151
    want = (25 / (10 + 149 / 100) + 25 / (10 + 150 / 100)) / 2
    assert layers.get_loss_x(halves(), LOSS) == pytest.approx(want)
    assert layers.get_loss_x(halves(), None) is None
    assert layers.get_loss_x(halves(n=200), LOSS) is not None
    assert layers.get_loss_x(halves(n=230, guard_keys=range(31)), LOSS) is None  # 199 left


def test_loss_pair_with_a_failed_read_counts_as_infinite():
    recs = halves(n=201)
    recs[1] = whole(0, recs[1]["due"], 25.0, status=-1)
    assert layers.loss_pairs(recs, LOSS)[0][0] == (pytest.approx(0.01), float("inf"))


def test_loss_medians_of_each_half():
    c = ctx(records=halves(), loss=LOSS)
    assert run.load_reader("client.get_before_p50_ms")(c) == pytest.approx(11.495)
    assert run.load_reader("client.get_after_p50_ms")(c) == pytest.approx(25.0)
    assert run.load_reader("get_loss_x")(c) == layers.get_loss_x(c["records"], LOSS)
