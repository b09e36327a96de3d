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
