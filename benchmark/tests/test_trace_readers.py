"""The readers of the program's own stages inside the access.get span (the
codec's queue wait and batch stages, the read pool's waits) and of the card's
share of it, on hand-made contexts: each returns its number, and nothing
where the program records no such stage."""

import pytest

from benchmark import run, spans

PUT = {"op": "access.put", "start": 10.0, "dur": 1.0, "stages": [("codec.host", 10.0, 0.5)]}
# a window decode: the read pool's waits, the codec's queue wait, and the
# batch's wall as its host and launch stages inside the decode
GET = {"op": "access.get", "start": 20.0, "dur": 2.0, "stages": [
    ("wait.read_pool", 20.0, 0.1), ("wait.read_pool", 20.05, 0.1), ("read", 20.0, 0.5),
    ("gather", 20.5, 0.5), ("decode", 21.0, 0.6), ("wait.codec", 21.05, 0.2),
    ("codec.host", 21.25, 0.05), ("codec.launch", 21.3, 0.15)]}
# a queue wait that began before the span, and a codec stage that outlasts
# the decode stage it overlaps
EDGE = {"op": "access.get", "start": 30.0, "dur": 1.0, "stages": [
    ("decode", 30.0, 0.4), ("wait.codec", 29.9, 0.15), ("codec.launch", 30.3, 0.3)]}
# the spans of a program that records only a batch's host stage and its rest
OLD = {"op": "access.get", "start": 40.0, "dur": 1.0, "stages": [
    ("read", 40.0, 0.5), ("decode", 40.5, 0.4), ("codec.host", 40.6, 0.1),
    ("codec.device", 40.7, 0.1)]}


# the profiler's side: 0.03 s busy in the window, 3 jobs in 2 batches
DEVICE = {"window_s": 10.0, "busy_s": 0.03, "ops": {}, "gaps": []}
CODEC = {"batches": 2, "jobs": 3, "dispatch_s": 0.5}


def ctx(*span_list, device=None, codec=None):
    return {"spans": list(span_list),
            "codec": codec or {"batches": 0, "jobs": 0, "dispatch_s": 0.0},
            "traced_s": 10.0, "device": device, "records": []}


@pytest.mark.parametrize("name,want", [
    ("access.get.wait_codec_pct", 100 * 0.25 / 3),  # 0.2 s and 0.05 s clipped to EDGE
    ("access.get.codec_host_pct", 100 * 0.5 / 3),  # host 0.05 + launch 0.15, and 0.3
    ("access.get.codec_device_pct", 100 * 0.03 * 1.5 / 3),  # busy x jobs a batch / wall
    # GET's decode 0.6 s less its 0.4 s queue wait and batch; EDGE's 0.4 s
    # less 0.05 s of queue wait and the 0.1 s the launch stage overlaps
    ("access.get.decode_caller_pct", 100 * 0.45 / 3),
    ("access.get.wait_read_pool_pct", 100 * 0.15 / 3),  # two waits, overlapping
    ("access.get.p95_ms", 1950.0),  # 1000 and 2000 ms, inclusive quantiles
])
def test_stage_reader_value(name, want):
    got = run.load_reader(name)(ctx(PUT, GET, EDGE, device=DEVICE, codec=CODEC))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["access.get.wait_codec_pct", "access.get.codec_host_pct",
                                  "access.get.codec_device_pct",
                                  "access.get.decode_caller_pct",
                                  "access.get.wait_read_pool_pct"])
def test_nothing_to_read_without_the_stages(name):
    """A program without the queue waits and the launch stage, and a run
    without a device trace: the shares read nothing, though the spans hold
    decode and codec.host stages."""
    assert run.load_reader(name)(ctx(PUT, OLD, OLD)) is None


@pytest.mark.parametrize("device,codec", [(None, CODEC), (DEVICE, None),
                                          (dict(DEVICE, busy_s=0.0), CODEC)])
def test_device_share_needs_busy_seconds_and_batches(device, codec):
    assert run.load_reader("access.get.codec_device_pct")(
        ctx(GET, device=device, codec=codec)) is None


def test_device_share_reads_any_program():
    """The card's share reads the profiler and the codec's counters, so it
    reads a program that records only codec.host and codec.device too."""
    assert run.load_reader("access.get.codec_device_pct")(
        ctx(OLD, device=DEVICE, codec=CODEC)) == pytest.approx(100 * 0.03 * 1.5 / 1.0)


def test_span_tail_reads_any_program():
    assert run.load_reader("access.get.p95_ms")(ctx(OLD, dict(OLD, dur=3.0))) == \
        pytest.approx(1000 + 0.95 * 2000)
    assert run.load_reader("access.get.p95_ms")(ctx(PUT, OLD)) is None


def test_prefix_names_match_every_stage_they_start():
    assert spans.share(ctx(GET), "access.get", ("codec.",)) == pytest.approx(100 * 0.2 / 2)
    assert spans.share(ctx(GET), "access.get", ("codec",)) is None
