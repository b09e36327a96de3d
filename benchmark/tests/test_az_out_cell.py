"""The two-AZ LRC cell with one AZ dark (blob_2az_lrc.get_az_out): its two
readers of the survivor gather's replacement reads on hand-made spans, and
the cell's path on the host at the small size (benchmark/tests/small.py)
from its configuration and mix files, sound and with each fault its GETs
can have planted."""

import re

import pytest

from benchmark import faults, run, system, traffic
from benchmark.tests.small import rehearse

CELL = "blob_2az_lrc.get_az_out"
READERS = ("access.get.replace_pct", "access.get.replaced_per_degraded")

# a whole GET with an AZ dark: the direct read, then a gather whose first
# wave failed, with three replacements (two overlapping) before the decode
DEGRADED = {"op": "access.get", "start": 10.0, "dur": 1.0, "stages": [
    ("read", 10.0, 0.1), ("gather", 10.1, 0.5), ("gather.replace", 10.2, 0.2),
    ("gather.replace", 10.3, 0.2), ("gather.replace", 10.45, 0.1), ("decode", 10.6, 0.3)]}
# a ranged GET of live shards alone
HEALTHY = {"op": "access.get", "start": 20.0, "dur": 1.0, "stages": [("read", 20.0, 0.2)]}
# a degraded GET of a program that records no replacement
OLD = {"op": "access.get", "start": 30.0, "dur": 1.0, "stages": [
    ("read", 30.0, 0.1), ("gather", 30.1, 0.5), ("decode", 30.6, 0.3)]}


def ctx(*span_list):
    return {"spans": list(span_list)}


@pytest.mark.parametrize("name,want", [
    ("access.get.replace_pct", 100 * 0.35 / 3),  # 10.2-10.55 merged, over 3 s of spans
    ("access.get.replaced_per_degraded", 3 / 2),  # 3 replacements, 2 GETs decoding
])
def test_reader_value(name, want):
    assert run.load_reader(name)(ctx(DEGRADED, HEALTHY, OLD)) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_without_replacements(name):
    """Degraded GETs of a program that records no gather.replace stage, and
    healthy GETs: neither reader has anything to read."""
    assert run.load_reader(name)(ctx(OLD, HEALTHY, OLD)) is None


def test_cell_files_change_only_what_the_cell_needs():
    """The mix is get_degraded's but for the AZ lost whole and its cap; the
    configuration carries blob_3az's keys, and EC6P10L2 fits its AZs."""
    mix, base = traffic.load_mix("get_az_out"), traffic.load_mix("get_degraded")
    changed = {k for k in mix.keys() | base.keys() if mix.get(k) != base.get(k)}
    assert changed == {"about", "lose_disks", "lose_az", "max_stored_bytes"}
    assert (mix["lose_disks"], mix["lose_az"], mix["max_stored_bytes"]) == (0, 0, 3 << 30)
    cfg = traffic.load_config("blob_2az_lrc")
    assert cfg.keys() == traffic.load_config("blob_3az").keys()
    assert cfg["policies"] == [{"mode": "EC6P10L2", "min_size": 1}]
    assert cfg["nodes"] * cfg["disks_per_node"] // cfg["azs"] >= 18  # 9 shards an AZ, twice
    _, spec = run.cell_spec(CELL)
    assert (spec["config"], spec["traffic"], spec["chips"]) == ("blob_2az_lrc", "get_az_out", 1)


def test_sound_run_is_correct_and_the_readers_read(capsys):
    """The cell from its files: correct, every whole GET reading a lost
    shard, and both readers reading the run's own GET spans."""
    with system.SpanRecorder() as rec:
        line = rehearse(CELL)
    err = capsys.readouterr().err
    assert "lost AZ 0: 18 disks" in err
    whole = re.search(r"whole GETs reading a lost shard: (\d+) of (\d+)", err)
    assert whole and whole.group(1) == whole.group(2) != "0"
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["checks"]["decoded_MiB"]["value"] >= 1
    spans = ctx(*rec.spans)
    assert 0 < run.load_reader("access.get.replace_pct")(spans) < 100
    assert run.load_reader("access.get.replaced_per_degraded")(spans) >= 5


@pytest.mark.parametrize("fault", ["decode_skipped", "answer_altered"])
def test_planted_fault_is_not_correct(fault):
    line = rehearse(CELL, fault=faults.FAULTS[fault])
    assert not line["correct"], line["checks"]
