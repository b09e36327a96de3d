"""`correct` on the host at a small size: a cell comes out correct when
sound, and not correct with each fault it can have planted under the timed
path (the harness's look for a card skipped: device="cpu"). The PUT faults
run on the same cluster under the `get_healthy` mix, whose trickle of PUTs
carries them. The disk-loss cell loses its disks halfway through its
window, and its faults show after the loss."""

import re

import pytest

from benchmark import faults
from benchmark.tests.small import rehearse

CELL = "blob_3az.get_degraded"
FAULTS = {
    "get_degraded": ["decode_skipped", "answer_altered", "half_batch", "shard_altered"],
    "get_healthy": ["parity_unwritten", "state_unchanged", "answer_altered", "half_batch",
                    "shard_altered"],
}


@pytest.mark.parametrize("mix", sorted(FAULTS))
def test_sound_run_is_correct(mix):
    line = rehearse(CELL, traffic_name=mix)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("mix,fault", [(m, f) for m, fs in sorted(FAULTS.items()) for f in fs])
def test_planted_fault_is_not_correct(mix, fault):
    line = rehearse(CELL, fault=faults.FAULTS[fault], traffic_name=mix)
    assert not line["correct"], line["checks"]


LOSS_CELL = "blob_3az.get_disk_loss"


@pytest.mark.parametrize("fault", [None, "decode_delayed"])
def test_disk_loss_run_loses_its_disks_halfway_and_is_correct(fault, capsys):
    """decode_delayed slows every codec batch and must leave the run
    correct: it controls get_loss_x's sensitivity, not `correct`."""
    line = rehearse(LOSS_CELL, fault=fault and faults.FAULTS[fault])
    began = re.search(r"the loss began ([0-9.]+) s into the window", capsys.readouterr().err)
    assert began and 0.75 <= float(began.group(1)) < 0.9  # half of the 1.5 s window
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["checks"]["decoded_MiB"]["value"] >= 1


@pytest.mark.parametrize("fault", FAULTS["get_degraded"])
def test_disk_loss_planted_fault_is_not_correct(fault):
    line = rehearse(LOSS_CELL, fault=faults.FAULTS[fault])
    assert not line["correct"], line["checks"]
