"""`correct` on the host at a small size: a cell comes out correct when
sound, and not correct with each fault it can have planted under the timed
path (the harness's look for a card skipped: device="cpu"). The PUT faults
run on the same cluster under the `get_healthy` mix, whose trickle of PUTs
carries them."""

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
