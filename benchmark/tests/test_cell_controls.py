"""`correct` on the host at a small size: a cell comes out correct when
sound, and not correct with each fault it can have planted under the timed
path (the harness's look for a card skipped: device="cpu"). The PUT faults
run on the same cluster under the `get_healthy` mix, whose trickle of PUTs
carries them. The one-disk cell loses one disk, so its window holds
healthy GETs beside degraded ones, and its faults show on the degraded."""

import json
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


ONE_DISK = "blob_3az.get_one_disk"


@pytest.mark.parametrize("fault", [None, "decode_delayed", "decode_delayed_1ms"])
def test_one_disk_run_is_correct_and_classes_its_gets(fault, capsys):
    """decode_delayed and decode_delayed_1ms slow every codec batch and must
    leave the run correct: they control get_degraded_x's sensitivity, not
    `correct`."""
    line = rehearse(ONE_DISK, fault=fault and faults.FAULTS[fault])
    err = capsys.readouterr().err
    assert re.search(r"lost disks \[\d+\]", err)  # one disk
    whole = re.search(r"whole GETs reading a lost shard: (\d+) of (\d+)", err)
    assert whole and 0 < int(whole.group(1)) < int(whole.group(2))  # healthy ones left
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["checks"]["decoded_MiB"]["value"] >= 1


@pytest.mark.parametrize("fault", FAULTS["get_degraded"])
def test_one_disk_planted_fault_is_not_correct(fault):
    line = rehearse(ONE_DISK, fault=faults.FAULTS[fault])
    assert not line["correct"], line["checks"]


def test_classes_agree_with_the_gateways_decodes(tmp_path):
    """Every GET of a block, sent one at a time after the cell's disk is
    lost: the layout classes it degraded exactly where the gateway's
    decoded-bytes counter moves."""
    from benchmark import layers, run, system, traffic
    from benchmark.tests.small import SEED, small_mix

    cfg, mix = traffic.load_config("blob_3az"), small_mix(ONE_DISK)
    daemon = system.start_daemon(cfg, str(tmp_path / "cluster"), "cpu")
    try:
        cluster = system.cluster_of(daemon)
        system.set_policies(cluster, cfg["policies"])
        job = {"addr": daemon.addr, "seed": SEED, "mix": mix, "seconds": 1.5}
        out, proc = run.client(job, str(tmp_path), "preload", None)
        proc.communicate(timeout=300)
        dataset = json.load(open(out))
        system.switch_off(daemon.addr, cfg["switches_off"] + mix["switches_off"])
        lost = run.lose(cluster, system.victims(cluster, 1))
        classes, decoded = [], []
        for g in traffic.get_block(mix["window"][0], dataset["sizes"]):
            before = system.decoded_bytes()
            cluster.access.get(dataset["locations"][g.key], g.offset, g.length)
            decoded.append(system.decoded_bytes() > before)
            classes.append(layers.reads_lost_shard(json.loads(dataset["locations"][g.key]),
                                                   g.offset, g.length, lost))
        assert classes == decoded and 0 < sum(classes) < len(classes)
    finally:
        daemon.stop()
