"""A configuration and a mix that no cell names, run through the cells' path
on the host at the small size (benchmark/tests/small.py): a two-AZ
blobstore in EC6P10L2, CubeFS's two-AZ LRC mode, with one AZ lost whole,
and the same AZ loss in the three-AZ EC6P6 configuration. Both are built
here, so a deployment in any mode of the reference's table, and a mix that
takes an AZ down, are new files only."""

import re

import pytest

from benchmark import faults, system, traffic
from benchmark.tests.small import rehearse, small_mix

CELL = "blob_3az.get_degraded"

# EC6P10L2: 9 shards an AZ (3 data, 5 global parity, 1 local parity). Two
# disks a node and the nodes dealt to the AZs in turn: 10 nodes are the
# fewest that give each AZ 9 disks.
LRC = {
    "name": "blob_2az_lrc",
    "source": "https://github.com/cubefs/cubefs/blob/v3.2.1/blobstore/common/codemode/codemode.go",
    "nodes": 10,
    "disks_per_node": 2,
    "azs": 2,
    "policies": [{"mode": "EC6P10L2", "min_size": 1}],
    "max_blob_size": 4194304,
    "switches_off": ["vol_inspect"],
}


def az_out(az: int = 0, disks: int = 0) -> dict:
    """get_degraded's small mix with AZ `az` lost whole and `disks` disks
    of the other AZs picked."""
    mix = small_mix(CELL, "get_degraded")
    mix.update(lose_disks=disks, lose_az=az)
    return mix


def lost_exactly(az: int, disks_out: int = 0):
    """A fault that plants nothing: it asserts that every disk of AZ `az`,
    and `disks_out` disks outside it, are broken and hold none of their shards,
    while every other disk holds all of its own."""
    def inspect(daemon):
        from chubaofs_tpu_torch.blobstore.blobnode import NoSuchShard
        from chubaofs_tpu_torch.blobstore.clustermgr import DISK_BROKEN

        def listed(u):
            try:
                return cluster.nodes[u.node_id].list_shards(u.vuid)
            except NoSuchShard:  # the unit never got a chunk
                return []

        cluster = system.cluster_of(daemon)
        disks = cluster.cm.disks
        broken = {d for d in disks if disks[d].status == DISK_BROKEN}
        whole = set(system.az_disks(cluster, az))
        assert whole and whole <= broken and len(broken - whole) == disks_out
        blobs = 0
        for vol in cluster.cm.volumes.values():
            held = [u.disk_id not in broken for u in vol.units]
            bids = {m.bid for u, h in zip(vol.units, held) if h for m in listed(u)}
            for bid in bids:
                got = system.read_stripe(cluster, vol.vid, bid)
                assert [g is not None for g in got] == held
                blobs += 1
        assert blobs > 0
    return inspect


def test_lrc_az_lost_run_is_correct(capsys):
    line = rehearse(CELL, fault=lost_exactly(0), config=LRC, mix=az_out(0))
    err = capsys.readouterr().err
    assert "lost AZ 0: 10 disks" in err
    whole = re.search(r"whole GETs reading a lost shard: (\d+) of (\d+)", err)
    assert whole and whole.group(1) == whole.group(2)  # each loses data shards 0-2
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["checks"]["get_failed"]["value"] == 0
    assert line["checks"]["decoded_MiB"]["value"] >= 1


@pytest.mark.parametrize("fault", ["decode_skipped", "answer_altered"])
def test_lrc_az_lost_planted_fault_is_not_correct(fault):
    line = rehearse(CELL, fault=faults.FAULTS[fault], config=LRC, mix=az_out(0))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [None, "parity_unwritten", "shard_altered"])
def test_lrc_puts_are_checked_as_whole_stripes(fault, capsys):
    """get_healthy's PUTs in EC6P10L2: each blob read back as 18 shards, the
    two local parities among them, against the reference's stripe."""
    line = rehearse(CELL, fault=fault and faults.FAULTS[fault], config=LRC,
                    traffic_name="get_healthy")
    if fault is None:
        assert line["correct"], line["checks"]
        put = re.search(r"PUT: (\d+) acknowledged, (\d+) blobs read back, 0 shards missing",
                        capsys.readouterr().err)
        assert put and int(put.group(1)) > 0 and int(put.group(2)) > 0
    else:
        assert not line["correct"], line["checks"]


@pytest.mark.parametrize("disks", [0, 1])
def test_az_lost_in_ec6p6_loses_that_az_alone_and_reads_back(disks):
    """EC6P6 keeps 8 of its 12 shards with an AZ out, and 7 with a disk of
    another AZ lost besides: every GET answered."""
    line = rehearse(CELL, fault=lost_exactly(0, disks), config=traffic.load_config("blob_3az"),
                    mix=az_out(0, disks))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["checks"]["decoded_MiB"]["value"] >= 1
