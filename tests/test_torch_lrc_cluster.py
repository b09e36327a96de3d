"""The cases of tests/test_lrc_cluster.py, run against the port on the CPU:
LRC (EC6P3L3 and friends) on multi-AZ MiniClusters, local repair inside an AZ."""

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.access import (
    QuorumError,
    default_policies,
    select_code_mode,
)
from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
from chubaofs_tpu_torch.codec.codemode import CodeMode, get_tactic


CPU = "cpu"
# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


class DownNode:
    """A blobnode whose every RPC fails (a fully-dark host)."""

    def __getattr__(self, name):
        def _fail(*a, **k):
            raise RuntimeError("node down")

        return _fail


class RecordingNode:
    """Pass-through blobnode that records which shards were read."""

    def __init__(self, inner):
        self._inner = inner
        self.reads = []

    def get_shard(self, vuid, bid, offset=0, size=None):
        self.reads.append((vuid, bid))
        return self._inner.get_shard(vuid, bid, offset=offset, size=size)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.fixture
def cluster3az(tmp_path):
    # 3 AZs x 2 nodes x 2 disks: EC6P3L3 places 4 units per AZ on 4 disks
    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=2, azs=3)
    yield c
    c.close()


def _az_nodes(cluster, az):
    """node_ids whose disks live in the given AZ."""
    return sorted({d.node_id for d in cluster.cm.disks.values() if d.az == az})


def blob_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_default_policies_put_lrc_on_live_path():
    """Multi-AZ clusters select LRC modes for archive-sized puts."""
    p3 = default_policies(3)
    assert select_code_mode(2_000_000, p3) == CodeMode.EC6P3L3
    assert get_tactic(select_code_mode(2_000_000, p3)).L > 0
    p2 = default_policies(2)
    assert select_code_mode(2_000_000, p2) == CodeMode.EC16P20L2
    assert select_code_mode(1000, p2) == CodeMode.EC6P10L2
    # single-AZ keeps the plain-RS ladder
    assert select_code_mode(2_000_000, default_policies(1)) == CodeMode.EC12P4


def test_access_selects_lrc_from_cluster_topology(cluster3az, rng):
    """An Access built on a 3-AZ cluster routes large puts through LRC."""
    data = blob_bytes(rng, 2_000_000)
    loc = cluster3az.access.put(data)
    assert loc.code_mode == int(CodeMode.EC6P3L3)
    assert cluster3az.access.get(loc) == data
    # every shard, locals included, landed
    t = get_tactic(loc.code_mode)
    vol = cluster3az.cm.get_volume(loc.blobs[0].vid)
    for unit in vol.units:
        node = cluster3az.nodes[unit.node_id]
        assert node.get_shard(unit.vuid, loc.blobs[0].bid)


def test_dark_az_put_get_heal(cluster3az, rng):
    """PUT with one whole AZ down succeeds; GET reconstructs; repair heals.

    The signature LRC/multi-AZ flow: stream_put.go:405-437 tolerance, then the
    failed shards ride the repair topic back to full redundancy."""
    c = cluster3az
    dark_az = 2
    down = _az_nodes(c, dark_az)
    saved = {n: c.nodes[n] for n in down}
    for n in down:
        c.nodes[n] = DownNode()

    data = blob_bytes(rng, 2_000_000)
    loc = c.access.put(data, code_mode=CodeMode.EC6P3L3)

    # degraded GET with the AZ still dark
    assert c.access.get(loc) == data

    # exactly the dark AZ's shards were queued for repair
    t = get_tactic(CodeMode.EC6P3L3)
    vol = c.cm.get_volume(loc.blobs[0].vid)
    bid = loc.blobs[0].bid
    dark_idx = set(t.shards_in_az(dark_az))
    msgs = c.proxy.topics["shard_repair"].consume("peek", 100)
    assert msgs and set(msgs[0]["bad_idx"]) == dark_idx

    # lights back on: background repair heals every missing shard
    for n, node in saved.items():
        c.nodes[n] = node
    c.run_background_once()
    for idx in sorted(dark_idx):
        unit = vol.units[idx]
        got = c.nodes[unit.node_id].get_shard(unit.vuid, bid)
        assert len(got) == t.shard_size(loc.blobs[0].size)
    # the healed object reads back clean via the fast path
    assert c.access.get(loc) == data


def test_two_dark_azs_fail_put(cluster3az, rng):
    """Two dark AZs break both the quorum and the tolerance rule."""
    c = cluster3az
    saved = dict(c.nodes)
    for az in (1, 2):
        for n in _az_nodes(c, az):
            c.nodes[n] = DownNode()
    try:
        with pytest.raises(QuorumError):
            c.access.put(blob_bytes(rng, 2_000_000), code_mode=CodeMode.EC6P3L3)
    finally:
        c.nodes.update(saved)


def test_local_parity_does_not_satisfy_quorum(tmp_path, rng):
    """Quorum counts global shards only (maxWrittenIndex = N+M): killing all
    but one AZ's globals fails the put even if locals landed."""
    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=2, azs=3)
    try:
        t = get_tactic(CodeMode.EC6P3L3)
        # darken two AZs partially: one global shard down in each of az1, az2
        # leaves written globals = 7 < put_quorum 9 and no single-dark-AZ out
        vol = c.cm.alloc_volume(int(CodeMode.EC6P3L3))
        down_nodes = set()
        for az in (1, 2):
            g = [i for i in t.shards_in_az(az) if i < t.global_count][0]
            down_nodes.add(vol.units[g].node_id)
        saved = dict(c.nodes)
        for n in down_nodes:
            c.nodes[n] = DownNode()
        try:
            with pytest.raises(QuorumError):
                c.access.put(blob_bytes(rng, 2_000_000), code_mode=CodeMode.EC6P3L3)
        finally:
            c.nodes.update(saved)
    finally:
        c.close()


def test_local_stripe_repair_reads_same_az_only(cluster3az, rng):
    """Losing one shard inside an AZ repairs from that AZ alone
    (work_shard_recover.go:517)."""
    c = cluster3az
    data = blob_bytes(rng, 2_000_000)
    loc = c.access.put(data, code_mode=CodeMode.EC6P3L3)
    t = get_tactic(CodeMode.EC6P3L3)
    vol = c.cm.get_volume(loc.blobs[0].vid)
    bid = loc.blobs[0].bid

    lost_idx = t.shards_in_az(0)[0]  # a data shard in AZ 0
    unit = vol.units[lost_idx]
    c.nodes[unit.node_id].lose_shard(unit.vuid, bid)
    c.proxy.send_shard_repair(vol.vid, bid, [lost_idx], "test")

    # gate off the volume inspector: it legitimately sweeps every AZ, and this
    # test asserts only on the REPAIR's read set
    from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_VOL_INSPECT

    c.scheduler.switches.set(SWITCH_VOL_INSPECT, False)
    recorders = {n: RecordingNode(node) for n, node in c.nodes.items()}
    c.nodes.clear()
    c.nodes.update(recorders)
    c.run_background_once()

    az0_nodes = set(_az_nodes(c, 0))
    read_nodes = {n for n, r in recorders.items() if r.reads}
    assert read_nodes, "repair must have read something"
    assert read_nodes <= az0_nodes, f"repair read outside AZ 0: {read_nodes}"

    healed = c.nodes[unit.node_id].get_shard(unit.vuid, bid)
    assert np.frombuffer(healed, np.uint8).size == t.shard_size(loc.blobs[0].size)
    assert c.access.get(loc) == data


def test_lost_local_parity_recomputed_in_az(cluster3az, rng):
    """A lost local parity is regenerated from its AZ's global shards."""
    c = cluster3az
    data = blob_bytes(rng, 2_000_000)
    loc = c.access.put(data, code_mode=CodeMode.EC6P3L3)
    t = get_tactic(CodeMode.EC6P3L3)
    vol = c.cm.get_volume(loc.blobs[0].vid)
    bid = loc.blobs[0].bid

    local_idx = t.shards_in_az(1)[-1]  # AZ 1's local parity
    assert local_idx >= t.global_count
    unit = vol.units[local_idx]
    before = c.nodes[unit.node_id].get_shard(unit.vuid, bid)
    c.nodes[unit.node_id].lose_shard(unit.vuid, bid)
    c.proxy.send_shard_repair(vol.vid, bid, [local_idx], "test")

    from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_VOL_INSPECT

    c.scheduler.switches.set(SWITCH_VOL_INSPECT, False)  # see test above
    recorders = {n: RecordingNode(node) for n, node in c.nodes.items()}
    c.nodes.clear()
    c.nodes.update(recorders)
    c.run_background_once()

    az1_nodes = set(_az_nodes(c, 1))
    read_nodes = {n for n, r in recorders.items() if r.reads}
    assert read_nodes <= az1_nodes, f"repair read outside AZ 1: {read_nodes}"
    assert c.nodes[unit.node_id].get_shard(unit.vuid, bid) == before


def test_two_az_lrc_roundtrip(tmp_path, rng):
    """EC6P10L2 (2-AZ LRC) full put/get/degraded-get on a 2-AZ cluster."""
    # EC6P10L2 places 9 units per AZ: 3 nodes x 3 disks each side
    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=3, azs=2)
    try:
        data = blob_bytes(rng, 500_000)
        loc = c.access.put(data)
        assert loc.code_mode == int(CodeMode.EC6P10L2)
        assert c.access.get(loc) == data
        # kill two data shards; direct GET degrades but still serves
        vol = c.cm.get_volume(loc.blobs[0].vid)
        for idx in (0, 1):
            u = vol.units[idx]
            c.nodes[u.node_id].lose_shard(u.vuid, loc.blobs[0].bid)
        assert c.access.get(loc) == data
    finally:
        c.close()
