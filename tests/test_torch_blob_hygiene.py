"""The cases of tests/test_hygiene.py, run against the port on the CPU:
every name, size and assertion as in the reference, imports from
chubaofs_tpu_torch, every MiniCluster built with device="cpu", and the
shared bit-rot injector from chubaofs_tpu_torch.chaos.inject.

The reference file's docstring:

Blobnode hygiene: chunk compaction, CRC scrub, scheduler volume inspector.

Reference: blobstore/blobnode compaction + datainspect.go (background CRC
scrub), blobstore/scheduler/volume_inspector.go (proactive stripe sweep feeding
the repair topic), SWITCH_VOL_INSPECT gating (common/taskswitch).
"""

import os

import numpy as np
import pytest

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.blobnode import BlobNode
from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_VOL_INSPECT
from chubaofs_tpu_torch.chaos.inject import corrupt_shard_on_disk


def blob_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


# -- chunk compaction ---------------------------------------------------------


def test_compaction_reclaims_holes(tmp_path, rng):
    node = BlobNode(node_id=1, disk_roots=[str(tmp_path / "d0")])
    node.create_vuid(7)
    payload = blob_bytes(rng, 8192)
    for bid in range(20):
        node.put_shard(7, bid, payload)
    chunk = node._chunk(7)
    before = chunk.used
    for bid in range(15):  # punch 75% of the records
        node.delete_shard(7, bid)
    assert chunk.holes > 0
    reclaimed = chunk.compact()
    assert reclaimed > 0.6 * before
    assert chunk.holes == 0
    assert chunk.gen == 1
    for bid in range(15, 20):  # survivors read back exactly
        assert node.get_shard(7, bid) == payload
    node.close()


def test_compaction_survives_reopen(tmp_path, rng):
    root = str(tmp_path / "d0")
    node = BlobNode(node_id=1, disk_roots=[root])
    node.create_vuid(9)
    want = {bid: blob_bytes(rng, 4096) for bid in range(6)}
    for bid, payload in want.items():
        node.put_shard(9, bid, payload)
    for bid in range(3):
        node.delete_shard(9, bid)
        del want[bid]
    node._chunk(9).compact()
    node.close()

    node2 = BlobNode(node_id=1, disk_roots=[root])
    chunk = node2._chunk(9)
    assert chunk.gen == 1
    for bid, payload in want.items():
        assert node2.get_shard(9, bid) == payload
    node2.close()


def test_compaction_crash_before_commit_is_swept(tmp_path, rng):
    """An orphan next-gen file (crash before the metadb commit) is ignored and
    removed on reopen; the committed generation stays authoritative."""
    root = str(tmp_path / "d0")
    node = BlobNode(node_id=1, disk_roots=[root])
    node.create_vuid(5)
    node.put_shard(5, 1, blob_bytes(rng, 2048))
    chunk = node._chunk(5)
    orphan = chunk._gen_path(chunk.gen + 1)
    with open(orphan, "wb") as f:
        f.write(b"partial compaction garbage")
    node.close()

    node2 = BlobNode(node_id=1, disk_roots=[root])
    chunk2 = node2._chunk(5)
    assert chunk2.gen == 0
    assert not os.path.exists(orphan)
    assert len(node2.get_shard(5, 1)) == 2048
    node2.close()


def test_compact_once_threshold(tmp_path, rng):
    node = BlobNode(node_id=1, disk_roots=[str(tmp_path / "d0")])
    node.create_vuid(3)
    for bid in range(8):
        node.put_shard(3, bid, blob_bytes(rng, 4096))
    assert node.compact_once(min_holes=1) == 0  # no holes yet
    for bid in range(6):
        node.delete_shard(3, bid)
    assert node.compact_once(min_hole_ratio=0.25, min_holes=1) > 0
    node.close()


# -- CRC scrub ----------------------------------------------------------------


def test_inspect_once_finds_corruption(tmp_path, rng):
    node = BlobNode(node_id=1, disk_roots=[str(tmp_path / "d0")])
    node.create_vuid(11)
    node.put_shard(11, 1, blob_bytes(rng, 4096))
    node.put_shard(11, 2, blob_bytes(rng, 4096))
    assert node.inspect_once() == []
    corrupt_shard_on_disk(node, 11, 2)
    assert node.inspect_once() == [(11, 2)]
    node.close()


# -- scheduler volume inspector ----------------------------------------------


def test_volume_inspector_discovers_and_heals(tmp_path, rng):
    """Corrupt a shard ON DISK; the inspector (not a client GET) finds it and
    the repair plane heals it (volume_inspector.go end to end)."""
    c = MiniCluster(str(tmp_path), n_nodes=9, disks_per_node=2, device="cpu")
    try:
        data = blob_bytes(rng, 600_000)
        loc = c.access.put(data)
        vid, bid = loc.blobs[0].vid, loc.blobs[0].bid
        vol = c.cm.get_volume(vid)
        unit = vol.units[2]
        corrupt_shard_on_disk(c.nodes[unit.node_id], unit.vuid, bid)

        stats = c.run_background_once()
        assert stats["inspect_msgs"] >= 1
        msgs = c.proxy.topics["shard_repair"].consume("peek", 10)
        assert any(m["reason"] == "inspect" and m["vid"] == vid for m in msgs)

        # healed: the shard reads back clean, and a fresh sweep is quiet
        healed = c.nodes[unit.node_id].get_shard(unit.vuid, bid)
        assert len(healed) > 0
        assert c.scheduler.inspect_volumes(max_volumes=100) == 0
        assert c.access.get(loc) == data
    finally:
        c.close()


def test_volume_inspector_switch_gates(tmp_path, rng):
    c = MiniCluster(str(tmp_path), n_nodes=9, disks_per_node=2, device="cpu")
    try:
        loc = c.access.put(blob_bytes(rng, 10_000))
        vol = c.cm.get_volume(loc.blobs[0].vid)
        unit = vol.units[0]
        corrupt_shard_on_disk(c.nodes[unit.node_id], unit.vuid, loc.blobs[0].bid)
        c.scheduler.switches.set(SWITCH_VOL_INSPECT, False)
        assert c.scheduler.inspect_volumes() == 0  # switched off: no sweep
        c.scheduler.switches.set(SWITCH_VOL_INSPECT, True)
        assert c.scheduler.inspect_volumes(max_volumes=100) >= 1
    finally:
        c.close()


def test_deleter_then_compaction_shrinks_chunks(tmp_path, rng):
    """DELETE -> punch-hole -> compaction: the background tick reclaims the
    bytes of a deleted blob."""
    c = MiniCluster(str(tmp_path), n_nodes=9, disks_per_node=2, device="cpu")
    try:
        loc = c.access.put(blob_bytes(rng, 3_000_000))
        vol = c.cm.get_volume(loc.blobs[0].vid)
        used_before = sum(
            c.nodes[u.node_id]._chunk(u.vuid).used for u in vol.units)
        c.access.delete(loc)
        stats = c.run_background_once()
        assert stats["deletes"] >= 1
        # force-compact regardless of ratio thresholds
        reclaimed = sum(n.compact_once(min_hole_ratio=0.0, min_holes=1)
                        for n in c.nodes.values())
        assert reclaimed > 0
        used_after = sum(
            c.nodes[u.node_id]._chunk(u.vuid).used for u in vol.units)
        assert used_after < used_before
    finally:
        c.close()


def test_committed_gen_missing_fails_loudly(tmp_path, rng):
    """A committed generation whose datafile vanished must NOT sweep the
    surviving copies — it refuses to open instead of silently losing data."""
    from chubaofs_tpu_torch.blobstore.blobnode import BlobNodeError

    root = str(tmp_path / "d0")
    node = BlobNode(node_id=1, disk_roots=[root])
    node.create_vuid(5)
    node.put_shard(5, 1, blob_bytes(rng, 2048))
    chunk = node._chunk(5)
    chunk.compact()  # now at gen 1
    gen1 = chunk._data_path
    node.close()
    os.unlink(gen1)  # external damage: committed file gone
    open(gen1.replace(".g1.", ".g9."), "wb").write(b"survivor")
    with pytest.raises(BlobNodeError, match="refusing to sweep"):
        BlobNode(node_id=1, disk_roots=[root])


def test_holes_metric_survives_restart(tmp_path, rng):
    root = str(tmp_path / "d0")
    node = BlobNode(node_id=1, disk_roots=[root])
    node.create_vuid(4)
    for bid in range(4):
        node.put_shard(4, bid, blob_bytes(rng, 4096))
    for bid in range(3):
        node.delete_shard(4, bid)
    holes = node._chunk(4).holes
    assert holes > 0
    node.close()
    node2 = BlobNode(node_id=1, disk_roots=[root])
    assert node2._chunk(4).holes == holes  # recomputed from live records
    node2.close()


def test_inspector_finishes_partial_delete(tmp_path, rng):
    """A bid deleted on most units but alive on one (node was down during the
    delete) is NOT resurrected: the inspector completes the delete."""
    c = MiniCluster(str(tmp_path), n_nodes=9, disks_per_node=2, device="cpu")
    try:
        loc = c.access.put(blob_bytes(rng, 10_000))
        vid, bid = loc.blobs[0].vid, loc.blobs[0].bid
        vol = c.cm.get_volume(vid)
        survivor = vol.units[0]
        # delete everywhere except unit 0 (simulates its node being down)
        for u in vol.units[1:]:
            c.nodes[u.node_id].mark_delete_shard(u.vuid, bid)
            c.nodes[u.node_id].delete_shard(u.vuid, bid)
        assert c.scheduler.inspect_volumes(max_volumes=100) == 0  # no repair!
        # ...and the straggler copy is gone now
        with pytest.raises(Exception):
            c.nodes[survivor.node_id].get_shard(survivor.vuid, bid)
        assert c.proxy.topics["shard_repair"].lag("scheduler") == 0
    finally:
        c.close()


def test_chunk_id_prefix_not_confused(tmp_path, rng):
    """'vuid-2560.data' is not a generation of chunk 'vuid-256': creating the
    shorter-id chunk must not trip the missing-committed-gen guard."""
    node = BlobNode(node_id=1, disk_roots=[str(tmp_path / "d0")])
    node.create_vuid(2560)
    node.put_shard(2560, 1, blob_bytes(rng, 1024))
    node.create_vuid(256)  # must not raise
    node.put_shard(256, 1, blob_bytes(rng, 1024))
    node.close()
    node2 = BlobNode(node_id=1, disk_roots=[str(tmp_path / "d0")])
    assert len(node2.get_shard(256, 1)) == 1024
    assert len(node2.get_shard(2560, 1)) == 1024
    node2.close()


def test_tombstones_survive_compaction(tmp_path, rng):
    """Compaction keeps delete intent: a tombstoned bid stays tombstoned after
    the chunk is rewritten (and after reopen)."""
    root = str(tmp_path / "d0")
    node = BlobNode(node_id=1, disk_roots=[root])
    node.create_vuid(6)
    node.put_shard(6, 1, blob_bytes(rng, 2048))
    node.put_shard(6, 2, blob_bytes(rng, 2048))
    node.mark_delete_shard(6, 1)
    node.delete_shard(6, 1)
    node._chunk(6).compact()
    assert node.has_tombstone(6, 1)
    node.close()
    node2 = BlobNode(node_id=1, disk_roots=[root])
    assert node2.has_tombstone(6, 1)
    assert not node2.has_tombstone(6, 2)
    node2.close()


def test_tombstones_of_enumeration(tmp_path, rng):
    """tombstones_of lists delete intent directly (including bids never stored
    here) — migrations must carry them even when no live copy exists."""
    node = BlobNode(node_id=1, disk_roots=[str(tmp_path / "d0")])
    node.create_vuid(12)
    node.put_shard(12, 1, blob_bytes(rng, 512))
    node.mark_delete_shard(12, 1)
    node.delete_shard(12, 1)
    node.put_shard(12, 2, blob_bytes(rng, 512))
    assert node.tombstones_of(12) == {1}
    node.tombstone_shard(12, 9)  # carried from elsewhere, never stored here
    assert node.tombstones_of(12) == {1, 9}
    node.tombstone_shard(12, 2)  # live bid: must NOT become a tombstone
    assert node.tombstones_of(12) == {1, 9}
    node.close()
    node2 = BlobNode(node_id=1, disk_roots=[str(tmp_path / "d0")])
    assert node2.tombstones_of(12) == {1, 9}  # persisted
    node2.close()
