"""The cases of tests/test_blobstore.py, run against the port on the CPU.

End-to-end blobstore tests: PUT/GET/DELETE, shard loss, disk repair, with
real components wired in-process and failures injected by deleting shard
files / breaking disks. Every cluster here is MiniCluster(device="cpu"); the
same cases run on the card through chip_smoke.py's gateway phase."""

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.access import Location, LocationError, select_code_mode
from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
from chubaofs_tpu_torch.blobstore.clustermgr import DISK_BROKEN, parse_vuid, make_vuid
from chubaofs_tpu_torch.codec.codemode import CodeMode


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


@pytest.fixture
def cluster(tmp_path):
    # EC12P4 places 16 units on 16 distinct disks; keep spares for repair
    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=9, disks_per_node=2)
    yield c
    c.close()


def blob_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_put_get_roundtrip(cluster, rng):
    data = blob_bytes(rng, 300_000)
    loc = cluster.access.put(data)
    assert loc.size == len(data)
    assert cluster.access.get(loc) == data


def test_ranged_get(cluster, rng):
    data = blob_bytes(rng, 1_000_000)
    loc = cluster.access.put(data)
    assert cluster.access.get(loc, 0, 10) == data[:10]
    assert cluster.access.get(loc, 567_890, 1234) == data[567_890 : 567_890 + 1234]
    assert cluster.access.get(loc, len(data) - 7, 7) == data[-7:]


def test_multi_blob_object(cluster, rng):
    """Objects above MAX_BLOB_SIZE split into multiple blobs."""
    data = blob_bytes(rng, 9_000_000)  # 3 blobs at 4 MiB max
    loc = cluster.access.put(data)
    assert len(loc.blobs) == 3
    assert cluster.access.get(loc) == data
    # cross-blob-boundary range
    assert cluster.access.get(loc, 4_194_000, 1000) == data[4_194_000:4_195_000]


def test_code_mode_selection():
    assert select_code_mode(1000) == CodeMode.EC3P3
    assert select_code_mode(500_000) == CodeMode.EC6P3
    assert select_code_mode(3_000_000) == CodeMode.EC12P4


def test_location_signature_tamper(cluster, rng):
    loc = cluster.access.put(blob_bytes(rng, 1000))
    s = loc.to_json()
    tampered = Location.from_json(s)
    tampered.size = 999999
    with pytest.raises(LocationError):
        cluster.access.get(tampered)


def test_get_with_lost_shards_reconstructs(cluster, rng):
    """Kill shards up to the parity budget; GET must still return the data and
    queue repair messages (stream_get.go:427 reconstruct-on-read analog)."""
    data = blob_bytes(rng, 2_000_000)  # EC12P4
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    blob = loc.blobs[0]
    vol = cluster.cm.get_volume(blob.vid)
    for idx in (0, 5, 13, 15):  # 2 data + 2 parity... idx 13,15 parity; 0,5 data
        unit = vol.units[idx]
        cluster.nodes[unit.node_id].lose_shard(unit.vuid, blob.bid)
    assert cluster.access.get(loc) == data
    assert cluster.proxy.topics["shard_repair"].lag("scheduler") > 0


def test_get_beyond_parity_budget_fails(cluster, rng):
    data = blob_bytes(rng, 200_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC3P3)
    blob = loc.blobs[0]
    vol = cluster.cm.get_volume(blob.vid)
    for idx in (0, 1, 3, 4):  # 4 missing > M=3
        unit = vol.units[idx]
        cluster.nodes[unit.node_id].lose_shard(unit.vuid, blob.bid)
    with pytest.raises(Exception):
        cluster.access.get(loc)


def test_background_shard_repair(cluster, rng):
    """Repair messages drive the worker to rebuild missing shards in place."""
    data = blob_bytes(rng, 2_000_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    blob = loc.blobs[0]
    vol = cluster.cm.get_volume(blob.vid)
    killed = [2, 7]
    for idx in killed:
        unit = vol.units[idx]
        cluster.nodes[unit.node_id].lose_shard(unit.vuid, blob.bid)
    # reading triggers reconstruction + repair message
    assert cluster.access.get(loc) == data
    stats = cluster.run_background_once()
    assert stats["tasks_ran"] >= 1
    # the shards must be physically back on their nodes
    for idx in killed:
        unit = vol.units[idx]
        shard = cluster.nodes[unit.node_id].get_shard(unit.vuid, blob.bid)
        assert len(shard) > 0
    # and the stripe verifies end-to-end again without reconstruct
    assert cluster.access.get(loc) == data


def test_disk_repair_migrates_shards(cluster, rng):
    """Breaking a disk migrates its stripe positions to a healthy disk
    (disk_repairer + migrate state machine analog)."""
    data = blob_bytes(rng, 2_000_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    blob = loc.blobs[0]
    vol = cluster.cm.get_volume(blob.vid)
    victim_unit = vol.units[3]
    old_vuid = victim_unit.vuid
    cluster.cm.set_disk_status(victim_unit.disk_id, DISK_BROKEN)

    stats = cluster.run_background_once()
    assert stats["disk_tasks"] == 1 and stats["tasks_ran"] >= 1

    fresh = cluster.cm.get_volume(blob.vid)
    new_unit = fresh.units[3]
    assert new_unit.disk_id != victim_unit.disk_id or new_unit.vuid != old_vuid
    assert new_unit.epoch == 2
    # data readable through the re-homed unit
    assert cluster.access.get(loc) == data
    node = cluster.nodes[new_unit.node_id]
    assert len(node.get_shard(new_unit.vuid, blob.bid)) > 0


def test_delete_punches_shards(cluster, rng):
    data = blob_bytes(rng, 500_000)
    loc = cluster.access.put(data)
    blob = loc.blobs[0]
    vol = cluster.cm.get_volume(blob.vid)
    cluster.access.delete(loc)
    stats = cluster.run_background_once()
    assert stats["deletes"] == 1
    unit = vol.units[0]
    with pytest.raises(Exception):
        cluster.nodes[unit.node_id].get_shard(unit.vuid, blob.bid)


def test_quorum_failure_raises(tmp_path, rng):
    """Too few healthy nodes -> PUT fails its quorum."""
    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=1)
    try:
        # remove 3 nodes: EC6P3 needs put_quorum=8 of 9 shards on 9 distinct disks
        with pytest.raises(Exception):
            for n in (4, 5, 6):
                del c.nodes[n]
            c.access.put(blob_bytes(rng, 500_000), code_mode=CodeMode.EC6P3)
    finally:
        c.close()


def test_clustermgr_persistence(tmp_path, rng):
    """WAL + snapshot restore: volumes and scopes survive restart."""
    from chubaofs_tpu_torch.blobstore.clustermgr import ClusterMgr

    cm1 = ClusterMgr(str(tmp_path / "cm"))
    cm1.register_disk(1, node_id=1)
    cm1.register_disk(2, node_id=1)
    cm1.register_disk(3, node_id=2)
    cm1.register_disk(4, node_id=2)
    cm1.register_disk(5, node_id=3)
    cm1.register_disk(6, node_id=3)
    vol = cm1.create_volume(CodeMode.EC3P3)
    a, b = cm1.alloc_scope("bid", 10)
    cm1.checkpoint()
    cm1.set_config("balance", "on")
    cm1.close()

    cm2 = ClusterMgr(str(tmp_path / "cm"))
    assert cm2.get_volume(vol.vid).code_mode == int(CodeMode.EC3P3)
    a2, _ = cm2.alloc_scope("bid", 1)
    assert a2 == b + 1
    assert cm2.get_config("balance") == "on"
    cm2.close()


def test_vuid_roundtrip():
    v = make_vuid(1234, 15, 3)
    assert parse_vuid(v) == (1234, 15, 3)


def test_blobnode_restart_recovers_index(tmp_path, rng):
    """Chunk index WAL replay: shards readable after reopen."""
    from chubaofs_tpu_torch.blobstore.blobnode import BlobNode

    roots = [str(tmp_path / "d0")]
    n1 = BlobNode(node_id=1, disk_roots=roots)
    n1.create_vuid(make_vuid(1, 0))
    payload = blob_bytes(rng, 100_000)
    n1.put_shard(make_vuid(1, 0), 42, payload)
    n1.close()

    n2 = BlobNode(node_id=1, disk_roots=roots)
    assert n2.get_shard(make_vuid(1, 0), 42) == payload
    assert n2.get_shard(make_vuid(1, 0), 42, offset=1000, size=500) == payload[1000:1500]


def test_chunk_crc_detects_corruption(tmp_path, rng):
    """Flipping a byte in the datafile surfaces as a CRC error on read."""
    from chubaofs_tpu_torch.blobstore.blobnode import BlobNode
    from chubaofs_tpu_torch.utils.crc32block import CrcError

    n1 = BlobNode(node_id=1, disk_roots=[str(tmp_path / "d0")])
    vuid = make_vuid(1, 0)
    n1.create_vuid(vuid)
    n1.put_shard(vuid, 7, blob_bytes(rng, 50_000))
    chunk = n1._chunk(vuid)
    with open(chunk._data_path, "r+b") as f:
        f.seek(chunk.shards[7].offset + 40 + 100)
        orig = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([orig[0] ^ 0xFF]))
    with pytest.raises(CrcError):
        n1.get_shard(vuid, 7)


def test_degraded_get_hedges_past_slow_blobnode(cluster, rng):
    """One SLOW (not dead) blobnode must not set the degraded-GET latency
    floor: the gather keeps t.read_hedge speculative reads in flight and
    returns when N shards arrive, abandoning the straggler (get_quorum
    wiring; ref stream_get.go:427-530 races reconstruct against laggards)."""
    import time as _time

    data = blob_bytes(rng, 2_000_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    blob = loc.blobs[0]
    vol = cluster.cm.get_volume(blob.vid)

    # kill one data shard so the GET takes the degraded path
    unit = vol.units[3]
    cluster.nodes[unit.node_id].lose_shard(unit.vuid, blob.bid)

    # wedge ANOTHER data shard's node: reads of it hang 30s. EC12P4 hedges
    # N + ceil(M/2) = 14 of 16 reads concurrently, so the stripe completes
    # from the other 14 shards without ever waiting on the wedged one.
    slow_unit = vol.units[7]
    slow_node = cluster.nodes[slow_unit.node_id]
    orig_get = slow_node.get_shard

    def slow_get(vuid, bid, offset=0, size=None):
        if bid == blob.bid and vuid == slow_unit.vuid:
            _time.sleep(30)
        return orig_get(vuid, bid, offset=offset, size=size)

    slow_node.get_shard = slow_get
    try:
        t0 = _time.perf_counter()
        assert cluster.access.get(loc) == data
        elapsed = _time.perf_counter() - t0
        assert elapsed < 10, f"GET waited on the wedged blobnode ({elapsed:.1f}s)"
    finally:
        slow_node.get_shard = orig_get


def test_read_hedge_bounds():
    from chubaofs_tpu_torch.codec.codemode import get_tactic

    t = get_tactic(CodeMode.EC12P4)
    assert t.read_hedge == 14  # N + ceil(M/2), within N+M
    assert get_tactic(CodeMode.EC6P3).read_hedge == 8
    # an explicit get_quorum bounds the hedge
    from chubaofs_tpu_torch.codec.codemode import Tactic

    assert Tactic(4, 2, 0, 1, put_quorum=5, get_quorum=5).read_hedge == 5
    assert Tactic(4, 2, 0, 1, put_quorum=5, get_quorum=99).read_hedge == 6


def test_repair_task_dedup(cluster, rng):
    """N degraded GETs of one stripe produce ONE open repair task."""
    data = blob_bytes(rng, 2_000_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    blob = loc.blobs[0]
    vol = cluster.cm.get_volume(blob.vid)
    unit = vol.units[2]
    cluster.nodes[unit.node_id].lose_shard(unit.vuid, blob.bid)
    for _ in range(4):
        assert cluster.access.get(loc) == data  # each emits a repair message
    cluster.scheduler.poll_repair_topic()
    open_tasks = cluster.scheduler.tasks(kind="shard_repair")
    assert len(open_tasks) == 1


def test_migrate_respects_volume_disk_invariant(cluster, rng):
    """The migrated unit must land on a disk hosting no other unit of the volume."""
    data = blob_bytes(rng, 2_000_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    blob = loc.blobs[0]
    vol = cluster.cm.get_volume(blob.vid)
    victim_disk = vol.units[5].disk_id  # snapshot: units mutate in place on migrate
    others = {u.disk_id for u in vol.units if u.index != 5}
    cluster.cm.set_disk_status(victim_disk, DISK_BROKEN)
    cluster.run_background_once()
    fresh = cluster.cm.get_volume(blob.vid)
    assert fresh.units[5].disk_id not in others
    assert fresh.units[5].disk_id != victim_disk
    assert cluster.access.get(loc) == data


def test_drop_healthy_disk_copies_without_reconstruct(cluster, rng):
    """DISK_DROP of a healthy disk must read-copy the source shard."""
    data = blob_bytes(rng, 500_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC6P3)
    blob = loc.blobs[0]
    vol = cluster.cm.get_volume(blob.vid)
    victim_disk = vol.units[1].disk_id  # snapshot before in-place re-home
    cluster.scheduler.drop_disk(victim_disk)
    while cluster.worker.run_once():
        pass
    fresh = cluster.cm.get_volume(blob.vid)
    assert fresh.units[1].disk_id != victim_disk
    assert cluster.access.get(loc) == data


def test_chunk_reput_replaces_record(tmp_path, rng):
    """Re-putting a bid serves the new payload and keeps one index entry."""
    from chubaofs_tpu_torch.blobstore.blobnode import BlobNode

    n1 = BlobNode(node_id=1, disk_roots=[str(tmp_path / "d0")])
    vuid = make_vuid(9, 0)
    n1.create_vuid(vuid)
    n1.put_shard(vuid, 5, b"old" * 1000)
    n1.put_shard(vuid, 5, b"new" * 1000)
    assert n1.get_shard(vuid, 5) == b"new" * 1000
    assert len(n1.list_shards(vuid)) == 1
    # survives reopen (the shard metadb replays to the newest record)
    n1.close()
    n2 = BlobNode(node_id=1, disk_roots=[str(tmp_path / "d0")])
    assert n2.get_shard(vuid, 5) == b"new" * 1000


def test_checkpoint_wal_rotation(tmp_path):
    """Checkpoint folds the WAL into the snapshot; restart applies each op
    exactly once (kvstore-backed persistence, common/kvstore role)."""
    from chubaofs_tpu_torch.blobstore.clustermgr import ClusterMgr

    cm = ClusterMgr(str(tmp_path / "cm"))
    cm.register_disk(1, node_id=1)
    cm.checkpoint()
    assert cm._db.scan(prefix=b"w/") == []  # folded into the snapshot
    cm.alloc_scope("bid", 5)
    assert len(cm._db.scan(prefix=b"w/")) == 1  # post-checkpoint op in the WAL
    cm.close()

    cm2 = ClusterMgr(str(tmp_path / "cm"))
    first, _ = cm2.alloc_scope("bid", 1)
    assert first == 6  # 5 allocated exactly once, not replayed twice
    cm2.close()


def test_clustermgr_legacy_migration(tmp_path):
    """Pre-kvstore snapshot.json + wal-N.jsonl dirs import cleanly."""
    import json
    import os
    from chubaofs_tpu_torch.blobstore.clustermgr import ClusterMgr

    d = tmp_path / "cm"
    os.makedirs(d)
    legacy = ClusterMgr(None)  # build a state in memory to snapshot
    legacy.register_disk(1, node_id=1)
    with open(d / "snapshot.json", "w") as f:
        json.dump({"wal_id": 3, "state": legacy.snapshot()}, f)
    with open(d / "wal-3.jsonl", "w") as f:
        f.write(json.dumps(["alloc_scope", {"name": "bid", "count": 4}]) + "\n")

    cm = ClusterMgr(str(d))
    assert 1 in cm.disks
    first, _ = cm.alloc_scope("bid", 1)
    assert first == 5  # the 4 legacy WAL allocations replayed exactly once
    assert not os.path.exists(d / "wal-3.jsonl")
    cm.close()


def test_volume_rotation_on_full_chunks(tmp_path, rng):
    """Full chunks retire the volume and PUT rotates to a fresh one."""
    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=2)
    try:
        # shrink chunks so a few puts fill them
        for node in c.nodes.values():
            for disk in node.disks.values():
                disk.chunk_size = 300_000
        locs = []
        for i in range(6):  # each blob ~67KB/shard + framing; 300KB chunks hold 4
            data = blob_bytes(rng, 400_000)
            locs.append((c.access.put(data, code_mode=CodeMode.EC6P3), data))
        vids = {loc.blobs[0].vid for loc, _ in locs}
        assert len(vids) >= 2, "must have rotated to a second volume"
        for loc, data in locs:
            assert c.access.get(loc) == data
    finally:
        c.close()


def test_failed_disk_repair_retried_after_failure(cluster, rng):
    """A disk-repair task that exhausts retries is re-created while the disk
    stays broken (no permanent under-replication)."""
    from chubaofs_tpu_torch.blobstore import scheduler as sched_mod

    data = blob_bytes(rng, 500_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC6P3)
    vol = cluster.cm.get_volume(loc.blobs[0].vid)
    victim_disk = vol.units[0].disk_id
    cluster.cm.set_disk_status(victim_disk, DISK_BROKEN)

    # poison the worker so every attempt fails
    orig = cluster.worker._migrate_disk
    cluster.worker._migrate_disk = \
        lambda task, lease=None: (_ for _ in ()).throw(RuntimeError("net down"))
    for _ in range(4):
        cluster.run_background_once()
    failed = [t for t in cluster.scheduler.tasks(sched_mod.KIND_DISK_REPAIR)
              if t.state == sched_mod.TASK_FAILED]
    assert failed and "net down" in failed[0].error

    # heal the worker: a new task is created and succeeds
    cluster.worker._migrate_disk = orig
    cluster.run_background_once()
    cluster.run_background_once()
    fresh = cluster.cm.get_volume(loc.blobs[0].vid)
    assert fresh.units[0].disk_id != victim_disk
    assert cluster.access.get(loc) == data


def test_poisoned_task_does_not_stall_background(cluster, rng):
    """An unrecoverable stripe fails its task; deletes still run that tick."""
    data = blob_bytes(rng, 300_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC6P3)
    # fabricate a repair message for a stripe that cannot be gathered
    cluster.proxy.send_shard_repair(loc.blobs[0].vid, 999999, [0], "bogus")
    loc2 = cluster.access.put(blob_bytes(rng, 1000))
    cluster.access.delete(loc2)
    stats = cluster.run_background_once()
    assert stats["deletes"] == 1  # deleter ran despite the poisoned repair task


def test_balancer_moves_unit_to_fresh_disks(tmp_path, rng):
    """A new empty node draws load: check_balance creates a single-unit move
    (scheduler/balancer.go analog), gated by SWITCH_BALANCE, and the moved
    data keeps serving."""
    from chubaofs_tpu_torch.blobstore.blobnode import BlobNode
    from chubaofs_tpu_torch.blobstore.scheduler import KIND_BALANCE, TASK_FINISHED
    from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_BALANCE

    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=2)
    try:
        locs = [c.access.put(blob_bytes(rng, 500_000)) for _ in range(4)]
        # a brand-new node registers with empty disks -> imbalance appears
        node = BlobNode(node_id=77, disk_roots=[
            str(tmp_path / "n77" / "d0"), str(tmp_path / "n77" / "d1")])
        c.nodes[77] = node
        for disk_id in node.disks:
            c.cm.register_disk(disk_id, node_id=77, az=0)

        c.scheduler.switches.set(SWITCH_BALANCE, False)
        assert c.scheduler.check_balance(min_gap=1) is None  # gated off
        c.scheduler.switches.set(SWITCH_BALANCE, True)

        task = c.scheduler.check_balance(min_gap=1)
        assert task is not None and task.kind == KIND_BALANCE
        # only one rebalance in flight
        assert c.scheduler.check_balance(min_gap=1) is None

        src_disk = task.disk_id
        chunks_before = c.cm.disks[src_disk].chunk_count
        while c.worker.run_once():
            pass
        assert c.scheduler.tasks(KIND_BALANCE)[0].state == TASK_FINISHED
        # the unit left the overloaded disk for an emptier one... (the disk
        # may still hold OTHER volumes' chunks: the proxy grants a rotating
        # set of active volumes, and one balance task moves one unit)
        vol = c.cm.get_volume(task.vid)
        assert all(u.disk_id != src_disk for u in vol.units) or \
            sum(1 for u in vol.units if u.disk_id == src_disk) < 2
        assert c.cm.disks[src_disk].chunk_count < chunks_before
        # ...no two units of the volume share a disk, and data reads clean
        assert len({u.disk_id for u in vol.units}) == len(vol.units)
        for loc in locs:
            assert len(c.access.get(loc)) == 500_000
    finally:
        c.close()


def test_unit_move_keeps_chunk_counts_consistent(tmp_path, rng):
    from chubaofs_tpu_torch.blobstore.blobnode import BlobNode

    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=2)
    try:
        c.access.put(blob_bytes(rng, 400_000))
        node = BlobNode(node_id=88, disk_roots=[str(tmp_path / "n88" / "d0")])
        c.nodes[88] = node
        for disk_id in node.disks:
            c.cm.register_disk(disk_id, node_id=88, az=0)
        total_before = sum(d.chunk_count for d in c.cm.disks.values())
        task = c.scheduler.check_balance(min_gap=1)
        assert task is not None
        while c.worker.run_once():
            pass
        assert sum(d.chunk_count for d in c.cm.disks.values()) == total_before
    finally:
        c.close()


def test_balance_retry_after_partial_move_heals(tmp_path, rng):
    """A balance retry that finds the mapping already moved must not declare
    victory over a degraded stripe: it sweeps the volume into the repair
    plane and the stripe heals."""
    from chubaofs_tpu_torch.blobstore.blobnode import BlobNode

    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=2)
    try:
        loc = c.access.put(blob_bytes(rng, 500_000))
        vid, bid = loc.blobs[0].vid, loc.blobs[0].bid
        node = BlobNode(node_id=99, disk_roots=[str(tmp_path / "n99" / "d0")])
        c.nodes[99] = node
        for disk_id in node.disks:
            c.cm.register_disk(disk_id, node_id=99, az=0)
        task = c.scheduler.check_balance(min_gap=1)
        assert task is not None
        # simulate a crash mid-move: the mapping re-homes but no data copies
        vol = c.cm.get_volume(task.vid)
        unit = next(u for u in vol.units if u.disk_id == task.disk_id)
        moved_index = unit.index
        dest = c.worker._dest_for(vol, task.disk_id)
        c.cm.update_volume_unit(task.vid, unit.index, dest)

        # the retried task finds the unit gone and feeds the repair plane
        assert c.worker.run_once()
        assert c.proxy.topics["shard_repair"].lag("scheduler") > 0
        c.run_background_once()  # repair heals the missing position
        new_unit = c.cm.get_volume(task.vid).units[moved_index]
        got = c.nodes[new_unit.node_id].get_shard(new_unit.vuid, bid)
        assert len(got) > 0
        assert len(c.access.get(loc)) == 500_000
    finally:
        c.close()


def test_balance_frees_source_chunk(tmp_path, rng):
    """A balance move must reclaim the source disk's chunk file, not just the
    logical count: the old vuid's chunk is destroyed after the re-home."""
    from chubaofs_tpu_torch.blobstore.blobnode import BlobNode, NoSuchShard

    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=2)
    try:
        loc = c.access.put(blob_bytes(rng, 500_000))
        node = BlobNode(node_id=55, disk_roots=[str(tmp_path / "n55" / "d0")])
        c.nodes[55] = node
        for disk_id in node.disks:
            c.cm.register_disk(disk_id, node_id=55, az=0)
        task = c.scheduler.check_balance(min_gap=1)
        assert task is not None
        vol = c.cm.get_volume(task.vid)
        old_unit = next(u for u in vol.units if u.disk_id == task.disk_id)
        old_vuid, old_node = old_unit.vuid, old_unit.node_id
        while c.worker.run_once():
            pass
        # pinned destination honored, old chunk physically gone
        new_unit = c.cm.get_volume(task.vid).units[old_unit.index]
        assert new_unit.disk_id == task.dest_disk_id
        with pytest.raises(NoSuchShard):
            c.nodes[old_node].get_shard(old_vuid, loc.blobs[0].bid)
        assert len(c.access.get(loc)) == 500_000
    finally:
        c.close()


def test_migration_carries_tombstones(tmp_path, rng):
    """A unit move must not resurrect a bid whose delete tombstone lived only
    on the moved unit: the tombstone travels with it."""
    from chubaofs_tpu_torch.blobstore.blobnode import BlobNode

    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=2)
    try:
        loc = c.access.put(blob_bytes(rng, 500_000))
        vid, bid = loc.blobs[0].vid, loc.blobs[0].bid
        vol = c.cm.get_volume(vid)
        node = BlobNode(node_id=66, disk_roots=[str(tmp_path / "n66" / "d0")])
        c.nodes[66] = node
        for disk_id in node.disks:
            c.cm.register_disk(disk_id, node_id=66, az=0)
        task = c.scheduler.check_balance(min_gap=1)
        assert task is not None and task.vid == vid
        unit = next(u for u in vol.units if u.disk_id == task.disk_id)
        # delete applied ONLY at the about-to-move unit (others unreachable)
        c.nodes[unit.node_id].mark_delete_shard(unit.vuid, bid)
        c.nodes[unit.node_id].delete_shard(unit.vuid, bid)
        while c.worker.run_once():
            pass
        new_unit = c.cm.get_volume(vid).units[unit.index]
        new_node = c.nodes[new_unit.node_id]
        # the bid was NOT resurrected at the destination, and the tombstone
        # survived the move for the inspector's partial-delete protocol
        with pytest.raises(Exception):
            new_node.get_shard(new_unit.vuid, bid)
        assert new_node.has_tombstone(new_unit.vuid, bid)
    finally:
        c.close()


def test_scheduler_tasks_survive_restart(tmp_path, rng):
    """Open tasks persist in the clustermgr KV and reload on a scheduler
    restart; in-flight (WORKING) tasks re-queue (migrate.go:346-347 analog)."""
    from chubaofs_tpu_torch.blobstore.scheduler import (
        KIND_SHARD_REPAIR, TASK_FINISHED, TASK_PREPARED, Scheduler)

    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=9, disks_per_node=2)
    try:
        data = blob_bytes(rng, 2_000_000)
        loc = c.access.put(data, code_mode=CodeMode.EC12P4)
        blob = loc.blobs[0]
        vol = c.cm.get_volume(blob.vid)
        unit = vol.units[2]
        c.nodes[unit.node_id].lose_shard(unit.vuid, blob.bid)
        c.proxy.send_shard_repair(vol.vid, blob.bid, [2], "test")
        c.scheduler.poll_repair_topic()
        task = c.scheduler.acquire_task()  # WORKING, then the "worker dies"
        assert task is not None

        sched2 = Scheduler(c.cm, c.proxy, c.nodes, codec=c.codec)
        reloaded = {t.task_id: t for t in sched2.tasks(KIND_SHARD_REPAIR)}
        assert task.task_id in reloaded
        assert reloaded[task.task_id].state == TASK_PREPARED  # re-queued

        # the restarted scheduler's worker completes the repair
        from chubaofs_tpu_torch.blobstore.scheduler import RepairWorker

        w2 = RepairWorker(sched2, c.nodes, codec=c.codec)
        while w2.run_once():
            pass
        assert sched2.tasks(KIND_SHARD_REPAIR)[0].state == TASK_FINISHED
        assert len(c.nodes[unit.node_id].get_shard(unit.vuid, blob.bid)) > 0

        # terminal tasks leave the persisted table: a third scheduler is empty
        sched3 = Scheduler(c.cm, c.proxy, c.nodes, codec=c.codec)
        assert sched3.tasks(KIND_SHARD_REPAIR) == []
    finally:
        c.close()


def test_task_ids_never_reissued_after_restart(tmp_path, rng):
    """The id counter persists independently of open tasks: a restart after
    everything finished must not reuse ids (the recordlog keys on them), and
    finished tasks leave no residue in the config KV."""
    from chubaofs_tpu_torch.blobstore.scheduler import Scheduler

    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=9, disks_per_node=2)
    try:
        loc = c.access.put(blob_bytes(rng, 300_000))
        vol = c.cm.get_volume(loc.blobs[0].vid)
        unit = vol.units[0]
        c.nodes[unit.node_id].lose_shard(unit.vuid, loc.blobs[0].bid)
        c.proxy.send_shard_repair(vol.vid, loc.blobs[0].bid, [0], "t")
        c.run_background_once()  # task t1 created and FINISHED
        done = c.scheduler.tasks()
        assert done and all(t.state == "finished" for t in done)
        used_ids = {t.task_id for t in done}

        sched2 = Scheduler(c.cm, c.proxy, c.nodes, codec=c.codec)
        assert sched2.tasks() == []  # no tombstone residue reloads
        assert not any(k.startswith("task/") for k in c.cm.config)
        fresh = sched2.drop_disk(unit.disk_id)
        assert fresh.task_id not in used_ids
    finally:
        c.close()
