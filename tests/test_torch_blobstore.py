"""The port's blobstore held against the JAX package's, byte for byte.

A JAX MiniCluster and a port MiniCluster(device="cpu") get the same seeded
payloads and the same faults. Placement, bid allocation and Location signing
are deterministic, so the two clusters must agree on everything: the
Locations (code mode, blobs, sizes, signature), every stored shard, what each
GET returns (healthy, ranged and degraded), what the repair worker rebuilds,
and the on-disk state, which each package must open and serve after the other
wrote it. GF(2^8) math is exact: every comparison has tolerance 0.
"""

import numpy as np
import pytest
import torch

from chubaofs_tpu.blobstore.access import Location as JLocation
from chubaofs_tpu.blobstore.blobnode import NoSuchShard as JNoSuchShard
from chubaofs_tpu.blobstore.cluster import MiniCluster as JMiniCluster
from chubaofs_tpu.codec.codemode import get_tactic as j_get_tactic
from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.access import Location, LocationError
from chubaofs_tpu_torch.blobstore.blobnode import BlobNode, NoSuchShard
from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
from chubaofs_tpu_torch.blobstore.clustermgr import DISK_BROKEN, ClusterMgr
from chubaofs_tpu_torch.codec.codemode import CodeMode

CPU = "cpu"
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture
def pair(tmp_path):
    # EC12P4 places 16 units on 16 distinct disks; keep spares for repair
    j = JMiniCluster(str(tmp_path / "jax"), n_nodes=9, disks_per_node=2)
    t = MiniCluster(str(tmp_path / "port"), n_nodes=9, disks_per_node=2, device=CPU)
    yield j, t
    t.close()
    j.close()


def blob_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def stored_stripe(cluster, blob) -> np.ndarray:
    """Every shard of one blob, read back from the blobnodes that hold it."""
    vol = cluster.cm.get_volume(blob.vid)
    return np.stack([np.frombuffer(cluster.nodes[u.node_id].get_shard(u.vuid, blob.bid), np.uint8)
                     for u in vol.units])


def jax_stripe(j, mode, payload: bytes) -> np.ndarray:
    """The JAX package's encode of one blob, in the access gateway's layout
    (zero-padded rows of shard_size bytes)."""
    t = j_get_tactic(mode)
    shard_len = t.shard_size(len(payload))
    mat = np.zeros((t.N, shard_len), np.uint8)
    mat.reshape(-1)[: len(payload)] = np.frombuffer(payload, np.uint8)
    return np.asarray(j.codec.encode_tactic(t, mat).result(timeout=120))


def blob_payloads(loc, data: bytes):
    off = 0
    for b in loc.blobs:
        yield b, data[off:off + b.size]
        off += b.size


def break_disk(cluster, disk_id: int) -> None:
    """Media loss of a whole disk: every shard on it is gone and the
    clustermgr marks it broken."""
    for vol in cluster.cm.volumes.values():
        for u in vol.units:
            if u.disk_id != disk_id:
                continue
            node = cluster.nodes[u.node_id]
            try:
                metas = node.list_shards(u.vuid)
            except (NoSuchShard, JNoSuchShard):  # a unit whose chunk was never written
                continue
            for meta in metas:
                node.lose_shard(u.vuid, meta.bid)
    cluster.cm.set_disk_status(disk_id, DISK_BROKEN)


RANGES = [(0, 10), (567, 1234), (-7, 7)]


def check_reads(j, t, jl, tl, data):
    assert t.access.get(tl) == data == j.access.get(jl)
    for off, ln in RANGES:
        off %= len(data)
        ln = min(ln, len(data) - off)
        assert t.access.get(tl, off, ln) == data[off:off + ln] == j.access.get(jl, off, ln)


@pytest.mark.parametrize("size", [1000, 100_000, 300_000, 2_000_000, 5_000_000])
def test_put_locations_stripes_and_gets_match_jax(pair, rng, size):
    j, t = pair
    data = blob_bytes(rng, size)
    jl, tl = j.access.put(data), t.access.put(data)
    assert tl.to_json() == jl.to_json()  # code mode, blobs, sizes, crc, signature
    assert len(tl.blobs) == -(-size // (4 << 20))
    for blob, payload in blob_payloads(tl, data):
        st = stored_stripe(t, blob)
        assert np.array_equal(st, stored_stripe(j, blob))
        assert np.array_equal(st, jax_stripe(j, tl.code_mode, payload))
    check_reads(j, t, jl, tl, data)


@pytest.mark.parametrize("mode,lost", [
    (CodeMode.EC12P4, [3]), (CodeMode.EC12P4, [0, 13]), (CodeMode.EC12P4, [0, 5, 13]),
    (CodeMode.EC12P4, [0, 5, 13, 15]), (CodeMode.EC6P3, [1, 4, 7]), (CodeMode.EC3P3, [0, 1, 2]),
])
def test_degraded_gets_match_jax(pair, rng, mode, lost):
    """1 to m broken disks under one stripe: the GETs decode around them."""
    j, t = pair
    data = blob_bytes(rng, 1_500_000)
    jl, tl = j.access.put(data, code_mode=mode), t.access.put(data, code_mode=mode)
    assert tl.to_json() == jl.to_json()
    vol = t.cm.get_volume(tl.blobs[0].vid)
    for idx in lost:
        break_disk(t, vol.units[idx].disk_id)
        break_disk(j, vol.units[idx].disk_id)
    check_reads(j, t, jl, tl, data)


def test_worker_shard_repair_matches_jax(pair, rng):
    j, t = pair
    data = blob_bytes(rng, 2_000_000)
    jl, tl = (c.access.put(data, code_mode=CodeMode.EC12P4) for c in (j, t))
    blob = tl.blobs[0]
    golden = stored_stripe(t, blob)
    vol = t.cm.get_volume(blob.vid)
    for c, loc in ((j, jl), (t, tl)):
        for idx in (2, 7, 14):
            u = vol.units[idx]
            c.nodes[u.node_id].lose_shard(u.vuid, blob.bid)
        assert c.access.get(loc) == data  # the degraded read queues repair messages
        assert c.run_background_once()["tasks_ran"] >= 1
    assert np.array_equal(stored_stripe(t, blob), golden)
    assert np.array_equal(stored_stripe(j, blob), golden)


def test_disk_repair_migration_matches_jax(pair, rng):
    j, t = pair
    data = blob_bytes(rng, 2_000_000)
    jl, tl = (c.access.put(data, code_mode=CodeMode.EC12P4) for c in (j, t))
    blob = tl.blobs[0]
    golden = stored_stripe(t, blob)
    victim = t.cm.get_volume(blob.vid).units[3].disk_id
    for c in (j, t):
        break_disk(c, victim)
        assert c.run_background_once()["disk_tasks"] == 1
    jv, tv = j.cm.get_volume(blob.vid), t.cm.get_volume(blob.vid)
    assert [(u.vuid, u.disk_id, u.epoch) for u in tv.units] == \
        [(u.vuid, u.disk_id, u.epoch) for u in jv.units]
    assert tv.units[3].disk_id != victim
    assert np.array_equal(stored_stripe(t, blob), golden)
    assert np.array_equal(stored_stripe(j, blob), golden)
    check_reads(j, t, jl, tl, data)


def test_lrc_local_repair_matches_jax(tmp_path, rng):
    """EC6P3L3 across 3 AZs: a lost data shard is rebuilt from its AZ's
    local stripe on the read path, and by the worker."""
    j = JMiniCluster(str(tmp_path / "jax"), n_nodes=6, disks_per_node=2, azs=3)
    t = MiniCluster(str(tmp_path / "port"), n_nodes=6, disks_per_node=2, azs=3, device=CPU)
    try:
        data = blob_bytes(rng, 1_000_000)
        jl, tl = (c.access.put(data, code_mode=CodeMode.EC6P3L3) for c in (j, t))
        assert tl.to_json() == jl.to_json()
        blob = tl.blobs[0]
        golden = stored_stripe(t, blob)
        assert np.array_equal(golden, stored_stripe(j, blob))
        assert np.array_equal(golden, jax_stripe(j, tl.code_mode, data))
        u = t.cm.get_volume(blob.vid).units[1]
        for c in (j, t):
            c.nodes[u.node_id].lose_shard(u.vuid, blob.bid)
        check_reads(j, t, jl, tl, data)
        for c in (j, t):
            c.run_background_once()
        assert np.array_equal(stored_stripe(t, blob), golden)
        assert np.array_equal(stored_stripe(j, blob), golden)
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_on_disk_state_opens_across_packages(tmp_path, rng, writer):
    """Clustermgr KV/WAL, proxy data, chunk files with their shard index and
    the signed Locations written by one package are served by the other."""
    root = str(tmp_path / "cluster")
    make = {"jax": lambda: JMiniCluster(root, n_nodes=9, disks_per_node=2),
            "port": lambda: MiniCluster(root, n_nodes=9, disks_per_node=2, device=CPU)}
    reader = "port" if writer == "jax" else "jax"
    loc_cls = {"jax": JLocation, "port": Location}
    w = make[writer]()
    objs = []
    for size in (1000, 300_000, 2_000_000):
        data = blob_bytes(rng, size)
        objs.append((data, w.access.put(data).to_json()))
    vols = {vid: [(u.vuid, u.disk_id, u.epoch) for u in v.units] for vid, v in w.cm.volumes.items()}
    w.close()

    r = make[reader]()
    try:
        assert {vid: [(u.vuid, u.disk_id, u.epoch) for u in v.units]
                for vid, v in r.cm.volumes.items()} == vols
        for data, s in objs:
            assert r.access.get(loc_cls[reader].from_json(s)) == data
        tampered = loc_cls[reader].from_json(objs[0][1])
        tampered.size += 1
        with pytest.raises(Exception):
            r.access.get(tampered)
        more = blob_bytes(rng, 700_000)
        more_loc = r.access.put(more).to_json()
    finally:
        r.close()

    w = make[writer]()  # and back: the writer reads what the reader added
    try:
        assert w.access.get(loc_cls[writer].from_json(more_loc)) == more
    finally:
        w.close()


def test_port_clustermgr_and_blobnode_open_jax_files(tmp_path, rng):
    """The port's ClusterMgr and BlobNodes, on their own, open the files the
    JAX package wrote: same volumes, same shard index, same bytes."""
    root = tmp_path / "cluster"
    j = JMiniCluster(str(root), n_nodes=9, disks_per_node=2)
    data = blob_bytes(rng, 2_000_000)
    jl = j.access.put(data, code_mode=CodeMode.EC12P4)
    blob = jl.blobs[0]
    golden = stored_stripe(j, blob)
    j.close()

    cm = ClusterMgr(str(root / "cm"))
    nodes = {n: BlobNode(node_id=n, disk_roots=[str(root / f"node{n}" / f"disk{d}") for d in range(2)])
             for n in range(1, 10)}
    try:
        vol = cm.get_volume(blob.vid)
        assert vol.code_mode == int(CodeMode.EC12P4)
        got = np.stack([np.frombuffer(nodes[u.node_id].get_shard(u.vuid, blob.bid), np.uint8)
                        for u in vol.units])
        assert np.array_equal(got, golden)
        assert [m.bid for m in nodes[vol.units[0].node_id].list_shards(vol.units[0].vuid)] == [blob.bid]
    finally:
        for n in nodes.values():
            n.close()
        cm.close()


def test_port_refuses_a_tampered_jax_location(pair, rng):
    j, t = pair
    data = blob_bytes(rng, 5000)
    jl, tl = j.access.put(data), t.access.put(data)
    forged = Location.from_json(jl.to_json())
    assert t.access.get(forged) == data
    forged.blobs[0].size -= 1
    with pytest.raises(LocationError):
        t.access.get(forged)


def test_gateway_entry_points_refuse_to_leave_the_card(tmp_path, monkeypatch):
    """With no GPU and no device named, a MiniCluster, and an Access that
    takes the default service, raise instead of running on the host."""
    from chubaofs_tpu_torch.blobstore.access import Access
    from chubaofs_tpu_torch.blobstore.proxy import Proxy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MiniCluster(str(tmp_path / "c"), n_nodes=9, disks_per_node=2)
    cm = ClusterMgr(None)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Access(cm, Proxy(cm), {})
    finally:
        cm.close()
