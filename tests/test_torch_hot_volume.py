"""The cases of tests/test_hot_volume.py, run against the port on the CPU.

Hot-tier end-to-end: FsCluster with real TCP datanodes — the docker-compose
suite analog for the replica path (SURVEY §4)."""

import os

import pytest
import torch

from chubaofs_tpu_torch.deploy import FsCluster
from chubaofs_tpu_torch.raft.server import run_until

from chubaofs_tpu_torch import chaos as t_chaos

# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


CPU = "cpu"


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = FsCluster(str(tmp_path_factory.mktemp("hot")), n_nodes=3,
                  blob_nodes=9, data_nodes=4, device=CPU)
    c.create_volume("hotvol", cold=False)
    yield c
    c.close()


def test_hot_volume_has_data_partitions(cluster):
    views = cluster.master().data_partition_views("hotvol")
    assert len(views) == 3
    for v in views:
        assert len(v["hosts"]) == 3


def test_small_file_rides_tiny_extent(cluster):
    fs = cluster.client("hotvol")
    fs.write_file("/tiny.txt", b"hello tiny world")
    assert fs.read_file("/tiny.txt") == b"hello tiny world"
    inode = cluster.client("hotvol").meta.get_inode(fs.resolve("/tiny.txt"))
    assert len(inode.extents) == 1
    assert 1 <= inode.extents[0].extent_id <= 64  # tiny id range


def test_large_file_write_read(cluster):
    fs = cluster.client("hotvol")
    payload = os.urandom(1_000_000)  # > 7 packets
    fs.write_file("/big.bin", payload)
    assert fs.read_file("/big.bin") == payload
    assert fs.read_file("/big.bin", offset=123_456, size=789) == payload[123_456:124_245]


def test_append_and_overwrite(cluster):
    fs = cluster.client("hotvol")
    fs.write_file("/rw.bin", b"A" * 300_000)
    fs.append_file("/rw.bin", b"B" * 100_000)
    assert fs.stat("/rw.bin")["size"] == 400_000

    # in-place overwrite rides the raft random-write path; the datanode
    # handler thread blocks on commit, so pump raft clocks meanwhile
    ino = fs.resolve("/rw.bin")
    done = {}

    def do_overwrite():
        try:
            fs.write_at(ino, 150_000, b"C" * 10_000)
            done["ok"] = True
        except Exception as e:  # noqa: BLE001
            done["err"] = e

    import threading

    t = threading.Thread(target=do_overwrite)
    t.start()
    run_until(cluster.net, lambda: not t.is_alive(), max_ticks=5000)
    t.join(timeout=20)
    assert done.get("ok"), done.get("err")

    data = fs.read_file("/rw.bin")
    assert data[:150_000] == b"A" * 150_000
    assert data[150_000:160_000] == b"C" * 10_000
    assert data[160_000:300_000] == b"A" * 140_000
    assert data[300_000:] == b"B" * 100_000


def test_truncate_then_rewrite(cluster):
    fs = cluster.client("hotvol")
    fs.write_file("/re.bin", b"first version, long" * 1000)
    fs.write_file("/re.bin", b"second")
    assert fs.read_file("/re.bin") == b"second"


def test_unlink_purges_extents(cluster):
    fs = cluster.client("hotvol")
    fs.write_file("/gone.bin", os.urandom(300_000))
    ino = fs.resolve("/gone.bin")
    inode = fs.meta.get_inode(ino)
    keys = list(inode.extents)
    assert keys
    fs.unlink("/gone.bin")
    cluster.tick_background()  # freelist drain -> mark-delete on datanodes
    # normal extents gone from every replica store
    normal = [k for k in keys if k.extent_id > 64]
    for key in normal:
        for dn in cluster.datanodes.values():
            dp = dn.space.partitions.get(key.partition_id)
            if dp is None:
                continue
            assert not dp.store.has(key.extent_id)


def test_repair_sweep_noop_when_healthy(cluster):
    fs = cluster.client("hotvol")
    fs.write_file("/steady.bin", os.urandom(200_000))
    assert cluster.repair_data_partitions() == 0


def test_truncate_purges_dropped_extents(cluster):
    """Rewriting a hot file must not leak the old version's extents."""
    fs = cluster.client("hotvol")
    fs.write_file("/tr.bin", os.urandom(300_000))
    ino = fs.resolve("/tr.bin")
    old = [k for k in fs.meta.get_inode(ino).extents if k.extent_id > 64]
    assert old
    fs.write_file("/tr.bin", b"tiny now")
    cluster.tick_background()  # del-extents drain -> mark-delete
    for key in old:
        for dn in cluster.datanodes.values():
            dp = dn.space.partitions.get(key.partition_id)
            if dp is not None:
                assert not dp.store.has(key.extent_id)


def test_hot_cluster_restart_reconnects(tmp_path_factory):
    """Datanode ports change across restarts; recovered dp views must follow
    the fresh registry (master refresh_dp_hosts)."""
    root = str(tmp_path_factory.mktemp("restart"))
    c1 = FsCluster(root, n_nodes=3, blob_nodes=9, data_nodes=4, device=CPU)
    c1.create_volume("hv", cold=False)
    fs = c1.client("hv")
    payload = os.urandom(250_000)
    fs.write_file("/keep.bin", payload)
    old_hosts = {dp.partition_id: list(dp.hosts)
                 for vol in c1.master().sm.volumes.values()
                 for dp in vol.data_partitions}
    c1.close()

    c2 = FsCluster(root, n_nodes=3, blob_nodes=9, data_nodes=4, device=CPU)
    views = c2.master().data_partition_views("hv")
    assert len(views) == 3
    # metadata survived; extent data is on the same disks under new ports
    fs2 = c2.client("hv")
    assert fs2.read_file("/keep.bin") == payload
    new_hosts = {v["pid"]: v["hosts"] for v in views}
    assert set(new_hosts) == set(old_hosts)
    c2.close()


def test_write_into_truncate_up_hole_not_dropped(cluster):
    """Regression (found by the kernel-mount fsx soak): bytes written into
    a hole a truncate-up created BELOW the committed size must get their
    own extents — the overwrite path used to intersect only existing
    extents and silently dropped them."""
    fs = cluster.client("hotvol")
    fs.write_file("/hole.bin", b"A" * 1000)
    ino = fs.resolve("/hole.bin")
    fs.meta.truncate(ino, 200_000)  # extend: [1000, 200000) is a hole
    assert fs.read_at(ino, 150_000, 10) == b"\0" * 10
    fs.write_at(ino, 100_000, b"B" * 5000)  # entirely inside the hole
    assert fs.read_at(ino, 100_000, 5000) == b"B" * 5000
    assert fs.read_at(ino, 99_990, 10) == b"\0" * 10  # hole around it intact
    assert fs.read_at(ino, 0, 1000) == b"A" * 1000
    # straddling write: part over an extent, part over the hole
    fs.write_at(ino, 500, b"C" * 2000)
    assert fs.read_at(ino, 500, 2000) == b"C" * 2000
    assert fs.meta.get_inode(ino).size == 200_000
