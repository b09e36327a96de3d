"""The cases of tests/test_fs.py, run against the port on the CPU.

File/metadata cluster end-to-end: POSIX verbs over raft-replicated metadata
with blobstore-backed (erasure-coded) file data."""

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch.deploy import FsCluster
from chubaofs_tpu_torch.sdk.fs import FsError

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
def fscluster(tmp_path_factory):
    c = FsCluster(str(tmp_path_factory.mktemp("fs")), device=CPU)
    c.create_volume("vol1")
    yield c
    c.close()


@pytest.fixture
def fs(fscluster):
    return fscluster.client("vol1")


def test_mkdir_readdir(fs):
    fs.mkdir("/a")
    fs.mkdir("/a/b")
    fs.mkdir("/a/c")
    assert fs.readdir("/a") == ["b", "c"]
    assert fs.stat("/a")["is_dir"]


def test_file_write_read(fs, rng):
    data = rng.integers(0, 256, 500_000, dtype=np.uint8).tobytes()
    fs.write_file("/a/file1", data)
    assert fs.read_file("/a/file1") == data
    assert fs.stat("/a/file1")["size"] == len(data)
    # ranged read
    assert fs.read_file("/a/file1", 1000, 50) == data[1000:1050]


def test_append(fs, rng):
    a = rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
    fs.append_file("/appended", a)
    fs.append_file("/appended", b)
    assert fs.read_file("/appended") == a + b


def test_overwrite_truncates(fs, rng):
    fs.write_file("/over", b"x" * 1000)
    fs.write_file("/over", b"y" * 10)
    assert fs.read_file("/over") == b"y" * 10


def test_unlink_and_enoent(fs):
    fs.write_file("/gone", b"bye")
    fs.unlink("/gone")
    with pytest.raises(FsError) as e:
        fs.read_file("/gone")
    assert e.value.code == "ENOENT"


def test_rename(fs):
    fs.write_file("/old", b"data")
    fs.rename("/old", "/a/new")
    assert fs.read_file("/a/new") == b"data"
    with pytest.raises(FsError):
        fs.stat("/old")


def test_rmdir_nonempty_fails(fs):
    fs.mkdir("/d1")
    fs.write_file("/d1/f", b"x")
    with pytest.raises(FsError) as e:
        fs.rmdir("/d1")
    assert e.value.code == "ENOTEMPTY"
    fs.unlink("/d1/f")
    fs.rmdir("/d1")
    with pytest.raises(FsError):
        fs.stat("/d1")


def test_duplicate_create_fails(fs):
    fs.mkdir("/dup")
    with pytest.raises(FsError) as e:
        fs.mkdir("/dup")
    assert e.value.code == "EEXIST"


def test_hardlink(fs):
    fs.write_file("/orig", b"shared")
    fs.link("/orig", "/lnk")
    assert fs.read_file("/lnk") == b"shared"
    assert fs.stat("/orig")["nlink"] == 2
    fs.unlink("/orig")
    assert fs.read_file("/lnk") == b"shared"  # survives first unlink


def test_xattr(fs):
    fs.write_file("/xf", b"1")
    fs.setxattr("/xf", "user.tag", b"value")
    assert fs.getxattr("/xf", "user.tag") == b"value"
    with pytest.raises(FsError):
        fs.getxattr("/xf", "user.other")


def test_metadata_replicated_across_nodes(fscluster, fs):
    """All 3 metanode replicas hold the applied namespace."""
    fs.mkdir("/replcheck")
    # followers apply on the next heartbeat round
    fscluster.settle(lambda: False, max_ticks=4)
    view = fscluster.master().get_volume("vol1")
    pid = view.meta_partitions[0].partition_id
    versions = []
    for mn in fscluster.metanodes.values():
        sm = mn.partitions.get(pid)
        if sm is not None:
            versions.append(any(d.name == "replcheck" for d in sm.children.get(1, {}).values()))
    assert versions.count(True) >= 2  # quorum has applied it


def test_meta_leader_failover(fscluster, fs, rng):
    """Kill the partition leader; ops keep working via the new leader."""
    data = rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    fs.write_file("/failover-pre", data)

    view = fscluster.master().get_volume("vol1")
    pid = view.meta_partitions[0].partition_id
    leader = next(i for i, r in fscluster.rafts.items() if r.is_leader(pid))
    fscluster.net.isolate(leader)
    others = [i for i in fscluster.rafts if i != leader]
    assert fscluster.settle(
        lambda: any(fscluster.rafts[i].is_leader(pid) for i in others), max_ticks=900
    )
    assert fs.read_file("/failover-pre") == data
    fs.write_file("/failover-post", b"alive")
    assert fs.read_file("/failover-post") == b"alive"
    fscluster.net.heal()
    fscluster.settle()


def test_deep_paths(fs):
    path = ""
    for i in range(10):
        path += f"/deep{i}"
        fs.mkdir(path)
    fs.write_file(path + "/leaf", b"bottom")
    assert fs.read_file(path + "/leaf") == b"bottom"


def test_cluster_restart_rehosts_partitions(tmp_path, rng):
    """A restarted FsCluster re-hosts meta partitions and replays their WALs."""
    root = str(tmp_path)
    c1 = FsCluster(root, device=CPU)
    c1.create_volume("v")
    f1 = c1.client("v")
    f1.mkdir("/d")
    data = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    f1.write_file("/d/f", data)
    c1.close()

    c2 = FsCluster(root, device=CPU)
    f2 = c2.client("v")
    assert f2.read_file("/d/f") == data
    f2.write_file("/d/g", b"new")
    assert f2.readdir("/d") == ["f", "g"]
    c2.close()
