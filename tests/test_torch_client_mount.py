"""The cases of tests/test_client_mount.py against the port's Mount, on
FsCluster(device="cpu"); every name and assertion as in the reference. Then
one seeded sequence of file operations through the reference's Mount on its
FsCluster and the port's Mount on FsCluster(device="cpu"), on a hot and on
a cold volume: file bytes, stat sizes, modes and link counts, readdir lists
and the errno of every refused operation must be equal. Tolerance 0.

The reference file's docstring:

Client Mount layer: fd table, caches, orphan list, audit (client/ analog)."""

import os

import numpy as np
import pytest
import torch

from chubaofs_tpu.client.mount import Mount as JMount
from chubaofs_tpu.deploy import FsCluster as JFsCluster
from chubaofs_tpu.sdk.fs import FsError as JFsError
from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.client.mount import (
    Mount,
    MountError,
    O_APPEND,
    O_CREAT,
    O_RDONLY,
    O_RDWR,
    O_TRUNC,
    O_WRONLY,
)
from chubaofs_tpu_torch.deploy import FsCluster
from chubaofs_tpu_torch.sdk.fs import FsError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = FsCluster(str(tmp_path_factory.mktemp("mnt")), n_nodes=3, blob_nodes=6,
                  data_nodes=4, device="cpu")
    c.create_volume("mv", cold=False)
    yield c
    c.close()


@pytest.fixture
def mnt(cluster, tmp_path):
    m = Mount(cluster.client("mv"), volume="mv", audit_dir=str(tmp_path / "audit"))
    yield m
    m.umount()


def test_open_write_read_close(mnt):
    fd = mnt.open("/f1.txt", O_CREAT | O_RDWR)
    assert mnt.write(fd, b"hello ") == 6
    assert mnt.write(fd, b"world") == 5
    mnt.lseek(fd, 0)
    assert mnt.read(fd, 100) == b"hello world"
    assert mnt.fstat(fd)["size"] == 11
    mnt.close(fd)
    with pytest.raises(MountError):
        mnt.read(fd, 1)  # EBADF after close


def test_positional_io_and_append(mnt):
    fd = mnt.open("/f2.bin", O_CREAT | O_WRONLY)
    mnt.write(fd, b"A" * 100)
    mnt.write(fd, b"B" * 10, offset=50)
    mnt.close(fd)
    fd = mnt.open("/f2.bin", O_WRONLY | O_APPEND)
    mnt.write(fd, b"C" * 5)
    mnt.close(fd)
    fd = mnt.open("/f2.bin")
    data = mnt.read(fd, 1000)
    mnt.close(fd)
    assert data == b"A" * 50 + b"B" * 10 + b"A" * 40 + b"C" * 5


def test_o_trunc(mnt):
    fd = mnt.open("/f3", O_CREAT | O_WRONLY)
    mnt.write(fd, b"long old content")
    mnt.close(fd)
    fd = mnt.open("/f3", O_WRONLY | O_TRUNC)
    mnt.write(fd, b"new")
    mnt.close(fd)
    fd = mnt.open("/f3")
    assert mnt.read(fd, 100) == b"new"
    mnt.close(fd)


def test_orphan_unlink_while_open(mnt):
    """POSIX: an unlinked file stays readable through open fds; the last
    close evicts it (the client orphan inode list)."""
    fd = mnt.open("/doomed", O_CREAT | O_RDWR)
    mnt.write(fd, b"still here")
    mnt.unlink("/doomed")
    with pytest.raises(FsError):
        mnt.stat("/doomed")  # gone from the namespace
    mnt.lseek(fd, 0)
    assert mnt.read(fd, 100) == b"still here"  # data alive via the fd
    assert mnt.statfs()["orphans"] == 1
    mnt.close(fd)
    assert mnt.statfs()["orphans"] == 0


def test_namespace_ops_and_caches(mnt):
    mnt.mkdir("/dir")
    fd = mnt.open("/dir/a", O_CREAT | O_WRONLY)
    mnt.write(fd, b"x")
    mnt.close(fd)
    assert mnt.readdir("/dir") == ["a"]
    st = mnt.stat("/dir/a")
    assert st["size"] == 1
    mnt.rename("/dir/a", "/dir/b")
    assert mnt.readdir("/dir") == ["b"]
    with pytest.raises(FsError):
        mnt.stat("/dir/a")  # lookup cache must not serve the old name
    mnt.truncate("/dir/b", 0)
    assert mnt.stat("/dir/b")["size"] == 0
    mnt.unlink("/dir/b")
    mnt.rmdir("/dir")
    with pytest.raises(FsError):
        mnt.readdir("/dir")


def test_readonly_fd_rejects_write(mnt):
    fd = mnt.open("/ro", O_CREAT | O_WRONLY)
    mnt.write(fd, b"data")
    mnt.close(fd)
    fd = mnt.open("/ro", O_RDONLY)
    with pytest.raises(MountError):
        mnt.write(fd, b"nope")
    mnt.close(fd)


def test_audit_log_written(cluster, tmp_path):
    audit_dir = str(tmp_path / "adt")
    m = Mount(cluster.client("mv"), volume="mv", audit_dir=audit_dir)
    fd = m.open("/audited", O_CREAT | O_WRONLY)
    m.write(fd, b"z")
    m.close(fd)
    try:
        m.stat("/nope")
    except FsError:
        pass
    m.umount()
    logs = [f for f in os.listdir(audit_dir) if f.startswith("audit")]
    assert logs
    body = open(os.path.join(audit_dir, logs[0])).read()
    assert ",open,/audited," in body and ",write,/audited," in body
    assert ",stat,/nope,ENOENT" in body  # errors carry their code


# -- the port's Mount against the reference's, one seeded sequence ------------


SEED = 31


def seeded_ops(seed: int, n: int = 60) -> list[tuple]:
    """Operations over a small tree, some of them refused on purpose
    (missing paths, a non-empty rmdir, a write on a read-only fd, a read on
    a closed fd)."""
    rng = np.random.default_rng(seed)
    ops = [("mkdir", "/d"), ("mkdir", "/d/e"), ("mkdir", "/d")]  # EEXIST
    names = [f"/d/f{i}" for i in range(6)] + [f"/d/e/g{i}" for i in range(3)]
    for name in names:
        size = int(rng.integers(1, 200_000))
        ops.append(("create", name, rng.integers(0, 256, size, dtype=np.uint8).tobytes()))
    for _ in range(n):
        kind = str(rng.choice(["create", "pwrite", "append", "truncate",
                               "rename", "link", "unlink", "read", "read",
                               "readdir", "stat", "missing", "rmdir_full",
                               "ro_write", "closed_read"]))
        name = names[int(rng.integers(len(names)))]
        if kind == "create":
            size = int(rng.integers(1, 200_000))
            ops.append((kind, name, rng.integers(0, 256, size, dtype=np.uint8).tobytes()))
        elif kind == "pwrite":
            off = int(rng.integers(0, 250_000))
            size = int(rng.integers(1, 60_000))
            ops.append((kind, name, off,
                        rng.integers(0, 256, size, dtype=np.uint8).tobytes()))
        elif kind == "append":
            size = int(rng.integers(1, 30_000))
            ops.append((kind, name, rng.integers(0, 256, size, dtype=np.uint8).tobytes()))
        elif kind == "truncate":
            ops.append((kind, name, int(rng.integers(0, 220_000))))
        elif kind in ("rename", "link"):
            ops.append((kind, name, names[int(rng.integers(len(names)))]))
        elif kind == "readdir":
            ops.append((kind, ["/", "/d", "/d/e", "/nodir"][int(rng.integers(4))]))
        elif kind == "missing":
            ops.append((kind, f"/d/absent{int(rng.integers(5))}"))
        else:
            ops.append((kind, name))
    return ops


def apply_ops(m, ops, errors) -> list:
    """Run `ops` through Mount `m`; one record per op: its result, or the
    error code of a refused op."""
    log = []
    for op in ops:
        kind, path = op[0], op[1]
        try:
            if kind == "mkdir":
                m.mkdir(path)
                out = "ok"
            elif kind == "create":
                fd = m.open(path, O_CREAT | O_WRONLY | O_TRUNC)
                out = m.write(fd, op[2])
                m.close(fd)
            elif kind == "pwrite":
                fd = m.open(path, O_RDWR)
                out = m.write(fd, op[3], offset=op[2])
                m.close(fd)
            elif kind == "append":
                fd = m.open(path, O_WRONLY | O_APPEND)
                out = m.write(fd, op[2])
                m.close(fd)
            elif kind == "truncate":
                m.truncate(path, op[2])
                out = "ok"
            elif kind == "rename":
                m.rename(path, op[2])
                out = "ok"
            elif kind == "link":
                m.link(path, op[2])
                out = "ok"
            elif kind == "unlink":
                m.unlink(path)
                out = "ok"
            elif kind == "read":
                fd = m.open(path, O_RDONLY)
                out = m.read(fd, 1 << 20)
                m.close(fd)
            elif kind == "readdir":
                out = sorted(m.readdir(path))
            elif kind == "stat":
                st = m.stat(path)
                out = (st["size"], st["mode"], st["nlink"], st["is_dir"])
            elif kind == "missing":
                out = m.open(path, O_RDONLY)
            elif kind == "rmdir_full":
                m.rmdir("/d")
                out = "ok"
            elif kind == "ro_write":
                fd = m.open(path, O_RDONLY)
                try:
                    out = m.write(fd, b"refused")
                finally:
                    m.close(fd)
            elif kind == "closed_read":
                fd = m.open(path, O_RDONLY)
                m.close(fd)
                out = m.read(fd, 10)
            log.append((kind, path, out))
        except errors as e:
            log.append((kind, path, "error", e.code))
    return log


def final_tree(m) -> dict:
    out = {}
    stack = ["/"]
    while stack:
        d = stack.pop()
        for name in sorted(m.readdir(d)):
            p = d.rstrip("/") + "/" + name
            st = m.stat(p)
            if st["is_dir"]:
                out[p] = ("dir", st["mode"], st["nlink"])
                stack.append(p)
            else:
                fd = m.open(p, O_RDONLY)
                data = m.read(fd, 1 << 21)
                m.close(fd)
                out[p] = (st["size"], st["mode"], st["nlink"], data)
    return out


@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
def test_mount_same_results_as_reference(tmp_path, cold):
    ops = seeded_ops(SEED + int(cold))
    jc = JFsCluster(str(tmp_path / "j"), n_nodes=3, blob_nodes=6, data_nodes=4)
    try:
        jc.create_volume("xv", cold=cold)
        jm = JMount(jc.client("xv"), volume="xv")
        jlog = apply_ops(jm, ops, JFsError)
        jtree = final_tree(jm)
        jm.umount()
    finally:
        jc.close()
    tc = FsCluster(str(tmp_path / "t"), n_nodes=3, blob_nodes=6, data_nodes=4,
                   device="cpu")
    try:
        tc.create_volume("xv", cold=cold)
        tm = Mount(tc.client("xv"), volume="xv")
        tlog = apply_ops(tm, ops, FsError)
        ttree = final_tree(tm)
        tm.umount()
    finally:
        tc.close()
    assert len(tlog) == len(jlog) == len(ops)
    for t, j in zip(tlog, jlog):
        assert t == j, (t[:2], j[:2])
    refused = [r for r in tlog if r[2] == "error"]
    assert {r[3] for r in refused} >= {"EEXIST", "ENOENT", "ENOTEMPTY"}
    assert ttree == jtree
    assert any(isinstance(v[0], int) and v[0] > 0 for v in ttree.values())
