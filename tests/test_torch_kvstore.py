"""The cases of tests/test_kvstore.py, run against the port on the CPU.

libcfskv native engine (the port builds it as libcfskv_torch.so) + PyKV
fallback: API, atomicity, recovery, cross-engine file compatibility."""

import os
import struct

import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.utils.kvstore import KVError, NativeKV, PyKV, open_kv


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


ENGINES = ["python", "native"]


def _mk(engine, path):
    if engine == "native":
        try:
            return NativeKV(str(path))
        except KVError:
            pytest.skip("native engine unavailable")
    return PyKV(str(path))


@pytest.mark.parametrize("engine", ENGINES)
def test_basic_ops(engine, tmp_path):
    db = _mk(engine, tmp_path / "db")
    assert db.get(b"k") is None
    db.put(b"k", b"v1")
    assert db.get(b"k") == b"v1"
    db.put(b"k", b"v2")
    assert db.get(b"k") == b"v2"
    db.delete(b"k")
    assert db.get(b"k") is None
    db.delete(b"k")  # delete of a missing key is a no-op
    assert db.count() == 0
    db.put(b"", b"empty key ok")
    db.put(b"binary\x00key", bytes(range(256)))
    assert db.get(b"binary\x00key") == bytes(range(256))
    db.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_scan_ordered_prefix(engine, tmp_path):
    db = _mk(engine, tmp_path / "db")
    for c in b"zaqmbx":
        db.put(b"p/" + bytes([c]), bytes([c]) * 2)
    db.put(b"other", b"no")
    got = db.scan(prefix=b"p/")
    assert [k for k, _ in got] == sorted(b"p/" + bytes([c]) for c in b"zaqmbx")
    got = db.scan(prefix=b"p/", start=b"p/m", limit=2)
    assert [k for k, _ in got] == [b"p/m", b"p/q"]
    assert db.scan(prefix=b"nope") == []
    db.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_batch_and_reopen(engine, tmp_path):
    db = _mk(engine, tmp_path / "db")
    db.put(b"stale", b"x")
    db.write_batch(puts=[(b"a", b"1"), (b"b", b"2")], deletes=[b"stale"])
    assert db.get(b"a") == b"1" and db.get(b"stale") is None
    db.close()
    db2 = _mk(engine, tmp_path / "db")
    assert db2.get(b"a") == b"1"
    assert db2.get(b"b") == b"2"
    assert db2.get(b"stale") is None
    db2.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_torn_tail_truncated(engine, tmp_path):
    db = _mk(engine, tmp_path / "db")
    db.put(b"good", b"data")
    db.close()
    # simulate a crash mid-append: garbage tail on the active log
    logs = [f for f in os.listdir(tmp_path / "db") if f.endswith(".log")]
    with open(tmp_path / "db" / logs[0], "ab") as f:
        f.write(struct.pack("<IBII", 12345, 1, 100, 100) + b"torn")
    db2 = _mk(engine, tmp_path / "db")
    assert db2.get(b"good") == b"data"
    db2.put(b"after", b"recovery")  # appends after the truncated tail
    db2.close()
    db3 = _mk(engine, tmp_path / "db")
    assert db3.get(b"after") == b"recovery"
    db3.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_compact_drops_dead_space(engine, tmp_path):
    db = _mk(engine, tmp_path / "db")
    for i in range(100):
        db.put(b"k%d" % (i % 10), os.urandom(100))  # 90% dead
    size_before = sum(
        os.path.getsize(tmp_path / "db" / f) for f in os.listdir(tmp_path / "db"))
    db.compact()
    size_after = sum(
        os.path.getsize(tmp_path / "db" / f) for f in os.listdir(tmp_path / "db"))
    assert size_after < size_before / 3
    assert db.count() == 10
    db.close()
    db2 = _mk(engine, tmp_path / "db")
    assert db2.count() == 10
    db2.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_checkpoint_opens_as_store(engine, tmp_path):
    db = _mk(engine, tmp_path / "db")
    for i in range(20):
        db.put(b"key%02d" % i, b"val%02d" % i)
    db.checkpoint(str(tmp_path / "ckpt"))
    db.put(b"later", b"not in checkpoint")
    db.close()
    snap = _mk(engine, tmp_path / "ckpt")
    assert snap.count() == 20
    assert snap.get(b"key07") == b"val07"
    assert snap.get(b"later") is None
    snap.close()


@pytest.mark.parametrize("writer,reader", [("python", "native"),
                                           ("native", "python")])
def test_cross_engine_file_compat(writer, reader, tmp_path):
    """The two engines share one on-disk format — each must open the
    other's files (the fallback is only safe if this holds)."""
    w = _mk(writer, tmp_path / "db")
    w.put(b"alpha", b"1")
    w.write_batch(puts=[(b"beta", b"2"), (b"gamma", b"3")], deletes=[b"alpha"])
    w.put(b"delta", os.urandom(4096))
    delta = w.get(b"delta")
    w.close()
    r = _mk(reader, tmp_path / "db")
    assert r.get(b"alpha") is None
    assert r.get(b"beta") == b"2"
    assert r.get(b"gamma") == b"3"
    assert r.get(b"delta") == delta
    r.close()


def test_open_kv_auto(tmp_path):
    db = open_kv(str(tmp_path / "db"))
    db.put(b"x", b"y")
    assert db.get(b"x") == b"y"
    db.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_double_open_refused(engine, tmp_path):
    """One live handle per directory (RocksDB LOCK discipline): a second
    open must fail loudly instead of silently losing appends to a log
    generation the first handle compacts away."""
    db = _mk(engine, tmp_path / "db")
    ctor = NativeKV if engine == "native" else PyKV
    with pytest.raises(KVError, match="LOCK"):
        ctor(str(tmp_path / "db"))
    db.close()
    db2 = _mk(engine, tmp_path / "db")  # released on close
    db2.close()
