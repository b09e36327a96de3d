"""The cases of tests/test_blockcache.py, run against the port on the CPU.

Blockcache daemon + client: LRU, restart recency, TinyLFU admission, ghost
readmission and budgets, and an FsClient on a cold volume reading through
the cache."""

import os
import threading

import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blockcache import BcacheClient, BcacheManager, BcacheService


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


@pytest.fixture()
def bcache(tmp_path):
    mgr = BcacheManager(str(tmp_path / "cache"), capacity_bytes=1 << 20)
    svc = BcacheService(str(tmp_path / "bcache.sock"), mgr).start()
    cli = BcacheClient(str(tmp_path / "bcache.sock"))
    yield mgr, svc, cli
    cli.close()
    svc.stop()


def test_put_get_evict_roundtrip(bcache):
    mgr, _, cli = bcache
    key = BcacheClient.cache_key("vol", 42, 0)
    assert cli.get(key) is None
    assert cli.put(key, b"block data" * 100)
    assert cli.get(key) == b"block data" * 100
    # ranged get
    assert cli.get(key, 6, 4) == b"data"
    cli.evict(key)
    assert cli.get(key) is None
    stats = cli.stats()
    assert stats["hits"] == 2 and stats["misses"] == 2


def test_lru_eviction_under_pressure(bcache):
    mgr, _, cli = bcache
    block = bytes(200 << 10)  # 200 KiB blocks into a 1 MiB cache
    for i in range(8):
        cli.put(f"k{i}", block)
    stats = cli.stats()
    assert stats["used"] <= mgr.capacity
    # oldest keys evicted, newest survive
    assert cli.get("k0") is None
    assert cli.get("k7") == block


def test_cache_survives_daemon_restart(tmp_path):
    mgr = BcacheManager(str(tmp_path / "c"), capacity_bytes=1 << 20)
    svc = BcacheService(str(tmp_path / "s.sock"), mgr).start()
    cli = BcacheClient(str(tmp_path / "s.sock"))
    cli.put("persisted", b"still here")
    cli.close()
    svc.stop()
    # new daemon over the same dir rebuilds the index from disk
    mgr2 = BcacheManager(str(tmp_path / "c"), capacity_bytes=1 << 20)
    svc2 = BcacheService(str(tmp_path / "s.sock"), mgr2).start()
    cli2 = BcacheClient(str(tmp_path / "s.sock"))
    assert cli2.get("persisted") == b"still here"
    cli2.close()
    svc2.stop()


def test_client_degrades_to_miss_when_daemon_down(tmp_path):
    cli = BcacheClient(str(tmp_path / "nope.sock"))
    assert cli.get("k") is None
    assert cli.put("k", b"x") is False
    cli.evict("k")  # no raise


def test_concurrent_clients(bcache):
    _, _, _ = bcache
    mgr, svc, _ = bcache
    errs = []

    def worker(n):
        try:
            c = BcacheClient(svc.sock_path)
            for i in range(20):
                c.put(f"w{n}_{i}", bytes([n]) * 1000)
                assert c.get(f"w{n}_{i}") == bytes([n]) * 1000
            c.close()
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(n,)) for n in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs


def test_fsclient_cold_reads_through_bcache(tmp_path):
    """reader.go:30,66 integration: miss → backend + fill; hit → no backend."""
    from chubaofs_tpu_torch.deploy import FsCluster

    cluster = FsCluster(str(tmp_path / "fs"), n_nodes=3, blob_nodes=6,
                        data_nodes=0, device=CPU)
    mgr = BcacheManager(str(tmp_path / "bc"), capacity_bytes=64 << 20)
    svc = BcacheService(str(tmp_path / "bc.sock"), mgr).start()
    try:
        cluster.create_volume("cached")
        fs = cluster.client("cached")
        fs.bcache = BcacheClient(str(tmp_path / "bc.sock"))
        payload = os.urandom(300_000)
        fs.write_file("/f", payload)
        reads = []
        orig_read = fs.data.read
        fs.data.read = lambda *a: (reads.append(1), orig_read(*a))[1]
        assert fs.read_file("/f") == payload
        assert reads  # first read hits the backend
        backend_calls = len(reads)
        assert fs.read_file("/f") == payload  # now served from cache
        assert len(reads) == backend_calls
        # ranged read also cached
        assert fs.read_file("/f", 1000, 5000) == payload[1000:6000]
        assert len(reads) == backend_calls
    finally:
        svc.stop()
        cluster.close()


# -- frequency admission + two-tier budgets + restart recency ----------------


def test_restart_rebuilds_lru_in_recency_order(tmp_path):
    """Regression: _load used to rebuild in directory/hash order,
    so the first post-restart eviction evicted an arbitrary survivor. It
    must rebuild in mtime (recency) order and evict the true LRU tail."""
    mgr = BcacheManager(str(tmp_path / "c"), capacity_bytes=450 << 10,
                        admit="always")
    for i in range(4):
        mgr.put(f"k{i}", bytes(100 << 10))
    # force a recency order that differs from both put and hash order
    order = ["k2", "k0", "k3", "k1"]
    for i, k in enumerate(order):
        os.utime(mgr._path(k), (1_000_000 + i, 1_000_000 + i))
    mgr2 = BcacheManager(str(tmp_path / "c"), capacity_bytes=450 << 10,
                         admit="always")
    assert list(mgr2._lru) == order
    # pressure: the evicted keys must be the OLDEST-mtime survivors
    mgr2.put("new1", bytes(100 << 10))
    assert mgr2.get("k2") is None and mgr2.get("k0") is None
    assert mgr2.get("k1") is not None and mgr2.get("k3") is not None


def test_disk_hit_refreshes_restart_recency(tmp_path):
    mgr = BcacheManager(str(tmp_path / "c"), capacity_bytes=1 << 20,
                        mem_capacity_bytes=0, admit="always")
    mgr.put("old", b"x" * 100)
    mgr.put("young", b"y" * 100)
    os.utime(mgr._path("old"), (1_000_000, 1_000_000))
    os.utime(mgr._path("young"), (1_000_001, 1_000_001))
    assert mgr.get("old") == b"x" * 100  # disk hit touches mtime to "now"
    mgr2 = BcacheManager(str(tmp_path / "c"), capacity_bytes=1 << 20)
    assert list(mgr2._lru) == ["young", "old"]


def test_admission_protects_hot_set_from_scan(tmp_path):
    """TinyLFU admission: a one-hit-wonder scan against a full cache must
    not flush the frequently-accessed head."""
    mgr = BcacheManager(str(tmp_path / "c"), capacity_bytes=100 << 10,
                        mem_capacity_bytes=0)
    block = bytes(10 << 10)
    for h in ("hot0", "hot1"):
        mgr.put(h, block)
        for _ in range(6):
            assert mgr.get(h) is not None  # build sketch frequency
    for i in range(30):  # cold scan: each key seen exactly once
        mgr.put(f"scan{i}", block)
    assert mgr.get("hot0") is not None
    assert mgr.get("hot1") is not None
    assert mgr.admit_rejects > 0


def test_ghost_grants_readmission(tmp_path):
    mgr = BcacheManager(str(tmp_path / "c"), capacity_bytes=50 << 10,
                        mem_capacity_bytes=0)
    mgr.put("victim", bytes(40 << 10))
    for _ in range(8):
        mgr.get("victim")  # victim is HOT: plain admission would refuse
    mgr.ghost.remember("back")  # "back" was recently pressure-evicted
    assert mgr.put("back", bytes(20 << 10)) is True
    assert mgr.get("back") is not None


def test_separate_memory_and_disk_budgets(tmp_path):
    mgr = BcacheManager(str(tmp_path / "c"), capacity_bytes=1 << 20,
                        mem_capacity_bytes=25 << 10, admit="always")
    block = bytes(10 << 10)
    for i in range(5):
        mgr.put(f"k{i}", block)
    st = mgr.stats()
    assert st["used"] == 5 * (10 << 10)          # all 5 on disk
    assert st["mem_used"] <= 25 << 10            # overlay stays budgeted
    assert st["mem_blocks"] == 2
    # a block dropped from the overlay still serves from its disk file
    assert mgr.get("k0") == block


def test_frequency_sketch_estimates_and_ages():
    from chubaofs_tpu_torch.blockcache.bcache import FrequencySketch

    sk = FrequencySketch(width=64)
    for _ in range(6):
        sk.add("hot")
    sk.add("cold")
    assert sk.estimate("hot") >= 5
    assert sk.estimate("cold") <= 2
    assert sk.estimate("never") == 0
    hot_before = sk.estimate("hot")
    for i in range(sk._sample):  # force an aging pass
        sk.add(f"filler{i % 97}")
    assert sk.ages >= 1
    assert sk.estimate("hot") <= max(1, hot_before // 2) + 1


def test_admission_walks_every_displaced_victim(tmp_path):
    """Review regression: one large candidate barely hotter than the LRU
    tail must NOT displace a run of hotter blocks — admission walks every
    victim its size would evict (the W-TinyLFU victim walk)."""
    mgr = BcacheManager(str(tmp_path / "c"), capacity_bytes=100 << 10,
                        mem_capacity_bytes=0)
    tail = bytes(10 << 10)
    mgr.put("coldtail", tail)  # estimate 1, sits at the LRU head
    for i in range(9):
        k = f"hot{i}"
        mgr.put(k, tail)
        for _ in range(5):
            mgr.get(k)
    # candidate seen twice: beats the cold tail (1) but not the hot run (6)
    mgr.get("big")
    assert mgr.put("big", bytes(50 << 10)) is False
    for i in range(9):
        assert mgr.get(f"hot{i}") is not None
