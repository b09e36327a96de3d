"""The cases of tests/test_follower_read.py, run against the port on the CPU.

Follower-read: volume-option-gated replica reads in the data SDK.

Reference: sdk/data/stream follower-read + proto/mount_options.go
FollowerRead (the BASELINE env runs FollowerRead=on, env.md:14-22). The
consistency contract is the reference's: a follower may trail the leader's
latest raft-applied overwrite, so the option trades strict read-your-writes
for read availability and replica load-spread. The headline property tested
here: a LEADERLESS-but-quorate partition still serves reads."""

import pytest
import torch

from chubaofs_tpu_torch.deploy import FsCluster
from chubaofs_tpu_torch.raft.core import ROLE_FOLLOWER
from chubaofs_tpu_torch.sdk.stream import ExtentClient, StreamError

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
    c = FsCluster(str(tmp_path_factory.mktemp("fread")), n_nodes=3,
                  blob_nodes=0, data_nodes=3, device=CPU)
    c.create_volume("frvol", cold=False, follower_read=True)
    c.create_volume("lrvol", cold=False)  # leader-read control volume
    yield c
    c.close()


def _demote_all_leaders(cluster, pid: int) -> int:
    """Force every raft replica of dp `pid` to follower. FsCluster raft only
    advances on explicit ticks, so no re-election happens behind the test's
    back: the partition is leaderless yet fully quorate (all replicas up)."""
    demoted = 0
    for raft in cluster.rafts.values():
        g = raft.groups.get(pid)
        if g is not None and g.core.role != ROLE_FOLLOWER:
            g.core.role = ROLE_FOLLOWER
            g.core.leader = None
            demoted += 1
    return demoted


def _extent_pid(fs, path: str) -> int:
    inode = fs.meta.get_inode(fs.resolve(path))
    assert inode.extents, "file landed no extents"
    return inode.extents[0].partition_id


def test_volume_option_flows_to_client(cluster):
    assert cluster.master().get_volume("frvol").follower_read is True
    assert cluster.master().get_volume("lrvol").follower_read is False
    assert cluster.client("frvol").hot.client.follower_read is True
    assert cluster.client("lrvol").hot.client.follower_read is False


def test_leaderless_quorate_partition_serves_reads(cluster, monkeypatch):
    fs = cluster.client("frvol")
    payload = b"follower-read payload " * 1000  # multi-packet, normal extent
    fs.write_file("/fr.bin", payload)
    pid = _extent_pid(fs, "/fr.bin")

    assert _demote_all_leaders(cluster, pid) >= 1
    # keep the control-case wait short; follower-read shouldn't need retries
    monkeypatch.setattr(ExtentClient, "RETRY_WINDOW", 0.5)

    # leaderless + quorate: all replicas alive, none is leader
    assert all(not r.groups[pid].core.role == "leader"
               for r in cluster.rafts.values() if pid in r.groups)
    assert cluster.client("frvol").read_file("/fr.bin") == payload

    # the control volume (leader-only reads) must NOT serve now
    lfs = cluster.client("lrvol")
    lfs.write_file("/lr.bin", b"leader only")
    lpid = _extent_pid(lfs, "/lr.bin")
    _demote_all_leaders(cluster, lpid)
    with pytest.raises(StreamError):
        cluster.client("lrvol").read_file("/lr.bin")


def test_read_hosts_ranking_prefers_fast_replicas():
    """KFasterRandom over replicas: the EWMA ranking keeps a slow/dead
    leader out of the first-attempt set once its latency sinks."""
    ec = ExtentClient(lambda: [], follower_read=True)
    dp = {"pid": 1, "hosts": ["leader:1", "f1:1", "f2:1"]}
    ec.record_host_latency("leader:1", 10.0)  # punished (e.g. conn refused)
    ec.record_host_latency("f1:1", 0.001)
    ec.record_host_latency("f2:1", 0.002)
    for _ in range(20):
        order = ec.read_hosts(dp)
        assert order[0] != "leader:1"  # never first while slowest
        assert set(order) == set(dp["hosts"])  # everyone stays a fallback

    # leader-only mode keeps wire order
    ec2 = ExtentClient(lambda: [], follower_read=False)
    assert ec2.read_hosts(dp) == dp["hosts"]


def test_reads_survive_continuous_leader_churn(cluster):
    """Soak (compact form of a churn hunt, 109k reads clean):
    data-partition leaders get demoted continuously while a client reads —
    follower-read keeps every read correct with no election needed."""
    import random
    import threading
    import time

    from chubaofs_tpu_torch.deploy import DATANODE_ID_BASE

    fs = cluster.client("frvol")
    payload = bytes(range(256)) * 400
    fs.write_file("/churn.bin", payload)

    stop = threading.Event()

    def churn():
        rnd = random.Random(7)
        while not stop.is_set():
            for nid, raft in cluster.rafts.items():
                if nid < DATANODE_ID_BASE:
                    continue
                for g in list(raft.groups.values()):
                    if g.core.role == "leader" and rnd.random() < 0.5:
                        g.core.role = ROLE_FOLLOWER
                        g.core.leader = None
            time.sleep(0.02)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    reader = cluster.client("frvol")
    try:
        deadline = time.time() + 5
        n = 0
        while time.time() < deadline:
            assert reader.read_file("/churn.bin") == payload
            n += 1
        assert n > 20, n
    finally:
        stop.set()
        t.join()


def test_follower_read_packets_flagged(cluster):
    """The wire carries the relaxed-consistency opt-in, so followers serve
    without a leadership check only when the volume asked for it."""
    fs = cluster.client("frvol")
    fs.write_file("/flag.bin", b"flagged")
    ec = fs.hot.client
    seen = {}
    orig = ExtentClient.request

    def spy(self, dp, pkt, retry_hosts=True, hosts=None):
        seen["flag"] = pkt.arg.get("follower_read")
        return orig(self, dp, pkt, retry_hosts, hosts)

    ExtentClient.request = spy
    try:
        assert fs.read_file("/flag.bin") == b"flagged"
    finally:
        ExtentClient.request = orig
    assert seen["flag"] is True
