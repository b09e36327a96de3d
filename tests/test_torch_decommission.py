"""The cases of tests/test_decommission.py, run against the port on the CPU.

Raft single-server membership change + node decommission (the master
decommission flows + raft reconfiguration the reference drives through
master/cluster.go and tiglabs raft ChangeMember)."""

import pytest
import torch

from chubaofs_tpu_torch.deploy import FsCluster
from chubaofs_tpu_torch.raft.server import InProcNet, MultiRaft, run_until

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


class _KVSM:
    def __init__(self):
        self.data = {}

    def apply(self, d, index):
        self.data[d[0]] = d[1]
        return d[1]

    def snapshot(self):
        import pickle

        return pickle.dumps(self.data)

    def restore(self, payload):
        import pickle

        self.data = pickle.loads(payload)

    def on_leader_change(self, leader):
        pass


def _leader(nodes, gid):
    return next((n for n in nodes.values() if n.is_leader(gid)), None)


def test_raft_add_then_remove_member(tmp_path):
    """Grow 3 -> 4 (new node catches up via snapshot/appends), then shrink
    back by removing an original member; the group stays writable."""
    net = InProcNet()
    nodes, sms = {}, {}
    for i in (1, 2, 3):
        nodes[i] = MultiRaft(i, net, wal_dir=str(tmp_path / f"n{i}"),
                             snapshot_every=8)
        sms[i] = _KVSM()
        nodes[i].create_group(5, [1, 2, 3], sms[i])
    assert run_until(net, lambda: _leader(nodes, 5) is not None)
    lead = _leader(nodes, 5)
    for i in range(20):  # enough entries to trigger a snapshot/compaction
        fut = lead.propose(5, (f"k{i}", i))
        assert run_until(net, fut.done)

    # add node 4: create its (empty) replica with the new membership, then
    # commit the config change — the leader streams it a snapshot
    nodes[4] = MultiRaft(4, net, wal_dir=str(tmp_path / "n4"), snapshot_every=8)
    sms[4] = _KVSM()
    nodes[4].create_group(5, [1, 2, 3, 4], sms[4])
    fut = lead.propose_config(5, "add", 4)
    assert run_until(net, fut.done)
    assert sorted(fut.result()) == [1, 2, 3, 4]
    assert run_until(net, lambda: sms[4].data.get("k19") == 19,
                     max_ticks=600), "new member never caught up"

    # remove node 1 (possibly the leader) and keep writing
    fut = _leader(nodes, 5).propose_config(5, "remove", 1)
    assert run_until(net, fut.done)
    nodes[1].remove_group(5)
    assert run_until(net, lambda: _leader(nodes, 5) is not None
                     and _leader(nodes, 5).node_id != 1, max_ticks=600)
    lead = _leader(nodes, 5)
    fut = lead.propose(5, ("after", "shrink"))
    assert run_until(net, fut.done)
    alive = [i for i in (2, 3, 4)]
    assert run_until(net, lambda: all(
        sms[i].data.get("after") == "shrink" for i in alive))


def test_raft_membership_survives_restart(tmp_path):
    """Config changes persist: a restarted node recovers the post-change
    peer set from WAL/snapshot, not its construction-time membership."""
    net = InProcNet()
    nodes, sms = {}, {}
    for i in (1, 2, 3):
        nodes[i] = MultiRaft(i, net, wal_dir=str(tmp_path / f"n{i}"))
        sms[i] = _KVSM()
        nodes[i].create_group(9, [1, 2, 3], sms[i])
    assert run_until(net, lambda: _leader(nodes, 9) is not None)
    lead = _leader(nodes, 9)
    fut = lead.propose_config(9, "remove", 3)
    assert run_until(net, fut.done)
    nodes[3].remove_group(9)
    # followers learn + persist the commit on later append rounds; the
    # restart below may only replay what node 2 durably knew
    assert run_until(net, lambda: sorted(nodes[2].groups[9].core.peers) == [1])

    # restart node 2 from its WAL with the ORIGINAL peer list; recovery must
    # land on the shrunk membership
    net2 = InProcNet()
    n2 = MultiRaft(2, net2, wal_dir=str(tmp_path / "n2"))
    sm2 = _KVSM()
    n2.create_group(9, [1, 2, 3], sm2)
    assert sorted(n2.groups[9].core.peers) == [1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = FsCluster(str(tmp_path_factory.mktemp("decom")), n_nodes=4,
                  blob_nodes=6, data_nodes=4, device=CPU)
    yield c
    c.close()


def test_decommission_metanode(cluster):
    cluster.create_volume("dmv", cold=True)
    fs = cluster.client("dmv")
    fs.mkdirs("/keep")
    fs.write_file("/keep/f.bin", b"re-homed namespace")

    vol = cluster.master().get_volume("dmv")
    victim = vol.meta_partitions[0].peers[0]
    moved = cluster.master().decommission_metanode(victim)
    assert moved >= 1

    vol = cluster.master().get_volume("dmv")
    for mp in vol.meta_partitions:
        assert victim not in mp.peers
        assert len(mp.peers) == 3
    # victim holds no partitions; namespace stays readable via new peers
    assert not cluster.metanodes[victim].partitions
    cluster.settle(lambda: any(
        cluster.rafts[p].is_leader(vol.meta_partitions[0].partition_id)
        for p in vol.meta_partitions[0].peers))
    fs2 = cluster.client("dmv")
    assert fs2.read_file("/keep/f.bin") == b"re-homed namespace"
    fs2.write_file("/keep/g.bin", b"still writable")


def test_decommission_datanode(cluster):
    cluster.create_volume("ddv", cold=False)
    fs = cluster.client("ddv")
    payload = b"hot data outlives its node " * 300
    fs.write_file("/hot.bin", payload)

    vol = cluster.master().get_volume("ddv")
    victim = vol.data_partitions[0].peers[0]
    moved = cluster.master().decommission_datanode(victim)
    assert moved >= 1

    vol = cluster.master().get_volume("ddv")
    for dp in vol.data_partitions:
        assert victim not in dp.peers
        assert len(dp.peers) == 3
    # extent repair back-fills the replacement replica, then the file reads
    # through the new host set
    cluster.repair_data_partitions()
    fs2 = cluster.client("ddv")
    assert fs2.read_file("/hot.bin") == payload
    fs2.write_file("/hot2.bin", b"writes keep flowing")
    assert fs2.read_file("/hot2.bin") == b"writes keep flowing"
