"""The cases of tests/test_raft.py, run against the port on the CPU.

Raft consensus: elections, replication, failures, snapshots, multi-group."""

import time

import pytest
import torch

from chubaofs_tpu_torch.raft import MultiRaft, InProcNet, NotLeaderError, StateMachine
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


class KvSM(StateMachine):
    """Tiny replicated KV used as the test state machine."""

    def __init__(self):
        self.kv = {}
        self.applied = []
        self.leader_changes = []

    def apply(self, data, index):
        op, k, v = data
        self.applied.append((index, data))
        if op == "set":
            self.kv[k] = v
            return ("ok", k)
        if op == "del":
            return self.kv.pop(k, None)

    def snapshot(self):
        import json

        return json.dumps(self.kv).encode()

    def restore(self, payload):
        import json

        self.kv = json.loads(payload)

    def on_leader_change(self, leader):
        self.leader_changes.append(leader)


def make_cluster(n=3, wal_root=None, snapshot_every=0):
    net = InProcNet()
    nodes, sms = {}, {}
    for i in range(1, n + 1):
        wal = f"{wal_root}/n{i}" if wal_root else None
        nodes[i] = MultiRaft(i, net, wal_dir=wal, snapshot_every=snapshot_every)
    for i in range(1, n + 1):
        sms[i] = KvSM()
        nodes[i].create_group(1, list(range(1, n + 1)), sms[i])
    return net, nodes, sms


def leader_id(nodes, group=1):
    leaders = [i for i, n in nodes.items() if n.is_leader(group)]
    return leaders[0] if len(leaders) == 1 else None


def test_single_node_group_commits_immediately():
    net = InProcNet()
    node = MultiRaft(1, net)
    sm = KvSM()
    node.create_group(1, [1], sm)
    assert run_until(net, lambda: node.is_leader(1))
    fut = node.propose(1, ("set", "a", 1))
    assert fut.result(timeout=1) == ("ok", "a")
    assert sm.kv == {"a": 1}


def test_election_and_replication():
    net, nodes, sms = make_cluster(3)
    assert run_until(net, lambda: leader_id(nodes) is not None)
    lead = leader_id(nodes)
    fut = nodes[lead].propose(1, ("set", "x", 42))
    assert run_until(net, lambda: fut.done())
    assert fut.result() == ("ok", "x")
    assert run_until(net, lambda: all(s.kv.get("x") == 42 for s in sms.values()))


def test_follower_propose_raises_not_leader():
    net, nodes, _ = make_cluster(3)
    assert run_until(net, lambda: leader_id(nodes) is not None)
    lead = leader_id(nodes)
    follower = next(i for i in nodes if i != lead)
    with pytest.raises(NotLeaderError) as ei:
        nodes[follower].propose(1, ("set", "y", 1))
    assert ei.value.leader == lead


def test_leader_failure_elects_new_and_preserves_log():
    net, nodes, sms = make_cluster(3)
    assert run_until(net, lambda: leader_id(nodes) is not None)
    lead = leader_id(nodes)
    fut = nodes[lead].propose(1, ("set", "k", "v"))
    assert run_until(net, lambda: fut.done())

    net.isolate(lead)  # old leader cut off
    others = [i for i in nodes if i != lead]
    assert run_until(
        net, lambda: any(nodes[i].is_leader(1) for i in others), max_ticks=600
    )
    new_lead = next(i for i in others if nodes[i].is_leader(1))
    f2 = nodes[new_lead].propose(1, ("set", "k2", "v2"))
    assert run_until(net, lambda: f2.done())
    assert sms[new_lead].kv == {"k": "v", "k2": "v2"}

    # healed old leader catches up and steps down
    net.heal()
    assert run_until(
        net,
        lambda: sms[lead].kv.get("k2") == "v2" and not nodes[lead].is_leader(1),
        max_ticks=600,
    )


def test_minority_partition_cannot_commit():
    net, nodes, _ = make_cluster(3)
    assert run_until(net, lambda: leader_id(nodes) is not None)
    lead = leader_id(nodes)
    net.isolate(lead)
    for _ in range(30):
        for n in nodes.values():
            n.tick()
    try:
        fut = nodes[lead].propose(1, ("set", "ghost", 1))
        for _ in range(100):
            for n in nodes.values():
                n.tick()
        assert not fut.done() or isinstance(fut.exception(), NotLeaderError)
    except NotLeaderError:
        pass  # already stepped down


def test_wal_recovery(tmp_path):
    net, nodes, sms = make_cluster(3, wal_root=str(tmp_path))
    assert run_until(net, lambda: leader_id(nodes) is not None)
    lead = leader_id(nodes)
    for i in range(5):
        fut = nodes[lead].propose(1, ("set", f"k{i}", i))
        assert run_until(net, lambda: fut.done())

    # "restart" node: fresh MultiRaft over the same WAL dir
    net2 = InProcNet()
    n1 = MultiRaft(lead, net2, wal_dir=str(tmp_path / f"n{lead}"))
    sm = KvSM()
    n1.create_group(1, [1, 2, 3], sm)
    assert sm.kv == {f"k{i}": i for i in range(5)}


def test_snapshot_compaction_and_catchup(tmp_path):
    net, nodes, sms = make_cluster(3, wal_root=str(tmp_path), snapshot_every=10)
    assert run_until(net, lambda: leader_id(nodes) is not None)
    lead = leader_id(nodes)

    laggard = next(i for i in nodes if i != lead)
    net.isolate(laggard)
    for i in range(40):
        fut = nodes[lead].propose(1, ("set", f"k{i}", i))
        assert run_until(net, lambda: fut.done(), max_ticks=600)
    # leader compacted beyond the laggard's log
    assert nodes[lead].groups[1].core.offset > 0

    net.heal()
    assert run_until(
        net, lambda: sms[laggard].kv.get("k39") == 39, max_ticks=900
    ), "laggard must catch up via snapshot install"


def test_many_groups_one_node():
    """Multi-raft: 5 groups multiplexed over the same 3 nodes."""
    net = InProcNet()
    nodes = {i: MultiRaft(i, net) for i in (1, 2, 3)}
    sms = {g: {} for g in range(1, 6)}
    for g in range(1, 6):
        for i in (1, 2, 3):
            sm = KvSM()
            sms[g][i] = sm
            nodes[i].create_group(g, [1, 2, 3], sm)
    assert run_until(
        net,
        lambda: all(leader_id(nodes, g) is not None for g in range(1, 6)),
        max_ticks=600,
    )
    for g in range(1, 6):
        lead = leader_id(nodes, g)
        fut = nodes[lead].propose(g, ("set", "g", g))
        assert run_until(net, lambda: fut.done())
    for g in range(1, 6):
        assert run_until(net, lambda: all(s.kv == {"g": g} for s in sms[g].values()))


def test_leader_change_callback():
    net, nodes, sms = make_cluster(3)
    assert run_until(net, lambda: leader_id(nodes) is not None)
    lead = leader_id(nodes)
    assert sms[lead].leader_changes[-1] == lead


# -- group commit: propose_batch ordering + atomicity ---------------------------


def test_propose_batch_fifo_across_singles_and_batches():
    """Interleaved propose() and propose_batch() apply in exact submission
    order on EVERY replica — group commit coalesces rounds, never reorders."""
    net, nodes, sms = make_cluster(3)
    assert run_until(net, lambda: leader_id(nodes) is not None)
    lead = nodes[leader_id(nodes)]
    futs, expected = [], []
    for i in range(3):
        batch = [("set", f"b{i}_{j}", j) for j in range(5)]
        futs += lead.propose_batch(1, batch)
        expected += [d[1] for d in batch]
        futs.append(lead.propose(1, ("set", f"s{i}", i)))
        expected.append(f"s{i}")
    assert run_until(net, lambda: all(f.done() for f in futs), max_ticks=600)
    for f in futs:
        assert f.exception() is None
    assert run_until(
        net, lambda: all(len(s.applied) >= len(expected) for s in sms.values()),
        max_ticks=600)
    for s in sms.values():
        keys = [d[1] for _, d in s.applied]
        assert keys == expected, "apply order diverged from submission order"


def test_propose_batch_error_fails_only_its_own_future():
    """Errors are VALUES through consensus: one EEXIST inside a drained
    batch fails exactly its own future; neighbors commit untouched."""
    import stat

    from chubaofs_tpu_torch.meta.metanode import MetaNode, OpError

    net = InProcNet()
    node = MultiRaft(1, net)
    mn = MetaNode(1, node)
    mn.create_partition(7, 1, 1 << 20, [1])
    assert run_until(net, lambda: node.is_leader(7))
    mode = stat.S_IFREG | 0o644
    futs = mn.submit_batch(7, [
        ("create_inode_dentry", {"parent": 1, "name": "a", "mode": mode}),
        ("create_inode_dentry", {"parent": 1, "name": "a", "mode": mode}),
        ("create_inode_dentry", {"parent": 1, "name": "b", "mode": mode}),
    ])
    assert futs[0].result(timeout=5).ino > 1
    with pytest.raises(OpError) as ei:
        futs[1].result(timeout=5)
    assert ei.value.code == "EEXIST"
    assert futs[2].result(timeout=5).ino > 1
    assert set(mn.partitions[7].children[1]) == {"a", "b"}


def test_propose_batch_stale_term_fails_each_stranded_future():
    """A batch stranded on a deposed leader: every entry overwritten by the
    new term fails its own future with NotLeaderError; the new leader's
    proposals are untouched."""
    net, nodes, sms = make_cluster(3)
    assert run_until(net, lambda: leader_id(nodes) is not None)
    old_id = leader_id(nodes)
    old = nodes[old_id]
    net.isolate(old_id)
    stranded = old.propose_batch(1, [("set", f"lost{i}", i) for i in range(3)])
    others = [i for i in nodes if i != old_id]
    assert run_until(
        net, lambda: any(nodes[i].is_leader(1) for i in others), max_ticks=600)
    new = nodes[next(i for i in others if nodes[i].is_leader(1))]
    # enough new-term entries to cover every stranded index
    wins = [new.propose(1, ("set", f"win{i}", i)) for i in range(5)]
    assert run_until(net, lambda: all(f.done() for f in wins), max_ticks=600)
    net.heal()
    assert run_until(
        net, lambda: all(f.done() for f in stranded), max_ticks=900)
    for f in stranded:
        assert isinstance(f.exception(), NotLeaderError)
    for f in wins:
        assert f.exception() is None
    assert run_until(
        net, lambda: all(s.kv.get("win4") == 4 for s in sms.values()),
        max_ticks=600)
    assert all("lost0" not in s.kv for s in sms.values())


def test_wal_persists_conflict_truncated_rewrites(tmp_path):
    """A deposed leader's WAL holds a stale unreplicated tail; the new
    term's entries overwrite it in memory — the rewritten span must reach
    the WAL too, or a crash-restart replays the stale suffix."""
    net, nodes, sms = make_cluster(3, wal_root=str(tmp_path))
    assert run_until(net, lambda: leader_id(nodes) is not None)
    old_id = leader_id(nodes)
    fut = nodes[old_id].propose(1, ("set", "base", 0))
    assert run_until(net, lambda: fut.done())

    net.isolate(old_id)
    nodes[old_id].propose_batch(1, [("set", f"stale{i}", i) for i in range(3)])
    time.sleep(0.2)  # pump drains + persists the doomed tail
    others = [i for i in nodes if i != old_id]
    assert run_until(
        net, lambda: any(nodes[i].is_leader(1) for i in others), max_ticks=600)
    new = nodes[next(i for i in others if nodes[i].is_leader(1))]
    wins = [new.propose(1, ("set", f"win{i}", i)) for i in range(4)]
    assert run_until(net, lambda: all(f.done() for f in wins), max_ticks=600)

    net.heal()
    assert run_until(
        net, lambda: sms[old_id].kv.get("win3") == 3, max_ticks=900)
    # crash-restart the deposed node from its WAL alone
    sm2 = KvSM()
    n2 = MultiRaft(old_id, InProcNet(), wal_dir=str(tmp_path / f"n{old_id}"))
    n2.create_group(1, [1, 2, 3], sm2)
    assert "stale0" not in sm2.kv, "recovery replayed a truncated stale tail"
    assert sm2.kv.get("base") == 0
    assert all(sm2.kv.get(f"win{i}") == i
               for i in range(4) if f"win{i}" in sms[old_id].kv)


# -- merged cross-group heartbeats (tiglabs raft README:18) ---------------------


def test_merged_heartbeats_one_message_per_peer_pair():
    """1,000 partitions != 1,000 heartbeat streams: a quiescent tick emits at
    most ONE group_hb per (src, dst) pair carrying every group's slice, and
    zero per-group appends."""
    net = InProcNet()
    nodes = {i: MultiRaft(i, net) for i in (1, 2, 3)}
    NG = 12
    gids = list(range(100, 100 + NG))
    for gid in gids:
        for n in nodes.values():
            n.create_group(gid, [1, 2, 3], KvSM())
    assert run_until(net, lambda: all(
        any(n.is_leader(g) for n in nodes.values()) for g in gids))
    for _ in range(6):  # drain no-op barrier replication; reach quiescence
        for n in nodes.values():
            n.tick()

    sent = []
    orig = net.send

    def spy(msgs):
        sent.extend(msgs)
        orig(msgs)

    net.send = spy
    # HEARTBEAT_TICKS=2: two ticks guarantee every leader beats exactly once
    # (groups' elapsed phases differ, so beats spread over the two ticks)
    total_slices = 0
    for _ in range(2):
        sent.clear()
        for n in nodes.values():
            n.tick()
        appends = [m for m in sent if m.type == "append"]
        assert not appends, f"quiescent tick sent per-group appends: {appends[:3]}"
        hbs = [m for m in sent if m.type == "group_hb"]
        pairs = [(m.src, m.dst) for m in hbs]
        assert len(pairs) == len(set(pairs)), \
            "more than one heartbeat message per peer pair in one tick"
        total_slices += sum(len(m.hb) for m in hbs)
    net.send = orig
    # every group rode some merged message, each to both followers
    assert total_slices == NG * 2


def test_merged_heartbeats_suppress_elections_and_propagate_commit():
    net = InProcNet()
    nodes = {i: MultiRaft(i, net) for i in (1, 2, 3)}
    sms = {i: KvSM() for i in nodes}
    for i, n in nodes.items():
        n.create_group(5, [1, 2, 3], sms[i])
    assert run_until(net, lambda: any(n.is_leader(5) for n in nodes.values()))
    lead = next(n for n in nodes.values() if n.is_leader(5))
    term0 = lead.groups[5].core.term
    fut = lead.propose(5, ("set", "k", 1))
    assert run_until(net, lambda: fut.done())
    # long quiescent stretch: merged heartbeats keep followers from campaigning
    for _ in range(60):
        for n in nodes.values():
            n.tick()
    assert lead.is_leader(5)
    assert lead.groups[5].core.term == term0
    # commit propagated to every replica (rides the merged beat)
    assert all(sm.kv.get("k") == 1 for sm in sms.values())


def test_merged_heartbeat_dethrones_stale_leader():
    net = InProcNet()
    nodes = {i: MultiRaft(i, net) for i in (1, 2, 3)}
    for i, n in nodes.items():
        n.create_group(7, [1, 2, 3], KvSM())
    assert run_until(net, lambda: any(n.is_leader(7) for n in nodes.values()))
    old = next(n for n in nodes.values() if n.is_leader(7))
    net.isolate(old.node_id)
    others = [n for n in nodes.values() if n is not old]
    assert run_until(net, lambda: any(n.is_leader(7) for n in others))
    net.heal()
    # the deposed leader's merged beat draws a stale response (or the new
    # leader's beat carries the higher term) — either way it steps down
    assert run_until(net, lambda: not old.is_leader(7))


def test_follower_commits_no_further_than_the_appended_entries():
    """A follower whose log runs past the entries of a leader's append (a
    deposed leader's uncommitted proposals, not yet overwritten) commits no
    further than the append's last entry, whatever the leader's commit
    index. Applying that tail would answer its proposer's waiter with a
    success the cluster never committed: a write acknowledged, then lost.
    The JAX package's core commits up to its own last entry and applies
    the stale one."""
    from chubaofs_tpu.raft.core import Entry as JEntry
    from chubaofs_tpu.raft.core import Msg as JMsg
    from chubaofs_tpu.raft.core import RaftCore as JRaftCore
    from chubaofs_tpu_torch.raft.core import Entry, Msg, RaftCore

    def run(core_cls, entry_cls, msg_cls):
        # node 2 led term 2 and proposed index 3; node 1 won term 3 without it
        f = core_cls(1, 2, [1, 2, 3])
        f.term = 2
        f.entries = [entry_cls(1, ("set", "a", 1)), entry_cls(1, ("set", "b", 2)),
                     entry_cls(2, ("set", "stale", 3))]
        f.step(msg_cls(type="append", group=1, src=1, dst=2, term=3, prev_index=2,
                       prev_term=1, entries=[], commit=3))
        _, committed = f.ready()
        return f.commit, [(i, e.data) for i, e in committed]

    assert run(RaftCore, Entry, Msg) == (2, [(1, ("set", "a", 1)), (2, ("set", "b", 2))])
    assert run(JRaftCore, JEntry, JMsg)[1][-1] == (3, ("set", "stale", 3))
    # the leader's next append overwrites the stale entry, and then it commits
    f = RaftCore(1, 2, [1, 2, 3])
    f.term = 2
    f.entries = [Entry(1, ("set", "a", 1)), Entry(1, ("set", "b", 2)),
                 Entry(2, ("set", "stale", 3))]
    f.step(Msg(type="append", group=1, src=1, dst=2, term=3, prev_index=2, prev_term=1,
               entries=[Entry(3, ("set", "c", 3))], commit=3))
    _, committed = f.ready()
    assert f.commit == 3 and committed[-1][1].data == ("set", "c", 3)
