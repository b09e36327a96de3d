"""The cases of tests/test_meta_scale.py, run against the port on the CPU.

Metadata scale-out: mid-range load splits, cross-metanode
migration, refresh-safe SDK routing, and the observability riders.

Routing-race coverage (the split battery) runs over the in-process
FsCluster — the same SMs/raft/hooks the daemons wire, minus the TCP layer —
with a deep-copied view adapter standing in for remote mode where the test
needs a genuinely STALE client view (in-process the cached view objects are
the master's live dataclasses, so staleness needs simulating). The
crash-restart halves live in the --meta-split chaos soak (real daemons,
SIGKILL mid-split/mid-migration)."""

import copy
import stat as stat_mod
import threading

import pytest
import torch

from chubaofs_tpu_torch.deploy import FsCluster
from chubaofs_tpu_torch.master.master import INF, MasterSM, MetaPartitionView
from chubaofs_tpu_torch.meta.metanode import OpError
from chubaofs_tpu_torch.meta.partition import MetaPartitionSM
from chubaofs_tpu_torch.sdk.meta_wrapper import MetaWrapper

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


@pytest.fixture
def cluster(tmp_path):
    c = FsCluster(str(tmp_path / "fs"), n_nodes=5, blob_nodes=0,
                  data_nodes=0, device=CPU)
    try:
        c.master().create_volume("msvol", "t", 1 << 30, cold=True)
        yield c
    finally:
        c.close()


def _seed_dirs(fs, dirs=4, files=6):
    """Directories interleaved with files so dir inos straddle the median."""
    dir_inos = {}
    for d in range(dirs):
        dir_inos[d] = fs.mkdirs(f"/d{d}")
        for i in range(files):
            fs.create(f"/d{d}/seed{i}")
    return dir_inos


def _split_first(c, vol="msvol"):
    mp = sorted(c.master().get_volume(vol).meta_partitions,
                key=lambda m: m.start)[0]
    new_pid = c.master().split_meta_partition(vol, mp.partition_id)
    assert new_pid, "partition declined the split"
    return mp.partition_id, new_pid


class _FrozenViewMaster:
    """Duck-typed master returning DEEP-COPIED views — the remote-mode
    shape, where a client's cached view is a snapshot that does NOT see
    master-side splits until it refreshes."""

    def __init__(self, master):
        self._m = master

    def get_volume(self, name):
        return copy.deepcopy(self._m.get_volume(name))


# -- routing: bisect index -----------------------------------------------------


def test_partition_of_bisect_routing_many_partitions():
    """O(log n) routing answers exactly like the linear scan at hundreds of
    partitions: every boundary ino (start, end-1) routes to its owner, a
    pre-range ino errors, and the tail keeps the open range."""
    from chubaofs_tpu_torch.master.master import MasterError, VolumeView

    view = VolumeView(name="v", vol_id=1, owner="t", capacity=1, cold=True)
    bounds = list(range(1, 2002, 10))  # 200 partitions of width 10
    for i, s in enumerate(bounds):
        e = INF if i == len(bounds) - 1 else bounds[i + 1]
        view.meta_partitions.append(
            MetaPartitionView(1000 + i, start=s, end=e))

    class _M:
        def get_volume(self, name):
            return view

    w = MetaWrapper(_M(), {}, "v")
    for i, s in enumerate(bounds):
        assert w.partition_of(s).partition_id == 1000 + i
        if i < len(bounds) - 1:
            assert w.partition_of(bounds[i + 1] - 1).partition_id == 1000 + i
    assert w.tail_partition().partition_id == 1000 + len(bounds) - 1
    assert w.partition_of(10 ** 9).partition_id == 1000 + len(bounds) - 1
    with pytest.raises(MasterError):
        w.partition_of(0)  # below every range: no owner, even after refresh


# -- mid-range split: correctness across the boundary --------------------------


def test_split_then_lookup_readdir_across_boundary(cluster):
    """A mid-range split moves the upper half to a sibling; lookups,
    read_dirs and get_inodes on BOTH sides keep answering, including via a
    client whose cached view predates the split (EWRONGPART -> one refresh
    -> re-route, never a failed op)."""
    c = cluster
    fs = c.client("msvol")
    dir_inos = _seed_dirs(fs)
    # a client with a deep-copied (genuinely stale-able) view, warmed now
    stale_fs = MetaWrapper(_FrozenViewMaster(c.master()),
                           c.metanodes, "msvol")
    stale_fs.VIEW_TTL = 300.0
    stale_fs.refresh_view()
    old_pid, new_pid = _split_first(c)
    view = sorted(c.master().get_volume("msvol").meta_partitions,
                  key=lambda m: m.start)
    assert [m.partition_id for m in view[:2]] == [old_pid, new_pid]
    assert view[0].end == view[1].start  # contiguous, disjoint
    split_at = view[0].end
    below = [i for i in dir_inos.values() if i < split_at]
    above = [i for i in dir_inos.values() if i >= split_at]
    assert below and above, f"split {split_at} left dirs on one side only"
    # fresh-view client: every dir lists its exact seed set
    for d, ino in dir_inos.items():
        names = fs.readdir(f"/d{d}")
        assert {n for n in names if n.startswith("seed")} == \
            {f"seed{i}" for i in range(6)}, (d, names)
        assert fs.stat(f"/d{d}/seed0")["ino"]
    # stale-view client: ops on MOVED inos hit the old partition, get
    # EWRONGPART, refresh once, land on the sibling
    for ino in above:
        assert stale_fs.get_inode(ino).ino == ino
        assert stale_fs.read_dir(ino)
    for ino in below:
        assert stale_fs.get_inode(ino).ino == ino


def test_stale_view_op_retries_once_after_refresh(cluster):
    """The EWRONGPART dance is exactly one refresh for a post-swap stale
    view — for a read AND for a routed write — and the op succeeds instead
    of failing; nothing double-applies."""
    c = cluster
    fs = c.client("msvol")
    dir_inos = _seed_dirs(fs)

    def stale_wrapper():
        w = MetaWrapper(_FrozenViewMaster(c.master()), c.metanodes, "msvol")
        w.VIEW_TTL = 300.0
        w.refresh_view()
        refreshes = []
        real = w.refresh_view

        def counting():
            refreshes.append(1)
            return real()

        w.refresh_view = counting
        return w, refreshes

    reader, r_refreshes = stale_wrapper()
    writer, w_refreshes = stale_wrapper()
    _split_first(c)
    split_at = sorted(c.master().get_volume("msvol").meta_partitions,
                      key=lambda m: m.start)[0].end
    moved = next(i for i in dir_inos.values() if i >= split_at)
    assert reader.get_inode(moved).ino == moved  # read: one refresh
    assert r_refreshes == [1]
    writer.set_xattr(moved, "k", b"v")  # routed write: one refresh
    assert w_refreshes == [1]
    assert reader.get_inode(moved).xattrs["k"] == b"v"
    assert r_refreshes == [1]  # refreshed route is CACHED, not re-fetched


def test_concurrent_creates_during_live_split(cluster, monkeypatch):
    """Creates racing a live mid-range split: every acked create lands
    exactly once (no loss, no dup dentry), no duplicate ino is ever handed
    out, and afterwards every live ino is owned by exactly ONE partition SM
    whose view range contains it. EXPORT_BATCH=1 stretches the freeze
    window across many export/import rounds so creates genuinely interleave
    with the copy (in-process the default batch finishes in one page)."""
    monkeypatch.setattr(MetaPartitionSM, "EXPORT_BATCH", 1)
    c = cluster
    fs0 = c.client("msvol")
    dir_inos = _seed_dirs(fs0, dirs=4, files=8)
    stop = threading.Event()
    # pre-populated: creators only APPEND, so the main thread's count()
    # never iterates a dict mid-insert
    made: dict[int, list] = {t: [] for t in range(3)}
    errs: list = []
    count = lambda: sum(len(v) for v in made.values())  # noqa: E731

    def creator(t: int):
        fs = c.client("msvol")
        mine = made[t]
        i = 0
        while not stop.is_set() and i < 400:
            d = (t + i) % 4
            path = f"/d{d}/t{t}_f{i}"
            i += 1
            try:
                fs.create(path)
                mine.append((d, path.rsplit('/', 1)[1],
                             fs.stat(path)["ino"]))
            except Exception as e:  # in-process: nothing may fail
                errs.append((path, repr(e)))
                return

    threads = [threading.Thread(target=creator, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    try:
        while count() < 10 and not errs:  # creates BEFORE the freeze
            pass
        before = count()
        _split_first(c)  # freeze -> copy -> swap -> complete, under load
        deadline = threading.Event()
        while count() < before + 20 and not errs \
                and not deadline.wait(0.01):  # creates AFTER the swap
            pass
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errs, errs[:3]
    acked = [rec for per in made.values() for rec in per]
    assert len(acked) >= 30, "creators barely ran; race untested"
    inos = [ino for _, _, ino in acked]
    assert len(set(inos)) == len(inos), "duplicate ino handed out"
    by_dir: dict[int, list] = {}
    for d, name, _ in acked:
        by_dir.setdefault(d, []).append(name)
    for d, names in by_dir.items():
        listed = fs0.readdir(f"/d{d}")
        assert len(listed) == len(set(listed)), f"dup dentries in /d{d}"
        missing = set(names) - set(listed)
        assert not missing, f"/d{d} lost acked creates: {sorted(missing)[:5]}"
    # exactly-one-owner census over the live SMs (leaders only)
    view = sorted(c.master().get_volume("msvol").meta_partitions,
                  key=lambda m: m.start)
    owner: dict[int, int] = {}
    for m in view:
        sm = next(mn.partitions[m.partition_id] for mn in c.metanodes.values()
                  if m.partition_id in mn.partitions
                  and mn.raft.is_leader(m.partition_id))
        for ino in sm.inodes:
            assert m.start <= ino < m.end, \
                f"partition {m.partition_id} holds out-of-range ino {ino}"
            assert ino not in owner, \
                f"ino {ino} owned by {owner[ino]} and {m.partition_id}"
            owner[ino] = m.partition_id


def test_quota_usage_conserved_across_split(cluster):
    """Quota-drift regression: a quota'd tree split across two partitions
    keeps aggregate usage exact. Moved entries' usage transfers WITH them
    (the sibling recounts from imported state, the source sheds it at
    complete), so deletes debit the side that now holds the charge and
    delete-all frees the FULL headroom — before the fix the sibling's debit
    clamped at zero while the source kept the stale charge forever, so an
    empty directory eventually answered EDQUOT."""
    from chubaofs_tpu_torch.sdk.fs import FsError

    c = cluster
    fs = c.client("msvol")
    fs.mkdirs("/q")
    QID, CAP = 77, 24
    fs.meta.set_quota(fs.resolve("/q"), quota_id=QID, max_files=CAP)
    files = []
    for d in range(4):  # dirs interleaved with files: the median split
        fs.mkdirs(f"/q/d{d}")  # leaves charged entries on BOTH sides
        for i in range(5):
            p = f"/q/d{d}/f{i}"
            fs.create(p)
            # size growth through the extent path = the byte charge
            fs.meta.append_obj_extents(fs.resolve(p), [], 10)
            files.append(p)
    assert fs.meta.quota_usage(QID) == {"files": 24, "bytes": 200}
    with pytest.raises(FsError) as e:
        fs.create("/q/overflow")  # 4 dirs + 20 files = CAP: quota is full
    assert e.value.code == "EDQUOT"

    _split_first(c)
    split_at = sorted(c.master().get_volume("msvol").meta_partitions,
                      key=lambda m: m.start)[0].end
    d_inos = [fs.resolve(f"/q/d{d}") for d in range(4)]
    assert [i for i in d_inos if i < split_at] \
        and [i for i in d_inos if i >= split_at], \
        f"split {split_at} left every quota'd dir on one side"
    # aggregate conserved across the split: usage moved WITH the entries
    assert fs.meta.quota_usage(QID) == {"files": 24, "bytes": 200}

    for p in files:
        fs.unlink(p)
    for d in range(4):
        fs.rmdir(f"/q/d{d}")
    assert fs.meta.quota_usage(QID) == {"files": 0, "bytes": 0}
    for i in range(CAP):  # the FULL headroom is reusable post-split
        fs.create(f"/q/re{i}")
    with pytest.raises(FsError) as e:
        fs.create("/q/one_too_many")  # and the cap still enforces
    assert e.value.code == "EDQUOT"


# -- genesis-range replay (the soak-caught loss bug) ---------------------------


def test_replay_into_genesis_range_recovers_split_partition():
    """Crash-restart replay regression (caught by the --meta-split soak):
    ops recorded BEFORE an in-log range shrink were applied under the
    genesis range; a recovering SM must be created with it — born with the
    post-split VIEW range instead, replay silently refuses pre-shrink
    allocations and committed files vanish."""
    live = MetaPartitionSM(7, 1, INF)
    log: list = []

    def apply(op, **args):
        log.append((op, args))
        return live.apply((op, args), len(log))

    root_dir = 1  # ROOT_INO pre-created
    apply("create_inode_dentry", parent=root_dir, name="d", mode=16877,
          quota_ids=[])
    d_ino = live.dentries[(root_dir, "d")].ino
    for i in range(8):
        apply("create_inode_dentry", parent=d_ino, name=f"f{i}", mode=33188,
              quota_ids=[])
    split_at = live.split_point()
    assert split_at
    apply("freeze_range", split_at=split_at, new_pid=8, new_peers=[])
    apply("complete_split")

    genesis = MetaPartitionSM(7, 1, INF)  # what re-hosting must pass
    for idx, (op, args) in enumerate(log, 1):
        genesis.apply((op, args), idx)
    assert genesis.inodes.keys() == live.inodes.keys()
    assert genesis.dentries.keys() == live.dentries.keys()
    assert (genesis.start, genesis.end) == (live.start, live.end)

    shrunk = MetaPartitionSM(7, 1, split_at)  # the buggy re-host shape
    for idx, (op, args) in enumerate(log, 1):
        shrunk.apply((op, args), idx)
    # the loss shape the soak caught: a combined create whose PARENT is
    # below the cut but whose allocated ino lands above it refuses to
    # replay wholesale under the view range — the dentry (which never
    # moved) vanishes with it
    assert shrunk.dentries.keys() != live.dentries.keys(), \
        "view-range replay should lose dentries — fixture no longer bites"


def test_view_genesis_survives_splits_and_snapshot(cluster):
    """MetaPartitionView.start0/end0 record the creation range through a
    mid-range split + a chained cursor split, and round-trip the MasterSM
    snapshot — every re-host path reads them."""
    c = cluster
    fs = c.client("msvol")
    _seed_dirs(fs)
    old_pid, new_pid = _split_first(c)
    view = {m.partition_id: m
            for m in c.master().get_volume("msvol").meta_partitions}
    old, sib = view[old_pid], view[new_pid]
    assert (old.start0, old.end0) == (1, INF)  # created as [1, INF)
    assert old.end < INF  # live view shrank at the split
    assert sib.start0 == old.end  # sibling created at the split point
    assert sib.end0 == INF  # inherited the open tail range at creation
    if sib.end < INF:  # the chained cursor split capped the sibling's VIEW
        assert sib.end0 > sib.end
    blob = c.master().sm.snapshot()
    sm2 = MasterSM()
    sm2.restore(blob)
    view2 = {m.partition_id: m
             for m in sm2.volumes["msvol"].meta_partitions}
    for pid in (old_pid, new_pid):
        assert (view2[pid].start0, view2[pid].end0) == \
            (view[pid].start0, view[pid].end0)
        assert (view2[pid].start, view2[pid].end) == \
            (view[pid].start, view[pid].end)


# -- load accounting + rebalance + events --------------------------------------


def test_take_loads_window_and_maintenance_exclusion(cluster):
    """take_loads returns one window's per-partition delta then resets;
    refund folds an unreported window back; split/maintenance plumbing ops
    never count (the splitter must not chase its own cure)."""
    c = cluster
    fs = c.client("msvol")
    for mn in c.metanodes.values():
        mn.take_loads()  # drain boot-time noise
    _seed_dirs(fs, dirs=2, files=3)
    loads = {}
    for mn in c.metanodes.values():
        for pid, n in mn.take_loads().items():
            loads[pid] = loads.get(pid, 0) + n
    assert loads and all(n > 0 for n in loads.values())
    for mn in c.metanodes.values():
        assert mn.take_loads() == {}  # window reset
    mn = next(iter(c.metanodes.values()))
    mn.refund_loads({99: 5})
    assert mn.take_loads() == {99: 5}
    # maintenance ops: a split leaves NO load trace
    for mn in c.metanodes.values():
        mn.take_loads()
    _split_first(c)
    after = {}
    for mn in c.metanodes.values():
        for pid, n in mn.take_loads().items():
            after[pid] = after.get(pid, 0) + n
    assert not after, f"split plumbing counted as client load: {after}"
    # a misdirected write (follower answers NotLeaderError before anything
    # serves) must not count — phantom leader-hunt load would feed the
    # splitter a partition that served no traffic
    from chubaofs_tpu_torch.raft.server import NotLeaderError

    mp = sorted(c.master().get_volume("msvol").meta_partitions,
                key=lambda m: m.start)[0]
    follower = next(c.metanodes[p] for p in mp.peers
                    if not c.metanodes[p].raft.is_leader(mp.partition_id))
    with pytest.raises(NotLeaderError):
        follower.submit(mp.partition_id, "update_inode", ino=1)
    assert follower.take_loads().get(mp.partition_id) is None, \
        "follower-rejected submit counted as served load"


def test_split_and_migrate_events_and_metric(cluster):
    """meta_split freeze -> commit -> complete (causally ordered) and
    meta_migrate add_peer -> remove_peer land on the event journal, and
    cfs_metanode_partition_ops{pid} renders under the declared-pid guard."""
    from chubaofs_tpu_torch.utils import events, exporter

    c = cluster
    fs = c.client("msvol")
    _seed_dirs(fs)
    old_pid, new_pid = _split_first(c)
    evs = [e for e in events.recent(500, types=("meta_split",))
           if e.get("detail", {}).get("new_pid") == new_pid]
    phases = [e["detail"]["phase"] for e in evs]
    for want in ("freeze", "commit", "complete"):
        assert want in phases, (want, phases)
    assert phases.index("freeze") < phases.index("commit") \
        < phases.index("complete")
    # migration: report a deterministic load shape — one node hot on TWO
    # partitions (shedding only the hottest is then a strict improvement;
    # a node hot on ONE partition correctly declines: moving it would just
    # relocate the hotspot). The membership dance itself is real.
    view = sorted(c.master().get_volume("msvol").meta_partitions,
                  key=lambda m: m.start)
    hot = view[0].peers[0]
    for nid in c.metanodes:
        c.master().heartbeat(
            nid, loads={view[0].partition_id: 80.0,
                        view[1].partition_id: 30.0} if nid == hot else {})
    moved = c.master().rebalance_meta(factor=0.5, max_moves=1)
    assert moved == 1, c.master().meta_node_loads()
    assert hot not in next(
        m for m in c.master().get_volume("msvol").meta_partitions
        if m.partition_id == view[0].partition_id).peers
    mig = [e["detail"]["phase"]
           for e in events.recent(500, types=("meta_migrate",))]
    assert "add_peer" in mig and "remove_peer" in mig, mig
    text = exporter.render_all()
    assert "cfs_metanode_partition_ops{" in text
    assert "cfs_metanode_partitions" in text
    # replica sets stay 3-wide and the view stays contiguous after the move
    view = sorted(c.master().get_volume("msvol").meta_partitions,
                  key=lambda m: m.start)
    assert all(len(m.peers) == 3 for m in view)
    for a, b in zip(view, view[1:]):
        assert a.end == b.start


# -- cfs-top META column row math ----------------------------------------------


def test_cfstop_meta_column_math():
    """META renders `parts/hot-ops`: partitions from the state gauge, hot
    ops/s as the MAX per-pid window rate (per-series deltas — summing would
    hide the skew the splitter acts on), restart-clamped; '-' off-metanodes
    and for hot-ops on a first frame."""
    from chubaofs_tpu_torch.tools.cfstop import COLUMNS, compute_row, render

    assert "META" in COLUMNS
    prev = {"cfs_metanode_partitions": 3.0,
            'cfs_metanode_partition_ops{pid="101"}': 100.0,
            'cfs_metanode_partition_ops{pid="102"}': 50.0}
    cur = {"cfs_metanode_partitions": 3.0,
           'cfs_metanode_partition_ops{pid="101"}': 220.0,
           'cfs_metanode_partition_ops{pid="102"}': 70.0}
    row = compute_row("mn:1", prev, cur, 10.0, {"status": "ok"})
    assert row["meta_parts"] == 3
    assert row["meta_hot_ops"] == 12.0  # max(120, 20) / 10s, not the sum
    assert "3/12" in render([row])
    # restart: counter fell — the post-restart total IS the window
    restarted = {"cfs_metanode_partitions": 3.0,
                 'cfs_metanode_partition_ops{pid="101"}': 40.0}
    row = compute_row("mn:1", prev, restarted, 10.0, {"status": "ok"})
    assert row["meta_hot_ops"] == 4.0
    # a target with no meta partitions renders '-', never a fake 0/0
    from chubaofs_tpu_torch.tools.cfstop import _meta_cell

    row = compute_row("dn:1", {"x": 1.0}, {"x": 2.0}, 10.0, {"status": "ok"})
    assert row["meta_parts"] is None
    assert _meta_cell(row) == "-"
    # first frame: parts render from the current gauge, hot-ops stays '-'
    fresh = compute_row("mn:2", None, cur, 10.0, {"status": "ok"})
    assert fresh["meta_parts"] == 3
    assert fresh.get("meta_hot_ops") is None
    assert "3/-" in render([fresh])


# -- create-path routing through splits ----------------------------------------


def test_create_file_fast_path_recheck_after_split(cluster):
    """create_file on a stale view re-checks routing after the EWRONGPART
    refresh instead of silently demoting every create to the two-op flow:
    a parent whose partition still allocates keeps the ONE-commit path
    through a concurrent split; a parent on a range-capped partition falls
    back (returns None) only after a real ERANGE."""
    c = cluster
    fs = c.client("msvol")
    dir_inos = _seed_dirs(fs)
    stale = MetaWrapper(_FrozenViewMaster(c.master()), c.metanodes, "msvol")
    stale.VIEW_TTL = 300.0
    stale.refresh_view()
    _split_first(c)
    split_at = sorted(c.master().get_volume("msvol").meta_partitions,
                      key=lambda m: m.start)[0].end
    moved_dir = next(i for i in dir_inos.values() if i >= split_at)
    inode = stale.create_file(moved_dir, "fast", stat_mod.S_IFREG | 0o644)
    assert inode is not None, \
        "fast path silently demoted to two-op through the split"
    assert [d.name for d in stale.read_dir(moved_dir)].count("fast") == 1
    with pytest.raises(OpError):
        # double-create through the refreshed route conflicts cleanly
        stale.create_file(moved_dir, "fast", stat_mod.S_IFREG | 0o644)


# -- hardening regressions -----------------------------------------------------


def test_split_refusals_raise_esplit_immediately(cluster):
    """Split-orchestration refusals (freeze conflict, frozen set_range_end,
    unfrozen export) carry ESPLIT — a code the meta-op hooks do NOT classify
    as a retryable transport failure. Before, they raised bare MetaError
    (code EIO) and the hooks blind-retried the doomed op against a 20-30s
    deadline while holding _decomm_lock."""
    import time

    c = cluster
    fs = c.client("msvol")
    _seed_dirs(fs)
    lead = c.master()
    mp = lead.get_volume("msvol").meta_partitions[0]
    sp = c._meta_op(mp.partition_id, mp.peers, "split_point", {}, read=True)
    assert sp
    pid_a = lead._apply("alloc_id")
    c._meta_op(mp.partition_id, mp.peers, "freeze_range",
               {"split_at": sp, "new_pid": pid_a, "new_peers": []})
    try:
        t0 = time.monotonic()
        with pytest.raises(OpError) as e:  # conflicting split identity
            c._meta_op(mp.partition_id, mp.peers, "freeze_range",
                       {"split_at": sp + 1, "new_pid": pid_a + 1,
                        "new_peers": []})
        assert e.value.code == "ESPLIT"
        with pytest.raises(OpError) as e:  # frozen range refuses shrink
            c._meta_op(mp.partition_id, mp.peers, "set_range_end",
                       {"end": sp})
        assert e.value.code == "ESPLIT"
        assert time.monotonic() - t0 < 5, \
            "refusals were retried against the hook deadline, not raised"
    finally:
        c._meta_op(mp.partition_id, mp.peers, "unfreeze_range", {})
    with pytest.raises(OpError) as e:  # export demands the freeze
        c._meta_op(mp.partition_id, mp.peers, "export_range",
                   {"after": 0}, read=True)
    assert e.value.code == "ESPLIT"


def test_quota_conservation_with_multipage_import(cluster, monkeypatch):
    """The sibling recounts quota usage on the FINAL imported page only
    (per-page recounts made the copy quadratic on the apply thread) — a
    multi-page copy must land the exact same conserved usage as the
    single-page shape."""
    monkeypatch.setattr(MetaPartitionSM, "EXPORT_BATCH", 1)
    test_quota_usage_conserved_across_split(cluster)


def test_frozen_tail_does_not_wedge_the_growth_sweep(cluster, monkeypatch):
    """A load split of the TAIL stranded mid-flight (orchestrator died
    after the freeze) leaves the tail frozen; when the cursor is also near
    the range bound, check_meta_partitions used to fire set_range_end
    FIRST, abort on the refusal, and never reach resume_meta_splits — the
    split (and every later sweep pass) stayed stuck. Resume now runs first
    and the cursor branch is guarded per-volume."""
    import chubaofs_tpu_torch.master.master as master_mod

    c = cluster
    fs = c.client("msvol")
    _seed_dirs(fs)
    lead = c.master()
    mp = lead.get_volume("msvol").meta_partitions[0]
    assert mp.end >= INF  # the tail
    sp = c._meta_op(mp.partition_id, mp.peers, "split_point", {}, read=True)
    new_pid = lead._apply("alloc_id")
    c._meta_op(mp.partition_id, mp.peers, "freeze_range",
               {"split_at": sp, "new_pid": new_pid, "new_peers": []})
    # shrink the step so the seeded cursor counts as "near the bound"
    monkeypatch.setattr(master_mod, "META_RANGE_STEP", 8)
    c.heartbeat_metanodes()  # cursors + the frozen-split report
    lead.check_meta_partitions()  # must not raise, must resume the split
    view = sorted(lead.get_volume("msvol").meta_partitions,
                  key=lambda m: m.start)
    assert len(view) >= 2 and any(m.partition_id == new_pid for m in view)
    for m in view:  # the fence is lifted everywhere
        for mn in c.metanodes.values():
            sm = mn.partitions.get(m.partition_id)
            assert sm is None or sm.frozen_from is None


def test_resume_after_swap_still_chains_tail_split(cluster, monkeypatch):
    """Orchestrator death between the view swap and complete_split: the
    resume sweep's already-swapped branch used to finish the cleanup but
    skip the chained cursor split of a TAIL load split, settling the volume
    at 2 partitions with the sibling re-forming the hotspot (and the
    --meta-split soak's >=3-partition settle timing out)."""
    c = cluster
    fs = c.client("msvol")
    _seed_dirs(fs)
    lead = c.master()
    mp = lead.get_volume("msvol").meta_partitions[0]
    orig = lead.meta_op_hook
    died = {"n": 0}

    def hook(pid, peers, op, args, read=False):
        if op == "complete_split" and died["n"] == 0:
            died["n"] += 1
            raise RuntimeError("orchestrator died after the swap")
        return orig(pid, peers, op, args, read=read)

    monkeypatch.setattr(lead, "meta_op_hook", hook)
    with pytest.raises(RuntimeError):
        lead.split_meta_partition("msvol", mp.partition_id)
    assert died["n"] == 1
    assert len(lead.get_volume("msvol").meta_partitions) == 2  # swapped
    c.heartbeat_metanodes()  # the frozen source reports its split_info
    lead.check_meta_partitions()
    view = sorted(lead.get_volume("msvol").meta_partitions,
                  key=lambda m: m.start)
    assert len(view) == 3, "resume finished the cleanup but skipped the chain"
    assert sum(1 for m in view if m.end >= INF) == 1  # one open tail
    for a, b in zip(view, view[1:]):
        assert a.end == b.start  # contiguous, no gap/overlap


def test_route_guard_bounces_do_not_count_as_load(cluster):
    """EWRONGPART refusals are not served load: during a split's
    freeze->swap gap every blocked client retries into the route guard,
    and counting those bounces would re-trip CFS_META_SPLIT_OPS on the
    partition the split just relieved (write path counts on the commit
    outcome; reads refund the pre-counted tally)."""
    c = cluster
    fs = c.client("msvol")
    dir_inos = _seed_dirs(fs)
    lead = c.master()
    mp = lead.get_volume("msvol").meta_partitions[0]
    pid = mp.partition_id
    sp = c._meta_op(pid, mp.peers, "split_point", {}, read=True)
    frozen_dir = next((i for i in dir_inos.values() if i >= sp), None)
    assert frozen_dir is not None, "no seeded dir above the median"
    new_pid = lead._apply("alloc_id")
    c._meta_op(pid, mp.peers, "freeze_range",
               {"split_at": sp, "new_pid": new_pid, "new_peers": []})
    try:
        mn = next(m for m in c.metanodes.values()
                  if pid in m.partitions and m.raft.is_leader(pid))
        mn.take_loads()  # drain the seeding window
        with pytest.raises(OpError) as e:  # read bounce: tally refunded
            mn.lookup(pid, frozen_dir, "absent")
        assert e.value.code == "EWRONGPART"
        with pytest.raises(OpError) as e:  # write bounce: never tallied
            mn.submit_sync(pid, "delete_dentry", parent=frozen_dir,
                           name="absent")
        assert e.value.code == "EWRONGPART"
        assert mn.take_loads().get(pid, 0) == 0, \
            "route-guard bounces tallied as served load"
        # a genuinely served op still counts on its commit outcome
        below = next(i for i in dir_inos.values() if i < sp)
        with pytest.raises(OpError) as e:
            mn.submit_sync(pid, "delete_dentry", parent=below, name="absent")
        assert e.value.code == "ENOENT"  # served (and refused) by the SM
        assert mn.take_loads().get(pid, 0) == 1
    finally:
        c._meta_op(pid, mp.peers, "unfreeze_range", {})


def test_remove_partition_drops_load_window(cluster):
    """A migrated-off replica's accrued-but-unreported load window leaves
    with the partition: reporting it afterwards keeps the node 'hot' for
    load it no longer serves, and a back-to-back rebalance sweep would
    shed a second, correctly-placed partition on that stale signal."""
    c = cluster
    fs = c.client("msvol")
    _seed_dirs(fs)
    pid = c.master().get_volume("msvol").meta_partitions[0].partition_id
    mn = next(m for m in c.metanodes.values()
              if pid in m.partitions and m.raft.is_leader(pid))
    assert mn.take_loads().get(pid, 0) > 0  # seeding accrued, now drained
    fs.create("/d0/one_more")  # re-accrue
    mn.remove_partition(pid)
    assert pid not in mn.take_loads(), \
        "removed partition still reports a load window"


def test_split_declines_zero_on_txn_conflict(cluster, monkeypatch):
    """split_meta_partition's documented contract: prepared 2PC txns in
    flight are a transient DECLINE (new_pid 0, retry after TX_TTL), not an
    error surfaced to the operator API."""
    c = cluster
    fs = c.client("msvol")
    _seed_dirs(fs)
    lead = c.master()
    pid = lead.get_volume("msvol").meta_partitions[0].partition_id
    orig = lead.meta_op_hook

    def hook(p, peers, op, args, read=False):
        if op == "freeze_range":
            raise OpError("ETXCONFLICT", "2 prepared txn(s) in flight")
        return orig(p, peers, op, args, read=read)

    monkeypatch.setattr(lead, "meta_op_hook", hook)
    assert lead.split_meta_partition("msvol", pid) == 0


def test_cursor_split_retry_converges_after_partial_failure(cluster,
                                                            monkeypatch):
    """Failure between set_range_end and the view-split commit used to be
    permanent: the retry recomputed split_at from a cursor that kept
    advancing, overshooting the committed SM cap, and the old shrink-only
    refusal rejected it every sweep (creates eventually ERANGE'd at the
    cap forever). The SM now answers with the cap it holds and the retry
    completes the view swap at THAT boundary."""
    from chubaofs_tpu_torch.master.master import SPLIT_HEADROOM

    c = cluster
    fs = c.client("msvol")
    _seed_dirs(fs)
    lead = c.master()
    vol = lead.get_volume("msvol")
    tail = vol.meta_partitions[-1]
    pid = tail.partition_id
    mn = next(m for m in c.metanodes.values()
              if pid in m.partitions and m.raft.is_leader(pid))
    first_cap = mn.partitions[pid].cursor + SPLIT_HEADROOM
    orig_apply = lead._apply
    fail = {"armed": True}

    def apply(op, **kw):
        if op == "split_partition" and fail["armed"]:
            fail["armed"] = False
            raise RuntimeError("leadership lost mid-cursor-split")
        return orig_apply(op, **kw)

    monkeypatch.setattr(lead, "_apply", apply)
    with pytest.raises(RuntimeError):
        lead._cursor_split(vol, tail, first_cap)
    assert mn.partitions[pid].end == first_cap  # SM capped, view did not
    assert len(lead.get_volume("msvol").meta_partitions) == 1
    for i in range(8):  # the cursor keeps advancing into the headroom
        fs.create(f"/d0/after_cap{i}")
    retry_at = mn.partitions[pid].cursor + SPLIT_HEADROOM
    assert retry_at > first_cap  # the overshooting recompute
    assert lead._cursor_split(lead.get_volume("msvol"), tail, retry_at) == 1
    view = sorted(lead.get_volume("msvol").meta_partitions,
                  key=lambda m: m.start)
    assert len(view) == 2
    assert view[0].end == first_cap == view[1].start, \
        "view swapped at the recomputed cap, not the SM's committed one"
    fs.create("/d0/post_retry")  # and the volume still serves creates


def test_dead_node_load_window_is_not_a_split_signal(cluster):
    """Loads only refresh on a heartbeat, so a dead node's window is
    frozen at its last report — split_hot_meta_partitions must not keep
    splitting the same partition on that ghost."""
    c = cluster
    fs = c.client("msvol")
    _seed_dirs(fs)
    lead = c.master()
    pid = lead.get_volume("msvol").meta_partitions[0].partition_id
    c.heartbeat_metanodes()
    loads = lead.meta_partition_loads()
    assert loads.get(pid, 0) > 0
    reporter = next(n.node_id for n in lead.sm.nodes.values()
                    if n.kind == "meta" and n.loads.get(pid))
    lead._apply("set_node_status", node_id=reporter, status="inactive")
    assert lead.meta_partition_loads().get(pid, 0) == 0, \
        "a dead node's frozen window still drives splits"
    lead._apply("set_node_status", node_id=reporter, status="active")
    assert lead.meta_partition_loads().get(pid, 0) > 0  # back with the beat


def test_heartbeat_refunds_window_on_any_failure(cluster, monkeypatch):
    """The in-proc heartbeat pump must keep the taken load window on ANY
    send failure — mid-election the master raises NotLeaderError, not
    MasterError, and the observed window used to be silently erased."""
    from chubaofs_tpu_torch.raft.core import NotLeaderError

    c = cluster
    fs = c.client("msvol")
    _seed_dirs(fs)
    lead = c.master()
    pid = lead.get_volume("msvol").meta_partitions[0].partition_id
    mn = next(m for m in c.metanodes.values()
              if pid in m.partitions and m.raft.is_leader(pid))
    with mn._loads_lock:
        assert mn._op_loads.get(pid, 0) > 0  # seeding accrued, undrained

    def deposed(*a, **kw):
        raise NotLeaderError(None)

    monkeypatch.setattr(lead, "heartbeat", deposed)
    c.heartbeat_metanodes()  # must neither raise nor eat the window
    monkeypatch.undo()
    assert mn.take_loads().get(pid, 0) > 0, \
        "mid-election heartbeat erased the observed load window"
