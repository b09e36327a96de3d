"""The cases of tests/test_meta_tx_quota.py, run against the port on the CPU.

Metanode transactions (2PC), uniq-op idempotence, directory quotas
(metanode/transaction.go, uniq_checker.go, quota + master_quota_manager)."""

import stat

import pytest
import torch

from chubaofs_tpu_torch.deploy import FsCluster
from chubaofs_tpu_torch.meta.partition import MetaPartitionSM
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


# -- uniq checker (SM level) ---------------------------------------------------


def mk_sm():
    return MetaPartitionSM(1, 1, 1 << 20)


def test_uniq_duplicate_replays_result():
    sm = mk_sm()
    args = {"mode": stat.S_IFREG | 0o644, "_uniq": ("c1", 7)}
    r1 = sm.apply(("create_inode", args), 1)
    r2 = sm.apply(("create_inode", args), 2)  # duplicate delivery
    assert r1 == r2  # same inode, not a second one
    assert sm.cursor == 2  # only one allocation happened (root is ino 1)


def test_uniq_errors_replayed_too():
    sm = mk_sm()
    args = {"parent": 1, "name": "nope", "_uniq": ("c1", 1)}
    r1 = sm.apply(("delete_dentry", args), 1)
    r2 = sm.apply(("delete_dentry", args), 2)
    assert r1[0] == "err" and r1 == r2


def test_uniq_window_prunes():
    sm = mk_sm()
    for i in range(sm.UNIQ_WINDOW + 50):
        sm.apply(("update_inode", {"ino": 1, "_uniq": ("c1", i)}), i)
    assert len(sm.uniq_seen["c1"]) == sm.UNIQ_WINDOW


def test_uniq_duplicate_append_extents_no_conflict():
    """regression/idempotent analog: the metanode applies AppendExtentKey,
    the reply is lost, the client RETRIES the identical request — the replay
    must return the recorded result, not append the extents a second time
    (the reference's fix made AppendExtentKeyWithCheck idempotent)."""
    sm = mk_sm()
    ino = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 1)[1].ino
    args = {"ino": ino, "size": 4096, "_uniq": ("c1", 42),
            "extents": [{"partition_id": 7, "extent_id": 3,
                         "file_offset": 0, "extent_offset": 0, "size": 4096}]}
    r1 = sm.apply(("append_extents", args), 2)
    # snapshot observable state BEFORE the retry: both results wrap the same
    # live Inode object, so comparing r1 == r2 alone would be vacuous
    extents_after_first = len(sm.inodes[ino].extents)
    r2 = sm.apply(("append_extents", args), 3)  # network-failure retry
    assert r1[0] == "ok" and r2[0] == "ok"
    inode = sm.inodes[ino]
    assert extents_after_first == 1
    assert len(inode.extents) == 1, "duplicate delivery appended twice"
    assert inode.size == 4096


# -- 2PC transactions (SM level) -----------------------------------------------


def test_tx_prepare_commit():
    sm = mk_sm()
    ino = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 1)[1].ino
    ops = [("create_dentry", {"parent": 1, "name": "t", "ino": ino,
                              "mode": stat.S_IFREG | 0o644})]
    assert sm.apply(("tx_prepare", {"tx_id": "tx1", "ops": ops,
                                    "deadline": 1e12}), 2)[0] == "ok"
    # the intent lock blocks outside writers
    r = sm.apply(("create_dentry", {"parent": 1, "name": "t", "ino": ino,
                                    "mode": 0o644}), 3)
    assert r[:2] == ("err", "ETXCONFLICT")
    assert sm.apply(("tx_commit", {"tx_id": "tx1"}), 4)[0] == "ok"
    assert (1, "t") in sm.dentries
    assert not sm.tx_locks
    # idempotent re-commit
    assert sm.apply(("tx_commit", {"tx_id": "tx1"}), 5)[0] == "ok"


def test_tx_prepare_validates():
    sm = mk_sm()
    ops = [("delete_dentry", {"parent": 1, "name": "ghost"})]
    r = sm.apply(("tx_prepare", {"tx_id": "tx2", "ops": ops,
                                 "deadline": 1e12}), 1)
    assert r[:2] == ("err", "ENOENT")
    assert not sm.txns and not sm.tx_locks


def test_tx_rollback_and_expiry():
    sm = mk_sm()
    ino = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 1)[1].ino
    ops = [("create_dentry", {"parent": 1, "name": "r", "ino": ino,
                              "mode": 0o644})]
    sm.apply(("tx_prepare", {"tx_id": "tx3", "ops": ops, "deadline": 1e12}), 2)
    sm.apply(("tx_rollback", {"tx_id": "tx3"}), 3)
    assert not sm.tx_locks and (1, "r") not in sm.dentries
    # a rolled-back txn cannot be committed later (coordinator came back)
    assert sm.apply(("tx_commit", {"tx_id": "tx3"}), 4)[:2] == ("err", "ETXCONFLICT")
    # expiry sweep: a TM-anchored txn (tm defaults to this partition) rolls
    # back locally — the coordinator never recorded a commit decision
    sm.apply(("tx_prepare", {"tx_id": "tx4", "ops": ops, "deadline": 5.0}), 5)
    assert sm.apply(("tx_sweep", {"now": 10.0}), 6) == ("ok", [])
    assert not sm.txns and sm.tx_status("tx4") == "rolledback"
    # the decision is retained through the resolve window, then pruned by
    # TTL — never by count (count-pruning could forget a
    # commit mid-window and roll a committed rename half back)
    sm.apply(("tx_sweep", {"now": 5.0 + sm.TX_DONE_RETAIN - 1}), 7)
    assert sm.tx_status("tx4") == "rolledback"
    sm.apply(("tx_sweep", {"now": 5.0 + sm.TX_DONE_RETAIN + 1}), 8)
    assert sm.tx_status("tx4") == "unknown"


def test_tx_participant_expiry_resolves_via_tm():
    """A participant partition never aborts unilaterally: the sweep surfaces
    the txn, and the decision comes from the TM (coordinator recovery)."""
    sm = mk_sm()
    ino = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 1)[1].ino
    ops = [("create_dentry", {"parent": 1, "name": "p", "ino": ino,
                              "mode": 0o644})]
    sm.apply(("tx_prepare", {"tx_id": "tx9", "ops": ops, "deadline": 5.0,
                             "tm_pid": 999}), 2)
    unresolved = sm.apply(("tx_sweep", {"now": 10.0}), 3)
    assert unresolved == ("ok", [("tx9", 999)])
    assert "tx9" in sm.txns  # still prepared, locks still held
    # the metanode resolves: TM says committed -> roll FORWARD
    assert sm.apply(("tx_commit", {"tx_id": "tx9"}), 4)[0] == "ok"
    assert (1, "p") in sm.dentries


def test_tx_dir_delete_locks_child_set():
    """Prepared delete of an empty dir freezes its child set, so commit's
    'cannot fail' invariant holds against concurrent creates inside it."""
    sm = mk_sm()
    d_ino = sm.apply(("create_inode", {"mode": stat.S_IFDIR | 0o755}), 1)[1].ino
    sm.apply(("create_dentry", {"parent": 1, "name": "dir", "ino": d_ino,
                                "mode": stat.S_IFDIR | 0o755}), 2)
    ops = [("delete_dentry", {"parent": 1, "name": "dir"})]
    assert sm.apply(("tx_prepare", {"tx_id": "txd", "ops": ops,
                                    "deadline": 1e12}), 3)[0] == "ok"
    f_ino = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 4)[1].ino
    r = sm.apply(("create_dentry", {"parent": d_ino, "name": "sneak",
                                    "ino": f_ino, "mode": 0o644}), 5)
    assert r[:2] == ("err", "ETXCONFLICT")
    assert sm.apply(("tx_commit", {"tx_id": "txd"}), 6)[0] == "ok"
    assert (1, "dir") not in sm.dentries


def test_tx_commit_cannot_fail_on_quota_fill():
    """Prepare RESERVES quota headroom, so a quota that
    fills between prepare and commit cannot make commit raise EDQUOT."""
    sm = mk_sm()
    sm.apply(("set_quota_def", {"quota_id": 5, "max_files": 1}), 1)
    ino = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 2)[1].ino
    ops = [("create_dentry", {"parent": 1, "name": "a", "ino": ino,
                              "mode": 0o644, "quota_ids": [5]})]
    assert sm.apply(("tx_prepare", {"tx_id": "txq", "ops": ops,
                                    "deadline": 1e12}), 3)[0] == "ok"
    # the reservation fills the quota: a competing non-tx create fails NOW
    ino2 = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 4)[1].ino
    r = sm.apply(("create_dentry", {"parent": 1, "name": "b", "ino": ino2,
                                    "mode": 0o644, "quota_ids": [5]}), 5)
    assert r[:2] == ("err", "EDQUOT")
    # ... and commit succeeds without double-charging
    assert sm.apply(("tx_commit", {"tx_id": "txq"}), 6)[0] == "ok"
    assert sm.quotas[5]["files"] == 1


def test_tx_rollback_releases_quota_reservation():
    sm = mk_sm()
    sm.apply(("set_quota_def", {"quota_id": 6, "max_files": 1}), 1)
    ino = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 2)[1].ino
    ops = [("create_dentry", {"parent": 1, "name": "a", "ino": ino,
                              "mode": 0o644, "quota_ids": [6]})]
    sm.apply(("tx_prepare", {"tx_id": "txr", "ops": ops, "deadline": 1e12}), 3)
    assert sm.quotas[6]["files"] == 1  # reserved
    sm.apply(("tx_rollback", {"tx_id": "txr"}), 4)
    assert sm.quotas[6]["files"] == 0  # released
    r = sm.apply(("create_dentry", {"parent": 1, "name": "b", "ino": ino,
                                    "mode": 0o644, "quota_ids": [6]}), 5)
    assert r[0] == "ok"


def test_tx_create_conflicts_with_prepared_dir_delete():
    """The other half of the commit-cannot-fail invariant: a create whose
    parent has a PREPARED dir-delete conflicts at prepare, not at commit."""
    sm = mk_sm()
    d_ino = sm.apply(("create_inode", {"mode": stat.S_IFDIR | 0o755}), 1)[1].ino
    sm.apply(("create_dentry", {"parent": 1, "name": "dir", "ino": d_ino,
                                "mode": stat.S_IFDIR | 0o755}), 2)
    del_ops = [("delete_dentry", {"parent": 1, "name": "dir"})]
    assert sm.apply(("tx_prepare", {"tx_id": "txA", "ops": del_ops,
                                    "deadline": 1e12}), 3)[0] == "ok"
    f_ino = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 4)[1].ino
    crt_ops = [("create_dentry", {"parent": d_ino, "name": "x", "ino": f_ino,
                                  "mode": 0o644})]
    r = sm.apply(("tx_prepare", {"tx_id": "txB", "ops": crt_ops,
                                 "deadline": 1e12}), 5)
    assert r[:2] == ("err", "ETXCONFLICT")


def test_tx_failed_prepare_releases_partial_quota_charges():
    """A multi-create prepare that dies mid-reservation must undo the charges
    it already made — there is no txn left to roll them back."""
    sm = mk_sm()
    sm.apply(("set_quota_def", {"quota_id": 7, "max_files": 1}), 1)
    i1 = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 2)[1].ino
    i2 = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 3)[1].ino
    ops = [("create_dentry", {"parent": 1, "name": "a", "ino": i1,
                              "mode": 0o644, "quota_ids": [7]}),
           ("create_dentry", {"parent": 1, "name": "b", "ino": i2,
                              "mode": 0o644, "quota_ids": [7]})]
    r = sm.apply(("tx_prepare", {"tx_id": "txm", "ops": ops,
                                 "deadline": 1e12}), 4)
    assert r[:2] == ("err", "EDQUOT")
    assert sm.quotas[7]["files"] == 0  # nothing leaked
    ok = sm.apply(("create_dentry", {"parent": 1, "name": "a", "ino": i1,
                                     "mode": 0o644, "quota_ids": [7]}), 5)
    assert ok[0] == "ok"


def test_plain_rmdir_blocked_by_pending_create_inside():
    """Non-transactional rmdir of a dir with a PREPARED create inside must
    conflict — otherwise that txn's commit fails after the TM decision."""
    sm = mk_sm()
    d_ino = sm.apply(("create_inode", {"mode": stat.S_IFDIR | 0o755}), 1)[1].ino
    sm.apply(("create_dentry", {"parent": 1, "name": "dir", "ino": d_ino,
                                "mode": stat.S_IFDIR | 0o755}), 2)
    f_ino = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 3)[1].ino
    ops = [("create_dentry", {"parent": d_ino, "name": "x", "ino": f_ino,
                              "mode": 0o644})]
    assert sm.apply(("tx_prepare", {"tx_id": "txE", "ops": ops,
                                    "deadline": 1e12}), 4)[0] == "ok"
    r = sm.apply(("delete_dentry", {"parent": 1, "name": "dir"}), 5)
    assert r[:2] == ("err", "ETXCONFLICT")
    assert sm.apply(("tx_commit", {"tx_id": "txE"}), 6)[0] == "ok"
    assert (d_ino, "x") in sm.dentries
    # with the txn resolved the rmdir would still fail — dir is non-empty now
    assert sm.apply(("delete_dentry", {"parent": 1, "name": "dir"}),
                    7)[:2] == ("err", "ENOTEMPTY")


def test_mtime_rides_proposal():
    """ctime/mtime come from the proposer's _now stamp, never the replica
    clock — two replicas applying the same log agree bit-for-bit."""
    sm = mk_sm()
    r = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644,
                                   "_now": 1234.5}), 1)
    assert r[1].ctime == 1234.5 and r[1].mtime == 1234.5
    sm.apply(("create_dentry", {"parent": 1, "name": "t", "ino": r[1].ino,
                                "mode": 0o644, "_now": 2000.0}), 2)
    assert sm.inodes[1].mtime == 2000.0  # parent dir mtime from the proposal


def test_tx_dir_delete_conflicts_with_prepared_create_inside():
    """Reverse order: create prepared first, then the dir-delete prepare must
    conflict (it would otherwise validate emptiness that commit invalidates)."""
    sm = mk_sm()
    d_ino = sm.apply(("create_inode", {"mode": stat.S_IFDIR | 0o755}), 1)[1].ino
    sm.apply(("create_dentry", {"parent": 1, "name": "dir", "ino": d_ino,
                                "mode": stat.S_IFDIR | 0o755}), 2)
    f_ino = sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 3)[1].ino
    crt_ops = [("create_dentry", {"parent": d_ino, "name": "x", "ino": f_ino,
                                  "mode": 0o644})]
    assert sm.apply(("tx_prepare", {"tx_id": "txC", "ops": crt_ops,
                                    "deadline": 1e12}), 4)[0] == "ok"
    del_ops = [("delete_dentry", {"parent": 1, "name": "dir"})]
    r = sm.apply(("tx_prepare", {"tx_id": "txD", "ops": del_ops,
                                 "deadline": 1e12}), 5)
    assert r[:2] == ("err", "ETXCONFLICT")
    # create commits cleanly afterwards
    assert sm.apply(("tx_commit", {"tx_id": "txC"}), 6)[0] == "ok"
    assert (d_ino, "x") in sm.dentries


# -- cross-partition rename through the cluster --------------------------------


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = FsCluster(str(tmp_path_factory.mktemp("txq")), n_nodes=3, blob_nodes=6,
                  data_nodes=0, device=CPU)
    c.create_volume("tv", cold=True)
    yield c
    c.close()


def _force_split(cluster, vol="tv"):
    """Grow the namespace until the master splits the tail partition."""
    lead = cluster.master()
    for mn in cluster.metanodes.values():
        for pid, sm in mn.partitions.items():
            lead.heartbeat(mn.node_id, cursors={pid: sm.cursor})
    from chubaofs_tpu_torch.master import master as master_mod

    old_step, old_headroom = master_mod.META_RANGE_STEP, master_mod.SPLIT_HEADROOM
    master_mod.META_RANGE_STEP, master_mod.SPLIT_HEADROOM = 64, 8
    try:
        fs = cluster.client(vol)
        fs.mkdirs("/split-filler")
        for i in range(80):
            fs.create(f"/split-filler/f{i}")
        for mn in cluster.metanodes.values():
            for pid, sm in mn.partitions.items():
                lead.heartbeat(mn.node_id, cursors={pid: sm.cursor})
        assert lead.check_meta_partitions() >= 1
    finally:
        master_mod.META_RANGE_STEP, master_mod.SPLIT_HEADROOM = old_step, old_headroom


def test_cross_partition_rename_via_2pc(cluster):
    fs = cluster.client("tv")
    fs.mkdirs("/a")
    _force_split(cluster)
    # a directory on the NEW tail partition: its dentries live there
    fs2 = cluster.client("tv")
    fs2.mkdirs("/b")
    ino_a = fs2.resolve("/a")
    ino_b = fs2.resolve("/b")
    mp_a = fs2.meta.partition_of(ino_a).partition_id
    mp_b = fs2.meta.partition_of(ino_b).partition_id
    assert mp_a != mp_b, "need a genuinely cross-partition rename"

    fs2.write_file("/a/x.bin", b"payload")
    fs2.rename("/a/x.bin", "/b/y.bin")
    assert fs2.read_file("/b/y.bin") == b"payload"
    assert "x.bin" not in fs2.readdir("/a")

    # follower replicas apply the commit on subsequent ticks; pump the clock,
    # then no intent locks may remain anywhere
    def no_locks():
        return all(not sm.tx_locks and not sm.txns
                   for mn in cluster.metanodes.values()
                   for sm in mn.partitions.values())

    assert cluster.settle(no_locks)


# -- quotas --------------------------------------------------------------------


def test_quota_max_files(cluster):
    fs = cluster.client("tv")
    fs.mkdirs("/q1")
    dir_ino = fs.resolve("/q1")
    fs.meta.set_quota(dir_ino, quota_id=11, max_files=3)
    for i in range(3):
        fs.create(f"/q1/f{i}")
    with pytest.raises(FsError) as e:
        fs.create("/q1/f3")
    assert e.value.code == "EDQUOT"
    # deleting frees the budget
    fs.unlink("/q1/f0")
    fs.create("/q1/f3")
    usage = fs.meta.quota_usage(11)
    assert usage["files"] == 3


def test_quota_max_bytes(cluster):
    fs = cluster.client("tv")
    fs.mkdirs("/q2")
    fs.meta.set_quota(fs.resolve("/q2"), quota_id=12, max_bytes=1000)
    fs.write_file("/q2/a", b"x" * 900)
    with pytest.raises(FsError) as e:
        fs.append_file("/q2/a", b"y" * 900)
    assert e.value.code == "EDQUOT"
    assert fs.meta.quota_usage(12)["bytes"] == 900
    # truncate credits the budget back
    fs.meta.truncate(fs.resolve("/q2/a"), 0)
    assert fs.meta.quota_usage(12)["bytes"] == 0
    fs.write_file("/q2/b", b"z" * 500)


def test_quota_inherited_by_subdirs(cluster):
    fs = cluster.client("tv")
    fs.mkdirs("/q3")
    fs.meta.set_quota(fs.resolve("/q3"), quota_id=13, max_files=2)
    fs.mkdir("/q3/sub")  # counts as one file
    fs.create("/q3/sub/leaf")  # inherited: counts too
    with pytest.raises(FsError) as e:
        fs.create("/q3/sub/leaf2")
    assert e.value.code == "EDQUOT"


def test_quota_flag_push(cluster):
    fs = cluster.client("tv")
    fs.mkdirs("/q4")
    fs.meta.set_quota(fs.resolve("/q4"), quota_id=14, max_files=1)
    fs.create("/q4/only")
    fs.meta.push_quota_flags()
    with pytest.raises(FsError):
        fs.create("/q4/more")
    fs.unlink("/q4/only")
    fs.meta.push_quota_flags()  # usage back under: flag clears
    fs.create("/q4/again")
