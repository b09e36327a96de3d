"""The port's file/metadata cluster held against the JAX package's, byte for
byte.

A JAX FsCluster and a port FsCluster(device="cpu") get the same seeded inputs
(numpy default_rng). Raft's wire codec, snapshot sections and the state
machines' snapshots must be the same bytes and each package must decode the
other's. On a cold volume the same tree must give the same inode numbers,
directory listings, sizes and link counts (times left out), the same signed
Locations in every inode's obj_extents, the same stored stripes per blob, and
the same bytes on whole, ranged and degraded reads; the repair must rebuild
the same shards. On a hot volume writes, appends, an overwrite and a truncate
must read back the same. The on-disk state one package wrote opens in the
other. GF(2^8) math and the codecs are exact: tolerance 0 throughout.
"""

import os
import stat
import threading

import numpy as np
import pytest
import torch

from chubaofs_tpu.blobstore.blobnode import NoSuchShard as JNoSuchShard
from chubaofs_tpu.deploy import FsCluster as JFsCluster
from chubaofs_tpu.master.master import MasterSM as JMasterSM
from chubaofs_tpu.meta.partition import MetaPartitionSM as JMetaPartitionSM
from chubaofs_tpu.raft import codec as j_codec
from chubaofs_tpu.raft import snapcodec as j_snapcodec
from chubaofs_tpu.raft import transport as j_transport
from chubaofs_tpu.raft.core import Entry as JEntry
from chubaofs_tpu.raft.core import Msg as JMsg
from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.blobnode import NoSuchShard
from chubaofs_tpu_torch.blobstore.clustermgr import DISK_BROKEN
from chubaofs_tpu_torch.deploy import FsCluster
from chubaofs_tpu_torch.master.master import MasterSM
from chubaofs_tpu_torch.meta.partition import MetaPartitionSM
from chubaofs_tpu_torch.raft import codec, snapcodec, transport
from chubaofs_tpu_torch.raft.core import Entry, Msg
from chubaofs_tpu_torch.raft.server import run_until

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


# -- raft: wire codec, snapshot sections, state-machine snapshots ---------------


def seeded_value(rng, depth: int = 0):
    """A random codec value: every type the grammar carries, nested."""
    kind = int(rng.integers(0, 10 if depth < 3 else 7))
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:  # zigzag varints, past 64 bits too
        return int(rng.integers(-(1 << 62), 1 << 62)) * int(rng.integers(1, 1 << 20))
    if kind == 3:
        return float(rng.normal() * 10.0 ** int(rng.integers(-5, 6)))
    if kind == 4:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2FFF, int(rng.integers(0, 12))))
    if kind in (5, 6):
        return rng.bytes(int(rng.integers(0, 64)))
    n = int(rng.integers(0, 5))
    if kind == 7:
        return [seeded_value(rng, depth + 1) for _ in range(n)]
    if kind == 8:
        return tuple(seeded_value(rng, depth + 1) for _ in range(n))
    return {f"k{i}": seeded_value(rng, depth + 1) for i in range(n)}


def seeded_msgs(rng, entry_cls, msg_cls, n: int = 6) -> list:
    types = ["vote_req", "vote_resp", "append", "append_resp", "snap"]
    out = []
    for i in range(n):
        m = msg_cls(type=types[i % len(types)], group=int(rng.integers(1, 99)),
                    src=int(rng.integers(1, 9)), dst=int(rng.integers(1, 9)),
                    term=int(rng.integers(0, 1 << 40)))
        m.last_log_index = int(rng.integers(0, 1 << 30))
        m.granted = bool(rng.integers(0, 2))
        m.prev_index, m.prev_term = int(rng.integers(0, 1000)), int(rng.integers(0, 50))
        m.commit = int(rng.integers(0, 1000))
        m.entries = [entry_cls(int(rng.integers(0, 50)),
                               ("op", {"v": seeded_value(np.random.default_rng(int(s)))}))
                     for s in rng.integers(0, 1 << 30, int(rng.integers(0, 4)))]
        out.append(m)
    return out


def msg_fields(m) -> tuple:
    return (tuple(getattr(m, f) for f in transport._MSG_FIELDS),
            [(e.term, e.data) for e in m.entries])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_raft_codec_values_and_frames_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        v = seeded_value(rng)
        raw = codec.dumps(v)
        assert raw == j_codec.dumps(v)
        assert codec.loads(raw) == v == j_codec.loads(raw)
    # WAL entries and transport frames: [u32 len][HMAC][codec payload]
    state = rng.bit_generator.state
    msgs = seeded_msgs(rng, Entry, Msg)
    rng.bit_generator.state = state
    jmsgs = seeded_msgs(rng, JEntry, JMsg)
    secret = transport.DEFAULT_SECRET
    assert secret == j_transport.DEFAULT_SECRET
    frame = transport._pack(secret, msgs)
    assert frame == j_transport._pack(secret, jmsgs)
    payload = frame[transport._LEN.size + 32:]
    mine = transport._unwire_msgs(codec.loads(payload))
    theirs = j_transport._unwire_msgs(j_codec.loads(payload))
    assert [msg_fields(m) for m in mine] == [msg_fields(m) for m in theirs] \
        == [msg_fields(m) for m in msgs]
    for m in msgs:
        for e in m.entries:
            assert codec.dumps(e.data).hex() == j_codec.dumps(e.data).hex()


def test_snapcodec_sections_match_jax():
    rng = np.random.default_rng(5)
    sections = [(f"sec{i}", seeded_value(rng)) for i in range(8)]
    items = [seeded_value(rng) for _ in range(40)]
    w, jw = snapcodec.SnapshotWriter(), j_snapcodec.SnapshotWriter()
    for name, v in sections:
        w.add(name, v)
        jw.add(name, v)
    w.add_batched("items", items, batch=7)
    jw.add_batched("items", items, batch=7)
    blob = w.getvalue()
    assert blob == jw.getvalue()
    want = sections + [("items", items[i:i + 7]) for i in range(0, 40, 7)]
    assert list(snapcodec.read_sections(blob)) == want
    assert list(j_snapcodec.read_sections(blob)) == want
    bad = bytearray(blob)
    bad[-1] ^= 0xFF
    for mod in (snapcodec, j_snapcodec):
        with pytest.raises(mod.SnapshotError):
            list(mod.read_sections(bytes(bad)))


def meta_ops(rng, n_dirs: int = 4, n_files: int = 40) -> list:
    """Seeded MetaPartitionSM ops with proposer-stamped times."""
    ops, now = [], 1_700_000_000.0
    cursor, dirs = 1, [1]
    for d in range(n_dirs):
        cursor += 1
        ops.append(("create_inode", {"mode": stat.S_IFDIR | 0o755, "_now": now,
                                     "_uniq": ("c1", len(ops))}))
        ops.append(("create_dentry", {"parent": 1, "name": f"d{d}", "ino": cursor,
                                      "mode": stat.S_IFDIR | 0o755, "_now": now}))
        dirs.append(cursor)
    for f in range(n_files):
        cursor += 1
        now += float(rng.integers(1, 1000)) / 8
        parent = dirs[int(rng.integers(len(dirs)))]
        ops.append(("create_inode", {"mode": stat.S_IFREG | 0o644, "_now": now}))
        ops.append(("create_dentry", {"parent": parent, "name": f"f{f}", "ino": cursor,
                                      "mode": stat.S_IFREG | 0o644, "_now": now}))
        size = int(rng.integers(1, 1 << 20))
        ops.append(("append_extents", {"ino": cursor, "size": size, "_now": now, "extents": [
            {"file_offset": 0, "size": size, "partition_id": int(rng.integers(1, 9)),
             "extent_id": int(rng.integers(65, 1 << 20)), "extent_offset": 0}]}))
        if f % 5 == 0:
            ops.append(("set_xattr", {"ino": cursor, "key": f"user.k{f}",
                                      "value": rng.bytes(8), "_now": now}))
    return ops


def test_meta_partition_and_master_snapshots_match_jax():
    ops = meta_ops(np.random.default_rng(9))
    sm, jsm = MetaPartitionSM(7, 1, 1 << 30), JMetaPartitionSM(7, 1, 1 << 30)
    for s in (sm, jsm):  # the root inode is stamped by the local clock
        s.inodes[1].ctime = s.inodes[1].mtime = 1_600_000_000.0
    for i, op in enumerate(ops, 1):
        assert repr(sm.apply(op, i)) == repr(jsm.apply(op, i))
    blob = sm.snapshot()
    assert blob == jsm.snapshot()
    back, jback = MetaPartitionSM(7, 1, 1 << 30), JMetaPartitionSM(7, 1, 1 << 30)
    back.restore(jsm.snapshot())
    jback.restore(blob)
    assert back.snapshot() == blob == jback.snapshot()

    msm, jmsm = MasterSM(), JMasterSM()
    master_ops = [
        ("register_node", {"node_id": 4, "kind": "meta", "addr": "127.0.0.1:9",
                           "raft_addr": "r:1", "now": 1.5}),
        ("create_user", {"user_id": "u", "access_key": "AK", "secret_key": "SK"}),
        ("create_volume", {"name": "v", "owner": "u", "capacity": 100, "cold": False,
                           "vol_id": 101, "partition_id": 102, "peers": [4]}),
        ("create_data_partition", {"vol_name": "v", "partition_id": 103,
                                   "peers": [4], "hosts": ["h:1"]}),
    ]
    for i, op in enumerate(master_ops, 1):
        msm.apply(op, i)
        jmsm.apply(op, i)
    blob = msm.snapshot()
    assert blob == jmsm.snapshot()
    back, jback = MasterSM(), JMasterSM()
    back.restore(jmsm.snapshot())
    jback.restore(blob)
    assert back.snapshot() == blob == jback.snapshot()


# -- the cold volume --------------------------------------------------------------


def seeded_tree(rng, dirs: int = 3, files: int = 6) -> dict:
    """path -> list of appends (bytes): small files of 1-200 KB in a few
    directories, and one file of three 1.5 MB appends (EC(12,4) blobs)."""
    tree = {}
    for d in range(dirs):
        for f in range(files):
            tree[f"/d{d}/f{f}"] = [rng.bytes(int(rng.integers(1_000, 200_000)))]
    tree["/big/multi.bin"] = [rng.bytes(1_500_000) for _ in range(3)]
    tree["/empty"] = []
    return tree


def write_tree(fs, tree: dict) -> None:
    for path in sorted(tree):
        parent = path.rsplit("/", 1)[0]
        if parent:
            fs.mkdirs(parent)
        fs.create(path)
        for chunk in tree[path]:
            fs.append_file(path, chunk)


def namespace(fs, path: str = "/") -> dict:
    """path -> (ino, mode, size, nlink, is_dir) and, for a directory, its
    listing: everything but times."""
    st = fs.stat(path)
    out = {path: (st["ino"], st["mode"], st["size"], st["nlink"], st["is_dir"])}
    if st["is_dir"]:
        names = fs.readdir(path)
        out[path + "#"] = names
        for name in names:
            out.update(namespace(fs, path.rstrip("/") + "/" + name))
    return out


def obj_extents(fs, path: str) -> list:
    return fs.meta.get_inode(fs.resolve(path)).obj_extents


def blobs_of(fs, tree) -> list:
    """(path, Location, blob) of every blob under the tree's files."""
    from chubaofs_tpu_torch.blobstore.access import Location

    out = []
    for path in sorted(tree):
        for ext in obj_extents(fs, path):
            loc = Location.from_json(ext["loc"])
            out += [(path, loc, b) for b in loc.blobs]
    return out


def stored_stripe(blobstore, blob) -> list:
    """Every shard of one blob as the blobnodes hold it (None where lost)."""
    vol = blobstore.cm.get_volume(blob.vid)
    out = []
    for u in vol.units:
        try:
            out.append(bytes(blobstore.nodes[u.node_id].get_shard(u.vuid, blob.bid)))
        except (NoSuchShard, JNoSuchShard):
            out.append(None)
    return out


def ranges(rng, tree, n: int = 24) -> list:
    paths = [p for p in sorted(tree) if tree[p]]
    out = []
    for _ in range(n):
        p = paths[int(rng.integers(len(paths)))]
        size = sum(len(c) for c in tree[p])
        off = int(rng.integers(size))
        out.append((p, off, int(rng.integers(1, size - off + 1))))
    return out


def check_reads(fs, jfs, tree, rng) -> None:
    for path, chunks in tree.items():
        want = b"".join(chunks)
        assert fs.read_file(path) == want == jfs.read_file(path), path
    for path, off, ln in ranges(rng, tree):
        want = b"".join(tree[path])[off:off + ln]
        assert fs.read_file(path, off, ln) == want == jfs.read_file(path, off, ln)


def make_pair(tmp_path):
    j = JFsCluster(str(tmp_path / "jax"))
    t = FsCluster(str(tmp_path / "port"), device=CPU)
    for c in (j, t):
        c.create_volume("cold")
        c.create_volume("hot", cold=False)
    return j, t


@pytest.fixture(scope="module")
def cold_pair(tmp_path_factory):
    """Both clusters with the same tree written to their cold volumes."""
    j, t = make_pair(tmp_path_factory.mktemp("fs_pair"))
    tree = seeded_tree(np.random.default_rng(21))
    fs, jfs = t.client("cold"), j.client("cold")
    write_tree(fs, tree)
    write_tree(jfs, tree)
    yield j, t, fs, jfs, tree
    t.close()
    j.close()


def test_cold_namespace_matches_jax(cold_pair):
    _, _, fs, jfs, tree = cold_pair
    ns = namespace(fs)
    assert ns == namespace(jfs)
    for path, chunks in tree.items():
        assert ns[path][2] == sum(len(c) for c in chunks)
        assert ns[path][3] == 1 and not ns[path][4]
    # a hard link and a rename move nlink and listings the same way
    for f in (fs, jfs):
        f.link("/d0/f0", "/d1/f0_link")
        f.rename("/d2/f1", "/d2/f1_moved")
    ns = namespace(fs)
    assert ns == namespace(jfs)
    assert ns["/d0/f0"][3] == 2 and ns["/d1/f0_link"][0] == ns["/d0/f0"][0]
    for f in (fs, jfs):
        f.unlink("/d1/f0_link")
        f.rename("/d2/f1_moved", "/d2/f1")


def test_cold_locations_and_stripes_match_jax(cold_pair):
    j, t, fs, jfs, tree = cold_pair
    for path in sorted(tree):
        assert obj_extents(fs, path) == obj_extents(jfs, path), path
    blobs = blobs_of(fs, tree)
    assert len(blobs) == len(tree) - 1 + 2  # the big file's 3 appends, no empty
    for _, _, blob in blobs:
        st = stored_stripe(t.blobstore, blob)
        assert None not in st
        assert st == stored_stripe(j.blobstore, blob)


def test_cold_reads_match_jax(cold_pair):
    _, _, fs, jfs, tree = cold_pair
    check_reads(fs, jfs, tree, np.random.default_rng(22))


def break_disk(cluster, disk_id: int) -> int:
    """Media loss of a whole blobnode disk: every shard on it is gone and the
    clustermgr marks it broken. Returns the shards lost."""
    bs, lost = cluster.blobstore, 0
    for vol in bs.cm.volumes.values():
        for u in vol.units:
            if u.disk_id != disk_id:
                continue
            node = bs.nodes[u.node_id]
            try:
                metas = node.list_shards(u.vuid)
            except (NoSuchShard, JNoSuchShard):
                continue
            for meta in metas:
                node.lose_shard(u.vuid, meta.bid)
                lost += 1
    bs.cm.set_disk_status(disk_id, DISK_BROKEN)
    return lost


def test_degraded_reads_and_repair_match_jax(tmp_path):
    j, t = make_pair(tmp_path)
    try:
        tree = seeded_tree(np.random.default_rng(23), dirs=2, files=5)
        fs, jfs = t.client("cold"), j.client("cold")
        write_tree(fs, tree)
        write_tree(jfs, tree)
        blobs = blobs_of(fs, tree)
        golden = {(b.vid, b.bid): stored_stripe(t.blobstore, b) for _, _, b in blobs}
        big = next(b for p, _, b in blobs if p == "/big/multi.bin")
        units = t.blobstore.cm.get_volume(big.vid).units
        victims = [units[0].disk_id, units[13].disk_id]
        lost = [sum(break_disk(c, d) for d in victims) for c in (t, j)]
        assert lost[0] == lost[1] > 0
        check_reads(fs, jfs, tree, np.random.default_rng(24))
        for c in (t, j):
            for _ in range(40):
                c.tick_background()
                if all(None not in stored_stripe(c.blobstore, b) for _, _, b in blobs):
                    break
        for _, _, b in blobs:
            tv, jv = t.blobstore.cm.get_volume(b.vid), j.blobstore.cm.get_volume(b.vid)
            assert [(u.vuid, u.disk_id, u.epoch) for u in tv.units] == \
                [(u.vuid, u.disk_id, u.epoch) for u in jv.units]
            assert not {u.disk_id for u in tv.units} & set(victims)
            assert stored_stripe(t.blobstore, b) == golden[(b.vid, b.bid)] \
                == stored_stripe(j.blobstore, b)
        check_reads(fs, jfs, tree, np.random.default_rng(25))
    finally:
        t.close()
        j.close()


def test_unlink_purges_the_same_blobs_as_jax(tmp_path):
    j, t = make_pair(tmp_path)
    try:
        tree = seeded_tree(np.random.default_rng(26), dirs=1, files=4)
        fs, jfs = t.client("cold"), j.client("cold")
        write_tree(fs, tree)
        write_tree(jfs, tree)
        gone = ["/d0/f1", "/big/multi.bin"]
        purged = [b for p, _, b in blobs_of(fs, tree) if p in gone]
        kept = [b for p, _, b in blobs_of(fs, tree) if p not in gone]
        for c, f in ((t, fs), (j, jfs)):
            for p in gone:
                f.unlink(p)
            for _ in range(10):
                c.tick_background()
                if not any(sm.freelist for mn in c.metanodes.values()
                           for sm in mn.partitions.values()):
                    break
            assert not any(sm.freelist for mn in c.metanodes.values()
                           for sm in mn.partitions.values())
        for b in purged:
            assert set(stored_stripe(t.blobstore, b)) == {None} \
                == set(stored_stripe(j.blobstore, b))
        for b in kept:
            assert stored_stripe(t.blobstore, b) == stored_stripe(j.blobstore, b)
        assert namespace(fs) == namespace(jfs)
    finally:
        t.close()
        j.close()


# -- the hot volume ---------------------------------------------------------------


def overwrite(cluster, fs, ino: int, offset: int, data: bytes) -> None:
    """An in-place overwrite rides the raft random-write path; the datanode
    handler blocks on commit, so raft clocks are pumped meanwhile."""
    done = {}

    def run():
        try:
            fs.write_at(ino, offset, data)
            done["ok"] = True
        except Exception as e:  # reported by the assert below
            done["err"] = e

    th = threading.Thread(target=run)
    th.start()
    run_until(cluster.net, lambda: not th.is_alive(), max_ticks=5000)
    th.join(timeout=20)
    assert done.get("ok"), done.get("err")


def test_hot_volume_bytes_match_jax(tmp_path):
    j, t = make_pair(tmp_path)
    try:
        rng = np.random.default_rng(27)
        files = {f"/h{i}": rng.bytes(int(rng.integers(1_000, 300_000))) for i in range(6)}
        tail, patch = rng.bytes(100_000), rng.bytes(10_000)
        out = {}
        for c in (t, j):
            fs = c.client("hot")
            for p, data in files.items():
                fs.write_file(p, data)
            fs.append_file("/h0", tail)
            overwrite(c, fs, fs.resolve("/h1"), 500, patch)
            fs.meta.truncate(fs.resolve("/h2"), 700)
            fs.write_file("/h3", b"second version")
            out[c is t] = ({p: fs.read_file(p) for p in files},
                           fs.read_file("/h0", 1_000, 50_000), namespace(fs))
        assert out[True] == out[False]
        got = out[True][0]
        assert got["/h0"] == files["/h0"] + tail
        assert got["/h1"] == files["/h1"][:500] + patch + files["/h1"][10_500:]
        assert got["/h2"] == files["/h2"][:700]
        assert got["/h3"] == b"second version"
    finally:
        t.close()
        j.close()


# -- on-disk state ----------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_on_disk_state_opens_across_packages(tmp_path, writer):
    """Raft WALs and snapshots (the master, meta partition and keystore
    groups), the datanodes' extent files and the blobstore's files that one
    package wrote and closed open in the other, and back."""
    root = str(tmp_path / "cluster")
    make = {"jax": lambda: JFsCluster(root), "port": lambda: FsCluster(root, device=CPU)}
    reader = "port" if writer == "jax" else "jax"
    rng = np.random.default_rng(28)
    tree = seeded_tree(rng, dirs=2, files=3)
    hot = {f"/h{i}": rng.bytes(int(rng.integers(1_000, 200_000))) for i in range(4)}

    w = make[writer]()
    w.create_volume("cold")
    w.create_volume("hot", cold=False)
    fs = w.client("cold")
    write_tree(fs, tree)
    for i in range(600):  # past snapshot_every: the meta group snapshots
        fs.create(f"/many/e{i}") if i else fs.mkdirs("/many")
    hfs = w.client("hot")
    for p, data in hot.items():
        hfs.write_file(p, data)
    ns, hns = namespace(fs), namespace(hfs)
    w.close()
    assert [f for _, _, fs_ in os.walk(root) for f in fs_ if f.endswith(".snap")]

    r = make[reader]()
    try:
        fs, hfs = r.client("cold"), r.client("hot")
        assert namespace(fs) == ns and namespace(hfs) == hns
        for path, chunks in tree.items():
            assert fs.read_file(path) == b"".join(chunks)
        for p, data in hot.items():
            assert hfs.read_file(p) == data
        more, hmore = rng.bytes(300_000), rng.bytes(150_000)
        fs.write_file("/added", more)
        hfs.write_file("/added", hmore)
    finally:
        r.close()

    w = make[writer]()  # and back: the writer reads what the reader added
    try:
        assert w.client("cold").read_file("/added") == more
        assert w.client("hot").read_file("/added") == hmore
        assert w.client("cold").read_file("/d1/f2") == b"".join(tree["/d1/f2"])
    finally:
        w.close()


# -- the slice's modules ----------------------------------------------------------

SLICE = ["utils.conn_pool", "utils.cryptoutil", "raft", "raft.codec", "raft.snapcodec",
         "raft.core", "raft.server", "raft.transport", "storage", "storage.extent_store",
         "meta", "meta.partition", "meta.wire", "meta.metanode", "data", "data.repl",
         "data.datanode", "authnode", "authnode.server", "authnode.api", "master",
         "master.master", "sdk", "sdk.meta_wrapper", "sdk.stream", "sdk.fs", "deploy"]


@pytest.mark.parametrize("mod", SLICE)
def test_slice_module_carries_the_reference_names(mod):
    """Each module of the slice sits at the reference's path and defines
    every public name the reference's module does (submodules a package
    gains as other tests import them left out)."""
    import importlib
    import types

    ref = importlib.import_module(f"chubaofs_tpu.{mod}")
    port = importlib.import_module(f"chubaofs_tpu_torch.{mod}")
    want = {n for n, v in vars(ref).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, missing
