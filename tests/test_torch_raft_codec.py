"""The cases of tests/test_codec.py, run against the port on the CPU.

raft.codec + raft.snapcodec: the safe replacements for pickle on the raft
path (wire frames, WAL entries, SM snapshots). Includes the adversarial cases
that matter: a forged frame must never execute code and a
corrupt snapshot section must never half-apply silently."""

import hashlib
import hmac
import pickle
import socket
import struct
import time

import pytest
import torch

from chubaofs_tpu_torch.raft import codec, snapcodec
from chubaofs_tpu_torch.raft.core import Entry, Msg
from chubaofs_tpu_torch.raft.transport import (
    DEFAULT_SECRET, TcpNet, _unwire_msgs, _wire_msgs)

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


# -- value codec ---------------------------------------------------------------


@pytest.mark.parametrize("v", [
    None, True, False, 0, 1, -1, 2**70, -(2**70), 0.5, -1.5e300, "", "héllo",
    b"", b"\x00\xff" * 10, [], [1, "a", None], (1, 2, (3,)), {},
    {"k": [1, 2]}, {1: "int key", (2, "t"): "tuple key"},
    ("op", {"args": [b"bytes", {"nested": (True, None)}]}),
])
def test_codec_roundtrip(v):
    assert codec.loads(codec.dumps(v)) == v
    # types are preserved exactly (tuple vs list matters to the raft server)
    assert type(codec.loads(codec.dumps(v))) is type(v)


def test_codec_rejects_hostile_input():
    for bad in [b"", b"z", b"i", b"s\xff\xff\xff\xff\x0fxx", b"l\x05i\x02",
                b"NN", pickle.dumps({"rce": 1}),
                b"i" + b"\xff" * 100 + b"\x01"]:
        with pytest.raises(codec.CodecError):
            codec.loads(bad)


def test_codec_depth_bound():
    v = [1]
    for _ in range(100):
        v = [v]
    with pytest.raises(codec.CodecError):
        codec.dumps(v)


def test_msg_wire_roundtrip():
    m = Msg(type="append", group=7, src=1, dst=2, term=3, prev_index=4,
            prev_term=2, commit=9, entries=[
                Entry(3, ("op", {"k": b"v", "n": [1, 2]})),
                Entry(3, None),
                Entry(3, ("__config_change__", "add", 5)),
            ])
    out = _unwire_msgs(codec.loads(codec.dumps(_wire_msgs([m]))))
    assert len(out) == 1 and out[0] == m


# -- transport hostility -------------------------------------------------------


def _mk_pair(tmp_path):
    a = TcpNet(1, {1: "127.0.0.1:0", 2: "127.0.0.1:0"})
    b = TcpNet(2, {1: a.listen_addr, 2: "127.0.0.1:0"})
    a.set_peer(2, b.listen_addr)
    return a, b


class _Sink:
    def __init__(self):
        self.batches = []

    def register(self, *a):
        pass

    def deliver(self, msgs):
        self.batches.append(msgs)


def test_transport_drops_pickle_frame(tmp_path):
    """A validly-MAC'd frame carrying a pickle (the RCE shape) is
    dropped at decode — nothing is unpickled, the sink sees nothing."""
    a, b = _mk_pair(tmp_path)
    try:
        sink = _Sink()
        b.node = sink
        evil = pickle.dumps([("os.system", "true")])
        mac = hmac.new(DEFAULT_SECRET, evil, hashlib.sha256).digest()
        frame = struct.pack("<I", len(evil)) + mac + evil
        host, port = b.listen_addr.rsplit(":", 1)
        with socket.create_connection((host, int(port))) as s:
            s.sendall(frame)
            time.sleep(0.2)
        # a real frame still goes through on a fresh connection
        a.send([Msg(type="append", group=1, src=1, dst=2, term=1)])
        deadline = time.time() + 5
        while not sink.batches and time.time() < deadline:
            time.sleep(0.02)
        assert sink.batches and sink.batches[0][0].type == "append"
    finally:
        a.close()
        b.close()


def test_transport_refuses_default_secret_off_loopback():
    with pytest.raises(ValueError, match="raftSecret"):
        TcpNet(1, {1: "0.0.0.0:0"})
    # explicit secret: allowed
    net = TcpNet(1, {1: "0.0.0.0:0"}, secret=b"cluster-secret")
    net.close()


# -- snapshot sections ---------------------------------------------------------


def test_snapshot_sections_roundtrip():
    w = snapcodec.SnapshotWriter()
    w.add("meta", {"cursor": 7})
    w.add_batched("items", range(2500), batch=1000)
    payload = w.getvalue()
    names = [n for n, _ in snapcodec.read_sections(payload)]
    assert names == ["meta", "items", "items", "items"]  # 1000+1000+500
    got = []
    snapcodec.restore_sections(payload, {
        "meta": lambda m: got.append(m["cursor"]),
        "items": lambda b: got.extend(b),
    })
    assert got[0] == 7 and got[1:] == list(range(2500))


def test_snapshot_crc_detects_corruption():
    w = snapcodec.SnapshotWriter()
    w.add("meta", {"x": 1})
    payload = bytearray(w.getvalue())
    payload[-1] ^= 0xFF
    with pytest.raises(snapcodec.SnapshotError, match="CRC"):
        list(snapcodec.read_sections(bytes(payload)))


def test_snapshot_unknown_section_errors():
    w = snapcodec.SnapshotWriter()
    w.add("mystery", 1)
    with pytest.raises(snapcodec.SnapshotError, match="unknown"):
        snapcodec.restore_sections(w.getvalue(), {})


# -- SM snapshot equivalence ---------------------------------------------------


def test_meta_partition_snapshot_roundtrip():
    import stat

    from chubaofs_tpu_torch.meta.partition import MetaPartitionSM

    sm = MetaPartitionSM(1, 1, 1 << 20)
    sm.apply(("create_inode", {"mode": stat.S_IFDIR | 0o755,
                               "_uniq": ("c1", 1)}), 1)
    ino = sm.cursor
    sm.apply(("create_dentry", {"parent": 1, "name": "d", "ino": ino,
                                "mode": stat.S_IFDIR | 0o755}), 2)
    sm.apply(("create_inode", {"mode": stat.S_IFREG | 0o644}), 3)
    f = sm.cursor
    sm.apply(("create_dentry", {"parent": ino, "name": "f", "ino": f,
                                "mode": stat.S_IFREG | 0o644}), 4)
    sm.apply(("append_extents", {"ino": f, "size": 100, "extents": [
        {"file_offset": 0, "size": 100, "partition_id": 9, "extent_id": 3,
         "extent_offset": 0}]}), 5)
    sm.apply(("set_xattr", {"ino": f, "key": "user.k", "value": b"\x00v"}), 6)

    blob = sm.snapshot()
    assert blob.startswith(snapcodec.MAGIC)
    sm2 = MetaPartitionSM(1, 1, 1 << 20)
    sm2.restore(blob)
    assert sm2.cursor == sm.cursor
    assert sm2.inodes.keys() == sm.inodes.keys()
    assert sm2.inodes[f].extents == sm.inodes[f].extents
    assert sm2.inodes[f].xattrs == {"user.k": b"\x00v"}
    assert sm2.dentries.keys() == sm.dentries.keys()
    assert sm2.children[ino]["f"].ino == f
    # uniq replay survives the snapshot: same result object shape comes back
    replay = sm2.apply(("create_inode", {"mode": stat.S_IFDIR | 0o755,
                                         "_uniq": ("c1", 1)}), 99)
    assert replay[0] == "ok" and replay[1].ino == ino


def test_master_snapshot_roundtrip():
    from chubaofs_tpu_torch.master.master import MasterSM

    sm = MasterSM()
    sm.apply(("register_node", {"node_id": 4, "kind": "meta",
                                "addr": "127.0.0.1:9", "raft_addr": "r:1"}), 1)
    sm.apply(("create_user", {"user_id": "u", "access_key": "AK",
                              "secret_key": "SK"}), 2)
    sm.apply(("create_volume", {"name": "v", "owner": "u", "capacity": 100,
                                "cold": False, "vol_id": 101,
                                "partition_id": 102, "peers": [4]}), 3)
    sm.apply(("create_data_partition", {"vol_name": "v", "partition_id": 103,
                                        "peers": [4], "hosts": ["h:1"]}), 4)
    blob = sm.snapshot()
    sm2 = MasterSM()
    sm2.restore(blob)
    assert sm2.next_id == sm.next_id
    assert sm2.nodes[4].addr == "127.0.0.1:9"
    assert sm2.volumes["v"].meta_partitions[0].partition_id == 102
    assert sm2.volumes["v"].data_partitions[0].hosts == ["h:1"]
    assert sm2.ak_index == {"AK": "u"}
    assert sm2.users["u"].secret_key == "SK"


def test_lagging_follower_catches_up_large_namespace():
    """100k-inode namespace: a follower that joins after compaction gets the
    sectioned snapshot and replays identically — the partition_fsm.go:484
    ApplySnapshot analog at scale."""
    import stat

    from chubaofs_tpu_torch.meta.partition import MetaPartitionSM
    from chubaofs_tpu_torch.raft.server import InProcNet, MultiRaft, run_until

    net = InProcNet()
    n1 = MultiRaft(1, net)
    sm1 = MetaPartitionSM(7, 1, 1 << 40)
    n1.create_group(7, [1], sm1)
    run_until(net, lambda: n1.is_leader(7))

    for i in range(100_000):
        n1.propose(7, ("create_inode", {"mode": stat.S_IFREG | 0o644}))
    run_until(net, lambda: len(sm1.inodes) == 100_001, max_ticks=2000)
    assert len(sm1.inodes) == 100_001
    # compact so the new follower must catch up by snapshot, not log replay
    n1.groups[7].take_snapshot()

    n2 = MultiRaft(2, net)
    sm2 = MetaPartitionSM(7, 1, 1 << 40)
    n2.create_group(7, [1, 2], sm2)
    fut = n1.propose_config(7, "add", 2)
    run_until(net, lambda: fut.done(), max_ticks=2000)
    run_until(net, lambda: len(sm2.inodes) == 100_001, max_ticks=2000)
    assert sm2.cursor == sm1.cursor
    assert len(sm2.inodes) == 100_001
