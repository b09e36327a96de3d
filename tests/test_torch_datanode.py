"""The cases of tests/test_datanode.py, run against the port on the CPU.

Data plane: wire packets, extent store, chain replication, raft random
writes, repair — the datanode/, storage/, repl/ test twins (SURVEY §4)."""

import os
import threading
import zlib

import pytest
import torch

from chubaofs_tpu_torch.data.datanode import DataNode
from chubaofs_tpu_torch.proto.packet import (
    OP_CREATE_EXTENT, OP_CREATE_PARTITION, OP_GET_WATERMARKS, OP_MARK_DELETE,
    OP_RANDOM_WRITE, OP_REPAIR_READ, OP_STREAM_READ, OP_WRITE, Packet,
    RES_NOT_EXIST, RES_OK,
    recv_packet, send_packet,
)
from chubaofs_tpu_torch.raft.server import InProcNet, MultiRaft, run_until
from chubaofs_tpu_torch.storage.extent_store import (
    BrokenExtent, ExtentStore, MIN_NORMAL_EXTENT_ID, PAGE_SIZE, StorageError,
)
from chubaofs_tpu_torch.utils.conn_pool import ConnPool

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


# -- wire protocol ----------------------------------------------------------------


def test_packet_roundtrip():
    import io
    import socket as socket_mod

    pkt = Packet(OP_WRITE, partition_id=7, extent_id=65, extent_offset=4096,
                 kernel_offset=1 << 30, data=b"hello world",
                 arg={"followers": ["a:1", "b:2"]})
    blob = pkt.encode()
    # decode via a socketpair to exercise the real recv path
    a, b = socket_mod.socketpair()
    a.sendall(blob)
    got = recv_packet(b)
    a.close()
    b.close()
    assert got.opcode == OP_WRITE
    assert got.partition_id == 7
    assert got.extent_id == 65
    assert got.extent_offset == 4096
    assert got.kernel_offset == 1 << 30
    assert got.data == b"hello world"
    assert got.arg == {"followers": ["a:1", "b:2"]}
    assert got.verify_crc()


# -- extent store -----------------------------------------------------------------


class TestExtentStore:
    def test_normal_append_read(self, tmp_path):
        st = ExtentStore(str(tmp_path))
        eid = MIN_NORMAL_EXTENT_ID
        st.create(eid)
        st.write(eid, 0, b"aaaa")
        st.write(eid, 4, b"bbbb")
        assert st.read(eid, 0, 8) == b"aaaabbbb"
        assert st.size(eid) == 8

    def test_append_discipline(self, tmp_path):
        st = ExtentStore(str(tmp_path))
        eid = MIN_NORMAL_EXTENT_ID
        st.create(eid)
        st.write(eid, 0, b"x" * 10)
        with pytest.raises(StorageError):
            st.write(eid, 5, b"y")  # not at watermark
        st.write(eid, 3, b"y" * 2, overwrite=True)
        assert st.read(eid, 0, 10) == b"xxxyyxxxxx"

    def test_tiny_alloc_alignment(self, tmp_path):
        st = ExtentStore(str(tmp_path))
        tid, off = st.alloc_tiny()
        assert 1 <= tid <= 64 and off == 0
        st.write(tid, off, b"z" * 100)
        tid2, off2 = st.alloc_tiny()
        assert tid2 != tid or off2 % PAGE_SIZE == 0
        # same tiny extent comes back page-aligned after wrap-around
        for _ in range(64):
            t, o = st.alloc_tiny()
            if t == tid:
                assert o == PAGE_SIZE
                st.write(t, o, b"w")
                assert st.read(t, o, 1) == b"w"

    def test_mark_delete_and_journal_reload(self, tmp_path):
        st = ExtentStore(str(tmp_path))
        eid = MIN_NORMAL_EXTENT_ID
        st.create(eid)
        st.write(eid, 0, b"data")
        st.mark_delete(eid)
        assert not st.has(eid)
        tid, off = st.alloc_tiny()
        st.write(tid, off, b"q" * 4096)
        st.mark_delete(tid, off, 4096)
        assert st.tiny_holes(tid) == [(off, 4096)]
        st2 = ExtentStore(str(tmp_path))  # journal reload
        assert st2.is_deleted(eid)
        assert st2.tiny_holes(tid) == [(off, 4096)]

    def test_crc_detects_corruption(self, tmp_path):
        st = ExtentStore(str(tmp_path))
        eid = MIN_NORMAL_EXTENT_ID
        st.create(eid)
        st.write(eid, 0, b"payload" * 100)
        with open(os.path.join(str(tmp_path), "extents", str(eid)), "r+b") as f:
            f.seek(10)
            f.write(b"\xff")
        with pytest.raises(BrokenExtent):
            st.read(eid, 0, 700)

    def test_watermarks(self, tmp_path):
        st = ExtentStore(str(tmp_path))
        eid = MIN_NORMAL_EXTENT_ID
        st.create(eid)
        st.write(eid, 0, b"abc")
        tid, off = st.alloc_tiny()
        st.write(tid, off, b"d" * 10)
        wm = st.watermarks()
        assert wm[eid] == 3
        assert wm[tid] == ((off + 10 + PAGE_SIZE - 1) // PAGE_SIZE) * PAGE_SIZE


# -- three-replica datanodes over real TCP ----------------------------------------


@pytest.fixture
def trio(tmp_path):
    net = InProcNet()
    nodes = []
    for i in (101, 102, 103):
        raft = MultiRaft(i, net)
        dn = DataNode(i, "127.0.0.1:0",
                      [str(tmp_path / f"dn{i}" / "disk0")], raft=raft)
        dn.start()
        nodes.append(dn)
    pool = ConnPool()
    hosts = [dn.addr for dn in nodes]
    peers = [dn.node_id for dn in nodes]
    for dn in nodes:
        rep = _rpc(pool, dn.addr, Packet(
            OP_CREATE_PARTITION, partition_id=10,
            arg={"peers": peers, "hosts": hosts}))
        assert rep.result == RES_OK
    run_until(net, lambda: any(
        dn.raft.is_leader(10) for dn in nodes), max_ticks=400)
    yield nodes, hosts, pool, net
    pool.close()
    for dn in nodes:
        dn.stop()


def _rpc(pool, addr, pkt):
    sock = pool.get(addr)
    try:
        send_packet(sock, pkt)
        rep = recv_packet(sock)
    except Exception:
        pool.put(addr, sock, ok=False)
        raise
    pool.put(addr, sock)
    return rep


class TestChainReplication:
    def test_write_replicates_to_all(self, trio):
        nodes, hosts, pool, _ = trio
        rep = _rpc(pool, hosts[0], Packet(
            OP_CREATE_EXTENT, partition_id=10, arg={"followers": hosts[1:]}))
        assert rep.result == RES_OK
        eid = rep.extent_id
        payload = os.urandom(300_000)
        off = 0
        for i in range(0, len(payload), 128 * 1024):
            chunk = payload[i: i + 128 * 1024]
            rep = _rpc(pool, hosts[0], Packet(
                OP_WRITE, partition_id=10, extent_id=eid, extent_offset=off,
                data=chunk, arg={"followers": hosts[1:]}))
            assert rep.result == RES_OK, rep.error()
            off += len(chunk)
        # every replica holds identical bytes (replica-targeted repair read;
        # client stream reads are leader-only once raft is attached)
        for addr in hosts:
            rep = _rpc(pool, addr, Packet(
                OP_REPAIR_READ, partition_id=10, extent_id=eid,
                extent_offset=0, arg={"size": len(payload)}))
            assert rep.result == RES_OK
            assert rep.data == payload

    def test_tiny_write_assigns_extent(self, trio):
        nodes, hosts, pool, _ = trio
        rep = _rpc(pool, hosts[0], Packet(
            OP_WRITE, partition_id=10, extent_id=0, data=b"small file",
            arg={"tiny": True, "followers": hosts[1:]}))
        assert rep.result == RES_OK
        assert 1 <= rep.extent_id <= 64
        for addr in hosts:
            got = _rpc(pool, addr, Packet(
                OP_REPAIR_READ, partition_id=10, extent_id=rep.extent_id,
                extent_offset=rep.extent_offset, arg={"size": 10}))
            assert got.data == b"small file"

    def test_mark_delete_replicates(self, trio):
        nodes, hosts, pool, _ = trio
        rep = _rpc(pool, hosts[0], Packet(
            OP_CREATE_EXTENT, partition_id=10, arg={"followers": hosts[1:]}))
        eid = rep.extent_id
        _rpc(pool, hosts[0], Packet(
            OP_WRITE, partition_id=10, extent_id=eid, extent_offset=0,
            data=b"doomed", arg={"followers": hosts[1:]}))
        rep = _rpc(pool, hosts[0], Packet(
            OP_MARK_DELETE, partition_id=10, extent_id=eid,
            arg={"followers": hosts[1:]}))
        assert rep.result == RES_OK
        for addr in hosts:
            got = _rpc(pool, addr, Packet(
                OP_REPAIR_READ, partition_id=10, extent_id=eid,
                extent_offset=0, arg={"size": 6}))
            assert got.result == RES_NOT_EXIST

    def test_random_write_via_raft(self, trio):
        nodes, hosts, pool, net = trio
        rep = _rpc(pool, hosts[0], Packet(
            OP_CREATE_EXTENT, partition_id=10, arg={"followers": hosts[1:]}))
        eid = rep.extent_id
        _rpc(pool, hosts[0], Packet(
            OP_WRITE, partition_id=10, extent_id=eid, extent_offset=0,
            data=b"0" * 1000, arg={"followers": hosts[1:]}))
        # find the raft leader and overwrite the middle
        done = {}

        def do_rw():
            for addr in hosts:
                rep = _rpc(pool, addr, Packet(
                    OP_RANDOM_WRITE, partition_id=10, extent_id=eid,
                    extent_offset=100, data=b"X" * 50))
                if rep.result == RES_OK:
                    done["ok"] = True
                    return

        t = threading.Thread(target=do_rw)
        t.start()
        run_until(net, lambda: not t.is_alive(), max_ticks=2000)
        t.join(timeout=10)
        assert done.get("ok")

        # followers apply once the next heartbeat carries the commit index
        def all_applied():
            return all(
                dn.space.partitions[10].store.read(eid, 100, 50, verify=False)
                == b"X" * 50
                for dn in nodes
            )

        assert run_until(net, all_applied, max_ticks=200)
        for addr in hosts:
            got = _rpc(pool, addr, Packet(
                OP_REPAIR_READ, partition_id=10, extent_id=eid,
                extent_offset=95, arg={"size": 60}))
            assert got.data == b"0" * 5 + b"X" * 50 + b"0" * 5

    def test_repair_catches_up_laggard(self, trio):
        nodes, hosts, pool, _ = trio
        rep = _rpc(pool, hosts[0], Packet(
            OP_CREATE_EXTENT, partition_id=10, arg={"followers": hosts[1:]}))
        eid = rep.extent_id
        payload = os.urandom(100_000)
        _rpc(pool, hosts[0], Packet(
            OP_WRITE, partition_id=10, extent_id=eid, extent_offset=0,
            data=payload, arg={"followers": hosts[1:]}))
        # mangle one follower: truncate its replica behind the others
        victim = nodes[2]
        store = victim.space.partitions[10].store
        with open(store._path(eid), "r+b") as f:
            f.truncate(40_000)
        with open(store._crc_path(eid), "r+b") as f:
            f.truncate(0)
        store._update_block_crcs(eid, 0, 40_000)
        wm = _rpc(pool, hosts[2], Packet(
            OP_GET_WATERMARKS, partition_id=10)).arg["watermarks"]
        assert wm[str(eid)] == 40_000
        moved = nodes[0].repair_partition(10)
        assert moved >= 60_000
        got = _rpc(pool, hosts[2], Packet(
            OP_REPAIR_READ, partition_id=10, extent_id=eid, extent_offset=0,
            arg={"size": len(payload)}))
        assert got.result == RES_OK, got.error()
        assert got.data == payload
        assert zlib.crc32(got.data) == zlib.crc32(payload)


class TestLeaderReadGate:
    def test_stream_read_is_leader_only(self, trio):
        """Client stream reads redirect off raft followers (stale-overwrite
        protection); repair reads still serve from any replica."""
        from chubaofs_tpu_torch.proto.packet import RES_NOT_LEADER

        nodes, hosts, pool, net = trio
        rep = _rpc(pool, hosts[0], Packet(
            OP_CREATE_EXTENT, partition_id=10, arg={"followers": hosts[1:]}))
        eid = rep.extent_id
        _rpc(pool, hosts[0], Packet(
            OP_WRITE, partition_id=10, extent_id=eid, extent_offset=0,
            data=b"gate", arg={"followers": hosts[1:]}))
        assert run_until(
            net, lambda: any(dn.space.partitions[10].is_raft_leader
                             for dn in nodes), max_ticks=300)
        leaders = 0
        for dn, addr in zip(nodes, hosts):
            got = _rpc(pool, addr, Packet(
                OP_STREAM_READ, partition_id=10, extent_id=eid,
                extent_offset=0, arg={"size": 4}))
            if dn.space.partitions[10].is_raft_leader:
                assert got.result == RES_OK and got.data == b"gate"
                leaders += 1
            else:
                assert got.result == RES_NOT_LEADER
                assert got.arg.get("leader") is not None
            # repair read is replica-targeted and always serves
            got = _rpc(pool, addr, Packet(
                OP_REPAIR_READ, partition_id=10, extent_id=eid,
                extent_offset=0, arg={"size": 4}))
            assert got.result == RES_OK and got.data == b"gate"
        assert leaders == 1


class TestRepairTrafficClass:
    def test_repair_lane_bounds_concurrency_client_io_unblocked(self, trio):
        """Traffic-class separation (ref datanode/server.go:99-103 smux
        ports, rebuilt as a priority lane): saturating the repair lane with
        slow bulk reads (a) never admits more than repair_lanes concurrent
        repair ops, and (b) leaves client STREAM_READ latency untouched."""
        import threading as _threading
        import time as _time

        from chubaofs_tpu_torch.utils.conn_pool import ConnPool

        nodes, hosts, pool, net = trio
        # the raft leader serves client stream reads; aim everything there
        leader_dn = next(dn for dn in nodes
                         if dn.space.partitions[10].is_raft_leader)
        laddr = leader_dn.addr
        eid_rep = _rpc(pool, laddr, Packet(
            OP_CREATE_EXTENT, partition_id=10,
            arg={"followers": [h for h in hosts if h != laddr]}))
        eid = eid_rep.extent_id
        _rpc(pool, laddr, Packet(
            OP_WRITE, partition_id=10, extent_id=eid, extent_offset=0,
            data=b"lane", arg={"followers": [h for h in hosts if h != laddr]}))

        store = leader_dn.space.partitions[10].store
        orig_read = store.read
        inflight, peak = [0], [0]
        gate = _threading.Lock()

        def slow_read(eid_, off, size, **kw):
            with gate:
                inflight[0] += 1
                peak[0] = max(peak[0], inflight[0])
            _time.sleep(0.4)
            try:
                return orig_read(eid_, off, size, **kw)
            finally:
                with gate:
                    inflight[0] -= 1

        store.read = slow_read
        try:
            def repair_req():
                p = ConnPool()
                try:
                    _rpc(p, laddr, Packet(
                        OP_REPAIR_READ, partition_id=10, extent_id=eid,
                        extent_offset=0, arg={"size": 4}))
                finally:
                    p.close()

            threads = [_threading.Thread(target=repair_req)
                       for _ in range(6)]
            for t in threads:
                t.start()
            _time.sleep(0.3)  # lane saturated: 2 running, 4 queued
            # client read on its own connection answers fast DESPITE the
            # saturated repair lane (it also runs the slow store.read once,
            # so "fast" = one read's latency, not the 6-deep repair queue)
            t0 = _time.perf_counter()
            got = _rpc(pool, laddr, Packet(
                OP_STREAM_READ, partition_id=10, extent_id=eid,
                extent_offset=0, arg={"size": 4}))
            dt = _time.perf_counter() - t0
            assert got.result == RES_OK and got.data == b"lane"
            assert dt < 1.0, f"client IO starved behind repair queue ({dt:.2f}s)"
            for t in threads:
                t.join(timeout=10)
            assert peak[0] <= leader_dn.repair_lanes + 1, (
                f"repair concurrency {peak[0]} exceeded the lane budget "
                f"(+1 for the client read sharing the patched store)")
        finally:
            store.read = orig_read
