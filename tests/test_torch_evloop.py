"""The cases of tests/test_evloop.py, run against the port on the CPU: every
name and assertion as in the reference, imports from chubaofs_tpu_torch.

The reference file's docstring:

Event-loop packet data path: zero-copy framing invariants,
evloop-vs-threaded serving matrix, write-queue backpressure fairness, chaos
failpoints on evloop connections, and restart hygiene."""

from __future__ import annotations

import os
import socket
import threading
import time

import pytest

from chubaofs_tpu_torch.proto.packet import (
    HEADER_SIZE,
    OP_HEARTBEAT,
    OP_WRITE,
    Packet,
    PacketFramer,
    RES_OK,
    packet_iov,
    recv_packet,
    send_packet,
)
from chubaofs_tpu_torch import chaos as t_chaos


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


PAYLOAD = os.urandom(1 << 20)  # 1 MiB: a copy would be visible and expensive


# -- zero-copy framing invariants ---------------------------------------------


class _SendmsgSock:
    """Records every sendmsg iovec; optionally sends partially."""

    def __init__(self, max_per_call: int | None = None):
        self.calls: list[list[memoryview]] = []
        self.bytes = bytearray()
        self.max_per_call = max_per_call

    def sendmsg(self, iov):
        iov = list(iov)
        self.calls.append(iov)
        budget = self.max_per_call
        sent = 0
        for view in iov:
            take = len(view) if budget is None else min(len(view), budget - sent)
            self.bytes += view[:take]
            sent += take
            if budget is not None and sent >= budget:
                break
        return sent


def test_send_packet_never_concats_the_payload():
    """Acceptance: `send_packet` hands the kernel the caller's data buffer
    as a memoryview in an iovec — it never materializes header+arg+data as
    one joined blob."""
    pkt = Packet(OP_WRITE, partition_id=3, extent_id=70, data=PAYLOAD,
                 arg={"followers": []})
    sock = _SendmsgSock()
    send_packet(sock, pkt)
    flat = [v for call in sock.calls for v in call]
    # the payload element IS the caller's buffer (memoryview over it)
    assert any(isinstance(v, memoryview) and v.obj is PAYLOAD for v in flat)
    # and no single buffer is a concatenation spanning header + payload
    assert all(len(v) <= len(PAYLOAD) for v in flat)
    assert bytes(sock.bytes) == pkt.encode()  # wire bytes identical


def test_sendmsg_partial_sends_resume():
    pkt = Packet(OP_WRITE, data=PAYLOAD, arg={"k": "v"})
    sock = _SendmsgSock(max_per_call=1000)  # force many partial writes
    send_packet(sock, pkt)
    assert bytes(sock.bytes) == pkt.encode()


def test_send_packet_sendall_fallback_passes_buffer_by_identity():
    class _SendallSock:  # no sendmsg attribute at all
        def __init__(self):
            self.bufs = []

        def sendall(self, b):
            self.bufs.append(b)

    pkt = Packet(OP_WRITE, data=PAYLOAD)
    sock = _SendallSock()
    send_packet(sock, pkt)
    assert any(isinstance(b, memoryview) and b.obj is PAYLOAD
               for b in sock.bufs)


class _RecvIntoSock:
    """Serves wire bytes ONLY through recv_into, in dribbles; recv() is a
    trap — the copying API must never be touched."""

    def __init__(self, wire: bytes, chunk: int = 1499):
        self.wire = memoryview(wire)
        self.pos = 0
        self.chunk = chunk
        self.recv_into_calls = 0

    def recv(self, n):  # pragma: no cover - the assertion is the point
        raise AssertionError("recv() copies; the framing layer must recv_into")

    def recv_into(self, view):
        self.recv_into_calls += 1
        n = min(len(view), self.chunk, len(self.wire) - self.pos)
        view[:n] = self.wire[self.pos:self.pos + n]
        self.pos += n
        return n


def test_recv_packet_fills_preallocated_buffer_in_place():
    """Acceptance: the receive side preallocates the data buffer and fills
    it with recv_into — no bytearray-accumulate → bytes() double copy."""
    pkt = Packet(OP_WRITE, partition_id=9, extent_id=100, data=PAYLOAD,
                 arg={"followers": ["a:1"]})
    sock = _RecvIntoSock(pkt.encode())
    got = recv_packet(sock)
    assert isinstance(got.data, bytearray)  # the filled buffer itself
    assert got.data == PAYLOAD and got.verify_crc()
    assert got.arg["followers"] == ["a:1"]
    assert sock.recv_into_calls > 3  # really arrived in dribbles


def test_packet_framer_incremental_and_zero_copy():
    """The evloop's PacketFramer is the same codec: stage sizes via need(),
    buffers filled externally, and the data-stage buffer BECOMES pkt.data."""
    pkt = Packet(OP_WRITE, extent_offset=7, data=PAYLOAD, arg={"a": 1})
    wire = memoryview(pkt.encode())
    fr = PacketFramer()
    pos = 0
    fed_bufs = []
    msg = None
    while msg is None:
        n = fr.need()
        assert n > 0
        buf = bytearray(wire[pos:pos + n])
        pos += n
        fed_bufs.append(buf)
        msg = fr.feed(buf)
    assert pos == len(wire)
    assert msg.data is fed_bufs[-1]  # zero copy: the stage buffer itself
    assert msg.data == PAYLOAD and msg.verify_crc()
    assert msg.arg == {"a": 1} and msg.extent_offset == 7
    # framer resets: a second packet parses on the same instance
    assert fr.need() == HEADER_SIZE


def test_packet_framer_rejects_bad_magic():
    from chubaofs_tpu_torch.proto.packet import ProtoError

    fr = PacketFramer()
    with pytest.raises(ProtoError):
        fr.feed(bytearray(b"\x00" * HEADER_SIZE))


def test_decode_header_bounds_claimed_lengths():
    """Both receive paths preallocate a buffer sized straight from the
    header's u32 length fields — a hostile size=0xFFFFFFFF must be rejected
    at decode, not handed to bytearray() as a 4 GiB allocation."""
    import struct

    from chubaofs_tpu_torch.proto.packet import (
        MAGIC, MAX_DATA_LEN, Packet, ProtoError, _HEADER)

    def hdr(size, arg_len):
        return _HEADER.pack(MAGIC, 1, 0, 0, 0, size, arg_len,
                            0, 0, 0, 0, 0)

    with pytest.raises(ProtoError):
        Packet.decode_header(hdr(0xFFFFFFFF, 0))
    with pytest.raises(ProtoError):
        Packet.decode_header(hdr(0, 0xFFFFFFFF))
    # the largest legit payload still decodes
    pkt, arg_len, size = Packet.decode_header(hdr(MAX_DATA_LEN, 16))
    assert size == MAX_DATA_LEN and arg_len == 16
    # and a framer fed a hostile header drops the conn, not the process
    fr = PacketFramer()
    with pytest.raises(ProtoError):
        fr.feed(bytearray(hdr(0xFFFFFFFF, 0)))


# -- serving matrix: evloop and threaded shim ----------------------------------


def _echo_dispatch(pkt: Packet) -> Packet:
    return pkt.reply(RES_OK, data=bytes(pkt.data))


@pytest.fixture(params=["1", "0"], ids=["evloop", "threaded"])
def repl_server(request, monkeypatch):
    from chubaofs_tpu_torch.data.repl import ReplServer

    monkeypatch.setenv("CFS_EVLOOP", request.param)
    srv = ReplServer("127.0.0.1:0", _echo_dispatch)
    srv.start()
    assert (srv._evloop is not None) == (request.param == "1")
    yield srv
    srv.stop()


def _connect(addr: str) -> socket.socket:
    host, port = addr.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=10.0)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def test_repl_roundtrip_both_modes(repl_server):
    s = _connect(repl_server.addr)
    try:
        send_packet(s, Packet(OP_WRITE, partition_id=1, data=PAYLOAD))
        rep = recv_packet(s)
        assert rep.result == RES_OK and rep.data == PAYLOAD
    finally:
        s.close()


def test_repl_pipelined_burst_stays_in_order(repl_server):
    """The sdk/stream write burst contract: N packets down one socket, acks
    come back in send order (per-connection dispatch is serial)."""
    s = _connect(repl_server.addr)
    try:
        for i in range(64):
            send_packet(s, Packet(OP_WRITE, extent_offset=i,
                                  data=i.to_bytes(4, "little")))
        for i in range(64):
            rep = recv_packet(s)
            assert rep.extent_offset == i
            assert int.from_bytes(bytes(rep.data), "little") == i
    finally:
        s.close()


def test_meta_service_both_modes(monkeypatch):
    from chubaofs_tpu_torch.meta.service import MetaService, RemoteMetaNode

    class _StubMeta:
        partitions: dict = {}

        def read_dir(self, pid, parent):
            return [{"name": "f", "ino": 2, "pid": pid, "parent": parent}]

    for mode in ("1", "0"):
        monkeypatch.setenv("CFS_EVLOOP", mode)
        svc = MetaService(_StubMeta())
        try:
            rmn = RemoteMetaNode(svc.addr)
            out = rmn.read_dir(7, 1)
            assert out[0]["pid"] == 7 and out[0]["parent"] == 1
            rmn.close()
        finally:
            svc.close()


def test_evloop_env_escape_hatch(monkeypatch):
    from chubaofs_tpu_torch.rpc.evloop import evloop_enabled

    monkeypatch.delenv("CFS_EVLOOP", raising=False)
    assert evloop_enabled()  # default ON
    monkeypatch.setenv("CFS_EVLOOP", "0")
    assert not evloop_enabled()


def test_repl_restart_rebinds_same_port(monkeypatch):
    """Crash-restart hygiene: stop tears the loop down completely; a new
    server binds the same port and serves."""
    from chubaofs_tpu_torch.data.repl import ReplServer

    monkeypatch.setenv("CFS_EVLOOP", "1")
    srv = ReplServer("127.0.0.1:0", _echo_dispatch)
    srv.start()
    addr = srv.addr
    s = _connect(addr)
    send_packet(s, Packet(OP_HEARTBEAT))
    assert recv_packet(s).result == RES_OK
    s.close()
    srv.stop()
    srv2 = ReplServer(addr, _echo_dispatch)
    srv2.start()
    try:
        s = _connect(addr)
        send_packet(s, Packet(OP_HEARTBEAT))
        assert recv_packet(s).result == RES_OK
        s.close()
    finally:
        srv2.stop()


# -- backpressure: a wedged reader must not stall its shard --------------------


def test_slow_reader_backpressure_spares_shard_neighbors():
    """One shard, two clients. Client A floods requests without reading a
    byte of replies until its write queue crosses the high-water mark —
    the shard pauses READS from A only. Client B's roundtrips on the SAME
    shard stay live throughout; once A finally drains, every reply arrives
    complete and in order."""
    from chubaofs_tpu_torch.rpc.evloop import EvloopServer
    from chubaofs_tpu_torch.utils import exporter

    amp = 64  # 4 KiB request -> 256 KiB reply: the write queue fills from
    # TINY requests, so the flood is fully sent before reads pause and the
    # test can never wedge on its own send side

    def _amplify(pkt: Packet) -> Packet:
        return pkt.reply(RES_OK, data=bytes(pkt.data) * amp)

    listener = socket.create_server(("127.0.0.1", 0))
    addr = f"127.0.0.1:{listener.getsockname()[1]}"
    srv = EvloopServer(listener, _amplify, name="bp-test",
                       shards=1, workers=2, write_hwm=128 * 1024)
    srv.start()
    try:
        blob = os.urandom(4 * 1024)
        a, b = _connect(addr), _connect(addr)
        n_flood = 40  # 10 MiB of replies >> kernel buffers + 128 KiB HWM
        for i in range(n_flood):
            send_packet(a, Packet(OP_WRITE, extent_offset=i, data=blob))
        deadline = time.monotonic() + 10.0
        bp = exporter.registry("evloop").counter(
            "backpressure", {"srv": "bp-test", "shard": "0"})
        while bp.value == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert bp.value >= 1, "write queue never hit the high-water mark"
        # B, on the same (only) shard, still gets prompt service
        for i in range(20):
            t0 = time.perf_counter()
            send_packet(b, Packet(OP_WRITE, data=b"live?"))
            rep = recv_packet(b)
            assert rep.data == b"live?" * amp
            assert time.perf_counter() - t0 < 5.0
        # A drains: all flood replies arrive, in order, byte-identical
        for i in range(n_flood):
            rep = recv_packet(a)
            assert rep.extent_offset == i and rep.data == blob * amp
        a.close()
        b.close()
    finally:
        srv.stop()
        listener.close()


def test_single_oversized_request_pauses_then_resumes():
    """One request bigger than the high-water mark on an otherwise idle
    connection: the pause (set by the loop) and the drain's low-water
    resume check run on different threads — if they race, the conn stays
    read-paused forever. The reply AND a follow-up request must both
    complete."""
    from chubaofs_tpu_torch.rpc.evloop import EvloopServer

    def _ack(pkt: Packet) -> Packet:
        return pkt.reply(RES_OK, data=bytes(pkt.data[:8]))

    listener = socket.create_server(("127.0.0.1", 0))
    addr = f"127.0.0.1:{listener.getsockname()[1]}"
    srv = EvloopServer(listener, _ack, name="big-one",
                       shards=1, workers=2, write_hwm=64 * 1024)
    srv.start()
    try:
        a = _connect(addr)
        a.settimeout(15)
        for _ in range(3):  # repeat: the race is timing-dependent
            blob = os.urandom(128 * 1024)  # 2x the high-water mark
            send_packet(a, Packet(OP_WRITE, data=blob))
            assert recv_packet(a).data == blob[:8]
        a.close()
    finally:
        srv.stop()
        listener.close()


def test_fast_sender_slow_handler_inbox_backpressure():
    """The other direction: a client floods requests while dispatch is
    wedged (slow handler), so replies can't fill the write queue — the
    parsed-request inbox must hit the same high-water mark and pause reads,
    keeping per-connection memory bounded instead of parsing the whole
    flood into the inbox. Once the handler unwedges, every reply arrives in
    order."""
    import threading

    from chubaofs_tpu_torch.rpc.evloop import EvloopServer
    from chubaofs_tpu_torch.utils import exporter

    gate = threading.Event()

    def _gated(pkt: Packet) -> Packet:
        gate.wait(timeout=30)
        return pkt.reply(RES_OK, data=bytes(pkt.data[:8]))

    hwm = 64 * 1024
    listener = socket.create_server(("127.0.0.1", 0))
    addr = f"127.0.0.1:{listener.getsockname()[1]}"
    srv = EvloopServer(listener, _gated, name="inbox-bp",
                       shards=1, workers=2, write_hwm=hwm)
    srv.start()
    try:
        blob = os.urandom(4 * 1024)
        a = _connect(addr)
        n_flood = 64  # 256 KiB of requests >> the 64 KiB high-water mark

        def flood():
            for i in range(n_flood):
                send_packet(a, Packet(OP_WRITE, extent_offset=i, data=blob))

        sender = threading.Thread(target=flood, daemon=True)
        sender.start()
        bp = exporter.registry("evloop").counter(
            "backpressure", {"srv": "inbox-bp", "shard": "0"})
        deadline = time.monotonic() + 10.0
        while bp.value == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert bp.value >= 1, "inbox never hit the high-water mark"
        shard = srv.shards[0]
        with shard._lock:
            parked = max(c.inbox_bytes for c in shard.conns.values())
        assert parked <= hwm + len(blob) + 1024, \
            f"inbox kept growing past the high-water mark: {parked}"
        gate.set()
        for i in range(n_flood):
            rep = recv_packet(a)
            assert rep.extent_offset == i and rep.data == blob[:8]
        sender.join(timeout=10)
        assert not sender.is_alive()
        a.close()
    finally:
        gate.set()
        srv.stop()
        listener.close()


# -- chaos on an evloop connection ---------------------------------------------


def test_chaos_delay_on_evloop_dispatch(repl_server):
    from chubaofs_tpu_torch import chaos

    s = _connect(repl_server.addr)
    try:
        if repl_server._evloop is None:
            pytest.skip("evloop.dispatch failpoint is the evloop's site")
        chaos.arm("evloop.dispatch", "delay(0.2)*1")
        t0 = time.perf_counter()
        send_packet(s, Packet(OP_HEARTBEAT))
        recv_packet(s)
        assert time.perf_counter() - t0 >= 0.2
    finally:
        chaos.disarm("evloop.dispatch")
        s.close()


def test_chaos_link_drop_kills_one_conn_not_the_server(monkeypatch):
    """An injected ConnectionError in dispatch drops THAT connection (the
    wire contract for a link cut mid-op); the server and other connections
    keep serving."""
    from chubaofs_tpu_torch import chaos
    from chubaofs_tpu_torch.data.repl import ReplServer

    monkeypatch.setenv("CFS_EVLOOP", "1")
    srv = ReplServer("127.0.0.1:0", _echo_dispatch)
    srv.start()
    try:
        victim, healthy = _connect(srv.addr), _connect(srv.addr)
        chaos.arm("evloop.dispatch", "error(link down)*1")
        send_packet(victim, Packet(OP_HEARTBEAT))
        with pytest.raises((ConnectionError, OSError)):
            recv_packet(victim)  # conn dropped by the injected link cut
        chaos.disarm("evloop.dispatch")
        send_packet(healthy, Packet(OP_WRITE, data=b"still here"))
        assert recv_packet(healthy).data == b"still here"
        victim.close()
        healthy.close()
    finally:
        chaos.disarm("evloop.dispatch")
        srv.stop()


# -- conn-pool parity ---------------------------------------------------------


def test_conn_pool_counters_and_eviction(monkeypatch):
    from chubaofs_tpu_torch.utils import exporter
    from chubaofs_tpu_torch.utils.conn_pool import ConnPool

    monkeypatch.setenv("CFS_EVLOOP", "1")
    from chubaofs_tpu_torch.data.repl import ReplServer

    srv = ReplServer("127.0.0.1:0", _echo_dispatch)
    srv.start()
    reg = exporter.registry("connpool")
    reuse0 = reg.counter("reuse").value
    miss0 = reg.counter("miss").value
    evict0 = reg.counter("evict").value
    pool = ConnPool(idle_timeout=0.05)
    try:
        s1 = pool.get(srv.addr)          # miss
        pool.put(srv.addr, s1)
        s2 = pool.get(srv.addr)          # reuse (warm)
        assert s2 is s1
        pool.put(srv.addr, s2)
        time.sleep(0.08)                 # idle past the TTL
        s3 = pool.get(srv.addr)          # evict stale + miss
        pool.put(srv.addr, s3)
        assert reg.counter("reuse").value - reuse0 == 1
        assert reg.counter("miss").value - miss0 == 2
        assert reg.counter("evict").value - evict0 == 1
    finally:
        pool.close()
        srv.stop()


# -- evloop metrics -------------------------------------------------------------


def test_evloop_metrics_families(monkeypatch):
    from chubaofs_tpu_torch.data.repl import ReplServer
    from chubaofs_tpu_torch.utils import exporter

    monkeypatch.setenv("CFS_EVLOOP", "1")
    srv = ReplServer("127.0.0.1:0", _echo_dispatch)
    srv.start()
    try:
        s = _connect(srv.addr)
        send_packet(s, Packet(OP_HEARTBEAT))
        recv_packet(s)
        text = exporter.registry("evloop").render()
        assert "cfs_evloop_conns" in text
        assert "cfs_evloop_dispatch" in text
        s.close()
    finally:
        srv.stop()
