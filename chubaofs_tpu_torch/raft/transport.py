"""TCP raft transport — the network twin of InProcNet.

Reference counterpart: depends/tiglabs/raft's dedicated TCP transports
(transport_heartbeat.go, transport_replicate.go) with merged heartbeats
across groups (depends/tiglabs/raft/README.md:18). Kept: per-destination
batching (every `send` groups all groups' messages to one peer into ONE
frame — the merged-heartbeat idea), fire-and-forget delivery (raft tolerates
loss; a dead peer's queue drops oldest first), background per-peer sender
threads so a slow peer never stalls the tick loop. Changed: one port instead
of two — heartbeats here are tiny Msg batches on the same framed stream, so
a separate heartbeat listener buys nothing.

Framing: [u32 length][32B HMAC-SHA256][codec-encoded list[Msg]]. The payload
is a safe tagged-binary encoding (raft.codec) that can only ever decode to
plain values — a hostile frame cannot make the decoder run code, so the HMAC
is an integrity/anti-spoof gate, not the last line of defense. Binding the
listener off-loopback REQUIRES an explicit cluster secret (refused at start
otherwise): with the well-known default secret any network peer could inject
raft traffic and corrupt consensus state.
"""

from __future__ import annotations

import hashlib
import hmac
import queue
import socket
import struct
import threading

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.raft import codec
from chubaofs_tpu_torch.raft.core import Entry, Msg
from chubaofs_tpu_torch.rpc.evloop import EvloopServer, evloop_enabled

_LEN = struct.Struct("<I")
MAX_FRAME = 256 << 20  # a snapshot install rides one frame
DEFAULT_SECRET = b"chubaofs-tpu-raft"

# Msg fields in wire order; entries ride separately as (term, data) pairs
_MSG_FIELDS = (
    "type", "group", "src", "dst", "term", "last_log_index", "last_log_term",
    "granted", "prev_index", "prev_term", "commit", "success", "match_index",
    "snap_index", "snap_term", "snap_data", "hb",
)


def _wire_msgs(msgs: list[Msg]) -> list:
    return [
        [[getattr(m, f) for f in _MSG_FIELDS],
         [(e.term, e.data) for e in m.entries]]
        for m in msgs
    ]


def _unwire_msgs(v) -> list[Msg]:
    if not isinstance(v, list):
        raise codec.CodecError("frame is not a message batch")
    out = []
    for item in v:
        fields, ents = item
        if len(fields) != len(_MSG_FIELDS):
            raise codec.CodecError("bad message field count")
        m = Msg(**dict(zip(_MSG_FIELDS, fields)))
        m.entries = [Entry(term, data) for term, data in ents]
        out.append(m)
    return out


def _pack(secret: bytes, msgs: list[Msg]) -> bytes:
    payload = codec.dumps(_wire_msgs(msgs))
    mac = hmac.new(secret, payload, hashlib.sha256).digest()
    return _LEN.pack(len(payload)) + mac + payload


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


class _FrameFramer:
    """Incremental reader for the [u32 len][32B MAC][payload] raft frame —
    the evloop per-connection state machine twin of the blocking _serve
    loop. Yields (mac, payload); oversized lengths raise and drop the
    connection before a byte of the body is bought."""

    def __init__(self):
        self._stage = "len"
        self._length = 0
        self._mac: bytes | None = None

    def need(self) -> int:
        if self._stage == "len":
            return _LEN.size
        if self._stage == "mac":
            return 32
        return self._length

    def feed(self, buf: bytearray):
        if self._stage == "len":
            (self._length,) = _LEN.unpack(buf)
            if self._length > MAX_FRAME:
                raise codec.CodecError("oversized frame")
            self._stage = "mac"
            return None
        if self._stage == "mac":
            self._mac = bytes(buf)
            self._stage = "payload"
            return None
        mac, self._mac, self._stage = self._mac, None, "len"
        return (mac, buf)


class _PeerLink:
    """One outbound connection + sender thread; reconnects lazily per frame."""

    def __init__(self, addr: str, secret: bytes):
        self.addr = addr
        self.secret = secret
        self.q: queue.Queue[list[Msg]] = queue.Queue(maxsize=256)
        self.sock: socket.socket | None = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def offer(self, msgs: list[Msg]) -> None:
        try:
            self.q.put_nowait(msgs)
        except queue.Full:  # drop oldest: newer raft state supersedes older
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            try:
                self.q.put_nowait(msgs)
            except queue.Full:
                pass

    def _connect(self) -> socket.socket:
        host, port = self.addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=2.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _run(self):
        while not self._stop.is_set():
            try:
                msgs = self.q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                if self.sock is None:
                    self.sock = self._connect()
                self.sock.sendall(_pack(self.secret, msgs))
            except OSError:
                if self.sock is not None:
                    try:
                        self.sock.close()
                    except OSError:
                        pass
                    self.sock = None
                # message dropped — raft retries via the next tick

    def close(self):
        self._stop.set()
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass


class TcpNet:
    """Network transport for one MultiRaft node.

    `peers` maps node_id -> "host:port" for every raft node including self;
    the local node's entry is the listen address. Implements the same
    send/register surface InProcNet does, so MultiRaft is transport-blind.
    """

    def __init__(self, node_id: int, peers: dict[int, str],
                 secret: bytes = DEFAULT_SECRET):
        self.node_id = node_id
        self.peers = dict(peers)
        self.secret = secret
        self.node = None  # the local MultiRaft, set by register()
        self.links: dict[int, _PeerLink] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()

        host, port = self.peers[node_id].rsplit(":", 1)
        if secret == DEFAULT_SECRET and host not in ("127.0.0.1", "localhost", "::1"):
            raise ValueError(
                "raft transport bound off-loopback requires an explicit "
                "cluster secret (set 'raftSecret' in the daemon config); "
                "refusing to start with the well-known default")
        self.listener = socket.create_server((host, int(port)))
        self.listen_addr = f"{host}:{self.listener.getsockname()[1]}"
        self.peers[node_id] = self.listen_addr
        self._evloop: EvloopServer | None = None
        if evloop_enabled():
            # inbound raft frames ride the shared event-loop core: verify +
            # decode + deliver run on its worker pool (deliver takes node
            # locks), fire-and-forget so encode=None
            self._evloop = EvloopServer(self.listener, self._on_frame,
                                        name="raft",
                                        framer_factory=_FrameFramer,
                                        encode=None)
            self._evloop.start()
        else:
            self._accept_thread = threading.Thread(target=self._accept,
                                                   daemon=True)
            self._accept_thread.start()

    # -- InProcNet surface ----------------------------------------------------

    def register(self, node) -> None:
        self.node = node

    def send(self, msgs: list[Msg]) -> None:
        by_dst: dict[int, list[Msg]] = {}
        for m in msgs:
            by_dst.setdefault(m.dst, []).append(m)
        for dst, batch in by_dst.items():
            try:
                # injected link loss/flap: drop the batch on the floor —
                # raft re-sends via the next tick, exactly like real loss
                chaos.failpoint("raft.send", node=self.node_id)
            except chaos.FailpointError:
                continue
            if dst == self.node_id:
                if self.node is not None:
                    self.node.deliver(batch)
                continue
            link = self._link(dst)
            if link is not None:
                link.offer(batch)

    # -- plumbing -------------------------------------------------------------

    def _link(self, dst: int) -> _PeerLink | None:
        addr = self.peers.get(dst)
        if addr is None:
            return None
        with self._lock:
            link = self.links.get(dst)
            if link is None or link.addr != addr:
                if link is not None:
                    link.close()
                link = self.links[dst] = _PeerLink(addr, self.secret)
            return link

    def set_peer(self, node_id: int, addr: str) -> None:
        """Membership/address change: future sends dial the new address."""
        with self._lock:
            self.peers[node_id] = addr

    def _on_frame(self, msg) -> None:
        """Evloop handler: one (mac, payload) frame — authenticate, decode,
        deliver. Any failure raises, which drops THAT connection (the
        blocking _serve loop's `return` on the same conditions)."""
        mac, payload = msg
        want = hmac.new(self.secret, payload, hashlib.sha256).digest()
        if not hmac.compare_digest(mac, want):
            raise ConnectionError("unauthenticated frame")
        msgs = _unwire_msgs(codec.loads(payload))  # CodecError et al drop the conn
        if self.node is not None:
            self.node.deliver(msgs)

    def _accept(self):
        """CFS_EVLOOP=0 shim: the pre-evloop thread-per-connection path."""
        while not self._stop.is_set():
            try:
                conn, _ = self.listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(  # racelint: CFS_EVLOOP=0 rollback shim — evloop is the default serving path
                target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                (length,) = _LEN.unpack(_recv_exact(conn, _LEN.size))
                if length > MAX_FRAME:
                    return
                mac = _recv_exact(conn, 32)
                payload = _recv_exact(conn, length)
                want = hmac.new(self.secret, payload, hashlib.sha256).digest()
                if not hmac.compare_digest(mac, want):
                    return  # unauthenticated frame: drop the connection
                try:
                    msgs = _unwire_msgs(codec.loads(payload))
                except (codec.CodecError, TypeError, ValueError):
                    return  # malformed frame: hostile or corrupt — drop conn
                if self.node is not None:
                    self.node.deliver(msgs)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        self._stop.set()
        if self._evloop is not None:
            self._evloop.stop()
        try:
            self.listener.close()
        except OSError:
            pass
        with self._lock:
            for link in self.links.values():
                link.close()
            self.links.clear()
