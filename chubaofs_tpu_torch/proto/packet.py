"""Wire protocol — the binary TCP packet every data-plane op rides.

Reference counterpart: proto/packet.go:238-257 (the `Packet` struct: Magic,
Opcode, ResultCode, RemainingFollowers, CRC, Size, ArgLen, PartitionID,
ExtentID, ExtentOffset, ReqID, KernelOffset; opcodes :50-69). Design choices
kept: fixed little-endian header followed by an opaque arg blob (JSON here,
where the reference packs follower addresses as a '/'-joined string) and the
data payload, CRC32 over the payload, and a RemainingFollowers byte that the
chain-replication leader decrements before forwarding (packet.go:243,
repl/repl_protocol.go:35-39). Not kept: the reference's ~150 opcodes collapse
to the data-plane set below — metadata ops travel through raft proposals
instead of this wire (the reference package's meta/ plane)."""

from __future__ import annotations

import json
import socket
import struct
import zlib
from dataclasses import dataclass, field

MAGIC = 0xCF

# -- opcodes (proto/packet.go:50-69 analog, data-plane subset) -----------------
OP_CREATE_EXTENT = 0x01  # OpCreateExtent: alloc a normal extent id on the dp
OP_WRITE = 0x02  # OpWrite: append to a normal or tiny extent
OP_STREAM_READ = 0x03  # OpStreamRead: read [offset, offset+size) of an extent
OP_RANDOM_WRITE = 0x04  # OpRandomWrite: in-place overwrite, routed via raft
OP_MARK_DELETE = 0x05  # OpMarkDelete: extent (or tiny range) delete
OP_GET_WATERMARKS = 0x06  # OpGetAllWatermarks: {extent_id: size} for repair
OP_REPAIR_READ = 0x07  # OpExtentRepairRead: repair-path stream read
OP_REPAIR_WRITE = 0x08  # repair-path write (bypasses replication; local only)
OP_GET_PARTITION_METRICS = 0x09  # used + extent counts, for master heartbeats
OP_HEARTBEAT = 0x0A  # liveness probe
OP_CREATE_PARTITION = 0x0B  # admin: host a new data partition
OP_TINY_DELETE_RECORD = 0x0C  # replicated tiny-range punch-hole record
OP_RAFT_CONFIG = 0x0D  # admin: single-server raft membership change
OP_REMOVE_PARTITION = 0x0E  # admin: drop a retired partition replica
# metadata plane (proto/packet.go:72-82 OpMeta* analog): one opcode, the op
# name rides the arg blob — the metanode partition SM already dispatches by
# name, so ~40 distinct OpMeta opcodes collapse to a tagged envelope
OP_META_OP = 0x20

# opcode -> short name, for metric labels and trace/track entries (bounded
# cardinality by construction: the opcode set IS the label set)
OP_NAMES = {
    OP_CREATE_EXTENT: "create_extent", OP_WRITE: "write",
    OP_STREAM_READ: "stream_read", OP_RANDOM_WRITE: "random_write",
    OP_MARK_DELETE: "mark_delete", OP_GET_WATERMARKS: "get_watermarks",
    OP_REPAIR_READ: "repair_read", OP_REPAIR_WRITE: "repair_write",
    OP_GET_PARTITION_METRICS: "partition_metrics", OP_HEARTBEAT: "heartbeat",
    OP_CREATE_PARTITION: "create_partition",
    OP_TINY_DELETE_RECORD: "tiny_delete", OP_RAFT_CONFIG: "raft_config",
    OP_REMOVE_PARTITION: "remove_partition", OP_META_OP: "meta_op",
}


def op_name(opcode: int) -> str:
    return OP_NAMES.get(opcode, f"op_{opcode:#x}")

# -- result codes (proto/packet.go OpOk/OpErr/... analog) ----------------------
RES_OK = 0x00
RES_ERR = 0x01
RES_AGAIN = 0x02
RES_NOT_LEADER = 0x03
RES_NOT_EXIST = 0x04
RES_DISK_ERR = 0x05
RES_CRC_MISMATCH = 0x06

# magic, opcode, result, remaining_followers, crc, size, arg_len,
# partition_id, extent_id, extent_offset, kernel_offset, req_id
_HEADER = struct.Struct("<BBBBIIIQQQQQ")
HEADER_SIZE = _HEADER.size  # 56 bytes

# receive-side sanity bounds on the header's u32 length fields. The largest
# legit payload is a multi-MiB extent/shard write; 64 MiB leaves generous
# headroom while keeping a hostile header from preallocating 4 GiB.
MAX_DATA_LEN = 64 << 20
MAX_ARG_LEN = 16 << 20

TINY_EXTENT_COUNT = 64  # storage/extent_store.go:613-694: 64 shared tiny extents
TINY_EXTENT_MAX_ID = TINY_EXTENT_COUNT  # ids 1..64 are tiny, >=65 normal


def is_tiny_extent(extent_id: int) -> bool:
    return 1 <= extent_id <= TINY_EXTENT_MAX_ID


class ProtoError(Exception):
    pass


_req_counter = 0


def next_req_id() -> int:
    global _req_counter
    _req_counter += 1
    return _req_counter


@dataclass
class Packet:
    opcode: int
    partition_id: int = 0
    extent_id: int = 0
    extent_offset: int = 0
    kernel_offset: int = 0
    data: bytes = b""
    arg: dict = field(default_factory=dict)
    result: int = RES_OK
    remaining_followers: int = 0
    req_id: int = 0
    crc: int = 0

    def __post_init__(self):
        if self.req_id == 0:
            self.req_id = next_req_id()
        if self.data and self.crc == 0:
            self.crc = zlib.crc32(self.data)

    # -- framing ---------------------------------------------------------------

    def encode(self) -> bytes:
        arg_blob = json.dumps(self.arg).encode() if self.arg else b""
        hdr = _HEADER.pack(
            MAGIC, self.opcode, self.result, self.remaining_followers,
            self.crc, len(self.data), len(arg_blob),
            self.partition_id, self.extent_id, self.extent_offset,
            self.kernel_offset, self.req_id,
        )
        return hdr + arg_blob + self.data

    @classmethod
    def decode_header(cls, hdr: bytes) -> tuple["Packet", int, int]:
        (magic, opcode, result, followers, crc, size, arg_len,
         pid, eid, eoff, koff, req_id) = _HEADER.unpack(hdr)
        if magic != MAGIC:
            raise ProtoError(f"bad magic {magic:#x}")
        # bound the u32 length fields BEFORE anyone preallocates: both
        # receive paths (_recv_exact, PacketFramer.arm_stage) size a buffer
        # straight from the header, so an unchecked size=0xFFFFFFFF is a
        # 4 GiB allocation per corrupt/hostile connection
        if size > MAX_DATA_LEN or arg_len > MAX_ARG_LEN:
            raise ProtoError(f"oversized packet: data={size} arg={arg_len}")
        pkt = cls(opcode=opcode, partition_id=pid, extent_id=eid,
                  extent_offset=eoff, kernel_offset=koff, result=result,
                  remaining_followers=followers, req_id=req_id, crc=crc)
        return pkt, arg_len, size

    def verify_crc(self) -> bool:
        return not self.data or zlib.crc32(self.data) == self.crc

    # -- replies ---------------------------------------------------------------

    def reply(self, result: int = RES_OK, data: bytes = b"",
              arg: dict | None = None, extent_id: int | None = None,
              extent_offset: int | None = None) -> "Packet":
        """Build the response packet mirroring ids; write acks may rewrite the
        extent id/offset the datanode assigned (tiny-extent allocation)."""
        return Packet(
            opcode=self.opcode, partition_id=self.partition_id,
            extent_id=self.extent_id if extent_id is None else extent_id,
            extent_offset=self.extent_offset if extent_offset is None else extent_offset,
            kernel_offset=self.kernel_offset, data=data, arg=arg or {},
            result=result, req_id=self.req_id,
        )

    def error(self) -> str:
        return self.arg.get("error", f"result={self.result}")


# -- trace carrier on the packet wire ------------------------------------------
# The binary header is fixed; the trace id and returning track log ride the
# JSON arg blob under reserved keys (the reference packs follower addrs into
# its arg bytes the same way). Requests carry "_trace" (+ the caller's span
# id under "_span", so the server span records its cross-process parent);
# replies carry "_track".

TRACE_ARG_KEY = "_trace"
SPAN_ARG_KEY = "_span"
TRACK_ARG_KEY = "_track"


def trace_inject(pkt: "Packet") -> "Packet":
    """Attach the CURRENT thread span's trace id to an outgoing request."""
    from chubaofs_tpu_torch.blobstore import trace

    span = trace.current_span()
    if span is not None:
        pkt.arg[TRACE_ARG_KEY] = span.trace_id
        pkt.arg[SPAN_ARG_KEY] = span.span_id
    return pkt


def trace_extract(pkt: "Packet", operation: str):
    """Server side: a span continuing the packet's trace (or a fresh root)."""
    from chubaofs_tpu_torch.blobstore import trace

    tid = pkt.arg.get(TRACE_ARG_KEY) if isinstance(pkt.arg, dict) else None
    span = trace.Span(operation, trace_id=tid)
    if tid is not None:
        span.remote_parent = pkt.arg.get(SPAN_ARG_KEY)
    return span


def trace_reply(resp: "Packet", span) -> "Packet":
    """Attach the server span's track log to an outgoing reply."""
    if span is not None and span.track:
        resp.arg[TRACK_ARG_KEY] = span.track_entries()
    return resp


def trace_merge(resp: "Packet") -> None:
    """Client side: fold a reply's track log into the current span."""
    from chubaofs_tpu_torch.blobstore import trace

    span = trace.current_span()
    if span is not None and isinstance(resp.arg, dict):
        span.merge_track(resp.arg.get(TRACK_ARG_KEY))


# -- socket framing ---------------------------------------------------------------
#
# Zero-copy discipline: a multi-MB shard payload crosses this layer
# without a single Python-level copy in either direction. Sending hands the
# kernel an iovec of (header, arg, data) memoryviews via sendmsg — never
# `hdr + arg + data` concatenation, which would materialize the payload a
# second time. Receiving preallocates ONE bytearray of the exact size and
# fills it in place with recv_into — the old bytearray-accumulate-then-
# `bytes(buf)` path copied every payload twice (growth reallocs + the final
# freeze). Received payloads stay bytearray: every consumer (crc32, file
# writes, raft codec, json.loads, slice-assign into read buffers) takes any
# buffer object, and the freeze-to-bytes copy bought nothing.


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly n bytes into a preallocated buffer, filled in place."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            raise ConnectionError("peer closed")
        got += r
    return buf


def packet_iov(pkt: Packet) -> list:
    """The packet as a (header, arg, data) iovec — framing WITHOUT the
    payload concat `encode()` pays. The data element is a memoryview of the
    caller's buffer; nothing is copied."""
    arg_blob = json.dumps(pkt.arg).encode() if pkt.arg else b""
    hdr = _HEADER.pack(
        MAGIC, pkt.opcode, pkt.result, pkt.remaining_followers,
        pkt.crc, len(pkt.data), len(arg_blob),
        pkt.partition_id, pkt.extent_id, pkt.extent_offset,
        pkt.kernel_offset, pkt.req_id,
    )
    iov = [hdr]
    if arg_blob:
        iov.append(arg_blob)
    if pkt.data:
        iov.append(memoryview(pkt.data))
    return iov


def advance_iov(views: list, sent: int) -> list:
    """Drop `sent` bytes off the front of a memoryview iovec and return the
    remainder — THE pointer-advance for every partial-send site (blocking
    sendmsg_all, the evloop's direct send and shard flush all share it, so
    a boundary fix lands everywhere at once)."""
    i = 0
    for v in views:
        if sent < len(v):
            break
        sent -= len(v)
        i += 1
    rest = views[i:]
    if rest and sent:
        rest[0] = rest[0][sent:]
    return [v for v in rest if len(v)]


def sendmsg_all(sock: socket.socket, iov: list) -> None:
    """Drain an iovec through sendmsg, advancing memoryviews across partial
    sends — the writev analog. No buffer is ever joined."""
    views = [memoryview(b) for b in iov]
    while views:
        views = advance_iov(views, sock.sendmsg(views))


def send_packet(sock: socket.socket, pkt: Packet) -> None:
    iov = packet_iov(pkt)
    if hasattr(sock, "sendmsg"):
        sendmsg_all(sock, iov)
    else:  # sendmsg-less socket (test doubles, exotic platforms)
        for buf in iov:
            sock.sendall(buf)


def recv_packet(sock: socket.socket) -> Packet:
    pkt, arg_len, size = Packet.decode_header(_recv_exact(sock, HEADER_SIZE))
    if arg_len:
        pkt.arg = json.loads(_recv_exact(sock, arg_len))
    if size:
        pkt.data = _recv_exact(sock, size)
    return pkt


class PacketFramer:
    """Incremental packet codec — the event loop's per-connection read state
    machine, and the SAME framing recv_packet performs blockingly: header →
    arg blob → data payload, each stage a preallocated buffer the loop fills
    with non-blocking recv_into calls (partial reads resume where they
    stopped). The data-stage buffer BECOMES pkt.data — zero copies on the
    receive path, same as the blocking side.

    Contract (rpc/evloop.py consumes it): `need()` says how many bytes the
    next stage wants; the loop hands back the exact-size filled buffer via
    `feed(buf)`, which returns a completed Packet or None (mid-message).
    Malformed input raises ProtoError — the connection is dropped."""

    def __init__(self):
        self._pkt: Packet | None = None
        self._arg_len = 0
        self._size = 0
        self._stage = "hdr"

    def need(self) -> int:
        if self._stage == "hdr":
            return HEADER_SIZE
        if self._stage == "arg":
            return self._arg_len
        return self._size

    def feed(self, buf: bytearray) -> Packet | None:
        if self._stage == "hdr":
            self._pkt, self._arg_len, self._size = Packet.decode_header(buf)
            self._stage = "arg" if self._arg_len else "data"
        elif self._stage == "arg":
            try:
                self._pkt.arg = json.loads(buf)
            except ValueError as e:
                raise ProtoError(f"bad arg blob: {e}") from None
            self._stage = "data"
        else:
            self._pkt.data = buf
            self._stage = "done"
        if self._stage == "arg" or (self._stage == "data" and self._size):
            return None
        pkt, self._pkt, self._stage = self._pkt, None, "hdr"
        return pkt
