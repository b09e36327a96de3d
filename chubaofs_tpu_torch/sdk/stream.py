"""Extent client — the hot-tier streaming data SDK.

Reference counterpart: sdk/data/stream (ExtentClient extent_client.go,
Streamer.write stream_writer.go:278 with the flush-before-overwrite rule
:299-309, doWrite :433, ExtentHandler extent_handler.go:49-79 with its
sender/receiver pipeline, reader stream_reader.go) and sdk/data/wrapper's
KFasterRandomSelector (k_faster_random_selector.go:53-58).

Kept:
  * per-inode Streamer; appends ride an ExtentHandler that pipelines ≤128KiB
    packets over one pooled connection to the partition leader (acks are
    collected at flush — the sender/receiver goroutine pair collapsed into a
    send-now/ack-on-flush window);
  * overwrites FLUSH first, then go through the raft random-write op against
    the owning extent (stream_writer.go:299-309);
  * small first writes use the tiny-extent path — the datanode assigns the
    extent id + offset and the ack carries them back;
  * flush emits only the newly-acked extent suffix as ExtentKeys to the
    metanode (AppendExtentKey, sdk/meta/api.go:1137) so keys never overlap;
  * partition selection ranks by EWMA ack latency and picks randomly among
    the fastest half (KFasterRandom).
"""

from __future__ import annotations

import random
import socket
import time
from collections import deque

from chubaofs_tpu_torch.proto.packet import (
    OP_CREATE_EXTENT, OP_MARK_DELETE, OP_RANDOM_WRITE, OP_STREAM_READ,
    OP_WRITE, Packet, RES_NOT_LEADER, RES_OK, is_tiny_extent, recv_packet,
    send_packet,
)
from chubaofs_tpu_torch.utils.conn_pool import ConnPool

PACKET_SIZE = 128 * 1024
TINY_LIMIT = PACKET_SIZE  # first write ≤ this rides a tiny extent


class StreamError(Exception):
    pass


class ExtentClient:
    """Partition view + selector + conn pool shared by all streamers."""

    def __init__(self, refresh_partitions, pool: ConnPool | None = None,
                 follower_read: bool = False):
        """refresh_partitions() -> [{"pid": int, "hosts": [addr,...]}] — the
        master's data-partition view for the volume (wrapper.go analog).
        follower_read: volume option — reads may hit ANY replica, ranked by
        per-host EWMA latency (the reference's FollowerRead + the selector's
        read-side job, sdk/data/stream follower-read)."""
        self._refresh = refresh_partitions
        self.pool = pool or ConnPool()
        self.follower_read = follower_read
        self._parts: list[dict] = []
        self._lat: dict[int, float] = {}  # pid -> EWMA seconds
        self._host_lat: dict[str, float] = {}  # host -> EWMA seconds (reads)

    def partitions(self) -> list[dict]:
        if not self._parts:
            self._parts = list(self._refresh())
        return self._parts

    def refresh(self) -> None:
        self._parts = list(self._refresh())

    def select(self) -> dict:
        parts = self.partitions()
        if not parts:
            raise StreamError("no writable data partitions")
        ranked = sorted(parts, key=lambda p: self._lat.get(p["pid"], 0.0))
        k = max(1, len(ranked) // 2)
        return random.choice(ranked[:k])

    def record_latency(self, pid: int, dt: float) -> None:
        prev = self._lat.get(pid, dt)
        self._lat[pid] = 0.8 * prev + 0.2 * dt

    def record_host_latency(self, host: str, dt: float) -> None:
        prev = self._host_lat.get(host, dt)
        self._host_lat[host] = 0.8 * prev + 0.2 * dt

    def read_hosts(self, dp: dict) -> list[str]:
        """Replica order for a read. Follower-read ranks ALL hosts by EWMA
        and picks randomly among the fastest half (KFasterRandom applied to
        replicas, k_faster_random_selector.go:53-58), so a slow or dead
        leader never sets the read latency floor; the rest follow as
        fallbacks. Leader-only mode keeps the wire order (leader first)."""
        hosts = list(dp["hosts"])
        if not self.follower_read or len(hosts) <= 1:
            return hosts
        ranked = sorted(hosts, key=lambda h: self._host_lat.get(h, 0.0))
        k = max(1, len(ranked) // 2)
        first = random.choice(ranked[:k])
        return [first] + [h for h in ranked if h != first]

    def find_dp(self, pid: int) -> dict:
        for p in self.partitions():
            if p["pid"] == pid:
                return p
        self.refresh()
        for p in self.partitions():
            if p["pid"] == pid:
                return p
        raise StreamError(f"unknown partition {pid}")

    def delete_extents(self, keys) -> None:
        """MarkDelete every ExtentKey (dicts or dataclasses); raises on any
        failure so the metanode's purge queue retries the batch."""
        for key in keys:
            get = key.get if isinstance(key, dict) else lambda a, k=key: getattr(k, a)
            pid, eid = get("partition_id"), get("extent_id")
            dp = self.find_dp(pid)
            arg = {"followers": dp["hosts"][1:]}
            off = 0
            if is_tiny_extent(eid):
                arg["size"] = get("size")
                off = get("extent_offset")
            rep = self.request(dp, Packet(
                OP_MARK_DELETE, partition_id=pid, extent_id=eid,
                extent_offset=off, arg=arg), retry_hosts=False)
            if rep.result != RES_OK:
                raise StreamError(f"mark delete {pid}/{eid}: {rep.error()}")

    # -- one-shot requests with leader fallback --------------------------------

    # a raft election (or a restarted replica) makes every host answer
    # not-leader/conn-refused for a moment; ride it out like the meta client
    # does (sdk/data retry discipline)
    RETRY_WINDOW = 10.0
    RETRY_SLEEP = 0.1

    def request(self, dp: dict, pkt: Packet, retry_hosts: bool = True,
                hosts: list[str] | None = None) -> Packet:
        import time as _time

        from chubaofs_tpu_torch.proto.packet import trace_inject, trace_merge

        trace_inject(pkt)  # datanode hops join the caller's trace
        last = None
        if hosts is None:
            hosts = dp["hosts"] if retry_hosts else dp["hosts"][:1]
        deadline = _time.monotonic() + (self.RETRY_WINDOW if retry_hosts else 0)
        while True:
            for addr in hosts:
                sock = self.pool.get(addr)
                t0 = _time.perf_counter()
                try:
                    send_packet(sock, pkt)
                    reply = recv_packet(sock)
                except (OSError, ConnectionError) as e:
                    self.pool.put(addr, sock, ok=False)
                    # a dead replica must sink in the read ranking, not
                    # stay at its last healthy EWMA
                    self.record_host_latency(addr, self.RETRY_WINDOW)
                    last = StreamError(f"{addr}: {e}")
                    continue
                self.pool.put(addr, sock)
                self.record_host_latency(addr, _time.perf_counter() - t0)
                if reply.result == RES_NOT_LEADER:
                    last = StreamError(f"{addr}: not leader")
                    continue
                trace_merge(reply)
                return reply
            if _time.monotonic() >= deadline:
                break
            _time.sleep(self.RETRY_SLEEP)
        raise last or StreamError("no hosts")

    def request_read(self, dp: dict, pkt: Packet) -> Packet:
        """Read with the volume's consistency mode: follower-read fans the
        attempt order across EWMA-ranked replicas (and flags the packet so
        followers serve it); leader-only keeps the plain request path."""
        if not self.follower_read:
            return self.request(dp, pkt)
        pkt.arg["follower_read"] = True
        return self.request(dp, pkt, hosts=self.read_hosts(dp))


class ExtentHandler:
    """One open extent on one partition: pipelined append packets
    (extent_handler.go:49-79)."""

    def __init__(self, client: ExtentClient, dp: dict, file_offset: int):
        self.client = client
        self.dp = dp
        self.leader = dp["hosts"][0]
        self.followers = dp["hosts"][1:]
        self.file_offset = file_offset  # file position where this extent begins
        self.extent_id: int | None = None
        self.size = 0  # bytes sent into the extent
        self.acked = 0  # bytes acked (suffix [acked, size) is in flight)
        self.emitted = 0  # bytes already reported to the metanode as keys
        self.sock: socket.socket | None = None
        self.inflight: deque[int] = deque()  # per-packet payload sizes

    def _conn(self) -> socket.socket:
        if self.sock is None:
            self.sock = self.client.pool.get(self.leader)
        return self.sock

    def open(self) -> None:
        from chubaofs_tpu_torch.proto.packet import trace_inject, trace_merge

        t0 = time.perf_counter()
        req = trace_inject(Packet(OP_CREATE_EXTENT, partition_id=self.dp["pid"],
                                  arg={"followers": self.followers}))
        sock = self._conn()
        send_packet(sock, req)
        rep = recv_packet(sock)
        trace_merge(rep)
        self.client.record_latency(self.dp["pid"], time.perf_counter() - t0)
        if rep.result != RES_OK:
            raise StreamError(f"create extent: {rep.error()}")
        self.extent_id = rep.extent_id

    def write(self, data: bytes) -> None:
        if self.extent_id is None:
            self.open()
        sock = self._conn()
        view = memoryview(data)
        while view:
            chunk = bytes(view[:PACKET_SIZE])
            view = view[len(chunk):]
            pkt = Packet(
                OP_WRITE, partition_id=self.dp["pid"], extent_id=self.extent_id,
                extent_offset=self.size, kernel_offset=self.file_offset + self.size,
                data=chunk, arg={"followers": self.followers},
            )
            send_packet(sock, pkt)
            self.inflight.append(len(chunk))
            self.size += len(chunk)

    def flush(self) -> list[dict]:
        """Drain acks; return ExtentKeys for the newly-acked suffix."""
        if self.extent_id is None:
            return []
        sock = self._conn()
        t0 = time.perf_counter()
        had_inflight = bool(self.inflight)
        while self.inflight:
            rep = recv_packet(sock)
            if rep.result != RES_OK:
                self._drop_conn()
                raise StreamError(f"write ack: {rep.error()}")
            self.acked += self.inflight.popleft()
        if had_inflight:
            self.client.record_latency(self.dp["pid"], time.perf_counter() - t0)
        if self.acked == self.emitted:
            return []
        key = {
            "file_offset": self.file_offset + self.emitted,
            "partition_id": self.dp["pid"],
            "extent_id": self.extent_id,
            "extent_offset": self.emitted,
            "size": self.acked - self.emitted,
        }
        self.emitted = self.acked
        return [key]

    def close(self) -> None:
        if self.sock is not None:
            self.client.pool.put(self.leader, self.sock, ok=not self.inflight)
            self.sock = None

    def _drop_conn(self) -> None:
        if self.sock is not None:
            self.client.pool.put(self.leader, self.sock, ok=False)
            self.sock = None
        self.inflight.clear()


class Streamer:
    """Per-inode write/read pipeline (stream_writer.go Streamer analog)."""

    def __init__(self, client: ExtentClient, meta, ino: int):
        self.client = client
        self.meta = meta  # MetaWrapper
        self.ino = ino
        inode = meta.get_inode(ino)
        self.size = inode.size
        self.handler: ExtentHandler | None = None

    # -- writes ----------------------------------------------------------------

    def sync_committed(self) -> None:
        """Re-anchor on the metanode's committed size; drops a handler whose
        file mapping went stale (truncate from another client/path)."""
        committed = self._committed_size()
        if self.handler is not None and not self.handler.inflight:
            if self.handler.file_offset + self.handler.emitted != committed:
                self.handler.close()
                self.handler = None
        if self.handler is None:
            self.size = committed

    def write(self, offset: int, data: bytes) -> int:
        """Classify overwrite vs append per stream_writer.go:278."""
        if not data:
            return 0
        n = len(data)
        committed = self._committed_size()
        if offset < committed:
            cut = min(offset + n, committed)
            self._overwrite(offset, data[: cut - offset])
            data = data[cut - offset:]
            offset = cut
        if data:
            self._append(offset, data)
        return n

    def _committed_size(self) -> int:
        return self.meta.get_inode(self.ino).size

    def _overwrite(self, offset: int, data: bytes) -> None:
        """Flush dirty appends, then raft random-writes into owning extents
        (the flush-before-overwrite rule, stream_writer.go:299-309).

        Ranges below the committed size that NO extent covers are holes a
        truncate-up left behind: they get fresh extents of their own (keys
        never overlap, so a hole-fill key at its file_offset slots straight
        into the read paste) — silently skipping them would drop the bytes."""
        self.flush()
        inode = self.meta.get_inode(self.ino)
        end = offset + len(data)
        covered: list[tuple[int, int]] = []
        for key in inode.extents:
            lo = max(offset, key.file_offset)
            hi = min(end, key.file_offset + key.size)
            if lo >= hi:
                continue
            covered.append((lo, hi))
            dp = self._dp_of(key.partition_id)
            pkt = Packet(
                OP_RANDOM_WRITE, partition_id=key.partition_id,
                extent_id=key.extent_id,
                extent_offset=key.extent_offset + (lo - key.file_offset),
                kernel_offset=lo, data=data[lo - offset: hi - offset],
            )
            rep = self.client.request(dp, pkt)
            if rep.result != RES_OK:
                raise StreamError(f"random write: {rep.error()}")
        # fill the uncovered holes with fresh extents
        covered.sort()
        pos = offset
        holes: list[tuple[int, int]] = []
        for lo, hi in covered:
            if pos < lo:
                holes.append((pos, lo))
            pos = max(pos, hi)
        if pos < end:
            holes.append((pos, end))
        for lo, hi in holes:
            h = ExtentHandler(self.client, self.client.select(), lo)
            try:
                h.write(data[lo - offset: hi - offset])
                keys = h.flush()
            finally:
                h.close()
            if keys:
                self.meta.append_extents(
                    self.ino, keys, max(inode.size, keys[-1]["file_offset"]
                                        + keys[-1]["size"]))

    def _append(self, offset: int, data: bytes) -> None:
        if offset > self.size:
            # zero-fill the gap so append lands at the watermark
            data = b"\0" * (offset - self.size) + data
            offset = self.size
        if offset != self.size:
            raise StreamError(f"append at {offset}, size {self.size}")
        if self.size == 0 and self.handler is None and len(data) <= TINY_LIMIT:
            self._tiny_write(data)
            self.size += len(data)
            return
        if self.handler is None:
            self.handler = ExtentHandler(self.client, self.client.select(), offset)
        self.handler.write(data)
        self.size += len(data)

    def _tiny_write(self, data: bytes) -> None:
        """Single-packet small write: datanode assigns tiny extent + offset."""
        dp = self.client.select()
        pkt = Packet(OP_WRITE, partition_id=dp["pid"], extent_id=0,
                     kernel_offset=0, data=data,
                     arg={"tiny": True, "followers": dp["hosts"][1:]})
        t0 = time.perf_counter()
        rep = self.client.request(dp, pkt, retry_hosts=False)
        self.client.record_latency(dp["pid"], time.perf_counter() - t0)
        if rep.result != RES_OK:
            raise StreamError(f"tiny write: {rep.error()}")
        self.meta.append_extents(self.ino, [{
            "file_offset": 0, "partition_id": dp["pid"],
            "extent_id": rep.extent_id, "extent_offset": rep.extent_offset,
            "size": len(data),
        }], len(data))

    def flush(self) -> None:
        if self.handler is None:
            return
        keys = self.handler.flush()
        if keys:
            new_size = max(self.size, keys[-1]["file_offset"] + keys[-1]["size"])
            self.meta.append_extents(self.ino, keys, new_size)

    def close(self) -> None:
        self.flush()
        if self.handler is not None:
            self.handler.close()
            self.handler = None

    # -- reads -----------------------------------------------------------------

    def _dp_of(self, pid: int) -> dict:
        return self.client.find_dp(pid)

    def read(self, offset: int, size: int) -> bytes:
        self.flush()
        inode = self.meta.get_inode(self.ino)
        size = max(0, min(size, inode.size - offset))
        if size == 0:
            return b""
        out = bytearray(size)
        for key in inode.extents:  # in-order paste; keys never overlap
            lo = max(offset, key.file_offset)
            hi = min(offset + size, key.file_offset + key.size)
            if lo >= hi:
                continue
            dp = self._dp_of(key.partition_id)
            pkt = Packet(
                OP_STREAM_READ, partition_id=key.partition_id,
                extent_id=key.extent_id,
                extent_offset=key.extent_offset + (lo - key.file_offset),
                arg={"size": hi - lo},
            )
            rep = self.client.request_read(dp, pkt)
            if rep.result != RES_OK:
                raise StreamError(f"read: {rep.error()}")
            out[lo - offset: hi - offset] = rep.data
        return bytes(out)


class HotBackend:
    """FsClient data backend over the extent client (replica tier).

    Mirrors the role sdk/data/blobstore's writer/reader play for cold volumes
    (chubaofs_tpu_torch/deploy.BlobstoreBackend), but records ExtentKeys."""

    def __init__(self, client: ExtentClient, meta):
        self.client = client
        self.meta = meta
        self._streamers: dict[int, Streamer] = {}

    def streamer(self, ino: int) -> Streamer:
        s = self._streamers.get(ino)
        if s is None:
            s = self._streamers[ino] = Streamer(self.client, self.meta, ino)
        return s

    def write(self, ino: int, offset: int, data: bytes) -> None:
        s = self.streamer(ino)
        s.sync_committed()
        s.write(offset, data)
        s.flush()

    def read(self, ino: int, offset: int, size: int) -> bytes:
        return self.streamer(ino).read(offset, size)

    def delete(self, ino: int, extents: list) -> None:
        """MarkDelete every extent the inode owned (freelist drain analog)."""
        self._streamers.pop(ino, None)
        self.client.delete_extents(extents)
