"""BlobNode — per-host chunk storage engine.

Reference counterpart: blobstore/blobnode (disks -> chunks -> shards; append-only
chunk datafiles with per-shard headers and crc32block framing,
core/storage/datafile.go:356,416; RocksDB shard metadb; punch-hole GC,
core/blobfile.go:83). Same on-disk contracts — append-only data files,
block-CRC framing, a persistent shard index, hole punching on delete — with
the shard index in the native libcfskv engine (utils/kvstore), exactly the
role RocksDB plays under the reference blobnode.

Layout on disk:
    <root>/superblock.json                 disk identity + chunk registry
    <root>/chunks/<chunk_id>.data          append-only shard records
    <root>/metadb/                         per-disk shard index (libcfskv — the
                                           native KV engine standing in for the
                                           reference's RocksDB metadb,
                                           blobnode/db/metadb.go); keys
                                           s/<chunk_id>/<bid> -> ShardMeta json.
                                           Legacy <chunk_id>.idx JSON-line WALs
                                           migrate into the metadb on open.

Shard record in a chunk datafile:
    [32B header: magic, bid, vuid, payload_len, header_crc]
    [crc32block-framed payload]
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import zlib
from dataclasses import dataclass

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.blobstore.clustermgr import DISK_BROKEN, DISK_NORMAL
from chubaofs_tpu_torch.utils import crc32block
from chubaofs_tpu_torch.utils.locks import SanitizedLock
from chubaofs_tpu_torch.utils.kvstore import open_kv

MAGIC = 0x73686472  # "shdr"
_HEADER = struct.Struct("<IQQQI")  # magic, bid, vuid, payload_len, crc-of-header
HEADER_LEN = _HEADER.size

# shard index states (metadb values)
STATUS_NORMAL = 1
STATUS_MARK_DELETE = 2
STATUS_DELETED = 3


def _punch_hole(fd: int, offset: int, length: int) -> None:
    """Release a byte range back to the filesystem (core/blobfile.go:83 analog).

    FALLOC_FL_PUNCH_HOLE | FALLOC_FL_KEEP_SIZE; best-effort — filesystems
    without hole support just keep the bytes until compaction."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.fallocate(fd, 0x03, ctypes.c_long(offset), ctypes.c_long(length))
    except Exception:
        pass


class BlobNodeError(Exception):
    pass


class NoSuchShard(BlobNodeError):
    pass


class ChunkFull(BlobNodeError):
    pass


def classify_io_error(e: BaseException) -> str:
    """Bucket a shard-IO failure for {reason}-labeled metrics: 'missing'
    (routine absence — the shard was never written or already lost),
    'timeout' (a silent hang that hit a deadline), 'io' (infrastructure:
    sockets, disks, injected faults), or 'error' (everything else — the
    bucket that should be a bug). The split is what makes a wedged node and
    a real defect distinguishable on a dashboard."""
    from concurrent.futures import TimeoutError as _FutTimeout

    from chubaofs_tpu_torch.chaos.failpoints import Dropped, FailpointError

    if isinstance(e, NoSuchShard):
        return "missing"
    if isinstance(e, (TimeoutError, _FutTimeout)):
        return "timeout"
    if isinstance(e, (BlobNodeError, OSError, ConnectionError,
                      FailpointError, Dropped)):
        return "io"
    return "error"


@dataclass
class ShardMeta:
    bid: int
    vuid: int
    offset: int  # offset of the record header in the datafile
    size: int  # payload length (unframed)
    status: int = STATUS_NORMAL


class Chunk:
    """One append-only chunk datafile + its shard index.

    Compaction is generational (core/storage compaction analog): gen G lives
    in `<chunk>.data` (G=0) or `<chunk>.g<G>.data`; a compaction writes gen
    G+1 fully, then commits the gen bump AND every re-offset shard meta in ONE
    atomic metadb batch. A crash before the batch leaves gen G valid (the
    orphan G+1 file is swept on open); after it, gen G+1 is valid and stale
    files are swept on open.
    """

    def __init__(self, path: str, chunk_id: str, max_size: int, metadb):
        self.chunk_id = chunk_id
        self.max_size = max_size
        self._base_path = path
        self._idx_path = path + ".idx"  # legacy json-line WAL (migrated)
        self._db = metadb
        self._lock = SanitizedLock(name="blobnode.chunk")
        self.shards: dict[int, ShardMeta] = {}
        self.gen = int(self._db.get(self._gen_key()) or 0)
        self._data_path = self._gen_path(self.gen)
        self.tombstones: set[int] = set()  # deleted bids (metadb tombstones)
        self._check_committed_gen()
        self._sweep_stale_gens()
        self._load()
        self._f = open(self._data_path, "r+b")
        self._size = os.path.getsize(self._data_path)
        # garbage metric survives restarts: everything in the file that is not
        # a live record is punched/superseded space (compaction trigger)
        live = sum(HEADER_LEN + crc32block.encoded_len(m.size)
                   for m in self.shards.values())
        self.holes = max(0, self._size - live)

    def _check_committed_gen(self):
        """Never sweep while the committed generation's datafile is missing:
        deleting the survivors would turn a recoverable inconsistency into
        silent data loss. (compact() fsyncs the directory before the commit,
        so this only fires on external damage — fail loudly.)"""
        if os.path.exists(self._data_path):
            return
        d = os.path.dirname(self._base_path) or "."
        stem = os.path.basename(self._base_path)
        others = []
        for f in os.listdir(d):
            # same gen-suffix filter as _sweep_stale_gens: 'vuid-2560.data' is
            # NOT a generation of chunk 'vuid-256'
            if not f.startswith(stem) or not f.endswith(".data"):
                continue
            mid = f[len(stem):-len(".data")]
            if (mid == "" or (mid.startswith(".g") and mid[2:].isdigit())) \
                    and os.path.join(d, f) != self._data_path:
                others.append(f)
        if others:
            raise BlobNodeError(
                f"chunk {self.chunk_id}: committed gen {self.gen} datafile "
                f"missing but {others} exist — refusing to sweep")

    def _gen_key(self) -> bytes:
        return f"g/{self.chunk_id}".encode()

    def _gen_path(self, gen: int) -> str:
        return self._base_path + (".data" if gen == 0 else f".g{gen}.data")

    def _sweep_stale_gens(self):
        """Drop datafiles of any generation other than the committed one."""
        d = os.path.dirname(self._base_path) or "."
        stem = os.path.basename(self._base_path)
        for fname in os.listdir(d):
            if not fname.startswith(stem) or not fname.endswith(".data"):
                continue
            full = os.path.join(d, fname)
            if full != self._data_path:
                mid = fname[len(stem):-len(".data")]
                if mid == "" or (mid.startswith(".g") and mid[2:].isdigit()):
                    os.unlink(full)

    def _key(self, bid: int) -> bytes:
        # fixed-width decimal keeps the metadb's byte order == bid order
        return f"s/{self.chunk_id}/{bid:020d}".encode()

    def _load(self):
        if not os.path.exists(self._data_path):
            open(self._data_path, "ab").close()
        if os.path.exists(self._idx_path):  # migrate a legacy index WAL
            with open(self._idx_path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    # DELETED entries become tombstones too: delete intent
                    # must survive the migration or the inspector could
                    # resurrect a partially-deleted blob
                    meta = ShardMeta(**json.loads(line))
                    self._db.put(self._key(meta.bid),
                                 json.dumps(meta.__dict__).encode())
            os.replace(self._idx_path, self._idx_path + ".migrated")
        for _, v in self._db.scan(prefix=f"s/{self.chunk_id}/".encode()):
            meta = ShardMeta(**json.loads(v))
            if meta.status == STATUS_DELETED:
                self.tombstones.add(meta.bid)  # deleted, not lost
            else:
                self.shards[meta.bid] = meta

    def _log_idx(self, meta: ShardMeta):
        # STATUS_DELETED stays in the metadb as a TOMBSTONE: the volume
        # inspector must be able to tell "deleted here" from "lost here", or a
        # partially-applied blob delete would be resurrected as a repair
        self._db.put(self._key(meta.bid), json.dumps(meta.__dict__).encode())

    @property
    def used(self) -> int:
        return self._size

    def put(self, bid: int, vuid: int, payload: bytes) -> ShardMeta:
        framed = crc32block.encode(payload)
        with self._lock:
            if self._size + HEADER_LEN + len(framed) > self.max_size:
                raise ChunkFull(self.chunk_id)
            old = self.shards.get(bid)
            offset = self._size
            head = _HEADER.pack(MAGIC, bid, vuid, len(payload), 0)[:-4]
            self._f.seek(offset)
            self._f.write(head + struct.pack("<I", zlib.crc32(head)) + framed)
            self._f.flush()
            self._size = offset + HEADER_LEN + len(framed)
            meta = ShardMeta(bid=bid, vuid=vuid, offset=offset, size=len(payload))
            self.shards[bid] = meta
            self.tombstones.discard(bid)  # re-put over a tombstone revives it
            self._log_idx(meta)
            if old is not None:
                # re-put (e.g. repeated repair): release the superseded record
                length = HEADER_LEN + crc32block.encoded_len(old.size)
                _punch_hole(self._f.fileno(), old.offset, length)
                self.holes += length
            return meta

    def get(self, bid: int, offset: int = 0, size: int | None = None) -> bytes:
        with self._lock:
            meta = self.shards.get(bid)
            if meta is None or meta.status != STATUS_NORMAL:
                raise NoSuchShard(f"chunk {self.chunk_id} bid {bid}")
            if size is None:
                size = meta.size - offset
            if offset < 0 or size < 0 or offset + size > meta.size:
                raise BlobNodeError(f"range [{offset}, {offset+size}) outside shard of {meta.size}")
            fstart, fend = crc32block.block_range(offset, size)
            self._f.seek(meta.offset + HEADER_LEN + fstart)
            framed_total = crc32block.encoded_len(meta.size)
            framed = self._f.read(min(fend, framed_total) - fstart)
        blocks = crc32block.decode(framed)
        inner = offset - (fstart // (crc32block.BLOCK_SIZE + 4)) * crc32block.BLOCK_SIZE
        return blocks[inner : inner + size]

    def mark_delete(self, bid: int):
        with self._lock:
            meta = self.shards.get(bid)
            if meta is None:
                raise NoSuchShard(f"chunk {self.chunk_id} bid {bid}")
            meta.status = STATUS_MARK_DELETE
            self._log_idx(meta)

    def delete(self, bid: int):
        """Punch-hole delete: release the record's bytes, drop the index entry."""
        with self._lock:
            meta = self.shards.get(bid)
            if meta is None:
                raise NoSuchShard(f"chunk {self.chunk_id} bid {bid}")
            length = HEADER_LEN + crc32block.encoded_len(meta.size)
            _punch_hole(self._f.fileno(), meta.offset, length)
            self.holes += length
            meta.status = STATUS_DELETED
            self._log_idx(meta)
            self.tombstones.add(meta.bid)
            del self.shards[meta.bid]

    def compact(self) -> int:
        """Rewrite the datafile keeping only live records; returns bytes
        reclaimed. Crash-safe via the generational commit described on the
        class docstring."""
        with self._lock:
            new_gen = self.gen + 1
            new_path = self._gen_path(new_gen)
            new_metas: list[ShardMeta] = []
            with open(new_path, "wb") as out:
                for bid, meta in sorted(self.shards.items(),
                                        key=lambda kv: kv[1].offset):
                    length = HEADER_LEN + crc32block.encoded_len(meta.size)
                    self._f.seek(meta.offset)
                    record = self._f.read(length)
                    new_metas.append(ShardMeta(bid=bid, vuid=meta.vuid,
                                               offset=out.tell(),
                                               size=meta.size,
                                               status=meta.status))
                    out.write(record)
                out.flush()
                os.fsync(out.fileno())
            # the new file's DIRECTORY ENTRY must be durable before the gen
            # bump commits, or a crash could leave a committed gen with no file
            dfd = os.open(os.path.dirname(new_path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
            # commit point: gen bump + every re-offset meta, atomically.
            # Tombstones are RETAINED: they are cluster-level delete intent
            # ("deleted here, not lost"), not file-local garbage — purging them
            # would let the inspector resurrect a partially-deleted blob
            puts = [(self._gen_key(), str(new_gen).encode())]
            puts += [(self._key(m.bid), json.dumps(m.__dict__).encode())
                     for m in new_metas]
            self._db.write_batch(puts=puts)
            old_path, old_size = self._data_path, self._size
            self._f.close()
            self.gen = new_gen
            self._data_path = new_path
            self._f = open(new_path, "r+b")
            self._size = os.path.getsize(new_path)
            self.shards = {m.bid: m for m in new_metas}
            self.holes = 0
            if old_path != new_path:
                os.unlink(old_path)
            return old_size - self._size

    def tombstone(self, bid: int):
        """Record delete intent for a bid this chunk never stored (migrations
        carry tombstones with the unit). No-op when the bid is live here."""
        with self._lock:
            if bid in self.shards:
                return  # live here: a real delete must go through delete()
            meta = ShardMeta(bid=bid, vuid=0, offset=0, size=0,
                             status=STATUS_DELETED)
            self._log_idx(meta)
            self.tombstones.add(bid)

    def lose(self, bid: int):
        """Drop a record WITHOUT a tombstone — models media loss (a lost
        sector/file), as opposed to delete(), which records intent. The
        inspector repairs lost shards but finishes deleted ones."""
        with self._lock:
            meta = self.shards.pop(bid, None)
            if meta is None:
                raise NoSuchShard(f"chunk {self.chunk_id} bid {bid}")
            length = HEADER_LEN + crc32block.encoded_len(meta.size)
            _punch_hole(self._f.fileno(), meta.offset, length)
            self.holes += length
            self._db.delete(self._key(bid))

    def list_shards(self) -> list[ShardMeta]:
        with self._lock:
            return sorted(self.shards.values(), key=lambda m: m.bid)

    def destroy(self):
        """Delete the chunk outright: datafile, shard metas, tombstones, gen
        marker. Used when a volume unit is re-homed off this disk."""
        with self._lock:
            self._f.close()
            keys = [k for k, _ in self._db.scan(
                prefix=f"s/{self.chunk_id}/".encode())]
            keys.append(self._gen_key())
            self._db.write_batch(deletes=keys)
            try:
                os.unlink(self._data_path)
            except OSError:
                pass
            self.shards.clear()
            self.tombstones.clear()

    def close(self):
        self._f.close()


class Disk:
    """A directory of chunks with a superblock (core/disk/superblock.go analog)."""

    DEFAULT_CHUNK_SIZE = 1 << 30

    def __init__(self, root: str, disk_id: int, chunk_size: int | None = None):
        self.root = root
        self.disk_id = disk_id
        self.chunk_size = chunk_size or self.DEFAULT_CHUNK_SIZE
        os.makedirs(os.path.join(root, "chunks"), exist_ok=True)
        self._sb_path = os.path.join(root, "superblock.json")
        self.metadb = open_kv(os.path.join(root, "metadb"))
        self._lock = SanitizedLock(name="blobnode.disk")
        self.chunks: dict[str, Chunk] = {}
        self._load()

    def _load(self):
        if os.path.exists(self._sb_path):
            with open(self._sb_path) as f:
                sb = json.load(f)
            self.disk_id = sb["disk_id"]
            self.chunk_size = sb["chunk_size"]
            for cid in sb["chunks"]:
                self.chunks[cid] = Chunk(
                    os.path.join(self.root, "chunks", cid), cid,
                    self.chunk_size, self.metadb
                )
        else:
            self._persist()

    def _persist(self):
        tmp = self._sb_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "disk_id": self.disk_id,
                    "chunk_size": self.chunk_size,
                    "chunks": list(self.chunks),
                },
                f,
            )
        os.replace(tmp, self._sb_path)

    def create_chunk(self, chunk_id: str) -> Chunk:
        with self._lock:
            if chunk_id in self.chunks:
                return self.chunks[chunk_id]
            c = Chunk(os.path.join(self.root, "chunks", chunk_id), chunk_id,
                      self.chunk_size, self.metadb)
            self.chunks[chunk_id] = c
            self._persist()
            return c

    def stats(self) -> dict:
        return {
            "disk_id": self.disk_id,
            "chunks": len(self.chunks),
            "used": sum(c.used for c in self.chunks.values()),
        }

    def close(self):
        for c in self.chunks.values():
            c.close()
        self.metadb.close()


class BlobNode:
    """Shard API over a set of disks (api/blobnode PutShard/GetShard analog).

    vuid (volume-unit id) identifies one stripe position of one volume; the
    clustermgr maps vuid -> (node, disk, chunk).
    """

    def __init__(self, node_id: int, disk_roots: list[str],
                 iostat: bool = False, scrub_rate: float | None = None):
        self.node_id = node_id
        self.disks: dict[int, Disk] = {}
        for i, root in enumerate(disk_roots):
            d = Disk(root, disk_id=node_id * 1000 + i)
            self.disks[d.disk_id] = d
        self._chunk_of_vuid: dict[int, tuple[int, str]] = {}
        self._lock = SanitizedLock(name="blobnode.node")
        # shard-IO observability: per-node TP metrics in the blobnode role
        # registry; optionally the mmap'd iostat block node-side viewers read
        # (common/iostat) — off by default so test fleets don't litter shm
        from chubaofs_tpu_torch.utils.exporter import registry as _registry

        self._reg = _registry("blobnode")
        self._iostat = None
        if iostat:
            from chubaofs_tpu_torch.blobstore.iostat import IOStat

            self._iostat = IOStat(f"blobnode-{node_id}")
        # recover vuid->chunk mapping from chunk names ("vuid-<id>")
        for d in self.disks.values():
            for cid in d.chunks:
                if cid.startswith("vuid-"):
                    self._chunk_of_vuid[int(cid[5:])] = (d.disk_id, cid)
        # -- detection state (datainspect.go + disk-failure reporting) -------
        # scrub: token-bucket byte budget (CFS_SCRUB_RATE bytes/s; 0 =
        # unlimited) + a resumable (vuid, bid) cursor persisted in the first
        # disk's metadb, so a restarted node continues mid-sweep instead of
        # rescanning from shard zero
        if scrub_rate is None:
            scrub_rate = float(os.environ.get("CFS_SCRUB_RATE",
                                              str(64 << 20)))
        self._scrub_bucket = None
        if scrub_rate > 0:
            from chubaofs_tpu_torch.utils.ratelimit import TokenBucket

            self._scrub_bucket = TokenBucket(scrub_rate)
        self._scrub_db = (self.disks[min(self.disks)].metadb
                          if self.disks else None)
        self._scrub_cursor: tuple[int, int] | None = None
        if self._scrub_db is not None:
            raw = self._scrub_db.get(b"scrub/cursor")
            if raw:
                try:
                    v, b = json.loads(raw)
                    self._scrub_cursor = (int(v), int(b))
                except (ValueError, TypeError):
                    # bad JSON raises ValueError, but valid-JSON garbage (a
                    # scalar, an object) fails the unpack with TypeError —
                    # either way: restart the sweep, lose nothing
                    pass
        # consecutive IO errors per disk: the heartbeat's disk-failure signal
        self._io_errors: dict[int, int] = {}
        self._closed = False

    # -- chunk lifecycle (clustermgr drives this) ---------------------------

    def create_vuid(self, vuid: int, disk_id: int | None = None) -> int:
        """Bind a volume unit to a fresh chunk; returns the disk id used."""
        with self._lock:
            if vuid in self._chunk_of_vuid:
                return self._chunk_of_vuid[vuid][0]
            if disk_id is None:
                disk_id = min(
                    self.disks, key=lambda d: self.disks[d].stats()["used"]
                )
            self.disks[disk_id].create_chunk(f"vuid-{vuid}")
            self._chunk_of_vuid[vuid] = (disk_id, f"vuid-{vuid}")
            return disk_id

    def _chunk(self, vuid: int) -> Chunk:
        loc = self._chunk_of_vuid.get(vuid)
        if loc is None:
            raise NoSuchShard(f"vuid {vuid} not on node {self.node_id}")
        disk_id, cid = loc
        return self.disks[disk_id].chunks[cid]

    def _disk_io(self, vuid: int, op):
        """Run one chunk op tracking CONSECUTIVE per-disk OSErrors — the
        disk-failure signal heartbeat() reports to clustermgr. Logical
        faults (NoSuchShard, CRC mismatches) don't count: a dying device
        shows up as the OS refusing IO, not as absent bids."""
        loc = self._chunk_of_vuid.get(vuid)
        before = self._io_errors.get(loc[0], 0) if loc is not None else 0
        try:
            out = op()
        except OSError:
            if loc is not None:
                # under the node lock: concurrent failing reads (access
                # fan-out, repair pool, scrub) must not lose increments of
                # the CONSECUTIVE count heartbeat's broken_after gates on
                with self._lock:
                    self._io_errors[loc[0]] = \
                        self._io_errors.get(loc[0], 0) + 1
                self._reg.counter("disk_io_errors").add()
            raise
        if loc is not None and before:
            with self._lock:
                # a success breaks the consecutive chain — but only reset if
                # the count is still the one we snapshotted: failures that
                # landed WHILE this op was in flight are newer information,
                # and zeroing them would lose increments the except path
                # took the lock to keep
                if self._io_errors.get(loc[0], 0) == before:
                    self._io_errors[loc[0]] = 0
        return out

    # -- shard API ----------------------------------------------------------

    def put_shard(self, vuid: int, bid: int, payload: bytes) -> None:
        import time as _time

        t0 = _time.perf_counter()
        if self._iostat is not None:
            self._iostat.write_begin()
        try:
            with self._reg.tp("shard_put"):
                chaos.failpoint("blobnode.put_shard", node=self.node_id)
                # corrupt-on-write models a bad controller: the framing CRCs
                # the already-flipped bytes, so only a later stripe-level
                # repair catches it
                payload = chaos.corrupt_bytes("blobnode.put_shard.payload",
                                              payload, node=self.node_id)
                self._disk_io(
                    vuid, lambda: self._chunk(vuid).put(bid, vuid, payload))
            self._reg.counter("shard_put_bytes_total").add(len(payload))
        finally:
            if self._iostat is not None:
                self._iostat.write_done(
                    len(payload), int((_time.perf_counter() - t0) * 1e6))

    def get_shard(self, vuid: int, bid: int, offset: int = 0, size: int | None = None) -> bytes:
        import time as _time

        t0 = _time.perf_counter()
        data = b""
        if self._iostat is not None:
            self._iostat.read_begin()
        try:
            with self._reg.tp("shard_get"):
                chaos.failpoint("blobnode.get_shard", node=self.node_id)
                data = self._disk_io(
                    vuid, lambda: self._chunk(vuid).get(bid, offset, size))
            self._reg.counter("shard_get_bytes_total").add(len(data))
            # corrupt-on-read models wire/DMA corruption past the CRC framing
            return chaos.corrupt_bytes("blobnode.get_shard.data", data,
                                       node=self.node_id)
        finally:
            if self._iostat is not None:
                self._iostat.read_done(
                    len(data), int((_time.perf_counter() - t0) * 1e6))

    def get_shard_combined(self, vuid: int, bid: int, coeffs: bytes) -> bytes:
        """Beta-combine helper read for regenerating-code repair: read the
        whole local shard, combine its len(coeffs) equal sub-units with the
        failed shard's GF(2^8) coefficients (codec/pm.py helper math), and
        return the single shard/len(coeffs)-byte payload. The disk still
        reads the full shard (iostat shows that truth); what shrinks is the
        bytes shipped to the repair worker — the cross-node cost repair
        bandwidth actually pays.
        """
        import time as _time

        import numpy as np

        from chubaofs_tpu_torch.ops import gf256

        t0 = _time.perf_counter()
        data = b""
        if self._iostat is not None:
            self._iostat.read_begin()
        try:
            with self._reg.tp("shard_get"):
                # same failpoint as get_shard: wire-delay/error chaos regimes
                # apply to beta reads and full reads alike
                chaos.failpoint("blobnode.get_shard", node=self.node_id)
                data = self._disk_io(
                    vuid, lambda: self._chunk(vuid).get(bid, 0, None))
            buf = np.frombuffer(data, np.uint8)
            if not coeffs or buf.size % len(coeffs):
                raise BlobNodeError(
                    f"shard {len(data)}B not divisible into "
                    f"{len(coeffs)} sub-units")
            phi = np.frombuffer(coeffs, np.uint8)[None, :]
            out = gf256.gf_matmul(phi, buf.reshape(len(coeffs), -1)).tobytes()
            # count the SHIPPED bytes, like get_shard does — the beta win
            # must be visible in the node's own byte counters
            self._reg.counter("shard_get_bytes_total").add(len(out))
            self._reg.counter("shard_combine_bytes_total").add(len(out))
            return chaos.corrupt_bytes("blobnode.get_shard.data", out,
                                       node=self.node_id)
        finally:
            if self._iostat is not None:
                # the disk truly read the whole shard; iostat records that
                self._iostat.read_done(
                    len(data), int((_time.perf_counter() - t0) * 1e6))

    def mark_delete_shard(self, vuid: int, bid: int) -> None:
        self._chunk(vuid).mark_delete(bid)

    def delete_shard(self, vuid: int, bid: int) -> None:
        self._chunk(vuid).delete(bid)

    def list_shards(self, vuid: int) -> list[ShardMeta]:
        return self._chunk(vuid).list_shards()

    def lose_shard(self, vuid: int, bid: int) -> None:
        """Simulate media loss of one shard (no delete tombstone)."""
        self._chunk(vuid).lose(bid)

    def tombstone_shard(self, vuid: int, bid: int) -> None:
        """Record delete intent for a bid this chunk never stored — migrations
        carry tombstones WITH the unit, or a partially-deleted blob would be
        resurrected once the only tombstone-holding chunk moves."""
        self._chunk(vuid).tombstone(bid)

    def tombstones_of(self, vuid: int) -> set[int]:
        """All tombstoned bids of one unit (migrations enumerate these)."""
        return set(self._chunk(vuid).tombstones)

    def drop_vuid(self, vuid: int) -> None:
        """Release a re-homed volume unit's chunk: the space a balance/migrate
        moved away must actually free on the source disk. Idempotent."""
        with self._lock:
            loc = self._chunk_of_vuid.pop(vuid, None)
        if loc is None:
            return
        disk_id, cid = loc
        disk = self.disks[disk_id]
        with disk._lock:
            chunk = disk.chunks.pop(cid, None)
        if chunk is not None:
            chunk.destroy()
            disk._persist()

    def has_tombstone(self, vuid: int, bid: int) -> bool:
        """True when this bid was DELETED here (vs never written / lost)."""
        try:
            return bid in self._chunk(vuid).tombstones
        except NoSuchShard:
            return False

    def stats(self) -> dict:
        return {
            "node_id": self.node_id,
            "disks": [d.stats() for d in self.disks.values()],
        }

    # -- background hygiene (core compaction + datainspect.go analogs) -------

    def compact_once(self, min_hole_ratio: float = 0.25,
                     min_holes: int = 1 << 20) -> int:
        """Compact every chunk whose punched-hole share crosses the threshold;
        returns total bytes reclaimed."""
        reclaimed = 0
        for disk in self.disks.values():
            for chunk in list(disk.chunks.values()):
                if chunk.used and chunk.holes >= min_holes and \
                        chunk.holes / chunk.used >= min_hole_ratio:
                    reclaimed += chunk.compact()
        return reclaimed

    def inspect_once(self) -> list[tuple[int, int]]:
        """CRC scrub (blobnode/datainspect.go): re-read every live shard
        through the crc32block framing; returns [(vuid, bid)] that fail.
        The one-shot full sweep; the production loop is scrub_once()."""
        bad: list[tuple[int, int]] = []
        for vuid, (disk_id, cid) in list(self._chunk_of_vuid.items()):
            chunk = self.disks[disk_id].chunks.get(cid)
            if chunk is None:
                continue
            for meta in chunk.list_shards():
                if meta.status != STATUS_NORMAL:
                    continue
                try:
                    chunk.get(meta.bid)
                except Exception:
                    bad.append((vuid, meta.bid))
        return bad

    def _scrub_positions(self, cur: tuple[int, int] | None):
        """Live shard positions strictly AFTER the cursor, chunk by chunk
        in (vuid, bid) order — the batched-per-chunk iteration scrub_once
        resumes through."""
        for vuid in sorted(self._chunk_of_vuid):
            if cur is not None and vuid < cur[0]:
                continue
            loc = self._chunk_of_vuid.get(vuid)
            if loc is None:
                continue
            chunk = self.disks[loc[0]].chunks.get(loc[1])
            if chunk is None:
                continue
            for meta in chunk.list_shards():
                if cur is not None and vuid == cur[0] and meta.bid <= cur[1]:
                    continue
                if meta.status == STATUS_NORMAL:
                    yield vuid, meta.bid, chunk, meta

    def _save_scrub_cursor(self) -> None:
        if self._scrub_db is None:
            return
        try:
            if self._scrub_cursor is None:
                self._scrub_db.delete(b"scrub/cursor")
            else:
                self._scrub_db.put(b"scrub/cursor",
                                   json.dumps(list(self._scrub_cursor)).encode())
        except Exception:
            pass  # a cursor that fails to persist restarts the sweep, no worse

    def scrub_once(self, max_shards: int = 256) -> dict:
        """One budgeted tick of the background CRC scrub loop: re-read up to
        max_shards live shards through their crc32block framing, resuming
        from the persisted cursor, spending at most the CFS_SCRUB_RATE
        token-bucket byte budget. Returns {"scanned", "bad": [(vuid, bid)],
        "complete"} — complete=True means the sweep wrapped (the cursor
        reset) and everything currently live was verified this cycle."""
        scanned = 0
        bad: list[tuple[int, int]] = []
        complete = False
        exhausted = True  # ran off the end of the shard list (vs budget)
        for vuid, bid, chunk, meta in self._scrub_positions(self._scrub_cursor):
            if scanned >= max_shards:
                exhausted = False
                break
            cost = HEADER_LEN + crc32block.encoded_len(meta.size)
            if self._scrub_bucket is not None and not \
                    self._scrub_bucket.try_acquire(
                        min(cost, self._scrub_bucket.burst)):
                exhausted = False  # byte budget dry: resume here next tick
                break
            try:
                self._disk_io(vuid, lambda: chunk.get(bid))
            except OSError:
                # the OS refusing IO is a DISK failure (heartbeat's
                # consecutive-error signal, counted by _disk_io), not
                # bitrot — repairing shard-by-shard off a dying device
                # would fight the disk-repair migration
                pass
            except Exception:
                bad.append((vuid, bid))
            scanned += 1
            self._scrub_cursor = (vuid, bid)
        if exhausted:
            # wrapped: a full pass over every live shard finished
            if self._scrub_cursor is not None:
                self._reg.counter("scrub_sweeps").add()
            complete = True
            self._scrub_cursor = None
        self._save_scrub_cursor()
        if scanned:
            self._reg.counter("scrub_scanned_shards").add(scanned)
        if bad:
            self._reg.counter("scrub_bad_shards").add(len(bad))
            # a finding is a TRANSITION (healthy bytes -> detected bitrot):
            # one timeline record per tick, the shard ids in the detail —
            # never a metric label (obslint rule 1)
            from chubaofs_tpu_torch.utils import events

            events.emit("scrub_finding", events.SEV_WARNING,
                        entity=f"node{self.node_id}",
                        detail={"node_id": self.node_id,
                                "bad": [[v, b] for v, b in bad],
                                "scanned": scanned})
        return {"scanned": scanned, "bad": bad, "complete": complete}

    def heartbeat(self, cm, broken_after: int = 3) -> None:
        """Report per-disk liveness + chunk counts to clustermgr, flagging
        any disk whose consecutive IO-error count crossed broken_after as
        BROKEN (the disk-failure half of detection; heartbeats going SILENT
        — a dead process — is caught by the clustermgr-side expiry)."""
        if self._closed:
            # a dead engine must go SILENT: heartbeat itself touches no disk
            # IO, so without this gate a crashed-but-still-routed node (the
            # chaos crash plan closes the engine in place) would keep
            # beating and the expiry path could never detect it
            return
        for disk_id, disk in self.disks.items():
            if self._io_errors.get(disk_id, 0) >= broken_after:
                try:
                    # only flip a NORMAL disk: re-reporting a DROPPED disk
                    # (repair done, error count never reset) as broken would
                    # mint an endless broken->repair->dropped->broken cycle
                    if cm.disk_status(disk_id) == DISK_NORMAL:
                        cm.set_disk_status(disk_id, DISK_BROKEN,
                                           reason="io_errors")
                except Exception:
                    pass  # control plane unreachable: retried next beat
                continue  # a broken disk stops heartbeating as healthy
            try:
                # no chunk_count: clustermgr's unit accounting is
                # authoritative (physical chunks lag volume creation)
                cm.heartbeat_disk(disk_id)
            except Exception:
                pass

    def close(self):
        self._closed = True
        for d in self.disks.values():
            d.close()
        if self._iostat is not None:
            self._iostat.close()
