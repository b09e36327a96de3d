"""ExtentStore — the on-disk extent engine backing one data partition.

Reference counterpart: storage/extent_store.go:102-124 (store layout comment
:103-107), Write :327, Read :378, MarkDelete :436, GetAllWatermarks :558,
tiny-extent channels :613-694; storage/extent.go (Extent); punch-hole shims
storage/fallocate_linux.go; block CRC persistence storage/persistence_crc.go.

Layout kept from the reference:
  * normal extents (id >= 65): one append-only file per extent, created on
    demand, deleted whole on MarkDelete;
  * 64 shared *tiny* extents (ids 1..64) for small files: appends are 4KiB
    page aligned, deletes punch holes (fallocate FALLOC_FL_PUNCH_HOLE when the
    filesystem supports it) and always land in a replicated delete journal so
    repair replays them (storage/extent_store.go tinyDelete flow);
  * per-64KiB-block CRC32 sidecar per extent, verified on read, recomputed for
    the blocks a write touches;
  * watermarks = {extent_id: committed size}, the repair currency
    (datanode/data_partition_repair.go:80's diff input).

Not kept: ext4-specific fallocate fast paths become best-effort; file handles
are opened per call (the OS page cache is the pool) rather than the
reference's fd cache.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import struct
import zlib

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.proto.packet import TINY_EXTENT_COUNT, is_tiny_extent
from chubaofs_tpu_torch.utils.locks import SanitizedRLock

BLOCK_SIZE = 64 * 1024  # CRC granularity (storage/extent.go block crc)
PAGE_SIZE = 4096  # tiny-extent append alignment
MIN_NORMAL_EXTENT_ID = TINY_EXTENT_COUNT + 1

_FALLOC_FL_KEEP_SIZE = 0x01
_FALLOC_FL_PUNCH_HOLE = 0x02

_libc = None
if os.name == "posix":
    _name = ctypes.util.find_library("c")
    if _name:
        try:
            _libc = ctypes.CDLL(_name, use_errno=True)
        except OSError:
            _libc = None


def _punch_hole(fd: int, offset: int, size: int) -> bool:
    """Best-effort hole punch; False means the journal is the only record."""
    if _libc is None or not hasattr(_libc, "fallocate"):
        return False
    ret = _libc.fallocate(
        fd, _FALLOC_FL_PUNCH_HOLE | _FALLOC_FL_KEEP_SIZE,
        ctypes.c_longlong(offset), ctypes.c_longlong(size),
    )
    return ret == 0


class StorageError(Exception):
    pass


class ExtentNotFound(StorageError):
    pass


class ExtentExists(StorageError):
    pass


class BrokenExtent(StorageError):
    """CRC mismatch on read — the repair trigger."""


class ExtentStore:
    """One directory of extents + CRC sidecars + delete journal."""

    def __init__(self, root: str):
        self.root = root
        self.ext_dir = os.path.join(root, "extents")
        self.crc_dir = os.path.join(root, "crc")
        os.makedirs(self.ext_dir, exist_ok=True)
        os.makedirs(self.crc_dir, exist_ok=True)
        self._lock = SanitizedRLock(name="extent_store")
        self._deleted: set[int] = set()
        self._tiny_holes: dict[int, list[tuple[int, int]]] = {}
        self._delete_journal = os.path.join(root, "deleted.jsonl")
        self._load_journal()
        # tiny extents always exist (extent_store.go:613 initTinyExtents)
        for tid in range(1, TINY_EXTENT_COUNT + 1):
            p = self._path(tid)
            if not os.path.exists(p):
                open(p, "wb").close()
        self._tiny_rr = 0  # round-robin tiny allocator (availableTinyExtentC)

    # -- paths / journal -------------------------------------------------------

    def _path(self, extent_id: int) -> str:
        return os.path.join(self.ext_dir, str(extent_id))

    def _crc_path(self, extent_id: int) -> str:
        return os.path.join(self.crc_dir, str(extent_id))

    def _load_journal(self):
        if not os.path.exists(self._delete_journal):
            return
        with open(self._delete_journal) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if rec[0] == "extent":
                    self._deleted.add(rec[1])
                elif rec[0] == "tiny":
                    self._tiny_holes.setdefault(rec[1], []).append((rec[2], rec[3]))

    def _journal(self, rec: list) -> None:
        with open(self._delete_journal, "a") as f:
            f.write(json.dumps(rec) + "\n")

    # -- extent lifecycle ------------------------------------------------------

    def create(self, extent_id: int) -> None:
        """OpCreateExtent server side (wrap_prepare.go alloc path)."""
        if is_tiny_extent(extent_id):
            return  # tiny extents pre-exist
        with self._lock:
            p = self._path(extent_id)
            if os.path.exists(p):
                raise ExtentExists(str(extent_id))
            self._deleted.discard(extent_id)
            open(p, "wb").close()

    def has(self, extent_id: int) -> bool:
        return os.path.exists(self._path(extent_id)) and extent_id not in self._deleted

    def size(self, extent_id: int) -> int:
        p = self._path(extent_id)
        if not os.path.exists(p) or extent_id in self._deleted:
            raise ExtentNotFound(str(extent_id))
        return os.path.getsize(p)

    def extent_ids(self) -> list[int]:
        with self._lock:
            out = []
            for name in os.listdir(self.ext_dir):
                eid = int(name)
                if eid in self._deleted:
                    continue
                if is_tiny_extent(eid) and os.path.getsize(self._path(eid)) == 0:
                    continue
                out.append(eid)
            return sorted(out)

    # -- tiny allocation -------------------------------------------------------

    def alloc_tiny(self) -> tuple[int, int]:
        """Pick a tiny extent and its aligned append offset.

        The reference hands tiny extents out through a channel and the datanode
        assigns the store's watermark as the write offset
        (datanode/wrap_prepare.go tiny branch); round-robin keeps the 64 files
        evenly filled."""
        with self._lock:
            self._tiny_rr = self._tiny_rr % TINY_EXTENT_COUNT + 1
            tid = self._tiny_rr
            return tid, self._aligned_size(tid)

    def _aligned_size(self, extent_id: int) -> int:
        size = os.path.getsize(self._path(extent_id))
        return (size + PAGE_SIZE - 1) // PAGE_SIZE * PAGE_SIZE

    # -- IO --------------------------------------------------------------------

    def write(self, extent_id: int, offset: int, data: bytes,
              crc: int | None = None, overwrite: bool = False) -> None:
        """Append (or, for the raft random-write path, overwrite) one span.

        Append-only discipline of extent_store.go:327: a non-overwrite write
        must land at the current watermark (tiny: page-aligned watermark)."""
        chaos.failpoint("extent_store.write")
        if crc is not None and zlib.crc32(data) != crc:
            raise StorageError("payload crc mismatch")
        with self._lock:
            p = self._path(extent_id)
            if not os.path.exists(p) or extent_id in self._deleted:
                raise ExtentNotFound(str(extent_id))
            size = os.path.getsize(p)
            if not overwrite:
                expect = self._aligned_size(extent_id) if is_tiny_extent(extent_id) else size
                if offset != expect:
                    raise StorageError(
                        f"extent {extent_id}: append at {offset}, watermark {expect}")
            elif offset + len(data) > size:
                raise StorageError(f"extent {extent_id}: overwrite past watermark")
            with open(p, "r+b") as f:
                if offset > size:
                    f.truncate(offset)  # aligned gap in a tiny extent
                f.seek(offset)
                f.write(data)
            self._update_block_crcs(extent_id, offset, len(data))

    def read(self, extent_id: int, offset: int, size: int, verify: bool = True) -> bytes:
        chaos.failpoint("extent_store.read")
        with self._lock:
            p = self._path(extent_id)
            if not os.path.exists(p) or extent_id in self._deleted:
                raise ExtentNotFound(str(extent_id))
            if verify:
                self._verify_blocks(extent_id, offset, size)
            with open(p, "rb") as f:
                f.seek(offset)
                # corrupt-past-CRC: the block CRCs verified above read the
                # FILE again, so a flip here models the disk returning bad
                # bytes after a clean verify (the repair plane's blind spot
                # the inspector scrub exists for)
                return chaos.corrupt_bytes("extent_store.read.data",
                                           f.read(size))

    # -- delete ----------------------------------------------------------------

    def mark_delete(self, extent_id: int, offset: int = 0, size: int = 0) -> None:
        """Normal extents: drop whole file. Tiny extents: punch [offset, +size)
        (extent_store.go:436 MarkDelete; punch-hole storage/blobfile semantics
        live in the blobstore twin, chubaofs_tpu_torch/blobstore/blobnode.py)."""
        with self._lock:
            if is_tiny_extent(extent_id):
                if size <= 0:
                    raise StorageError("tiny delete needs a range")
                with open(self._path(extent_id), "r+b") as f:
                    _punch_hole(f.fileno(), offset, size)
                self._tiny_holes.setdefault(extent_id, []).append((offset, size))
                self._journal(["tiny", extent_id, offset, size])
                return
            p = self._path(extent_id)
            if not os.path.exists(p):
                raise ExtentNotFound(str(extent_id))
            self._deleted.add(extent_id)
            self._journal(["extent", extent_id])
            os.unlink(p)
            cp = self._crc_path(extent_id)
            if os.path.exists(cp):
                os.unlink(cp)

    def tiny_holes(self, extent_id: int) -> list[tuple[int, int]]:
        return list(self._tiny_holes.get(extent_id, []))

    def is_deleted(self, extent_id: int) -> bool:
        return extent_id in self._deleted

    # -- CRC blocks ------------------------------------------------------------

    def _update_block_crcs(self, extent_id: int, offset: int, length: int) -> None:
        first = offset // BLOCK_SIZE
        last = (offset + length - 1) // BLOCK_SIZE if length else first
        p, cp = self._path(extent_id), self._crc_path(extent_id)
        if not os.path.exists(cp):
            open(cp, "wb").close()
        with open(p, "rb") as f, open(cp, "r+b") as cf:
            cf.seek(0, os.SEEK_END)
            if cf.tell() < (last + 1) * 4:
                cf.write(b"\0" * ((last + 1) * 4 - cf.tell()))
            for blk in range(first, last + 1):
                f.seek(blk * BLOCK_SIZE)
                payload = f.read(BLOCK_SIZE)
                cf.seek(blk * 4)
                cf.write(struct.pack("<I", zlib.crc32(payload)))

    def _verify_blocks(self, extent_id: int, offset: int, size: int) -> None:
        cp = self._crc_path(extent_id)
        if not os.path.exists(cp) or size <= 0:
            return
        with open(cp, "rb") as cf:
            crcs = cf.read()
        first, last = offset // BLOCK_SIZE, (offset + size - 1) // BLOCK_SIZE
        with open(self._path(extent_id), "rb") as f:
            for blk in range(first, last + 1):
                if (blk + 1) * 4 > len(crcs):
                    continue
                want = struct.unpack_from("<I", crcs, blk * 4)[0]
                f.seek(blk * BLOCK_SIZE)
                got = zlib.crc32(f.read(BLOCK_SIZE))
                if got != want:
                    from chubaofs_tpu_torch.utils.exporter import registry

                    registry("datanode").counter("crc_mismatch_total").add()
                    raise BrokenExtent(f"extent {extent_id} block {blk}")

    def block_crc(self, extent_id: int, block: int) -> int:
        cp = self._crc_path(extent_id)
        if not os.path.exists(cp):
            return 0
        with open(cp, "rb") as cf:
            blob = cf.read()
        if (block + 1) * 4 > len(blob):
            return 0
        return struct.unpack_from("<I", blob, block * 4)[0]

    # -- repair currency -------------------------------------------------------

    def watermarks(self) -> dict[int, int]:
        """{extent_id: size} across live extents (GetAllWatermarks :558)."""
        out = {}
        for eid in self.extent_ids():
            out[eid] = self._aligned_size(eid) if is_tiny_extent(eid) else self.size(eid)
        return out

    def used_bytes(self) -> int:
        return sum(self.watermarks().values())
