"""Sectioned, CRC-framed state snapshots — the pickle-snapshot replacement.

Reference counterpart: metanode/partition_store.go:57-1033 — snapshots are
per-type files (inode/dentry/extend/multipart/txn), each carrying its own
CRC32, loaded type-by-type on recovery; clustermgr streams RocksDB checkpoint
files the same way. Here a snapshot is one byte stream of framed sections:

    magic "CFSS1\\n"
    repeat:  [u16 name_len][name utf8][u32 crc32(payload)][u64 payload_len][payload]

Payloads are raft.codec values (safe tagged binary — no pickle anywhere on
the raft path). Large collections are emitted as REPEATED sections of bounded
batch size, and `read_sections` yields them lazily from the buffer, so restore
applies a 100k-inode namespace batch-by-batch instead of materializing a
second full-size decoded image. CRC mismatches raise SnapshotError — a
corrupt section never half-applies silently.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator

from chubaofs_tpu_torch.raft import codec

MAGIC = b"CFSS1\n"
_HDR = struct.Struct("<HIQ")  # name_len, crc32, payload_len

BATCH = 1024  # items per repeated section


class SnapshotError(ValueError):
    pass


class SnapshotWriter:
    def __init__(self):
        self._parts: list[bytes] = [MAGIC]

    def add(self, name: str, value) -> None:
        """Append one section holding a codec-encoded value."""
        raw_name = name.encode("utf-8")
        payload = codec.dumps(value)
        self._parts.append(
            _HDR.pack(len(raw_name), zlib.crc32(payload) & 0xFFFFFFFF, len(payload)))
        self._parts.append(raw_name)
        self._parts.append(payload)

    def add_batched(self, name: str, items, batch: int = BATCH) -> None:
        """Emit a list/iterable as repeated bounded-size sections."""
        buf = []
        for item in items:
            buf.append(item)
            if len(buf) >= batch:
                self.add(name, buf)
                buf = []
        if buf:
            self.add(name, buf)

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


def read_sections(payload: bytes) -> Iterator[tuple[str, object]]:
    """Yield (name, decoded value) per section, verifying CRCs lazily."""
    view = memoryview(payload)
    if bytes(view[: len(MAGIC)]) != MAGIC:
        raise SnapshotError("bad snapshot magic")
    pos = len(MAGIC)
    total = len(payload)
    while pos < total:
        if pos + _HDR.size > total:
            raise SnapshotError("truncated section header")
        name_len, crc, plen = _HDR.unpack_from(view, pos)
        pos += _HDR.size
        if pos + name_len + plen > total:
            raise SnapshotError("truncated section body")
        name = bytes(view[pos : pos + name_len]).decode("utf-8")
        pos += name_len
        body = bytes(view[pos : pos + plen])
        pos += plen
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise SnapshotError(f"section {name!r} CRC mismatch")
        try:
            yield name, codec.loads(body)
        except codec.CodecError as e:
            raise SnapshotError(f"section {name!r}: {e}") from None


def restore_sections(payload: bytes, handlers: dict) -> None:
    """Dispatch each section to handlers[name]; unknown names error out
    (an unknown section means a version/trust mismatch, not data to skip)."""
    for name, value in read_sections(payload):
        h = handlers.get(name)
        if h is None:
            raise SnapshotError(f"unknown snapshot section {name!r}")
        h(value)
