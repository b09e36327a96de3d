"""Tiered buffer pools (blobstore/common/resourcepool analog).

Reference counterpart: common/resourcepool — sized-class []byte pools behind
ec.Buffer allocation (common/ec/buf.go) with a process memory cap; misses fall
through to plain allocation. Kept: power-of-two-ish size classes, per-class
free lists, a capacity limit that makes Alloc fail loudly when the cap would
be exceeded (the reference returns ErrPoolLimit), and zero-fill on reuse for
the EC write path (parity buffers must start clean).
"""

from __future__ import annotations

import threading

DEFAULT_CLASSES = (1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24)


class PoolLimitError(MemoryError):
    pass


class MemPool:
    def __init__(self, classes=DEFAULT_CLASSES, capacity_bytes: int = 1 << 30):
        self.classes = tuple(sorted(classes))
        self.capacity = capacity_bytes
        self.in_use = 0
        self._free: dict[int, list[bytearray]] = {c: [] for c in self.classes}
        self._lock = threading.Lock()

    def _class_of(self, size: int) -> int:
        for c in self.classes:
            if size <= c:
                return c
        return size  # oversized: exact allocation, still capacity-accounted

    def alloc(self, size: int, zero: bool = True) -> bytearray:
        c = self._class_of(size)
        with self._lock:
            if self.in_use + c > self.capacity:
                raise PoolLimitError(f"pool capacity {self.capacity} exceeded")
            self.in_use += c
            bucket = self._free.get(c)
            buf = bucket.pop() if bucket else None
        if buf is None:
            return bytearray(c)
        if zero:
            buf[:] = bytes(c)
        return buf

    def put(self, buf: bytearray):
        c = len(buf)
        with self._lock:
            self.in_use = max(0, self.in_use - c)
            if c in self._free:
                self._free[c].append(buf)

    def stats(self) -> dict:
        with self._lock:
            return {"in_use": self.in_use, "capacity": self.capacity,
                    "free": {c: len(v) for c, v in self._free.items()}}
