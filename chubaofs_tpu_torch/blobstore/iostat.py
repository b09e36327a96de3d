"""Shared-memory IO stats (blobstore/common/iostat analog).

Reference counterpart: common/iostat/iostat.go:50,151-168 — blobnode emits
read/write iops + byte + latency counters into mmap'd files under /dev/shm so
node-side viewers can watch disk IO without scraping HTTP. Kept: a fixed
little-endian counter block in a memory-mapped file, writer increments with
atomic-enough single-writer semantics, reader side decodes the same struct.
Layout (8 x u64): rcnt, rbytes, rlat_us, rpending, wcnt, wbytes, wlat_us,
wpending.
"""

from __future__ import annotations

import mmap
import os
import struct

_FIELDS = ("rcnt", "rbytes", "rlat_us", "rpending",
           "wcnt", "wbytes", "wlat_us", "wpending")
_BLOCK = struct.Struct("<8Q")


def _shm_dir() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"


class IOStat:
    """Single-writer counter block; one per (module, disk).

    The same counters also mirror into the `iostat` role registry (gauges
    labeled by block name) so a daemon's /metrics carries them — the shm
    block stays the node-side zero-HTTP view, the registry the scrape view."""

    def __init__(self, name: str, path: str | None = None):
        self.name = name
        self.path = path or os.path.join(_shm_dir(), f"cfs-iostat-{name}")
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            os.ftruncate(fd, _BLOCK.size)
            self._mm = mmap.mmap(fd, _BLOCK.size)
        finally:
            os.close(fd)
        self._vals = dict.fromkeys(_FIELDS, 0)
        from chubaofs_tpu_torch.utils.exporter import registry

        # gauges bound ONCE (labels never change): _flush runs per IO and
        # must not pay a registry-lock lookup per field per operation
        lab = {"name": name}
        self._gauges = [(f, registry("iostat").gauge(f, lab))
                        for f in _FIELDS]

    def _flush(self):
        self._mm[:] = _BLOCK.pack(*(self._vals[f] for f in _FIELDS))
        for f, g in self._gauges:
            g.set(self._vals[f])

    def read_begin(self):
        self._vals["rpending"] += 1
        self._flush()

    def read_done(self, nbytes: int, lat_us: int):
        v = self._vals
        v["rcnt"] += 1
        v["rbytes"] += nbytes
        v["rlat_us"] += lat_us
        v["rpending"] = max(0, v["rpending"] - 1)
        self._flush()

    def write_begin(self):
        self._vals["wpending"] += 1
        self._flush()

    def write_done(self, nbytes: int, lat_us: int):
        v = self._vals
        v["wcnt"] += 1
        v["wbytes"] += nbytes
        v["wlat_us"] += lat_us
        v["wpending"] = max(0, v["wpending"] - 1)
        self._flush()

    def close(self):
        self._mm.close()
        # a closed block's mirror gauges must not render as a live idle
        # node on every later scrape
        from chubaofs_tpu_torch.utils.exporter import registry

        lab = {"name": self.name}
        for f, _ in self._gauges:
            registry("iostat").unregister(f, lab)

    @staticmethod
    def view(path: str) -> dict:
        """Reader side: decode a counter block (the iostat viewer's read)."""
        with open(path, "rb") as f:
            raw = f.read(_BLOCK.size)
        return dict(zip(_FIELDS, _BLOCK.unpack(raw)))
