"""The production code modes, their shard rule, layout and stripes.

A frozen copy of the production rows of the mode table of CubeFS
`blobstore/common/codemode/codemode.go` (N data, M global parity, L local
parity, AZ count, put quorum, 2 KiB minimum shard; its test modes left out),
its shard-size rule (ceil(blob / N), at least the minimum), its layout
(codemode.go:119-126: data shards dealt to the AZs in contiguous runs, then
global parities, then local parities) and the access layer's split of an
object into blobs of at most 4 MiB. A configuration names its policy table
by mode name; the object's size picks the mode. Imports numpy and this
folder only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.reference import gf256

MAX_BLOB_SIZE = 4 << 20
MIN_SHARD = 2048


@dataclass(frozen=True)
class Mode:
    name: str
    code: int  # the mode's number in codemode.go, as a Location carries it
    N: int
    M: int
    L: int
    azs: int
    put_quorum: int  # of the global shards: local parities never count

    @property
    def global_count(self) -> int:
        return self.N + self.M

    @property
    def total(self) -> int:
        return self.N + self.M + self.L

    def shards_in_az(self, az: int) -> list[int]:
        """The shard indices one AZ holds: its data shards, its global
        parities, then its local parities."""
        d, p, q = self.N // self.azs, self.M // self.azs, self.L // self.azs
        return ([*range(az * d, (az + 1) * d)]
                + [*range(self.N + az * p, self.N + (az + 1) * p)]
                + [*range(self.global_count + az * q, self.global_count + (az + 1) * q)])

    def shard_size(self, blob_size: int) -> int:
        return max(-(-blob_size // self.N), MIN_SHARD)


MODES = {m.name: m for m in (
    # three AZs
    Mode("EC15P12", 1, 15, 12, 0, 3, 24),
    Mode("EC6P6", 2, 6, 6, 0, 3, 11),
    Mode("EC12P9", 14, 12, 9, 0, 3, 20),
    # two AZs, with local parities
    Mode("EC16P20L2", 3, 16, 20, 2, 2, 34),
    Mode("EC6P10L2", 4, 6, 10, 2, 2, 14),
    # one AZ
    Mode("EC12P4", 9, 12, 4, 0, 1, 15),
    Mode("EC16P4", 10, 16, 4, 0, 1, 19),
    Mode("EC3P3", 11, 3, 3, 0, 1, 5),
    Mode("EC10P4", 12, 10, 4, 0, 1, 13),
    Mode("EC6P3", 13, 6, 3, 0, 1, 8),
)}


def by_code(code: int) -> Mode:
    """The mode a Location names by its number."""
    return next(m for m in MODES.values() if m.code == code)


def pick_mode(policies: list[dict], size: int) -> Mode:
    """The policy band that holds an object of `size` bytes."""
    for p in policies:
        if p.get("min_size", 0) <= size <= p.get("max_size", 1 << 62):
            return MODES[p["mode"]]
    raise ValueError(f"no policy covers size {size}")


def blob_sizes(size: int) -> list[int]:
    return [min(MAX_BLOB_SIZE, size - off) for off in range(0, size, MAX_BLOB_SIZE)]


def stripe_bytes(mode: Mode, size: int) -> int:
    """Shard bytes of an object of `size` bytes, every blob's whole stripe,
    local parities included: what it stores."""
    return sum(mode.total * mode.shard_size(b) for b in blob_sizes(size))


def stripe(mode: Mode, blob: bytes) -> np.ndarray:
    """(total, shard) uint8: the blob's data rows, zero-padded, then its
    global parity rows, then its local parity rows: in each AZ, the Cauchy RS
    parity of that AZ's global shards in index order (CubeFS lrcencoder.go:
    one local RS per AZ)."""
    k = mode.shard_size(len(blob))
    out = np.zeros((mode.total, k), np.uint8)
    out[: mode.N].reshape(-1)[: len(blob)] = np.frombuffer(blob, np.uint8)
    out[mode.N: mode.global_count] = gf256.matmul(gf256.cauchy(mode.N, mode.M),
                                                  out[: mode.N])
    if mode.L:
        local_n, local_m = mode.global_count // mode.azs, mode.L // mode.azs
        for az in range(mode.azs):
            rows = mode.shards_in_az(az)
            out[rows[local_n:]] = gf256.matmul(gf256.cauchy(local_n, local_m),
                                               out[rows[:local_n]])
    return out
