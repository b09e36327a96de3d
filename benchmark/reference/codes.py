"""The code modes the cells use, their shard rule and their stripes.

A frozen copy of the rows the cells use of the mode table of CubeFS
`blobstore/common/codemode/codemode.go` (N data, M parity, AZ count, put
quorum, 2 KiB minimum shard), its shard-size rule (ceil(blob / N), at least the
minimum) and the access layer's split of an object into blobs of at most
4 MiB. A configuration names its policy table by mode name; the object's
size picks the mode. Imports numpy and this folder only.
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
    azs: int
    put_quorum: int

    @property
    def total(self) -> int:
        return self.N + self.M

    def shard_size(self, blob_size: int) -> int:
        return max(-(-blob_size // self.N), MIN_SHARD)


MODES = {m.name: m for m in (
    Mode("EC6P6", 2, 6, 6, 3, 11),
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
    """Shard bytes of an object of `size` bytes, every blob's whole stripe:
    what it stores."""
    return sum(mode.total * mode.shard_size(b) for b in blob_sizes(size))


def stripe(mode: Mode, blob: bytes) -> np.ndarray:
    """(total, shard) uint8: the blob's data rows, zero-padded, then its
    parity rows."""
    k = mode.shard_size(len(blob))
    out = np.zeros((mode.total, k), np.uint8)
    out[: mode.N].reshape(-1)[: len(blob)] = np.frombuffer(blob, np.uint8)
    out[mode.N: mode.N + mode.M] = gf256.matmul(gf256.cauchy(mode.N, mode.M),
                                                out[: mode.N])
    return out
