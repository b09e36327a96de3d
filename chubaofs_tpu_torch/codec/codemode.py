"""EC code modes: declarative N+M+L layouts with AZ-aware stripe geometry.

Equivalent of reference blobstore/common/codemode/codemode.go:26-160. A CodeMode
names a fixed Tactic: N data shards, M global parity, L local (per-AZ) parity,
the AZ count, the put/get quorums, and the minimum shard size used when splitting
small blobs. Stripe-layout helpers (global stripe, per-AZ local stripes, shard->AZ
assignment) mirror the reference's GlobalStripe/GetECLayoutByAZ semantics
(codemode.go:119-126): data shards are dealt to AZs contiguously N/AZCount each,
then parity M/AZCount each, then locals L/AZCount each.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

ALIGN_0B = 0
ALIGN_512B = 512
ALIGN_2KB = 2048


class CodeMode(enum.IntEnum):
    EC15P12 = 1
    EC6P6 = 2
    EC16P20L2 = 3
    EC6P10L2 = 4
    EC6P3L3 = 5
    EC6P6Align0 = 6
    EC6P6Align512 = 7
    EC4P4L2 = 8
    EC12P4 = 9
    EC16P4 = 10
    EC3P3 = 11
    EC10P4 = 12
    EC6P3 = 13
    EC12P9 = 14
    # the hot-tier redundancy engine: a systematic RS(1,2)
    # stripe IS the codec-native 3-replica layout — shard 0 is the blob
    # bytes verbatim (one direct read serves a GET), shards 1-2 are GF
    # scalar images recoverable through the ordinary reconstruct path.
    # Never size-selected: blobs enter only via tier promotion.
    Replica3 = 15
    # repair-traffic regenerating code: product-matrix MSR
    # RG(n=12, k=6, d=10, alpha=5) — single-shard repair downloads
    # d*(shard/alpha) = 2 shard-equivalents instead of RS's 12. Systematic
    # (data shards are raw blob bytes), rate 1/2.
    RG6P6 = 16
    # test-only modes (kept for parity with the reference's table)
    EC6P6L9 = 200
    EC6P8L10 = 201
    # BASELINE.json archive config (EC(20,4)+LRC local parity, 2 AZ) — shared
    # by bench.py and the multichip dryrun so the two can never drift
    EC20P4L2 = 202
    # BASELINE.json unit-bench config (plain RS 4+2, single AZ)
    EC4P2 = 203
    # small regenerating mode for fast tests: RG(n=8, k=4, d=6, alpha=3)
    RG4P4 = 204


@dataclass(frozen=True)
class Tactic:
    """Immutable strategy of one CodeMode (codemode.go:129-160)."""

    N: int
    M: int
    L: int
    az_count: int
    put_quorum: int
    get_quorum: int = 0
    min_shard_size: int = ALIGN_2KB
    # regenerating-code geometry (0/1 = plain RS/LRC): sub_units is the
    # per-shard sub-unit count alpha (a shard is alpha equal slices; the
    # repair beta-payload is ONE slice), helpers is d, the helper count a
    # single-loss repair reads from. Product-matrix MSR fixes alpha = N-1,
    # helpers = 2N-2 (codec/pm.py).
    sub_units: int = 1
    helpers: int = 0

    @property
    def total(self) -> int:
        return self.N + self.M + self.L

    @property
    def read_hedge(self) -> int:
        """How many shard reads a degraded GET keeps in flight at once:
        N would-be-sufficient reads plus speculative extras, so one slow or
        dead blobnode never sets the GET latency floor (the reference hedges
        the same way — getDataShardOnly fans out, reconstruct fallback races
        the stragglers, stream_get.go:427-530). `get_quorum` is the explicit
        per-mode bound; 0 (unset) defaults to N + ceil(M/2), capped at N+M."""
        hedge = self.get_quorum or self.N + (self.M + 1) // 2
        return min(hedge, self.N + self.M)

    @property
    def global_count(self) -> int:
        return self.N + self.M

    @property
    def is_regenerating(self) -> bool:
        """True for product-matrix regenerating modes (beta-fetch repair)."""
        return self.sub_units > 1

    def beta_size(self, shard_size: int) -> int:
        """Bytes ONE helper ships for a single-shard repair: shard/alpha."""
        if shard_size % self.sub_units:
            raise ValueError(
                f"shard size {shard_size} not divisible by "
                f"sub_units={self.sub_units}")
        return shard_size // self.sub_units

    def is_valid(self) -> bool:
        if self.N <= 0 or self.M <= 0 or self.L < 0 or self.az_count <= 0:
            return False
        if self.N % self.az_count or self.M % self.az_count or self.L % self.az_count:
            return False
        if self.is_regenerating:
            # PM-MSR geometry: alpha = N-1, d = 2N-2, a single loss must
            # leave d helpers, and LRC locals don't compose with beta-fetch
            if self.L or self.sub_units != self.N - 1:
                return False
            if self.helpers != 2 * self.N - 2 or self.total - 1 < self.helpers:
                return False
        # quorum bound: (N+M)/AZCount + N <= PutQuorum <= M+N (codemode.go:137-140)
        return self.put_quorum <= self.N + self.M

    def global_stripe(self) -> list[int]:
        """Indexes of the N+M global-stripe shards (data then parity)."""
        return list(range(self.N + self.M))

    def az_of_shard(self, idx: int) -> int:
        """AZ owning shard idx under contiguous N/M/L dealing."""
        if idx < self.N:
            return idx // (self.N // self.az_count)
        if idx < self.N + self.M:
            return (idx - self.N) // (self.M // self.az_count)
        if idx < self.total:
            return (idx - self.N - self.M) // (self.L // self.az_count) if self.L else 0
        raise IndexError(idx)

    def shards_in_az(self, az: int) -> list[int]:
        """All shard indexes (data, global parity, local parity) living in one AZ."""
        if not 0 <= az < self.az_count:
            raise IndexError(az)
        dn, pn = self.N // self.az_count, self.M // self.az_count
        out = list(range(az * dn, (az + 1) * dn))
        out += list(range(self.N + az * pn, self.N + (az + 1) * pn))
        if self.L:
            ln = self.L // self.az_count
            base = self.N + self.M
            out += list(range(base + az * ln, base + (az + 1) * ln))
        return out

    def local_stripes(self) -> list[tuple[list[int], int, int]]:
        """[(shard_indexes, local_n, local_m)] per AZ — the LRC repair stripes.

        Matches the layout comment at codemode.go:119-126: each AZ's local stripe is
        its data + global-parity shards (local_n of them) protected by its local
        parities (local_m). Empty when L == 0.
        """
        if not self.L:
            return []
        local_n = (self.N + self.M) // self.az_count
        local_m = self.L // self.az_count
        return [(self.shards_in_az(az), local_n, local_m) for az in range(self.az_count)]

    def shard_size(self, blob_size: int) -> int:
        """Per-shard byte size when splitting a blob (codemode.go:142-158).

        Regenerating modes round up to a multiple of sub_units so every
        shard slices into alpha equal sub-units (the beta-payload unit).
        """
        if blob_size <= 0:
            raise ValueError(f"blob_size {blob_size}")
        size = -(-blob_size // self.N)  # ceil div
        size = max(size, self.min_shard_size)
        if self.sub_units > 1:
            size = -(-size // self.sub_units) * self.sub_units
        return size

    def helper_set(self, fail: int, alive: list[int]) -> list[int]:
        """The layout-aware helper pick for a single-shard beta-fetch repair:
        which d survivors ship their beta payload for failed shard `fail`.

        Policy: prefer helpers in the failed shard's own AZ (repair traffic
        stays local), then ring-distance-closest AZs, index order within an
        AZ for determinism. Returns [] when the survivors can't cover d —
        the caller then falls back to the full-stripe gather.
        """
        if not self.is_regenerating:
            return []
        cand = [i for i in alive if i != fail and i < self.global_count]
        if len(cand) < self.helpers:
            return []
        az_f = self.az_of_shard(fail)
        ring = self.az_count

        def rank(i: int) -> tuple[int, int]:
            dist = abs(self.az_of_shard(i) - az_f)
            return (min(dist, ring - dist), i)

        return sorted(cand, key=rank)[: self.helpers]


_TACTICS: dict[CodeMode, Tactic] = {
    # three AZ
    CodeMode.EC15P12: Tactic(15, 12, 0, 3, put_quorum=24),
    CodeMode.EC6P6: Tactic(6, 6, 0, 3, put_quorum=11),
    CodeMode.EC12P9: Tactic(12, 9, 0, 3, put_quorum=20),
    # two AZ (LRC)
    CodeMode.EC16P20L2: Tactic(16, 20, 2, 2, put_quorum=34),
    CodeMode.EC6P10L2: Tactic(6, 10, 2, 2, put_quorum=14),
    # single AZ
    CodeMode.EC12P4: Tactic(12, 4, 0, 1, put_quorum=15),
    CodeMode.EC16P4: Tactic(16, 4, 0, 1, put_quorum=19),
    CodeMode.EC3P3: Tactic(3, 3, 0, 1, put_quorum=5),
    CodeMode.EC10P4: Tactic(10, 4, 0, 1, put_quorum=13),
    CodeMode.EC6P3: Tactic(6, 3, 0, 1, put_quorum=8),
    # hot tier: exact-size shards (ALIGN_0B) so replica shard 0 == blob
    CodeMode.Replica3: Tactic(1, 2, 0, 1, put_quorum=2,
                              min_shard_size=ALIGN_0B),
    # regenerating: PM-MSR n=12/k=6/d=10/alpha=5 — repair ships 10 beta
    # payloads (2 shard-equivalents) instead of 12 full shards
    CodeMode.RG6P6: Tactic(6, 6, 0, 1, put_quorum=11,
                           sub_units=5, helpers=10),
    # env/test modes
    CodeMode.EC6P3L3: Tactic(6, 3, 3, 3, put_quorum=9),
    CodeMode.EC6P6Align0: Tactic(6, 6, 0, 3, put_quorum=11, min_shard_size=ALIGN_0B),
    CodeMode.EC6P6Align512: Tactic(6, 6, 0, 3, put_quorum=11, min_shard_size=ALIGN_512B),
    CodeMode.EC4P4L2: Tactic(4, 4, 2, 2, put_quorum=6),
    CodeMode.EC6P6L9: Tactic(6, 6, 9, 3, put_quorum=11),
    CodeMode.EC6P8L10: Tactic(6, 8, 10, 2, put_quorum=13, min_shard_size=ALIGN_0B),
    CodeMode.EC20P4L2: Tactic(20, 4, 2, 2, put_quorum=22),
    CodeMode.EC4P2: Tactic(4, 2, 0, 1, put_quorum=5),
    CodeMode.RG4P4: Tactic(4, 4, 0, 1, put_quorum=7,
                           sub_units=3, helpers=6),
}


def get_tactic(mode: CodeMode | int | str) -> Tactic:
    try:
        if isinstance(mode, str):
            mode = CodeMode[mode]
        return _TACTICS[CodeMode(mode)]
    except (KeyError, ValueError):
        raise ValueError(
            f"unknown code mode {mode!r}; known: {[m.name for m in _TACTICS]}"
        ) from None


def all_modes() -> list[CodeMode]:
    return list(_TACTICS.keys())
