"""BlobCache — the blobstore read-cache plane.

Reference counterpart: blockcache/ + preload/ (PAPER.md layer map) — the
reference puts a node-local cache daemon and a preload pipeline in front of
the erasure-coded cold path because million-user GET traffic is zipfian: a
small hot head absorbs most reads, and serving it from an EC shard gather +
device decode per read is the online-EC read penalty arxiv 1709.05365
measures. Here the cache is in-process with the access gateway (the SDK and
S3 objectnode both read through `Access`, so one cache covers both GET
surfaces) and rides the grown `blockcache.BcacheManager`: TinyLFU admission
(counting sketch + ghost list) in front of a two-tier (memory overlay +
disk file) LRU with separate byte budgets.

Block granularity: entries are keyed
`(vid, bid, version, block_no)` with CFS_CACHE_BLOCK-sized blocks (default
256 KiB), so a ranged GET fills and hits ONLY the blocks its byte window
touches — a 4 KiB read of a 4 MiB blob caches one block, not the blob.
`get()` assembles its answer from the covering blocks and is a hit only
when every one is present; `fill()` accepts a (data, offset, total) window
and stores the fully-covered blocks (plus the tail block once `total`
proves it complete). The access layer rounds its backend fetch window out
to block boundaries, so fills always arrive block-aligned.

Correctness contract — versioning is unchanged from the blob-keyed plane:

  * blobs are immutable per bid on the write path (an overwrite allocates
    fresh bids), so a hit can only go stale through DELETE punch-out or a
    tier rewrite — both call `invalidate(vid, bid)`, which evicts every
    filled block AND bumps the blob's version;
  * `fill()` captures the version BEFORE the backend read and commits only
    if it still matches — a fill racing an invalidation lands under a dead
    version (unreachable) instead of resurrecting punched bytes;
  * blocks are only reachable while tracked: the fill ledger that
    invalidate punches from is pruned by EVICTING the blocks it forgets,
    so a version-map prune can never resurrect bytes;
  * the `cache.invalidate` failpoint sits in front of the punch-out so
    chaos runs can delay it and prove read-after-overwrite/-delete stays
    byte-correct (tests/test_cache_plane.py, chaos/soak.run_cache_soak).

Heat accounting for tier promotion also lives here: every lookup feeds a
bounded per-(vid, bid) counter, and `promote_signal()` fires once per blob
per aging epoch when CFS_PROMOTE_HITS accesses accumulate — the access
layer forwards the signal to the proxy's hot-blob topic, where the
scheduler turns it into a lease-driven promote task.

Knobs: CFS_CACHE_MB (memory-tier budget; 0/unset = cache plane off),
CFS_CACHE_DISK_MB (disk-tier budget, default 4x memory),
CFS_CACHE_BLOCK (cache block bytes, default 256 KiB),
CFS_CACHE_ADMIT ("tinylfu" | "always"), CFS_PROMOTE_HITS (promotion
threshold, 0 = never signal).
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.blockcache.bcache import BcacheManager
from chubaofs_tpu_torch.utils.exporter import declare_label_values, registry
from chubaofs_tpu_torch.utils.locks import SanitizedLock

# version-map bound: past _VER_MAX entries the prune pops oldest-first,
# but never an entry younger than the minimum-age floor — comfortably
# above any backend read's lifetime (write_deadline is 10s), so the
# fill-race window the version map exists to close stays closed. The map
# is then bounded by _VER_MIN_AGE_S worth of delete churn.
_VER_MAX = 65536
_VER_MIN_AGE_S = 30.0

# heat table bound: zipfian traffic concentrates heat, so a few thousand
# slots hold every plausible promotion candidate; on overflow the coldest
# half of the table is dropped (never the hot head)
_HEAT_MAX = 4096

DEFAULT_BLOCK = 256 * 1024


class BlobCache:
    """In-process read cache for blobstore blobs, keyed
    (vid, bid, version, block_no)."""

    def __init__(self, cache_dir: str, mem_mb: int | None = None,
                 disk_mb: int | None = None, admit: str | None = None,
                 promote_hits: int | None = None,
                 block_bytes: int | None = None):
        if mem_mb is None:
            mem_mb = int(os.environ.get("CFS_CACHE_MB", "") or 64)
        if disk_mb is None:
            disk_mb = int(os.environ.get("CFS_CACHE_DISK_MB", "") or 0)
            if disk_mb <= 0:
                disk_mb = 4 * mem_mb
        if admit is None:
            admit = os.environ.get("CFS_CACHE_ADMIT", "tinylfu")
        if promote_hits is None:
            promote_hits = int(os.environ.get("CFS_PROMOTE_HITS", "32") or 32)
        if block_bytes is None:
            block_bytes = int(os.environ.get("CFS_CACHE_BLOCK", "")
                              or DEFAULT_BLOCK)
        # 4 KiB floor: a pathological env value must not mint a key per byte
        self.block = max(4096, int(block_bytes))
        self.promote_hits = promote_hits
        self.mgr = BcacheManager(cache_dir, capacity_bytes=disk_mb << 20,
                                 mem_capacity_bytes=mem_mb << 20,
                                 admit=admit)
        self._lock = SanitizedLock(name="cache.ver")
        # (vid, bid) -> (version, monotonic stamp of the bump), kept in
        # bump order (move_to_end on re-bump) so pruning pops oldest-first
        # without ever sorting under the lock every GET also takes
        self._ver: OrderedDict[tuple[int, int], tuple[int, float]] = \
            OrderedDict()
        # (vid, bid) -> blob size, learned on fill — what lets a
        # size=None lookup know which blocks a whole-blob read covers
        self._total: OrderedDict[tuple[int, int], int] = OrderedDict()
        # (vid, bid, ver) -> filled block numbers: the punch-out ledger.
        # invalidate() evicts exactly these; pruning EVICTS what it forgets
        # so an untracked block is never a reachable one.
        self._blocks: OrderedDict[tuple[int, int, int], set[int]] = \
            OrderedDict()
        # (vid, bid) -> access count since the last signal/aging/invalidate
        self._heat: dict[tuple[int, int], int] = {}
        self._heat_total = 0
        self._reg = registry("cache")
        declare_label_values("tier", ("mem", "disk"))

    @classmethod
    def from_env(cls, cache_dir: str) -> "BlobCache | None":
        """The deployment wiring: a cache only when CFS_CACHE_MB is set to a
        positive budget — unset keeps every existing path byte-identical."""
        try:
            mem_mb = int(os.environ.get("CFS_CACHE_MB", "0") or 0)
        except ValueError:
            mem_mb = 0
        if mem_mb <= 0:
            return None
        return cls(cache_dir, mem_mb=mem_mb)

    # -- keying ----------------------------------------------------------------

    def _version(self, vid: int, bid: int) -> int:
        ver = self._ver.get((vid, bid))
        return 0 if ver is None else ver[0]

    @staticmethod
    def _key(vid: int, bid: int, ver: int, blk: int) -> str:
        return f"b_{vid}_{bid}_{ver}_{blk}"

    # -- read path -------------------------------------------------------------

    def get(self, vid: int, bid: int, offset: int = 0,
            size: int | None = None) -> bytes | None:
        """Ranged lookup assembled from the covering blocks — a hit ONLY
        when every block the window touches is present (a torn answer is a
        miss, never a short read). One plane-level hit/miss per lookup;
        every call (hit or miss) is a heat sample."""
        self._reg.counter("lookups").add()
        with self._lock:
            ver = self._version(vid, bid)
            self._note_heat_locked(vid, bid)
            total = self._total.get((vid, bid))
        if size is None:
            if total is None:  # blob size never learned: can't enumerate
                self._reg.counter("misses").add()
                return None
            size = max(0, total - offset)
        B = self.block
        out = bytearray()
        for blk in range(offset // B, (offset + size - 1) // B + 1):
            lo = max(offset, blk * B) - blk * B
            hi = min(offset + size, (blk + 1) * B) - blk * B
            piece = self.mgr.get(self._key(vid, bid, ver, blk), lo, hi - lo)
            if piece is None or len(piece) != hi - lo:
                self._reg.counter("misses").add()
                return None
            out += piece
        self._reg.counter("hits").add()
        return bytes(out)

    def fill_version(self, vid: int, bid: int) -> int:
        """Capture the blob's version BEFORE reading the backend; pass it to
        fill() so a fill whose backend read straddled an invalidation can
        never land reachable bytes."""
        with self._lock:
            return self._version(vid, bid)

    def fill(self, vid: int, bid: int, ver: int, data: bytes,
             offset: int = 0, total: int | None = None) -> bool:
        """Store the blocks `data` (a window at `offset` of a `total`-byte
        blob) fully covers; the tail block is storable short once `total`
        proves it complete. A whole-blob fill (offset 0, no total) infers
        total=len(data). Returns True when every covered block landed."""
        if total is None and offset == 0:
            total = len(data)
        with self._lock:
            if ver != self._version(vid, bid):
                self._reg.counter("stale_fills").add()
                return False
        B = self.block
        end = offset + len(data)
        written: list[int] = []
        ok = True
        stored_any = False
        first_blk = (offset + B - 1) // B  # partial leading block: skipped
        for blk in range(first_blk, (end + B - 1) // B):
            b_lo = blk * B
            b_hi = min(b_lo + B, total) if total is not None else b_lo + B
            if b_hi <= b_lo or b_hi > end:
                continue  # block not fully covered by this window
            if self.mgr.put(self._key(vid, bid, ver, blk),
                            data[b_lo - offset: b_hi - offset]):
                written.append(blk)
                stored_any = True
            else:
                ok = False  # admission rejected this block
        # re-check AFTER the store writes: an invalidate that raced the puts
        # may have punched before the bytes landed — its version bump
        # happens-before its evict, so a still-matching version here proves
        # the blocks were not punched behind us, and a mismatch means we
        # must take our own bytes back out
        with self._lock:
            landed_stale = ver != self._version(vid, bid)
            if not landed_stale and written:
                blks = self._blocks.setdefault((vid, bid, ver), set())
                blks.update(written)
                self._blocks.move_to_end((vid, bid, ver))
                if total is not None:
                    self._total[(vid, bid)] = total
                    self._total.move_to_end((vid, bid))
                evictions = self._prune_ledgers_locked()
            else:
                evictions = []
        if landed_stale:
            for blk in written:
                self.mgr.evict(self._key(vid, bid, ver, blk))
            self._reg.counter("stale_fills").add()
            return False
        for key in evictions:  # ledger overflow: punch what it forgot
            self.mgr.evict(key)
        if not stored_any:
            self._reg.counter("fill_rejects").add()
            return False
        self._reg.counter("fills" if ok else "fill_rejects").add()
        return ok

    def _prune_ledgers_locked(self) -> list[str]:
        """Bound the fill/total ledgers; returns store keys the caller must
        evict (outside the lock) for ledger entries being forgotten — an
        untracked-but-reachable block would survive its invalidate."""
        evictions: list[str] = []
        while len(self._blocks) > _VER_MAX:
            (vid, bid, ver), blks = self._blocks.popitem(last=False)
            evictions.extend(self._key(vid, bid, ver, b) for b in blks)
        while len(self._total) > _VER_MAX:
            self._total.popitem(last=False)  # size=None lookups degrade
        return evictions

    # -- invalidation (write-through punch-out) --------------------------------

    def invalidate(self, vid: int, bid: int) -> None:
        """Punch the blob out: evict every filled block and bump its
        version. Callers invalidate BEFORE queueing the backend
        delete/punch, so by the time shards disappear no cached copy is
        reachable — the failpoint lets chaos stretch that window and prove
        the ordering carries it."""
        chaos.failpoint("cache.invalidate")
        with self._lock:
            cur, _ = self._ver.get((vid, bid), (0, 0.0))
            self._ver[(vid, bid)] = (cur + 1, time.monotonic())
            self._ver.move_to_end((vid, bid))
            self._heat.pop((vid, bid), None)
            self._total.pop((vid, bid), None)
            blks = self._blocks.pop((vid, bid, cur), set())
            self._prune_vers_locked()
        for blk in blks:
            self.mgr.evict(self._key(vid, bid, cur, blk))
        self._reg.counter("invalidations").add()

    def _prune_vers_locked(self) -> None:
        """Bound the version map: entries whose bump is older than the
        minimum-age floor can go — any fill that captured the pre-bump
        version has long since landed (unreachable, or self-evicted by the
        post-put re-check) or died, and the blocks were evicted at bump
        time, so forgetting the version cannot resurrect anything."""
        if len(self._ver) <= _VER_MAX:
            return
        # the map is in bump order, so the oldest entries sit at the front:
        # pop from there down to the cap, stopping at the minimum-age floor
        # (see _VER_MIN_AGE_S) — O(evicted), no scan or sort under the lock
        # every GET's version read also takes. In a storm where even the
        # front is younger than the floor the map temporarily exceeds the
        # cap, bounded by _VER_MIN_AGE_S worth of delete churn.
        floor = time.monotonic() - _VER_MIN_AGE_S
        while len(self._ver) > _VER_MAX:
            key, (_, ts) = next(iter(self._ver.items()))
            if ts > floor:
                break
            del self._ver[key]

    # -- heat / promotion signals ----------------------------------------------

    def _note_heat_locked(self, vid: int, bid: int) -> None:
        key = (vid, bid)
        self._heat[key] = self._heat.get(key, 0) + 1
        self._heat_total += 1
        if len(self._heat) > _HEAT_MAX:
            # keep the hot half; the dropped tail was never promotable
            keep = sorted(self._heat.items(), key=lambda kv: -kv[1])
            self._heat = dict(keep[: _HEAT_MAX // 2])
        if self._heat_total >= 16 * _HEAT_MAX:
            # aging: halve so the signal tracks SUSTAINED heat
            self._heat = {k: v >> 1 for k, v in self._heat.items() if v > 1}
            self._heat_total //= 2

    def promote_signal(self, vid: int, bid: int) -> bool:
        """True once per CFS_PROMOTE_HITS accesses (the counter resets on
        signal) — the caller forwards it to the hot-blob topic. A blob that
        STAYS hot keeps signalling every promote_hits accesses, which is
        what keeps the scheduler's idle-sweep demoter from evicting a
        still-hot blob out of the hot tier: signal silence really means
        'fewer than promote_hits accesses per demote window'."""
        if self.promote_hits <= 0:
            return False
        key = (vid, bid)
        with self._lock:
            if self._heat.get(key, 0) < self.promote_hits:
                return False
            self._heat[key] = 0
        self._reg.counter("promote_signals").add()
        return True

    def stats(self) -> dict:
        return self.mgr.stats()
