"""Proxy — volume-allocation caching and the async message bus.

Reference counterpart: blobstore/proxy (allocator/volumemgr.go:348,512 caches
renewable volume grants from clustermgr; mq/ forwards shard-repair and
blob-delete messages to Kafka, service.go:57). Kafka is replaced by a durable
file-backed topic queue — same at-least-once contract, no external broker.
"""

from __future__ import annotations

import json
import os
import time

from chubaofs_tpu_torch.blobstore.clustermgr import ClusterMgr, VolumeInfo
from chubaofs_tpu_torch.utils.locks import SanitizedLock

TOPIC_SHARD_REPAIR = "shard_repair"
TOPIC_BLOB_DELETE = "blob_delete"
TOPIC_BLOB_HOT = "blob_hot"  # access-layer heat signals -> tier promoter


class TopicQueue:
    """Durable append-only topic with consumer offsets (the Kafka stand-in)."""

    def __init__(self, path: str | None = None):
        self._lock = SanitizedLock(name="proxy.topic")
        self._msgs: list[dict] = []
        self._offsets: dict[str, int] = {}
        self._path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            if os.path.exists(path):
                with open(path) as f:
                    for line in f:
                        if line.strip():
                            self._msgs.append(json.loads(line))
            self._f = open(path, "a")
        else:
            self._f = None

    def produce(self, msg: dict) -> None:
        with self._lock:
            self._msgs.append(msg)
            if self._f:
                self._f.write(json.dumps(msg) + "\n")
                self._f.flush()

    def consume(self, group: str, max_msgs: int = 64) -> list[dict]:
        with self._lock:
            off = self._offsets.get(group, 0)
            batch = self._msgs[off : off + max_msgs]
            return batch

    def commit(self, group: str, count: int) -> None:
        with self._lock:
            self._offsets[group] = self._offsets.get(group, 0) + count

    def lag(self, group: str) -> int:
        with self._lock:
            return len(self._msgs) - self._offsets.get(group, 0)


class Proxy:
    """Per-IDC stateless proxy: cached volume grants + message production.

    Grants EXPIRE (alloc_ttl): like the reference allocator's renewal loop
    (proxy/allocator/volumemgr.go:348,512), a cached volume is re-validated
    against clustermgr after the TTL so a long-running proxy never keeps
    serving a volume that was retired, locked, or filled behind its back."""

    def __init__(self, cm: ClusterMgr, data_dir: str | None = None,
                 alloc_ttl: float = 30.0, active_vols: int | None = None):
        self.cm = cm
        self.alloc_ttl = alloc_ttl
        # grants rotate round-robin over a SET of active volumes (the
        # reference allocator keeps several volumes per mode in flight):
        # consecutive blobs of one windowed PUT then land on different
        # chunks/disks instead of serializing on one chunk's append lock
        if active_vols is None:
            active_vols = int(os.environ.get("CFS_PROXY_ACTIVE_VOLS", "2"))
        self.active_vols = max(1, active_vols)
        self._lock = SanitizedLock(name="proxy.alloc")
        # code_mode -> (volume grants, monotonic expiry)
        self._cached: dict[int, tuple[list[VolumeInfo], float]] = {}
        self._rr: dict[int, int] = {}
        d = data_dir
        self.topics = {
            TOPIC_SHARD_REPAIR: TopicQueue(os.path.join(d, "repair.jsonl") if d else None),
            TOPIC_BLOB_DELETE: TopicQueue(os.path.join(d, "delete.jsonl") if d else None),
            TOPIC_BLOB_HOT: TopicQueue(os.path.join(d, "hot.jsonl") if d else None),
        }

    # -- allocator (volumemgr.go:348 Alloc analog) ---------------------------

    def alloc_volume(self, code_mode: int) -> VolumeInfo:
        now = time.monotonic()
        with self._lock:
            granted, expires = self._cached.get(code_mode, ([], 0.0))
            vols = [v for v in granted if v.status == "active"]
            # renew on TTL expiry AND whenever a granted volume was retired
            # behind our back (len shrank): a thinned set would serialize
            # the PUT window on one chunk for the rest of the TTL — the
            # exact contention the rotating grant exists to prevent
            if not vols or now >= expires or len(vols) < len(granted):
                vols = self.cm.alloc_volumes(code_mode, self.active_vols)
                self._cached[code_mode] = (vols, now + self.alloc_ttl)
            i = self._rr.get(code_mode, 0)
            self._rr[code_mode] = i + 1
            return vols[i % len(vols)]

    def alloc_bids(self, count: int) -> tuple[int, int]:
        return self.cm.alloc_scope("bid", count)

    def invalidate(self, code_mode: int) -> None:
        with self._lock:
            self._cached.pop(code_mode, None)

    # -- message bus (mq analog) ---------------------------------------------

    def send_shard_repair(self, vid: int, bid: int, bad_idx: list[int], reason: str) -> None:
        self.topics[TOPIC_SHARD_REPAIR].produce(
            {"vid": vid, "bid": bid, "bad_idx": bad_idx, "reason": reason}
        )

    def send_blob_delete(self, vid: int, bid: int) -> None:
        self.topics[TOPIC_BLOB_DELETE].produce({"vid": vid, "bid": bid})

    def send_blob_hot(self, vid: int, bid: int, size: int) -> None:
        """Heat signal from the cache plane: this blob crossed the promote
        threshold — the scheduler's tier sweep turns it into a task. `size`
        is the blob's true byte length (shards alone can't recover it past
        the stripe padding; the promoter trims the replica copy with it)."""
        self.topics[TOPIC_BLOB_HOT].produce(
            {"vid": vid, "bid": bid, "size": size})
