"""ClusterMgr — the blobstore control plane.

Reference counterpart: blobstore/clustermgr (raft-replicated managers:
DiskMgr/VolumeMgr/ScopeMgr/ServiceMgr/ConfigMgr, svr.go:123-138; volume creation
places chunks across AZs/racks, volumemgr/createvolume.go; bid/vid scopes,
scopemgr). This single-node engine keeps the same responsibilities and a
WAL+snapshot persistence contract; the reference's consensus layer wraps
it for replication (not part of this package yet).

State model (all mutations go through apply() so a replicated log can drive it):
  * disks: disk_id -> {node_id, az, status, heartbeat}
  * volumes: vid -> {codemode, units: [vuid...], health}; vuid -> (node, disk)
  * scopes: named monotonic id ranges (vid space, bid space)
  * services / config KV
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

from chubaofs_tpu_torch.codec.codemode import CodeMode, get_tactic
from chubaofs_tpu_torch.utils import events
from chubaofs_tpu_torch.utils.locks import SanitizedRLock

DISK_NORMAL = "normal"
DISK_BROKEN = "broken"
DISK_DROPPED = "dropped"

VOL_IDLE = "idle"
VOL_ACTIVE = "active"
VOL_LOCK = "lock"


class ClusterError(Exception):
    pass


@dataclass
class DiskInfo:
    disk_id: int
    node_id: int
    az: int = 0
    rack: str = ""
    status: str = DISK_NORMAL
    last_heartbeat: float = 0.0
    chunk_count: int = 0


@dataclass
class VolumeUnit:
    vuid: int
    index: int  # stripe position 0..total-1
    disk_id: int
    node_id: int
    epoch: int = 1


@dataclass
class VolumeInfo:
    vid: int
    code_mode: int
    units: list[VolumeUnit] = field(default_factory=list)
    status: str = VOL_IDLE
    used: int = 0
    capacity: int = 1 << 30

    def tactic(self):
        return get_tactic(self.code_mode)


def make_vuid(vid: int, index: int, epoch: int = 1) -> int:
    """vuid encodes (vid, stripe index, epoch) in one integer."""
    return (vid << 24) | (index << 8) | epoch


def parse_vuid(vuid: int) -> tuple[int, int, int]:
    return vuid >> 24, (vuid >> 8) & 0xFFFF, vuid & 0xFF


class ClusterMgr:
    """Single-group state machine; every mutation is an (op, args) apply."""

    def __init__(self, data_dir: str | None = None):
        self._lock = SanitizedRLock(name="clustermgr")
        self.disks: dict[int, DiskInfo] = {}
        self.volumes: dict[int, VolumeInfo] = {}
        self.scopes: dict[str, int] = {}
        self.services: dict[str, list[str]] = {}
        self.config: dict[str, str] = {}
        # tier residency map: (vid, bid) -> (hot_vid, hot_bid)
        # for blobs the promoter copied into the Replica3 hot engine. The
        # ORIGINAL EC copy stays authoritative (Location tokens keep
        # working); the map is a read-path redirect, replicated like every
        # other mutation so a restarted gateway keeps serving hot reads.
        self.tiermap: dict[tuple[int, int], tuple[int, int]] = {}
        # monotonic heartbeat observations, THIS process only (never
        # persisted — a wall-clock stamp would be meaningless arithmetic
        # across restarts, and expiry is a liveness judgment about what this
        # clustermgr has itself observed). Restored disks stamp "now" so a
        # freshly-loaded cluster gets a full grace window before any expiry.
        self._hb_mono: dict[int, float] = {}
        self._data_dir = data_dir
        self._db = None
        self._seq = 0  # last applied wal sequence
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            from chubaofs_tpu_torch.utils.kvstore import open_kv

            self._db = open_kv(os.path.join(data_dir, "kv"))
            self._load()
        self._refresh_disk_gauges()

    # -- persistence (state in the native kvstore, the RocksDB role of
    # blobstore/common/kvstore under clustermgr) ----------------------------
    #
    # Keys: "snap" (json state) + "snap_seq" written atomically in one batch,
    # "w/<seq>" for WAL entries after the snapshot. A crash anywhere leaves
    # either the old snapshot + its WAL tail or the new snapshot with the
    # old WAL keys deleted in the same atomic batch — never a double replay.

    @staticmethod
    def _wal_key(seq: int) -> bytes:
        return b"w/%020d" % seq

    def _load(self):
        self._migrate_legacy()
        snap = self._db.get(b"snap")
        if snap is not None:
            self._seq = int(self._db.get(b"snap_seq") or b"0")
            self._restore(json.loads(snap))
        for k, v in self._db.scan(prefix=b"w/", start=self._wal_key(self._seq + 1)):
            op, args = json.loads(v)
            self._apply(op, args, replay=True)
            self._seq = int(k[2:])

    def _migrate_legacy(self):
        """One-time import of the earlier snapshot.json + wal-N.jsonl files."""
        snap = os.path.join(self._data_dir, "snapshot.json")
        legacy_wals = sorted(
            f for f in os.listdir(self._data_dir)
            if f.startswith("wal-") and f.endswith(".jsonl"))
        if not os.path.exists(snap) and not legacy_wals:
            return
        wal_id = 0
        if os.path.exists(snap):
            with open(snap) as f:
                payload = json.load(f)
            wal_id = payload.get("wal_id", 0)
            self._restore(payload["state"])
        wal = os.path.join(self._data_dir, f"wal-{wal_id}.jsonl")
        if os.path.exists(wal):
            with open(wal) as f:
                for line in f:
                    if line.strip():
                        op, args = json.loads(line)
                        self._apply(op, args, replay=True)
        self._db.write_batch(puts=[(b"snap", json.dumps(self.snapshot()).encode()),
                                   (b"snap_seq", b"0")])
        for f in legacy_wals + (["snapshot.json"] if os.path.exists(snap) else []):
            os.replace(os.path.join(self._data_dir, f),
                       os.path.join(self._data_dir, f + ".migrated"))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "disks": {i: d.__dict__ for i, d in self.disks.items()},
                "volumes": {
                    v: {**info.__dict__, "units": [u.__dict__ for u in info.units]}
                    for v, info in self.volumes.items()
                },
                "scopes": dict(self.scopes),
                "services": {k: list(v) for k, v in self.services.items()},
                "config": dict(self.config),
                "tiermap": [[v, b, hv, hb]
                            for (v, b), (hv, hb) in self.tiermap.items()],
            }

    def _restore(self, snap: dict):
        self.disks = {int(i): DiskInfo(**d) for i, d in snap["disks"].items()}
        now = time.monotonic()
        self._hb_mono = {i: now for i in self.disks}
        self.volumes = {}
        for v, info in snap["volumes"].items():
            units = [VolumeUnit(**u) for u in info.pop("units")]
            self.volumes[int(v)] = VolumeInfo(**{**info, "units": units})
        self.scopes = dict(snap["scopes"])
        self.services = {k: list(v) for k, v in snap["services"].items()}
        self.config = dict(snap["config"])
        # .get: snapshots from before the tier map existed
        self.tiermap = {(v, b): (hv, hb)
                        for v, b, hv, hb in snap.get("tiermap", [])}

    def checkpoint(self):
        """Fold the WAL into a fresh snapshot in ONE atomic kv batch: the new
        snapshot, its sequence floor, and the deletion of every folded WAL
        entry land together or not at all (RocksDB checkpoint discipline)."""
        if not self._db:
            return
        with self._lock:
            wal_keys = [k for k, _ in self._db.scan(prefix=b"w/")]
            self._db.write_batch(
                puts=[(b"snap", json.dumps(self.snapshot()).encode()),
                      (b"snap_seq", str(self._seq).encode())],
                deletes=wal_keys)

    def _apply(self, op: str, args: dict, replay: bool = False):
        handler = getattr(self, "_op_" + op)
        out = handler(**args)
        if self._db and not replay:
            self._seq += 1
            self._db.put(self._wal_key(self._seq), json.dumps([op, args]).encode())
        return out

    def _apply_batch(self, ops: list[tuple[str, dict]]) -> list:
        """Apply many ops with ONE durable kv write batch — the raft
        group-commit analog at this store's WAL layer (lock held by caller).
        Ops already applied before a mid-batch failure still reach the WAL."""
        out, puts = [], []
        try:
            for op, args in ops:
                out.append(getattr(self, "_op_" + op)(**args))
                if self._db:
                    self._seq += 1
                    puts.append((self._wal_key(self._seq),
                                 json.dumps([op, args]).encode()))
        finally:
            if self._db and puts:
                self._db.write_batch(puts=puts)
        return out

    def close(self):
        if self._db is not None:
            self._db.close()
            self._db = None

    def apply(self, op: str, args: dict):
        with self._lock:
            return self._apply(op, args)

    # -- scope mgr ----------------------------------------------------------

    def alloc_scope(self, name: str, count: int = 1) -> tuple[int, int]:
        """Allocate [first, last] inclusive monotonic ids from a named scope."""
        return self.apply("alloc_scope", {"name": name, "count": count})

    def _op_alloc_scope(self, name: str, count: int):
        cur = self.scopes.get(name, 0)
        self.scopes[name] = cur + count
        return (cur + 1, cur + count)

    # -- disk mgr -----------------------------------------------------------

    def register_disk(self, disk_id: int, node_id: int, az: int = 0, rack: str = "") -> None:
        self.apply("register_disk", {"disk_id": disk_id, "node_id": node_id, "az": az, "rack": rack})
        self._refresh_disk_gauges()

    def register_disks(self, specs: list[dict]) -> None:
        """Register many disks in ONE batched WAL commit (cluster bring-up:
        a node's whole disk set lands as a single kv write batch)."""
        with self._lock:
            self._apply_batch([
                ("register_disk", {"az": 0, "rack": "", **s}) for s in specs])
        self._refresh_disk_gauges()

    def _op_register_disk(self, disk_id: int, node_id: int, az: int, rack: str):
        if disk_id not in self.disks:  # racelint: _op_* appliers only run under self._lock (apply/_apply_batch take it)
            self.disks[disk_id] = DiskInfo(disk_id, node_id, az, rack)
        self.disks[disk_id].last_heartbeat = time.time()
        self._hb_mono[disk_id] = time.monotonic()  # racelint: _op_* appliers only run under self._lock (apply/_apply_batch take it)

    def heartbeat_disk(self, disk_id: int,
                       chunk_count: int | None = None) -> None:
        """Liveness beat. NOT an apply(): heartbeats are observations, not
        replicated state transitions — a WAL entry per beat per disk would
        bloat the log for zero recovery value (the reference batches them
        in memory the same way). chunk_count=None leaves the placement
        bookkeeping alone: clustermgr's own unit accounting is
        authoritative, and a node's physical chunk count legitimately lags
        volume creation (chunks materialize at first write)."""
        with self._lock:
            d = self.disks.get(disk_id)
            if d is None:
                raise ClusterError(f"unknown disk {disk_id}")
            d.last_heartbeat = time.time()
            self._hb_mono[disk_id] = time.monotonic()
            if chunk_count is not None:
                d.chunk_count = chunk_count

    def _op_heartbeat_disk(self, disk_id: int, chunk_count: int):
        # retained for WAL replay of pre-heartbeat-rework logs
        d = self.disks.get(disk_id)
        if d is None:
            raise ClusterError(f"unknown disk {disk_id}")
        d.last_heartbeat = time.time()
        self._hb_mono[disk_id] = time.monotonic()  # racelint: _op_* appliers only run under self._lock (apply/_apply_batch take it)
        d.chunk_count = chunk_count

    def disk_status(self, disk_id: int) -> str | None:
        """Current status of one disk (None if unknown) — the read half of
        the report-broken handshake: a reporter must not flip a disk that
        already left NORMAL (broken is being repaired, dropped IS repaired)."""
        with self._lock:
            d = self.disks.get(disk_id)
            return None if d is None else d.status

    def set_disk_status(self, disk_id: int, status: str,
                        reason: str = "report") -> None:
        """The ONE public disk-status transition (the error-count path:
        blobnode heartbeats report broken disks through here; repair
        completion drops them through here too). The transition lands on
        the event timeline — a WAL replay does not (it re-applies state,
        it is not a fresh transition)."""
        with self._lock:
            d = self.disks.get(disk_id)
            old = d.status if d is not None else None
            self._apply("set_disk_status",
                        {"disk_id": disk_id, "status": status})
            # gauge + timeline record land INSIDE the (re-entrant) lock:
            # the lock serializes every transition, so the timeline's order
            # matches the state machine's — a repair lease observed after
            # this broken-flip can never carry an earlier stamp (the same
            # contract the scheduler's lease emitters keep)
            self._refresh_disk_gauges()
            if old != status:
                self._emit_disk_event(disk_id, old, status, reason)

    def _emit_disk_event(self, disk_id: int, old: str | None, status: str,
                         reason: str) -> None:
        with self._lock:
            node_id = self.disks[disk_id].node_id \
                if disk_id in self.disks else -1
        events.emit(
            "disk_status",
            events.SEV_CRITICAL if status == DISK_BROKEN else events.SEV_INFO,
            entity=f"disk{disk_id}",
            detail={"disk_id": disk_id, "node_id": node_id,
                    "from": old, "to": status, "reason": reason})

    def _refresh_disk_gauges(self) -> None:
        """cfs_clustermgr_disks{status} gauges — the broken-disk count the
        alert plane evaluates (bounded label: the three status literals)."""
        from chubaofs_tpu_torch.utils.exporter import registry

        with self._lock:
            counts = {DISK_NORMAL: 0, DISK_BROKEN: 0, DISK_DROPPED: 0}
            for d in self.disks.values():
                counts[d.status] = counts.get(d.status, 0) + 1
        reg = registry("clustermgr")
        for status, n in counts.items():
            reg.gauge("disks", {"status": status}).set(n)

    def _op_set_disk_status(self, disk_id: int, status: str):
        if disk_id not in self.disks:
            raise ClusterError(f"unknown disk {disk_id}")
        self.disks[disk_id].status = status

    # -- volume mgr ---------------------------------------------------------

    def create_volume(self, code_mode: CodeMode | int) -> VolumeInfo:
        """Place one chunk per stripe position on distinct disks, AZ-aware.

        Reference: volumemgr/createvolume.go — data/parity/local shards of one
        AZ land on that AZ's disks, no two units of a volume share a disk."""
        mode = int(code_mode)
        t = get_tactic(mode)
        with self._lock:
            healthy = [d for d in self.disks.values() if d.status == DISK_NORMAL]
            by_az: dict[int, list[DiskInfo]] = {}
            for d in healthy:
                by_az.setdefault(d.az, []).append(d)
            azs = sorted(by_az)
            if len(azs) < t.az_count:
                raise ClusterError(
                    f"codemode needs {t.az_count} AZs, cluster has {len(azs)}"
                )
            # check capacity per AZ
            per_az = t.total // t.az_count
            placements: list[int] = [0] * t.total
            for az_pos, az in enumerate(azs[: t.az_count]):
                pool = sorted(by_az[az], key=lambda d: d.chunk_count)
                need = [i for i in range(t.total) if t.az_of_shard(i) == az_pos]
                if len(pool) < len(need):
                    raise ClusterError(
                        f"AZ {az} has {len(pool)} disks, needs {len(need)}"
                    )
                for slot, d in zip(need, pool):
                    placements[slot] = d.disk_id
            (vid, _) = self._apply("alloc_scope", {"name": "vid", "count": 1})
            return self._apply(
                "create_volume", {"vid": vid, "code_mode": mode, "placements": placements}
            )

    def _op_create_volume(self, vid: int, code_mode: int, placements: list[int]):
        units = []
        for idx, disk_id in enumerate(placements):
            d = self.disks[disk_id]
            units.append(VolumeUnit(make_vuid(vid, idx), idx, disk_id, d.node_id))
            d.chunk_count += 1
        vol = VolumeInfo(vid=vid, code_mode=code_mode, units=units, status=VOL_ACTIVE)
        self.volumes[vid] = vol
        return vol

    def get_volume(self, vid: int) -> VolumeInfo:
        with self._lock:
            vol = self.volumes.get(vid)
            if vol is None:
                raise ClusterError(f"unknown volume {vid}")
            return vol

    def alloc_volume(self, code_mode: CodeMode | int, count_hint: int = 1) -> VolumeInfo:
        """Return an active volume of the mode, creating one if none exists."""
        mode = int(code_mode)
        with self._lock:
            for vol in self.volumes.values():
                if vol.code_mode == mode and vol.status == VOL_ACTIVE:
                    return vol
            return self.create_volume(mode)

    def alloc_volumes(self, code_mode: CodeMode | int,
                      count: int = 1) -> list[VolumeInfo]:
        """Up to `count` DISTINCT active volumes of the mode, creating the
        shortfall (volumemgr's multi-volume grant): a pipelined PUT spreads
        consecutive blobs across them so one chunk file's append lock never
        serializes the whole window. Returns fewer when the cluster can't
        place more volumes — never fails while at least one is allocatable."""
        mode = int(code_mode)
        # check + create under one (re-entrant) lock hold, like the singular
        # alloc_volume: concurrent grantees must not both see the same
        # shortfall and over-create volumes
        with self._lock:
            act = [v for v in self.volumes.values()
                   if v.code_mode == mode and v.status == VOL_ACTIVE]
            while len(act) < count:
                try:
                    act.append(self.create_volume(mode))
                except ClusterError:
                    if act:
                        break
                    raise
            return act[:count]

    def set_volume_status(self, vid: int, status: str) -> None:
        """Retire full volumes (VOL_IDLE) so alloc_volume rotates to a new one."""
        self.apply("set_volume_status", {"vid": vid, "status": status})

    def _op_set_volume_status(self, vid: int, status: str):
        vol = self.volumes.get(vid)
        if vol is None:
            raise ClusterError(f"unknown volume {vid}")
        vol.status = status

    def update_volume_unit(self, vid: int, index: int, new_disk_id: int) -> VolumeUnit:
        """Re-home a stripe position after repair/migration (epoch bump)."""
        return self.apply(
            "update_volume_unit", {"vid": vid, "index": index, "new_disk_id": new_disk_id}
        )

    def _op_update_volume_unit(self, vid: int, index: int, new_disk_id: int):
        vol = self.volumes.get(vid)
        if vol is None:
            raise ClusterError(f"unknown volume {vid}")
        unit = vol.units[index]
        d = self.disks[new_disk_id]
        old = self.disks.get(unit.disk_id)
        if old is not None and old.chunk_count > 0:
            old.chunk_count -= 1  # the chunk moved WITH the unit
        d.chunk_count += 1
        unit.epoch += 1
        unit.disk_id = new_disk_id
        unit.node_id = d.node_id
        unit.vuid = make_vuid(vid, index, unit.epoch)
        return unit

    # -- tier residency (hot Replica3 copies of sustained-hot EC blobs) ------

    def promote_blob(self, vid: int, bid: int, hot_vid: int,
                     hot_bid: int) -> tuple[int, int]:
        """Install the redirect iff absent (first committer wins); returns
        the WINNING residence — a promoter that lost the race frees its
        own replica set instead of overwriting (and leaking) the winner's."""
        return self.apply("promote_blob", {"vid": vid, "bid": bid,
                                           "hot_vid": hot_vid,
                                           "hot_bid": hot_bid})

    def _op_promote_blob(self, vid: int, bid: int, hot_vid: int, hot_bid: int):
        return self.tiermap.setdefault((vid, bid), (hot_vid, hot_bid))

    def demote_blob(self, vid: int, bid: int) -> tuple[int, int] | None:
        """Drop the redirect FIRST (readers fall back to the authoritative EC
        copy immediately); returns the hot residence so the caller can free
        its replica shards afterwards."""
        return self.apply("demote_blob", {"vid": vid, "bid": bid})

    def _op_demote_blob(self, vid: int, bid: int):
        return self.tiermap.pop((vid, bid), None)

    def hot_location(self, vid: int, bid: int) -> tuple[int, int] | None:
        with self._lock:
            return self.tiermap.get((vid, bid))

    def hot_blobs(self) -> dict[tuple[int, int], tuple[int, int]]:
        with self._lock:
            return dict(self.tiermap)

    # -- service + config mgr ----------------------------------------------

    def register_service(self, name: str, addr: str) -> None:
        self.apply("register_service", {"name": name, "addr": addr})

    def _op_register_service(self, name: str, addr: str):
        lst = self.services.setdefault(name, [])
        if addr not in lst:
            lst.append(addr)

    def get_service(self, name: str) -> list[str]:
        with self._lock:
            return list(self.services.get(name, []))

    def set_config(self, key: str, value: str) -> None:
        self.apply("set_config", {"key": key, "value": value})

    def _op_set_config(self, key: str, value: str):
        self.config[key] = value

    def del_config(self, key: str) -> None:
        self.apply("del_config", {"key": key})

    def _op_del_config(self, key: str):
        self.config.pop(key, None)

    def get_config(self, key: str, default: str | None = None) -> str | None:
        with self._lock:
            return self.config.get(key, default)

    def config_items(self, prefix: str = "") -> list[tuple[str, str]]:
        """Locked snapshot of config entries under a key prefix."""
        with self._lock:
            return [(k, v) for k, v in self.config.items() if k.startswith(prefix)]

    # -- health views --------------------------------------------------------

    def broken_disks(self) -> list[DiskInfo]:
        with self._lock:
            return [d for d in self.disks.values() if d.status == DISK_BROKEN]

    def expire_heartbeats(self, timeout_s: float) -> list[int]:
        """Mark NORMAL disks whose heartbeat this process hasn't observed in
        timeout_s as BROKEN (the kill-a-blobnode detection path: a dead
        engine stops beating and its disks become disk-repair work). The
        judgment clock is monotonic and process-local — a restarted
        clustermgr grants every disk a fresh grace window rather than
        condemning the fleet off stale wall-clock stamps. Returns the disk
        ids newly marked broken (the status change IS replicated)."""
        now = time.monotonic()
        with self._lock:
            stale = [
                d.disk_id for d in self.disks.values()
                if d.status == DISK_NORMAL
                and now - self._hb_mono.get(d.disk_id, now) > timeout_s
            ]
            for disk_id in stale:
                self._apply("set_disk_status",
                            {"disk_id": disk_id, "status": DISK_BROKEN})
            if stale:
                # under the lock, like set_disk_status: detection events
                # must stamp before any repair reaction can (causal order)
                self._refresh_disk_gauges()
                for disk_id in stale:
                    # the heartbeat-silence detection path, distinguished
                    # from the error-count report path on the timeline
                    self._emit_disk_event(disk_id, DISK_NORMAL, DISK_BROKEN,
                                          "heartbeat_silence")
        return stale

    def volumes_on_disk(self, disk_id: int) -> list[tuple[VolumeInfo, VolumeUnit]]:
        with self._lock:
            out = []
            for vol in self.volumes.values():
                for u in vol.units:
                    if u.disk_id == disk_id:
                        out.append((vol, u))
            return out
