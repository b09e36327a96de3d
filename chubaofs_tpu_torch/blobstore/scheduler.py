"""Scheduler — the background task brain: shard repair, disk repair/drop,
balance, blob delete.

Reference counterpart: blobstore/scheduler (migrate state machines with
prepare/work/finish queues, migrate.go:322-347; Kafka consumers feeding
ShardRepairMgr shard_repairer.go:103 and blob_deleter.go; workers PULL tasks
via HTTPTaskAcquire, service.go:84, repair tasks served first). Shapes kept:

  * tasks move through PREPARED -> WORKING -> FINISHED and survive restarts by
    reloading from the clustermgr-persisted task table;
  * workers acquire tasks (repair before balance) and report completion;
  * the repair math itself is a batched device reconstruct through CodecService:
    a disk-repair task covers every (volume, bid) on the dead disk, and the
    worker stacks thousands of stripes into the same device batches
    (SURVEY §3.5's 10k-stripe bulk-repair config).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field

import numpy as np

from chubaofs_tpu_torch.blobstore import trace
from chubaofs_tpu_torch.blobstore.blobnode import BlobNode, classify_io_error
from chubaofs_tpu_torch.blobstore.clustermgr import (
    DISK_DROPPED,
    DISK_NORMAL,
    ClusterMgr,
    VolumeInfo,
    parse_vuid,
)
from chubaofs_tpu_torch.blobstore.proxy import (
    TOPIC_BLOB_DELETE,
    TOPIC_BLOB_HOT,
    TOPIC_SHARD_REPAIR,
    Proxy,
)
from chubaofs_tpu_torch.codec.service import CodecService, default_service
from chubaofs_tpu_torch.utils.exporter import BATCH_BUCKETS, RATIO_BUCKETS, registry

TASK_PREPARED = "prepared"
TASK_WORKING = "working"
TASK_FINISHED = "finished"
TASK_FAILED = "failed"  # exhausted retries; eligible for re-creation

KIND_SHARD_REPAIR = "shard_repair"
KIND_DISK_REPAIR = "disk_repair"
KIND_DISK_DROP = "disk_drop"
KIND_BALANCE = "balance"
KIND_TIER_PROMOTE = "tier_promote"
KIND_TIER_DEMOTE = "tier_demote"

# acquisition priority (service.go:84: repair first; tier migration is an
# optimization, so it yields to every durability task)
_PRIORITY = [KIND_SHARD_REPAIR, KIND_DISK_REPAIR, KIND_DISK_DROP,
             KIND_BALANCE, KIND_TIER_PROMOTE, KIND_TIER_DEMOTE]

_TASK_STATES = (TASK_PREPARED, TASK_WORKING, TASK_FINISHED, TASK_FAILED)


def stage_overlap_ratio(stages) -> float | None:
    """Download/decode overlap of one repair span's stages: intersection of
    the 'download' interval union with the codec.* interval union, over the
    SMALLER of the two — 0 means the pipeline degenerated to serial, >0 means
    survivor downloads really ran while the device decoded. None when either
    side never happened (nothing to overlap)."""
    dl = [(off, off + dur) for name, off, dur in stages if name == "download"]
    dec = [(off, off + dur) for name, off, dur in stages
           if name.startswith("codec.")]
    return trace.overlap_ratio(dl, dec)


@dataclass
class Task:
    task_id: str
    kind: str
    state: str = TASK_PREPARED
    vid: int = 0
    bid: int = 0
    bad_idx: list[int] = field(default_factory=list)
    disk_id: int = 0
    dest_disk_id: int | None = None  # None = pick at execution
    size: int = 0  # tier_promote: the blob's true byte length
    created: float = field(default_factory=time.time)
    retries: int = 0
    error: str = ""
    # current lease number (0 = never leased). Monotonic across the
    # scheduler's lifetime; a report carrying an older lease is STALE — the
    # reaper requeued and re-leased the task after that worker went quiet.
    lease: int = 0


class Scheduler:
    """Leader-elected background brain (single leader here; raft wraps later)."""

    def __init__(self, cm: ClusterMgr, proxy: Proxy, nodes: dict[int, BlobNode],
                 codec: CodecService | None = None, record_log=None,
                 cache=None):
        from chubaofs_tpu_torch.blobstore.taskswitch import SwitchMgr

        self.cm = cm
        self.proxy = proxy
        self.nodes = nodes
        self.codec = codec or default_service()
        # the gateway's BlobCache when co-located (MiniCluster): the deleter
        # punches blobs out of it before shards disappear
        self.cache = cache
        # switches persist in the clustermgr config KV (task_switch.go:26);
        # pull persisted state so a restarted scheduler honors prior settings
        self.switches = SwitchMgr(config_get=cm.get_config,
                                  config_set=cm.set_config)
        self.switches.refresh()
        self.record_log = record_log  # common/recordlog: finished-task audit
        self._lock = threading.Lock()
        self._tasks: dict[str, Task] = {}
        self._seq = 0
        self._inspect_cursor = 0  # round-robin position over volume ids
        # leased scheduling (the task_runner.go lease/renewal analog): every
        # acquire hands out a monotonic deadline; the reaper requeues expired
        # WORKING tasks with backoff so a dead worker can never strand one.
        self.lease_ms = float(os.environ.get("CFS_REPAIR_LEASE_MS", "30000"))
        self.requeue_backoff_s = 0.5  # doubled per expiry, capped below
        self.requeue_backoff_cap_s = 30.0
        # expiries before a WORKING task goes terminal FAILED (reap_expired)
        self.max_lease_expiries = 5
        # heartbeat-silence window after which a disk counts as dead (the
        # kill-a-blobnode detection path; generous default so slow test
        # phases never false-positive — the kill soak tightens it)
        self.hb_timeout_s = float(os.environ.get("CFS_HB_TIMEOUT_S", "60"))
        # tier demotion: a promoted blob that produces NO heat signal for
        # this many tier sweeps has gone cold — its replica copy is freed
        # and reads fall back to EC
        self.demote_sweeps = int(os.environ.get("CFS_DEMOTE_SWEEPS", "8"))
        self._tier_idle: dict[tuple[int, int], int] = {}  # under self._lock
        # recently-deleted (vid, bid)s, noted BEFORE the deleter touches
        # tier/cache state: an in-flight promote re-checks this after
        # committing its redirect, closing the promote-vs-delete race in
        # daemon deployments where the two run on different threads.
        # Bounded LRU; entries only need to outlive the concurrency window
        # (a promote for a long-gone blob fails on the punched EC read).
        self._deleted_recent: OrderedDict[tuple[int, int], None] = \
            OrderedDict()  # under self._lock
        self._lease_seq = 0
        self._lease_deadline: dict[str, float] = {}  # task_id -> monotonic
        self._not_before: dict[str, float] = {}      # requeue backoff gate
        self._expiries: dict[str, int] = {}          # per-task expiry count
        self._load_tasks()
        with self._lock:
            self._update_gauges_locked()

    # -- task table (persisted in the clustermgr config KV, the reference's
    # migrate-task tables in clustermgr: migrate.go:346-347) -------------------

    _TASK_PREFIX = "task/"
    _TASK_SEQ_KEY = "task_seq"

    # in-memory history cap: terminal tasks already left the KV
    # (_persist_task) and the recordlog holds the durable audit; keeping a
    # bounded tail serves `task ls` without letting a long outage — where
    # FAILED tasks are re-created per fresh damage report — grow the table,
    # and with it task ids and memory, without bound
    TERMINAL_KEEP = 256

    def _prune_terminal_locked(self) -> None:
        terminal = [t for t in self._tasks.values()
                    if t.state in (TASK_FINISHED, TASK_FAILED)]
        if len(terminal) <= self.TERMINAL_KEEP:
            return
        terminal.sort(key=lambda t: int(t.task_id.lstrip("t") or 0))
        for t in terminal[: len(terminal) - self.TERMINAL_KEEP]:
            del self._tasks[t.task_id]

    def _has_tombstone(self, node_id: int, vuid: int, bid: int) -> bool:
        """Tombstone probe that tolerates dark hosts: an unreachable node
        simply cannot attest a tombstone (the sweep retries next round)."""
        node = self.nodes.get(node_id)
        if node is None:
            return False
        try:
            return bool(node.has_tombstone(vuid, bid))
        except Exception:
            return False

    def _load_tasks(self):
        """Reload open tasks after a restart; WORKING tasks re-queue (their
        worker died with us — the reference's junk-task cleanup re-drives).
        The id counter persists separately so completed tasks' ids are never
        reissued (the recordlog audit keys on them)."""
        self._seq = int(self.cm.get_config(self._TASK_SEQ_KEY) or 0)
        for key, raw in self.cm.config_items(self._TASK_PREFIX):
            if not raw:
                continue
            t = Task(**json.loads(raw))
            if t.state == TASK_WORKING:
                t.state = TASK_PREPARED
            self._tasks[t.task_id] = t
            # lease numbers stay monotonic across reloads so a pre-crash
            # worker's report can never alias a fresh lease
            self._lease_seq = max(self._lease_seq, t.lease)

    def _persist_task(self, t: Task):
        key = self._TASK_PREFIX + t.task_id
        if t.state in (TASK_FINISHED, TASK_FAILED):
            # terminal states LEAVE the table (the recordlog keeps the audit);
            # a real delete, so the config KV never grows with task history
            self.cm.del_config(key)
            return
        self.cm.set_config(key, json.dumps(t.__dict__))

    def _new_task(self, **kw) -> Task:
        with self._lock:
            self._seq += 1
            self.cm.set_config(self._TASK_SEQ_KEY, str(self._seq))
            t = Task(task_id=f"t{self._seq}", **kw)
            self._tasks[t.task_id] = t
            self._persist_task(t)
            self._update_gauges_locked()
            return t

    def tasks(self, kind: str | None = None, state: str | None = None) -> list[Task]:
        with self._lock:
            return [
                t
                for t in self._tasks.values()
                if (kind is None or t.kind == kind)
                and (state is None or t.state == state)
            ]

    # -- producers -----------------------------------------------------------

    def poll_repair_topic(self, max_msgs: int = 64) -> int:
        """Drain the shard-repair topic into repair tasks (shard_repairer.go:103).

        Deduped by (vid, bid): every degraded GET emits a message, but one open
        task repairs the whole stripe."""
        from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_SHARD_REPAIR

        if not self.switches.enabled(SWITCH_SHARD_REPAIR):
            return 0
        topic = self.proxy.topics[TOPIC_SHARD_REPAIR]
        msgs = topic.consume("scheduler", max_msgs)
        with self._lock:
            # terminal tasks don't block a fresh attempt: a FAILED task means
            # retries ran out under the conditions of the time (e.g. a dark
            # AZ); the damage persisting past that deserves a new task, not
            # permanent abandonment (TASK_FAILED is "eligible for re-creation")
            open_keys = {
                (t.vid, t.bid)
                for t in self._tasks.values()
                if t.kind == KIND_SHARD_REPAIR
                and t.state not in (TASK_FINISHED, TASK_FAILED)
            }
        for m in msgs:
            key = (m["vid"], m["bid"])
            if key in open_keys:
                continue
            open_keys.add(key)
            self._new_task(
                kind=KIND_SHARD_REPAIR, vid=m["vid"], bid=m["bid"], bad_idx=m["bad_idx"]
            )
        topic.commit("scheduler", len(msgs))
        return len(msgs)

    def check_disks(self) -> list[Task]:
        """Turn broken disks into disk-repair tasks (disk_repairer analog).

        Destination disks are picked per-volume at execution time so the
        no-two-units-of-a-volume-per-disk invariant holds."""
        from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_DISK_REPAIR

        if not self.switches.enabled(SWITCH_DISK_REPAIR):
            return []
        out = []
        for disk in self.cm.broken_disks():
            # an open (prepared/working) task blocks re-creation; a FAILED one
            # does not — the disk is still broken and must be retried
            existing = [
                t
                for t in self.tasks(KIND_DISK_REPAIR)
                if t.disk_id == disk.disk_id and t.state in (TASK_PREPARED, TASK_WORKING)
            ]
            if existing:
                continue
            out.append(self._new_task(kind=KIND_DISK_REPAIR, disk_id=disk.disk_id))
        return out

    def inspect_volumes(self, max_volumes: int = 4) -> int:
        """Proactive integrity sweep (scheduler/volume_inspector.go): walk a
        cursor-bounded batch of volumes, verify every stripe position of every
        bid is present AND passes its crc32block framing, and feed anything
        broken to the repair topic — discovery without waiting for a client GET.
        Gated by SWITCH_VOL_INSPECT. Returns repair messages produced."""
        from chubaofs_tpu_torch.blobstore.blobnode import STATUS_MARK_DELETE
        from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_VOL_INSPECT

        if not self.switches.enabled(SWITCH_VOL_INSPECT):
            return 0
        with self._lock:
            vids = sorted(self.cm.volumes)
            if not vids:
                return 0
            start = self._inspect_cursor % len(vids)
            batch = (vids[start:] + vids[:start])[:max_volumes]
            self._inspect_cursor = (start + len(batch)) % len(vids)
        produced = 0
        for vid in batch:
            vol = self.cm.get_volume(vid)
            t = vol.tactic()
            # bid -> stripe positions holding it, with index status
            seen: dict[int, dict[int, int]] = {}
            for u in vol.units:
                node = self.nodes.get(u.node_id)
                if node is None:
                    continue
                try:
                    metas = node.list_shards(u.vuid)
                except Exception:
                    continue
                for m in metas:
                    seen.setdefault(m.bid, {})[u.index] = m.status
            for bid, have in sorted(seen.items()):
                # a tombstone ANYWHERE means this bid was deleted: finish the
                # partial delete (idempotent, retried every sweep) instead of
                # resurrecting it — checked BEFORE the mark-delete skip so a
                # half-marked straggler can't wedge forever
                tombstoned = any(
                    self._has_tombstone(u.node_id, u.vuid, bid)
                    for u in vol.units
                )
                if tombstoned:
                    for idx in have:
                        unit = vol.units[idx]
                        node = self.nodes.get(unit.node_id)
                        if node is None:
                            continue
                        try:
                            node.delete_shard(unit.vuid, bid)
                        except Exception:
                            pass  # node down: retried on the next sweep
                    continue
                if any(st == STATUS_MARK_DELETE for st in have.values()):
                    continue  # delete in flight; the deleter owns this bid
                bad = []
                for idx in range(t.total):
                    unit = vol.units[idx]
                    node = self.nodes.get(unit.node_id)
                    if node is None or idx not in have:
                        bad.append(idx)
                        continue
                    try:
                        node.get_shard(unit.vuid, bid)  # full CRC-framed read
                    except Exception:
                        bad.append(idx)
                if bad:
                    self.proxy.send_shard_repair(vid, bid, bad, "inspect")
                    produced += 1
        if produced:
            registry("scheduler").counter("inspect_findings").add(produced)
        return produced

    def drop_disk(self, disk_id: int) -> Task:
        """Manual decommission -> migrate everything off (disk_drop analog)."""
        return self._new_task(kind=KIND_DISK_DROP, disk_id=disk_id)

    def check_balance(self, min_gap: int = 3) -> Task | None:
        """Even out chunk counts (scheduler/balancer.go): when the most-loaded
        normal disk leads the least-loaded same-AZ disk by >= min_gap chunks,
        create ONE balance task moving a single volume unit off it. Gated by
        SWITCH_BALANCE; one rebalance in flight at a time."""
        from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_BALANCE

        if not self.switches.enabled(SWITCH_BALANCE):
            return None
        if any(t.state in (TASK_PREPARED, TASK_WORKING)
               for t in self.tasks(KIND_BALANCE)):
            return None
        by_az: dict[int, list] = {}
        for d in self.cm.disks.values():
            if d.status == DISK_NORMAL:
                by_az.setdefault(d.az, []).append(d)
        # balance is intrinsically per-AZ (moves never cross AZs): evaluate
        # every AZ's own spread, not one global maximum
        for az, disks in sorted(by_az.items()):
            if len(disks) < 2:
                continue
            src = max(disks, key=lambda d: d.chunk_count)
            low = min(d.chunk_count for d in disks if d.disk_id != src.disk_id)
            if src.chunk_count - low < min_gap:
                continue
            for vol, unit in self.cm.volumes_on_disk(src.disk_id):
                try:
                    dest = self.pick_dest_disk(
                        exclude={u.disk_id for u in vol.units}, az=az)
                except RuntimeError:
                    continue
                # the move must CONVERGE: a destination nearly as loaded as
                # the source would just ping-pong units back and forth
                if self.cm.disks[dest].chunk_count + min_gap > src.chunk_count:
                    continue
                registry("scheduler").counter("balance_tasks").add()
                return self._new_task(kind=KIND_BALANCE, vid=vol.vid,
                                      disk_id=src.disk_id,
                                      dest_disk_id=dest)
        return None

    def pick_dest_disk(self, exclude: set[int], az: int) -> int:
        """Least-loaded normal disk in the AZ, outside the exclusion set
        (source disk + every disk already hosting a unit of the volume)."""
        candidates = [
            d
            for d in self.cm.disks.values()
            if d.status == DISK_NORMAL and d.disk_id not in exclude and d.az == az
        ]
        if not candidates:
            raise RuntimeError(f"no destination disk available in AZ {az}")
        return min(candidates, key=lambda d: d.chunk_count).disk_id

    # -- worker pull API (HTTPTaskAcquire analog) -----------------------------

    def acquire_task(self) -> Task | None:
        """Hand out the highest-priority PREPARED task under a LEASE: the
        returned task carries a fresh lease number and a monotonic deadline;
        a worker that never reports is reaped by reap_expired() and the task
        requeues with backoff. Capture task.lease IMMEDIATELY — the shared
        Task object's lease advances if the task is ever re-leased."""
        now = time.monotonic()
        got: Task | None = None
        with self._lock:
            for kind in _PRIORITY:
                if got is not None:
                    break
                for t in self._tasks.values():
                    if t.kind != kind or t.state != TASK_PREPARED:
                        continue
                    if self._not_before.get(t.task_id, 0.0) > now:
                        continue  # requeue backoff still cooling
                    t.state = TASK_WORKING
                    self._lease_seq += 1
                    t.lease = self._lease_seq
                    # persisted not for the WORKING state (reload demotes it
                    # back to PREPARED regardless) but for the LEASE number:
                    # _load_tasks restores _lease_seq from the stored maximum,
                    # so a worker that outlives a scheduler crash can never
                    # find its old lease number reissued to someone else
                    self._persist_task(t)
                    self._lease_deadline[t.task_id] = \
                        now + self.lease_ms / 1e3
                    self._update_gauges_locked()
                    got = t
                    # emit UNDER the lock: the lock serializes every lease
                    # transition, so stamping here keeps the timeline's
                    # order identical to the state machine's (an expiry's
                    # event can never trail its re-acquisition's), and the
                    # mutable lease field is captured before it can advance
                    from chubaofs_tpu_torch.utils import events

                    events.emit("lease_acquired", entity=t.task_id,
                                detail={"kind": t.kind, "lease": t.lease,
                                        "disk_id": t.disk_id, "vid": t.vid,
                                        "bid": t.bid})
                    break
        return got

    def reap_expired(self) -> int:
        """Requeue WORKING tasks whose lease deadline passed (the junk-task
        cleanup loop the reference runs against dead workers): state back to
        PREPARED behind an exponential requeue backoff, counted by
        cfs_scheduler_lease_expired. The late worker's eventual report is
        dropped as stale (its lease no longer matches). A task that expires
        max_lease_expiries times goes terminal FAILED instead — workers
        renew mid-task (renew_lease), so repeated expiry means every
        execution dies, and re-executing forever is not an error path."""
        from chubaofs_tpu_torch.utils import events

        now = time.monotonic()
        reaped = 0
        failed = 0
        with self._lock:
            for t in self._tasks.values():
                if t.state != TASK_WORKING:
                    continue
                deadline = self._lease_deadline.get(t.task_id)
                if deadline is not None and now < deadline:
                    continue
                self._lease_deadline.pop(t.task_id, None)
                n = self._expiries.get(t.task_id, 0) + 1
                self._expiries[t.task_id] = n
                if n >= self.max_lease_expiries:
                    t.state = TASK_FAILED
                    t.error = f"lease expired {n}x with no report"
                    self._persist_task(t)
                    self._not_before.pop(t.task_id, None)
                    self._expiries.pop(t.task_id, None)
                    failed += 1
                else:
                    t.state = TASK_PREPARED
                    self._not_before[t.task_id] = now + min(
                        self.requeue_backoff_cap_s,
                        self.requeue_backoff_s * (2 ** (n - 1)))
                reaped += 1
                # emit UNDER the lock (same rationale as acquire_task's):
                # the expiry's timeline stamp must precede any
                # re-acquisition's, and only the lock guarantees that
                terminal = t.state == TASK_FAILED
                events.emit("lease_expired", events.SEV_WARNING,
                            entity=t.task_id,
                            detail={"kind": t.kind, "expiries": n,
                                    "terminal": terminal})
                if terminal:
                    events.emit("task_failed", events.SEV_CRITICAL,
                                entity=t.task_id,
                                detail={"kind": t.kind, "error": t.error})
            if failed:
                self._prune_terminal_locked()
            if reaped:
                self._update_gauges_locked()
        if reaped:
            registry("scheduler").counter("lease_expired").add(reaped)
        if failed:
            registry("scheduler").counter("lease_expired_failed").add(failed)
        return reaped

    def renew_lease(self, task_id: str, lease: int) -> bool:
        """Extend a WORKING task's lease deadline by a full lease_ms (the
        reference task runner's renewal tick). A long disk migrate renews
        between units so a healthy slow worker never loses a race against
        the reaper; False means the lease is gone (task pruned, reaped, or
        re-leased) and the caller must abandon the task."""
        with self._lock:
            t = self._tasks.get(task_id)
            if t is None or t.state != TASK_WORKING or t.lease != lease:
                return False
            self._lease_deadline[task_id] = \
                time.monotonic() + self.lease_ms / 1e3
        registry("scheduler").counter("lease_renewed").add()
        return True

    def report_task(self, task_id: str, ok: bool, error: str = "",
                    lease: int | None = None) -> bool:
        """Worker completion report. Tolerant by contract: an unknown id
        (terminal-task pruning, scheduler reload), a task no longer WORKING
        (the reaper requeued it), or a mismatched lease (it was re-leased to
        another worker) is DROPPED with cfs_scheduler_stale_report — never a
        crash in the worker thread, and never a double state transition.
        Returns True when the report was accepted."""
        with self._lock:
            t = self._tasks.get(task_id)
            stale = (t is None or t.state != TASK_WORKING
                     or (lease is not None and lease != t.lease))
            if stale:
                reason = ("pruned" if t is None else
                          "not_working" if t.state != TASK_WORKING
                          else "lease")
            else:
                self._lease_deadline.pop(task_id, None)
                if ok:
                    t.state = TASK_FINISHED
                else:
                    t.retries += 1
                    t.error = error
                    t.state = TASK_PREPARED if t.retries < 3 else TASK_FAILED
                self._persist_task(t)
                if t.state in (TASK_FINISHED, TASK_FAILED):
                    self._prune_terminal_locked()
                    self._not_before.pop(task_id, None)
                    self._expiries.pop(task_id, None)
                self._update_gauges_locked()
            record = None
            if not stale and self.record_log is not None \
                    and t.state in (TASK_FINISHED, TASK_FAILED):
                record = {
                    "task_id": t.task_id, "kind": t.kind, "state": t.state,
                    "vid": t.vid, "bid": t.bid, "disk_id": t.disk_id,
                    "retries": t.retries, "error": t.error,
                }
        if stale:
            registry("scheduler").counter(
                "stale_report", {"reason": reason}).add()
            return False
        # record outside the lock; the audit trail must never alter task state
        if record is not None:
            try:
                self.record_log.encode(record)
            except OSError:
                pass
        if t.state in (TASK_FINISHED, TASK_FAILED):
            # terminal transition -> timeline. Emitted from the WORKER'S
            # calling context, so a live repair span's trace id rides along
            # and `cfs-events --correlate <trace>` joins the rebuild-finished
            # event to its repair trace
            from chubaofs_tpu_torch.utils import events

            if t.state == TASK_FINISHED:
                events.emit("task_finished", entity=t.task_id,
                            detail={"kind": t.kind, "vid": t.vid,
                                    "bid": t.bid, "disk_id": t.disk_id,
                                    "retries": t.retries})
            else:
                events.emit("task_failed", events.SEV_CRITICAL,
                            entity=t.task_id,
                            detail={"kind": t.kind, "vid": t.vid,
                                    "bid": t.bid, "disk_id": t.disk_id,
                                    "retries": t.retries, "error": t.error})
        return True

    def _update_gauges_locked(self) -> None:
        """cfs_scheduler_tasks{kind,state} gauges over the (bounded) table —
        the cfs-stat repair rollup's task inventory."""
        counts: dict[tuple[str, str], int] = {}
        for t in self._tasks.values():
            counts[(t.kind, t.state)] = counts.get((t.kind, t.state), 0) + 1
        reg = registry("scheduler")
        for kind in _PRIORITY:
            for state in _TASK_STATES:
                reg.gauge("tasks", {"kind": kind, "state": state}).set(
                    counts.get((kind, state), 0))

    # -- detection drivers (scrub + heartbeat expiry) -------------------------

    def run_scrub(self, max_shards: int = 256) -> int:
        """One budgeted scrub tick across every reachable blobnode: each
        node re-reads up to max_shards live shards through its crc32block
        framing (cursor-resumable, CFS_SCRUB_RATE-limited — see
        BlobNode.scrub_once) and every CRC failure feeds the repair topic.
        This is the datainspect.go half of detection: it finds bitrot
        without waiting for a client GET or a full inspector sweep."""
        from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_VOL_INSPECT

        if not self.switches.enabled(SWITCH_VOL_INSPECT):
            return 0
        produced = 0
        for node in list(self.nodes.values()):
            try:
                res = node.scrub_once(max_shards=max_shards)
            except Exception:
                continue  # dark/closed engine: its restart resumes the cursor
            for vuid, bid in res["bad"]:
                vid, idx, _ = parse_vuid(vuid)
                try:
                    self.proxy.send_shard_repair(vid, bid, [idx], "scrub")
                    produced += 1
                except Exception:
                    pass  # proxy down: the next sweep re-finds it
        if produced:
            registry("scheduler").counter("scrub_findings").add(produced)
        return produced

    def check_node_health(self, timeout_s: float | None = None) -> list[int]:
        """Mark disks whose heartbeats went silent as BROKEN (the
        kill-a-blobnode detection path): a dead engine stops heartbeating,
        its disks expire, and check_disks turns them into disk-repair tasks.
        Returns the disk ids newly marked broken."""
        timeout = self.hb_timeout_s if timeout_s is None else timeout_s
        if timeout <= 0:
            return []
        stale = self.cm.expire_heartbeats(timeout)
        if stale:
            registry("scheduler").counter("hb_expired_disks").add(len(stale))
        return stale

    # -- blob deleter ---------------------------------------------------------

    def run_deleter(self, max_msgs: int = 64) -> int:
        """Consume delete messages -> mark-delete then punch-hole on blobnodes
        (blob_deleter.go two-phase analog)."""
        from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_BLOB_DELETE

        if not self.switches.enabled(SWITCH_BLOB_DELETE):
            return 0
        topic = self.proxy.topics[TOPIC_BLOB_DELETE]
        msgs = topic.consume("deleter", max_msgs)
        for m in msgs:
            # a deleted blob leaves EVERY tier. Order matters on a daemon,
            # where GETs serve CONCURRENTLY with this loop: (1) note the
            # delete so an in-flight tier promote re-checks it, (2) drop
            # the hot replica copy, (3) punch the EC shards, (4) invalidate
            # the cache LAST — an invalidate-before-punch would let a GET
            # in the gap refill the cache from the still-readable shards
            # under the post-bump version, and nothing would ever evict
            # those bytes again (the gateway's own delete() already did the
            # pre-delete write-through invalidation for its clients)
            key = (m["vid"], m["bid"])
            with self._lock:
                self._deleted_recent[key] = None
                while len(self._deleted_recent) > 4096:
                    self._deleted_recent.popitem(last=False)
            self._drop_hot_copy(*key)
            vol = self.cm.get_volume(m["vid"])
            for unit in vol.units:
                node = self.nodes.get(unit.node_id)
                if node is None:
                    continue
                try:
                    node.mark_delete_shard(unit.vuid, m["bid"])
                    node.delete_shard(unit.vuid, m["bid"])
                except Exception:
                    pass  # already gone or never written; repair owns the rest
            if self.cache is not None:
                self.cache.invalidate(*key)
        topic.commit("deleter", len(msgs))
        return len(msgs)

    def _recently_deleted(self, vid: int, bid: int) -> bool:
        with self._lock:
            return (vid, bid) in self._deleted_recent

    # -- tier migration (the cache plane's promoter/demoter) ----------------------

    def run_tier(self, max_msgs: int = 64) -> int:
        """One tier sweep: drain the hot-blob topic into promote tasks for
        blobs not yet resident in the hot engine, and create demote tasks
        for promoted blobs whose heat signal has been silent for
        demote_sweeps consecutive sweeps. Worker execution rides the same
        lease machinery as repair (acquire -> lease -> report)."""
        from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_TIER_MIGRATE

        topic = self.proxy.topics[TOPIC_BLOB_HOT]
        # drain the topic FULLY: the idle-demote counter below reads "no
        # signal this sweep" as cooling, so a partial batch under signal
        # backlog would demote genuinely hot blobs whose messages merely
        # sat past the batch boundary (then re-promote them — churn)
        msgs: list[dict] = []
        while True:
            batch = topic.consume("tier", max_msgs)
            if not batch:
                break
            topic.commit("tier", len(batch))
            msgs.extend(batch)
        if not self.switches.enabled(SWITCH_TIER_MIGRATE):
            # consumed-and-DISCARDED: heat signals are advisory, and the
            # access layer keeps producing them while a cache is armed —
            # leaving them unconsumed would grow hot.jsonl without bound
            # and dump an hours-stale backlog on the sweep that re-enables
            return 0
        hot_now = {(m["vid"], m["bid"]): m.get("size", 0) for m in msgs}
        promoted = self.cm.hot_blobs()
        with self._lock:
            open_keys = {
                (t.vid, t.bid)
                for t in self._tasks.values()
                if t.kind in (KIND_TIER_PROMOTE, KIND_TIER_DEMOTE)
                and t.state not in (TASK_FINISHED, TASK_FAILED)
            }
        for (vid, bid), size in sorted(hot_now.items()):
            if (vid, bid) in promoted or (vid, bid) in open_keys:
                continue
            open_keys.add((vid, bid))
            self._new_task(kind=KIND_TIER_PROMOTE, vid=vid, bid=bid, size=size)
        demote: list[tuple[int, int]] = []
        with self._lock:
            # drop idle entries for blobs no longer promoted (demoted or
            # deleted behind our back) so the table tracks the tier map
            for key in [k for k in self._tier_idle if k not in promoted]:
                del self._tier_idle[key]
            for key in promoted:
                if key in hot_now:
                    self._tier_idle[key] = 0
                    continue
                n = self._tier_idle.get(key, 0) + 1
                self._tier_idle[key] = n
                if n >= self.demote_sweeps and key not in open_keys:
                    demote.append(key)
                    del self._tier_idle[key]
        for vid, bid in demote:
            self._new_task(kind=KIND_TIER_DEMOTE, vid=vid, bid=bid)
        return len(msgs)

    def _drop_hot_copy(self, vid: int, bid: int) -> None:
        """Demote-and-free: drop the tier-map redirect FIRST (readers fall
        back to the authoritative EC copy), then best-effort delete the
        replica shards — an unreachable hot node leaks bytes until its
        chunk is re-imaged, never correctness."""
        if self.cm.hot_location(vid, bid) is None:
            # the common case (never promoted): skip the demote apply —
            # it would mint a durable no-op WAL record per blob delete.
            # Race-safe vs an in-flight promote: the deleter notes the key
            # in _deleted_recent BEFORE calling here, and _tier_promote
            # re-checks that note after committing its redirect
            return
        hot = self.cm.demote_blob(vid, bid)
        if hot is None:
            return
        hot_vid, hot_bid = hot
        from chubaofs_tpu_torch.utils import events

        events.emit("tier_demote", entity=f"blob({vid},{bid})",
                    detail={"vid": vid, "bid": bid, "hot_vid": hot_vid,
                            "hot_bid": hot_bid})
        try:
            vol = self.cm.get_volume(hot_vid)
        except Exception:
            return
        for unit in vol.units:
            node = self.nodes.get(unit.node_id)
            if node is None:
                continue
            try:
                node.mark_delete_shard(unit.vuid, hot_bid)
                node.delete_shard(unit.vuid, hot_bid)
            except Exception:
                pass
        registry("cache").counter("demotes").add()


class RepairWorker:
    """Executes repair/migrate tasks with batched device reconstructs.

    Reference: blobnode's embedded worker (task_runner.go:171,
    work_shard_recover.go:399-547). The device-side differences: one task's
    stripes are stacked into large (B, n, k) reconstruct batches instead of
    per-stripe loops, and bulk migrates run a WINDOWED pipeline — up to
    CFS_REPAIR_WINDOW stripes' survivor downloads in flight while earlier
    stripes decode on the device (the PUT pipeline's window pattern applied
    to repair-GET). Every task runs under a `scheduler.repair` span whose
    `download` stages and the codec's `codec.*` stages (codec/service.py)
    let cfs-trace prove the overlap.
    """

    def __init__(self, sched: Scheduler, nodes: dict[int, BlobNode],
                 codec: CodecService | None = None,
                 read_deadline: float = 3.0,
                 repair_window: int | None = None):
        self.sched = sched
        self.cm = sched.cm
        self.nodes = nodes
        self.codec = codec or sched.codec
        # every survivor read races this deadline: a wedged blobnode turns
        # into a typed probe_fail{timeout}, never a silent stall
        self.read_deadline = read_deadline
        if repair_window is None:
            repair_window = int(os.environ.get("CFS_REPAIR_WINDOW", "4"))
        self.repair_window = repair_window  # 0/1 = serial gather
        # stripe-level window workers (one per in-flight gather) and the
        # shard-read fan-out pool they share; both bounded so one repair
        # task can't monopolize a host
        self._stripe_pool = ThreadPoolExecutor(
            max_workers=max(1, repair_window or 1),
            thread_name_prefix="repair-stripe")
        self._shard_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="repair-io")

    def set_repair_window(self, window: int) -> None:
        """Change the stripe window AND resize the pool that realizes it —
        assigning repair_window bare would leave a pool sized for the old
        window silently serializing (or over-parallelizing) the gathers."""
        if window == self.repair_window:
            return
        self.repair_window = window
        old = self._stripe_pool
        self._stripe_pool = ThreadPoolExecutor(
            max_workers=max(1, window or 1),
            thread_name_prefix="repair-stripe")
        old.shutdown(wait=False)

    def close(self) -> None:
        """Shut down the worker's executors (racelint: unjoined-thread).
        wait=False mirrors Access.close — a read wedged on a dead node must
        not stall teardown; it fails on its own deadline."""
        self._stripe_pool.shutdown(wait=False)
        self._shard_pool.shutdown(wait=False)

    def run_once(self) -> bool:
        """Process one task; failures are recorded on the task, never raised —
        one poisoned stripe must not stall the background plane. The whole
        task executes under a root span so repair traces are analyzable, and
        the report carries the ACQUIRE-time lease: if the lease expired and
        the reaper re-queued the task mid-flight, this report is dropped as
        stale (idempotent write-back makes the re-execution safe)."""
        task = self.sched.acquire_task()
        if task is None:
            return False
        lease = task.lease  # capture NOW: the field advances on re-lease
        reg = registry("scheduler")
        with trace.child_of(trace.current_span(), "scheduler.repair") as span:
            span.set_tag("task", task.task_id)
            span.set_tag("kind", task.kind)
            span.set_tag("window", self.repair_window)
            ok, err = True, ""
            try:
                if task.kind == KIND_SHARD_REPAIR:
                    self._repair_shards(task.vid, task.bid, task.bad_idx)
                elif task.kind == KIND_BALANCE:
                    self._balance_unit(task)
                elif task.kind in (KIND_DISK_REPAIR, KIND_DISK_DROP):
                    self._migrate_disk(task, lease)
                elif task.kind == KIND_TIER_PROMOTE:
                    self._tier_promote(task, lease)
                elif task.kind == KIND_TIER_DEMOTE:
                    self.sched._drop_hot_copy(task.vid, task.bid)
            except Exception as e:
                ok, err = False, f"{type(e).__name__}: {e}"
            ratio = stage_overlap_ratio(span.stages)
            if ratio is not None:
                span.set_tag("overlap_ratio", round(ratio, 3))
                reg.summary("repair_overlap_ratio",
                            buckets=RATIO_BUCKETS).observe(ratio)
            self.sched.report_task(task.task_id, ok, error=err, lease=lease)
        return True

    # -- tier promotion (EC cold copy -> Replica3 hot engine) ------------------

    def _tier_promote(self, task: Task, lease: int | None = None):
        """Copy one sustained-hot blob into the 3-replica hot engine: read
        its data region off the EC stripe (reconstructing around any damage
        — a hot blob deserves promotion even while degraded), trim to the
        blob's true size, encode the systematic RS(1,2) replica stripe, and
        land it on a Replica3 volume before committing the redirect.
        Idempotent: a re-executed task (lease expiry, crash) sees the
        redirect and returns; a half-written replica set is unreachable
        until promote_blob commits, and put_shard punch-and-append makes
        the rewrite safe."""
        from chubaofs_tpu_torch.codec.codemode import CodeMode, get_tactic

        if self.cm.hot_location(task.vid, task.bid) is not None:
            return
        if self.sched._recently_deleted(task.vid, task.bid):
            return  # the blob is going/gone; don't resurrect it hot
        span = trace.current_span()
        vol = self.cm.get_volume(task.vid)
        t = vol.tactic()
        reads = self._probe(vol, task.bid, range(t.N), span=span)
        if len(reads) == t.N:
            payload = b"".join(reads[i] for i in range(t.N))
        else:
            stripe, present, _ = self._gather(vol, t, task.bid, span=span)
            missing = [i for i in range(t.N + t.M) if i not in present]
            if missing:
                stripe = self.codec.reconstruct_tactic(
                    t, stripe, missing, data_only=True).result()
            payload = stripe[: t.N].reshape(-1).tobytes()
        if task.size > 0:
            payload = payload[: task.size]  # strip the EC stripe padding
        # a big-blob promote on a degraded stripe (gather + reconstruct)
        # can outlive one lease: renew before the replica writes, like
        # _migrate_disk renews per unit — a lost lease means the reaper
        # may have re-leased this task, and the re-execution owns it now
        if lease is not None and \
                not self.sched.renew_lease(task.task_id, lease):
            raise RuntimeError(
                f"lease {lease} lost mid-promote of ({task.vid}, {task.bid})")
        rt = get_tactic(CodeMode.Replica3)
        mat = np.frombuffer(payload, np.uint8).reshape(1, -1)
        full = self.codec.encode_tactic(rt, mat).result()
        hot_vol = self.cm.alloc_volume(int(CodeMode.Replica3))
        hot_bid, _ = self.cm.alloc_scope("bid", 1)
        wrote: set[int] = set()
        for i, unit in enumerate(hot_vol.units):
            node = self.nodes.get(unit.node_id)
            if node is None:
                continue
            try:
                node.create_vuid(unit.vuid, unit.disk_id)
                node.put_shard(unit.vuid, hot_bid, full[i].tobytes())
                wrote.add(i)
            except Exception:
                continue
        # shard 0 is NOT optional: the hot read path serves only the data
        # shard, so a redirect whose data replica never landed would send
        # every GET through a failed hot read before the EC fallback —
        # worse than no promotion at all
        if len(wrote) < rt.put_quorum or 0 not in wrote:
            # take the landed shards back out before failing: no redirect
            # references them, so nothing else ever would — and every
            # retry allocs a FRESH hot_bid, so leaked sets would pile up
            for i in wrote:
                unit = hot_vol.units[i]
                node = self.nodes.get(unit.node_id)
                if node is None:
                    continue
                try:
                    node.mark_delete_shard(unit.vuid, hot_bid)
                    node.delete_shard(unit.vuid, hot_bid)
                except Exception:
                    pass  # best effort; the write just succeeded here
            raise RuntimeError(
                f"hot promote of ({task.vid}, {task.bid}): wrote "
                f"{sorted(wrote)}/{rt.total} replicas, quorum "
                f"{rt.put_quorum} incl. the data shard")
        winner = self.cm.promote_blob(task.vid, task.bid, hot_vol.vid,
                                      hot_bid)
        if winner != (hot_vol.vid, hot_bid):
            # first committer won (a re-leased execution of this task beat
            # us past the lease backstop): OUR replica set is the orphan —
            # free it; the winner's redirect stands untouched
            for i in wrote:
                unit = hot_vol.units[i]
                node = self.nodes.get(unit.node_id)
                if node is None:
                    continue
                try:
                    node.mark_delete_shard(unit.vuid, hot_bid)
                    node.delete_shard(unit.vuid, hot_bid)
                except Exception:
                    pass
            return
        # delete-race re-check AFTER the commit: the deleter notes the key
        # BEFORE its own _drop_hot_copy, so either it sees our redirect
        # (and removes it) or we see its note here (and remove it) — a
        # promote racing a delete can never leave a dangling hot copy
        # serving a deleted blob's bytes
        if self.sched._recently_deleted(task.vid, task.bid):
            self.sched._drop_hot_copy(task.vid, task.bid)
            raise RuntimeError(
                f"blob ({task.vid}, {task.bid}) deleted during promote")
        registry("cache").counter("promotes").add()
        registry("cache").counter("promote_bytes").add(len(payload))
        from chubaofs_tpu_torch.utils import events

        events.emit("tier_promote", entity=f"blob({task.vid},{task.bid})",
                    detail={"vid": task.vid, "bid": task.bid,
                            "hot_vid": hot_vol.vid, "hot_bid": hot_bid,
                            "bytes": len(payload)})

    # -- single-stripe shard repair -------------------------------------------

    def _repair_shards(self, vid: int, bid: int, bad_idx: list[int]):
        vol = self.cm.get_volume(vid)
        t = vol.tactic()
        unhandled = sorted(set(bad_idx))
        if t.L:
            unhandled = self._repair_local_stripes(vol, t, bid, unhandled)
            if not unhandled:
                return
        if t.is_regenerating and len(unhandled) == 1:
            # the repair-traffic win: a single loss under a regenerating
            # mode downloads d beta payloads, not N full shards. Multi-loss
            # (or any helper failure) falls through to the generic gather.
            if self._repair_regenerating(vol, t, bid, unhandled[0]):
                return
        elif t.is_regenerating and len(unhandled) > 1:
            registry("scheduler").counter(
                "repair_beta_fallback", {"reason": "multi_loss"}).add()
        self._repair_global(vol, t, bid)

    def _repair_local_stripes(self, vol: VolumeInfo, t, bid: int,
                              bad_idx: list[int]) -> list[int]:
        """LRC local-stripe-first repair (work_shard_recover.go:517
        recoverByLocalStripe): for each AZ whose damage fits its local parity
        budget, repair reading ONLY that AZ's shards. Returns the reported bad
        indexes that still need the global path."""
        span = trace.current_span()
        leftover: list[int] = []
        for idx, local_n, local_m in t.local_stripes():
            az_reported = [i for i in bad_idx if i in idx]
            if not az_reported:
                continue
            reads = self._probe(vol, bid, idx, span=span)  # same-AZ reads only
            az_bad = [i for i in idx if i not in reads]
            if not az_bad:
                continue
            if len(az_bad) > local_m:
                leftover.extend(az_reported)  # beyond local budget
                continue
            shard_len = len(next(iter(reads.values())))
            sub = np.zeros((len(idx), shard_len), np.uint8)
            pos = {g: p for p, g in enumerate(idx)}
            for g, data in reads.items():
                sub[pos[g]] = np.frombuffer(data, np.uint8)
            fixed = self.codec.reconstruct(
                local_n, local_m, sub, [pos[i] for i in az_bad]
            ).result()
            for g in az_bad:
                self._write_back(vol, g, bid, fixed[pos[g]].tobytes())
            # the repair-traffic win the LRC layout buys: these shards were
            # healed reading ONE local group, not the global stripe
            registry("scheduler").counter(
                "repair_local_shards").add(len(az_bad))
        return leftover

    def _repair_global(self, vol: VolumeInfo, t, bid: int):
        """Global-stripe repair + recompute of any missing local parities."""
        span = trace.current_span()
        stripe, present, shard_len = self._gather(vol, t, bid, span=span)
        missing = [i for i in range(t.N + t.M) if i not in present]
        if missing:
            fixed = self.codec.reconstruct_tactic(t, stripe, missing).result()
            for idx in missing:
                self._write_back(vol, idx, bid, fixed[idx].tobytes())
            stripe = fixed
            registry("scheduler").counter(
                "repair_global_shards").add(len(missing))
        if t.L:
            # local parities live outside the global stripe: any missing one is
            # recomputed from its AZ's (now whole) global shards
            local_idx = list(range(t.global_count, t.total))
            have = self._probe(vol, bid, local_idx, span=span)
            lost_azs = {t.az_of_shard(i) for i in local_idx if i not in have}
            local_n = (t.N + t.M) // t.az_count
            local_m = t.L // t.az_count
            for idx, _, _ in t.local_stripes():
                az = t.az_of_shard(idx[0])
                if az not in lost_azs:
                    continue
                src = stripe[idx[:local_n]]
                full = self.codec.encode(local_n, local_m, src).result()
                for p, g in enumerate(idx[local_n:]):
                    if g not in have:
                        self._write_back(vol, g, bid, full[local_n + p].tobytes())

    def _write_back(self, vol: VolumeInfo, idx: int, bid: int, payload: bytes):
        """Idempotent by construction: put_shard over an existing bid punches
        the superseded record and appends the same bytes, so a re-executed
        task (lease expiry, crash-restart) can never corrupt the stripe."""
        unit = vol.units[idx]
        node = self.nodes[unit.node_id]
        node.create_vuid(unit.vuid, unit.disk_id)
        node.put_shard(unit.vuid, bid, payload)
        registry("scheduler").counter("repaired_shards").add()

    def _read_one(self, vol: VolumeInfo, idx: int, bid: int) -> bytes:
        unit = vol.units[idx]
        node = self.nodes.get(unit.node_id)
        if node is None:
            raise ConnectionError(f"node {unit.node_id} unknown")
        return node.get_shard(unit.vuid, bid)

    def _drain_reads(self, futs: dict, out: dict, need: int | None = None) -> list:
        """Drain a {key: Future-of-bytes} fan-out under ONE shared
        read_deadline: successes land in `out` and feed the repair-traffic
        byte accounting; absent/unreachable/hung reads are returned as
        leftover keys, counted by failure class
        (cfs_scheduler_probe_fail{reason}) so a silent hang and a real bug
        stop being indistinguishable. The one timeout/cancel/classify
        block both _probe and _copy_direct ride — their semantics must
        never diverge.

        `need` is how many successes the decode strictly requires: bytes
        beyond it are HEDGES (straggler insurance) and count to
        repair_bytes_hedged instead of repair_bytes_downloaded, so
        bytes-per-repaired-shard stays an honest numerator. None = every
        read is required."""
        reg = registry("scheduler")
        deadline = time.monotonic() + self.read_deadline
        leftover = []
        got = 0
        for key, f in futs.items():
            try:
                data = f.result(timeout=max(0.0, deadline - time.monotonic()))
            except FutureTimeout:
                f.cancel()  # queued laggards release their pool slot
                reg.counter("probe_fail", {"reason": "timeout"}).add()
                leftover.append(key)
                continue
            except Exception as e:
                reg.counter("probe_fail",
                            {"reason": classify_io_error(e)}).add()
                leftover.append(key)
                continue
            out[key] = data
            got += 1
            if need is not None and got > need:
                reg.counter("repair_bytes_hedged").add(len(data))
            else:
                reg.counter("repair_bytes_downloaded").add(len(data))
        return leftover

    def _probe(self, vol: VolumeInfo, bid: int, idxs,
               span=None, need: int | None = None) -> dict[int, bytes]:
        """Read the given stripe positions CONCURRENTLY via _drain_reads;
        the whole fan-out lands on the span as a `download` stage."""
        idxs = list(idxs)
        if not idxs:
            return {}
        t0 = time.perf_counter()
        futs = {i: self._shard_pool.submit(self._read_one, vol, i, bid)
                for i in idxs}
        reads: dict[int, bytes] = {}
        self._drain_reads(futs, reads, need=need)
        if span is not None:
            span.add_stage("download", start=t0)
        return reads

    def _gather(self, vol: VolumeInfo, t, bid: int, span=None):
        """Read every readable global shard of a stripe; infer shard_len.
        Decode needs only N rows — the extra M reads are hedges and are
        accounted as such (_drain_reads need=N)."""
        reads = self._probe(vol, bid, range(t.N + t.M), span=span, need=t.N)
        if len(reads) < t.N:
            raise RuntimeError(f"stripe {vol.vid}/{bid}: {len(reads)} < N={t.N} readable")
        shard_len = len(next(iter(reads.values())))
        stripe = np.zeros((t.N + t.M, shard_len), np.uint8)
        for idx, data in reads.items():
            stripe[idx] = np.frombuffer(data, np.uint8)
        return stripe, sorted(reads), shard_len

    # -- beta-fetch repair (regenerating modes, codec/pm.py) -------------------

    def _read_combined(self, vol: VolumeInfo, idx: int, bid: int,
                       coeffs: bytes) -> bytes:
        unit = vol.units[idx]
        node = self.nodes.get(unit.node_id)
        if node is None:
            raise ConnectionError(f"node {unit.node_id} unknown")
        return node.get_shard_combined(unit.vuid, bid, coeffs)

    def _gather_beta(self, vol: VolumeInfo, t, bid: int, fail: int,
                     span=None):
        """Beta-fetch gather for a SINGLE lost shard of a regenerating
        stripe: the layout-aware helper set (Tactic.helper_set — same-AZ
        first) each ships its beta = shard/alpha combined payload
        (BlobNode.get_shard_combined). Returns (helpers, payloads (d, beta))
        or None when the survivors can't field d helpers or any helper read
        fails — the caller then falls back to the full-stripe gather, which
        needs only N of the survivors."""
        from chubaofs_tpu_torch.codec import pm

        reg = registry("scheduler")

        def usable(i: int) -> bool:
            u = vol.units[i]
            if u.node_id not in self.nodes:
                return False
            d = self.cm.disks.get(u.disk_id)
            return d is None or d.status == DISK_NORMAL

        alive = [i for i in range(t.global_count)
                 if i != fail and usable(i)]
        helpers = t.helper_set(fail, alive)
        if not helpers:
            reg.counter("repair_beta_fallback",
                        {"reason": "helpers_short"}).add()
            return None
        kernel = pm.get_kernel(t.total, t.N)
        coeffs = kernel.helper_coeffs(fail).tobytes()
        t0 = time.perf_counter()
        futs = {i: self._shard_pool.submit(
                    self._read_combined, vol, i, bid, coeffs)
                for i in helpers}
        reads: dict[int, bytes] = {}
        # every helper is load-bearing (the repair matrix inverts exactly
        # these d rows): need=len so none of these bytes count as hedged
        self._drain_reads(futs, reads, need=len(helpers))
        if span is not None:
            span.add_stage("download", start=t0)
        if len(reads) < len(helpers):
            reg.counter("repair_beta_fallback", {"reason": "read_fail"}).add()
            return None
        payloads = np.stack(
            [np.frombuffer(reads[i], np.uint8) for i in helpers])
        from chubaofs_tpu_torch.codec.codemode import CodeMode

        reg.counter("repair_helper_bytes",
                    {"mode": CodeMode(vol.code_mode).name}).add(
            int(payloads.size))
        return helpers, payloads

    def _repair_regenerating(self, vol: VolumeInfo, t, bid: int,
                             fail: int) -> bool:
        """Single-loss beta repair: d combined sub-shard reads, ONE
        (alpha, d) matmul decode through the codec service, write back.
        Returns False (nothing written) when the beta path can't run —
        _repair_global then handles the stripe generically."""
        from chubaofs_tpu_torch.codec import pm

        span = trace.current_span()
        got = self._gather_beta(vol, t, bid, fail, span=span)
        if got is None:
            return False
        helpers, payloads = got
        kernel = pm.get_kernel(t.total, t.N)
        mat = kernel.repair_matrix(fail, helpers)
        fixed = self.codec.matmul(mat, payloads).result()
        self._write_back(vol, fail, bid, fixed.reshape(-1).tobytes())
        registry("scheduler").counter("repair_beta_shards").add()
        return True

    # -- disk-level migrate (bulk; the 10k-stripe batch path) ------------------

    def _migrate_disk(self, task: Task, lease: int | None = None):
        """Move every stripe position off a disk.

        Order matters: GATHER (and copy/reconstruct) the rows through the OLD
        units first — for a drop of a healthy disk that's a plain read-copy —
        and only then re-home the units in clustermgr. A crash mid-task
        leaves every uncommitted unit's old mapping intact and the task
        retryable. The prepare/commit split is also the cross-unit pipeline:
        while unit k's reconstructs drain through the device, unit k+1's
        survivor downloads are already in flight — with few bids per unit,
        this (not the intra-unit window) is where the overlap comes from."""
        source_broken = self.cm.disks[task.disk_id].status != DISK_NORMAL
        affected = self.cm.volumes_on_disk(task.disk_id)
        # bounded prepare-ahead: holding every unit's reconstructed rows at
        # once would scale memory with the whole disk, not the window.
        # window <= 1 means the SERIAL control path — depth 1, no cross-unit
        # overlap either, so the bench A/B measures what it claims to
        window = self.repair_window or 0
        depth = max(2, window) if window > 1 else 1
        pending: deque = deque()
        for vol, unit in affected:
            # a disk migrate routinely outlives one lease: renew per unit so
            # a HEALTHY worker never races the reaper; a lost lease (we were
            # reaped and possibly re-leased) aborts — the work is someone
            # else's now, and idempotent write-back keeps the abort safe
            if lease is not None and \
                    not self.sched.renew_lease(task.task_id, lease):
                raise RuntimeError(
                    f"lease {lease} lost mid-migrate of disk {task.disk_id}")
            pending.append(
                self._prepare_unit(vol, unit, task.disk_id, source_broken))
            if len(pending) >= depth:
                self._commit_unit(pending.popleft(), task.disk_id)
        while pending:
            self._commit_unit(pending.popleft(), task.disk_id)
        self.cm.set_disk_status(task.disk_id, DISK_DROPPED)

    def _balance_unit(self, task: Task):
        """Move ONE volume unit off an (otherwise healthy) overloaded disk."""
        vol = self.cm.get_volume(task.vid)
        unit = next((u for u in vol.units if u.disk_id == task.disk_id), None)
        if unit is None:
            # a previous attempt already re-homed the mapping but may have
            # died mid-copy (mapping updates before the shard writes): sweep
            # the volume's stripes through the repair plane rather than
            # declaring victory over a silently degraded stripe
            self._enqueue_missing(vol)
            return
        source_broken = self.cm.disks[task.disk_id].status != DISK_NORMAL
        prep = self._prepare_unit(vol, unit, task.disk_id, source_broken)
        self._commit_unit(prep, task.disk_id,
                          dest_disk_id=task.dest_disk_id)

    def _enqueue_missing(self, vol: VolumeInfo):
        """Probe every stripe position of every bid in the volume; feed any
        missing/unreadable position to the repair topic."""
        t = vol.tactic()
        bids: set[int] = set()
        for u in vol.units:
            node = self.nodes.get(u.node_id)
            if node is None:
                continue
            try:
                bids.update(m.bid for m in node.list_shards(u.vuid))
            except Exception:
                continue
        for bid in sorted(bids):
            have = self._probe(vol, bid, range(t.total))
            bad = [i for i in range(t.total) if i not in have]
            if bad:
                self.sched.proxy.send_shard_repair(vol.vid, bid, bad,
                                                   "balance_retry")

    def _copy_direct(self, vol: VolumeInfo, unit, bids: list[int],
                     rows: dict[int, bytes]) -> list[int]:
        """Healthy-source fast path: CONCURRENT bounded reads of the unit's
        own rows via _drain_reads (a serial loop here would pay
        read_deadline per slow bid, not per unit). Returns the bids that
        still need the gather/reconstruct pipeline."""
        node = self.nodes.get(unit.node_id)
        if node is None:
            return list(bids)
        futs = {bid: self._shard_pool.submit(node.get_shard, unit.vuid, bid)
                for bid in bids}
        return self._drain_reads(futs, rows)

    def _gather_for_unit(self, vol: VolumeInfo, t, unit, bid: int,
                         span=None):
        """Mode-aware stripe gather for the migrate/rebuild pipeline: a
        regenerating volume first tries the beta-fetch for the migrating
        unit's row (d combined payloads instead of a full-stripe gather —
        the bulk-rebuild path is where nearly all repair bytes move) and
        falls back to the full gather when helpers can't cover it."""
        if t.is_regenerating and unit.index < t.global_count:
            got = self._gather_beta(vol, t, bid, unit.index, span=span)
            if got is not None:
                return ("beta",) + got
        return ("full", self._gather(vol, t, bid, span=span))

    def _stripe_row(self, vol: VolumeInfo, t, unit, bid: int, gathered,
                    rows: dict[int, bytes], futures: dict[int, object]):
        """Turn one gathered stripe into the migrating unit's row: a present
        survivor copies, a lost global shard becomes a (batchable) device
        reconstruct future, a lost local parity re-encodes its AZ stripe.
        A beta-gather (regenerating modes) becomes the (alpha, d) repair
        matmul — batchable on the device exactly like the RS decodes."""
        from concurrent.futures import Future

        if gathered[0] == "beta":
            _, helpers, payloads = gathered
            from chubaofs_tpu_torch.codec import pm

            kernel = pm.get_kernel(t.total, t.N)
            mat = kernel.repair_matrix(unit.index, helpers)
            mm = self.codec.matmul(mat, payloads)
            # _commit_unit resolves futures as result()[unit.index]: deliver
            # the single rebuilt row under that key (a dict indexes the same
            # way a full stripe array does)
            out: Future = Future()
            idx = unit.index

            def _fin(f: Future, out=out, idx=idx):
                if f.exception():
                    out.set_exception(f.exception())
                else:
                    out.set_result({idx: f.result().reshape(-1)})

            mm.add_done_callback(_fin)
            futures[bid] = out
            registry("scheduler").counter("repair_beta_shards").add()
            return
        stripe, present, _ = gathered[1]
        missing = [i for i in range(t.N + t.M) if i not in present]
        if unit.index in present:
            rows[bid] = stripe[unit.index].tobytes()
        elif unit.index < t.global_count:
            # repair with the FULL missing set: zero-filled absent rows
            # must never be treated as survivors
            futures[bid] = self.codec.reconstruct_tactic(t, stripe, missing)
        else:
            # LRC local parity: complete the globals, then re-encode
            # this AZ's local stripe to regenerate the lost row
            if missing:
                stripe = self.codec.reconstruct(t.N, t.M, stripe, missing).result()
            local_n = (t.N + t.M) // t.az_count
            local_m = t.L // t.az_count
            for idx, _, _ in t.local_stripes():
                if unit.index in idx:
                    full = self.codec.encode(
                        local_n, local_m, stripe[idx[:local_n]]
                    ).result()
                    pos = idx[local_n:].index(unit.index)
                    rows[bid] = full[local_n + pos].tobytes()
                    break

    def _rebuild_rows(self, vol: VolumeInfo, t, unit, bids: list[int],
                      rows: dict[int, bytes], futures: dict[int, object]):
        """The windowed rebuild pipeline (the _put_pipelined window pattern
        applied to repair-GET): up to repair_window stripes' survivor
        gathers run on the stripe pool while earlier stripes' reconstructs
        drain through the codec service's device batches — downloads never
        idle waiting on decode, decode never starves waiting on the network.
        Consumption is bid order, so write-back order is deterministic.
        repair_window <= 1 degenerates to the serial control path."""
        if not bids:
            return
        span = trace.current_span()
        window = self.repair_window
        if window <= 1:
            for bid in bids:
                self._stripe_row(vol, t, unit, bid,
                                 self._gather_for_unit(vol, t, unit, bid,
                                                       span=span),
                                 rows, futures)
            return

        def gather_job(bid: int):
            # the task span follows the gather onto the pool worker so its
            # download stage (and any failpoint evidence) lands on the trace
            if span is not None:
                trace.push_span(span)
            try:
                return self._gather_for_unit(vol, t, unit, bid, span=span)
            finally:
                if span is not None:
                    trace.pop_span()

        occ = registry("scheduler").summary("rebuild_window_occupancy",
                                            buckets=BATCH_BUCKETS)
        pending: deque = deque()
        it = iter(bids)
        nxt = next(it, None)
        while pending or nxt is not None:
            while nxt is not None and len(pending) < window:
                pending.append((nxt, self._stripe_pool.submit(gather_job, nxt)))
                nxt = next(it, None)
            occ.observe(len(pending))
            bid, f = pending.popleft()
            self._stripe_row(vol, t, unit, bid, f.result(), rows, futures)

    def _prepare_unit(self, vol: VolumeInfo, unit, source_disk_id: int,
                      source_broken: bool) -> dict:
        """Phase 1 of a unit move: gather/copy every row and SUBMIT the
        reconstructs (decode futures left in flight — the codec service
        batches them into shared device calls, and the caller may start the
        next unit's downloads while they drain). No cluster state changes
        here: a crash after prepare leaves the old mapping untouched."""
        t = vol.tactic()
        # every bid in this volume, seen from any unit (source included when healthy)
        bids: set[int] = set()
        for u in vol.units:
            if u.disk_id == source_disk_id and source_broken:
                continue
            node = self.nodes.get(u.node_id)
            if node is None:
                continue
            try:
                bids.update(m.bid for m in node.list_shards(u.vuid))
            except Exception:
                continue
        # source copies or reconstruct futures. Tombstones TRAVEL with the
        # unit — enumerated DIRECTLY from the source chunk (they are
        # invisible to list_shards, so deriving them from live bids would
        # drop any delete whose bid no reachable unit still serves) — a bid
        # deleted at the source must stay deleted at the destination.
        src_node = self.nodes.get(unit.node_id)
        tombstoned: set[int] = set()
        if src_node is not None:
            try:
                tombstoned = src_node.tombstones_of(unit.vuid)
            except Exception:
                pass
        rows: dict[int, bytes] = {}
        futures: dict[int, object] = {}
        work = [b for b in sorted(bids) if b not in tombstoned]
        if not source_broken:
            work = self._copy_direct(vol, unit, work, rows)
        self._rebuild_rows(vol, t, unit, work, rows, futures)
        return {"vol": vol, "unit": unit, "rows": rows, "futures": futures,
                "tombstoned": tombstoned}

    def _commit_unit(self, prep: dict, source_disk_id: int,
                     dest_disk_id: int | None = None):
        """Phase 2: resolve the in-flight decodes, then re-home the unit in
        clustermgr and write everything to the new disk. The mapping update
        stays AFTER all reads/decodes so a failed prepare never half-moves."""
        vol, unit = prep["vol"], prep["unit"]
        rows, tombstoned = prep["rows"], prep["tombstoned"]
        for bid, fut in prep["futures"].items():
            rows[bid] = fut.result()[unit.index].tobytes()

        dest = dest_disk_id
        if dest is not None:
            # a destination pinned at scheduling time may have gone stale
            d = self.cm.disks.get(dest)
            if d is None or d.status != DISK_NORMAL or \
                    dest in {u.disk_id for u in vol.units}:
                dest = None
        if dest is None:
            dest = self._dest_for(vol, source_disk_id)
        old_vuid, old_node_id = unit.vuid, unit.node_id
        new_unit = self.cm.update_volume_unit(vol.vid, unit.index, dest)
        dest_node = self.nodes[new_unit.node_id]
        dest_node.create_vuid(new_unit.vuid, new_unit.disk_id)
        for bid, payload in rows.items():
            dest_node.put_shard(new_unit.vuid, bid, payload)
        registry("scheduler").counter("repaired_shards").add(len(rows))
        for bid in tombstoned:
            dest_node.tombstone_shard(new_unit.vuid, bid)
        # the move must FREE the source: drop the superseded chunk (best
        # effort — an unreachable/broken source just leaks until re-imaged)
        old_node = self.nodes.get(old_node_id)
        if old_node is not None:
            try:
                old_node.drop_vuid(old_vuid)
            except Exception:
                pass

    def _dest_for(self, vol: VolumeInfo, source_disk_id: int) -> int:
        vol_disks = {u.disk_id for u in vol.units}
        return self.sched.pick_dest_disk(
            exclude=vol_disks | {source_disk_id},
            az=self.cm.disks[source_disk_id].az,
        )
