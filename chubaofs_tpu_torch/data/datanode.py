"""DataNode — hosts replicated data partitions over disks.

Reference counterpart: datanode/ (doStart server.go:178, dispatch
wrap_operator.go:80, write :479, random-write via raft :562,594 +
partition_op_by_raft.go, SpaceManager space_manager.go, repair
data_partition_repair.go:80-481) over storage/'s ExtentStore.

Dual replication kept exactly as the reference splits it (SURVEY §2.4):
  * append writes + extent create/delete ride CHAIN replication — the client
    sends to the partition leader with the follower address list, the leader
    forwards before operating locally (chubaofs_tpu_torch/data/repl.py);
  * random in-place overwrites ride RAFT (one group per partition, group id =
    partition id, hosted on the node's MultiRaft) because overwrite order must
    be total (datanode/partition_op_by_raft.go).

Repair follows data_partition_repair.go:80: the leader gathers every
replica's watermarks, computes the per-extent max, streams missing suffixes
from the most advanced replica to laggards (streamRepairExtent :481), and
replays extent deletes + tiny punch-hole records."""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading

import time

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.blobstore import trace
from chubaofs_tpu_torch.data.repl import FollowerAckError, ReplError, ReplServer
from chubaofs_tpu_torch.proto.packet import (
    OP_CREATE_EXTENT, OP_CREATE_PARTITION, OP_GET_PARTITION_METRICS,
    OP_RAFT_CONFIG, OP_REMOVE_PARTITION,
    OP_GET_WATERMARKS, OP_HEARTBEAT, OP_MARK_DELETE, OP_RANDOM_WRITE,
    OP_REPAIR_READ, OP_REPAIR_WRITE, OP_STREAM_READ, OP_TINY_DELETE_RECORD,
    OP_WRITE, Packet, RES_DISK_ERR, RES_ERR, RES_NOT_EXIST, RES_NOT_LEADER,
    RES_OK, TRACE_ARG_KEY, is_tiny_extent, op_name, trace_extract,
    trace_reply,
)
from chubaofs_tpu_torch.utils.auditlog import record_slow_op
from chubaofs_tpu_torch.utils.exporter import registry
from chubaofs_tpu_torch.utils.locks import SanitizedLock
from chubaofs_tpu_torch.raft.server import MultiRaft, NotLeaderError, StateMachine
from chubaofs_tpu_torch.storage.extent_store import (
    ExtentNotFound, ExtentStore, MIN_NORMAL_EXTENT_ID, StorageError,
)

REPAIR_CHUNK = 1 << 20  # repair stream granularity


class DataPartitionSM(StateMachine):
    """Raft state machine for the random-write path.

    The extent files ARE the durable state (SURVEY §5: 'datanode — extents are
    the state; raft WAL for random writes'), so snapshots carry no payload and
    recovery = WAL replay over the on-disk extents (idempotent overwrites)."""

    def __init__(self, store: ExtentStore):
        self.store = store

    def apply(self, data, index: int):
        op = data[0]
        try:
            if op == "rw":
                _, eid, off, blob = data
                self.store.write(eid, off, blob, overwrite=True)
            elif op == "tiny_del":
                _, eid, off, size = data
                self.store.mark_delete(eid, off, size)
            return ("ok", None)
        except (StorageError, OSError) as e:
            return ("err", str(e))

    def snapshot(self) -> bytes:
        return b""

    def restore(self, data: bytes) -> None:
        pass


class DataPartition:
    """One replica of a data partition: extent store + peers + raft group."""

    def __init__(self, pid: int, root: str, peers: list[int], hosts: list[str],
                 raft: MultiRaft | None):
        self.pid = pid
        self.root = root
        self.peers = peers  # datanode node ids (raft membership)
        self.hosts = hosts  # datanode repl addresses, hosts[0] = leader
        self.raft = raft
        self.store = ExtentStore(root)
        self._id_lock = threading.Lock()
        self._meta_path = os.path.join(root, "meta.json")
        self._eid_path = os.path.join(root, "eid_counter")
        self._write_meta()
        # monotonic, persisted, never reused — concurrent OP_CREATE_EXTENT
        # handlers must not hand out the same id
        self._next_eid = self._load_eid_counter()
        if raft is not None:
            raft.create_group(pid, peers, DataPartitionSM(self.store))

    def _write_meta(self) -> None:
        with open(self._meta_path, "w") as f:
            json.dump({"pid": self.pid, "peers": self.peers, "hosts": self.hosts}, f)

    def update_membership(self, peers: list[int], hosts: list[str]) -> None:
        """Refresh replica addresses (hosts change across node restarts)."""
        self.peers = peers
        self.hosts = hosts
        self._write_meta()

    def _load_eid_counter(self) -> int:
        floor = MIN_NORMAL_EXTENT_ID
        if os.path.exists(self._eid_path):
            with open(self._eid_path) as f:
                floor = max(floor, int(f.read().strip() or 0))
        ids = set(self.store.extent_ids()) | self.store._deleted
        return max([floor - 1, *ids]) + 1

    @classmethod
    def load(cls, root: str, raft: MultiRaft | None) -> "DataPartition":
        with open(os.path.join(root, "meta.json")) as f:
            meta = json.load(f)
        return cls(meta["pid"], root, meta["peers"], meta["hosts"], raft)

    def alloc_extent_id(self) -> int:
        with self._id_lock:
            eid = self._next_eid
            self._next_eid += 1
            with open(self._eid_path, "w") as f:
                f.write(str(self._next_eid))
            return eid

    @property
    def is_raft_leader(self) -> bool:
        return self.raft is not None and self.raft.is_leader(self.pid)


class SpaceManager:
    """Disk set → partition placement (datanode/space_manager.go analog):
    a new partition lands on the disk with the most free space."""

    def __init__(self, disks: list[str]):
        self.disks = disks
        for d in disks:
            os.makedirs(d, exist_ok=True)
        self.partitions: dict[int, DataPartition] = {}
        # guards partition create/load: concurrent OP_CREATE_PARTITION
        # packets for one pid must not double-create the DataPartition (and
        # its raft group) — racelint check-then-act
        self._lock = SanitizedLock(name="datanode.space")

    def _pick_disk(self) -> str:
        # most free space, fewest hosted partitions as the tiebreak
        def key(d: str):
            hosted = sum(1 for p in self.partitions.values() if p.root.startswith(d))
            return (shutil.disk_usage(d).free, -hosted)

        return max(self.disks, key=key)

    def create_partition(self, pid: int, peers: list[int], hosts: list[str],
                         raft: MultiRaft | None) -> DataPartition:
        with self._lock:
            if pid in self.partitions:
                self.partitions[pid].update_membership(peers, hosts)
                return self.partitions[pid]
            root = os.path.join(self._pick_disk(), f"dp_{pid}")
            os.makedirs(root, exist_ok=True)
            dp = DataPartition(pid, root, peers, hosts, raft)
            self.partitions[pid] = dp
            return dp

    def load_all(self, raft: MultiRaft | None) -> None:
        with self._lock:
            for disk in self.disks:
                for name in os.listdir(disk):
                    if name.startswith("dp_"):
                        pid = int(name[3:])
                        if pid not in self.partitions:
                            self.partitions[pid] = DataPartition.load(
                                os.path.join(disk, name), raft)


class DataNode:
    """TCP packet server + partitions + repair loops."""

    # repair/migrate traffic class: bulk streams that must never starve
    # client IO. The reference isolates them on separate smux ports
    # (datanode/server.go:99-103); here the same isolation is an explicit
    # PRIORITY LANE — repair-class packets share a small concurrency budget
    # per node, so any repair fan-in queues against itself while client
    # reads/writes keep their own unthrottled threads.
    REPAIR_CLASS = frozenset({OP_REPAIR_READ, OP_REPAIR_WRITE,
                              OP_GET_WATERMARKS})

    def __init__(self, node_id: int, addr: str, disks: list[str],
                 raft: MultiRaft | None = None, repair_lanes: int = 2):
        self.node_id = node_id
        self.space = SpaceManager(disks)
        self.raft = raft
        self.repair_lanes = repair_lanes
        self._repair_sem = threading.BoundedSemaphore(repair_lanes)
        self._reg = registry("datanode")  # bound once: dispatch is per-packet
        # per-partition op tally since the last take_loads() — the heartbeat
        # payload the master's hot-volume rebalancer reads. A plain dict on
        # purpose: partition ids are unbounded, so this must never become a
        # metric label (obslint rule 1); the aggregate ops ride the `op` TP.
        self._loads_lock = SanitizedLock(name="datanode.loads")
        self._op_loads: dict[int, int] = {}
        self.server = ReplServer(addr, self._dispatch)
        self.space.load_all(raft)

    @property
    def addr(self) -> str:
        return self.server.addr

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    def take_loads(self) -> dict[int, int]:
        """Per-partition ops served since the last call, then reset — each
        heartbeat reports one window's delta, so the master's NodeInfo.loads
        is always a recent-load snapshot, not a lifetime total."""
        with self._loads_lock:
            out, self._op_loads = self._op_loads, {}
        return out

    def refund_loads(self, loads: dict[int, int]) -> None:
        """Fold a taken-but-unreported window back in (heartbeat send
        failed) so a transient master hiccup never erases observed load."""
        with self._loads_lock:
            for pid, c in loads.items():
                self._op_loads[pid] = self._op_loads.get(pid, 0) + c

    # -- dispatch (wrap_operator.go:80 analog) ---------------------------------

    def _dispatch(self, pkt: Packet) -> Packet:
        """Op dispatch wrapped in the observability plane: per-op TP metrics
        into the datanode role registry, a span continuing the packet's
        trace (its track rides back in the reply arg — only for requests
        that CARRIED a trace id, so pipelined write bursts whose acks drain
        at flush don't flood the caller's bounded track log), and slow-op
        audit over CFS_SLOWOP_MS."""
        name = op_name(pkt.opcode)
        if pkt.partition_id and pkt.opcode not in self.REPAIR_CLASS:
            # client-class IO only: repair/migrate streams are the cure, and
            # counting them would make the rebalancer chase its own moves
            with self._loads_lock:
                self._op_loads[pkt.partition_id] = \
                    self._op_loads.get(pkt.partition_id, 0) + 1
        traced = isinstance(pkt.arg, dict) and TRACE_ARG_KEY in pkt.arg
        span = trace_extract(pkt, f"datanode.{name}")
        trace.push_span(span)
        t0 = time.perf_counter()
        try:
            with self._reg.tp("op", {"op": name}):
                resp = self._dispatch_inner(pkt)
            span.append_track_log("datanode", start=t0)
            return trace_reply(resp, span) if traced else resp
        finally:
            span.finish()
            trace.pop_span()
            record_slow_op("datanode", name, time.perf_counter() - t0,
                           span=span)

    def _dispatch_inner(self, pkt: Packet) -> Packet:
        try:
            handler = self._HANDLERS[pkt.opcode]
        except KeyError:
            return pkt.reply(RES_ERR, arg={"error": f"bad opcode {pkt.opcode:#x}"})
        # repair lane: bulk repair queues against its own budget, never
        # against client IO (smux-port separation analog)
        lane = (self._repair_sem if pkt.opcode in self.REPAIR_CLASS
                else contextlib.nullcontext())
        try:
            with lane:
                # injected disk-lane faults surface as RES_DISK_ERR below,
                # exactly the path a real EIO from the store takes
                chaos.failpoint("datanode.op", node=self.node_id)
                return handler(self, pkt)
        except ExtentNotFound as e:
            return pkt.reply(RES_NOT_EXIST, arg={"error": str(e)})
        except FollowerAckError as e:
            return pkt.reply(RES_ERR, arg={"error": str(e)})
        except (StorageError, ReplError, OSError) as e:
            return pkt.reply(RES_DISK_ERR, arg={"error": str(e)})

    def _dp(self, pkt: Packet) -> DataPartition:
        dp = self.space.partitions.get(pkt.partition_id)
        if dp is None:
            raise ExtentNotFound(f"partition {pkt.partition_id}")
        return dp

    # admin ---------------------------------------------------------------------

    def _op_create_partition(self, pkt: Packet) -> Packet:
        a = pkt.arg
        # daemon mode: the admin task carries peer raft addresses so this
        # node's TCP raft transport can dial them (master/cluster_task.go
        # sends hosts the same way)
        raft_addrs = a.get("raft_addrs") or {}
        if raft_addrs and self.raft is not None and hasattr(self.raft.net, "set_peer"):
            for nid, addr in raft_addrs.items():
                self.raft.net.set_peer(int(nid), addr)
        # idempotent: SpaceManager updates membership for an existing pid
        self.space.create_partition(pkt.partition_id, a["peers"], a["hosts"],
                                    self.raft)
        return pkt.reply()

    def _op_raft_config(self, pkt: Packet) -> Packet:
        """Single-server membership change; only the raft leader proposes."""
        dp = self._dp(pkt)
        a = pkt.arg
        if dp.raft is None:
            dp.update_membership(a.get("peers", dp.peers),
                                 a.get("hosts", dp.hosts))
            return pkt.reply()
        if not dp.is_raft_leader:
            return pkt.reply(RES_NOT_LEADER,
                             arg={"leader": dp.raft.leader_of(dp.pid)})
        raft_addrs = a.get("raft_addrs") or {}
        if hasattr(dp.raft.net, "set_peer"):
            for nid, addr in raft_addrs.items():
                dp.raft.net.set_peer(int(nid), addr)
        peers = dp.raft.propose_config(dp.pid, a["action"], a["node_id"]).result(10)
        dp.update_membership(a.get("peers", dp.peers), a.get("hosts", dp.hosts))
        return pkt.reply(arg={"peers": peers})

    def _op_remove_partition(self, pkt: Packet) -> Packet:
        """Drop a retired replica: leave the raft group, retire the dir."""
        import shutil

        dp = self.space.partitions.pop(pkt.partition_id, None)
        if dp is not None:
            if self.raft is not None:
                self.raft.remove_group(dp.pid)
            shutil.rmtree(dp.root, ignore_errors=True)
        return pkt.reply()

    def _op_heartbeat(self, pkt: Packet) -> Packet:
        return pkt.reply(arg={"node_id": self.node_id,
                              "partitions": len(self.space.partitions)})

    def _op_metrics(self, pkt: Packet) -> Packet:
        dp = self._dp(pkt)
        wm = dp.store.watermarks()
        return pkt.reply(arg={"used": sum(wm.values()), "extents": len(wm)})

    # chain-replicated writes ----------------------------------------------------

    def _op_create_extent(self, pkt: Packet) -> Packet:
        dp = self._dp(pkt)
        if pkt.extent_id == 0:  # leader allocates, then forwards the chosen id
            pkt.extent_id = dp.alloc_extent_id()

        def operate(p: Packet) -> Packet:
            dp.store.create(p.extent_id)
            return p.reply(extent_id=p.extent_id)

        return self.server.replicate(pkt, operate)

    def _op_write(self, pkt: Packet) -> Packet:
        """Append write; tiny allocation happens here on the leader
        (datanode/wrap_prepare.go:28 Prepare analog)."""
        dp = self._dp(pkt)
        if not pkt.verify_crc():
            return pkt.reply(RES_ERR, arg={"error": "packet crc mismatch"})
        if pkt.arg.get("tiny") and pkt.extent_id == 0:
            pkt.extent_id, pkt.extent_offset = dp.store.alloc_tiny()

        def operate(p: Packet) -> Packet:
            dp.store.write(p.extent_id, p.extent_offset, p.data, crc=p.crc)
            return p.reply(extent_id=p.extent_id, extent_offset=p.extent_offset)

        return self.server.replicate(pkt, operate)

    def _op_mark_delete(self, pkt: Packet) -> Packet:
        dp = self._dp(pkt)

        def operate(p: Packet) -> Packet:
            size = p.arg.get("size", 0)
            if is_tiny_extent(p.extent_id):
                dp.store.mark_delete(p.extent_id, p.extent_offset, size)
            elif dp.store.has(p.extent_id):
                dp.store.mark_delete(p.extent_id)
            return p.reply()

        return self.server.replicate(pkt, operate)

    # raft-replicated random write ----------------------------------------------

    def _op_random_write(self, pkt: Packet) -> Packet:
        dp = self._dp(pkt)
        if dp.raft is None:
            dp.store.write(pkt.extent_id, pkt.extent_offset, pkt.data, overwrite=True)
            return pkt.reply()
        if not dp.is_raft_leader:
            return pkt.reply(RES_NOT_LEADER,
                             arg={"leader": dp.raft.leader_of(dp.pid)})
        # concurrent handler threads coalesce in the group-commit pending
        # queue: one WAL flush + one AppendEntries round per drained batch,
        # not per packet (the partition_op_by_raft.go hot path)
        try:
            fut = dp.raft.propose(
                dp.pid, ("rw", pkt.extent_id, pkt.extent_offset, pkt.data))
        except NotLeaderError as e:  # deposed between the gate and the propose
            return pkt.reply(RES_NOT_LEADER, arg={"leader": e.leader})
        t_wait = time.perf_counter()
        status, detail = fut.result(timeout=10)
        span = trace.current_span()
        if span is not None:  # waiter-side raft hop entry (commit wait)
            span.append_track_log("raft", start=t_wait)
            span.add_stage("raft", start=t_wait)
        if status != "ok":
            return pkt.reply(RES_ERR, arg={"error": detail})
        return pkt.reply()

    def _op_tiny_delete_record(self, pkt: Packet) -> Packet:
        dp = self._dp(pkt)
        size = pkt.arg.get("size", 0)

        def operate(p: Packet) -> Packet:
            dp.store.mark_delete(p.extent_id, p.extent_offset, size)
            return p.reply()

        return self.server.replicate(pkt, operate)

    # reads ---------------------------------------------------------------------

    def _op_stream_read(self, pkt: Packet) -> Packet:
        dp = self._dp(pkt)
        # client reads are leader-only when the partition rides raft: a
        # follower may not have applied the latest random overwrite yet
        # (the reference ships followerRead=false by default for the same
        # reason). A packet flagged follower_read opts INTO that relaxed
        # consistency (volume option, proto/mount_options.go FollowerRead) —
        # the follower serves from its local store without a leadership
        # check, which keeps reads alive through elections. Repair reads
        # target specific replicas and skip the gate the same way.
        if (pkt.opcode == OP_STREAM_READ and dp.raft is not None
                and not dp.is_raft_leader
                and not pkt.arg.get("follower_read")):
            return pkt.reply(RES_NOT_LEADER,
                             arg={"leader": dp.raft.leader_of(dp.pid)})
        size = pkt.arg.get("size", 0)
        data = dp.store.read(pkt.extent_id, pkt.extent_offset, size)
        return pkt.reply(data=data)

    # repair --------------------------------------------------------------------

    def _op_get_watermarks(self, pkt: Packet) -> Packet:
        dp = self._dp(pkt)
        holes = {str(eid): dp.store.tiny_holes(eid) for eid in dp.store.extent_ids()
                 if is_tiny_extent(eid)}
        return pkt.reply(arg={
            "watermarks": {str(k): v for k, v in dp.store.watermarks().items()},
            "deleted": sorted(dp.store._deleted),
            "holes": {k: v for k, v in holes.items() if v},
        })

    def _op_repair_write(self, pkt: Packet) -> Packet:
        """Local-only append used by the repair stream (no re-replication)."""
        dp = self._dp(pkt)
        if not dp.store.has(pkt.extent_id) and not is_tiny_extent(pkt.extent_id):
            dp.store.create(pkt.extent_id)
        dp.store.write(pkt.extent_id, pkt.extent_offset, pkt.data, crc=pkt.crc)
        return pkt.reply()

    _HANDLERS = {
        OP_CREATE_PARTITION: _op_create_partition,
        OP_HEARTBEAT: _op_heartbeat,
        OP_GET_PARTITION_METRICS: _op_metrics,
        OP_CREATE_EXTENT: _op_create_extent,
        OP_WRITE: _op_write,
        OP_MARK_DELETE: _op_mark_delete,
        OP_RANDOM_WRITE: _op_random_write,
        OP_TINY_DELETE_RECORD: _op_tiny_delete_record,
        OP_RAFT_CONFIG: _op_raft_config,
        OP_REMOVE_PARTITION: _op_remove_partition,
        OP_STREAM_READ: _op_stream_read,
        OP_REPAIR_READ: _op_stream_read,
        OP_GET_WATERMARKS: _op_get_watermarks,
        OP_REPAIR_WRITE: _op_repair_write,
    }

    # -- leader-driven repair (data_partition_repair.go:80 analog) ---------------

    def repair_partition(self, pid: int) -> int:
        """Reconcile every replica of pid; returns bytes streamed."""
        self._reg.counter("repair_rounds_total").add()
        dp = self.space.partitions.get(pid)
        if dp is None:
            raise ExtentNotFound(f"partition {pid}")
        views: dict[str, dict] = {}
        for host in dp.hosts:
            if host == self.addr:
                rep = self._op_get_watermarks(
                    Packet(OP_GET_WATERMARKS, partition_id=pid))
            else:
                try:
                    rep = self.server.request(
                        host, Packet(OP_GET_WATERMARKS, partition_id=pid))
                except (OSError, ReplError):
                    continue  # dead replica: repair the reachable set
            if rep.result == RES_OK:
                views[host] = rep.arg

        # union of deletes wins: an extent deleted anywhere dies everywhere
        deleted = set()
        for v in views.values():
            deleted.update(v["deleted"])
        for host, v in views.items():
            for eid in deleted - set(v["deleted"]):
                if str(eid) in v["watermarks"]:
                    self.server.request(host, Packet(
                        OP_MARK_DELETE, partition_id=pid, extent_id=eid))

        # per-extent max watermark; stream suffixes to laggards
        maxes: dict[int, tuple[int, str]] = {}
        for host, v in views.items():
            for k, size in v["watermarks"].items():
                eid = int(k)
                if eid in deleted:
                    continue
                if eid not in maxes or size > maxes[eid][0]:
                    maxes[eid] = (size, host)
        streamed = 0
        for eid, (target, source) in maxes.items():
            for host, v in views.items():
                have = v["watermarks"].get(str(eid), 0)
                if have >= target or host == source:
                    continue
                streamed += self._stream_repair_extent(
                    dp, eid, source, host, have, target)

        # replay tiny punch-hole records everywhere
        for host, v in views.items():
            for k, holes in v.get("holes", {}).items():
                eid = int(k)
                for off, size in holes:
                    for peer, pv in views.items():
                        if peer == host:
                            continue
                        if [off, size] in pv.get("holes", {}).get(k, []):
                            continue
                        self.server.request(peer, Packet(
                            OP_MARK_DELETE, partition_id=pid, extent_id=eid,
                            extent_offset=off, arg={"size": size}))
        if streamed:
            self._reg.counter("repair_bytes_total").add(streamed)
        return streamed

    def _stream_repair_extent(self, dp: DataPartition, eid: int, source: str,
                              dest: str, start: int, end: int) -> int:
        """streamRepairExtent (data_partition_repair.go:481): chunked copy.

        LOCAL chunk IO (this node is the source and/or dest — the common
        case, the coordinator is usually the most advanced replica) takes
        the repair lane the same as remote-origin repair packets do: the
        traffic-class budget bounds bulk repair at the DISK, not merely at
        the wire."""
        moved = 0
        pos = start
        while pos < end:
            n = min(REPAIR_CHUNK, end - pos)
            req = Packet(OP_REPAIR_READ, partition_id=dp.pid, extent_id=eid,
                         extent_offset=pos, arg={"size": n})
            if source == self.addr:
                with self._repair_sem:
                    blob = dp.store.read(eid, pos, n)
            else:
                rep = self.server.request(source, req)
                if rep.result != RES_OK:
                    raise ReplError(rep.error())
                blob = rep.data
            wr = Packet(OP_REPAIR_WRITE, partition_id=dp.pid, extent_id=eid,
                        extent_offset=pos, data=blob)
            if dest == self.addr:
                with self._repair_sem:
                    self._op_repair_write(wr)
            else:
                rep = self.server.request(dest, wr)
                if rep.result != RES_OK:
                    raise ReplError(rep.error())
            pos += n
            moved += n
        return moved
