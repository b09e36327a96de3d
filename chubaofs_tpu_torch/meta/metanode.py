"""MetaNode — hosts meta partitions and dispatches metadata ops.

Reference counterpart: metanode/metanode.go + manager.go:103 (op dispatch) +
partition_free_list.go (async deletion of orphaned inodes' data). Partitions are
raft groups on the shared MultiRaft server (group id = partition id); mutations
are proposed to the partition's leader, reads served from leader state.
"""

from __future__ import annotations

from concurrent.futures import Future

from chubaofs_tpu_torch.meta.partition import (MetaError, MetaPartitionSM,
                                         WrongPartition)
from chubaofs_tpu_torch.raft.server import MultiRaft, NotLeaderError
from chubaofs_tpu_torch.utils.locks import SanitizedLock


class OpError(Exception):
    def __init__(self, code: str, msg: str):
        super().__init__(f"{code}: {msg}")
        self.code = code


# every pid ever hosted in this process, feeding the bounded-label guard for
# cfs_metanode_partition_ops{pid}: the VALUE set is declared (closed over the
# partitions the master actually created — bounded by cluster state, unlike
# an arbitrary wire string), so obslint rule 1's invariant holds at runtime.
# Process-wide because declare_label_values is keyed by label name and an
# in-process cluster hosts several MetaNodes.
_KNOWN_PIDS: set[str] = set()
_known_pids_lock = SanitizedLock(name="metanode.pids")

# ops that are the CURE or the plumbing, not client load: counting them would
# make the meta rebalancer/splitter chase its own moves (DataNode's
# REPAIR_CLASS rationale applied to the metadata plane)
_MAINTENANCE_OPS = frozenset({
    "freeze_range", "unfreeze_range", "import_entries", "complete_split",
    "set_range_end",
    "drain_freelist", "purge_ack", "drain_del_extents", "del_extents_ack",
    "tx_sweep", "set_quota_def", "set_quota_flag", "delete_quota_def",
})


def _declare_pid(pid: int) -> None:
    from chubaofs_tpu_torch.utils.exporter import declare_label_values

    with _known_pids_lock:
        _KNOWN_PIDS.add(str(pid))
        declare_label_values("pid", _KNOWN_PIDS)


class MetaNode:
    def __init__(self, node_id: int, raft: MultiRaft):
        self.node_id = node_id
        self.raft = raft
        self.partitions: dict[int, MetaPartitionSM] = {}
        self._lock = SanitizedLock(name="metanode.partitions")
        # per-partition op tally since the last take_loads() — the heartbeat
        # payload the master's split/rebalance accounting reads (the
        # DataNode.take_loads shape on the metadata plane). A plain dict
        # PLUS a declared-pid metric: partition ids here are bounded by the
        # master's own creations, so the label guard admits them.
        self._loads_lock = SanitizedLock(name="metanode.loads")
        self._op_loads: dict[int, int] = {}
        from chubaofs_tpu_torch.utils.exporter import registry

        self._reg = registry("metanode")  # bound once: _note_load is per-op
        self._partitions_g = self._reg.gauge("partitions")
        # pid -> bound counter series, populated at create_partition so the
        # hot path pays one dict lookup, not a registry+labels resolution
        self._load_counters: dict[int, object] = {}
        # injected by the deployment: called with (inode) to purge file data;
        # must RAISE on failure so the orphan stays queued and is retried
        self.data_purge_hook = None
        # called with ({"extents": [...], "obj_extents": [...]}) for spans
        # dropped by truncate; same raise-to-retry contract
        self.extent_purge_hook = None

    # -- partition lifecycle (master drives this) ----------------------------

    def create_partition(self, partition_id: int, start: int, end: int, peers: list[int]) -> None:
        with self._lock:
            sm = MetaPartitionSM(partition_id, start, end)
            self.partitions[partition_id] = sm
            self.raft.create_group(partition_id, peers, sm)
        _declare_pid(partition_id)
        self._load_counters[partition_id] = self._reg.counter(
            "partition_ops", {"pid": str(partition_id)})
        self._partitions_gauge()

    def _partitions_gauge(self) -> None:
        self._partitions_g.set(len(self.partitions))

    def is_leader(self, partition_id: int) -> bool:
        return self.raft.is_leader(partition_id)

    def remove_partition(self, partition_id: int) -> None:
        """Drop a retired replica (decommission tail step)."""
        with self._lock:
            self.raft.remove_group(partition_id)
            self.partitions.pop(partition_id, None)
        self._load_counters.pop(partition_id, None)
        with self._loads_lock:
            # the accrued window leaves with the partition: reporting it
            # after a migrate-off keeps this node "hot" for load it no
            # longer serves, and a back-to-back rebalance sweep would shed
            # a second, correctly-placed partition on that stale signal
            self._op_loads.pop(partition_id, None)
        self._partitions_gauge()

    # -- load accounting (the split/rebalance heartbeat feed) ------------------

    def _note_load(self, partition_id: int, op: str | None = None) -> None:
        if op is not None and op in _MAINTENANCE_OPS:
            return
        with self._loads_lock:
            self._op_loads[partition_id] = \
                self._op_loads.get(partition_id, 0) + 1
        c = self._load_counters.get(partition_id)
        if c is not None:
            c.add()

    def _unnote_load(self, partition_id: int) -> None:
        """Take back one _note_load from the heartbeat window: a read that
        bounced off the route guard (EWRONGPART) was not served load, and
        the freeze->swap retry storm must not re-trip the split threshold.
        The per-pid metric counter is NOT rolled back (counters only go up;
        it measures request pressure, while the window drives splits)."""
        with self._loads_lock:
            n = self._op_loads.get(partition_id, 0)
            if n > 1:
                self._op_loads[partition_id] = n - 1
            else:
                self._op_loads.pop(partition_id, None)

    def take_loads(self) -> dict[int, int]:
        """Per-partition ops served since the last call, then reset — each
        heartbeat reports one window's delta (DataNode.take_loads contract),
        so the master's NodeInfo.loads stays a recent-load snapshot."""
        with self._loads_lock:
            out, self._op_loads = self._op_loads, {}
        return out

    def refund_loads(self, loads: dict[int, int]) -> None:
        """Fold a taken-but-unreported window back in (heartbeat send
        failed) so a master hiccup never erases observed load."""
        with self._loads_lock:
            for pid, c in loads.items():
                self._op_loads[pid] = self._op_loads.get(pid, 0) + c

    def split_reports(self) -> dict[int, dict]:
        """pid -> replicated split_info for partitions mid-split — the
        heartbeat payload the master's resume sweep reads (any replica may
        report; the master dedupes against the volume view)."""
        out = {}
        for pid, sm in list(self.partitions.items()):
            info = sm.split_info  # single read: the raft apply thread may
            if info is not None:  # null it (complete/unfreeze) mid-sweep
                out[pid] = dict(info)
        return out

    def propose_raft_config(self, partition_id: int, action: str,
                            node_id: int, timeout: float = 10.0):
        """Single-server membership change; must run on the group leader."""
        if partition_id not in self.partitions:
            raise OpError("ENOPARTITION",
                          f"partition {partition_id} not on node {self.node_id}")
        return self.raft.propose_config(partition_id, action, node_id).result(timeout)

    # -- write ops: through raft ---------------------------------------------

    @staticmethod
    def _chain_result(fut: Future, unnote=None) -> Future:
        """Map a raft apply-result future onto the op-result/OpError shape.
        `unnote` refunds the submitter's load tally on an EWRONGPART
        outcome — a route-guard bounce is not served load (see submit) —
        and runs BEFORE the chained future resolves, so a waiter that
        checks take_loads right after result() sees the refund. Only the
        rare bounce pays it: the common path must add NO work on the raft
        apply thread (the commit pipeline's bottleneck)."""
        out: Future = Future()

        def _done(f: Future):
            if f.exception():
                out.set_exception(f.exception())
                return
            res = f.result()
            if res[0] == "err":
                if unnote is not None and res[1] == "EWRONGPART":
                    unnote()
                out.set_exception(OpError(res[1], res[2]))
            else:
                out.set_result(res[1])

        fut.add_done_callback(_done)
        return out

    def submit(self, partition_id: int, op: str, **args) -> Future:
        """Propose one fsm op; future resolves to the op result or raises.
        Rides raft group commit: concurrent submits against one partition
        coalesce into shared WAL-flush + replication rounds."""
        # propose FIRST: it raises NotLeaderError synchronously on a
        # follower, and a misdirected client probe (leader-hunt herd) must
        # not count as served load — a phantom tally here can cross
        # CFS_META_SPLIT_OPS and split a partition that served no traffic.
        # A route-guard bounce (stale client view mid-split) is refunded on
        # the commit outcome: the freeze->swap retry storm must not re-trip
        # the load threshold on the partition the split just relieved
        fut = self.raft.propose(partition_id, (op, dict(args)))
        self._note_load(partition_id, op)
        return self._chain_result(
            fut, unnote=lambda: self._unnote_load(partition_id))

    def submit_batch(self, partition_id: int, ops: list[tuple[str, dict]]) -> list[Future]:
        """Propose many fsm ops in one drained raft batch (one WAL flush, one
        AppendEntries fan-out). FIFO apply order; each op fails or resolves
        independently — errors are values through consensus, so one EEXIST in
        a batch never poisons its neighbors."""
        futs = self.raft.propose_batch(
            partition_id, [(op, dict(args)) for op, args in ops])
        return [self._chain_result(f) for f in futs]

    def submit_sync(self, partition_id: int, op: str, timeout: float = 5.0, **args):
        import time

        from chubaofs_tpu_torch.blobstore import trace

        span = trace.current_span()
        t0 = time.perf_counter()
        fut = self.submit(partition_id, op, **args)
        t_wait = time.perf_counter()
        result = fut.result(timeout)
        if span is not None:
            # appended HERE, by the waiter, after the commit resolved — a
            # raft-layer done-callback would race this thread's reply
            # construction/span.finish and lose the entry
            span.append_track_log("raft", start=t_wait)
            span.add_stage("raft", start=t_wait)  # group-commit wait
            # in-process callers get their "metanode" hop entry here; under
            # a MetaService handler the SERVICE span already appends one
            # covering the whole dispatch — one entry per hop either way
            if not span.operation.startswith("metanode."):
                span.append_track_log("metanode", start=t0)
        return result

    # -- read ops: leader-local ------------------------------------------------

    def _leader_sm(self, partition_id: int,
                   count: bool = True) -> MetaPartitionSM:
        sm = self.partitions.get(partition_id)
        if sm is None:
            # distinct from a namespace ENOENT: the SDK treats this as
            # try-the-next-replica, not file-not-found
            raise OpError("ENOPARTITION",
                          f"partition {partition_id} not on node {self.node_id}")
        if not self.raft.is_leader(partition_id):
            raise NotLeaderError(self.raft.leader_of(partition_id))
        if count:  # count=False: maintenance reads (export/dump/quota rolls)
            self._note_load(partition_id)
        return sm

    def get_inode(self, partition_id: int, ino: int):
        try:
            return self._leader_sm(partition_id).get_inode(ino)
        except WrongPartition as e:
            self._unnote_load(partition_id)
            raise OpError(e.code, str(e)) from None
        except MetaError as e:
            raise OpError(e.code, str(e)) from None

    def lookup(self, partition_id: int, parent: int, name: str):
        try:
            return self._leader_sm(partition_id).lookup(parent, name)
        except WrongPartition as e:
            self._unnote_load(partition_id)
            raise OpError(e.code, str(e)) from None
        except MetaError as e:
            raise OpError(e.code, str(e)) from None

    def read_dir(self, partition_id: int, parent: int):
        try:
            return self._leader_sm(partition_id).read_dir(parent)
        except WrongPartition as e:
            self._unnote_load(partition_id)
            raise OpError(e.code, str(e)) from None
        except MetaError as e:
            raise OpError(e.code, str(e)) from None

    def multipart_get(self, partition_id: int, upload_id: str):
        try:
            return self._leader_sm(partition_id).multipart_get(upload_id)
        except MetaError as e:
            raise OpError(e.code, str(e)) from None

    def multipart_list(self, partition_id: int):
        try:
            return self._leader_sm(partition_id).multipart_list()
        except MetaError as e:
            raise OpError(e.code, str(e)) from None

    def quota_usage(self, partition_id: int):
        try:
            return self._leader_sm(partition_id, count=False).quota_usage()
        except MetaError as e:
            raise OpError(e.code, str(e)) from None

    def tx_status(self, partition_id: int, tx_id: str) -> str:
        try:
            return self._leader_sm(partition_id, count=False).tx_status(tx_id)
        except MetaError as e:
            raise OpError(e.code, str(e)) from None

    def split_point(self, partition_id: int) -> int:
        """Median live inode of a partition (the split_at candidate)."""
        try:
            return self._leader_sm(partition_id, count=False).split_point()
        except MetaError as e:
            raise OpError(e.code, str(e)) from None

    def export_range(self, partition_id: int, after: int = 0,
                     limit: int = 0) -> dict:
        """One page of a FROZEN partition's moving sub-range (split copy)."""
        try:
            return self._leader_sm(partition_id, count=False).export_range(
                after=after, limit=limit)
        except MetaError as e:
            raise OpError(e.code, str(e)) from None

    def dump_namespace(self, partition_id: int):
        """Full inode+dentry dump of one partition (fsck's feed)."""
        try:
            sm = self._leader_sm(partition_id, count=False)
        except MetaError as e:
            raise OpError(e.code, str(e)) from None
        return {"inodes": list(sm.inodes.values()),
                "dentries": list(sm.dentries.values())}

    # injected by the deployment: (tm_pid, tx_id) -> "committed" |
    # "rolledback" | "prepared" | "unknown" — asks the TM partition's leader
    tx_resolver_hook = None

    def sweep_transactions(self) -> int:
        """Resolve expired prepared 2PC txns (tx GC, metanode/transaction.go
        timeouts). TM-anchored txns roll back in the sweep itself; participant
        txns roll FORWARD or BACK to match the TM's recorded decision."""
        import time

        swept = 0
        for pid in list(self.partitions):
            if not self.raft.is_leader(pid):
                continue
            if not self.partitions[pid].txns:
                continue
            try:
                unresolved = self.submit_sync(pid, "tx_sweep", now=time.time())
            except (NotLeaderError, OpError):
                continue
            swept += len(unresolved)
            for tx_id, tm_pid in unresolved:
                decision = "unknown"
                if self.tx_resolver_hook is not None:
                    try:
                        decision = self.tx_resolver_hook(tm_pid, tx_id)
                    except Exception:
                        continue  # TM unreachable: keep the txn for next sweep
                try:
                    if decision == "committed":
                        self.submit_sync(pid, "tx_commit", tx_id=tx_id)
                    elif decision in ("rolledback", "unknown"):
                        # unknown = the TM never saw the txn (coordinator died
                        # before preparing it there): nothing can commit it
                        self.submit_sync(pid, "tx_rollback", tx_id=tx_id)
                    # "prepared": TM undecided; its own sweep will decide first
                except (NotLeaderError, OpError):
                    continue
        return swept

    # -- freelist delete loop (partition_free_list.go:180,233 analog) ----------

    def drain_freelists(self) -> int:
        """Purge data of orphaned inodes + truncate-dropped extents on
        partitions this node leads. Two-phase: drain peeks, the purge runs,
        and only a successful purge acks the entry off the queue — so a
        datanode/blobstore hiccup leaves it queued for the next sweep
        (partition_free_list.go:180,233 retry discipline)."""
        purged = 0
        for pid in list(self.partitions):
            if not self.raft.is_leader(pid):
                continue
            try:
                # both peeks ride ONE drained raft batch (group commit):
                # half the consensus rounds per partition sweep
                drained_fut, extents_fut = self.submit_batch(
                    pid, [("drain_freelist", {}), ("drain_del_extents", {})])
                drained = drained_fut.result(5.0)
            except (NotLeaderError, OpError):
                continue
            done = []
            for inode in drained:
                if self.data_purge_hook:
                    try:
                        self.data_purge_hook(inode)
                    except Exception:
                        continue  # stays orphaned; retried next drain
                done.append(inode.ino)
            if done:
                try:
                    self.submit_sync(pid, "purge_ack", inos=done)
                except (NotLeaderError, OpError):
                    continue
                purged += len(done)

            try:
                entries = extents_fut.result(5.0)
            except (NotLeaderError, OpError):
                continue
            acked = []
            for seq, entry in entries:
                if self.extent_purge_hook:
                    try:
                        self.extent_purge_hook(entry)
                    except Exception:
                        continue
                acked.append(seq)
            if acked:
                try:
                    self.submit_sync(pid, "del_extents_ack", seqs=acked)
                except (NotLeaderError, OpError):
                    continue
                purged += len(acked)
        return purged
