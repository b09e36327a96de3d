"""FsCluster — a full in-process deployment: masters + metanodes + datanodes
+ blobstore.

Reference analog: docker/docker-compose.yml's 3-master/4-metanode/4-datanode
bring-up (SURVEY §4), collapsed into one process for tests and embedded use.
Node layout: raft nodes 1..N each host the master group (GROUP 1) and any meta
partition groups placed on them; datanodes (ids 101..) run real TCP packet
servers (chain replication + per-partition raft for random writes) for hot
volumes; cold volumes ride the erasure-coded blobstore (GF codec service on
the CUDA device unless the caller names another).
"""

from __future__ import annotations

import os

from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
from chubaofs_tpu_torch.data.datanode import DataNode
from chubaofs_tpu_torch.master.master import Master, MasterSM, MASTER_GROUP, MasterError
from chubaofs_tpu_torch.meta.metanode import MetaNode
from chubaofs_tpu_torch.ops.rs import resolve_device
from chubaofs_tpu_torch.proto.packet import (
    OP_CREATE_PARTITION, Packet, RES_OK, recv_packet, send_packet,
)
from chubaofs_tpu_torch.raft.server import InProcNet, MultiRaft, NotLeaderError, run_until
from chubaofs_tpu_torch.sdk.fs import FsClient
from chubaofs_tpu_torch.sdk.meta_wrapper import MetaWrapper
from chubaofs_tpu_torch.sdk.stream import ExtentClient, HotBackend
from chubaofs_tpu_torch.utils.conn_pool import ConnPool

DATANODE_ID_BASE = 100


class BlobstoreBackend:
    """FsClient data backend over the blobstore access gateway."""

    def __init__(self, blobstore: MiniCluster):
        self.bs = blobstore

    def write(self, data: bytes) -> str:
        return self.bs.access.put(data).to_json()

    def read(self, loc: str, offset: int, size: int) -> bytes:
        return self.bs.access.get(loc, offset, size)

    def delete(self, loc: str) -> None:
        self.bs.access.delete(loc)


class FsCluster:
    def __init__(self, root: str, n_nodes: int = 3, blob_nodes: int = 9,
                 data_nodes: int = 4, disks_per_datanode: int = 2,
                 device=None):
        """`device` is the blobstore's codec device: None means the CUDA
        device (and raises without one), "cpu" the host. It is passed to
        MiniCluster even when no volume is cold, and resolved before any
        node starts, so a missing GPU raises with nothing left running."""
        device = resolve_device(device)
        self.root = root
        self.net = InProcNet()
        self.rafts: dict[int, MultiRaft] = {}
        self.master_sms: dict[int, MasterSM] = {}
        self.masters: dict[int, Master] = {}
        self.metanodes: dict[int, MetaNode] = {}
        self.datanodes: dict[int, DataNode] = {}
        self.admin_pool = ConnPool()

        from chubaofs_tpu_torch.authnode import AUTH_GROUP, AuthNode, KeystoreSM

        self.keystore_sms: dict[int, KeystoreSM] = {}
        self.authnodes: dict[int, AuthNode] = {}
        for i in range(1, n_nodes + 1):
            raft = MultiRaft(i, self.net, wal_dir=os.path.join(root, f"raft{i}"),
                             snapshot_every=512)
            self.rafts[i] = raft
            sm = MasterSM()
            self.master_sms[i] = sm
            raft.create_group(MASTER_GROUP, list(range(1, n_nodes + 1)), sm)
            self.masters[i] = Master(raft, sm)
            self.metanodes[i] = MetaNode(i, raft)
            ksm = KeystoreSM()
            raft.create_group(AUTH_GROUP, list(range(1, n_nodes + 1)), ksm)
            self.keystore_sms[i] = ksm
            self.authnodes[i] = AuthNode(raft, ksm)

        for i, m in self.masters.items():
            m.metanode_hook = self._create_meta_partition
            m.datanode_hook = self._create_data_partition
            m.raft_config_hook = self._raft_config
            m.remove_partition_hook = self._remove_partition
            m.meta_op_hook = self._meta_op

        for j in range(1, data_nodes + 1):
            nid = DATANODE_ID_BASE + j
            draft = MultiRaft(nid, self.net,
                              wal_dir=os.path.join(root, f"raft{nid}"),
                              snapshot_every=512)
            self.rafts[nid] = draft
            disks = [os.path.join(root, f"dn{nid}", f"disk{k}")
                     for k in range(disks_per_datanode)]
            dn = DataNode(nid, "127.0.0.1:0", disks, raft=draft)
            dn.start()
            self.datanodes[nid] = dn

        self.blobstore = MiniCluster(os.path.join(root, "blob"), n_nodes=blob_nodes,
                                     disks_per_node=2, device=device)
        self.data_backend = BlobstoreBackend(self.blobstore)

        self.settle()
        lead = self.master()
        for i in self.metanodes:
            lead.register_node(i, "meta")
        for nid, dn in self.datanodes.items():
            lead.register_node(nid, "data", addr=dn.addr)
        # restart path: re-host every partition recorded in the recovered
        # master state; datanode addresses changed, so re-resolve dp hosts
        # from the fresh registry before reconnecting
        lead.refresh_dp_hosts()
        for vol in list(lead.sm.volumes.values()):
            for mp in vol.meta_partitions:
                # genesis range: WAL replay re-applies any in-log range
                # shrink (complete_split/set_range_end); a view-range SM
                # would silently drop pre-shrink entries
                self._create_meta_partition(mp.partition_id, mp.start0,
                                            mp.end0, mp.peers)
            for dp in vol.data_partitions:
                self._create_data_partition(dp.partition_id, dp.peers, dp.hosts)
        self._purge_ec = None
        for mn in self.metanodes.values():
            mn.data_purge_hook = self._purge_inode_data
            mn.extent_purge_hook = self._purge_extent_entry
            mn.tx_resolver_hook = self._resolve_tx

    # -- pumping -----------------------------------------------------------------

    def settle(self, cond=None, max_ticks: int = 600) -> bool:
        """Pump raft clocks until cond (default: master leader elected)."""
        cond = cond or (lambda: any(m.is_leader for m in self.masters.values()))
        return run_until(self.net, cond, max_ticks=max_ticks)

    def heartbeat_metanodes(self):
        """One metanode heartbeat round: cursors + op-load window + frozen-
        split reports into the master (the daemon's 1s loop, pumped
        explicitly in-process). Refunds the load window on failure so a
        mid-election master never erases observed load."""
        for mn in self.metanodes.values():
            cursors = {pid: sm.cursor
                       for pid, sm in list(mn.partitions.items())}
            loads = mn.take_loads()
            try:
                self.master().heartbeat(
                    mn.node_id, partition_count=len(cursors),
                    cursors=cursors, loads=loads,
                    splits=mn.split_reports())
            except Exception:
                # mid-election this raises NotLeaderError, not just
                # MasterError — either way keep the window for later
                # (the daemon heartbeat's same refund-on-any-failure
                # contract in cmd.py)
                mn.refund_loads(loads)

    def tick_background(self):
        """One pass of the master's background loops + metanode freelists."""
        self.heartbeat_metanodes()
        lead = self.master()
        lead.check_meta_partitions()
        lead.refresh_leaders(lambda pid: next(
            (r.leader_of(pid) for r in self.rafts.values() if r.leader_of(pid)), None
        ))
        for mn in self.metanodes.values():
            mn.drain_freelists()
            mn.sweep_transactions()
        for vol_name in self.volume_names():
            try:
                MetaWrapper(lead, self.metanodes, vol_name).push_quota_flags()
            except Exception:
                pass  # a mid-election partition: next tick retries
        self.blobstore.run_background_once()

    def repair_data_partitions(self) -> int:
        """Leader-driven extent repair sweep (the 60s loop of
        datanode/data_partition_repair.go:80); returns bytes streamed."""
        moved = 0
        for vol in self.master().sm.volumes.values():
            for dp in vol.data_partitions:
                leader = self._datanode_at(dp.hosts[0])
                if leader is not None:
                    moved += leader.repair_partition(dp.partition_id)
        return moved

    # -- components ----------------------------------------------------------------

    def master(self) -> Master:
        for m in self.masters.values():
            if m.is_leader:
                return m
        raise MasterError("no master leader")

    def authnode(self):
        from chubaofs_tpu_torch.authnode import AUTH_GROUP

        for i, node in self.authnodes.items():
            if self.rafts[i].is_leader(AUTH_GROUP):
                return node
        raise MasterError("no authnode leader")

    def _raft_config(self, kind: str, pid: int, action: str, node_id: int,
                     peers: list[int]) -> None:
        """Propose a membership change on the partition's raft leader and
        pump ticks until it commits (decommission hook). The proposal is
        async — blocking on the future while also being the tick pump would
        deadlock the in-proc cluster."""
        del kind, peers  # in-proc: every group lives on self.rafts
        fut = None

        def try_once():
            nonlocal fut
            if fut is not None and fut.done():
                return True
            if fut is None or (fut.done() and fut.exception()):
                for raft in self.rafts.values():
                    if pid in raft.groups and raft.is_leader(pid):
                        try:
                            fut = raft.propose_config(pid, action, node_id)
                        except NotLeaderError:
                            fut = None
                        break
            return fut is not None and fut.done() and fut.exception() is None

        assert self.settle(try_once, max_ticks=1200), \
            f"membership change {action}({node_id}) on {pid} did not commit"

    def _meta_op(self, pid: int, peers: list[int], op: str, args: dict,
                 read: bool = False):
        """Run one metanode op on the partition's raft leader (the master's
        split-orchestration hook): find the leader among the hosting
        metanodes, pumping raft clocks through elections, and retry
        leadership races until a bounded deadline."""
        import time as _time

        from chubaofs_tpu_torch.meta.metanode import OpError

        deadline = _time.monotonic() + 30.0
        last: Exception | None = None
        while _time.monotonic() < deadline:
            for mn in self.metanodes.values():
                if pid not in mn.partitions or not mn.raft.is_leader(pid):
                    continue
                try:
                    if read:
                        return getattr(mn, op)(pid, **args)
                    return mn.submit_sync(pid, op, **args)
                except (NotLeaderError, OpError) as e:
                    if isinstance(e, OpError) and e.code not in (
                            "ECONN", "ENOPARTITION", "EIO"):
                        raise
                    last = e
            # no leader found (fresh group / mid-election): pump the clocks
            self.settle(lambda: any(
                pid in mn.partitions and mn.raft.is_leader(pid)
                for mn in self.metanodes.values()), max_ticks=200)
        raise MasterError(f"meta op {op} on {pid}: no leader ({last})")

    def _remove_partition(self, kind: str, pid: int, node_id: int) -> None:
        from chubaofs_tpu_torch.proto.packet import OP_REMOVE_PARTITION

        if kind == "meta":
            mn = self.metanodes.get(node_id)
            if mn is not None:
                mn.remove_partition(pid)
            return
        node = self.master().sm.nodes.get(node_id)
        dn = self._datanode_at(node.addr) if node else None
        if dn is None:
            return
        sock = self.admin_pool.get(dn.addr)
        try:
            send_packet(sock, Packet(OP_REMOVE_PARTITION, partition_id=pid))
            recv_packet(sock)
        finally:
            self.admin_pool.put(dn.addr, sock)

    def _resolve_tx(self, tm_pid: int, tx_id: str) -> str:
        """Participant-sweep hook: ask the TM partition's leader for the
        txn decision (metanode tx RM->TM status query analog)."""
        for mn in self.metanodes.values():
            if tm_pid in mn.partitions and mn.raft.is_leader(tm_pid):
                return mn.tx_status(tm_pid, tx_id)
        raise RuntimeError(f"no leader for tm partition {tm_pid}")

    def _datanode_at(self, addr: str) -> DataNode | None:
        return next((d for d in self.datanodes.values() if d.addr == addr), None)

    def _create_meta_partition(self, pid: int, start: int, end: int,
                               peers: list[int], only: int | None = None):
        for peer in peers:
            if only is not None and peer != only:
                continue
            if pid not in self.metanodes[peer].partitions:
                self.metanodes[peer].create_partition(pid, start, end, peers)
        if only is None:
            self.settle(lambda: any(self.rafts[p].is_leader(pid) for p in peers))

    def _create_data_partition(self, pid: int, peers: list[int],
                               hosts: list[str], only: int | None = None):
        """Admin task to every replica host (master/cluster_task.go analog),
        over the real wire."""
        for peer, addr in zip(peers, hosts):
            if only is not None and peer != only:
                continue
            sock = self.admin_pool.get(addr)
            try:
                send_packet(sock, Packet(OP_CREATE_PARTITION, partition_id=pid,
                                         arg={"peers": peers, "hosts": hosts}))
                rep = recv_packet(sock)
            except (OSError, ConnectionError):
                self.admin_pool.put(addr, sock, ok=False)
                raise
            self.admin_pool.put(addr, sock)
            if rep.result != RES_OK:
                raise MasterError(f"create dp {pid} on {addr}: {rep.error()}")
        if only is None:
            self.settle(lambda: any(self.rafts[p].is_leader(pid) for p in peers))

    def _purge_client(self) -> ExtentClient:
        """One ExtentClient over every volume's partition table (purge path)."""
        if self._purge_ec is None:
            def all_views():
                views = []
                for vol_name in list(self.master().sm.volumes):
                    views += self.master().data_partition_views(vol_name)
                return views

            self._purge_ec = ExtentClient(all_views)
        self._purge_ec.refresh()
        return self._purge_ec

    def _purge_inode_data(self, inode) -> None:
        """Freelist purge: blobstore locations + replica extents. Raises on
        failure — the metanode keeps the orphan queued and retries."""
        for ext in getattr(inode, "obj_extents", []):
            self.data_backend.delete(ext["loc"])
        keys = getattr(inode, "extents", [])
        if keys:
            self._purge_client().delete_extents(keys)

    def _purge_extent_entry(self, entry: dict) -> None:
        """Truncate-dropped spans (the metanode EXTENT_DEL drain)."""
        for ext in entry.get("obj_extents", []):
            self.data_backend.delete(ext["loc"])
        keys = entry.get("extents", [])
        if keys:
            self._purge_client().delete_extents(keys)

    # -- volumes ---------------------------------------------------------------------

    def create_volume(self, name: str, cold: bool = True,
                      follower_read: bool = False) -> None:
        self.master().create_volume(name, cold=cold,
                                    follower_read=follower_read)

    def volume_names(self) -> list[str]:
        return sorted(self.master().sm.volumes)

    def delete_volume(self, name: str) -> None:
        self.master().delete_volume(name)

    def client(self, volume: str) -> FsClient:
        from chubaofs_tpu_torch.sdk.fs import VolQos

        meta = MetaWrapper(self.master(), self.metanodes, volume)
        vol = self.master().get_volume(volume)

        def fetch_limits():
            v = self.master().get_volume(volume)
            return v.qos_read_mbps, v.qos_write_mbps

        qos = VolQos.from_view(vol, fetch=fetch_limits)
        if vol.cold:
            return FsClient(meta, self.data_backend, cold=True, qos=qos)
        ec = ExtentClient(lambda: self.master().data_partition_views(volume),
                          follower_read=vol.follower_read)
        return FsClient(meta, self.data_backend, hot_backend=HotBackend(ec, meta),
                        cold=False, qos=qos)

    def close(self):
        for dn in self.datanodes.values():
            dn.stop()
        self.admin_pool.close()
        self.blobstore.close()
