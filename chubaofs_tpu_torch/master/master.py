"""Master — the cluster's resource manager, one raft group over all masters.

Reference counterpart: master/ (Server.Start server.go:137-175, single raft
group ID 1, MetadataFsm, Cluster.scheduleTask's 16 background loops
cluster.go:329-3587, IDAllocator id_allocator.go:176-272, vol/meta-partition
management vol.go + meta_partition.go). Kept:

  * every mutation is a raft-applied op on MasterSM (the MetadataFsm analog);
  * volumes own a list of meta partitions, each an inode range [start, end)
    replicated across 3 metanodes; the last partition is unbounded and is SPLIT
    when its cursor approaches the range end (meta_partition splitting);
  * node registry with heartbeats; background check loops are explicit tick
    methods (check_meta_partitions) the deployment pumps, like scheduleTask.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from chubaofs_tpu_torch.raft.server import MultiRaft, StateMachine
from chubaofs_tpu_torch.utils.locks import SanitizedLock

MASTER_GROUP = 1
META_RANGE_STEP = 1 << 24  # inos per partition before splitting
SPLIT_HEADROOM = 1 << 20  # split when cursor is this close to the end
INF = 1 << 63
NODESET_CAPACITY = 18  # nodes per nodeset (master/topology.go default)


class MasterError(Exception):
    pass


@dataclass
class NodeInfo:
    node_id: int
    kind: str  # "meta" | "data"
    addr: str = ""
    raft_addr: str = ""  # TCP raft transport address (daemon mode)
    last_heartbeat: float = 0.0
    partition_count: int = 0
    cursors: dict[int, int] = field(default_factory=dict)  # pid -> cursor (meta)
    status: str = "active"  # active | decommissioned
    zone: str = ""  # fault domain (master/topology.go:43 zones)
    nodeset: int = 0  # zone-local nodeset index (bounded failure groups)
    total_space: int = 0  # bytes, node-reported via heartbeat (statinfo)
    used_space: int = 0
    # pid -> ops served in the node's last heartbeat window (datanode/
    # metanode take_loads() delta) — the hot-volume rebalancer's and the
    # meta splitter's accounting feed
    loads: dict[int, float] = field(default_factory=dict)
    # pid -> replicated split_info for meta partitions FROZEN mid-split on
    # this node (metanode split_reports()) — the resume sweep's feed: a
    # split whose orchestrator died finishes from the partition's own state
    splits: dict[int, dict] = field(default_factory=dict)

    @property
    def schedulable(self) -> bool:
        return getattr(self, "status", "active") == "active"


@dataclass
class MetaPartitionView:
    partition_id: int
    start: int
    end: int  # exclusive; INF for the tail partition
    peers: list[int] = field(default_factory=list)
    leader: int | None = None
    # GENESIS range — the range this partition's raft group was CREATED
    # with, before any split shrank the live view. Every re-create of the
    # partition on a node (respawn re-host, migration replica, replica-count
    # heal) MUST use this range, not start/end: a recovering SM replays its
    # WAL from index 1, and ops recorded before an in-log range change
    # (freeze_range/complete_split/set_range_end) were applied under the
    # genesis range — an SM born with the post-split view range would
    # silently refuse them (OutOfRange/WrongPartition no-ops during replay)
    # and lose committed entries. 0 = derive from start/end at construction.
    start0: int = 0
    end0: int = 0

    def __post_init__(self):
        # creation sites construct views with start/end = the creation
        # range, so capturing it here IS the genesis; restore passes the
        # persisted values explicitly (old snapshots: re-derived — those
        # partitions predate mid-range splits, where view == genesis)
        if not self.start0:
            self.start0 = self.start
        if not self.end0:
            self.end0 = self.end


@dataclass
class DataPartitionView:
    """One replicated data partition (master/data_partition.go analog):
    peers are datanode ids (raft membership), hosts their repl addresses;
    hosts[0] is the chain-replication leader."""

    partition_id: int
    peers: list[int] = field(default_factory=list)
    hosts: list[str] = field(default_factory=list)
    status: str = "rw"  # rw | ro | unavail


@dataclass
class VolumeView:
    name: str
    vol_id: int
    owner: str = ""
    capacity: int = 0
    cold: bool = False  # cold volumes store data in the blobstore (EC tier)
    # reads may hit any replica (relaxed consistency — a follower can trail
    # the leader's latest random overwrite); ref proto/mount_options.go
    # FollowerRead + sdk/data/stream follower-read
    follower_read: bool = False
    # per-volume client QoS (MB/s, 0 = unlimited): the master owns the
    # limits and every client reads them from its volume view, so an
    # operator change flows master -> clients on the next view refresh
    # (ref master/limiter.go qos assignment flowing to clients)
    qos_read_mbps: int = 0
    qos_write_mbps: int = 0
    meta_partitions: list[MetaPartitionView] = field(default_factory=list)
    data_partitions: list[DataPartitionView] = field(default_factory=list)


@dataclass
class UserInfo:
    """master/user.go analog: an identity with S3 credentials + vol policy."""

    user_id: str
    access_key: str
    secret_key: str
    user_type: str = "normal"  # root | admin | normal
    own_vols: list[str] = field(default_factory=list)
    # vol -> granted actions, e.g. ["perm:readonly"] / ["perm:writable"]
    authorized_vols: dict[str, list[str]] = field(default_factory=dict)


class MasterSM(StateMachine):
    """Replicated master state (MetadataFsm + Cluster state analog)."""

    def __init__(self):
        self.nodes: dict[int, NodeInfo] = {}
        self.volumes: dict[str, VolumeView] = {}
        self.users: dict[str, UserInfo] = {}  # user_id -> info
        self.ak_index: dict[str, str] = {}  # access_key -> user_id
        # fault domains group zones (master/topology.go:43 + vol.go domain
        # placement): any assignment turns domain mode ON; unassigned zones
        # act as their own singleton domains
        self.zone_domains: dict[str, str] = {}
        self.next_id = 100  # shared id space for volumes + partitions

    # raft hooks -------------------------------------------------------------

    def apply(self, data, index: int):
        op, args = data
        try:
            return ("ok", getattr(self, "_op_" + op)(**args))
        except MasterError as e:
            return ("err", str(e))

    def snapshot(self) -> bytes:
        """Sectioned CRC-framed snapshot (raft.snapcodec) — the reference
        streams master state as typed RocksDB records (metadata_fsm), never
        as one opaque language-native blob."""
        from dataclasses import asdict

        from chubaofs_tpu_torch.raft import snapcodec

        w = snapcodec.SnapshotWriter()
        w.add("meta", {"next_id": self.next_id,
                       "zone_domains": self.zone_domains})
        w.add_batched("nodes", (asdict(n) for n in self.nodes.values()))
        w.add_batched("volumes", (asdict(v) for v in self.volumes.values()))
        w.add_batched("users", (asdict(u) for u in self.users.values()))
        return w.getvalue()

    def restore(self, payload: bytes) -> None:
        from chubaofs_tpu_torch.raft import snapcodec

        self.nodes, self.volumes, self.users, self.ak_index = {}, {}, {}, {}
        self.zone_domains = {}

        def load_nodes(batch):
            for d in batch:
                d["cursors"] = {int(k): v for k, v in d["cursors"].items()}
                # .get: snapshots from before load accounting existed
                d["loads"] = {int(k): float(v)
                              for k, v in d.get("loads", {}).items()}
                d["splits"] = {int(k): dict(v)
                               for k, v in d.get("splits", {}).items()}
                n = NodeInfo(**d)
                self.nodes[n.node_id] = n

        def load_volumes(batch):
            for d in batch:
                v = VolumeView(
                    name=d["name"], vol_id=d["vol_id"], owner=d["owner"],
                    capacity=d["capacity"], cold=d["cold"],
                    # .get: snapshots from before each option existed
                    follower_read=d.get("follower_read", False),
                    qos_read_mbps=d.get("qos_read_mbps", 0),
                    qos_write_mbps=d.get("qos_write_mbps", 0),
                    meta_partitions=[MetaPartitionView(**m)
                                     for m in d["meta_partitions"]],
                    data_partitions=[DataPartitionView(**p)
                                     for p in d["data_partitions"]],
                )
                self.volumes[v.name] = v

        def load_users(batch):
            for d in batch:
                u = UserInfo(**d)
                self.users[u.user_id] = u
                self.ak_index[u.access_key] = u.user_id

        def load_meta(m):
            self.next_id = m["next_id"]
            # older snapshots predate fault domains
            self.zone_domains = dict(m.get("zone_domains", {}))

        snapcodec.restore_sections(payload, {
            "meta": load_meta,
            "nodes": load_nodes,
            "volumes": load_volumes,
            "users": load_users,
        })

    # ops ---------------------------------------------------------------------

    def _op_alloc_id(self):
        self.next_id += 1
        return self.next_id

    def _op_register_node(self, node_id: int, kind: str, addr: str,
                          raft_addr: str = "", now: float = 0.0,
                          zone: str = ""):
        # `now` is stamped by the PROPOSER: calling time.time() inside apply
        # would make replicas and WAL replay record different values, so a
        # restarted master could trust dead nodes as freshly heartbeaten
        if node_id not in self.nodes:  # racelint: _op_* appliers are serialized by the raft drain pump
            self.nodes[node_id] = NodeInfo(
                node_id, kind, addr, zone=zone,
                nodeset=self._assign_nodeset(kind, zone),
            )
        n = self.nodes[node_id]
        if n.kind != kind:  # operator config error: one id, two roles
            raise MasterError(
                f"node id {node_id} already registered as {n.kind!r}")
        if addr:  # re-registration after restart carries the new address
            n.addr = addr
        if raft_addr:
            n.raft_addr = raft_addr
        if zone and zone != n.zone:
            # late-reported or operator-changed zone: re-home the nodeset too,
            # or the capacity bound would silently break in the new zone
            n.nodeset = self._assign_nodeset(kind, zone)
            n.zone = zone
        n.last_heartbeat = max(n.last_heartbeat, now)
        return node_id

    def _op_set_zone_domain(self, zone: str, domain: str):
        """Assign a zone to a fault domain (master/topology.go:43). An empty
        domain clears the assignment; clearing the last one turns domain
        mode off."""
        if domain:
            self.zone_domains[zone] = domain
        else:
            self.zone_domains.pop(zone, None)
        return dict(self.zone_domains)

    def _assign_nodeset(self, kind: str, zone: str) -> int:
        """Smallest zone-local nodeset with spare capacity — deterministic over
        replicated state, so every replica assigns identically
        (master/topology.go nodeset grouping, capacity-bounded)."""
        counts: dict[int, int] = {}
        for n in self.nodes.values():
            if n.kind == kind and n.zone == zone:
                counts[n.nodeset] = counts.get(n.nodeset, 0) + 1
        ns = 0
        while counts.get(ns, 0) >= NODESET_CAPACITY:
            ns += 1
        return ns

    def _op_heartbeat(self, node_id: int, partition_count: int = 0,
                      cursors: dict | None = None, now: float = 0.0,
                      total_space: int | None = None,
                      used_space: int | None = None,
                      loads: dict | None = None,
                      splits: dict | None = None):
        n = self.nodes.get(node_id)
        if n is None:
            raise MasterError(f"unknown node {node_id}")
        n.last_heartbeat = max(n.last_heartbeat, now)
        if n.status == "inactive":
            n.status = "active"  # liveness recovery; decommissioned stays out
        n.partition_count = partition_count
        # space report (statinfo source, master/cluster.go UpdateStatInfo):
        # None = no report, leaves state alone
        if total_space is not None:
            n.total_space = int(total_space)
        if used_space is not None:
            n.used_space = int(used_space)
        # a dict REPLACES the cursor set (even when empty — a restarted node
        # reports no partitions, and the ensure sweep must see that to re-send
        # create tasks); None means "no report" and leaves state alone
        if cursors is not None:
            n.cursors = {int(k): v for k, v in cursors.items()}
        # per-partition op-load window (same replace-vs-no-report contract)
        if loads is not None:
            n.loads = {int(k): float(v) for k, v in loads.items()}
        # frozen mid-split partitions this node hosts (resume sweep feed)
        if splits is not None:
            n.splits = {int(k): dict(v) for k, v in splits.items()}
        return None

    def _op_create_volume(self, name: str, owner: str, capacity: int, cold: bool,
                          vol_id: int, partition_id: int, peers: list[int],
                          follower_read: bool = False):
        if name in self.volumes:
            raise MasterError(f"volume {name!r} exists")
        vol = VolumeView(name=name, vol_id=vol_id, owner=owner, capacity=capacity,
                         cold=cold, follower_read=follower_read)
        vol.meta_partitions.append(
            MetaPartitionView(partition_id, start=1, end=INF, peers=peers)
        )
        self.volumes[name] = vol
        for p in peers:
            if p in self.nodes:
                self.nodes[p].partition_count += 1
        return vol

    def _op_update_volume(self, name: str, capacity: int | None = None,
                          follower_read: bool | None = None,
                          qos_read_mbps: int | None = None,
                          qos_write_mbps: int | None = None):
        """Vol expand/shrink + option updates (master/vol.go updateVol).
        Capacity is an admin quota: usage enforcement stays with the
        write-time quota charges, so shrinking below current usage stops
        NEW growth rather than deleting data (the reference's semantics)."""
        vol = self.volumes.get(name)
        if vol is None:
            raise MasterError(f"unknown volume {name!r}")
        if capacity is not None:
            if capacity <= 0:
                raise MasterError("capacity must be positive")
            vol.capacity = int(capacity)
        if follower_read is not None:
            vol.follower_read = bool(follower_read)
        if qos_read_mbps is not None:
            vol.qos_read_mbps = max(0, int(qos_read_mbps))
        if qos_write_mbps is not None:
            vol.qos_write_mbps = max(0, int(qos_write_mbps))
        return vol

    def _op_remove_node(self, node_id: int):
        """Prune a registry entry (stale-node pruner); refuses while any
        partition still lists the node."""
        n = self.nodes.get(node_id)
        if n is None:
            return None
        for vol in self.volumes.values():
            for mp in vol.meta_partitions:
                if node_id in mp.peers:
                    raise MasterError(f"node {node_id} still hosts mp")
            for dp in vol.data_partitions:
                if node_id in dp.peers:
                    raise MasterError(f"node {node_id} still hosts dp")
        del self.nodes[node_id]
        return node_id

    def _op_split_partition(self, vol_name: str, partition_id: int, split_at: int,
                            new_partition_id: int, peers: list[int]):
        vol = self.volumes.get(vol_name)
        if vol is None:
            raise MasterError(f"unknown volume {vol_name!r}")
        tail = vol.meta_partitions[-1]
        if tail.partition_id != partition_id:
            raise MasterError("only the tail partition splits")
        tail.end = split_at
        vol.meta_partitions.append(
            MetaPartitionView(new_partition_id, start=split_at, end=INF, peers=peers)
        )
        return vol.meta_partitions[-1]

    def _op_split_partition_mid(self, vol_name: str, partition_id: int,
                                split_at: int, new_partition_id: int,
                                peers: list[int]):
        """THE atomic view swap of a mid-range load split: in one
        master-raft commit the old partition's range shrinks to
        [start, split_at) and the sibling enters the view owning
        [split_at, old_end) — no inode is ever owned by zero or two
        partitions in the authoritative view. Idempotent: a resumed
        orchestrator re-proposing an already-swapped split no-ops."""
        vol = self.volumes.get(vol_name)
        if vol is None:
            raise MasterError(f"unknown volume {vol_name!r}")
        for mp in vol.meta_partitions:
            if mp.partition_id == new_partition_id:
                return mp  # already swapped (resume replay)
        for i, mp in enumerate(vol.meta_partitions):
            if mp.partition_id != partition_id:
                continue
            if not (mp.start < split_at < mp.end):
                raise MasterError(
                    f"split_at {split_at} outside ({mp.start}, {mp.end})")
            new_mp = MetaPartitionView(new_partition_id, start=split_at,
                                       end=mp.end, peers=list(peers))
            mp.end = split_at
            # keep meta_partitions sorted by start: routing (and the tail
            # convention meta_partitions[-1]) depend on range order
            vol.meta_partitions.insert(i + 1, new_mp)
            for p in peers:
                if p in self.nodes:
                    self.nodes[p].partition_count += 1
            return new_mp
        raise MasterError(f"unknown partition {partition_id}")

    def _op_set_partition_leader(self, vol_name: str, partition_id: int, leader: int | None):
        vol = self.volumes.get(vol_name)
        if vol is None:
            raise MasterError(f"unknown volume {vol_name!r}")
        for mp in vol.meta_partitions:
            if mp.partition_id == partition_id:
                mp.leader = leader
                return None
        raise MasterError(f"unknown partition {partition_id}")

    def _op_create_data_partition(self, vol_name: str, partition_id: int,
                                  peers: list[int], hosts: list[str]):
        vol = self.volumes.get(vol_name)
        if vol is None:
            raise MasterError(f"unknown volume {vol_name!r}")
        vol.data_partitions.append(
            DataPartitionView(partition_id, peers=peers, hosts=hosts))
        for p in peers:
            if p in self.nodes:
                self.nodes[p].partition_count += 1
        return vol.data_partitions[-1]

    def _op_update_dp_hosts(self, vol_name: str, partition_id: int, hosts: list[str]):
        vol = self.volumes.get(vol_name)
        if vol is None:
            raise MasterError(f"unknown volume {vol_name!r}")
        for dp in vol.data_partitions:
            if dp.partition_id == partition_id:
                dp.hosts = hosts
                return None
        raise MasterError(f"unknown data partition {partition_id}")

    def _op_set_dp_status(self, vol_name: str, partition_id: int, status: str):
        vol = self.volumes.get(vol_name)
        if vol is None:
            raise MasterError(f"unknown volume {vol_name!r}")
        for dp in vol.data_partitions:
            if dp.partition_id == partition_id:
                dp.status = status
                return None
        raise MasterError(f"unknown data partition {partition_id}")

    def _op_delete_volume(self, name: str):
        vol = self.volumes.pop(name, None)
        if vol is None:
            raise MasterError(f"unknown volume {name!r}")
        for u in self.users.values():
            if name in u.own_vols:
                u.own_vols.remove(name)
            u.authorized_vols.pop(name, None)
        return vol

    # -- decommission bookkeeping (master decommission APIs) -------------------

    def _op_set_node_status(self, node_id: int, status: str):
        n = self.nodes.get(node_id)
        if n is None:
            raise MasterError(f"unknown node {node_id}")
        n.status = status
        return None

    def _op_update_mp_peers(self, vol_name: str, partition_id: int,
                            peers: list[int]):
        vol = self.volumes.get(vol_name)
        if vol is None:
            raise MasterError(f"unknown volume {vol_name!r}")
        for mp in vol.meta_partitions:
            if mp.partition_id == partition_id:
                mp.peers = list(peers)
                return None
        raise MasterError(f"unknown partition {partition_id}")

    def _op_update_dp_members(self, vol_name: str, partition_id: int,
                              peers: list[int], hosts: list[str]):
        vol = self.volumes.get(vol_name)
        if vol is None:
            raise MasterError(f"unknown volume {vol_name!r}")
        for dp in vol.data_partitions:
            if dp.partition_id == partition_id:
                dp.peers = list(peers)
                dp.hosts = list(hosts)
                return None
        raise MasterError(f"unknown data partition {partition_id}")

    # -- user store (master/user.go analog) -----------------------------------

    def _op_create_user(self, user_id: str, access_key: str, secret_key: str,
                        user_type: str = "normal"):
        if user_id in self.users:
            raise MasterError(f"user {user_id!r} exists")
        if access_key in self.ak_index:
            raise MasterError("duplicate access key")
        u = UserInfo(user_id, access_key, secret_key, user_type)
        self.users[user_id] = u
        self.ak_index[access_key] = user_id
        return u

    def _op_delete_user(self, user_id: str):
        u = self.users.get(user_id)
        if u is None:
            raise MasterError(f"unknown user {user_id!r}")
        if u.own_vols:
            raise MasterError(f"user {user_id!r} still owns volumes {u.own_vols}")
        del self.users[user_id]
        self.ak_index.pop(u.access_key, None)
        return None

    def _op_user_own_vol(self, user_id: str, vol_name: str, add: bool):
        u = self.users.get(user_id)
        if u is None:
            raise MasterError(f"unknown user {user_id!r}")
        if add and vol_name not in u.own_vols:
            u.own_vols.append(vol_name)
        if not add and vol_name in u.own_vols:
            u.own_vols.remove(vol_name)
        return u

    def _op_update_user_policy(self, user_id: str, vol_name: str,
                               actions: list[str], grant: bool):
        u = self.users.get(user_id)
        if u is None:
            raise MasterError(f"unknown user {user_id!r}")
        if grant:
            u.authorized_vols[vol_name] = list(actions)
        else:
            u.authorized_vols.pop(vol_name, None)
        return u


class Master:
    """Leader-side service facade over the replicated MasterSM.

    The deployment wires `metanode_hook(partition_id, start, end, peers)` so
    partition creation reaches the metanodes (admin-task analog of
    master/cluster_task.go).
    """

    def __init__(self, raft: MultiRaft, sm: MasterSM):
        import threading

        self.raft = raft
        self.sm = sm
        # one migration at a time: an HTTP client retrying a slow decommission
        # must not start a second concurrent membership-change dance
        self._decomm_lock = threading.Lock()
        self.metanode_hook = None  # (pid, start, end, peers) -> None
        self.datanode_hook = None  # (pid, peers, hosts) -> None
        # decommission plumbing (deployment-wired, like the create hooks):
        # raft_config_hook(kind, pid, action, node_id, peers) proposes a
        # membership change on the partition's raft leader;
        # remove_partition_hook(kind, pid, node_id) drops the group+state on
        # the retired replica
        self.raft_config_hook = None
        self.remove_partition_hook = None
        # metadata-op plumbing for the mid-range split orchestrator
        # (deployment-wired): meta_op_hook(pid, peers, op, args, read=False)
        # runs one metanode op on the partition's leader with retry/hint
        # handling and returns its result
        self.meta_op_hook = None
        # load-split trigger: a meta partition whose heartbeat-window op
        # count reaches this splits at its median live inode. 0 = off (the
        # operator or the capacity harness triggers explicit splits instead).
        # CFS_META_SPLIT_OPS env / metaSplitOps daemon config.
        import os as _os

        try:
            self.meta_split_ops = float(
                _os.environ.get("CFS_META_SPLIT_OPS", "0") or 0)
        except ValueError:
            self.meta_split_ops = 0.0
        # nodes already fully drained by the dead-node sweep; in-memory only
        # (rebuilt by one sweep after a restart), cleared on returning heartbeat.
        # Own micro-lock: heartbeat clears this set on its hot path and must
        # never wait out a migration-length _decomm_lock hold
        self._drained_lock = SanitizedLock(name="master.drained")
        self._dead_drained: set[int] = set()

    def _apply(self, op: str, **args):
        # rides raft group commit: concurrent admin/heartbeat handler threads
        # coalesce into shared WAL-flush + replication rounds on GroupID=1
        res = self.raft.propose(MASTER_GROUP, (op, args)).result(timeout=5)
        if res[0] == "err":
            raise MasterError(res[1])
        return res[1]

    def _apply_batch(self, ops: list[tuple[str, dict]], timeout: float = 5.0) -> list:
        """Propose many master ops as ONE drained raft batch (one WAL flush,
        one replication fan-out); results FIFO, each op failing alone."""
        futs = self.raft.propose_batch(MASTER_GROUP, [(op, args) for op, args in ops])
        out = []
        for fut in futs:
            res = fut.result(timeout=timeout)
            if res[0] == "err":
                raise MasterError(res[1])
            out.append(res[1])
        return out

    @property
    def is_leader(self) -> bool:
        return self.raft.is_leader(MASTER_GROUP)

    # -- node admin -----------------------------------------------------------

    def register_node(self, node_id: int, kind: str, addr: str = "",
                      raft_addr: str = "", zone: str = "") -> None:
        self._apply("register_node", node_id=node_id, kind=kind, addr=addr,
                    raft_addr=raft_addr, now=time.time(), zone=zone)

    def set_zone_domain(self, zone: str, domain: str) -> dict:
        """Assign/clear a zone's fault domain (replicated)."""
        return self._apply("set_zone_domain", zone=zone, domain=domain)

    def topology(self) -> dict:
        """zones -> nodesets -> node ids (master/topology.go view analog)."""
        out: dict[str, dict[int, list[int]]] = {}
        for n in self.sm.nodes.values():
            out.setdefault(n.zone, {}).setdefault(n.nodeset, []).append(n.node_id)
        for zone in out.values():
            for ids in zone.values():
                ids.sort()
        return out

    def heartbeat(self, node_id: int, partition_count: int = 0,
                  cursors: dict | None = None,
                  total_space: int | None = None,
                  used_space: int | None = None,
                  loads: dict | None = None,
                  splits: dict | None = None):
        # a returning node may receive new placements again, so the dead-node
        # sweep must re-examine it if it dies a second time
        with self._drained_lock:
            self._dead_drained.discard(node_id)
        self._apply("heartbeat", node_id=node_id, partition_count=partition_count,
                    cursors=cursors, now=time.time(),
                    total_space=total_space, used_space=used_space,
                    loads=loads, splits=splits)

    def cluster_stat(self) -> dict:
        """Cluster/zone space + health rollup from node heartbeat reports.

        Reference: Cluster.scheduleToUpdateStatInfo (master/cluster.go:335)
        maintains this in a ticker; here the rollup derives on read — the
        node table is small and raft-replicated, so a loop would only add
        staleness."""
        def bucket():
            return {"total_space": 0, "used_space": 0, "nodes": 0, "active": 0}

        def kbucket():  # a rollup with nested per-kind sub-rollups
            return {**bucket(), "data": bucket(), "meta": bucket()}

        zones: dict[str, dict] = {}
        # per-kind rollups, like the reference's separate DataNodeStatInfo /
        # MetaNodeStatInfo (proto/model.go:162): metanode WAL-dir capacity
        # must not inflate storage capacity. The top-level total/used fields
        # remain the MERGED sum (all node kinds) for dashboard backward-compat.
        total = {**kbucket(), "meta_partitions": 0, "data_partitions": 0}
        for n in self.sm.nodes.values():
            z = zones.setdefault(n.zone, kbucket())
            for agg in (z, total, total[n.kind], z[n.kind]):
                agg["total_space"] += n.total_space
                agg["used_space"] += n.used_space
                agg["nodes"] += 1
                agg["active"] += 1 if n.status == "active" else 0
        for vol in self.sm.volumes.values():
            total["meta_partitions"] += len(vol.meta_partitions)
            total["data_partitions"] += len(vol.data_partitions)
        total["volumes"] = len(self.sm.volumes)
        total["zones"] = zones
        return total

    # -- volume admin -----------------------------------------------------------

    def domain_of(self, zone: str) -> str:
        """Fault domain owning a zone; unassigned zones are their own
        singleton domains (reference default-domain behavior)."""
        return self.sm.zone_domains.get(zone, zone)

    def _spread_by_zone(self, cands: list[NodeInfo], count: int,
                        kind: str) -> list[NodeInfo]:
        """Fault-domain- and zone-aware replica spread (master/topology.go
        placement contract + vol.go domain mode): with domain assignments
        present, replicas spread one-per-DOMAIN first — so a whole-domain
        loss (power/network failure of several co-dependent zones) leaves
        count-1 replicas when >= count domains exist — then per zone inside
        each domain; without assignments, domains degenerate to zones and
        the behavior is the plain zone spread. With fewer groups than
        `count`, round-robin so no group holds two replicas before every
        group holds one. (Decommission/dead-node replacements go through
        _pick_addition, which adds survivor-aware zone/domain bias.)"""
        if len(cands) < count:
            raise MasterError(f"need {count} {kind}nodes, have {len(cands)}")
        by_zone: dict[str, list[NodeInfo]] = {}
        for n in sorted(cands, key=lambda n: n.partition_count):
            by_zone.setdefault(n.zone, []).append(n)
        # group zones into domains; inside a domain, zones interleave so the
        # secondary spread (across zones within the picked domain) holds too
        by_domain: dict[str, list[NodeInfo]] = {}
        for zone, ns in by_zone.items():
            by_domain.setdefault(self.domain_of(zone), []).append(ns)
        groups = []
        for zone_lists in by_domain.values():
            zone_lists.sort(key=lambda ns: ns[0].partition_count)
            merged: list[NodeInfo] = []
            rank = 0
            while any(rank < len(ns) for ns in zone_lists):
                for ns in zone_lists:
                    if rank < len(ns):
                        merged.append(ns[rank])
                rank += 1
            groups.append(merged)
        groups.sort(key=lambda ns: ns[0].partition_count)
        picked: list[NodeInfo] = []
        if len(groups) >= count:
            for ns in groups[:count]:
                picked.append(ns[0])
        else:
            rank = 0
            while len(picked) < count:
                advanced = False
                for ns in groups:
                    if rank < len(ns):
                        picked.append(ns[rank])
                        advanced = True
                        if len(picked) == count:
                            break
                if not advanced:
                    raise MasterError(f"need {count} {kind}nodes, have {len(picked)}")
                rank += 1
        return picked

    def _pick_addition(self, kind: str, survivors: list[int],
                       prefer_zone: str | None = None,
                       exclude: set[int] = frozenset()) -> NodeInfo:
        """One extra replica for a partition that keeps `survivors`. With
        `prefer_zone` (a migration victim's zone) still healthy, stay there —
        the replacement preserves the existing spread by construction.
        Otherwise candidates rank by NOT sharing a fault domain with any
        survivor, then not sharing a zone, then emptiest — so whole-domain
        losses re-home (and under-replication heals) into a domain/zone that
        does not already hold a replica (vol.go domain placement on the
        repair path). `exclude` bars extra nodes (the migration VICTIM) from
        candidacy WITHOUT counting them in the spread ranking: the victim's
        domain is exactly where a replica is no longer held."""
        barred = set(survivors) | set(exclude)
        cands = [n for n in self.sm.nodes.values()
                 if n.kind == kind and n.schedulable
                 and n.node_id not in barred]
        if not cands:
            raise MasterError(f"need 1 {kind}node, have 0")
        if prefer_zone is not None:
            in_zone = [n for n in cands if n.zone == prefer_zone]
            if in_zone:
                return min(in_zone, key=lambda n: n.partition_count)
        surv_zones = {self.sm.nodes[p].zone for p in survivors
                      if p in self.sm.nodes}
        surv_doms = {self.domain_of(z) for z in surv_zones}
        return min(cands, key=lambda n: (
            self.domain_of(n.zone) in surv_doms,
            n.zone in surv_zones,
            n.partition_count,
        ))

    def _pick_meta_peers(self, count: int = 3,
                         exclude: set[int] = frozenset()) -> list[int]:
        metas = [n for n in self.sm.nodes.values()
                 if n.kind == "meta" and n.schedulable and n.node_id not in exclude]
        return [n.node_id
                for n in self._spread_by_zone(metas, count, "meta")]

    def _pick_data_peers(self, count: int = 3,
                         exclude: set[int] = frozenset()) -> list[NodeInfo]:
        datas = [n for n in self.sm.nodes.values()
                 if n.kind == "data" and n.schedulable and n.node_id not in exclude]
        return self._spread_by_zone(datas, count, "data")

    def create_volume(self, name: str, owner: str = "", capacity: int = 1 << 40,
                      cold: bool = False, data_partitions: int = 3,
                      follower_read: bool = False) -> VolumeView:
        # both ids in one drained raft batch: one commit round, not two
        vol_id, pid = self._apply_batch([("alloc_id", {}), ("alloc_id", {})])
        peers = self._pick_meta_peers()
        vol = self._apply(
            "create_volume", name=name, owner=owner, capacity=capacity, cold=cold,
            vol_id=vol_id, partition_id=pid, peers=peers,
            follower_read=follower_read,
        )
        if self.metanode_hook:
            self.metanode_hook(pid, 1, INF, peers)
        if not cold:
            for _ in range(data_partitions):
                self.create_data_partition(name)
        return self.sm.volumes[name]

    def create_data_partition(self, vol_name: str) -> DataPartitionView:
        """Place one 3-replica data partition on the emptiest datanodes
        (master/vol.go createDataPartition analog)."""
        dp_id = self._apply("alloc_id")
        nodes = self._pick_data_peers()
        view = self._apply(
            "create_data_partition", vol_name=vol_name, partition_id=dp_id,
            peers=[n.node_id for n in nodes], hosts=[n.addr for n in nodes],
        )
        if self.datanode_hook:
            self.datanode_hook(dp_id, view.peers, view.hosts)
        return view

    def _current_hosts(self, peers: list[int], stored: list[str]) -> list[str]:
        """Resolve replica addresses from the live node registry; datanode
        addresses change across restarts (ephemeral ports in tests)."""
        out = []
        for i, p in enumerate(peers):
            n = self.sm.nodes.get(p)
            out.append(n.addr if n and n.addr else (stored[i] if i < len(stored) else ""))
        return out

    def data_partition_views(self, vol_name: str) -> list[dict]:
        """Client-facing partition table (the ExtentClient refresh feed)."""
        vol = self.get_volume(vol_name)
        return [
            {"pid": dp.partition_id, "peers": list(dp.peers),
             "hosts": self._current_hosts(dp.peers, dp.hosts)}
            for dp in vol.data_partitions if dp.status == "rw"
        ]

    def refresh_dp_hosts(self) -> int:
        """Re-resolve stored dp.hosts from the registry (restart path)."""
        if not self.is_leader:
            return 0
        fixed = 0
        for vol in list(self.sm.volumes.values()):
            for dp in vol.data_partitions:
                hosts = self._current_hosts(dp.peers, dp.hosts)
                if hosts != dp.hosts:
                    self._apply("update_dp_hosts", vol_name=vol.name,
                                partition_id=dp.partition_id, hosts=hosts)
                    fixed += 1
        return fixed

    def get_volume(self, name: str) -> VolumeView:
        vol = self.sm.volumes.get(name)
        if vol is None:
            raise MasterError(f"unknown volume {name!r}")
        return vol

    def delete_volume(self, name: str) -> None:
        self._apply("delete_volume", name=name)

    # -- user admin (master/user.go analog) -----------------------------------

    def create_user(self, user_id: str, user_type: str = "normal",
                    access_key: str | None = None,
                    secret_key: str | None = None) -> UserInfo:
        import secrets
        import string

        alphabet = string.ascii_letters + string.digits
        # caller-supplied credentials are allowed (deterministic keys let
        # an operator declare them in a gateway's CFS_QOS_TENANTS before
        # the user exists); otherwise mint random ones
        ak = access_key or "".join(secrets.choice(alphabet)
                                   for _ in range(16))
        sk = secret_key or "".join(secrets.choice(alphabet)
                                   for _ in range(32))
        self._apply("create_user", user_id=user_id, access_key=ak,
                    secret_key=sk, user_type=user_type)
        return self.sm.users[user_id]

    def delete_user(self, user_id: str) -> None:
        self._apply("delete_user", user_id=user_id)

    def get_user(self, user_id: str) -> UserInfo:
        u = self.sm.users.get(user_id)
        if u is None:
            raise MasterError(f"unknown user {user_id!r}")
        return u

    def user_by_ak(self, access_key: str) -> UserInfo:
        uid = self.sm.ak_index.get(access_key)
        if uid is None:
            raise MasterError(f"unknown access key {access_key!r}")
        return self.sm.users[uid]

    def update_user_policy(self, user_id: str, vol_name: str,
                           actions: list[str], grant: bool = True) -> UserInfo:
        self._apply("update_user_policy", user_id=user_id, vol_name=vol_name,
                    actions=list(actions), grant=grant)
        return self.sm.users[user_id]

    def set_vol_owner(self, user_id: str, vol_name: str, add: bool = True) -> None:
        self._apply("user_own_vol", user_id=user_id, vol_name=vol_name, add=add)

    # -- decommission (master decommission APIs + migrate orchestration) -------
    #
    # The reference drains a node by re-homing every partition replica it
    # hosts (master decommission flows in cluster.go/vol.go). Per partition
    # the safe single-server dance is: create the group on the replacement
    # (it catches up via raft snapshot/appends) -> propose add(replacement)
    # -> propose remove(victim) -> drop state on the victim -> record the new
    # membership. Chain data (hot extents) back-fills through the extent
    # repair sweep once the replacement is in the hosts list.

    def decommission_metanode(self, node_id: int) -> int:
        if self.sm.nodes.get(node_id) is None:
            raise MasterError(f"unknown node {node_id}")
        self._apply("set_node_status", node_id=node_id, status="decommissioned")
        with self._decomm_lock:
            moved = self._migrate_metanode(node_id)
        from chubaofs_tpu_torch.utils import events

        events.emit("node_decommissioned", events.SEV_WARNING,
                    entity=f"node{node_id}",
                    detail={"node_id": node_id, "kind": "meta",
                            "moved": moved})
        return moved

    def _move_mp_replica(self, vol, mp, node_id: int,
                         prefer_zone: str | None = None,
                         repl: int | None = None,
                         reason: str = "decommission") -> None:
        """Move one meta-partition replica off node_id (decommission,
        dead-node re-home and hot-partition rebalance all share this step):
        create the group on the replacement (it catches up via raft
        snapshot/appends) -> propose add(replacement) -> propose
        remove(victim) -> drop state on the victim -> record the new
        membership. An explicit `repl` (the rebalancer's load-ranked pick)
        skips the zone/domain-ranked _pick_addition. Emits `meta_migrate`
        at the add-peer and remove-peer transitions so cfs-events can
        reconstruct the move."""
        from chubaofs_tpu_torch.utils import events

        survivors = [p for p in mp.peers if p != node_id]
        if repl is None:
            repl = self._pick_addition(
                "meta", survivors, exclude={node_id},
                prefer_zone=prefer_zone).node_id
        new_peers = survivors + [repl]
        if self.metanode_hook:
            # replacement-only create with the final membership — at the
            # GENESIS range: the new replica may catch up via appends from
            # index 1, and replaying under the post-split view range would
            # drop committed entries (the in-log range ops re-shrink it)
            self.metanode_hook(mp.partition_id, mp.start0, mp.end0,
                               new_peers, only=repl)
        events.emit("meta_migrate", entity=f"mp{mp.partition_id}",
                    detail={"partition": mp.partition_id, "vol": vol.name,
                            "victim": node_id, "replacement": repl,
                            "phase": "add_peer", "reason": reason})
        if self.raft_config_hook:
            self.raft_config_hook("meta", mp.partition_id, "add",
                                  repl, mp.peers)
            # contact set for the remove must still include the victim:
            # it is often the group's raft leader and must propose its
            # own removal (then step down on apply)
            self.raft_config_hook("meta", mp.partition_id, "remove",
                                  node_id, mp.peers + [repl])
        if self.remove_partition_hook:
            self.remove_partition_hook("meta", mp.partition_id, node_id)
        self._apply("update_mp_peers", vol_name=vol.name,
                    partition_id=mp.partition_id, peers=new_peers)
        events.emit("meta_migrate", entity=f"mp{mp.partition_id}",
                    detail={"partition": mp.partition_id, "vol": vol.name,
                            "victim": node_id, "replacement": repl,
                            "phase": "remove_peer", "reason": reason})

    def _migrate_metanode(self, node_id: int) -> int:
        moved = 0
        zone = self.sm.nodes[node_id].zone
        for vol in list(self.sm.volumes.values()):
            for mp in vol.meta_partitions:
                if node_id not in mp.peers:
                    continue
                self._move_mp_replica(vol, mp, node_id, prefer_zone=zone)
                moved += 1
        return moved

    def decommission_datanode(self, node_id: int) -> int:
        if self.sm.nodes.get(node_id) is None:
            raise MasterError(f"unknown node {node_id}")
        self._apply("set_node_status", node_id=node_id, status="decommissioned")
        with self._decomm_lock:
            moved = self._migrate_datanode(node_id)
        from chubaofs_tpu_torch.utils import events

        events.emit("node_decommissioned", events.SEV_WARNING,
                    entity=f"node{node_id}",
                    detail={"node_id": node_id, "kind": "data",
                            "moved": moved})
        return moved

    def _move_dp_replica(self, vol, dp, node_id: int,
                         prefer_zone: str | None = None,
                         repl: NodeInfo | None = None,
                         reason: str = "decommission") -> None:
        """Move one dp replica off node_id (decommission, dead-node re-home,
        spread-repair and hot-volume rebalance all share this step). An
        explicit `repl` (the rebalancer's load-ranked pick) skips the
        zone/domain-ranked _pick_addition. `reason` tags the timeline event
        so a rebalance move and a decommission drain are distinguishable
        forensics."""
        if repl is None:
            repl = self._pick_addition(
                "data", [p for p in dp.peers if p != node_id],
                exclude={node_id},
                prefer_zone=prefer_zone)
        idx = dp.peers.index(node_id)
        new_peers = [p for p in dp.peers if p != node_id] + [repl.node_id]
        hosts = self._current_hosts(dp.peers, dp.hosts)
        new_hosts = [h for i, h in enumerate(hosts) if i != idx] + [repl.addr]
        if self.datanode_hook:
            self.datanode_hook(dp.partition_id, new_peers, new_hosts,
                               only=repl.node_id)
        if self.raft_config_hook:
            self.raft_config_hook("data", dp.partition_id, "add",
                                  repl.node_id, dp.peers)
            # include the victim in the contact set (see metanode path)
            self.raft_config_hook("data", dp.partition_id, "remove",
                                  node_id, dp.peers + [repl.node_id])
        if self.remove_partition_hook:
            self.remove_partition_hook("data", dp.partition_id, node_id)
        self._apply("update_dp_members", vol_name=vol.name,
                    partition_id=dp.partition_id, peers=new_peers,
                    hosts=new_hosts)
        if self.datanode_hook:
            # idempotent re-send refreshes peers/hosts on survivors
            # (their local meta still lists the victim)
            self.datanode_hook(dp.partition_id, new_peers, new_hosts)
        from chubaofs_tpu_torch.utils import events

        events.emit("partition_moved", entity=f"dp{dp.partition_id}",
                    detail={"partition": dp.partition_id, "vol": vol.name,
                            "victim": node_id, "replacement": repl.node_id,
                            "reason": reason})

    def _migrate_datanode(self, node_id: int) -> int:
        moved = 0
        zone = self.sm.nodes[node_id].zone
        for vol in list(self.sm.volumes.values()):
            for dp in vol.data_partitions:
                if node_id not in dp.peers:
                    continue
                self._move_dp_replica(vol, dp, node_id, prefer_zone=zone,
                                      reason="decommission")
                moved += 1
        return moved

    def check_replica_spread(self) -> int:
        """Spread-repair sweep: a partition whose replicas CONCENTRATE in one
        fault domain — the residue of re-homing while several domains were
        dark — moves a doubled replica into an unrepresented healthy domain
        once one exists again (the reference's balance machinery applied to
        the domain axis). Data partitions only: mp moves are heavier
        (snapshot transfer) and the same residue heals on the next mp
        migration anyway."""
        if not self.is_leader:
            return 0
        moved = 0
        for vol in list(self.sm.volumes.values()):
            for dp in vol.data_partitions:
                by_dom: dict[str, list[int]] = {}
                for p in dp.peers:
                    n = self.sm.nodes.get(p)
                    if n is None or not n.schedulable:
                        continue  # dead peers are the re-home sweep's job
                    by_dom.setdefault(self.domain_of(n.zone), []).append(p)
                doubled = [ps for ps in by_dom.values() if len(ps) >= 2]
                if not doubled:
                    continue
                free_doms = {
                    self.domain_of(n.zone)
                    for n in self.sm.nodes.values()
                    if n.kind == "data" and n.schedulable
                    and n.node_id not in dp.peers
                } - set(by_dom)
                if not free_doms:
                    continue
                victim = max(
                    doubled[0],
                    key=lambda p: self.sm.nodes[p].partition_count)
                try:
                    self._move_dp_replica(vol, dp, victim,
                                          reason="spread_repair")
                    moved += 1
                except MasterError:
                    pass  # no capacity after all; retried next sweep
        return moved

    # -- hot-volume spreading (the capacity harness's actuator) -----------------

    def data_node_loads(self) -> dict[int, float]:
        """node_id -> total ops in the last heartbeat window, schedulable
        datanodes only — the per-node ops-spread view cfs-capacity's A/B
        measures (and rebalance_hot acts on)."""
        return {n.node_id: sum(n.loads.values())
                for n in self.sm.nodes.values()
                if n.kind == "data" and n.schedulable}

    def _find_dp(self, pid: int):
        for vol in self.sm.volumes.values():
            for dp in vol.data_partitions:
                if dp.partition_id == pid:
                    return vol, dp
        return None, None

    def rebalance_hot(self, factor: float = 1.5, max_moves: int = 2) -> int:
        """Hot-volume spreading under skewed load: any schedulable datanode
        whose heartbeat-window op load exceeds `factor` x the mean sheds its
        hottest data-partition replicas onto the coldest nodes not already
        hosting them, through the same create->raft-add->raft-remove->drop
        migration dance decommission uses (_move_dp_replica). Zipfian access
        concentrates leaders; this is the knob that actually fixes the
        hotspots the capacity harness finds. A move must strictly improve
        the pair (target load + partition load < source load) or it is
        skipped — the sweep converges instead of ping-ponging replicas.
        Bounded at `max_moves` per sweep so rebalancing traffic (replica
        catch-up rides the repair path) never dominates foreground IO.
        Domain concentration a load-ranked pick may introduce is healed by
        check_replica_spread, the same residue contract re-homing has."""
        if not self.is_leader:
            return 0
        with self._decomm_lock:
            datas = {n.node_id: n for n in self.sm.nodes.values()
                     if n.kind == "data" and n.schedulable}
            if len(datas) < 2:
                return 0
            # local bookkeeping copy: replicated NodeInfo.loads must only
            # mutate inside raft apply, but the sweep still needs to account
            # its own moves so one pass doesn't dogpile a single cold node
            loads = {nid: sum(n.loads.values()) for nid, n in datas.items()}
            total = sum(loads.values())
            if total <= 0:
                return 0
            mean = total / len(loads)
            moved = 0
            for nid in sorted(loads, key=loads.get, reverse=True):
                if moved >= max_moves:
                    break
                # snapshot ONCE: the raft apply thread REPLACES n.loads on
                # every heartbeat, and a double attribute read (iterable +
                # key fn) could straddle the swap — .get(old_pid) -> None
                # would crash the sort mid-sweep
                pid_loads = dict(datas[nid].loads)
                for pid in sorted(pid_loads, key=pid_loads.get, reverse=True):
                    if loads[nid] <= factor * mean:
                        break  # shed enough; next hot node
                    pid_load = pid_loads.get(pid, 0.0)
                    if pid_load <= 0:
                        break
                    vol, dp = self._find_dp(pid)
                    if dp is None or nid not in dp.peers:
                        continue  # meta pid, or a replica already moved
                    cands = [n for n in datas.values()
                             if n.node_id not in dp.peers]
                    if not cands:
                        continue
                    target = min(cands, key=lambda n: (loads[n.node_id],
                                                       n.partition_count))
                    if loads[target.node_id] + pid_load >= loads[nid]:
                        continue  # would not strictly improve the pair
                    try:
                        self._move_dp_replica(vol, dp, nid, repl=target,
                                              reason="rebalance_hot")
                    except MasterError:
                        continue  # no capacity after all; retried next sweep
                    loads[nid] -= pid_load
                    loads[target.node_id] += pid_load
                    moved += 1
                    if moved >= max_moves:
                        break
            return moved

    # -- metadata scale-out: load split + cross-metanode rebalance -------------

    def meta_node_loads(self) -> dict[int, float]:
        """node_id -> total meta ops in the last heartbeat window,
        schedulable metanodes only (the rebalance/split accounting view)."""
        return {n.node_id: sum(n.loads.values())
                for n in self.sm.nodes.values()
                if n.kind == "meta" and n.schedulable}

    def _find_meta_mp(self, pid: int):
        for vol in self.sm.volumes.values():
            for mp in vol.meta_partitions:
                if mp.partition_id == pid:
                    return vol, mp
        return None, None

    def meta_partition_loads(self) -> dict[int, float]:
        """pid -> hottest replica's heartbeat-window op count (the leader
        serves every client op, so max-across-replicas IS the serving load).
        Inactive nodes are excluded: loads only refresh on a heartbeat, so
        a dead node's window is frozen at its last report — a ghost that
        would re-split the same partition every sweep."""
        out: dict[int, float] = {}
        for n in self.sm.nodes.values():
            if n.kind != "meta" or n.status != "active":
                continue
            for pid, load in n.loads.items():
                out[pid] = max(out.get(pid, 0.0), float(load))
        return out

    def rebalance_meta(self, factor: float = 1.5, max_moves: int = 1) -> int:
        """Cross-metanode migration of hot meta partitions: any schedulable
        metanode whose heartbeat-window op load exceeds `factor` x the mean
        sheds its hottest partition replicas onto the coldest metanodes not
        already in the peer set, through the same create -> raft-add ->
        raft-remove -> drop dance decommission uses (_move_mp_replica).
        The data plane has this as rebalance_hot; this is the meta
        plane's analog. Strict-improvement gated so the sweep converges,
        bounded at `max_moves` (mp moves ship a namespace snapshot — heavier
        than a dp replica, so the default is conservative)."""
        if not self.is_leader:
            return 0
        with self._decomm_lock:
            # active only: a dead node's load window is frozen at its last
            # heartbeat (a ghost shedder), and worse, its idle-looking
            # window makes it the coldest MOVE TARGET
            metas = {n.node_id: n for n in self.sm.nodes.values()
                     if n.kind == "meta" and n.schedulable
                     and n.status == "active"}
            if len(metas) < 2:
                return 0
            loads = {nid: sum(n.loads.values()) for nid, n in metas.items()}
            total = sum(loads.values())
            if total <= 0:
                return 0
            mean = total / len(loads)
            moved = 0
            for nid in sorted(loads, key=loads.get, reverse=True):
                if moved >= max_moves:
                    break
                # snapshot ONCE (rebalance_hot rationale): the raft applier
                # REPLACES n.loads on every heartbeat mid-sweep
                pid_loads = dict(metas[nid].loads)
                for pid in sorted(pid_loads, key=pid_loads.get, reverse=True):
                    if loads[nid] <= factor * mean:
                        break  # shed enough; next hot node
                    pid_load = pid_loads.get(pid, 0.0)
                    if pid_load <= 0:
                        break
                    vol, mp = self._find_meta_mp(pid)
                    if mp is None or nid not in mp.peers:
                        continue  # data pid, or a replica already moved
                    cands = [n for n in metas.values()
                             if n.node_id not in mp.peers]
                    if not cands:
                        continue
                    target = min(cands, key=lambda n: (loads[n.node_id],
                                                       n.partition_count))
                    if loads[target.node_id] + pid_load >= loads[nid]:
                        continue  # would not strictly improve the pair
                    try:
                        self._move_mp_replica(vol, mp, nid,
                                              repl=target.node_id,
                                              reason="rebalance_meta")
                    except MasterError:
                        continue  # no capacity after all; retried next sweep
                    loads[nid] -= pid_load
                    loads[target.node_id] += pid_load
                    moved += 1
                    if moved >= max_moves:
                        break
            return moved

    def split_meta_partition(self, vol_name: str, partition_id: int) -> int:
        """Operator/bench entry: load-split ONE named partition at its
        median live inode, now. Returns the sibling's pid (0 = partition
        declined: too few live inodes, or a 2PC txn in flight)."""
        vol = self.get_volume(vol_name)
        mp = next((m for m in vol.meta_partitions
                   if m.partition_id == partition_id), None)
        if mp is None:
            raise MasterError(f"unknown meta partition {partition_id}")
        with self._decomm_lock:
            try:
                return self._split_meta_partition(vol, mp)
            except Exception as e:
                if getattr(e, "code", None) == "ETXCONFLICT":
                    # the documented decline (prepared 2PC txns in flight,
                    # bounded by TX_TTL), not an error: retry shortly
                    return 0
                raise

    def resume_meta_splits(self) -> int:
        """Finish splits whose orchestrator died mid-flight: metanode
        heartbeats report frozen partitions (NodeInfo.splits), and every
        step of _split_meta_partition is idempotent, so re-driving from the
        replicated split_info converges. A frozen partition that already
        left the view is unfrozen (volume deleted mid-split)."""
        if not self.is_leader:
            return 0
        finished = 0
        seen: set[int] = set()
        for n in list(self.sm.nodes.values()):
            if n.kind != "meta":
                continue
            for pid, info in dict(n.splits).items():
                if pid in seen:
                    continue
                seen.add(pid)
                vol, mp = self._find_meta_mp(pid)
                if mp is None:
                    if self.meta_op_hook:
                        try:
                            self.meta_op_hook(pid, [n.node_id],
                                              "unfreeze_range", {})
                        except Exception:
                            pass  # node may be rebooting; retried next sweep
                    continue
                with self._decomm_lock:
                    try:
                        if self._split_meta_partition(vol, mp, resume=info):
                            finished += 1
                    except Exception:
                        # a mid-resume replica crash surfaces as a hook
                        # timeout/OpError: the partition stays frozen and
                        # the next sweep re-resumes — never kill the sweep
                        pass
        return finished

    def _split_meta_partition(self, vol, mp, resume: dict | None = None) -> int:
        """Drive one mid-range split end to end (caller holds _decomm_lock):
        freeze the upper half at the median -> snapshot-copy it into a
        sibling raft group -> atomically swap the volume view in one master
        commit -> drop the moved entries. Any failure leaves the partition
        FROZEN with a replicated resume record; resume_meta_splits finishes
        it. Returns the sibling pid, 0 when the partition declines."""
        from chubaofs_tpu_torch.utils import events

        if self.meta_op_hook is None or self.metanode_hook is None:
            return 0
        old_end = mp.end
        if resume is None:
            split_at = self.meta_op_hook(mp.partition_id, mp.peers,
                                         "split_point", {}, read=True)
            if not split_at:
                return 0
            new_pid = self._apply("alloc_id")
            new_peers = self._pick_meta_peers()
            # the fence + the replicated resume record, in one raft commit
            # on the partition itself
            self.meta_op_hook(mp.partition_id, mp.peers, "freeze_range",
                              {"split_at": split_at, "new_pid": new_pid,
                               "new_peers": new_peers})
            events.emit("meta_split", entity=f"mp{mp.partition_id}",
                        detail={"partition": mp.partition_id, "vol": vol.name,
                                "split_at": split_at, "new_pid": new_pid,
                                "phase": "freeze"})
        else:
            split_at = int(resume["split_at"])
            new_pid = int(resume["new_pid"])
            new_peers = [int(p) for p in resume.get("new_peers", [])] \
                or self._pick_meta_peers()
            if any(m.partition_id == new_pid for m in vol.meta_partitions):
                # view already swapped: only the cleanup tail is missing
                self.meta_op_hook(mp.partition_id, mp.peers,
                                  "complete_split", {})
                events.emit("meta_split", entity=f"mp{mp.partition_id}",
                            detail={"partition": mp.partition_id,
                                    "vol": vol.name, "new_pid": new_pid,
                                    "phase": "complete", "resumed": True})
                # a resumed TAIL split still owes the chain: without it the
                # sibling keeps the open range and the volume settles at 2
                # partitions with the hotspot re-forming on the sibling
                self._chain_tail_split(vol, new_pid)
                return new_pid
        # sibling raft group on the chosen peers (idempotent: create skips
        # peers already hosting the pid), range [split_at, old_end)
        self.metanode_hook(new_pid, split_at, old_end, new_peers)
        # snapshot-copy the frozen sub-range, page by page (the freeze makes
        # paging consistent; import is a keyed upsert, so replays are safe)
        after = 0
        src_cursor = 0
        while True:
            page = self.meta_op_hook(mp.partition_id, mp.peers,
                                     "export_range", {"after": after},
                                     read=True)
            src_cursor = page.get("cursor") or src_cursor
            # the final page always ships (even empty): it carries the
            # final=True that triggers the sibling's one quota recount
            if page["inodes"] or page["dentries"] or not after or page["done"]:
                self.meta_op_hook(new_pid, new_peers, "import_entries",
                                  {"inodes": page["inodes"],
                                   "dentries": page["dentries"],
                                   "cursor": page.get("cursor"),
                                   "quotas": page.get("quotas"),
                                   "final": bool(page["done"])})
            if page["done"]:
                break
            after = page["next"]
        # THE atomic swap: one master-raft commit moves ownership of
        # [split_at, old_end) to the sibling — never zero or two owners
        self._apply("split_partition_mid", vol_name=vol.name,
                    partition_id=mp.partition_id, split_at=split_at,
                    new_partition_id=new_pid, peers=new_peers)
        events.emit("meta_split", entity=f"mp{mp.partition_id}",
                    detail={"partition": mp.partition_id, "vol": vol.name,
                            "split_at": split_at, "new_pid": new_pid,
                            "peers": list(new_peers), "phase": "commit"})
        # cleanup tail: drop the moved entries + shrink end + lift the fence
        self.meta_op_hook(mp.partition_id, mp.peers, "complete_split", {})
        events.emit("meta_split", entity=f"mp{mp.partition_id}",
                    detail={"partition": mp.partition_id, "vol": vol.name,
                            "new_pid": new_pid, "phase": "complete"})
        if old_end >= INF:
            self._chain_tail_split(vol, new_pid, src_cursor)
        return new_pid

    def _chain_tail_split(self, vol, new_pid: int,
                          src_cursor: int = 0) -> None:
        """A load split of the TAIL chains a cursor split of the sibling:
        the sibling inherited the open range, so every NEW create would
        land on it — the hot partition the split just relieved would
        re-form immediately. Capping it at cursor+headroom opens a fresh
        tail on (usually) other metanodes, and the capped sibling keeps
        serving its directories' combined creates from the headroom.
        Best-effort: failing the chain just leaves the sibling as the open
        tail (pre-chain behavior). The resume path has no export cursor, so
        it falls back to the sibling's heartbeat-reported cursor (resume is
        itself heartbeat-driven, so one is normally already on file)."""
        from chubaofs_tpu_torch.utils import events

        sib = next((m for m in vol.meta_partitions
                    if m.partition_id == new_pid), None)
        if sib is None or sib.end < INF:
            return
        cursor = src_cursor or max(
            (n.cursors.get(new_pid, 0) for n in self.sm.nodes.values()),
            default=0)
        if not cursor:
            return
        try:
            self._cursor_split(vol, sib, cursor + SPLIT_HEADROOM)
            events.emit("meta_split", entity=f"mp{new_pid}",
                        detail={"partition": new_pid, "vol": vol.name,
                                "phase": "chain",
                                "split_at": cursor + SPLIT_HEADROOM})
        except Exception:
            pass

    def _cursor_split(self, vol, tail, split_at: int) -> int:
        """One cursor split of the tail: cap the old tail at split_at (its
        headroom keeps serving combined creates for directories it owns) and
        open a fresh tail. The SM's range end shrinks FIRST (set_range_end,
        a replicated op): without it the old SM keeps end=INF and its
        combined-create path would allocate inodes beyond the view range —
        unroutable files. Ordered so a failure between the two commits
        leaves behavior safe: a capped SM without the view swap just answers
        ERANGE at the cap until the next sweep retries the split. The SM
        answers with the cap it actually holds (an earlier failed attempt
        may have committed a LOWER one while the cursor kept advancing);
        the view swap must use that cap or the retry never converges."""
        if self.meta_op_hook is not None:
            got = self.meta_op_hook(tail.partition_id, tail.peers,
                                    "set_range_end", {"end": split_at})
            if got:
                split_at = int(got)
        new_pid = self._apply("alloc_id")
        peers = self._pick_meta_peers()
        self._apply(
            "split_partition", vol_name=vol.name,
            partition_id=tail.partition_id,
            split_at=split_at, new_partition_id=new_pid, peers=peers,
        )
        if self.metanode_hook:
            self.metanode_hook(new_pid, split_at, INF, peers)
        return 1

    def split_hot_meta_partitions(self, threshold: float,
                                  max_splits: int = 1) -> int:
        """The load path: split the hottest meta partition whose heartbeat-
        window op count reached `threshold` (a directory-heavy tenant pins
        one raft group without this — the skewed regimes of arxiv
        1709.05365). Bounded per sweep: a split ships half a namespace."""
        if not self.is_leader or threshold <= 0:
            return 0
        done = 0
        loads = self.meta_partition_loads()
        for pid in sorted(loads, key=loads.get, reverse=True):
            if done >= max_splits or loads[pid] < threshold:
                break
            vol, mp = self._find_meta_mp(pid)
            if mp is None:
                continue
            with self._decomm_lock:
                try:
                    if self._split_meta_partition(vol, mp):
                        done += 1
                except Exception:
                    continue  # frozen state + heartbeat reports resume it
        return done

    # -- background checks (scheduleTask loop analogs) --------------------------

    def check_meta_partitions(self) -> int:
        """Meta-partition growth sweep: (1) split tail partitions whose
        cursor nears the range end (cursor growth), (2) resume mid-range
        splits stranded by a crashed orchestrator, (3) load-split HOT
        mid-range partitions when CFS_META_SPLIT_OPS arms a threshold."""
        if not self.is_leader:
            return 0
        # resume FIRST: a stranded load split can leave the tail frozen, and
        # a frozen tail refuses set_range_end — cursor growth on it can only
        # succeed after the resume lifts the fence
        splits = self.resume_meta_splits()
        for vol in list(self.sm.volumes.values()):
            tail = vol.meta_partitions[-1]
            cursor = max(
                (n.cursors.get(tail.partition_id, 0) for n in self.sm.nodes.values()),
                default=0,
            )
            bound = tail.start + META_RANGE_STEP
            if cursor and cursor >= bound - SPLIT_HEADROOM:
                split_at = cursor + SPLIT_HEADROOM
                try:
                    splits += self._cursor_split(vol, tail, split_at)
                except Exception:
                    # one volume's refusal (e.g. ESPLIT on a tail whose
                    # resume is still owed) must not abort the sweep for
                    # the other volumes or the hot-split pass below
                    continue
        splits += self.split_hot_meta_partitions(self.meta_split_ops)
        return splits

    def check_node_liveness(self, timeout: float = 10.0,
                            now: float | None = None) -> list[int]:
        """Mark nodes whose heartbeat went stale as INACTIVE so placement and
        client views route around them; a returning heartbeat reactivates
        (master/cluster.go scheduleToCheckHeartbeat analog). Decommissioned
        nodes are left alone. Returns the node ids newly marked."""
        if not self.is_leader:
            return []
        now = time.time() if now is None else now
        out = []
        for n in list(self.sm.nodes.values()):
            if n.status != "active":
                continue
            if n.last_heartbeat and now - n.last_heartbeat > timeout:
                self._apply("set_node_status", node_id=n.node_id,
                            status="inactive")
                out.append(n.node_id)
        return out

    def check_data_partitions(self) -> int:
        """Demote data partitions with a non-schedulable replica to read-only
        and promote them back when every peer is healthy (the reference's
        checkDataPartitions loop marking partitions unavailable). Clients only
        see rw partitions (data_partition_views), so writes route around dead
        replicas while reads still work through the survivors."""
        if not self.is_leader:
            return 0
        changed = 0
        for vol in list(self.sm.volumes.values()):
            for dp in vol.data_partitions:
                healthy = all(
                    self.sm.nodes.get(p) is not None
                    and self.sm.nodes[p].status == "active"
                    for p in dp.peers)
                want = "rw" if healthy else "ro"
                if dp.status in ("rw", "ro") and dp.status != want:
                    self._apply("set_dp_status", vol_name=vol.name,
                                partition_id=dp.partition_id, status=want)
                    changed += 1
        return changed

    def _replica_count(self, node_id: int) -> int:
        """Partition replicas currently homed on node_id (any kind)."""
        c = 0
        for vol in list(self.sm.volumes.values()):
            for mp in vol.meta_partitions:
                if node_id in mp.peers:
                    c += 1
            for dp in vol.data_partitions:
                if node_id in dp.peers:
                    c += 1
        return c

    def check_dead_node_replicas(self, dead_after: float = 60.0,
                                 now: float | None = None) -> int:
        """Durable auto-repair for nodes that STAY dead (reference
        scheduleToCheckDataReplicas + the decommission flows, cluster.go:347):
        liveness marks a stale node inactive within seconds (writes route
        around it, dps demote to ro); once the outage exceeds ``dead_after``
        this loop re-homes every replica the node held onto healthy peers,
        reusing the decommission dance. The node record stays ``inactive`` —
        a returning node reactivates on its next heartbeat and simply hosts
        nothing (its stale raft groups reject it; the partitions were moved).
        Per-node failures (e.g. no spare peers yet) keep whatever progress
        was made and retry on the next sweep. Fully-drained nodes enter an
        in-memory skip set (cleared by a returning heartbeat) so a cluster
        with long-dead nodes doesn't rescan every partition each tick.
        Returns replicas actually moved (counted by before/after census, so
        partial drains are reported honestly)."""
        if not self.is_leader:
            return 0
        now = time.time() if now is None else now
        moved = 0
        for n in list(self.sm.nodes.values()):
            with self._drained_lock:
                drained = n.node_id in self._dead_drained
            if n.status != "inactive" or drained:
                continue
            if not n.last_heartbeat or now - n.last_heartbeat < dead_after:
                continue
            with self._decomm_lock:
                before = self._replica_count(n.node_id)
                if before == 0:
                    with self._drained_lock:
                        self._dead_drained.add(n.node_id)
                    continue
                try:
                    if n.kind == "meta":
                        self._migrate_metanode(n.node_id)
                    else:
                        self._migrate_datanode(n.node_id)
                except MasterError:
                    pass  # partial progress kept; retried next sweep
                remaining = self._replica_count(n.node_id)
                moved += before - remaining
                if remaining == 0:
                    with self._drained_lock:
                        self._dead_drained.add(n.node_id)
        return moved

    def update_volume(self, name: str, capacity: int | None = None,
                      follower_read: bool | None = None,
                      qos_read_mbps: int | None = None,
                      qos_write_mbps: int | None = None) -> VolumeView:
        """Vol expand/shrink + per-volume client QoS (master/vol.go
        updateVol; limits flow master -> client via the volume view)."""
        return self._apply(
            "update_volume", name=name, capacity=capacity,
            follower_read=follower_read, qos_read_mbps=qos_read_mbps,
            qos_write_mbps=qos_write_mbps)

    def ensure_replica_counts(self, target: int = 3) -> int:
        """Partition-replica-count checker (scheduleToCheckDataReplicas'
        under-replication half): any mp/dp below `target` peers gains a
        replacement via the migrate machinery. Partial migrations and
        operator surgery leave these behind; the sweep heals them."""
        if not self.is_leader:
            return 0
        added = 0
        for vol in list(self.sm.volumes.values()):
            for mp in vol.meta_partitions:
                while len(mp.peers) < target:
                    try:
                        repl = self._pick_addition("meta", mp.peers).node_id
                    except MasterError:
                        break  # not enough healthy nodes; retried next sweep
                    new_peers = mp.peers + [repl]
                    if self.metanode_hook:
                        # genesis range (see _move_mp_replica): the healed
                        # replica replays/catches up from the log start
                        self.metanode_hook(mp.partition_id, mp.start0,
                                           mp.end0, new_peers, only=repl)
                    if self.raft_config_hook:
                        self.raft_config_hook("meta", mp.partition_id, "add",
                                              repl, mp.peers)
                    self._apply("update_mp_peers", vol_name=vol.name,
                                partition_id=mp.partition_id, peers=new_peers)
                    mp = [m for m in self.sm.volumes[vol.name].meta_partitions
                          if m.partition_id == mp.partition_id][0]
                    added += 1
            for dp in vol.data_partitions:
                while len(dp.peers) < target:
                    try:
                        repl = self._pick_addition("data", dp.peers)
                    except MasterError:
                        break
                    new_peers = dp.peers + [repl.node_id]
                    new_hosts = self._current_hosts(dp.peers, dp.hosts) + [repl.addr]
                    if self.datanode_hook:
                        self.datanode_hook(dp.partition_id, new_peers,
                                           new_hosts, only=repl.node_id)
                    if self.raft_config_hook:
                        self.raft_config_hook("data", dp.partition_id, "add",
                                              repl.node_id, dp.peers)
                    self._apply("update_dp_members", vol_name=vol.name,
                                partition_id=dp.partition_id, peers=new_peers,
                                hosts=new_hosts)
                    dp = [d for d in self.sm.volumes[vol.name].data_partitions
                          if d.partition_id == dp.partition_id][0]
                    added += 1
        return added

    def prune_stale_nodes(self, stale_after: float = 3600.0,
                          now: float | None = None) -> list[int]:
        """Stale-node pruner: registry entries that are inactive or
        decommissioned, host NO partition replicas, and have been silent
        past `stale_after` are removed — a re-registration starts clean.
        (The reference's operator-driven node removal, automated for the
        already-drained case.)"""
        if not self.is_leader:
            return []
        now = time.time() if now is None else now
        pruned = []
        for n in list(self.sm.nodes.values()):
            if n.status == "active":
                continue
            if now - n.last_heartbeat < stale_after:
                continue
            if self._replica_count(n.node_id):
                continue
            try:
                self._apply("remove_node", node_id=n.node_id)
                with self._drained_lock:
                    self._dead_drained.discard(n.node_id)
                pruned.append(n.node_id)
            except MasterError:
                pass
        return pruned

    def orphan_partitions(self) -> dict[int, list[int]]:
        """node_id -> partition ids the node REPORTS (heartbeat cursors)
        but should not host: either no volume records the pid (failed
        volume delete) or the pid's recorded peer set no longer includes
        the node (a migration whose remove task never reached the then-dead
        victim). Per-NODE detection, so stale replicas left behind by
        re-homes are found, not just fully-deleted-volume leftovers. The
        daemon's sweep sends remove tasks for them (scheduleTask junk
        cleanup analog)."""
        peers_of: dict[int, set[int]] = {}
        for vol in self.sm.volumes.values():
            for mp in vol.meta_partitions:
                peers_of[mp.partition_id] = set(mp.peers)
            for dp in vol.data_partitions:
                peers_of[dp.partition_id] = set(dp.peers)
        out: dict[int, list[int]] = {}
        for n in self.sm.nodes.values():
            orphans = [pid for pid in n.cursors
                       if n.node_id not in peers_of.get(pid, frozenset())]
            if orphans:
                out[n.node_id] = sorted(orphans)
        return out

    def refresh_leaders(self, leader_of) -> None:
        """Record partition leaders into the view (client routing hint)."""
        if not self.is_leader:
            return
        for vol in list(self.sm.volumes.values()):
            for mp in vol.meta_partitions:
                lead = leader_of(mp.partition_id)
                if lead != mp.leader:
                    self._apply(
                        "set_partition_leader", vol_name=vol.name,
                        partition_id=mp.partition_id, leader=lead,
                    )
