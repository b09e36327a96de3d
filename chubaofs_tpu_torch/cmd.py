"""Single-entry daemon with role dispatch — `python -m chubaofs_tpu_torch.cmd -c cfg.json`.

Reference counterpart: cmd/cmd.go:125-321 — one binary, a JSON config with a
`role` field, and a switch that boots master/metanode/datanode/objectnode/
authnode (cmd/cmd.go:175-199); blobstore/cmd/cmd.go's RegisterModule plays
the same part for the blobstore services. Kept: JSON config file, role
dispatch, everything network-reachable (raft rides TcpNet, metadata ops ride
MetaService's packet TCP, admin rides the master HTTP API), the boot line on
stdout, graceful stop on SIGTERM. Changed: no daemonize/fork — process
supervision belongs to the operator (systemd, docker, a test harness).

The device lives in one role. The blobstore daemon runs the GF codec on the
device its config's `"device"` key names (default: the CUDA device; with no
GPU it refuses to start rather than run on the host). The master, metanode,
datanode, objectnode and authnode roles are host work: they read no
`"device"` key and never touch the GPU, so they boot on a host without one.
Cold file data and S3 objects reach the codec over HTTP through the
blobstore daemon's access gateway. The console and client roles wait for
their planes (console/, client/).

Self-healing placement: the master re-sends partition-create admin tasks to
any replica whose heartbeat doesn't list the partition yet (the reference
does the same through loadMetaPartition/checkDataPartitions sweeps,
master/cluster.go:329-3587) — so node restarts and missed hooks converge.
"""

from __future__ import annotations

import json
import sys
import threading
import time

from chubaofs_tpu_torch.master.api_service import MasterAPI, MasterClient
from chubaofs_tpu_torch.master.master import MASTER_GROUP, Master, MasterSM
from chubaofs_tpu_torch.raft.server import MultiRaft, TickLoop
from chubaofs_tpu_torch.raft.transport import TcpNet
from chubaofs_tpu_torch.rpc.server import RPCServer

HEARTBEAT_INTERVAL = 1.0
ENSURE_INTERVAL = 2.0


def _addr_split(addr: str) -> tuple[str, int]:
    host, port = addr.rsplit(":", 1)
    return host, int(port)


def _advertise(addr: str, cfg: dict) -> str:
    """Rewrite a wildcard bind host into a peer-dialable address. Binding
    0.0.0.0 is how multi-host deployments listen; registering it verbatim
    would make every peer dial its own loopback. `advertiseHost` in config
    wins; otherwise the hostname's resolved address."""
    host, port = addr.rsplit(":", 1)
    if host not in ("0.0.0.0", "::", ""):
        return addr
    adv = cfg.get("advertiseHost")
    if not adv:
        import socket

        try:
            adv = socket.gethostbyname(socket.gethostname())
        except OSError:
            adv = "127.0.0.1"
    return f"{adv}:{port}"


def _log(daemon: str, msg: str) -> None:
    # stderr IS this process's log transport: supervisors and the harness
    # redirect it to the daemon's .log file, which log collectors tail
    print(f"[{daemon}] {msg}",  # obslint: stderr is the captured daemon log
          file=sys.stderr, flush=True)


def _stats_server(cfg: dict, module: str) -> RPCServer:
    """Tiny HTTP side-door for daemons whose primary wire is packet TCP
    (metanode, datanode): mounts /metrics (the process's whole registry set,
    role-namespaced) so EVERY role is scrapeable. `statsListen` in config;
    port 0 (default) binds an ephemeral port, "off" disables."""
    from chubaofs_tpu_torch.rpc.router import Router

    listen = cfg.get("statsListen", "127.0.0.1:0")
    if listen == "off":
        return None
    host, port = _addr_split(listen)
    return RPCServer(Router(), host=host, port=port, module=module).start()


def _admin_ticket(cfg: dict):
    """Ticket credential for ticket-gated masters. Preferred: authnode client
    credentials (authAddrs + authClientId + authClientKey b64) — a renewing
    provider that outlives TICKET_TTL. Fallback: a static `adminTicket`
    string (expires after the TTL; fine for tooling, wrong for daemons)."""
    if cfg.get("authAddrs") and cfg.get("authClientId") and cfg.get("authClientKey"):
        import base64

        from chubaofs_tpu_torch.authnode.api import RemoteAuthNode
        from chubaofs_tpu_torch.authnode.server import AuthClient, RenewingTicket

        client = AuthClient(RemoteAuthNode(cfg["authAddrs"]),
                            cfg["authClientId"],
                            base64.b64decode(cfg["authClientKey"]))
        return RenewingTicket(client, "master")
    return cfg.get("adminTicket")


def _make_net(node_id: int, peers: dict[int, str], cfg: dict) -> TcpNet:
    """TcpNet with the cluster secret from config. Deployments binding raft
    off-loopback MUST set `raftSecret` (TcpNet refuses the well-known default
    off-loopback); frames decode through the safe raft.codec either way."""
    secret = cfg.get("raftSecret")
    if secret:
        return TcpNet(node_id, peers, secret=secret.encode())
    return TcpNet(node_id, peers)


def _resolve_raft_peers(mc: MasterClient, net: TcpNet) -> None:
    """Refresh peer raft addresses from the registry (raftstore/resolver.go
    analog) so restarted nodes with new ports stay dialable."""
    try:
        for n in mc.get_cluster()["nodes"]:
            if n.get("raft_addr") and n["node_id"] != net.node_id:
                net.set_peer(n["node_id"], n["raft_addr"])
    except Exception:
        pass


def _space_report(paths) -> dict:
    """Disk usage of the daemon's data roots, reported with heartbeats into
    the master's statinfo rollup (ref scheduleToUpdateStatInfo source).

    Accepts one path or a list; filesystems are deduplicated by st_dev so two
    data dirs on one mount don't double-count. No paths -> no report ({})."""
    if not paths:
        return {}
    if isinstance(paths, str):
        paths = [paths]
    import os as _os
    import shutil

    total = used = 0
    seen: set[int] = set()
    for p in paths:
        try:
            dev = _os.stat(p).st_dev
            if dev in seen:
                continue
            du = shutil.disk_usage(p)
        except OSError:
            continue
        seen.add(dev)  # only after BOTH calls succeed: a stat-ok but
        # statvfs-failing mount must not turn the report into zeros
        total += du.total
        used += du.used
    return {"total_space": total, "used_space": used} if seen else {}


class _Daemon:
    """Common lifecycle: background threads registered for stop()."""

    def __init__(self):
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def _spawn(self, fn, name: str):
        t = threading.Thread(target=fn, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def _every(self, interval: float, fn, name: str):
        def loop():
            last_err = ""
            while not self._stop.wait(interval):
                try:
                    fn()
                    last_err = ""
                except Exception as e:
                    # sweeps never kill the daemon, but persistent faults must
                    # be visible — log each distinct error once
                    msg = f"{type(e).__name__}: {e}"
                    if msg != last_err:
                        _log(name, msg)
                        last_err = msg

        self._spawn(loop, name)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)


class MasterDaemon(_Daemon):
    """Role master (master/server.go:137 Start analog)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.node_id = int(cfg["id"])
        raft_peers = {int(k): v for k, v in cfg["raftPeers"].items()}
        self.peer_apis = {int(k): v for k, v in cfg.get("peerApis", {}).items()}
        # how long a node must stay dead before its replicas auto-re-home
        # (deadNodeSecs in config; tests compress it)
        self.dead_node_secs = float(cfg.get("deadNodeSecs",
                                            60 * HEARTBEAT_INTERVAL))
        # hot-volume spreading: rebalanceHotSecs > 0 runs a rebalance_hot
        # sweep on its own cadence (0/absent = off — the operator or the
        # capacity harness triggers it via /dataNode/rebalanceHot instead)
        self.rebalance_hot_secs = float(cfg.get("rebalanceHotSecs", 0))
        self.rebalance_hot_factor = float(cfg.get("rebalanceHotFactor", 1.5))
        # metadata scale-out knobs: rebalanceMetaSecs > 0 runs a
        # rebalance_meta sweep on its own cadence (0/absent = off; the
        # operator triggers /metaPartition/rebalance instead); metaSplitOps
        # overrides the CFS_META_SPLIT_OPS load-split threshold
        self.rebalance_meta_secs = float(cfg.get("rebalanceMetaSecs", 0))
        self.rebalance_meta_factor = float(cfg.get("rebalanceMetaFactor", 1.5))
        self.net = _make_net(self.node_id, raft_peers, cfg)
        self.raft = MultiRaft(self.node_id, self.net, wal_dir=cfg.get("walDir"),
                              snapshot_every=512)
        self.sm = MasterSM()
        self.raft.create_group(MASTER_GROUP, sorted(raft_peers), self.sm)
        self.master = Master(self.raft, self.sm)
        self.master.metanode_hook = self._meta_hook
        self.master.datanode_hook = self._data_hook
        self.master.raft_config_hook = self._raft_config_hook
        self.master.remove_partition_hook = self._remove_partition_hook
        self.master.meta_op_hook = self._meta_op_hook
        if "metaSplitOps" in cfg:
            self.master.meta_split_ops = float(cfg["metaSplitOps"] or 0)
        svc_secret = cfg.get("serviceSecret")
        ticket_key = cfg.get("adminTicketKey")  # b64 authnode service key
        if ticket_key:
            import base64

            ticket_key = base64.b64decode(ticket_key)
        self.api = MasterAPI(self.master,
                             leader_addr_of=lambda nid: self.peer_apis.get(nid, ""),
                             service_secret=svc_secret.encode() if svc_secret else None,
                             admin_ticket_key=ticket_key or None)
        host, port = _addr_split(cfg.get("listen", "127.0.0.1:0"))
        self.server = RPCServer(self.api.router, host=host, port=port,
                                module="master").start()
        self.addr = self.server.addr
        self.ticker = TickLoop([self.raft], interval=cfg.get("tickInterval", 0.02))
        self.ticker.start()
        self._meta_handles: dict[int, object] = {}  # node_id -> RemoteMetaNode
        self._every(ENSURE_INTERVAL, self._ensure, f"master{self.node_id}-ensure")
        if self.rebalance_hot_secs > 0:
            self._every(self.rebalance_hot_secs, self._rebalance_hot,
                        f"master{self.node_id}-rebalance")
        if self.rebalance_meta_secs > 0:
            self._every(self.rebalance_meta_secs, self._rebalance_meta,
                        f"master{self.node_id}-metarebalance")
        # autopilot: when CFS_AUTOPILOT armed the controller
        # at RPCServer boot, hand it the master's sweep actuators — the
        # hot-partition alert → rebalance closed loop
        from chubaofs_tpu_torch import autopilot as _ap

        if _ap.enabled_from_env():
            ctl = _ap.default_controller()
            for act in _ap.master_actuators(
                    self.master, factor=self.rebalance_hot_factor):
                ctl.register(act)

    def _rebalance_hot(self):
        if self.master.is_leader:
            moved = self.master.rebalance_hot(factor=self.rebalance_hot_factor)
            if moved:
                _log(f"master{self.node_id}",
                     f"rebalance_hot moved {moved} replica(s)")

    def _rebalance_meta(self):
        if self.master.is_leader:
            moved = self.master.rebalance_meta(
                factor=self.rebalance_meta_factor)
            if moved:
                _log(f"master{self.node_id}",
                     f"rebalance_meta moved {moved} replica(s)")

    # -- admin tasks to nodes (master/cluster_task.go analog) ------------------

    def _meta_handle(self, node_id: int, addr: str):
        from chubaofs_tpu_torch.meta.service import RemoteMetaNode

        h = self._meta_handles.get(node_id)
        if h is None or h.addr != addr:  # restarted node: close + re-dial
            if h is not None:
                h.close()
            h = self._meta_handles[node_id] = RemoteMetaNode(addr)
        return h

    def _raft_addrs(self, peers: list[int]) -> dict[int, str]:
        return {p: self.sm.nodes[p].raft_addr
                for p in peers if p in self.sm.nodes and self.sm.nodes[p].raft_addr}

    def _meta_hook(self, pid: int, start: int, end: int, peers: list[int],
                   only: int | None = None):
        raft_addrs = self._raft_addrs(peers)
        for peer in peers:
            if only is not None and peer != only:
                continue
            node = self.sm.nodes.get(peer)
            if node is None or not node.addr:
                continue
            try:
                self._meta_handle(peer, node.addr)._call(
                    pid, "admin_create_partition", start=start, end=end,
                    peers=peers, raft_addrs=raft_addrs)
            except Exception as e:
                _log(f"master{self.node_id}",
                     f"create mp {pid} on node {peer}: {e} (sweep retries)")

    def _data_hook(self, pid: int, peers: list[int], hosts: list[str],
                   only: int | None = None):
        from chubaofs_tpu_torch.proto.packet import (
            OP_CREATE_PARTITION, Packet, RES_OK, recv_packet, send_packet)
        import socket

        raft_addrs = self._raft_addrs(peers)
        for i, peer in enumerate(peers):
            if only is not None and peer != only:
                continue
            node = self.sm.nodes.get(peer)
            addr = node.addr if node and node.addr else (
                hosts[i] if i < len(hosts) else "")
            if not addr:
                continue
            try:
                host, port = _addr_split(addr)
                with socket.create_connection((host, port), timeout=3) as sock:
                    send_packet(sock, Packet(
                        OP_CREATE_PARTITION, partition_id=pid,
                        arg={"peers": peers, "hosts": hosts,
                             "raft_addrs": raft_addrs}))
                    recv_packet(sock)
            except Exception:
                pass

    def _send_data_packet(self, addr: str, pkt):
        """One admin packet round-trip to a datanode."""
        import socket

        from chubaofs_tpu_torch.proto.packet import recv_packet, send_packet

        host, port = _addr_split(addr)
        with socket.create_connection((host, port), timeout=10) as sock:
            send_packet(sock, pkt)
            return recv_packet(sock)

    def _raft_config_hook(self, kind: str, pid: int, action: str,
                          node_id: int, peers: list[int]) -> None:
        """Membership change for a decommission: find the partition's raft
        leader among the candidate peers and propose there, FOLLOWING the
        not-leader hint. The candidate list must include every node that can
        currently be leader — for a remove that includes the node being
        removed (a raft leader may propose its own removal and step down on
        apply; the reference's removeMetaPartitionRaftMember does the same
        leader-first dance)."""
        import time

        from chubaofs_tpu_torch.proto.packet import (
            OP_RAFT_CONFIG, Packet, RES_NOT_LEADER, RES_OK)
        from chubaofs_tpu_torch.raft.server import NotLeaderError

        candidates = list(dict.fromkeys(peers))
        raft_addrs = self._raft_addrs(list(set(peers) | {node_id}))
        deadline = time.monotonic() + 20
        last = "no peers reachable"

        def note_hint(hint):
            if isinstance(hint, int) and hint not in candidates:
                candidates.append(hint)

        while time.monotonic() < deadline:
            for peer in list(candidates):
                node = self.sm.nodes.get(peer)
                if node is None or not node.addr:
                    continue
                try:
                    if kind == "meta":
                        self._meta_handle(peer, node.addr)._call(
                            pid, "admin_raft_config", action=action,
                            node_id=node_id, raft_addrs=raft_addrs)
                        return
                    rep = self._send_data_packet(node.addr, Packet(
                        OP_RAFT_CONFIG, partition_id=pid,
                        arg={"action": action, "node_id": node_id,
                             "raft_addrs": raft_addrs}))
                    if rep.result == RES_OK:
                        return
                    if rep.result == RES_NOT_LEADER:
                        note_hint(rep.arg.get("leader"))
                        last = f"not leader (hint {rep.arg.get('leader')})"
                    else:
                        last = rep.error()
                except NotLeaderError as e:
                    note_hint(e.leader)
                    last = f"not leader (hint {e.leader})"
                except Exception as e:
                    last = str(e)
            time.sleep(0.3)
        raise RuntimeError(f"raft config {action}({node_id}) on {pid}: {last}")

    def _meta_op_hook(self, pid: int, peers: list[int], op: str, args: dict,
                      read: bool = False):
        """Run one metanode op on a partition's raft leader over the wire
        (the split orchestrator's plumbing): walk the candidate peers
        following not-leader hints, skipping replicas that are down or not
        yet hosting the group — the same dance as _raft_config_hook, but
        returning the op's RESULT. `read` is advisory here: MetaService
        routes read vs raft ops by op name."""
        import time

        from chubaofs_tpu_torch.meta.metanode import OpError
        from chubaofs_tpu_torch.raft.server import NotLeaderError

        del read  # the wire handler dispatches by op name
        candidates = list(dict.fromkeys(peers))
        deadline = time.monotonic() + 20
        last = "no peers reachable"
        while time.monotonic() < deadline:
            for peer in list(candidates):
                node = self.sm.nodes.get(peer)
                if node is None or not node.addr:
                    continue
                try:
                    return self._meta_handle(peer, node.addr)._call(
                        pid, op, **args)
                except NotLeaderError as e:
                    if isinstance(e.leader, int) and e.leader not in candidates:
                        candidates.append(e.leader)
                    last = f"not leader (hint {e.leader})"
                except OpError as e:
                    if e.code not in ("ECONN", "EIO", "ENOPARTITION"):
                        raise  # a real op error (frozen conflict, ...) is
                        # the ORCHESTRATOR's to handle, not a retry case
                    last = str(e)
                except Exception as e:
                    last = str(e)
            time.sleep(0.3)
        raise RuntimeError(f"meta op {op} on mp {pid}: {last}")

    def _remove_partition_hook(self, kind: str, pid: int, node_id: int) -> None:
        from chubaofs_tpu_torch.proto.packet import OP_REMOVE_PARTITION, Packet

        node = self.sm.nodes.get(node_id)
        if node is None or not node.addr:
            return  # node gone; nothing to clean
        try:
            if kind == "meta":
                self._meta_handle(node_id, node.addr)._call(
                    pid, "admin_remove_partition")
            else:
                self._send_data_packet(node.addr, Packet(
                    OP_REMOVE_PARTITION, partition_id=pid))
        except Exception as e:
            _log(f"master{self.node_id}",
                 f"remove {kind} partition {pid} on node {node_id}: {e}")

    def _ensure(self):
        """Re-send create tasks to replicas whose heartbeats miss a partition."""
        if not self.master.is_leader:
            return
        self.master.check_meta_partitions()
        self.master.refresh_dp_hosts()
        # liveness sweep: stale-heartbeat nodes go inactive, their data
        # partitions demote to read-only until they come back
        self.master.check_node_liveness(timeout=10 * HEARTBEAT_INTERVAL)
        self.master.check_data_partitions()
        # durable repair: replicas on long-dead nodes re-home to healthy peers
        self.master.check_dead_node_replicas(dead_after=self.dead_node_secs)
        # under-replicated partitions (partial migrations) gain replacements
        self.master.ensure_replica_counts()
        # domain-concentrated partitions (multi-domain-outage residue)
        # re-spread once a free healthy domain exists
        self.master.check_replica_spread()
        # long-silent drained nodes leave the registry
        self.master.prune_stale_nodes(stale_after=60 * self.dead_node_secs)
        # partitions a node reports but no volume records: failed deletes/
        # migrations — send remove tasks (junk-task cleanup analog)
        for node_id, pids in self.master.orphan_partitions().items():
            n = self.sm.nodes.get(node_id)
            kind = n.kind if n else "data"
            for pid in pids:
                self._remove_partition_hook(kind, pid, node_id)
        now = time.time()
        for vol in list(self.sm.volumes.values()):
            for mp in vol.meta_partitions:
                for peer in mp.peers:
                    n = self.sm.nodes.get(peer)
                    if (n and n.addr and now - n.last_heartbeat < 10
                            and mp.partition_id not in n.cursors):
                        # GENESIS range, not the live view range: the
                        # respawned node replays its WAL from index 1 into
                        # this SM, and entries recorded before an in-log
                        # range shrink (complete_split/set_range_end) only
                        # replay under the range they were applied under —
                        # a view-range SM silently drops them (data loss,
                        # caught by the --meta-split soak)
                        self._meta_hook(mp.partition_id, mp.start0, mp.end0,
                                        mp.peers, only=peer)
            for dp in vol.data_partitions:
                for peer in dp.peers:
                    n = self.sm.nodes.get(peer)
                    if (n and n.addr and now - n.last_heartbeat < 10
                            and dp.partition_id not in n.cursors):
                        self._data_hook(dp.partition_id, dp.peers, dp.hosts,
                                        only=peer)

    def stop(self):
        super().stop()
        self.ticker.stop()
        self.server.stop()
        self.net.close()


class MetaNodeDaemon(_Daemon):
    """Role metanode (metanode/metanode.go analog)."""

    def __init__(self, cfg: dict):
        super().__init__()
        from chubaofs_tpu_torch.meta.metanode import MetaNode
        from chubaofs_tpu_torch.meta.service import MetaService

        self.node_id = int(cfg["id"])
        self.net = _make_net(
            self.node_id, {self.node_id: cfg.get("raftListen", "127.0.0.1:0")},
            cfg)
        self._raft_addr = _advertise(self.net.listen_addr, cfg)
        self.raft = MultiRaft(self.node_id, self.net, wal_dir=cfg.get("walDir"),
                              snapshot_every=512)
        self.metanode = MetaNode(self.node_id, self.raft)
        self.zone = cfg.get("zone", "")
        self.data_dir = cfg.get("walDir")  # None = no space report
        host, port = _addr_split(cfg.get("listen", "127.0.0.1:0"))
        self.service = MetaService(self.metanode, host=host, port=port)
        self.addr = _advertise(self.service.addr, cfg)
        self.mc = MasterClient(cfg["masterAddrs"],
                               admin_ticket=_admin_ticket(cfg))
        self.stats_server = _stats_server(cfg, "metanode")
        self.stats_addr = self.stats_server.addr if self.stats_server else ""
        self.ticker = TickLoop([self.raft], interval=cfg.get("tickInterval", 0.02))
        self.ticker.start()
        try:
            self._register()
        except Exception as e:
            _log(f"node{self.node_id}",
                 f"register failed: {e} (heartbeat loop retries)")
        self._every(HEARTBEAT_INTERVAL, self._heartbeat,
                    f"metanode{self.node_id}-hb")
        self._wire_purge(cfg)
        self.metanode.tx_resolver_hook = self._resolve_tx
        self._every(5.0, self.metanode.drain_freelists,
                    f"metanode{self.node_id}-freelist")
        self._every(5.0, self.metanode.sweep_transactions,
                    f"metanode{self.node_id}-txsweep")
        self._every(5.0, self._push_quota_flags,
                    f"metanode{self.node_id}-quota")

    def _remote_metanodes(self):
        from chubaofs_tpu_torch.meta.service import RemoteMetaNode

        handles = {}
        for n in self.mc.get_cluster()["nodes"]:
            if n["kind"] == "meta" and n["addr"]:
                handles[n["node_id"]] = RemoteMetaNode(n["addr"])
        return handles

    def _resolve_tx(self, tm_pid: int, tx_id: str) -> str:
        """Participant-sweep hook over the wire: find the TM partition's
        peers in the master view, ask each for the decision."""
        from chubaofs_tpu_torch.meta.metanode import OpError
        from chubaofs_tpu_torch.raft.server import NotLeaderError

        handles = self._remote_metanodes()
        for v in self.mc.list_volumes():
            for mp in self.mc.meta_partitions(v["name"]):
                if mp["partition_id"] != tm_pid:
                    continue
                for peer in mp["peers"]:
                    h = handles.get(peer)
                    if h is None:
                        continue
                    try:
                        return h.tx_status(tm_pid, tx_id)
                    except (NotLeaderError, OpError):
                        continue
                raise RuntimeError(f"tm partition {tm_pid}: no leader reachable")
        return "unknown"  # partition no longer exists: nothing can commit it

    def _push_quota_flags(self):
        """One quota aggregation round per volume; only the node leading the
        volume's FIRST partition pushes, so the cluster does it once."""
        from chubaofs_tpu_torch.sdk.cluster import _MasterAdapter
        from chubaofs_tpu_torch.sdk.meta_wrapper import MetaWrapper

        adapter = _MasterAdapter(self.mc)
        handles = None
        for v in self.mc.list_volumes():
            mps = self.mc.meta_partitions(v["name"])
            if not mps or not self.metanode.is_leader(mps[0]["partition_id"]):
                continue
            if handles is None:
                handles = self._remote_metanodes()
            MetaWrapper(adapter, handles, v["name"]).push_quota_flags()

    def _register(self):
        self.mc.add_node(self.node_id, "meta", self.addr,
                         raft_addr=self._raft_addr, zone=self.zone)

    def _heartbeat(self):
        from chubaofs_tpu_torch.master.master import MasterError

        cursors = {pid: sm.cursor
                   for pid, sm in list(self.metanode.partitions.items())}
        # per-partition op-load window + frozen-split reports ride the beat:
        # the master's load splitter, meta rebalancer, and split-resume
        # sweep all read them
        loads = self.metanode.take_loads()
        try:
            self.mc.heartbeat(self.node_id, partitions=len(cursors),
                              cursors=cursors, loads=loads,
                              splits=self.metanode.split_reports(),
                              **_space_report(self.data_dir))
        except MasterError:  # "unknown node": master lost state → re-register
            self.metanode.refund_loads(loads)
            self._register()
        except Exception:
            # transport failure: a master hiccup must not erase an observed
            # load window (the datanode heartbeat's same contract)
            self.metanode.refund_loads(loads)
            raise
        _resolve_raft_peers(self.mc, self.net)

    def _wire_purge(self, cfg: dict):
        """Orphan purge hooks over the wire (partition_free_list.go analog)."""
        from chubaofs_tpu_torch.sdk.stream import ExtentClient

        access_addrs = cfg.get("accessAddrs") or []
        ac = None
        if access_addrs:
            from chubaofs_tpu_torch.blobstore.gateway import AccessClient

            ac = AccessClient(access_addrs)

        def all_views():
            views = []
            for v in self.mc.list_volumes():
                views += self.mc.data_partitions(v["name"])
            return views

        ec = ExtentClient(all_views)

        def purge_inode(inode):
            for ext in getattr(inode, "obj_extents", []):
                if ac is not None:
                    ac.delete(ext["loc"])
            keys = getattr(inode, "extents", [])
            if keys:
                ec.refresh()
                ec.delete_extents(keys)

        def purge_entry(entry):
            for ext in entry.get("obj_extents", []):
                if ac is not None:
                    ac.delete(ext["loc"])
            keys = entry.get("extents", [])
            if keys:
                ec.refresh()
                ec.delete_extents(keys)

        self.metanode.data_purge_hook = purge_inode
        self.metanode.extent_purge_hook = purge_entry

    def stop(self):
        super().stop()
        self.ticker.stop()
        self.service.close()
        if self.stats_server is not None:
            self.stats_server.stop()
        self.net.close()


class DataNodeDaemon(_Daemon):
    """Role datanode (datanode/server.go doStart analog)."""

    def __init__(self, cfg: dict):
        super().__init__()
        from chubaofs_tpu_torch.data.datanode import DataNode

        self.node_id = int(cfg["id"])
        self.net = _make_net(
            self.node_id, {self.node_id: cfg.get("raftListen", "127.0.0.1:0")},
            cfg)
        self._raft_addr = _advertise(self.net.listen_addr, cfg)
        self.raft = MultiRaft(self.node_id, self.net, wal_dir=cfg.get("walDir"),
                              snapshot_every=512)
        self.datanode = DataNode(self.node_id, cfg.get("listen", "127.0.0.1:0"),
                                 cfg["disks"], raft=self.raft)
        self.zone = cfg.get("zone", "")
        self.data_dir = list(cfg["disks"])  # all roots, deduped by fs
        self.datanode.start()
        self.addr = _advertise(self.datanode.addr, cfg)
        self.mc = MasterClient(cfg["masterAddrs"],
                               admin_ticket=_admin_ticket(cfg))
        self.stats_server = _stats_server(cfg, "datanode")
        self.stats_addr = self.stats_server.addr if self.stats_server else ""
        self.ticker = TickLoop([self.raft], interval=cfg.get("tickInterval", 0.02))
        self.ticker.start()
        try:
            self._register()
        except Exception as e:
            _log(f"node{self.node_id}",
                 f"register failed: {e} (heartbeat loop retries)")
        self._every(HEARTBEAT_INTERVAL, self._heartbeat,
                    f"datanode{self.node_id}-hb")

    def _register(self):
        self.mc.add_node(self.node_id, "data", self.addr,
                         raft_addr=self._raft_addr, zone=self.zone)

    def _heartbeat(self):
        from chubaofs_tpu_torch.master.master import MasterError

        pids = {pid: 0 for pid in list(self.datanode.space.partitions)}
        loads = self.datanode.take_loads()
        try:
            self.mc.heartbeat(self.node_id, partitions=len(pids), cursors=pids,
                              loads=loads, **_space_report(self.data_dir))
        except MasterError:
            # the master lost this node's record ("unknown node"): the
            # report never landed, so fold the consumed window back in
            self.datanode.refund_loads(loads)
            self._register()
        except Exception:
            # same for transport failures: a master hiccup must not erase
            # an observed load window
            self.datanode.refund_loads(loads)
            raise
        _resolve_raft_peers(self.mc, self.net)

    def stop(self):
        super().stop()
        self.ticker.stop()
        self.datanode.stop()
        if self.stats_server is not None:
            self.stats_server.stop()
        self.net.close()


class BlobstoreDaemon(_Daemon):
    """Role blobstore: the whole EC mini-cluster + access HTTP gateway.

    The reference runs access/clustermgr/proxy/blobnode/scheduler as separate
    processes under blobstore/cmd; the rebuilt services compose in one daemon
    here (they already talk through interfaces), fronted by the gateway.

    The codec runs on `cfg["device"]`: absent means the CUDA device, and the
    daemon raises at boot when there is none; "cpu" runs it on the host."""

    def __init__(self, cfg: dict):
        super().__init__()
        import torch

        from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
        from chubaofs_tpu_torch.blobstore.cmd import ModuleRunner, add_admin_routes
        from chubaofs_tpu_torch.blobstore.gateway import AccessGateway
        from chubaofs_tpu_torch.ops.rs import resolve_device

        # refuse to boot, before anything binds, when the codec's device is
        # not there: a daemon told (or defaulted) to use the card never
        # serves from the host instead
        if (resolve_device(cfg.get("device")).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(f"device {cfg.get('device')!r}: no CUDA device "
                               "available; set \"device\": \"cpu\" to run the "
                               "codec on the host")
        runner = ModuleRunner(cfg=dict(cfg))

        def up_cluster(c, handles):
            return MiniCluster(c["root"], n_nodes=int(c.get("nodes", 6)),
                               disks_per_node=int(c.get("disksPerNode", 2)),
                               azs=int(c.get("azs", 1)),
                               device=c.get("device"))

        def up_gateway(c, handles):
            host, port = _addr_split(c.get("listen", "127.0.0.1:0"))
            gw = AccessGateway(
                handles["cluster"].access, host=host, port=port,
                router_hook=lambda r: add_admin_routes(r, handles["cluster"],
                                                       runner))
            c["listen"] = gw.addr  # graceful reloads rebind the SAME address
            return gw

        runner.register("cluster", up_cluster, lambda h: h.close())
        runner.register("gateway", up_gateway, lambda h: h.stop())
        runner.start()
        self.runner = runner
        self.addr = runner.handles["gateway"].addr
        self._every(1.0, self._bg_tick, "blobstore-bg")

    def _bg_tick(self):
        # under the runner lock, so a tick can never race a concurrent
        # reload's teardown of the cluster it is sweeping
        self.runner.call_with("cluster", lambda c: c.run_background_once())

    def stop(self):
        super().stop()
        self.runner.stop()


class _MasterUserStore:
    """Mapping face over /user/akInfo for ObjectNode authentication.

    Entries expire so credential revocation at the master propagates
    (objectnode's userInfoStore keeps the same short TTL discipline);
    misses are negative-cached briefly to keep bad-AK floods off the master."""

    TTL = 30.0
    NEG_TTL = 5.0
    MAX_ENTRIES = 4096  # bad-AK floods must not grow memory unboundedly

    def __init__(self, mc: MasterClient):
        self.mc = mc
        self._cache: dict[str, tuple[float, dict | None]] = {}

    def get(self, ak: str):
        now = time.monotonic()  # TTL math, never a cross-process timestamp
        hit = self._cache.get(ak)
        if hit is not None and now < hit[0]:
            return hit[1]
        if len(self._cache) >= self.MAX_ENTRIES:
            self._cache = {k: v for k, v in self._cache.items() if now < v[0]}
            while len(self._cache) >= self.MAX_ENTRIES:  # all still live: drop oldest
                self._cache.pop(next(iter(self._cache)))
        try:
            u = self.mc.user_by_ak(ak)
        except Exception:
            self._cache[ak] = (now + self.NEG_TTL, None)
            return None
        entry = {"secret_key": u["secret_key"], "uid": u["user_id"]}
        self._cache[ak] = (now + self.TTL, entry)
        return entry


class ObjectNodeDaemon(_Daemon):
    """Role objectnode (objectnode/server.go analog) over RemoteCluster."""

    def __init__(self, cfg: dict):
        super().__init__()
        from chubaofs_tpu_torch.objectnode.server import ObjectNode
        from chubaofs_tpu_torch.sdk.cluster import RemoteCluster

        self.cluster = RemoteCluster(cfg["masterAddrs"],
                                     access_addrs=cfg.get("accessAddrs"),
                                     admin_ticket=_admin_ticket(cfg))
        users = cfg.get("users")
        if users is None:
            svc_secret = cfg.get("serviceSecret")
            if svc_secret:
                users = _MasterUserStore(MasterClient(
                    cfg["masterAddrs"], auth_secret=svc_secret.encode()))
            else:
                if any(not a.startswith(("127.0.0.1", "localhost", "[::1]"))
                       for a in cfg["masterAddrs"]):
                    _log("objectnode",
                         "no serviceSecret configured and masters are "
                         "non-loopback: the master will refuse /user/akInfo, "
                         "so ALL S3 authentication will fail — set the same "
                         "serviceSecret on masters and this objectnode")
                users = _MasterUserStore(self.cluster.mc)
        self.objectnode = ObjectNode(self.cluster, users=users,
                                     region=cfg.get("region", "cfs"))
        host, port = _addr_split(cfg.get("listen", "127.0.0.1:0"))
        # metrics=False: /metrics on the S3 surface would shadow the
        # auth-wrapped GET /:bucket listing for a bucket named "metrics"
        # and serve process internals unauthenticated — scrape the
        # statsListen side-door instead
        self.server = RPCServer(self.objectnode.router, host=host,
                                port=port, module="objectnode",
                                metrics=False).start()
        self.addr = self.server.addr
        self.stats_server = _stats_server(cfg, "objectnode")
        self.stats_addr = self.stats_server.addr if self.stats_server else ""

    def stop(self):
        super().stop()
        self.server.stop()
        if self.stats_server is not None:
            self.stats_server.stop()


class AuthNodeDaemon(_Daemon):
    """Role authnode (authnode/api_service.go analog)."""

    def __init__(self, cfg: dict):
        super().__init__()
        from chubaofs_tpu_torch.authnode import AUTH_GROUP, AuthNode, KeystoreSM
        from chubaofs_tpu_torch.authnode.api import build_router

        self.node_id = int(cfg["id"])
        raft_peers = {int(k): v for k, v in cfg["raftPeers"].items()}
        self.net = _make_net(self.node_id, raft_peers, cfg)
        self.raft = MultiRaft(self.node_id, self.net, wal_dir=cfg.get("walDir"),
                              snapshot_every=512)
        self.sm = KeystoreSM()
        self.raft.create_group(AUTH_GROUP, sorted(raft_peers), self.sm)
        self.authnode = AuthNode(self.raft, self.sm)
        secret = cfg.get("adminSecret")
        router = build_router(self.authnode,
                              secret.encode() if secret else None)
        host, port = _addr_split(cfg.get("listen", "127.0.0.1:0"))
        self.server = RPCServer(router, host=host, port=port,
                                module="authnode").start()
        self.addr = self.server.addr
        self.ticker = TickLoop([self.raft], interval=cfg.get("tickInterval", 0.02))
        self.ticker.start()

    def stop(self):
        super().stop()
        self.ticker.stop()
        self.server.stop()
        self.net.close()


ROLES = {
    "master": MasterDaemon,
    "metanode": MetaNodeDaemon,
    "datanode": DataNodeDaemon,
    "blobstore": BlobstoreDaemon,
    "objectnode": ObjectNodeDaemon,
    "authnode": AuthNodeDaemon,
}


def start_role(cfg: dict):
    role = cfg.get("role")
    ctor = ROLES.get(role)
    if ctor is None:
        raise SystemExit(f"unknown role {role!r}; valid: {sorted(ROLES)}")
    return ctor(cfg)


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="chubaofs-tpu-torch",
                                description="chubaofs_tpu_torch server daemon")
    p.add_argument("-c", "--config", required=True, help="JSON config file")
    args = p.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    daemon = start_role(cfg)
    addr = getattr(daemon, "addr", "")
    boot = {"role": cfg["role"], "addr": addr}
    stats_addr = getattr(daemon, "stats_addr", "")
    if stats_addr:
        boot["stats_addr"] = stats_addr  # /metrics side-door (statsListen)
    print(json.dumps(boot), flush=True)  # obslint: boot line IS the stdout protocol (harness parses it)
    # SIGTERM (supervisors, ProcCluster.close) must run the same graceful
    # stop as ^C
    from chubaofs_tpu_torch.utils.shutdown import await_shutdown, shutdown_event

    await_shutdown(shutdown_event())
    daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
