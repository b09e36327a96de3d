"""Master HTTP admin API — the operator/client face of the resource manager.

Reference counterpart: master/http_server.go:246,417 + master/api_service.go
(5,186 LoC of HTTP/JSON handlers). Kept: the reference's URL namespace
(/admin/*, /client/*, /dataNode/*, /metaNode/*, /user/*), its JSON envelope
{"code": 0, "msg": "success", "data": ...}, and its leader-proxy behavior —
a follower master answers with the leader's address so clients re-aim
(master/http_server.go's proxy; our RPCClient follows the hint). Changed:
handlers are thin wrappers over the Master facade; the reference's ~180
endpoints collapse to the set the CLI/console/objectnode/SDK actually use.
"""

from __future__ import annotations

from dataclasses import asdict

from chubaofs_tpu_torch.master.master import MASTER_GROUP, Master, MasterError
from chubaofs_tpu_torch.rpc.client import RPCClient
from chubaofs_tpu_torch.rpc.errors import HTTPError
from chubaofs_tpu_torch.rpc.router import Request, Response, Router
from chubaofs_tpu_torch.rpc.server import RPCServer

CODE_OK = 0
CODE_ERR = 1
CODE_NOT_LEADER = 2
CODE_BUSY = 3  # QoS limit hit; clients back off and retry (master/limiter.go)
CODE_DENIED = 4  # missing/invalid capability ticket (authnode-gated admin op)


def envelope(data=None, code: int = CODE_OK, msg: str = "success") -> dict:
    return {"code": code, "msg": msg, "data": data}


class MasterAPI:
    """HTTP service bound to one master replica."""

    def __init__(self, master: Master, leader_addr_of=None,
                 service_secret: bytes | None = None, qos=None,
                 admin_ticket_key: bytes | None = None):
        """leader_addr_of: node_id -> admin-API address, for leader redirects.
        service_secret gates the credential-bearing /user/akInfo endpoint
        (objectnode signs with it); without one, akInfo only answers loopback
        clients — S3 secrets must never be harvestable off the open admin API.
        qos: a utils.ratelimit.KeyedLimiter with per-route op limits
        (master/limiter.go analog); None = unlimited.
        admin_ticket_key: the master's authnode SERVICE key — when set,
        mutating admin routes demand an x-cfs-ticket header carrying the
        master:admin capability (authnode/api_service.go:37 gating); None
        keeps the shared-secret-only deployment mode."""
        from chubaofs_tpu_torch.utils.ratelimit import KeyedLimiter

        self.master = master
        self.leader_addr_of = leader_addr_of or (lambda node_id: "")
        self.service_secret = service_secret
        self.qos = qos if qos is not None else KeyedLimiter()
        self.admin_ticket_key = admin_ticket_key
        self.router = self._build()

    # -- plumbing -------------------------------------------------------------

    def _build(self) -> Router:
        r = Router()
        g = r.get
        g("/metrics", self.metrics)  # raw text/plain, no JSON envelope
        g("/admin/getCluster", self._w(self.get_cluster, leader=False))
        g("/admin/getClusterStat", self._w(self.get_cluster_stat, leader=False))
        g("/admin/getTopology", self._w(self.get_topology, leader=False))
        g("/admin/getZoneDomains", self._w(self.get_zone_domains, leader=False))
        g("/admin/setZoneDomain", self._w(self.set_zone_domain, admin=True))
        g("/admin/getIp", self._w(self.get_ip, leader=False))
        g("/admin/createVol", self._w(self.create_vol, admin=True))
        g("/admin/updateVol", self._w(self.update_vol, admin=True))
        g("/admin/deleteVol", self._w(self.delete_vol, admin=True))
        g("/admin/getVol", self._w(self.get_vol, leader=False))
        g("/admin/listVols", self._w(self.list_vols, leader=False))
        g("/admin/createDataPartition", self._w(self.create_dp, admin=True))
        g("/client/partitions", self._w(self.client_partitions, leader=False))
        g("/client/metaPartitions", self._w(self.client_meta_partitions, leader=False))
        g("/client/vol", self._w(self.get_vol, leader=False))
        # topology mutations are gated too, but under the NODE capability:
        # a datanode's on-disk credential must let it register/heartbeat
        # without also granting deleteVol-class admin power (least privilege)
        g("/dataNode/add", self._w(self.add_node_data, admin=True, cap="node"))
        g("/metaNode/add", self._w(self.add_node_meta, admin=True, cap="node"))
        g("/node/heartbeat", self._w(self.node_heartbeat, admin=True, cap="node"))
        g("/dataNode/decommission", self._w(self.decommission_data, admin=True))
        g("/metaNode/decommission", self._w(self.decommission_meta, admin=True))
        g("/dataNode/rebalanceHot", self._w(self.rebalance_hot, admin=True))
        g("/metaPartition/rebalance", self._w(self.rebalance_meta, admin=True))
        g("/metaPartition/split", self._w(self.split_meta, admin=True))
        g("/user/create", self._w(self.user_create, admin=True))
        g("/user/delete", self._w(self.user_delete, admin=True))
        g("/user/info", self._w(self.user_info, leader=False))
        g("/user/akInfo", self._w(self.user_ak_info, leader=False))
        g("/user/updatePolicy", self._w(self.user_update_policy, admin=True))
        g("/user/list", self._w(self.user_list, leader=False))
        # recent slow-op audit of THIS master process (the RPCServer mounts
        # the same data at /slowops on every daemon; this alias keeps the
        # master's ops surface under its /api namespace for cfs-stat)
        g("/api/slowops", self.slowops)
        from chubaofs_tpu_torch.master.gapi import GraphQLAPI

        r.post("/graphql", GraphQLAPI(self.master).handle)
        return r

    def slowops(self, req: Request):
        from chubaofs_tpu_torch.utils.auditlog import recent_slowops

        # QoS-gated like every /api route (each request re-reads the slowop
        # rotor from disk — a polling loop must not hammer the master
        # unthrottled), but WITHOUT the envelope: the response shape matches
        # the daemon-side /slowops side-door so cfs-stat and the console
        # rollup parse both identically
        if not self.qos.allow(req.path):
            return Response.json({"slowops": [],
                                  "error": "rate limit exceeded"}, status=429)
        return Response.json({"slowops": recent_slowops(req.q_int("n", 100))})

    def _w(self, fn, leader: bool = True, admin: bool = False,
           cap: str = "admin"):
        """Wrap a handler: QoS gate + ticket gate + leader gate + MasterError
        → envelope. `cap` names the capability the ticket must carry
        ("master:admin" for destructive ops, "master:node" for node
        registration/heartbeat — node credentials never hold admin power)."""

        def handler(req: Request):
            if not self.qos.allow(req.path):
                return Response.json(
                    envelope(None, CODE_BUSY, "rate limit exceeded"), status=200)
            if admin and self.admin_ticket_key is not None:
                from chubaofs_tpu_torch.authnode.server import verify_ticket

                try:
                    verify_ticket("master", self.admin_ticket_key,
                                  req.header("x-cfs-ticket"), action=cap)
                except Exception as e:  # TicketError, malformed b64, ...
                    return Response.json(
                        envelope(None, CODE_DENIED,
                                 f"master:{cap} ticket required: {e}"),
                        status=200)
            if leader and not self.master.is_leader:
                lead = self.master.raft.leader_of(MASTER_GROUP)
                addr = self.leader_addr_of(lead) if lead is not None else ""
                return Response.json(
                    envelope({"leader": addr}, CODE_NOT_LEADER, "not leader"),
                    status=200)
            try:
                return Response.json(envelope(fn(req)))
            except MasterError as e:
                return Response.json(envelope(None, CODE_ERR, str(e)))

        return handler

    # -- handlers -------------------------------------------------------------

    def get_cluster(self, req: Request):
        sm = self.master.sm
        return {
            "leader_id": self.master.raft.leader_of(MASTER_GROUP),
            "nodes": [asdict(n) for n in sm.nodes.values()],
            "volumes": sorted(sm.volumes),
            "users": sorted(sm.users),
        }

    def get_cluster_stat(self, req: Request):
        """Space/health rollup (ref /admin/getClusterStat, statinfo loop)."""
        return self.master.cluster_stat()

    def get_topology(self, req: Request):
        """zones -> nodesets -> node ids (master/topology.go view); the ONE
        grouping implementation (Master.topology), never re-derived by clients."""
        return {zone: {str(ns): ids for ns, ids in sets.items()}
                for zone, sets in self.master.topology().items()}

    def get_ip(self, req: Request):
        return {"cluster": "chubaofs-tpu", "ip": req.remote}

    def metrics(self, req: Request) -> Response:
        """Prometheus exposition of the cluster rollups — the
        master/monitor_metrics.go analog, derived on scrape from the same
        replicated state the stat endpoints read (no ticker staleness).
        Served by every master (leader=False scrape-ability)."""
        from chubaofs_tpu_torch.utils.exporter import Registry

        reg = Registry(cluster="", module="master")  # namespace cfs_master
        st = self.master.cluster_stat()
        for kind in ("data", "meta"):
            reg.gauge("total_space_bytes", {"kind": kind}).set(
                st[kind]["total_space"])
            reg.gauge("used_space_bytes", {"kind": kind}).set(
                st[kind]["used_space"])
            reg.gauge("nodes", {"kind": kind}).set(st[kind]["nodes"])
            reg.gauge("nodes_active", {"kind": kind}).set(st[kind]["active"])
        reg.gauge("volumes").set(st["volumes"])
        reg.gauge("meta_partitions").set(st["meta_partitions"])
        reg.gauge("data_partitions").set(st["data_partitions"])
        reg.gauge("is_leader").set(1 if self.master.is_leader else 0)
        for vol in self.master.sm.volumes.values():
            lv = {"volume": vol.name}
            reg.gauge("vol_capacity_bytes", lv).set(vol.capacity)
            reg.gauge("vol_meta_partitions", lv).set(len(vol.meta_partitions))
            reg.gauge("vol_data_partitions", lv).set(len(vol.data_partitions))
            reg.gauge("vol_dp_rw", lv).set(
                sum(1 for dp in vol.data_partitions if dp.status == "rw"))
        # the cluster rollups plus this PROCESS's role registries (raft drain
        # counters etc.) — one scrape covers both views of a master daemon
        from chubaofs_tpu_torch.utils import exporter

        return Response(200, {"Content-Type": "text/plain; version=0.0.4"},
                        (reg.render() + exporter.render_all()).encode())

    def get_zone_domains(self, req: Request):
        """zone -> fault domain map (master/topology.go:43 domain mode)."""
        return dict(self.master.sm.zone_domains)

    def set_zone_domain(self, req: Request):
        zone = req.q("zone")
        if not zone:
            raise MasterError("missing ?zone")
        # absent != blank: only an EXPLICIT domain= clears the assignment
        # (a typo'd param name must not silently strip domain protection)
        if not req.has_q("domain"):
            raise MasterError("missing ?domain (pass domain= to clear)")
        doms = self.master.set_zone_domain(zone, req.q("domain"))
        known = {n.zone for n in self.master.sm.nodes.values()}
        return {"domains": doms,
                # a typo'd zone matches no node: report it so the operator
                # doesn't walk away believing domain tolerance is on
                "warning": ("" if zone in known else
                            f"zone {zone!r} matches no registered node")}

    def create_vol(self, req: Request):
        name = req.q("name")
        if not name:
            raise MasterError("missing ?name")
        owner = req.q("owner")
        vol = self.master.create_volume(
            name, owner=owner,
            capacity=int(req.q("capacity", str(1 << 40))),
            cold=req.q("volType") == "cold" or req.q("cold") == "true",
            data_partitions=int(req.q("dpCount", "3")),
            follower_read=req.q("followerRead") == "true",
        )
        if owner and owner in self.master.sm.users:
            self.master.set_vol_owner(owner, name, add=True)
        return self._vol_view(vol)

    def update_vol(self, req: Request):
        """Vol expand/shrink + option/QoS updates (ref /vol/update)."""
        name = req.q("name")
        if not name:
            raise MasterError("missing ?name")

        def opt_int(key):
            return int(req.q(key)) if req.has_q(key) else None

        fr = None
        if req.has_q("followerRead"):
            fr = req.q("followerRead") == "true"
        vol = self.master.update_volume(
            name, capacity=opt_int("capacity"), follower_read=fr,
            qos_read_mbps=opt_int("qosReadMbps"),
            qos_write_mbps=opt_int("qosWriteMbps"))
        return self._vol_view(vol)

    def delete_vol(self, req: Request):
        self.master.delete_volume(req.q("name"))
        return None

    def _vol_view(self, vol) -> dict:
        d = asdict(vol)
        # JSON has no int64 sentinel; surface the tail range end as -1
        for mp in d["meta_partitions"]:
            if mp["end"] >= (1 << 62):
                mp["end"] = -1
            if mp.get("end0", 0) >= (1 << 62):
                mp["end0"] = -1
        return d

    def get_vol(self, req: Request):
        return self._vol_view(self.master.get_volume(req.q("name")))

    def list_vols(self, req: Request):
        return [
            {"name": v.name, "owner": v.owner, "capacity": v.capacity,
             "cold": v.cold, "mp_count": len(v.meta_partitions),
             "dp_count": len(v.data_partitions)}
            for v in self.master.sm.volumes.values()
        ]

    def create_dp(self, req: Request):
        return asdict(self.master.create_data_partition(req.q("name")))

    def client_partitions(self, req: Request):
        return self.master.data_partition_views(req.q("name"))

    def client_meta_partitions(self, req: Request):
        vol = self.master.get_volume(req.q("name"))
        return self._vol_view(vol)["meta_partitions"]

    def _add_node(self, req: Request, kind: str):
        node_id = int(req.q("id"))
        self.master.register_node(node_id, kind, req.q("addr"),
                                  raft_addr=req.q("raftAddr"),
                                  zone=req.q("zone"))
        return {"id": node_id}

    def add_node_data(self, req: Request):
        return self._add_node(req, "data")

    def add_node_meta(self, req: Request):
        return self._add_node(req, "meta")

    def node_heartbeat(self, req: Request):
        import json

        # absent param = "no cursor report" (leaves master state alone);
        # "{}" = an explicit empty report that WIPES the node's cursor set
        raw = req.q("cursors", "")
        cursors = json.loads(raw) if raw else None
        raw_loads = req.q("loads", "")
        raw_splits = req.q("splits", "")
        total = req.q("total_space", "")
        used = req.q("used_space", "")
        self.master.heartbeat(int(req.q("id")),
                              partition_count=int(req.q("partitions", "0")),
                              cursors=cursors,
                              total_space=int(total) if total else None,
                              used_space=int(used) if used else None,
                              loads=json.loads(raw_loads) if raw_loads else None,
                              splits=json.loads(raw_splits) if raw_splits
                              else None)
        return None

    def decommission_meta(self, req: Request):
        return {"migrated": self.master.decommission_metanode(int(req.q("id")))}

    def decommission_data(self, req: Request):
        return {"migrated": self.master.decommission_datanode(int(req.q("id")))}

    def rebalance_hot(self, req: Request):
        """One hot-volume spreading sweep (the capacity harness's knob);
        returns the moves made plus the per-node load view it acted on."""
        moved = self.master.rebalance_hot(
            factor=float(req.q("factor", "1.5")),
            max_moves=int(req.q("maxMoves", "2")))
        return {"moved": moved,
                "loads": {str(k): v
                          for k, v in self.master.data_node_loads().items()}}

    def rebalance_meta(self, req: Request):
        """One meta-partition migration sweep (hot metanodes shed their
        hottest partition replicas onto cold metanodes); returns
        the moves made plus the per-metanode load view it acted on."""
        moved = self.master.rebalance_meta(
            factor=float(req.q("factor", "1.5")),
            max_moves=int(req.q("maxMoves", "1")))
        return {"moved": moved,
                "loads": {str(k): v
                          for k, v in self.master.meta_node_loads().items()}}

    def split_meta(self, req: Request):
        """Load-split one named meta partition at its median live inode now
        (the bench/operator trigger; the CFS_META_SPLIT_OPS path drives the
        same machinery from heartbeat loads). Returns the sibling pid, 0
        when the partition declines (too few inodes / txns in flight)."""
        name = req.q("name")
        if not name:
            raise MasterError("missing ?name")
        try:
            pid = int(req.q("id"))
        except (TypeError, ValueError):
            raise MasterError("missing/bad ?id") from None
        return {"new_pid": self.master.split_meta_partition(name, pid)}

    @staticmethod
    def _user_view(u) -> dict:
        """Public user record: the secret key is returned ONLY at create time
        and over the gated akInfo path — list/info must not leak S3
        credentials through the unauthenticated admin API."""
        d = asdict(u)
        d.pop("secret_key", None)
        return d

    def user_create(self, req: Request):
        # create-time is the one moment the caller gets the secret back.
        # ak/sk may be caller-supplied (deterministic credentials, so an
        # operator can put the access keys in a gateway's CFS_QOS_TENANTS
        # BEFORE the user exists — cfs-capacity --s3 relies on it)
        return asdict(self.master.create_user(
            req.q("user"), req.q("type", "normal"),
            access_key=req.q("ak") or None,
            secret_key=req.q("sk") or None))

    def user_delete(self, req: Request):
        self.master.delete_user(req.q("user"))
        return None

    def user_info(self, req: Request):
        return self._user_view(self.master.get_user(req.q("user")))

    def user_ak_info(self, req: Request):
        from chubaofs_tpu_torch.rpc.server import AUTH_HEADER, sign_path

        if self.service_secret is not None:
            import hmac as _hmac

            want = sign_path(self.service_secret, "/user/akInfo")
            if not _hmac.compare_digest(req.header(AUTH_HEADER), want):
                raise MasterError("akInfo requires the service secret")
        elif req.remote not in ("-", "127.0.0.1", "::1", "localhost"):
            raise MasterError(
                "akInfo without a configured serviceSecret answers loopback "
                "clients only")
        return asdict(self.master.user_by_ak(req.q("ak")))

    def user_update_policy(self, req: Request):
        actions = [a for a in req.q("actions").split(",") if a]
        u = self.master.update_user_policy(
            req.q("user"), req.q("vol"), actions,
            grant=req.q("grant", "true") != "false")
        return self._user_view(u)

    def user_list(self, req: Request):
        return [self._user_view(u) for u in self.master.sm.users.values()]

    def serve(self, addr: str) -> RPCServer:
        host, port = addr.rsplit(":", 1)
        srv = RPCServer(self.router, host=host, port=int(port))
        srv.start()
        return srv


class MasterClient:
    """sdk/master analog: follows the not-leader hint across replicas."""

    def __init__(self, hosts: list[str], retries: int = 4,
                 auth_secret: bytes | None = None,
                 admin_ticket=None):
        """admin_ticket: authnode capability ticket — a static b64 string, or
        a CALLABLE returning one (authnode.server.RenewingTicket) so daemons
        outlive TICKET_TTL; a callable with .refresh() gets one re-acquire
        attempt when the master answers CODE_DENIED."""
        self.auth_secret = auth_secret
        self.admin_ticket = admin_ticket
        self.rpc = RPCClient(hosts, retries=retries, auth_secret=auth_secret)
        self.leader_hint: str | None = None

    def _headers(self) -> dict:
        t = self.admin_ticket
        if t is None:
            return {}
        return {"x-cfs-ticket": t() if callable(t) else t}

    @staticmethod
    def _path(route: str, **params) -> str:
        """Build a query string with every value URL-encoded — volume/user
        names must not be able to smuggle extra parameters."""
        import urllib.parse

        q = urllib.parse.urlencode(
            {k: v for k, v in params.items() if v is not None})
        return f"{route}?{q}" if q else route

    def call(self, path: str) -> object:
        last_msg = "no reply"
        denied_retried = False
        for _ in range(4):
            if self.leader_hint:
                rpc = RPCClient([self.leader_hint], retries=1,
                                auth_secret=self.auth_secret)
                try:
                    out = rpc.get(path, headers=self._headers())
                except (HTTPError, OSError):
                    self.leader_hint = None
                    continue
            else:
                out = self.rpc.get(path, headers=self._headers())
            code = out.get("code")
            if code == CODE_OK:
                return out.get("data")
            if code == CODE_NOT_LEADER:
                hint = (out.get("data") or {}).get("leader") or None
                if hint and hint != self.leader_hint:
                    self.leader_hint = hint
                    continue
                self.leader_hint = None
                import time

                time.sleep(0.1)
                continue
            if code == CODE_BUSY:
                # QoS throttle, not a hard failure: back off and retry
                import time

                last_msg = out.get("msg", "rate limited")
                time.sleep(0.2)
                continue
            if code == CODE_DENIED and callable(self.admin_ticket) \
                    and not denied_retried:
                # expired/stale ticket with a renewing provider: one
                # re-acquire, then retry the call
                denied_retried = True
                refresh = getattr(self.admin_ticket, "refresh", None)
                if refresh is not None:
                    refresh()
                continue
            last_msg = out.get("msg", "error")
            raise MasterError(last_msg)
        raise MasterError(f"master unavailable: {last_msg}")

    # typed helpers the CLI/SDK/objectnode use ---------------------------------

    def get_cluster(self):
        return self.call("/admin/getCluster")

    def get_topology(self):
        return self.call("/admin/getTopology")

    def get_zone_domains(self):
        return self.call("/admin/getZoneDomains")

    def set_zone_domain(self, zone: str, domain: str):
        return self.call(self._path("/admin/setZoneDomain", zone=zone,
                                    domain=domain))

    def create_volume(self, name: str, owner: str = "", cold: bool = False,
                      capacity: int = 1 << 40, dp_count: int = 3,
                      follower_read: bool = False):
        return self.call(self._path(
            "/admin/createVol", name=name, owner=owner,
            cold="true" if cold else "false", capacity=capacity,
            dpCount=dp_count,
            followerRead="true" if follower_read else "false"))

    def update_volume(self, name: str, capacity: int | None = None,
                      follower_read: bool | None = None,
                      qos_read_mbps: int | None = None,
                      qos_write_mbps: int | None = None):
        args = {"name": name}
        if capacity is not None:
            args["capacity"] = capacity
        if follower_read is not None:
            args["followerRead"] = "true" if follower_read else "false"
        if qos_read_mbps is not None:
            args["qosReadMbps"] = qos_read_mbps
        if qos_write_mbps is not None:
            args["qosWriteMbps"] = qos_write_mbps
        return self.call(self._path("/admin/updateVol", **args))

    def delete_volume(self, name: str):
        return self.call(self._path("/admin/deleteVol", name=name))

    def get_volume(self, name: str):
        return self.call(self._path("/admin/getVol", name=name))

    def list_volumes(self):
        return self.call("/admin/listVols")

    def data_partitions(self, name: str):
        return self.call(self._path("/client/partitions", name=name))

    def create_data_partition(self, name: str):
        return self.call(self._path("/admin/createDataPartition", name=name))

    def decommission_node(self, node_id: int, kind: str):
        which = "dataNode" if kind == "data" else "metaNode"
        return self.call(self._path(f"/{which}/decommission", id=node_id))

    def meta_partitions(self, name: str):
        return self.call(self._path("/client/metaPartitions", name=name))

    def add_node(self, node_id: int, kind: str, addr: str, raft_addr: str = "",
                 zone: str = ""):
        which = "dataNode" if kind == "data" else "metaNode"
        return self.call(self._path(f"/{which}/add", id=node_id, addr=addr,
                                    raftAddr=raft_addr, zone=zone))

    def heartbeat(self, node_id: int, partitions: int = 0,
                  cursors: dict | None = None,
                  total_space: int | None = None,
                  used_space: int | None = None,
                  loads: dict | None = None,
                  splits: dict | None = None):
        import json

        return self.call(self._path(
            "/node/heartbeat", id=node_id, partitions=partitions,
            cursors=None if cursors is None else json.dumps(cursors),
            total_space=total_space, used_space=used_space,
            loads=None if loads is None else json.dumps(loads),
            splits=None if splits is None else json.dumps(splits)))

    def rebalance_meta(self, factor: float = 1.5, max_moves: int = 1):
        return self.call(self._path("/metaPartition/rebalance", factor=factor,
                                    maxMoves=max_moves))

    def split_meta_partition(self, name: str, pid: int):
        return self.call(self._path("/metaPartition/split", name=name,
                                    id=pid))

    def rebalance_hot(self, factor: float = 1.5, max_moves: int = 2):
        return self.call(self._path("/dataNode/rebalanceHot", factor=factor,
                                    maxMoves=max_moves))

    def cluster_stat(self):
        return self.call("/admin/getClusterStat")

    def create_user(self, user: str, user_type: str = "normal",
                    ak: str | None = None, sk: str | None = None):
        kw = {"user": user, "type": user_type}
        if ak:
            kw["ak"], kw["sk"] = ak, sk or ""
        return self.call(self._path("/user/create", **kw))

    def delete_user(self, user: str):
        return self.call(self._path("/user/delete", user=user))

    def user_info(self, user: str):
        return self.call(self._path("/user/info", user=user))

    def user_by_ak(self, ak: str):
        return self.call(self._path("/user/akInfo", ak=ak))

    def update_user_policy(self, user: str, vol: str, actions: list[str],
                           grant: bool = True):
        return self.call(self._path(
            "/user/updatePolicy", user=user, vol=vol,
            actions=",".join(actions), grant="true" if grant else "false"))

    def list_users(self):
        return self.call("/user/list")
