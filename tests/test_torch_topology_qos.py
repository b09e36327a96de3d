"""The cases of tests/test_topology_qos.py, run against the port on the CPU:
every name and assertion as in the reference, imports from
chubaofs_tpu_torch, and every MiniCluster and FsCluster built with
device="cpu".

The reference file's docstring:

Master topology (zones/nodesets), zone-aware placement, and QoS.

Reference: master/topology.go:43 (zones, capacity-bounded nodesets),
replica placement never co-locating two replicas in one zone when >= 3 exist,
master/limiter.go (per-API token buckets), blobstore/access/stream_put.go:303-351
(per-disk punish + containment).
"""

import threading
import time

import numpy as np
import pytest

from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
from chubaofs_tpu_torch.master.master import (
    MASTER_GROUP,
    NODESET_CAPACITY,
    Master,
    MasterError,
    MasterSM,
)
from chubaofs_tpu_torch.raft.server import InProcNet, MultiRaft, run_until
from chubaofs_tpu_torch.utils.ratelimit import KeyedLimiter, RateLimitExceeded, TokenBucket
from chubaofs_tpu_torch import chaos as t_chaos


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture
def master(tmp_path):
    net = InProcNet()
    raft = MultiRaft(1, net, wal_dir=str(tmp_path / "m1"))
    sm = MasterSM()
    raft.create_group(MASTER_GROUP, [1], sm)
    assert run_until(net, lambda: raft.is_leader(MASTER_GROUP))
    return Master(raft, sm)


def _register_grid(master, kind, zones, per_zone, base):
    nid = base
    for z in range(zones):
        for _ in range(per_zone):
            master.register_node(nid, kind, addr=f"h{nid}:1", zone=f"z{z}")
            nid += 1


def _zone_of(master, node_id):
    return master.sm.nodes[node_id].zone


# -- topology -----------------------------------------------------------------


def test_nodeset_capacity_split(master):
    for i in range(NODESET_CAPACITY + 2):
        master.register_node(100 + i, "meta", zone="z0")
    sets = {n.nodeset for n in master.sm.nodes.values()}
    assert sets == {0, 1}
    topo = master.topology()
    assert len(topo["z0"][0]) == NODESET_CAPACITY
    assert len(topo["z0"][1]) == 2


def test_zone_spread_three_zones(master):
    """With >= 3 zones, a 3-replica partition never puts two replicas in one
    zone (master/topology.go placement contract)."""
    _register_grid(master, "meta", zones=3, per_zone=2, base=100)
    _register_grid(master, "data", zones=3, per_zone=2, base=200)
    vol = master.create_volume("v1", data_partitions=4)
    for mp in vol.meta_partitions:
        zones = {_zone_of(master, p) for p in mp.peers}
        assert len(zones) == 3, f"mp peers {mp.peers} span only {zones}"
    for dp in vol.data_partitions:
        zones = {_zone_of(master, p) for p in dp.peers}
        assert len(zones) == 3, f"dp peers {dp.peers} span only {zones}"


def test_zone_spread_two_zones_round_robin(master):
    """Fewer zones than replicas: no zone holds two replicas before every zone
    holds one (2 zones -> a 3-replica split of 2+1)."""
    _register_grid(master, "meta", zones=2, per_zone=3, base=100)
    vol = master.create_volume("v2", data_partitions=0, cold=True)
    counts: dict[str, int] = {}
    for p in vol.meta_partitions[0].peers:
        z = _zone_of(master, p)
        counts[z] = counts.get(z, 0) + 1
    assert sorted(counts.values()) == [1, 2]


def test_decommission_replacement_stays_in_zone(master):
    _register_grid(master, "meta", zones=3, per_zone=2, base=100)
    vol = master.create_volume("v3", data_partitions=0, cold=True)
    victim = vol.meta_partitions[0].peers[0]
    victim_zone = _zone_of(master, victim)
    master.decommission_metanode(victim)
    new_peers = master.sm.volumes["v3"].meta_partitions[0].peers
    assert victim not in new_peers
    zones = [_zone_of(master, p) for p in new_peers]
    assert sorted(zones) == ["z0", "z1", "z2"], zones
    assert victim_zone in zones


def test_insufficient_nodes_error(master):
    _register_grid(master, "meta", zones=1, per_zone=2, base=100)
    with pytest.raises(MasterError, match="need 3"):
        master.create_volume("v4", data_partitions=0, cold=True)


# -- rate limiting primitives -------------------------------------------------


def test_token_bucket_burst_and_refill():
    b = TokenBucket(rate=100, burst=10)
    assert b.try_acquire(10)
    assert not b.try_acquire(1)  # drained
    assert b.acquire(1, timeout=0.5)  # refills at 100/s -> ~10ms
    assert not b.acquire(10, timeout=0.01)  # can't refill 10 in 10ms


def test_token_bucket_unlimited():
    b = TokenBucket(rate=0)
    assert b.try_acquire(1e9)


def test_keyed_limiter():
    lim = KeyedLimiter({"op": (5, 2)})
    assert lim.allow("op", 2)
    assert not lim.allow("op", 2)
    assert lim.allow("other")  # unknown keys unlimited by default
    with pytest.raises(RateLimitExceeded):
        lim.check("op", 2)
    lim.set_rate("op", 1000, 1000)
    assert lim.allow("op", 500)


def test_master_api_qos_busy(master):
    """A dry route bucket answers CODE_BUSY instead of doing work
    (master/limiter.go behavior)."""
    from chubaofs_tpu_torch.master.api_service import CODE_BUSY, CODE_OK, MasterAPI
    from chubaofs_tpu_torch.rpc.router import Request

    api = MasterAPI(master, qos=KeyedLimiter({"/admin/getCluster": (0.001, 1)}))

    def req(path):
        return Request(method="GET", path=path, query={}, headers={}, body=b"")

    import json

    r1 = json.loads(api.router.dispatch(req("/admin/getCluster")).body)
    r2 = json.loads(api.router.dispatch(req("/admin/getCluster")).body)
    assert r1["code"] == CODE_OK
    assert r2["code"] == CODE_BUSY


# -- blobstore containment ----------------------------------------------------


class WedgedNode:
    """A blobnode whose writes hang (wedged device); reads still work."""

    def __init__(self, inner):
        self._inner = inner
        self.unwedge = threading.Event()

    def put_shard(self, vuid, bid, payload):
        self.unwedge.wait(timeout=30)
        if not self.unwedge.is_set():
            raise RuntimeError("wedged")
        return self._inner.put_shard(vuid, bid, payload)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def blob_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_wedged_node_does_not_stall_puts(tmp_path, rng):
    """One wedged blobnode: the PUT touching it completes within the write
    deadline via quorum, the wedged disk gets punished (later writes fail
    fast), and unrelated PUTs are unaffected (stream_put.go:303-351)."""
    c = MiniCluster(str(tmp_path), n_nodes=10, disks_per_node=1, device="cpu")
    try:
        c.access.write_deadline = 1.5
        c.access.punish_secs = 30.0
        # pre-create the EC6P3 volume so we can pick a node hosting ONE unit
        vol = c.cm.alloc_volume(13)  # EC6P3: 9 units on 9 of 10 nodes
        per_node: dict[int, int] = {}
        for u in vol.units:
            per_node[u.node_id] = per_node.get(u.node_id, 0) + 1
        wedged_id = next(n for n, k in per_node.items() if k == 1)
        wedged = WedgedNode(c.nodes[wedged_id])
        c.nodes[wedged_id] = wedged

        data = blob_bytes(rng, 600_000)  # selects EC6P3
        t0 = time.monotonic()
        loc = c.access.put(data)
        first = time.monotonic() - t0
        assert first < 5.0, f"PUT stalled {first:.1f}s behind the wedged node"
        assert c.access.get(loc) == data

        # the punish lands asynchronously when the wedged shard write times
        # out at write_deadline (the first PUT already returned via quorum);
        # wait for it so the timed PUT below measures the punished fast-fail
        # path, not this race
        wedged_disk = next(u.disk_id for u in vol.units
                           if u.node_id == wedged_id)
        deadline = time.monotonic() + 10.0
        while (not c.access._is_punished(wedged_disk)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert c.access._is_punished(wedged_disk), "wedged disk never punished"

        # wedged disk now punished: a second PUT fails that shard fast
        t0 = time.monotonic()
        loc2 = c.access.put(blob_bytes(rng, 600_000))
        assert time.monotonic() - t0 < 1.0, "punished disk not failing fast"
        assert c.access.get(loc2)

        # failed shards rode the repair topic
        assert c.proxy.topics["shard_repair"].lag("scheduler") > 0

        wedged.unwedge.set()
        c.nodes[wedged_id] = wedged._inner
    finally:
        c.close()


def test_access_qos_bandwidth(tmp_path, rng):
    c = MiniCluster(str(tmp_path), n_nodes=9, disks_per_node=2, device="cpu")
    try:
        c.access.qos = KeyedLimiter({"put": (1000.0, 200_000.0)})
        c.access.qos_timeout = 0.05
        assert c.access.put(blob_bytes(rng, 150_000))  # within burst
        with pytest.raises(Exception, match="bandwidth limit"):
            c.access.put(blob_bytes(rng, 150_000))  # bucket dry
    finally:
        c.close()


# -- proxy allocation renewal (proxy/allocator/volumemgr.go:348,512) -----------


def test_proxy_alloc_grant_expires(tmp_path):
    """A cached volume grant is re-validated against clustermgr after its TTL:
    a long-running proxy can't keep serving a retired volume forever."""
    from chubaofs_tpu_torch.blobstore.clustermgr import ClusterMgr
    from chubaofs_tpu_torch.blobstore.proxy import Proxy
    from chubaofs_tpu_torch.codec.codemode import CodeMode

    import copy

    cm = ClusterMgr()
    for d in range(10):
        cm.register_disk(d, node_id=d)
    # active_vols=1: this test pins the TTL-renewal path; the rotating
    # multi-volume grant set has its own coverage (pipeline tests)
    proxy = Proxy(cm, alloc_ttl=0.05, active_vols=1)
    mode = int(CodeMode.EC6P3)
    v1 = proxy.alloc_volume(mode)
    assert proxy.alloc_volume(mode).vid == v1.vid  # cached
    # emulate the RPC boundary: the proxy's grant is a SNAPSHOT, not the
    # live clustermgr object (in-process they alias, which would let the
    # status check mask the TTL path under test)
    vols, exp = proxy._cached[mode]
    proxy._cached[mode] = (copy.deepcopy(vols), exp)
    cm.set_volume_status(v1.vid, "idle")  # retired behind the proxy's back
    # before the TTL the stale grant is still served (cache semantics)...
    assert proxy.alloc_volume(mode).vid == v1.vid
    time.sleep(0.06)
    # ...and after it, renewal against clustermgr rotates to a live volume
    v2 = proxy.alloc_volume(mode)
    assert v2.vid != v1.vid and v2.status == "active"


# -- authnode capability tickets on admin APIs ---------------------------------


def test_master_admin_requires_authnode_ticket(tmp_path, master):
    """With a ticket key configured, mutating admin routes demand the
    master:admin capability; reads stay open (authnode/api_service.go:37)."""
    import json

    from chubaofs_tpu_torch.authnode.server import AuthClient, AuthNode, KeystoreSM
    from chubaofs_tpu_torch.master.api_service import (
        CODE_DENIED, CODE_OK, MasterAPI)
    from chubaofs_tpu_torch.raft.server import InProcNet, MultiRaft
    from chubaofs_tpu_torch.rpc.router import Request

    # a real authnode mints the service key + an operator ticket
    net = InProcNet()
    araft = MultiRaft(9, net)
    asm = KeystoreSM()
    from chubaofs_tpu_torch.authnode import AUTH_GROUP

    araft.create_group(AUTH_GROUP, [9], asm)
    assert run_until(net, lambda: araft.is_leader(AUTH_GROUP))
    an = AuthNode(araft, asm)
    svc_key = an.create_key("master", "service")
    op_key = an.create_key("operator", "client", caps=["master:admin"])
    grant = AuthClient(an, "operator", op_key).get_ticket("master")

    _register_grid(master, "meta", zones=3, per_zone=2, base=100)
    api = MasterAPI(master, admin_ticket_key=svc_key)

    def call(path, ticket=None):
        hdrs = {"x-cfs-ticket": ticket} if ticket else {}
        req = Request(method="GET", path=path.split("?")[0],
                      query={k: [v] for k, v in
                             (p.split("=") for p in path.split("?")[1].split("&"))}
                      if "?" in path else {},
                      headers=hdrs, body=b"")
        return json.loads(api.router.dispatch(req).body)

    # no ticket -> denied; read route stays open
    out = call("/admin/createVol?name=tv&cold=true&dpCount=0")
    assert out["code"] == CODE_DENIED
    assert call("/admin/getCluster")["code"] == CODE_OK

    # valid operator ticket -> allowed
    out = call("/admin/createVol?name=tv&cold=true&dpCount=0",
               ticket=grant["ticket"])
    assert out["code"] == CODE_OK, out

    # a ticket without the admin capability -> denied
    weak_key = an.create_key("peon", "client", caps=["objectnode:read"])
    weak = AuthClient(an, "peon", weak_key).get_ticket("master")
    out = call("/admin/deleteVol?name=tv", ticket=weak["ticket"])
    assert out["code"] == CODE_DENIED

    # topology mutations are gated under the NODE capability: no
    # unauthenticated registration/heartbeat, and least privilege both ways —
    # an admin ticket doesn't heartbeat, a node ticket doesn't deleteVol
    node_key = an.create_key("dn1", "client", caps=["master:node"])
    node_grant = AuthClient(an, "dn1", node_key).get_ticket("master")
    assert call("/dataNode/add?id=999&addr=evil:1")["code"] == CODE_DENIED
    assert call("/dataNode/add?id=999&addr=h999:1",
                ticket=grant["ticket"])["code"] == CODE_DENIED
    assert call("/dataNode/add?id=999&addr=h999:1",
                ticket=node_grant["ticket"])["code"] == CODE_OK
    assert call("/node/heartbeat?id=999",
                ticket=node_grant["ticket"])["code"] == CODE_OK
    assert call("/admin/deleteVol?name=tv",
                ticket=node_grant["ticket"])["code"] == CODE_DENIED


def test_renewing_ticket_provider_and_denied_retry(tmp_path, master):
    """Daemons hold credentials, not tickets: the provider renews before
    expiry, and MasterClient re-acquires once on CODE_DENIED."""
    import base64

    from chubaofs_tpu_torch.authnode import AUTH_GROUP
    from chubaofs_tpu_torch.authnode.server import (
        AuthClient, AuthNode, KeystoreSM, RenewingTicket)
    from chubaofs_tpu_torch.master.api_service import MasterAPI, MasterClient
    from chubaofs_tpu_torch.rpc.server import RPCServer

    net = InProcNet()
    araft = MultiRaft(9, net)
    asm = KeystoreSM()
    araft.create_group(AUTH_GROUP, [9], asm)
    assert run_until(net, lambda: araft.is_leader(AUTH_GROUP))
    an = AuthNode(araft, asm)
    svc_key = an.create_key("master", "service")
    op_key = an.create_key("op", "client", caps=["master:admin"])
    auth_client = AuthClient(an, "op", op_key)

    # caching: one grant serves repeated calls; a tiny margin forces renewal
    calls = {"n": 0}
    orig = auth_client.get_ticket

    def counting(service_id):
        calls["n"] += 1
        return orig(service_id)

    auth_client.get_ticket = counting
    prov = RenewingTicket(auth_client, "master")
    t1, t2 = prov(), prov()
    assert t1 == t2 and calls["n"] == 1
    prov.refresh()
    prov()
    assert calls["n"] == 2

    # refresh margin beyond the TTL: every call re-acquires
    eager = RenewingTicket(auth_client, "master", margin=10 ** 9)
    eager(), eager()
    assert calls["n"] == 4

    # end-to-end over HTTP: a provider whose cached ticket went bad gets ONE
    # re-acquire when the master answers CODE_DENIED
    _register_grid(master, "meta", zones=3, per_zone=1, base=100)
    api = MasterAPI(master, admin_ticket_key=svc_key)
    srv = RPCServer(api.router).start()
    try:
        class Flaky:
            def __init__(self):
                self.t = base64.b64encode(b"garbage-ticket").decode()

            def __call__(self):
                return self.t

            def refresh(self):
                self.t = auth_client.get_ticket("master")["ticket"]

        mc = MasterClient([srv.addr], admin_ticket=Flaky())
        vol = mc.create_volume("rtvol", cold=True, dp_count=0)
        assert vol["name"] == "rtvol"
    finally:
        srv.stop()


# -- liveness + partition health loops (master/cluster.go scheduleTask) --------


def test_node_liveness_and_dp_health(master):
    """Stale heartbeats mark nodes inactive, their data partitions demote to
    read-only, and a returning heartbeat restores both."""
    _register_grid(master, "meta", zones=3, per_zone=1, base=100)
    _register_grid(master, "data", zones=3, per_zone=1, base=200)
    now = time.time()
    for nid in (200, 201, 202):
        master.heartbeat(nid)
    vol = master.create_volume("lv", data_partitions=1)
    dp = vol.data_partitions[0]
    assert dp.status == "rw"

    # node 200 goes silent while everyone else keeps beating
    for n in master.sm.nodes.values():
        n.last_heartbeat = now
    master.sm.nodes[200].last_heartbeat = now - 100
    dead = master.check_node_liveness(timeout=10.0, now=now)
    assert dead == [200]
    assert master.sm.nodes[200].status == "inactive"
    assert master.check_data_partitions() == 1
    assert master.sm.volumes["lv"].data_partitions[0].status == "ro"
    # clients only see rw partitions
    assert master.data_partition_views("lv") == []
    # inactive nodes are not placement candidates
    with pytest.raises(MasterError, match="need 3"):
        master.create_volume("lv2", data_partitions=1)

    # the node comes back: heartbeat reactivates, partition promotes to rw
    master.heartbeat(200)
    assert master.check_data_partitions() == 1
    assert master.sm.volumes["lv"].data_partitions[0].status == "rw"
    assert len(master.data_partition_views("lv")) == 1


def test_dead_node_replicas_auto_rehome(master):
    """A node that stays dead past the threshold has its replicas migrated to
    healthy peers without operator action (scheduleToCheckDataReplicas +
    decommission-flow analog); a briefly-dead node is left alone."""
    _register_grid(master, "meta", zones=3, per_zone=1, base=100)
    _register_grid(master, "data", zones=3, per_zone=2, base=200)
    now = time.time()
    for n in master.sm.nodes.values():
        n.last_heartbeat = now
    vol = master.create_volume("arv", data_partitions=1)
    dp = vol.data_partitions[0]
    victim = dp.peers[0]

    master.sm.nodes[victim].last_heartbeat = now - 30
    assert master.check_node_liveness(timeout=10.0, now=now) == [victim]
    assert master.check_data_partitions() == 1  # demoted to ro
    # dead only 30s: liveness demoted it, but no migration yet
    assert master.check_dead_node_replicas(dead_after=60.0, now=now) == 0
    assert victim in master.sm.volumes["arv"].data_partitions[0].peers

    # past the threshold: the replica re-homes and the dp heals back to rw
    master.sm.nodes[victim].last_heartbeat = now - 120
    assert master.check_dead_node_replicas(dead_after=60.0, now=now) == 1
    new_peers = master.sm.volumes["arv"].data_partitions[0].peers
    assert victim not in new_peers and len(new_peers) == 3
    assert master.check_data_partitions() == 1
    assert master.sm.volumes["arv"].data_partitions[0].status == "rw"
    # the node record survives as inactive (it may return empty-handed)
    assert master.sm.nodes[victim].status == "inactive"
    # drained nodes enter the skip set; a returning heartbeat clears it
    assert master.check_dead_node_replicas(dead_after=60.0, now=now) == 0
    assert victim in master._dead_drained
    master.heartbeat(victim)
    assert victim not in master._dead_drained
    assert master.sm.nodes[victim].status == "active"


def test_dead_node_rehome_skips_without_spare_peers(master):
    """No healthy replacement available -> the sweep skips and retries later
    instead of erroring out."""
    _register_grid(master, "meta", zones=3, per_zone=1, base=100)
    _register_grid(master, "data", zones=3, per_zone=1, base=200)
    now = time.time()
    for n in master.sm.nodes.values():
        n.last_heartbeat = now
    master.create_volume("arv2", data_partitions=1)
    victim = master.sm.volumes["arv2"].data_partitions[0].peers[0]
    master.sm.nodes[victim].last_heartbeat = now - 120
    master.check_node_liveness(timeout=10.0, now=now)
    # only 3 data nodes exist; nothing to migrate to
    assert master.check_dead_node_replicas(dead_after=60.0, now=now) == 0
    assert victim in master.sm.volumes["arv2"].data_partitions[0].peers


def test_liveness_leaves_decommissioned_alone(master):
    _register_grid(master, "meta", zones=3, per_zone=2, base=100)
    master.create_volume("dv", data_partitions=0, cold=True)
    victim = master.sm.volumes["dv"].meta_partitions[0].peers[0]
    master.decommission_metanode(victim)
    assert master.sm.nodes[victim].status == "decommissioned"
    master.check_node_liveness(timeout=0.0, now=time.time() + 3600)
    assert master.sm.nodes[victim].status == "decommissioned"
    # and a (buggy/stray) heartbeat must NOT resurrect it into placement
    master.heartbeat(victim)
    assert master.sm.nodes[victim].status == "decommissioned"


# -- fault domains (master/topology.go:43, vol.go domain placement) -----------


def _domain_of(master, node_id):
    return master.domain_of(master.sm.nodes[node_id].zone)


def test_domain_aware_placement_spreads_across_domains(master):
    """With >= 3 domains (of 2 zones each), every 3-replica set lands one
    replica per DOMAIN — a whole-domain loss leaves two replicas."""
    _register_grid(master, "meta", zones=6, per_zone=1, base=100)
    _register_grid(master, "data", zones=6, per_zone=1, base=200)
    for z in range(6):
        master.set_zone_domain(f"z{z}", f"d{z // 2}")  # d0={z0,z1}, ...

    vol = master.create_volume("dv", data_partitions=4)
    for mp in vol.meta_partitions:
        assert len({_domain_of(master, p) for p in mp.peers}) == 3, mp.peers
    for dp in vol.data_partitions:
        assert len({_domain_of(master, p) for p in dp.peers}) == 3, dp.peers


def test_domain_round_robin_with_two_domains(master):
    """Fewer domains than replicas: no domain holds two replicas before
    every domain holds one (the zone round-robin lifted to domains)."""
    _register_grid(master, "meta", zones=4, per_zone=2, base=100)
    _register_grid(master, "data", zones=4, per_zone=2, base=200)
    for z in range(4):
        master.set_zone_domain(f"z{z}", f"d{z % 2}")

    vol = master.create_volume("dv2", data_partitions=3)
    for dp in vol.data_partitions:
        doms = [_domain_of(master, p) for p in dp.peers]
        assert sorted(doms.count(d) for d in set(doms)) == [1, 2], doms
        # the doubled domain still spreads its two replicas over two zones
        for d in set(doms):
            zs = [master.sm.nodes[p].zone for p in dp.peers
                  if _domain_of(master, p) == d]
            assert len(set(zs)) == len(zs), (d, zs)


def test_domain_assignments_replicate_and_snapshot(tmp_path):
    """zone_domains is raft state: it survives WAL replay + snapshot."""
    net = InProcNet()
    raft = MultiRaft(1, net, wal_dir=str(tmp_path / "dm"))
    sm = MasterSM()
    raft.create_group(MASTER_GROUP, [1], sm)
    assert run_until(net, lambda: raft.is_leader(MASTER_GROUP))
    m = Master(raft, sm)
    m.set_zone_domain("za", "east")
    m.set_zone_domain("zb", "west")
    m.set_zone_domain("za", "")  # clear
    blob = sm.snapshot()
    sm2 = MasterSM()
    sm2.restore(blob)
    assert sm2.zone_domains == {"zb": "west"}


def test_whole_domain_loss_tolerated_and_rehomed(master):
    """Kill EVERY node of one domain: reads stay quorate (2/3 replicas
    elsewhere by construction) and the dead-node sweep re-homes onto the
    surviving domains."""
    import time as _time

    _register_grid(master, "meta", zones=3, per_zone=2, base=100)
    _register_grid(master, "data", zones=3, per_zone=2, base=200)
    for z in range(3):
        master.set_zone_domain(f"z{z}", f"d{z}")
    vol = master.create_volume("dl", data_partitions=2)

    # every placement is one-replica-per-domain, so losing d0 leaves 2/3
    dead = [n.node_id for n in master.sm.nodes.values()
            if master.domain_of(n.zone) == "d0"]
    now = _time.time()
    for n in master.sm.nodes.values():
        n.last_heartbeat = now
    for nid in dead:
        master.sm.nodes[nid].last_heartbeat = now - 120
    for dp in vol.data_partitions:
        alive = [p for p in dp.peers if p not in dead]
        assert len(alive) == 2, dp.peers

    # dead-node sweep re-homes the lost replicas into surviving domains
    assert set(master.check_node_liveness(timeout=10.0, now=now)) <= set(dead)
    moved = master.check_dead_node_replicas(dead_after=60.0, now=now)
    assert moved >= 1
    vol = master.get_volume("dl")
    for dp in vol.data_partitions:
        assert not set(dp.peers) & set(dead), dp.peers
        assert len({_domain_of(master, p) for p in dp.peers}) == 2


@pytest.mark.parametrize("seed", [5, 6])
def test_domain_loss_soak(master, seed):
    """Randomized domain-fault soak (the master-plane analog of the
    blobstore's dark-AZ soak): a seeded schedule kills and revives whole
    fault domains; after every sweep, each partition keeps >= 2 live
    replicas, and whenever >= 3 domains are healthy, no partition
    co-locates two replicas in one domain."""
    import random as _random
    import time as _time

    rnd = _random.Random(seed)
    _register_grid(master, "meta", zones=4, per_zone=2, base=100)
    _register_grid(master, "data", zones=4, per_zone=2, base=200)
    for z in range(4):
        master.set_zone_domain(f"z{z}", f"d{z}")
    vol = master.create_volume("soak", data_partitions=3)
    now = _time.time()
    dark: set[str] = set()

    for _ in range(10):
        action = rnd.choice(["kill", "revive", "none"])
        if action == "kill" and len(dark) < 2:
            dark.add(rnd.choice([f"d{z}" for z in range(4)]))
        elif action == "revive" and dark:
            dark.discard(rnd.choice(sorted(dark)))
        now += 300
        for n in master.sm.nodes.values():
            if master.domain_of(n.zone) not in dark:
                n.last_heartbeat = now
                if n.status == "inactive":
                    master.heartbeat(n.node_id)
        master.check_node_liveness(timeout=10.0, now=now)
        master.check_data_partitions()
        master.check_dead_node_replicas(dead_after=60.0, now=now)
        master.check_replica_spread()

        vol = master.get_volume("soak")
        dead_nodes = {n.node_id for n in master.sm.nodes.values()
                      if master.domain_of(n.zone) in dark}
        healthy_domains = 4 - len(dark)
        for dp in vol.data_partitions:
            live = [p for p in dp.peers if p not in dead_nodes]
            assert len(live) >= 2, (dark, dp.peers)
            if healthy_domains >= 3:
                doms = [_domain_of(master, p) for p in dp.peers
                        if p not in dead_nodes]
                assert len(set(doms)) == len(doms), (dark, dp.peers)


# -- operational breadth (vol update, per-vol QoS, health sweeps) --------------


def test_vol_update_expand_shrink_and_options(master):
    _register_grid(master, "meta", zones=3, per_zone=1, base=100)
    _register_grid(master, "data", zones=3, per_zone=1, base=200)
    master.create_volume("uv", capacity=1 << 30)
    vol = master.update_volume("uv", capacity=4 << 30)  # expand
    assert vol.capacity == 4 << 30
    vol = master.update_volume("uv", capacity=1 << 20)  # shrink allowed
    assert vol.capacity == 1 << 20
    with pytest.raises(MasterError):
        master.update_volume("uv", capacity=0)
    vol = master.update_volume("uv", follower_read=True,
                               qos_read_mbps=100, qos_write_mbps=50)
    assert vol.follower_read and vol.qos_read_mbps == 100
    assert vol.qos_write_mbps == 50
    with pytest.raises(MasterError):
        master.update_volume("missing", capacity=1)
    # options survive snapshot/restore (the restore-path .get defaults)
    blob = master.sm.snapshot()
    sm2 = MasterSM()
    sm2.restore(blob)
    v2 = sm2.volumes["uv"]
    assert (v2.qos_read_mbps, v2.qos_write_mbps, v2.follower_read) == \
        (100, 50, True)


def test_vol_qos_flows_to_client_and_throttles(tmp_path):
    """Master-assigned MB/s limits reach the client's FsClient and shape
    its writes (limiter.go assignment flowing master -> client)."""
    import time as _time

    from chubaofs_tpu_torch.deploy import FsCluster

    c = FsCluster(str(tmp_path), n_nodes=3, blob_nodes=0, data_nodes=3,
                  device="cpu")
    try:
        c.create_volume("qv", cold=False)
        c.master().update_volume("qv", qos_write_mbps=2)  # 2 MB/s
        fs = c.client("qv")
        assert fs.qos is not None
        t0 = _time.perf_counter()
        # 6 MB at 2 MB/s, burst 2 MB: first chunk free, then ~2s of shaping
        fs.write_file("/q.bin", b"x" * (6 << 20))
        dt = _time.perf_counter() - t0
        assert dt > 1.5, f"throttle did not shape ({dt:.2f}s for 6MB at 2MB/s)"
        # unlimited volume: the qos object exists (so later tightening can
        # reach live clients via the periodic refetch) but passes bytes
        # through untouched
        c.create_volume("fast", cold=False)
        fq = c.client("fast").qos
        assert fq is not None and fq.write.rate <= 0
        t0 = _time.perf_counter()
        fq.throttle_write(100 << 20)  # must not loop per-byte
        assert _time.perf_counter() - t0 < 0.1
    finally:
        c.close()


def test_qos_tightening_reaches_live_client(tmp_path, monkeypatch):
    """Limits flow master -> EXISTING clients via the periodic refetch:
    no client rebuild needed to throttle a misbehaving tenant."""
    import time as _time

    from chubaofs_tpu_torch.deploy import FsCluster
    from chubaofs_tpu_torch.sdk.fs import VolQos

    monkeypatch.setattr(VolQos, "REFRESH_SECS", 0.0)  # refetch every charge
    c = FsCluster(str(tmp_path), n_nodes=3, blob_nodes=0, data_nodes=3,
                  device="cpu")
    try:
        c.create_volume("lt", cold=False)
        fs = c.client("lt")  # built while UNLIMITED
        fs.write_file("/a.bin", b"x" * (1 << 20))  # fast
        c.master().update_volume("lt", qos_write_mbps=2)
        t0 = _time.perf_counter()
        fs.write_file("/b.bin", b"x" * (6 << 20))
        assert _time.perf_counter() - t0 > 1.5, "tightened limit not applied"
    finally:
        c.close()


def test_rehome_prefers_victims_domain_sibling_zone(master):
    """Scenario: domains D1={z1,z2}, D2={z3}, D3={z4}; peers in
    z1/z3/z4. The z1 node dies with z1 empty but z2 healthy: the
    replacement must land in z2 (domain D1 holds NO replica after the
    loss), never co-locating two replicas in D2 or D3."""
    import time as _time

    master.register_node(101, "meta", addr="m1:1", zone="z1")
    master.register_node(102, "meta", addr="m2:1", zone="z3")
    master.register_node(103, "meta", addr="m3:1", zone="z4")
    for z, nid in [("z1", 201), ("z3", 202), ("z4", 203)]:
        master.register_node(nid, "data", addr=f"h{nid}:1", zone=z)
    master.register_node(204, "data", addr="h204:1", zone="z2")  # D1 sibling
    master.register_node(205, "data", addr="h205:1", zone="z3")  # D2 extra
    for z, d in [("z1", "D1"), ("z2", "D1"), ("z3", "D2"), ("z4", "D3")]:
        master.set_zone_domain(z, d)

    vol = master.create_volume("rh", data_partitions=1)
    dp = vol.data_partitions[0]
    assert sorted(dp.peers) == [201, 202, 203]  # one per domain
    now = _time.time()
    for n in master.sm.nodes.values():
        n.last_heartbeat = now
    master.sm.nodes[201].last_heartbeat = now - 120  # z1 dies
    master.check_node_liveness(timeout=10.0, now=now)
    assert master.check_dead_node_replicas(dead_after=60.0, now=now) == 1
    peers = master.get_volume("rh").data_partitions[0].peers
    assert 204 in peers, f"replacement {peers} skipped D1's sibling zone z2"


def test_ensure_replica_counts_sweep(master):
    """Under-replicated partitions (partial migration surgery) regain a
    third replica from the sweep; the replacement lands in a distinct
    zone when possible."""
    _register_grid(master, "meta", zones=3, per_zone=2, base=100)
    _register_grid(master, "data", zones=3, per_zone=2, base=200)
    vol = master.create_volume("rc", data_partitions=2)
    dp = vol.data_partitions[0]
    # surgical removal: drop one peer, as a half-finished migration leaves it
    master._apply("update_dp_members", vol_name="rc",
                  partition_id=dp.partition_id, peers=dp.peers[:2],
                  hosts=dp.hosts[:2])
    mp = vol.meta_partitions[0]
    master._apply("update_mp_peers", vol_name="rc",
                  partition_id=mp.partition_id, peers=mp.peers[:2])
    assert master.ensure_replica_counts() == 2
    vol = master.get_volume("rc")
    assert len(vol.data_partitions[0].peers) == 3
    assert len(vol.meta_partitions[0].peers) == 3
    assert len({_zone_of(master, p)
                for p in vol.data_partitions[0].peers}) == 3
    assert master.ensure_replica_counts() == 0  # idempotent


def test_prune_stale_nodes_sweep(master):
    import time as _time

    _register_grid(master, "meta", zones=3, per_zone=1, base=100)
    _register_grid(master, "data", zones=3, per_zone=2, base=200)
    now = _time.time()
    vol = master.create_volume("pv", data_partitions=1)
    hosted = set(vol.data_partitions[0].peers)
    spare = next(n.node_id for n in master.sm.nodes.values()
                 if n.kind == "data" and n.node_id not in hosted)
    # the spare dies and stays dead far past the stale window
    master.sm.nodes[spare].last_heartbeat = now - 7200
    master.check_node_liveness(timeout=10.0, now=now)
    # a node still HOSTING replicas is never pruned, however stale
    victim = next(iter(hosted))
    master.sm.nodes[victim].last_heartbeat = now - 7200
    master.sm.nodes[victim].status = "inactive"
    pruned = master.prune_stale_nodes(stale_after=3600.0, now=now)
    assert pruned == [spare]
    assert spare not in master.sm.nodes
    assert victim in master.sm.nodes
    # an active node is never pruned
    assert all(n.status != "active" or n.node_id in master.sm.nodes
               for n in master.sm.nodes.values())
    # re-registration starts clean
    master.register_node(spare, "data", addr="h:1", zone="z0")
    assert master.sm.nodes[spare].status == "active"


def test_orphan_partition_listing(master):
    _register_grid(master, "meta", zones=3, per_zone=1, base=100)
    _register_grid(master, "data", zones=3, per_zone=1, base=200)
    vol = master.create_volume("ov", data_partitions=1)
    dp_id = vol.data_partitions[0].partition_id
    node = vol.data_partitions[0].peers[0]
    # node reports the real partition + a ghost from a failed delete
    master.heartbeat(node, cursors={dp_id: 0, 9999: 0})
    assert master.orphan_partitions() == {node: [9999]}
    # the real partition is never flagged
    master.heartbeat(node, cursors={dp_id: 0})
    assert master.orphan_partitions() == {}
    # per-NODE detection: a migrated-away replica whose remove task never
    # landed (victim was dead) is flagged even though the pid still exists
    # in the volume — on the NEW peers
    stranger = 299
    master.register_node(stranger, "data", addr="h299:1", zone="z0")
    master.heartbeat(stranger, cursors={dp_id: 0})
    assert master.orphan_partitions() == {stranger: [dp_id]}


def test_cluster_stat_rollup(master):
    """Space/health rollup from heartbeat reports (scheduleToUpdateStatInfo +
    /admin/getClusterStat analog), per zone and cluster-wide."""
    _register_grid(master, "meta", zones=2, per_zone=1, base=100)
    _register_grid(master, "data", zones=2, per_zone=1, base=200)
    master.heartbeat(100, total_space=1000, used_space=250)
    master.heartbeat(200, total_space=2000, used_space=500)
    master.heartbeat(201, total_space=4000)  # partial report: used unchanged

    st = master.cluster_stat()
    assert st["total_space"] == 7000 and st["used_space"] == 750
    assert st["nodes"] == 4 and st["active"] == 4
    assert st["zones"]["z0"]["total_space"] == 3000
    assert st["zones"]["z1"]["total_space"] == 4000
    assert st["volumes"] == 0 and st["meta_partitions"] == 0
    # per-kind split (ref getClusterStat keeps DataNodeStatInfo and
    # MetaNodeStatInfo separate, proto/model.go:162): metanode WAL space
    # must not inflate the data-storage capacity figure
    assert st["data"]["total_space"] == 6000 and st["data"]["used_space"] == 500
    assert st["meta"]["total_space"] == 1000 and st["meta"]["used_space"] == 250
    assert st["zones"]["z0"]["data"]["total_space"] == 2000
    assert st["zones"]["z0"]["meta"]["total_space"] == 1000
    assert st["zones"]["z1"]["meta"]["total_space"] == 0

    # a repeat heartbeat without a space report leaves the numbers alone
    master.heartbeat(100)
    assert master.cluster_stat()["total_space"] == 7000


def test_replica_spread_repair_sweep(master):
    """Spread repair (found by the extended domain soak): a partition whose
    replicas concentrated in one domain during a multi-domain outage moves
    a doubled replica out once a free healthy domain returns; partitions
    already spread, or with nowhere better to go, are left alone."""
    import time as _time

    _register_grid(master, "meta", zones=3, per_zone=1, base=100)
    _register_grid(master, "data", zones=3, per_zone=2, base=200)
    for z in range(3):
        master.set_zone_domain(f"z{z}", f"d{z}")
    vol = master.create_volume("sp", data_partitions=1)
    dp = vol.data_partitions[0]
    now = _time.time()
    for n in master.sm.nodes.values():
        n.last_heartbeat = now

    # simulate the outage residue: both z0 nodes (domain d0) plus one z1
    # node — d0 doubled, d2 unrepresented though healthy
    z1_peer = next(p for p in dp.peers if master.sm.nodes[p].zone == "z1")
    forced = [200, 201, z1_peer]
    hosts = [master.sm.nodes[p].addr for p in forced]
    master._apply("update_dp_members", vol_name="sp",
                  partition_id=dp.partition_id, peers=forced, hosts=hosts)

    assert master.check_replica_spread() == 1
    peers = master.get_volume("sp").data_partitions[0].peers
    doms = [master.domain_of(master.sm.nodes[p].zone) for p in peers]
    assert sorted(doms) == ["d0", "d1", "d2"], doms
    # idempotent: a spread partition is untouched
    assert master.check_replica_spread() == 0
