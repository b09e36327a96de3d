"""The cluster as daemons: the port held against the JAX package on the CPU.

Each case says what it compares.

(a) Same results, cluster to cluster: a JAX ProcCluster (jax_platform="cpu")
    and a port ProcCluster (device="cpu"), each with a blobstore daemon and
    an objectnode, driven by one seeded sequence (volumes, cold and hot
    files, S3 objects, an unlink). Every file and object reads back equal to
    what was written, in both; the master's volume views are equal once the
    fields that carry addresses, ports or clocks are removed (VIEW_VOLATILE).
(b) Clients across the wire, both ways: the port's RemoteCluster and
    MasterClient against the JAX daemons, and the JAX client against the
    port's daemons, over the same files.
(c) Roles across the wire: JAX masters with the port's metanodes, datanodes
    and blobstore daemon ("device": "cpu"); a JAX client writes and reads
    cold and hot files.
(d) GraphQL: the same queries over an FsCluster of each package after the
    same operations give the same JSON.
(e) Fails fast without a GPU: the port's ProcCluster(blobstore=True) with no
    device raises within 30 s naming the blobstore daemon and "no CUDA
    device", and leaves no process.
(f) The host roles need no device: master, metanode, datanode, authnode and
    objectnode boot and serve where CUDA_VISIBLE_DEVICES="".

Blobs stay at or under 1 MiB: the harness's blobstore daemon has 6 nodes x
2 disks, and a larger blob selects EC(12,4), which needs 16 disks.
"""

import http.client
import time
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from chubaofs_tpu.master.api_service import MasterClient as JMasterClient
from chubaofs_tpu.objectnode.auth import sign_v4 as j_sign_v4
from chubaofs_tpu.sdk.cluster import RemoteCluster as JRemoteCluster
from chubaofs_tpu.testing.harness import ProcCluster as JProcCluster
from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.master.api_service import MasterClient
from chubaofs_tpu_torch.objectnode.auth import sign_v4
from chubaofs_tpu_torch.sdk.cluster import RemoteCluster
from chubaofs_tpu_torch.testing.harness import ProcCluster, free_port
from chubaofs_tpu_torch.tools.cfsstat import parse_metrics, scrape

torch.set_num_threads(1)

SEED = 23
# fields of MasterClient.get_volume that name addresses, ports or clocks:
# data partitions' hosts are "ip:port" of datanodes, and a meta partition's
# leader is whichever replica won a timed election. A partition's peers are
# compared as a set: placement takes the least-loaded nodes, and among equals
# the order in which the nodes registered and heartbeat, which is a race.
VIEW_VOLATILE = {"data_partitions": ("hosts",), "meta_partitions": ("leader",)}


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


def _bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _plan():
    rng = np.random.default_rng(SEED)
    cold = {f"/c/d{i % 2}/f{i}.bin": _bytes(rng, int(rng.integers(1, 1 << 20)))
            for i in range(6)}
    hot = {f"/h/f{i}.bin": _bytes(rng, int(rng.integers(1, 300_000)))
           for i in range(4)}
    objs = {f"k/o{i}": _bytes(rng, int(rng.integers(1, 700_000)))
            for i in range(4)}
    return cold, hot, objs


def _retry(fn, timeout=30.0):
    """Writes right after a volume is created race the partitions' raft
    elections; the first op retries until they have leaders."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return fn()
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.3)


def _s3(sign, addr, ak, sk, method, path, body=b"", headers=None,
        raw_query=""):
    hdrs = sign(method, path, raw_query, {"host": addr, **(headers or {})},
                ak, sk, payload=body)
    target = path + (f"?{raw_query}" if raw_query else "")
    conn = http.client.HTTPConnection(addr, timeout=60)
    try:
        conn.request(method, target, body=body or None, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _stable_view(view):
    view = dict(view)
    for key, drop in VIEW_VOLATILE.items():
        view[key] = [{k: sorted(v) if k == "peers" else v
                      for k, v in p.items() if k not in drop}
                     for p in view[key]]
    return view


def _drive(cluster, mc, rc, sign):
    """The seeded sequence, through one package's clients against one
    cluster. Returns what it read back and the master's views."""
    cold, hot, objs = _plan()
    mc.create_volume("pcold", cold=True)
    mc.create_volume("phot", cold=False)
    fc, fh = rc.client("pcold"), rc.client("phot")
    _retry(lambda: fc.mkdirs("/c/d0"))
    fc.mkdirs("/c/d1")
    _retry(lambda: fh.mkdirs("/h"))
    for path, data in cold.items():
        fc.write_file(path, data)
    for path, data in hot.items():
        _retry(lambda: fh.write_file(path, data))
    user = mc.create_user("s3u")
    ak, sk = user["access_key"], user["secret_key"]
    assert _s3(sign, cluster.s3_addr, ak, sk, "PUT", "/pbkt")[0] == 200
    for key, data in objs.items():
        assert _s3(sign, cluster.s3_addr, ak, sk, "PUT", f"/pbkt/{key}",
                   body=data)[0] == 200
    gone_cold, gone_hot = next(iter(cold)), next(iter(hot))
    fc.unlink(gone_cold)
    fh.unlink(gone_hot)

    out = {"files": {}, "objects": {}, "ranges": {}}
    for path in list(cold)[1:]:
        out["files"][path] = fc.read_file(path)
    for path in list(hot)[1:]:
        out["files"][path] = fh.read_file(path)
    out["listing"] = {d: sorted(fc.readdir(d)) for d in ("/c/d0", "/c/d1")}
    out["listing"]["/h"] = sorted(fh.readdir("/h"))
    for key in objs:
        status, _, body = _s3(sign, cluster.s3_addr, ak, sk, "GET",
                              f"/pbkt/{key}")
        assert status == 200
        out["objects"][key] = body
        status, hdrs, body = _s3(sign, cluster.s3_addr, ak, sk, "GET",
                                 f"/pbkt/{key}", headers={"range": "bytes=0-99"})
        out["ranges"][key] = (status, hdrs.get("Content-Range"), body)
    status, _, body = _s3(sign, cluster.s3_addr, ak, sk, "GET", "/pbkt")
    assert status == 200
    out["keys"] = sorted(e.text for e in ET.fromstring(body.decode()).iter()
                         if e.tag.endswith("Key"))
    out["views"] = {v: _stable_view(mc.get_volume(v))
                    for v in ("pcold", "phot", "pbkt")}
    return out


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    root = tmp_path_factory.mktemp("procs")
    topo = dict(masters=1, metanodes=3, datanodes=3, blobstore=True,
                objectnode=True)
    j = JProcCluster(str(root / "jax"), jax_platform="cpu", **topo)
    try:
        t = ProcCluster(str(root / "port"), device="cpu", **topo)
    except BaseException:
        j.close()
        raise
    try:
        jrc = JRemoteCluster(j.master_addrs, access_addrs=[j.access_addr])
        trc = RemoteCluster(t.master_addrs, access_addrs=[t.access_addr])
        results = {
            "jax": _drive(j, JMasterClient(j.master_addrs), jrc, j_sign_v4),
            "port": _drive(t, MasterClient(t.master_addrs), trc, sign_v4),
        }
        yield {"jax": j, "port": t, "results": results}
    finally:
        t.close()
        j.close()


def test_same_results_cluster_to_cluster(clusters):
    """(a) Every file and object reads back as written in both clusters,
    every Range answer and listing is the same, and the master's volume
    views agree once VIEW_VOLATILE is removed and peers are sets."""
    cold, hot, objs = _plan()
    want = {**dict(list(cold.items())[1:]), **dict(list(hot.items())[1:])}
    jr, tr = clusters["results"]["jax"], clusters["results"]["port"]
    for res in (jr, tr):
        assert res["files"] == want
        assert res["objects"] == objs
        for key, data in objs.items():
            assert res["ranges"][key] == (
                206, f"bytes 0-99/{len(data)}", data[:100])
        assert res["keys"] == sorted(objs)
    assert tr["listing"] == jr["listing"]
    assert tr["listing"]["/h"] == ["f1.bin", "f2.bin", "f3.bin"]
    assert tr["views"] == jr["views"]
    assert tr["views"]["pcold"]["cold"] and not tr["views"]["phot"]["cold"]
    assert tr["views"]["pbkt"]["cold"]  # a bucket is a cold volume


@pytest.mark.parametrize("direction", ["port_client_jax_daemons",
                                       "jax_client_port_daemons"])
def test_clients_cross_the_wire(clusters, direction):
    """(b) One package's RemoteCluster and MasterClient against the other's
    daemons: they read the files the owning package wrote, write new cold and
    hot files that the owning package's client reads back, and see the same
    volume views."""
    cold, hot, _ = _plan()
    if direction == "port_client_jax_daemons":
        c, own_mc, own_rc = clusters["jax"], JMasterClient, JRemoteCluster
        mc_cls, rc_cls = MasterClient, RemoteCluster
    else:
        c, own_mc, own_rc = clusters["port"], MasterClient, RemoteCluster
        mc_cls, rc_cls = JMasterClient, JRemoteCluster
    mc = mc_cls(c.master_addrs)
    rc = rc_cls(c.master_addrs, access_addrs=[c.access_addr])
    assert (_stable_view(mc.get_volume("pcold"))
            == _stable_view(own_mc(c.master_addrs).get_volume("pcold")))
    fc, fh = rc.client("pcold"), rc.client("phot")
    for path, data in list(cold.items())[1:]:
        assert fc.read_file(path) == data
        assert fc.read_file(path, offset=3, size=50) == data[3:53]
    for path, data in list(hot.items())[1:]:
        assert fh.read_file(path) == data
    rng = np.random.default_rng(SEED + 1)
    new_cold, new_hot = _bytes(rng, 700_000), _bytes(rng, 200_000)
    fc.write_file(f"/c/{direction}.bin", new_cold)
    fh.write_file(f"/h/{direction}.bin", new_hot)
    orc = own_rc(c.master_addrs, access_addrs=[c.access_addr])
    assert orc.client("pcold").read_file(f"/c/{direction}.bin") == new_cold
    assert orc.client("phot").read_file(f"/h/{direction}.bin") == new_hot


def test_roles_cross_the_wire(tmp_path):
    """(c) JAX masters, the port's metanodes, datanodes and blobstore daemon
    ("device": "cpu") in one cluster; a JAX client writes and reads cold and
    hot files through them."""
    j = JProcCluster.shell(str(tmp_path), jax_platform="cpu")
    t = ProcCluster.shell(str(tmp_path), device="cpu")
    try:
        raft_ports = {i: free_port() for i in (1, 2, 3)}
        api_ports = {i: free_port() for i in (1, 2, 3)}
        raft_peers = {str(i): f"127.0.0.1:{p}" for i, p in raft_ports.items()}
        peer_apis = {str(i): f"127.0.0.1:{p}" for i, p in api_ports.items()}
        j.master_addrs = t.master_addrs = list(peer_apis.values())
        for i in (1, 2, 3):
            j.spawn(f"master{i}", {
                "role": "master", "id": i, "raftPeers": raft_peers,
                "peerApis": peer_apis, "listen": peer_apis[str(i)],
                "walDir": str(tmp_path / f"m{i}")})
        j._await_leader()
        t.access_addr = f"127.0.0.1:{free_port()}"
        t.spawn("blobstore", t.blobstore_cfg())
        for i in (4, 5, 6):
            t.spawn(f"metanode{i}", t.metanode_cfg(i))
        for i in (101, 102, 103):
            t.spawn(f"datanode{i}", t.datanode_cfg(i))
        t.await_nodes(6)
        t._await_listen(t.access_addr, name="blobstore")
        mc = JMasterClient(j.master_addrs)
        mc.create_volume("mixcold", cold=True)
        mc.create_volume("mixhot", cold=False)
        rc = JRemoteCluster(j.master_addrs, access_addrs=[t.access_addr])
        fc, fh = rc.client("mixcold"), rc.client("mixhot")
        rng = np.random.default_rng(SEED + 2)
        files = {f"/f{i}.bin": _bytes(rng, int(rng.integers(1, 1 << 20)))
                 for i in range(4)}
        for path, data in files.items():
            _retry(lambda: fc.write_file(path, data))
            _retry(lambda: fh.write_file(path, data[:300_000]))
        for path, data in files.items():
            assert fc.read_file(path) == data
            assert fh.read_file(path) == data[:300_000]
            assert fc.read_file(path, offset=9, size=77) == data[9:86]
        # the cold bytes were coded by the port's blobstore daemon
        assert rc.data_backend.ac.rpc.hosts == [t.access_addr]
        codec = parse_metrics(scrape(t.access_addr))
        assert codec["cfs_codec_batches_total"] >= len(files)
    finally:
        t.close()
        j.close()


def test_s3_multipart_over_daemons(clusters):
    """A multipart upload through the objectnode daemon lists its parts in
    order and completes. Over the metanode's packet wire the upload's parts
    travel as JSON, whose keys are strings: the JAX package's objectnode
    then finds no part 1 and answers InvalidPart; the port reads the part
    numbers back as ints (objectnode/multipart.py `_parts`)."""
    c = clusters["port"]
    u = MasterClient(c.master_addrs).create_user("mpuser")
    ak, sk = u["access_key"], u["secret_key"]

    def s3(method, path, body=b"", raw_query=""):
        return _s3(sign_v4, c.s3_addr, ak, sk, method, path, body,
                   raw_query=raw_query)

    assert s3("PUT", "/mpbkt")[0] == 200
    status, _, body = s3("POST", "/mpbkt/big", raw_query="uploads=")
    assert status == 200
    upload = ET.fromstring(body.decode()).findtext("UploadId")
    rng = np.random.default_rng(SEED + 3)
    parts = [_bytes(rng, n) for n in (600_000, 300_000, 1000)]
    etags = []
    for n, part in enumerate(parts, start=1):
        status, hdrs, _ = s3("PUT", "/mpbkt/big", part,
                             raw_query=f"partNumber={n}&uploadId={upload}")
        assert status == 200
        etags.append(hdrs["ETag"].strip('"'))
    status, _, body = s3("GET", "/mpbkt/big", raw_query=f"uploadId={upload}")
    assert status == 200
    assert [e.text for e in ET.fromstring(body.decode()).iter()
            if e.tag.endswith("PartNumber")] == ["1", "2", "3"]
    xml = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in enumerate(etags, start=1)) + "</CompleteMultipartUpload>")
    status, _, body = s3("POST", "/mpbkt/big", xml.encode(),
                         raw_query=f"uploadId={upload}")
    assert status == 200 and b"-3" in body
    status, _, body = s3("GET", "/mpbkt/big")
    assert status == 200 and body == b"".join(parts)


def test_create_volume_reads_its_own_write_on_every_master(monkeypatch):
    """RemoteCluster.create_volume returns once every master that answers
    serves the new volume: masters serve getVol from their own replica, and
    the objectnode looks a bucket up right after creating it. A master that
    cannot be reached is skipped."""
    from chubaofs_tpu_torch.master.master import MasterError

    hosts = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]
    lag = {hosts[1]: 3}  # a follower that applies the create 3 reads late
    reads = []

    def create_volume(self, name, cold=False, **kw):
        reads.append(("create", name))

    def get_volume(self, name):
        (host,) = self.rpc.hosts
        reads.append(("get", host))
        if host == hosts[2]:
            raise ConnectionRefusedError(host)
        if lag.get(host, 0):
            lag[host] -= 1
            raise MasterError(f"unknown volume {name!r}")
        return {"name": name}

    monkeypatch.setattr(MasterClient, "create_volume", create_volume)
    monkeypatch.setattr(MasterClient, "get_volume", get_volume)
    RemoteCluster(hosts).create_volume("v")
    assert reads == [("create", "v"), ("get", hosts[0])] + \
        [("get", hosts[1])] * 4 + [("get", hosts[2])]


GQL_QUERIES = [
    ("{ clusterView { leaderID volumeCount nodes { id kind partitions } } }",
     None),
    ("{ volumeList { name owner capacity cold metaPartitions { partitionID "
     "start end peers } dataPartitions { partitionID peers status } } }", None),
    ("query Q($v: String!) { volume(name: $v) { name cold metaPartitions "
     "{ partitionID start end } } }", {"v": "gcold"}),
    ("{ userList { userID accessKey userType ownVols authorizedVols } }", None),
    ('{ userInfo(userID: "gu") { userID authorizedVols } }', None),
    ("{ clusterStat { nodes active volumes metaPartitions dataPartitions "
     "zones { name nodes active } } }", None),
]


def test_graphql_same_json_both_packages(tmp_path):
    """(d) The same GraphQL queries over an FsCluster of each package, after
    the same operations, give the same JSON. The queries select no field
    that carries an address or a clock (addr, raftAddr, lastHeartbeat, a
    partition's elected leader)."""
    from chubaofs_tpu.deploy import FsCluster as JFsCluster
    from chubaofs_tpu.master.gapi import GraphQLAPI as JGraphQLAPI
    from chubaofs_tpu_torch.deploy import FsCluster
    from chubaofs_tpu_torch.master.gapi import GraphQLAPI

    def ops(c):
        c.create_volume("gcold", cold=True)
        c.create_volume("ghot", cold=False)
        m = c.master()
        m.create_user("gu", access_key="gqlak0123456789a", secret_key="s" * 32)
        m.update_user_policy("gu", "gcold", ["perm:writable"])
        return m

    jc = JFsCluster(str(tmp_path / "jax"), n_nodes=3, blob_nodes=6,
                    data_nodes=3)
    try:
        tc = FsCluster(str(tmp_path / "port"), n_nodes=3, blob_nodes=6,
                       data_nodes=3, device="cpu")
        try:
            japi, tapi = JGraphQLAPI(ops(jc)), GraphQLAPI(ops(tc))
            for query, variables in GQL_QUERIES:
                assert (tapi.execute(query, variables)
                        == japi.execute(query, variables)), query
        finally:
            tc.close()
    finally:
        jc.close()


def test_proccluster_without_gpu_fails_fast(tmp_path, monkeypatch):
    """(e) With no GPU and no device, the blobstore daemon refuses to boot;
    the harness raises within 30 s naming it and "no CUDA device", and every
    daemon it spawned has exited."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the blobstore daemon boots")
    spawned = {}
    orig = ProcCluster.spawn

    def recording_spawn(self, name, cfg):
        spawned[name] = orig(self, name, cfg)
        return spawned[name]

    monkeypatch.setattr(ProcCluster, "spawn", recording_spawn)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        ProcCluster(str(tmp_path / "nogpu"), blobstore=True)
    assert time.monotonic() - t0 < 30
    msg = str(err.value)
    assert "blobstore daemon" in msg and "no CUDA device" in msg
    assert {"master1", "master2", "master3", "blobstore"} <= set(spawned)
    assert all(p.poll() is not None for p in spawned.values()), {
        n: p.pid for n, p in spawned.items() if p.poll() is None}


def test_host_roles_boot_without_a_device(tmp_path):
    """(f) master, metanode, datanode, objectnode and authnode boot and serve
    in processes that see no CUDA device."""
    from chubaofs_tpu_torch.rpc.client import RPCClient

    c = ProcCluster(str(tmp_path), masters=1, metanodes=3, datanodes=3,
                    objectnode=True, env={"CUDA_VISIBLE_DEVICES": ""})
    try:
        auth_addr = f"127.0.0.1:{free_port()}"
        c.spawn("authnode", {
            "role": "authnode", "id": 1, "raftPeers": {"1": "127.0.0.1:0"},
            "listen": auth_addr, "walDir": str(tmp_path / "an"),
            "adminSecret": "adm1n"})
        c._await_listen(auth_addr, name="authnode")
        admin = RPCClient([auth_addr], auth_secret=b"adm1n")
        key = _retry(lambda: admin.post("/admin/createkey",
                                        {"id": "svc", "role": "service"}))
        assert key["id"] == "svc" and key["key"]
        for name in ("master1", "metanode2", "datanode101", "objectnode",
                     "authnode"):
            assert c.boot_info(name)["role"], name
        mc = c.client_master()
        mc.create_volume("hostonly", cold=False)
        fs = c.fs("hostonly")
        _retry(lambda: fs.write_file("/x", b"host roles" * 100))
        assert fs.read_file("/x") == b"host roles" * 100
        u = mc.create_user("hu")
        # ListBuckets: the objectnode authenticates the AK at the master
        status, _, _ = _s3(sign_v4, c.s3_addr, u["access_key"],
                           u["secret_key"], "GET", "/")
        assert status == 200
        assert all(p.poll() is None for p in c.procs.values())
    finally:
        c.close()
