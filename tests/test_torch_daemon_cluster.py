"""The cases of tests/test_daemon.py, run against the port on the CPU: every
name and assertion as in the reference, imports from chubaofs_tpu_torch,
and the blobstore daemon built with "device": "cpu". (The port's
blobstore daemon held against the JAX package's is test_torch_daemon.py.)

The reference file's docstring:

Daemon-mode cluster: real TCP raft + master HTTP API + metanode wire.

Mirrors the reference's docker-compose bring-up (SURVEY.md §4) at thread
scale: every control/data path crosses real sockets — raft rides TcpNet,
metadata ops ride MetaService packets, admin rides the master HTTP API —
only process boundaries are collapsed to threads."""

import time

import pytest

from chubaofs_tpu_torch.cmd import DataNodeDaemon, MasterDaemon, MetaNodeDaemon
from chubaofs_tpu_torch.master.api_service import MasterClient
from chubaofs_tpu_torch.master.master import MasterError
from chubaofs_tpu_torch.raft.server import MultiRaft
from chubaofs_tpu_torch.raft.transport import TcpNet
from chubaofs_tpu_torch.sdk.cluster import RemoteCluster
from chubaofs_tpu_torch import chaos as t_chaos


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


def wait_for(cond, timeout=20.0, interval=0.05, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


# -- TcpNet raft ---------------------------------------------------------------


def test_tcp_raft_elects_and_replicates(tmp_path):
    """3 raft nodes over real sockets: elect, propose, all apply."""

    class CountSM:
        def __init__(self):
            self.vals = []

        def apply(self, data, index):
            self.vals.append(data)
            return data * 2

        def snapshot(self):
            import pickle

            return pickle.dumps(self.vals)

        def restore(self, payload):
            import pickle

            self.vals = pickle.loads(payload)

        def on_leader_change(self, leader):
            pass

    peers = {i: "127.0.0.1:0" for i in (1, 2, 3)}
    nets, nodes, sms = {}, {}, {}
    for i in peers:
        nets[i] = TcpNet(i, dict(peers))
    # each net bound an ephemeral port; cross-wire the real addresses
    for i in peers:
        for j in peers:
            nets[i].set_peer(j, nets[j].listen_addr)
    from chubaofs_tpu_torch.raft.server import TickLoop

    for i in peers:
        nodes[i] = MultiRaft(i, nets[i])
        sms[i] = CountSM()
        nodes[i].create_group(7, [1, 2, 3], sms[i])
    loop = TickLoop(list(nodes.values()), interval=0.02)
    loop.start()
    try:
        wait_for(lambda: any(n.is_leader(7) for n in nodes.values()),
                 msg="leader election over TCP")
        leader = next(n for n in nodes.values() if n.is_leader(7))
        assert leader.propose(7, 21).result(timeout=10) == 42
        wait_for(lambda: all(21 in sm.vals for sm in sms.values()),
                 msg="replication to all nodes")
    finally:
        loop.stop()
        for net in nets.values():
            net.close()


# -- full daemon cluster -------------------------------------------------------


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    root = tmp_path_factory.mktemp("daemon")
    master = MasterDaemon({
        "role": "master", "id": 1, "raftPeers": {"1": "127.0.0.1:0"},
        "listen": "127.0.0.1:0", "walDir": str(root / "m1"),
    })
    metas = [
        MetaNodeDaemon({
            "role": "metanode", "id": i, "masterAddrs": [master.addr],
            "walDir": str(root / f"mn{i}"),
        })
        for i in (2, 3, 4)
    ]
    datas = [
        DataNodeDaemon({
            "role": "datanode", "id": 100 + j, "masterAddrs": [master.addr],
            "disks": [str(root / f"dn{j}" / "d0"), str(root / f"dn{j}" / "d1")],
            "walDir": str(root / f"dn{j}" / "wal"),
        })
        for j in (1, 2, 3)
    ]
    wait_for(lambda: master.master.is_leader, msg="master leader")
    mc = MasterClient([master.addr])
    wait_for(
        lambda: sum(1 for n in mc.get_cluster()["nodes"] if n["addr"]) >= 6,
        msg="all nodes registered")
    yield {"master": master, "metas": metas, "datas": datas, "root": root}
    for d in datas + metas + [master]:
        d.stop()


def test_daemon_hot_volume_end_to_end(cluster):
    master = cluster["master"]
    mc = MasterClient([master.addr])
    mc.create_volume("dvol", cold=False)

    # partitions must land on the replicas (self-healing sweep covers races)
    def placed():
        vol = mc.get_volume("dvol")
        mps = vol["meta_partitions"]
        return mps and all(
            any(r.is_leader(mp["partition_id"]) for r in
                (m.raft for m in cluster["metas"]))
            for mp in mps)

    wait_for(placed, msg="meta partition raft leaders")

    rc = RemoteCluster([master.addr])
    fs = rc.client("dvol")
    fs.mkdirs("/a/b")
    payload = b"daemon-mode write " * 500
    fs.write_file("/a/b/hello.bin", payload)
    assert fs.read_file("/a/b/hello.bin") == payload
    assert fs.readdir("/a") == ["b"]
    st = fs.stat("/a/b/hello.bin")
    assert st["size"] == len(payload)

    # a second, fresh client sees the same namespace over the wire
    fs2 = RemoteCluster([master.addr]).client("dvol")
    assert fs2.read_file("/a/b/hello.bin") == payload
    fs2.rename("/a/b/hello.bin", "/a/b/renamed.bin")
    assert fs.readdir("/a/b") == ["renamed.bin"]


def test_daemon_user_store(cluster):
    mc = MasterClient([cluster["master"].addr])
    u = mc.create_user("alice")
    assert u["user_id"] == "alice" and len(u["access_key"]) == 16
    got = mc.user_by_ak(u["access_key"])
    assert got["secret_key"] == u["secret_key"]
    mc.update_user_policy("alice", "dvol", ["perm:writable"])
    info = mc.user_info("alice")
    assert info["authorized_vols"]["dvol"] == ["perm:writable"]
    # credentials only at create time / gated akInfo — never via list/info
    # over the open admin API
    assert "secret_key" not in info
    assert all("secret_key" not in x for x in mc.list_users())
    with pytest.raises(MasterError):
        mc.create_user("alice")
    mc.delete_user("alice")
    with pytest.raises(MasterError):
        mc.user_info("alice")


def test_daemon_metanode_restart_recovers(cluster):
    """Kill one metanode; a new daemon with the same id + walDir rejoins and
    the namespace stays readable (partition_store/WAL replay analog)."""
    master = cluster["master"]
    mc = MasterClient([master.addr])
    mc.create_volume("rvol", cold=False)
    rc = RemoteCluster([master.addr])
    fs = rc.client("rvol")
    fs.write_file("/keep.txt", b"survives restarts")

    victim = cluster["metas"][0]
    vid = victim.node_id
    wal = victim.raft.wal_dir
    victim.stop()
    time.sleep(0.3)

    reborn = MetaNodeDaemon({
        "role": "metanode", "id": vid,
        "masterAddrs": [master.addr], "walDir": wal,
    })
    cluster["metas"][0] = reborn

    def healed():
        try:
            return (RemoteCluster([master.addr]).client("rvol")
                    .read_file("/keep.txt") == b"survives restarts")
        except Exception:
            return False

    wait_for(healed, timeout=30, msg="metanode rejoin + namespace readable")


# -- blobstore gateway + objectnode daemon (cold path over the wire) ----------


def test_daemon_cold_volume_and_s3(cluster, tmp_path):
    import http.client

    from chubaofs_tpu_torch.cmd import BlobstoreDaemon, ObjectNodeDaemon
    from chubaofs_tpu_torch.objectnode.auth import sign_v4

    master = cluster["master"]
    bs = BlobstoreDaemon({"role": "blobstore", "root": str(tmp_path / "blob"),
                         "device": "cpu"})
    onode = None
    try:
        mc = MasterClient([master.addr])
        rc = RemoteCluster([master.addr], access_addrs=[bs.addr])
        mc.create_volume("cvol", cold=True)
        fs = rc.client("cvol")
        payload = b"cold daemon bytes " * 1000
        fs.write_file("/cold.bin", payload)
        assert fs.read_file("/cold.bin") == payload
        assert fs.read_file("/cold.bin", offset=7, size=11) == payload[7:18]

        # S3 face over the same cluster, credentials from the master user store
        u = mc.create_user("s3user")
        onode = ObjectNodeDaemon({
            "role": "objectnode", "masterAddrs": [master.addr],
            "accessAddrs": [bs.addr],
        })
        ak, sk = u["access_key"], u["secret_key"]

        def s3req(method, path, body=b""):
            hdrs = sign_v4(method, path, "", {"host": onode.addr}, ak, sk,
                           payload=body)
            conn = http.client.HTTPConnection(onode.addr, timeout=30)
            try:
                conn.request(method, path, body=body or None, headers=hdrs)
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()

        status, _ = s3req("PUT", "/dbkt")
        assert status == 200
        status, _ = s3req("PUT", "/dbkt/key1", b"s3 over daemons")
        assert status == 200
        status, body = s3req("GET", "/dbkt/key1")
        assert status == 200 and body == b"s3 over daemons"
    finally:
        if onode is not None:
            onode.stop()
        bs.stop()


# -- CLI (cfs-cli analog) ------------------------------------------------------


def test_cli_against_daemon_cluster(cluster, capsys):
    import io
    import json as _json

    from chubaofs_tpu_torch.cli.main import main as cli_main

    addr = cluster["master"].addr

    def run(*argv, expect=0):
        buf = io.StringIO()
        rc = cli_main(["--addr", addr, *argv], out=buf)
        assert rc == expect, buf.getvalue()
        return buf.getvalue()

    out = run("cluster", "info")
    assert "Leader" in out and "meta" in out

    out = run("cluster", "topology")
    assert "ZONE" in out and "NODESET" in out

    run("vol", "create", "clivol", "--dp-count", "3")
    out = run("vol", "list")
    assert "clivol" in out
    out = run("--json", "vol", "info", "clivol")
    v = _json.loads(out)
    assert v["name"] == "clivol" and len(v["meta_partitions"]) >= 1

    out = run("metanode", "list")
    assert out.count("\n") >= 4  # header + 3 metanodes
    out = run("datanode", "list")
    assert out.count("\n") >= 4
    out = run("metapartition", "list", "clivol")
    assert "PARTITION_ID" in out or "partition_id" in out
    out = run("datapartition", "list", "clivol")
    assert "PID" in out

    out = run("--json", "user", "create", "cliuser")
    u = _json.loads(out)
    assert len(u["access_key"]) == 16
    out = run("user", "perm", "cliuser", "clivol", "writable")
    out = run("--json", "user", "info", "cliuser")
    assert _json.loads(out)["authorized_vols"]["clivol"] == ["perm:writable"]
    out = run("user", "list")
    assert "cliuser" in out
    run("user", "delete", "cliuser")

    # delete without --yes refuses; with --yes succeeds
    import pytest as _pytest

    with _pytest.raises(SystemExit):
        run("vol", "delete", "clivol")
    run("vol", "delete", "clivol", "--yes")
    out = run("vol", "list")
    assert "clivol" not in out

    out = run("completion")
    assert "complete -F _cfs_cli" in out


def test_master_metrics_endpoint(tmp_path):
    """Prometheus rollups on /metrics (monitor_metrics.go analog): plain
    text, per-kind space gauges, per-volume partition gauges, scrapeable
    from any master (not just the leader)."""
    import http.client

    from chubaofs_tpu_torch.testing.harness import ProcCluster

    def scrape(addr):
        host, port = addr.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        body = resp.read().decode()
        assert resp.status == 200
        assert resp.getheader("Content-Type", "").startswith("text/plain")
        conn.close()
        return body

    import time

    c = ProcCluster(str(tmp_path), masters=3, metanodes=3, datanodes=3)
    try:
        c.client_master().create_volume("mv", cold=False)
        # followers serve their REPLICA's state: poll briefly for the raft
        # log to converge before asserting exact counts
        deadline = time.time() + 30
        while True:
            bodies = [scrape(a) for a in c.master_addrs]
            if all('cfs_master_vol_data_partitions{volume="mv"} 3' in b
                   for b in bodies) or time.time() > deadline:
                break
            time.sleep(0.5)
        for body in bodies:
            assert 'cfs_master_nodes{kind="data"} 3' in body
            assert 'cfs_master_vol_data_partitions{volume="mv"} 3' in body
        # exactly one leader; FOLLOWERS answer the scrape too (the route
        # skips the leader gate) and say so
        leaders = sum("cfs_master_is_leader 1" in b for b in bodies)
        followers = sum("cfs_master_is_leader 0" in b for b in bodies)
        assert (leaders, followers) == (1, 2), (leaders, followers)
    finally:
        c.close()


def test_daemon_stats_sidedoor_metrics(cluster):
    """metanode/datanode daemons (packet-TCP primary wire) expose /metrics
    on their statsListen HTTP side-door: role-namespaced output including
    raft drain counters with histogram buckets (observability plane)."""
    import http.client

    def scrape(addr):
        host, port = addr.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        body = resp.read().decode()
        conn.close()
        assert resp.status == 200
        return body

    mn = cluster["metas"][0]
    dn = cluster["datas"][0]
    assert mn.stats_addr and dn.stats_addr
    body = scrape(mn.stats_addr)
    # the metanode registered + heartbeats through raft-backed masters, and
    # this PROCESS hosts raft groups: drain metrics render with buckets
    assert "cfs_raft_drain_rounds_total" in body
    assert "cfs_raft_drain_batch_bucket{" in body
    assert scrape(dn.stats_addr)  # datanode side-door serves too
