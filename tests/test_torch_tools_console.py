"""The cases of tests/test_tools_console.py against the port on the CPU:
fsck, fdstore, authtool, autofs, preload, the master's GraphQL surface, the
console over a daemon master and its partial-failure rollup, localcluster
and the ProcCluster boot-failure guard. Every name and assertion as in the
reference, imports from chubaofs_tpu_torch, and every cluster built with
device="cpu". Then the port held against the reference byte for byte: fsck
reports on one seeded damaged tree, authtool decodes of tickets minted by
either package, and every console rollup over one fixed daemon.

The reference file's docstring:

Operator tools (fsck/fdstore/authtool/autofs/preload) + console/GraphQL."""

import pytest

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.deploy import FsCluster


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = FsCluster(str(tmp_path_factory.mktemp("tools")), n_nodes=3,
                  blob_nodes=6, data_nodes=0, device="cpu")
    c.create_volume("tl", cold=True)
    yield c
    c.close()


def test_graphql_queries(cluster):
    from chubaofs_tpu_torch.master.gapi import GQLError, GraphQLAPI

    api = GraphQLAPI(cluster.master())
    data = api.execute("""query Overview {
      clusterView { leaderID nodes { id kind } }
      volumeList { name cold metaPartitions { partitionID } }
    }""")
    assert data["clusterView"]["leaderID"] is not None
    assert {n["kind"] for n in data["clusterView"]["nodes"]} >= {"meta"}
    assert any(v["name"] == "tl" and v["cold"] for v in data["volumeList"])
    # arguments + variables, including a typed variable-definition list
    data = api.execute('query Q($v: String!) { volume(name: $v) { name owner } }',
                       {"v": "tl"})
    assert data["volume"]["name"] == "tl"
    # UTF-8 string literals survive (no unicode_escape mojibake)
    with pytest.raises(Exception, match="café"):
        api.execute('{ volume(name: "café") { name } }')
    # clusterStat: the dashboard capacity rollup rides the same endpoint
    data = api.execute(
        "{ clusterStat { nodes active volumes totalSpace zones { name nodes } } }")
    assert data["clusterStat"]["nodes"] >= 1
    assert data["clusterStat"]["volumes"] >= 1
    assert isinstance(data["clusterStat"]["zones"], list)
    # missing required argument is a GraphQL error, not a 500
    with pytest.raises(GQLError):
        api.execute("{ volume { name } }")
    with pytest.raises(GQLError):
        api.execute("{ nope }")
    with pytest.raises(GQLError):
        api.execute("mutation { hack }")


def test_proccluster_boot_failure_reaps_spawned_daemons(tmp_path, monkeypatch):
    """A partial boot (e.g. leader-election timeout) must not orphan already-
    spawned daemons: the constructor guard closes them before re-raising."""
    import subprocess
    import sys

    from chubaofs_tpu_torch.testing import harness

    spawned = {}

    def fake_boot(self, *a, **kw):
        p = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
        self.procs["master1"] = p
        spawned["p"] = p
        raise TimeoutError("no raft leader within 30s")

    monkeypatch.setattr(harness.ProcCluster, "_boot", fake_boot)
    try:
        with pytest.raises(TimeoutError):
            harness.ProcCluster(str(tmp_path / "boom"), masters=1, metanodes=0,
                                datanodes=0)
        assert spawned["p"].poll() is not None, (
            "orphaned daemon after boot failure")
    finally:
        if spawned["p"].poll() is None:  # a regression must not leak the child
            spawned["p"].kill()
            spawned["p"].wait(timeout=10)


# -- fsck ----------------------------------------------------------------------


def test_fsck_clean_tree(cluster):
    from chubaofs_tpu_torch.tools.fsck import Fsck

    fs = cluster.client("tl")
    fs.mkdirs("/ok/sub")
    fs.write_file("/ok/sub/file", b"data")
    rep = Fsck(fs.meta).check()
    assert rep.clean, rep.summary()
    assert rep.inode_count >= 4  # root + 2 dirs + file


def test_fsck_detects_and_cleans(cluster):
    from chubaofs_tpu_torch.tools.fsck import Fsck

    fs = cluster.client("tl")
    fs.mkdirs("/broken")
    parent = fs.resolve("/broken")
    # dangling dentry: points at an inode that was never created
    fs.meta.create_dentry(parent, "ghost", 999_999, 0o100644)
    # orphan inode: created, never linked
    orphan = fs.meta.create_inode(0o100644)
    # fresh unreferenced inodes are within the mid-creation grace window
    assert orphan.ino not in Fsck(fs.meta).check().orphan_inodes
    checker = Fsck(fs.meta, orphan_grace=0.0)
    rep = checker.check()
    assert (parent, "ghost", 999_999) in rep.dangling_dentries
    assert orphan.ino in rep.orphan_inodes
    rep2 = checker.clean()
    assert rep2.cleaned >= 2
    assert checker.check().clean


# -- fdstore -------------------------------------------------------------------


def test_fdstore_passes_fds(tmp_path):
    import os

    from chubaofs_tpu_torch.tools.fdstore import FdStore, FdStoreClient

    sock = str(tmp_path / "fd.sock")
    store = FdStore(sock)
    try:
        client = FdStoreClient(sock)
        r, w = os.pipe()
        os.write(w, b"surviving the upgrade")
        client.put("mount-1", [r, w])
        os.close(r)
        os.close(w)  # the store holds its own duplicates

        assert client.list() == ["mount-1"]
        # the "new client process" collects the fds back
        got = client.get("mount-1")
        assert len(got) == 2
        assert os.read(got[0], 64) == b"surviving the upgrade"
        for fd in got:
            os.close(fd)
        with pytest.raises(KeyError):
            client.get("mount-1")  # one-shot handoff
    finally:
        store.close()


# -- authtool ------------------------------------------------------------------


def test_authtool_genkey_and_decode(capsys, cluster):
    import base64
    import json

    from chubaofs_tpu_torch.tools.authtool import main as authtool_main

    assert authtool_main(["genkey"]) == 0
    key = capsys.readouterr().out.strip()
    assert len(base64.b64decode(key)) == 32

    # decode a real ticket minted by the in-proc authnode
    auth = cluster.authnode()
    ckey = auth.create_key("cli1", "client", caps=["svc:*"])
    skey = auth.create_key("svc", "service")
    from chubaofs_tpu_torch.authnode.server import AuthClient

    grant = AuthClient(auth, "cli1", ckey).get_ticket("svc")
    rc = authtool_main([
        "decode", grant["ticket"], base64.b64encode(skey).decode(),
        "--service", "svc"])
    assert rc == 0
    claims = json.loads(capsys.readouterr().out)
    assert claims["client_id"] == "cli1"


# -- autofs --------------------------------------------------------------------


def test_autofs_map_entry():
    from chubaofs_tpu_torch.tools.autofs import map_entry_to_config

    cfg = map_entry_to_config(
        "media", "-fstype=chubaofs,master=m1:17010;m2:17010,vol=media,ro")
    assert cfg["masterAddr"] == ["m1:17010", "m2:17010"]
    assert cfg["volName"] == "media"
    assert cfg["mountPoint"] == "/media"
    with pytest.raises(ValueError):
        map_entry_to_config("x", "-fstype=nfs,master=m:1")


# -- preload -------------------------------------------------------------------


def test_preload_walks_and_reads(cluster):
    from chubaofs_tpu_torch.tools.preload import Preloader

    fs = cluster.client("tl")
    fs.mkdirs("/warm/deep")
    fs.write_file("/warm/a.bin", b"a" * 10_000)
    fs.write_file("/warm/deep/b.bin", b"b" * 20_000)
    stats = Preloader(fs, workers=2).run("/warm")
    assert stats.files == 2 and stats.errors == 0
    assert stats.bytes == 30_000


# -- console -------------------------------------------------------------------


def test_console_over_daemon_master(tmp_path):
    import json
    import urllib.request

    from chubaofs_tpu_torch.cmd import ConsoleDaemon, MasterDaemon

    master = MasterDaemon({
        "role": "master", "id": 1, "raftPeers": {"1": "127.0.0.1:0"},
        "listen": "127.0.0.1:0", "walDir": str(tmp_path / "m"),
    })
    console = None
    try:
        import time

        deadline = time.time() + 10
        while not master.master.is_leader and time.time() < deadline:
            time.sleep(0.05)
        console = ConsoleDaemon({"role": "console",
                                 "masterAddrs": [master.addr]})
        page = urllib.request.urlopen(
            f"http://{console.addr}/", timeout=10).read()
        assert b"chubaofs-tpu console" in page
        overview = json.loads(urllib.request.urlopen(
            f"http://{console.addr}/api/overview", timeout=10).read())
        assert overview["clusterView"]["leaderID"] == 1
        req = urllib.request.Request(
            f"http://{console.addr}/graphql",
            data=json.dumps({"query": "{ userList { userID } }"}).encode(),
            headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=10).read())
        assert out["data"]["userList"] == []
    finally:
        if console is not None:
            console.stop()
        master.stop()


def test_console_rollup_reports_unreachable_targets(tmp_path):
    """Partial-failure contract: a target the console can't reach shows up
    in /api/health AS FAILING and in /api/metrics with an UNREACHABLE
    marker — never silently dropped (a dead daemon must not render an
    all-green cluster)."""
    import json
    import urllib.request

    from chubaofs_tpu_torch.console.server import Console
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer
    from chubaofs_tpu_torch.testing.harness import free_port

    srv = RPCServer(Router(), module="partial").start()
    dead = f"127.0.0.1:{free_port()}"  # reserved-then-released: nobody home
    console = Console([srv.addr], metrics_addrs=[dead])
    try:
        health = json.loads(urllib.request.urlopen(
            f"http://{console.addr}/api/health", timeout=15).read())
        assert health["status"] == "failing"
        assert dead in health["unreachable"]
        by_target = {t["target"]: t for t in health["targets"]}
        assert by_target[dead]["status"] == "failing"
        assert "unreachable" in by_target[dead]["reasons"]
        assert by_target[srv.addr]["status"] in ("ok", "degraded")
        # /api/metrics: the corpse is marked, the live target still scrapes
        text = urllib.request.urlopen(
            f"http://{console.addr}/api/metrics", timeout=15).read().decode()
        assert f"target {dead} UNREACHABLE" in text
        assert f"target {srv.addr} ==" in text
        # ... and cfs-top's rollup parser keeps the distinction
        from chubaofs_tpu_torch.tools.cfstop import split_rollup

        sections = split_rollup(text)
        assert sections[dead] is None
        assert sections[srv.addr], "live target's metrics parsed empty"
    finally:
        console.stop()
        srv.stop()


# -- localcluster (run_docker.sh -r analog) ------------------------------------


def test_localcluster_tool_launches_and_serves(tmp_path):
    """The one-command local cluster comes up, registers its nodes, serves a
    volume end to end, and tears down cleanly (docker-compose analog)."""
    import argparse

    from chubaofs_tpu_torch.tools.localcluster import launch

    args = argparse.Namespace(root=str(tmp_path / "lc"), masters=1,
                              metanodes=3, datanodes=3, blobstore=False,
                              objectnode=False, device="cpu")
    cluster = launch(args)  # constructor already waits for node registration
    try:
        mc = cluster.client_master()
        mc.create_volume("lcvol", cold=False)
        fs = cluster.fs("lcvol")
        fs.write_file("/hello.txt", b"from the local cluster tool")
        assert fs.read_file("/hello.txt") == b"from the local cluster tool"
    finally:
        cluster.close()


def test_localcluster_defaults_to_the_cuda_device(tmp_path):
    """Without a device the blobstore daemon takes the CUDA device; on a host
    without one the launch raises naming it, and leaves no daemon behind."""
    import argparse

    import torch

    from chubaofs_tpu_torch.testing.harness import ProcCluster
    from chubaofs_tpu_torch.tools.localcluster import launch, main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the blobstore daemon boots")
    spawned = []
    orig = ProcCluster.spawn

    def recording_spawn(self, name, cfg):
        spawned.append(orig(self, name, cfg))
        return spawned[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(ProcCluster, "spawn", recording_spawn)
    try:
        args = argparse.Namespace(root=str(tmp_path / "lc"), masters=1,
                                  metanodes=0, datanodes=0, blobstore=True,
                                  objectnode=False, device=None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch(args)
    finally:
        mp.undo()
    assert spawned and all(p.poll() is not None for p in spawned)
    with pytest.raises(SystemExit):
        main(["--help"])


# -- the port's tools and console against the reference's ---------------------


def _damaged_tree(cluster, seed: int):
    """A seeded tree with every kind of damage fsck reports: dangling
    dentries, orphan inodes, link-count drift and unreachable directories.
    Returns the volume's MetaWrapper."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cluster.create_volume("fv", cold=True)
    fs = cluster.client("fv")
    dirs = ["/t"]
    for i in range(int(rng.integers(3, 6))):
        d = f"{dirs[int(rng.integers(len(dirs)))]}/d{i}"
        fs.mkdirs(d)
        dirs.append(d)
    files = []
    for i in range(int(rng.integers(6, 12))):
        p = f"{dirs[int(rng.integers(len(dirs)))]}/f{i}"
        fs.write_file(p, rng.integers(0, 256, int(rng.integers(1, 5000)),
                                      dtype=np.uint8).tobytes())
        files.append(p)
    meta = fs.meta
    for i in range(int(rng.integers(1, 4))):
        meta.create_dentry(fs.resolve(dirs[int(rng.integers(len(dirs)))]),
                           f"ghost{i}", int(rng.integers(500_000, 900_000)),
                           0o100644)
    for _ in range(int(rng.integers(1, 4))):
        meta.create_inode(0o100644)
    for i in range(2):  # a second dentry the inode's nlink does not count
        ino = fs.resolve(files[int(rng.integers(len(files)))])
        meta.create_dentry(fs.resolve("/t"), f"alias{i}", ino, 0o100644)
    # a directory tree no path reaches: /lost's inode with a child, no
    # dentry naming it
    lost = meta.create_inode(0o40755)
    inner = meta.create_inode(0o40755)
    meta.create_dentry(lost.ino, "inner", inner.ino, 0o40755)
    return meta


def test_fsck_reports_same_as_reference(tmp_path):
    from dataclasses import asdict

    from chubaofs_tpu.deploy import FsCluster as JFsCluster
    from chubaofs_tpu.tools.fsck import Fsck as JFsck
    from chubaofs_tpu_torch.tools.fsck import Fsck

    out = {}
    for name, make, fsck in (
            ("j", lambda r: JFsCluster(r, n_nodes=3, blob_nodes=6, data_nodes=0), JFsck),
            ("t", lambda r: FsCluster(r, n_nodes=3, blob_nodes=6, data_nodes=0,
                                      device="cpu"), Fsck)):
        c = make(str(tmp_path / name))
        try:
            meta = _damaged_tree(c, seed=41)
            checker = fsck(meta, orphan_grace=0.0)
            before = checker.check()
            cleaned = checker.clean()
            after = checker.check()
            out[name] = [(asdict(r), r.summary(), r.clean)
                         for r in (before, cleaned, after)]
        finally:
            c.close()
    assert out["t"] == out["j"]
    before = out["t"][0][0]
    assert before["dangling_dentries"] and before["orphan_inodes"]
    assert before["nlink_drift"] and before["unreachable_dirs"]
    assert out["t"][1][0]["cleaned"] > 0


def test_authtool_decodes_same_as_reference(capsys, tmp_path):
    """One ticket minted by each package's authnode, decoded by both
    packages' authtool: the same JSON out, byte for byte."""
    import base64

    from chubaofs_tpu.authnode.server import AuthClient as JAuthClient
    from chubaofs_tpu.deploy import FsCluster as JFsCluster
    from chubaofs_tpu.tools.authtool import main as j_authtool
    from chubaofs_tpu_torch.authnode.server import AuthClient
    from chubaofs_tpu_torch.tools.authtool import main as t_authtool

    grants = []
    for name, make, client in (
            ("j", lambda r: JFsCluster(r, n_nodes=3, blob_nodes=0, data_nodes=0),
             JAuthClient),
            ("t", lambda r: FsCluster(r, n_nodes=3, blob_nodes=0, data_nodes=0,
                                      device="cpu"), AuthClient)):
        c = make(str(tmp_path / name))
        try:
            from chubaofs_tpu_torch.authnode import AUTH_GROUP

            c.settle(lambda: any(c.rafts[i].is_leader(AUTH_GROUP)
                                 for i in c.authnodes))
            auth = c.authnode()
            ckey = auth.create_key("cli1", "client", caps=["svc:*", "vol:read"])
            skey = auth.create_key("svc", "service")
            grant = client(auth, "cli1", ckey).get_ticket("svc")
            grants.append((grant["ticket"], base64.b64encode(skey).decode()))
        finally:
            c.close()
    for ticket, key in grants:
        outs = []
        for tool in (j_authtool, t_authtool):
            assert tool(["decode", ticket, key, "--service", "svc"]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
        assert '"client_id": "cli1"' in outs[1]
    # a wrong service key is refused the same way by both
    ticket, _ = grants[1]
    bad = base64.b64encode(b"\x01" * 32).decode()
    errs = []
    for tool in (j_authtool, t_authtool):
        with pytest.raises(Exception) as ei:
            tool(["decode", ticket, bad, "--service", "svc"])
        errs.append((type(ei.value).__name__, str(ei.value)))
    assert errs[0] == errs[1]


class _Fixture:
    """A fixed daemon: every side-door a console rolls up, serving constant
    bodies (the same bytes on every request)."""

    BODIES = {
        "/metrics": ("text/plain",
                     "# TYPE cfs_master_ops counter\n"
                     "cfs_master_ops{op=\"create\"} 41\n"
                     "# TYPE cfs_rpc_latency_seconds summary\n"
                     "cfs_rpc_latency_seconds_count 7\n"),
        "/health": {"status": "degraded", "reasons": ["put_p99"],
                    "slos": {"put_p99": {"status": "degraded", "value": 0.4}}},
        "/events": {"events": [
            {"seq": 3, "ts": 100.5, "type": "disk_status", "severity": "warning",
             "detail": {"disk": 7}},
            {"seq": 4, "ts": 101.0, "type": "slo_failing", "severity": "critical",
             "detail": {"slo": "put_p99"}}], "cursor": 4},
        "/alerts": {"alerts": [{"name": "put_p99", "state": "firing",
                                "labels": {"slo": "put_p99"}}], "firing": 1},
        "/slowops": {"slowops": [{"ts": "2026-01-01T00:00:01", "op": "write",
                                  "ms": 912}]},
        "/autopilot": {"enabled": True, "budget": {"remaining": 3, "per_hour": 6}},
        "/traces": {"trace_id": "t1", "spans": [
            {"span_id": "b", "start": 2.0, "name": "child"},
            {"span_id": "a", "start": 1.0, "name": "root"}]},
    }

    def __init__(self):
        import http.server
        import json
        import threading

        bodies = {}
        for path, body in self.BODIES.items():
            if isinstance(body, tuple):
                bodies[path] = (body[0], body[1].encode())
            else:
                bodies[path] = ("application/json", json.dumps(body).encode())

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                hit = bodies.get(self.path.split("?")[0])
                if hit is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", hit[0])
                self.send_header("Content-Length", str(len(hit[1])))
                self.end_headers()
                self.wfile.write(hit[1])

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_console_rollups_same_as_reference():
    """The reference's and the port's Console over one fixed daemon and one
    dead address: every rollup route answers the same bytes."""
    import urllib.error
    import urllib.request

    from chubaofs_tpu.console.server import Console as JConsole
    from chubaofs_tpu_torch.console.server import Console
    from chubaofs_tpu_torch.testing.harness import free_port

    fx = _Fixture()
    dead = f"127.0.0.1:{free_port()}"
    consoles = [JConsole([fx.addr], metrics_addrs=[dead]),
                Console([fx.addr], metrics_addrs=[dead])]
    try:
        for route in ("/api/metrics", "/api/health", "/api/events",
                      "/api/events?cursor=%7B%7D&n=1", "/api/alerts",
                      "/api/slowops", "/api/autopilot", "/api/trace?id=t1",
                      "/api/trace", "/api/events?cursor=notjson"):
            got = []
            for c in consoles:
                try:
                    resp = urllib.request.urlopen(
                        f"http://{c.addr}{route}", timeout=15)
                    got.append((resp.status, resp.read()))
                except urllib.error.HTTPError as e:
                    got.append((e.code, e.read()))
            assert got[0] == got[1], route
        health = got_health = urllib.request.urlopen(
            f"http://{consoles[1].addr}/api/health", timeout=15).read()
        assert b'"unreachable": ["' + dead.encode() in health, got_health
    finally:
        for c in consoles:
            c.stop()
        fx.close()
