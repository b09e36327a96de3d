"""The cases of tests/test_e2e.py against the port's daemons: every role
spawned as `python -m chubaofs_tpu_torch.cmd`, the Mount, S3 and the
master API from chubaofs_tpu_torch, the blobstore daemon on device="cpu".
Every name and assertion as in the reference. The whole file is `slow`, as
the reference is, so tier-1 does not run it; run it with
`python -m pytest tests/test_torch_e2e.py -m slow`.

The reference file's docstring:

End-to-end suite over REAL subprocess daemons (docker/run_docker.sh
-run_test analog): POSIX semantics battery (the LTP `fs` group's shape),
multi-master failover, node-kill recovery, and the S3 flow."""

import time

import pytest

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.client.mount import (
    Mount,
    MountError,
    O_APPEND,
    O_CREAT,
    O_RDONLY,
    O_RDWR,
    O_TRUNC,
    O_WRONLY,
)
from chubaofs_tpu_torch.sdk.fs import FsError
from chubaofs_tpu_torch.testing.harness import ProcCluster

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = ProcCluster(str(tmp_path_factory.mktemp("e2e")), masters=3,
                    metanodes=3, datanodes=3)
    c.client_master().create_volume("posix", cold=False)
    yield c
    c.close()


# -- LTP-style POSIX battery ---------------------------------------------------


def test_posix_battery(cluster):
    """The `runltp -f fs` analog: one pass of the POSIX semantics the
    reference validates on a real mount (docker/script/run_test.sh:213-222)."""
    mnt = Mount(cluster.fs("posix"), volume="posix")

    # creat01/open01: create, write, reopen, read
    fd = mnt.open("/f1", O_CREAT | O_RDWR)
    assert mnt.write(fd, b"alpha") == 5
    mnt.close(fd)
    fd = mnt.open("/f1", O_RDONLY)
    assert mnt.read(fd, 100) == b"alpha"
    mnt.close(fd)

    # open with O_CREAT on existing file keeps content; O_TRUNC empties
    fd = mnt.open("/f1", O_CREAT | O_RDONLY)
    assert mnt.read(fd, 100) == b"alpha"
    mnt.close(fd)
    fd = mnt.open("/f1", O_WRONLY | O_TRUNC)
    mnt.close(fd)
    assert mnt.stat("/f1")["size"] == 0

    # mkdir01/rmdir01: nested dirs, ENOTEMPTY, ENOENT
    mnt.mkdir("/d1")
    mnt.mkdir("/d1/d2")
    with pytest.raises(FsError) as e:
        mnt.rmdir("/d1")
    assert e.value.code == "ENOTEMPTY"
    mnt.rmdir("/d1/d2")
    mnt.rmdir("/d1")
    with pytest.raises(FsError) as e:
        mnt.readdir("/d1")
    assert e.value.code == "ENOENT"

    # rename01: file rename replaces path, ENOENT on old
    fd = mnt.open("/r1", O_CREAT | O_WRONLY)
    mnt.write(fd, b"rename me")
    mnt.close(fd)
    mnt.rename("/r1", "/r2")
    with pytest.raises(FsError):
        mnt.stat("/r1")
    fd = mnt.open("/r2", O_RDONLY)
    assert mnt.read(fd, 100) == b"rename me"
    mnt.close(fd)

    # link01: hardlink shares the inode; nlink tracks
    mnt.link("/r2", "/r2-link")
    st = mnt.stat("/r2")
    assert st["nlink"] == 2
    assert mnt.stat("/r2-link")["ino"] == st["ino"]
    mnt.unlink("/r2")
    time.sleep(1.1)  # attr cache TTL
    assert mnt.stat("/r2-link")["nlink"] == 1

    # unlink07: open fd survives unlink (orphan list)
    fd = mnt.open("/orph", O_CREAT | O_RDWR)
    mnt.write(fd, b"still readable")
    mnt.unlink("/orph")
    mnt.lseek(fd, 0)
    assert mnt.read(fd, 100) == b"still readable"
    mnt.close(fd)

    # truncate01: shrink + re-extend
    fd = mnt.open("/t1", O_CREAT | O_WRONLY)
    mnt.write(fd, b"0123456789")
    mnt.close(fd)
    mnt.truncate("/t1", 4)
    fd = mnt.open("/t1", O_RDONLY)
    assert mnt.read(fd, 100) == b"0123"
    mnt.close(fd)

    # append mode
    fd = mnt.open("/t1", O_WRONLY | O_APPEND)
    mnt.write(fd, b"XY")
    mnt.close(fd)
    fd = mnt.open("/t1", O_RDONLY)
    assert mnt.read(fd, 100) == b"0123XY"
    mnt.close(fd)

    # xattr (setfattr/getfattr/listfattr/removefattr shape)
    mnt.setxattr("/t1", "user.tag", b"v1")
    assert mnt.getxattr("/t1", "user.tag") == b"v1"
    assert "user.tag" in mnt.listxattr("/t1")
    mnt.removexattr("/t1", "user.tag")
    assert "user.tag" not in mnt.listxattr("/t1")

    # EBADF discipline
    fd = mnt.open("/t1", O_RDONLY)
    mnt.close(fd)
    with pytest.raises(MountError):
        mnt.read(fd, 1)
    mnt.umount()


def test_large_file_random_overwrite(cluster):
    """growfiles analog: interleaved extends + in-place overwrites."""
    import os as _os

    fs = cluster.fs("posix")
    blob = _os.urandom(600_000)
    fs.write_file("/big.bin", blob)
    expected = bytearray(blob)
    patch = _os.urandom(10_000)
    fs.write_at(fs.resolve("/big.bin"), 123_456, patch)
    expected[123_456:123_456 + len(patch)] = patch
    assert fs.read_file("/big.bin") == bytes(expected)


# -- failover ------------------------------------------------------------------


def test_master_failover(cluster):
    """Kill the master leader; a new leader serves admin + client paths."""
    mc = cluster.client_master()
    before = mc.get_cluster()
    leader_id = before["leader_id"]
    cluster.kill(f"master{leader_id}")

    deadline = time.time() + 30
    new_leader = None
    mc2 = cluster.client_master()
    while time.time() < deadline:
        try:
            mc2.leader_hint = None
            info = mc2.get_cluster()
            if info["leader_id"] is not None and info["leader_id"] != leader_id:
                new_leader = info["leader_id"]
                break
        except Exception:
            pass
        time.sleep(0.5)
    assert new_leader is not None, "no new master leader after kill"

    # the surviving quorum serves volume creation + io end-to-end
    mc2.create_volume("postfail", cold=False)
    fs = cluster.fs("postfail")
    fs.write_file("/after-failover.txt", b"quorum survived")
    assert fs.read_file("/after-failover.txt") == b"quorum survived"


def test_metanode_kill_and_replace(cluster):
    """SIGKILL a metanode; a fresh daemon with the same id + walDir rejoins
    and the namespace replays (partition_store + self-healing sweep)."""
    fs = cluster.fs("posix")
    fs.write_file("/durable.txt", b"survives SIGKILL")

    victim = next(n for n in cluster.procs if n.startswith("metanode"))
    vid = int(victim.removeprefix("metanode"))
    cluster.kill(victim)
    time.sleep(1)
    cluster.spawn(victim, cluster.metanode_cfg(vid))

    deadline = time.time() + 40
    while time.time() < deadline:
        try:
            if cluster.fs("posix").read_file("/durable.txt") == b"survives SIGKILL":
                break
        except Exception:
            pass
        time.sleep(0.5)
    else:
        raise AssertionError("namespace did not recover after metanode kill")


# -- S3 over subprocesses ------------------------------------------------------


@pytest.mark.slow
def test_s3_flow_over_daemons(tmp_path):
    import http.client

    from chubaofs_tpu_torch.objectnode.auth import sign_v4

    c = ProcCluster(str(tmp_path / "s3"), masters=1, metanodes=3, datanodes=0,
                    blobstore=True, objectnode=True, device="cpu")
    try:
        u = c.client_master().create_user("e2e")
        ak, sk = u["access_key"], u["secret_key"]

        def req(method, path, body=b"", raw_query=""):
            target = path + (f"?{raw_query}" if raw_query else "")
            hdrs = sign_v4(method, path, raw_query, {"host": c.s3_addr},
                           ak, sk, payload=body)
            conn = http.client.HTTPConnection(c.s3_addr, timeout=60)
            try:
                conn.request(method, target, body=body or None, headers=hdrs)
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()

        status, _ = req("PUT", "/e2ebkt")
        assert status == 200
        payload = b"S3 across processes " * 200
        status, _ = req("PUT", "/e2ebkt/dir/obj.bin", payload)
        assert status == 200
        status, body = req("GET", "/e2ebkt/dir/obj.bin")
        assert status == 200 and body == payload
        status, body = req("GET", "/e2ebkt", raw_query="list-type=2")
        assert status == 200 and b"dir/obj.bin" in body
        status, _ = req("DELETE", "/e2ebkt/dir/obj.bin")
        assert status in (200, 204)
        status, body = req("GET", "/e2ebkt/dir/obj.bin")
        assert status == 404
    finally:
        c.close()


def test_metanode_decommission_over_api(cluster):
    """Drain a metanode via the HTTP API: partitions re-home through raft
    membership changes and the namespace survives (decommission flow)."""
    mc = cluster.client_master()
    mc.create_volume("drain", cold=False)
    fs = cluster.fs("drain")
    fs.write_file("/survives-drain.txt", b"migrated by membership change")

    # draining needs spare capacity: bring up a replacement metanode first
    cluster.spawn("metanode9", cluster.metanode_cfg(9))
    deadline = time.time() + 30
    while time.time() < deadline:
        nodes = {n["node_id"]: n for n in mc.get_cluster()["nodes"]}
        if nodes.get(9, {}).get("addr"):
            break
        time.sleep(0.3)
    else:
        raise AssertionError("replacement metanode never registered")

    mps = mc.meta_partitions("drain")
    victim = mps[0]["peers"][0]
    out = mc.call(mc._path("/metaNode/decommission", id=victim))
    assert out["migrated"] >= 1

    for mp in mc.meta_partitions("drain"):
        assert victim not in mp["peers"] and len(mp["peers"]) == 3

    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            got = cluster.fs("drain").read_file("/survives-drain.txt")
            if got == b"migrated by membership change":
                break
        except Exception:
            pass
        time.sleep(0.5)
    else:
        raise AssertionError("namespace unreadable after decommission")
    cluster.fs("drain").write_file("/post-drain.txt", b"still writable")


def test_ticket_gated_cluster_over_daemons(tmp_path):
    """Full security composition in daemon mode: an authnode daemon mints the
    master's service key + per-role client credentials; the master enforces
    per-route capabilities; metanodes/datanodes register and heartbeat with
    node-capability credentials (renewing providers); an operator client with
    master:admin creates a volume; an uncredentialed client is denied."""
    import base64

    from chubaofs_tpu_torch.master.api_service import MasterClient, MasterError
    from chubaofs_tpu_torch.rpc.client import RPCClient
    from chubaofs_tpu_torch.testing.harness import ProcCluster, free_port

    root = str(tmp_path / "tg")

    # 1. authnode daemon
    auth_port = free_port()
    auth_addr = f"127.0.0.1:{auth_port}"
    shell = ProcCluster.shell(root)  # spawn machinery, own role mix
    shell.spawn("authnode", {
        "role": "authnode", "id": 1, "raftPeers": {"1": "127.0.0.1:0"},
        "listen": auth_addr, "walDir": root + "/an",
        "adminSecret": "adm1n"})
    shell._await_listen(auth_addr, name="authnode")

    admin_rpc = RPCClient([auth_addr], auth_secret=b"adm1n")
    deadline = time.time() + 15
    while True:  # single-node raft leader election
        try:
            svc = admin_rpc.post("/admin/createkey",
                                 {"id": "master", "role": "service"})
            break
        except Exception:
            if time.time() > deadline:
                raise
            time.sleep(0.3)
    node_cred = admin_rpc.post("/admin/createkey", {
        "id": "nodes", "role": "client", "caps": ["master:node"]})
    op_cred = admin_rpc.post("/admin/createkey", {
        "id": "operator", "role": "client", "caps": ["master:admin"]})

    # 2. gated master + credentialed metanodes/datanodes
    api_port = free_port()
    master_addr = f"127.0.0.1:{api_port}"
    node_auth = {"authAddrs": [auth_addr], "authClientId": "nodes",
                 "authClientKey": node_cred["key"]}
    shell.spawn("master", {
        "role": "master", "id": 1, "raftPeers": {"1": "127.0.0.1:0"},
        "listen": master_addr, "walDir": root + "/m1",
        "adminTicketKey": svc["key"]})
    shell._await_listen(master_addr, name="master")
    for i in (2, 3, 4):
        shell.spawn(f"mn{i}", {"role": "metanode", "id": i,
                               "masterAddrs": [master_addr],
                               "walDir": f"{root}/mn{i}", **node_auth})
    for j in (1, 2, 3):
        shell.spawn(f"dn{j}", {"role": "datanode", "id": 100 + j,
                               "masterAddrs": [master_addr],
                               "disks": [f"{root}/dn{j}/d0"],
                               "walDir": f"{root}/dn{j}/wal", **node_auth})
    try:
        # nodes registered + heartbeat through their node-capability tickets
        viewer = MasterClient([master_addr])  # reads stay open
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                if sum(1 for n in viewer.get_cluster()["nodes"]
                       if n["addr"]) >= 6:
                    break
            except Exception:
                pass
            time.sleep(0.3)
        else:
            raise AssertionError("credentialed nodes never registered")

        # no credential -> denied on admin mutations
        with pytest.raises(MasterError, match="ticket"):
            viewer.create_volume("deny-me")

        # the operator's renewing provider passes
        from chubaofs_tpu_torch.authnode.api import RemoteAuthNode
        from chubaofs_tpu_torch.authnode.server import AuthClient, RenewingTicket

        prov = RenewingTicket(
            AuthClient(RemoteAuthNode([auth_addr]), "operator",
                       base64.b64decode(op_cred["key"])), "master")
        op = MasterClient([master_addr], admin_ticket=prov)
        vol = op.create_volume("tgvol")
        assert vol["name"] == "tgvol"
        # node credentials can't do admin mutations (least privilege)
        node_prov = RenewingTicket(
            AuthClient(RemoteAuthNode([auth_addr]), "nodes",
                       base64.b64decode(node_cred["key"])), "master")
        with pytest.raises(MasterError, match="ticket"):
            MasterClient([master_addr],
                         admin_ticket=node_prov).delete_volume("tgvol")
    finally:
        shell.close()


def test_dead_datanode_auto_rehome_over_daemons(tmp_path):
    """SIGKILL a datanode and do NOT bring it back: the master's liveness +
    dead-node sweep re-homes its replicas onto the spare daemon without any
    operator action (scheduleToCheckDataReplicas analog, end to end), and the
    volume heals back to rw with the data still readable."""
    c = ProcCluster(str(tmp_path), masters=1, metanodes=3, datanodes=4,
                    master_extra={"deadNodeSecs": 3})
    try:
        mc = c.client_master()
        mc.create_volume("arh", cold=False)
        fs = c.fs("arh")
        fs.write_file("/precious.txt", b"survives the dead node")

        views = mc.data_partitions("arh")
        assert views, "no rw data partitions"
        victim_nid = views[0]["peers"][0]
        victim_name = f"datanode{victim_nid}"
        assert victim_name in c.procs
        c.kill(victim_name)

        # liveness (10 * HEARTBEAT) + deadNodeSecs + ensure tick; generous cap.
        # Success reads the FULL admin table, not the rw-only client view —
        # a stuck migration leaves the victim's partitions demoted+hidden,
        # which must fail this check, not slip past it.
        deadline = time.time() + 90
        rehomed = False
        while time.time() < deadline:
            try:
                dps = mc.get_volume("arh")["data_partitions"]
                if dps and all(victim_nid not in dp["peers"]
                               and len(dp["peers"]) == 3
                               and dp["status"] == "rw" for dp in dps):
                    rehomed = True
                    break
            except Exception:
                pass
            time.sleep(1)
        assert rehomed, f"replicas still on dead node {victim_nid}"

        # the re-homed volume serves reads AND writes
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                assert c.fs("arh").read_file("/precious.txt") == (
                    b"survives the dead node")
                c.fs("arh").write_file("/after.txt", b"rw again")
                break
            except Exception:
                time.sleep(1)
        else:
            raise AssertionError("volume not serving after re-home")
    finally:
        c.close()


def test_overlapping_mounts_consistency(cluster):
    """regression/overlapping analog (ref regression/overlapping/main.go:22-30):
    two mounts of one volume interleave writes+fsyncs over the SAME byte
    range; after each sync the other mount observes the writer's bytes, and
    the final layout reads identically through both mounts."""
    off = 1 * 1024 * 1024  # past the tiny-extent region, like the reference
    a = b"mount-one-payload-" * 64
    b_ = b"MOUNT-TWO-payload-" * 64
    L = len(a)
    assert len(b_) == L

    m1 = Mount(cluster.fs("posix"), volume="posix")
    m2 = Mount(cluster.fs("posix"), volume="posix")
    fd1 = m1.open("/overlap.bin", O_RDWR | O_CREAT)
    fd2 = m2.open("/overlap.bin", O_RDWR)

    # m1 writes A at off, syncs; m2 must see it
    m1.write(fd1, a, offset=off)
    m1.fsync(fd1)
    assert m2.read(fd2, L, offset=off) == a

    # m2 overwrites with B twice (off, off+L), syncs; m1 must see both
    m2.write(fd2, b_, offset=off)
    m2.write(fd2, b_, offset=off + L)
    m2.fsync(fd2)
    assert m1.read(fd1, L, offset=off) == b_
    assert m1.read(fd1, L, offset=off + L) == b_

    # m1 overwrites the second region back to A; final layout = [B, A]
    m1.write(fd1, a, offset=off + L)
    m1.fsync(fd1)
    for m, fd in ((m1, fd1), (m2, fd2)):
        assert m.read(fd, L, offset=off) == b_
        assert m.read(fd, L, offset=off + L) == a
    m1.close(fd1)
    m2.close(fd2)
