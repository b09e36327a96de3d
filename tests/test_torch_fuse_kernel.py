"""The cases of tests/test_fuse_kernel.py against the port's kernel FUSE
wire (client/fuse_ll.py) and its client role. Every name and assertion as
in the reference; the FsCluster is built with device="cpu", each mount sits
under its own temporary directory and is unmounted in the fixture's
teardown, and the client-role daemon is `python -m chubaofs_tpu_torch.cmd`.
Skips where /dev/fuse or the privilege to mount is absent, as the
reference does.

The reference file's docstring:

Kernel FUSE wire: unmodified external programs on a real mountpoint.

The reference's primary access protocol is a POSIX mount (client/fuse.go:470,
670 — bazil fs.Serve over /dev/fuse) exercised by the LTP fs suite
(docker/script/run_test.sh:213-222). Here the rebuilt wire (client/fuse_ll.py)
mounts an FsCluster hot volume through the real kernel VFS and the battery
runs via plain os.* syscalls and *subprocess* shell tools — no chubaofs code
in the accessing process. Skips where /dev/fuse or privilege is absent."""

import errno
import os
import subprocess

import pytest

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.client.fuse_ll import FuseServer, fuse_available
from chubaofs_tpu_torch.deploy import FsCluster

pytestmark = pytest.mark.skipif(
    not fuse_available(), reason="/dev/fuse unavailable or no privilege")


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


def _mounted(path: str) -> bool:
    with open("/proc/self/mounts") as f:
        return any(line.split()[1] == path for line in f)


@pytest.fixture(scope="module")
def mnt(tmp_path_factory):
    root = tmp_path_factory.mktemp("fusefs")
    cluster = FsCluster(str(root / "state"), n_nodes=3, blob_nodes=0,
                        data_nodes=4, device="cpu")
    cluster.create_volume("fusevol", cold=False)
    mp = root / "mnt"
    mp.mkdir()
    srv = FuseServer(cluster.client("fusevol"), str(mp), volume="fusevol",
                     audit_dir=str(root / "audit"))
    srv.mount()
    try:
        srv.serve_background()
        yield str(mp)
    finally:
        srv.unmount()
        cluster.close()
    assert not _mounted(str(mp))


def test_kernel_ops_reach_audit_trail(mnt, tmp_path_factory):
    """Kernel-mounted access is not invisible to the audit log (the Mount
    path's util/auditlog contract extends to the FUSE wire)."""
    import glob

    import time

    p = os.path.join(mnt, "audited.txt")
    open(p, "w").close()
    os.unlink(p)
    files = glob.glob(os.path.join(os.path.dirname(mnt), "audit", "*"))
    assert files, "no audit file written"
    text = ""
    for _ in range(50):  # audit writes are batched/flushed asynchronously
        text = open(files[0]).read()
        if "create" in text and "unlink" in text:
            break
        time.sleep(0.1)
    assert "create" in text and "unlink" in text, text


def test_mount_disables_vfork_subprocess(mnt):
    """A process hosting an in-process kernel mount must not use CPython's
    vfork subprocess fast path: vfork suspends the forking thread with the
    GIL held until the child execs, and a child touching this very mount
    (chdir to a cwd under it, FLUSH from closing an inherited fd) then
    waits on the mount's Python daemon thread — which waits on that GIL.
    Every shell-tool test in this file forks with cwd on the mount, so a
    regression here deadlocks the whole suite (observed live: parent in
    kernel_clone, child in request_wait_answer, 66 threads on the futex)."""
    import subprocess

    assert getattr(subprocess, "_USE_VFORK", False) is False


def test_create_write_read_roundtrip(mnt):
    p = os.path.join(mnt, "hello.txt")
    with open(p, "wb") as f:
        f.write(b"hello kernel wire")
    with open(p, "rb") as f:
        assert f.read() == b"hello kernel wire"
    st = os.stat(p)
    assert st.st_size == 17 and not os.path.isdir(p)


def test_large_file_random_access(mnt):
    payload = os.urandom(1_000_000)
    p = os.path.join(mnt, "big.bin")
    with open(p, "wb") as f:
        f.write(payload)
    assert os.stat(p).st_size == len(payload)
    with open(p, "rb") as f:
        f.seek(700_000)
        assert f.read(1024) == payload[700_000:701_024]
    # random overwrite through the kernel page path
    with open(p, "r+b") as f:
        f.seek(12345)
        f.write(b"OVERWRITTEN")
    with open(p, "rb") as f:
        f.seek(12345)
        assert f.read(11) == b"OVERWRITTEN"


def test_mkdir_listdir_rename_unlink(mnt):
    d = os.path.join(mnt, "subdir")
    os.mkdir(d)
    assert "subdir" in os.listdir(mnt)
    p = os.path.join(d, "a.txt")
    with open(p, "w") as f:
        f.write("x")
    os.rename(p, os.path.join(d, "b.txt"))
    assert os.listdir(d) == ["b.txt"]
    os.unlink(os.path.join(d, "b.txt"))
    assert os.listdir(d) == []
    os.rmdir(d)
    assert "subdir" not in os.listdir(mnt)


def test_errors_surface_as_errno(mnt):
    with pytest.raises(FileNotFoundError):
        open(os.path.join(mnt, "missing"), "rb")
    p = os.path.join(mnt, "excl")
    open(p, "x").close()
    with pytest.raises(FileExistsError):
        open(p, "x")
    with pytest.raises(OSError) as ei:
        os.rmdir(p)  # not a directory
    assert ei.value.errno == errno.ENOTDIR


def test_rename_over_existing(mnt):
    """POSIX rename(2) replace semantics through the kernel: mv over an
    existing file (editors' atomic-save) must succeed, and a displaced
    inode held open stays readable until its last close (same orphan
    contract as unlink)."""
    a, b = os.path.join(mnt, "ro_a.txt"), os.path.join(mnt, "ro_b.txt")
    with open(a, "wb") as f:
        f.write(b"new content")
    with open(b, "wb") as f:
        f.write(b"old content")
    held = open(b, "rb")  # displaced-while-open
    os.rename(a, b)  # must NOT raise EEXIST
    assert open(b, "rb").read() == b"new content"
    assert not os.path.exists(a)
    assert held.read() == b"old content"  # orphan stays readable
    held.close()
    os.unlink(b)


def test_rename_over_via_mv_tool(mnt):
    """The unmodified coreutils path: `mv` onto an existing target."""
    r = subprocess.run("echo newer > mv_a && echo older > mv_b && "
                       "mv mv_a mv_b && cat mv_b",
                       shell=True, capture_output=True, text=True, cwd=mnt)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "newer"


def test_rename_over_directory(mnt):
    d1, d2 = os.path.join(mnt, "rod_1"), os.path.join(mnt, "rod_2")
    os.mkdir(d1)
    os.mkdir(d2)
    os.rename(d1, d2)  # empty dir over empty dir: allowed
    assert os.path.isdir(d2) and not os.path.exists(d1)
    os.mkdir(d1)
    with open(os.path.join(d2, "child"), "w") as f:
        f.write("x")
    with pytest.raises(OSError) as ei:
        os.rename(d1, d2)  # dir over NON-EMPTY dir
    assert ei.value.errno in (errno.ENOTEMPTY, errno.EEXIST)


def test_unlinked_open_file_stays_readable(mnt):
    """The orphan-inode contract through the real kernel."""
    p = os.path.join(mnt, "orphan.txt")
    with open(p, "wb") as f:
        f.write(b"ghost data")
    f = open(p, "rb")
    os.unlink(p)
    assert not os.path.exists(p)
    assert f.read() == b"ghost data"
    f.close()


def test_append_truncate_chmod(mnt):
    p = os.path.join(mnt, "app.log")
    with open(p, "ab") as f:
        f.write(b"one\n")
    with open(p, "ab") as f:
        f.write(b"two\n")
    assert open(p, "rb").read() == b"one\ntwo\n"
    os.truncate(p, 4)
    assert open(p, "rb").read() == b"one\n"
    os.chmod(p, 0o600)
    assert (os.stat(p).st_mode & 0o7777) == 0o600


def test_hardlink_nlink(mnt):
    a = os.path.join(mnt, "ln_a")
    b = os.path.join(mnt, "ln_b")
    with open(a, "wb") as f:
        f.write(b"linked")
    os.link(a, b)
    assert os.stat(a).st_ino == os.stat(b).st_ino
    assert os.stat(a).st_nlink == 2
    os.unlink(a)
    assert open(b, "rb").read() == b"linked"


def test_xattr_via_syscalls(mnt):
    p = os.path.join(mnt, "x.txt")
    open(p, "w").close()
    os.setxattr(p, "user.tag", b"\x00\xffbin")
    assert os.getxattr(p, "user.tag") == b"\x00\xffbin"
    assert "user.tag" in os.listxattr(p)
    os.removexattr(p, "user.tag")
    assert "user.tag" not in os.listxattr(p)


def test_external_programs_shell_tools(mnt):
    """No chubaofs code in the accessing processes: cp/cat/mv/dd/ls."""
    run = lambda cmd: subprocess.run(cmd, shell=True, capture_output=True,
                                     text=True, cwd=mnt)
    r = run("echo external > ext.txt && cp ext.txt ext2.txt && cat ext2.txt")
    assert r.returncode == 0 and r.stdout.strip() == "external"
    r = run("dd if=/dev/zero of=zeros.bin bs=4096 count=32 2>/dev/null"
            " && wc -c < zeros.bin")
    assert r.returncode == 0 and r.stdout.strip() == str(4096 * 32)
    r = run("mkdir -p deep/tree && mv ext.txt deep/tree/ && ls deep/tree")
    assert r.returncode == 0 and r.stdout.strip() == "ext.txt"
    r = run("ls -la && df . > /dev/null")
    assert r.returncode == 0


def test_client_role_daemon_mounts_proccluster_volume(tmp_path):
    """The full deployment shape: a `role: client` DAEMON SUBPROCESS
    kernel-mounts a volume of a real subprocess cluster (ProcCluster), and
    this process reads/writes it with plain syscalls — every hop (VFS ->
    client daemon -> metanode/datanode daemons) crosses a process boundary,
    like the reference's cfs-client against a docker cluster."""
    import json
    import sys
    import time

    from chubaofs_tpu_torch.testing.harness import ProcCluster

    c = ProcCluster(str(tmp_path / "state"), masters=1, metanodes=3,
                    datanodes=3)
    client = None
    try:
        c.client_master().create_volume("kvol", cold=False)
        mp = tmp_path / "mnt"
        mp.mkdir()
        cfg = {"role": "client", "mountPoint": str(mp), "volName": "kvol",
               "masterAddrs": c.master_addrs}
        cfgp = tmp_path / "client.json"
        cfgp.write_text(json.dumps(cfg))
        client = subprocess.Popen(
            [sys.executable, "-m", "chubaofs_tpu_torch.cmd", "-c", str(cfgp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=c.env)
        line = client.stdout.readline().decode()  # boot JSON = mounted
        assert '"role": "client"' in line, line
        p = mp / "through_daemons.txt"
        p.write_bytes(b"kernel -> client daemon -> cluster daemons")
        assert p.read_bytes() == b"kernel -> client daemon -> cluster daemons"
        (mp / "d").mkdir()
        os.rename(str(p), str(mp / "d" / "moved.txt"))
        assert (mp / "d" / "moved.txt").read_bytes().startswith(b"kernel")
    finally:
        if client is not None:
            client.terminate()
            try:
                client.wait(timeout=10)
            except subprocess.TimeoutExpired:
                client.kill()
        c.close()


def test_fsx_style_random_soak_subprocess(mnt):
    """fsx-analog (the LTP suite's adversarial cousin): a SEPARATE
    interpreter runs seeded random op sequences — pwrite at random
    offsets, truncate up/down, reopen, rename, hardlink, unlink —
    against the kernel mount while mirroring every op on an in-memory
    shadow; any divergence (content or size) fails. No chubaofs imports
    in the accessing process."""
    script = r"""
import os, random, sys
mnt, seed = sys.argv[1], int(sys.argv[2])
rnd = random.Random(seed)
path = os.path.join(mnt, f"fsx_{seed}.dat")
shadow = bytearray()
fd = os.open(path, os.O_CREAT | os.O_RDWR)
MAXLEN = 300_000
for step in range(120):
    op = rnd.choice(["write", "write", "write", "read", "truncate",
                     "reopen", "rename", "rename_over", "link_cycle"])
    if op == "write":
        off = rnd.randrange(0, max(1, len(shadow) + 1))
        n = rnd.randrange(1, 40_000)
        if off + n > MAXLEN:
            n = max(1, MAXLEN - off)
        blob = bytes(rnd.getrandbits(8) for _ in range(min(n, 4096))) * (n // min(n, 4096) + 1)
        blob = blob[:n]
        os.pwrite(fd, blob, off)
        if off > len(shadow):
            shadow.extend(b"\0" * (off - len(shadow)))
        shadow[off:off + n] = blob
    elif op == "read":
        if shadow:
            off = rnd.randrange(0, len(shadow))
            n = rnd.randrange(1, len(shadow) - off + 1)
            got = os.pread(fd, n, off)
            want = bytes(shadow[off:off + n])
            assert got == want, f"step {step}: read mismatch at {off}+{n}"
    elif op == "truncate":
        n = rnd.randrange(0, MAXLEN)
        os.ftruncate(fd, n)
        if n <= len(shadow):
            del shadow[n:]
        else:
            shadow.extend(b"\0" * (n - len(shadow)))
    elif op == "reopen":
        os.close(fd)
        fd = os.open(path, os.O_RDWR)
    elif op == "rename":
        os.close(fd)
        a = os.path.join(mnt, f"fsx_{seed}.dat")
        b = os.path.join(mnt, f"fsx_{seed}_r.dat")
        new = b if path == a else a  # alternate, never a self-rename
        os.rename(path, new)
        path = new
        fd = os.open(path, os.O_RDWR)
    elif op == "rename_over":
        # POSIX replace: rename ONTO an existing victim file; content and
        # size must ride with the renamed inode, the victim must vanish.
        # Alternate targets so the victim is never the live file itself.
        os.close(fd)
        a = os.path.join(mnt, f"fsx_{seed}.dat")
        b = os.path.join(mnt, f"fsx_{seed}_v.dat")
        victim = b if path == a else a
        with open(victim, "wb") as g:
            g.write(b"victim-%d" % step)
        os.rename(path, victim)
        path = victim
        fd = os.open(path, os.O_RDWR)
    elif op == "link_cycle":
        lnk = path + ".lnk"
        os.link(path, lnk)
        assert os.stat(lnk).st_size == os.stat(path).st_size
        os.unlink(lnk)
    # invariant every step: size agrees with the shadow
    assert os.fstat(fd).st_size == len(shadow), f"step {step}: size drift"
# final full-content check through a FRESH descriptor
os.close(fd)
with open(path, "rb") as f:
    assert f.read() == bytes(shadow), "final content mismatch"
os.unlink(path)
print("FSX-OK")
"""
    import sys
    for seed in (11, 12):
        r = subprocess.run([sys.executable, "-c", script, mnt, str(seed)],
                           capture_output=True, text=True, timeout=300,
                           env={"PATH": os.environ.get("PATH", "")})
        assert r.returncode == 0, f"seed {seed}: {r.stderr[-2000:]}"
        assert "FSX-OK" in r.stdout


def test_posix_battery_subprocess(mnt):
    """A python-driven mini-LTP in a SEPARATE interpreter (no repo imports):
    sequences of syscalls an fs test suite leans on."""
    script = r"""
import os, sys, errno
mnt = sys.argv[1]
os.chdir(mnt)
# nested dirs + rename across directories
os.makedirs("a/b/c")
open("a/b/c/f.txt", "w").write("payload")
os.rename("a/b/c/f.txt", "a/f.txt")
assert open("a/f.txt").read() == "payload"
# seek/tell/pread semantics
fd = os.open("a/f.txt", os.O_RDONLY)
assert os.pread(fd, 4, 3) == b"load"
os.close(fd)
# O_APPEND honored across opens
fd = os.open("app", os.O_CREAT | os.O_WRONLY | os.O_APPEND)
os.write(fd, b"1"); os.close(fd)
fd = os.open("app", os.O_WRONLY | os.O_APPEND)
os.write(fd, b"2"); os.close(fd)
assert open("app").read() == "12"
# ENOTEMPTY
try:
    os.rmdir("a"); raise SystemExit("rmdir of non-empty dir succeeded")
except OSError as e:
    assert e.errno in (errno.ENOTEMPTY, errno.EEXIST), e
print("BATTERY-OK")
"""
    import sys
    r = subprocess.run([sys.executable, "-c", script, mnt],
                       capture_output=True, text=True,
                       env={"PATH": os.environ.get("PATH", "")})
    assert r.returncode == 0, r.stderr
    assert "BATTERY-OK" in r.stdout
