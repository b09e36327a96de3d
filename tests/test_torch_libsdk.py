"""The cases of tests/test_libsdk.py against the port's daemons: the C
drivers of native/libsdk, unchanged, against a master, metanodes and
datanodes spawned as `python -m chubaofs_tpu_torch.cmd`. Every name and
assertion as in the reference. The daemons' configs carry no platform key:
these roles are host work. The cases run in tier-1 (the reference marks
its twins slow); each takes a few seconds once native/libsdk is built.

The reference file's docstring:

libcfs C ABI: build the native library, spin a real daemon cluster in
subprocesses, and run external Python-free drivers against it (libsdk/
analog). Two batteries:

  * cfs_smoke — basic open/write/read lifecycle (the reference's libsdk demo)
  * cfs_posix_soak — LTP-style metadata/IO soak (rename/link/truncate/readdir
    under pthread concurrency), the `runltp -f fs` analog of
    docker/script/run_test.sh:213-222.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
from chubaofs_tpu_torch import chaos as t_chaos


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBSDK = os.path.join(REPO, "native", "libsdk")


def _build(target: str):
    if shutil.which("make") is None:
        pytest.skip("no make")
    try:
        subprocess.run(["make", "-C", LIBSDK, f"build/{target}"],
                       check=True, capture_output=True, timeout=180)
    except (OSError, subprocess.SubprocessError) as e:
        pytest.skip(f"libcfs build unavailable: {e}")


def _spawn(cfg: dict, tmp, name: str, env):
    path = str(tmp / f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return subprocess.Popen(
        [sys.executable, "-m", "chubaofs_tpu_torch.cmd", "-c", path],
        stdout=open(str(tmp / f"{name}.log"), "w"),
        stderr=subprocess.STDOUT, env=env)


@contextlib.contextmanager
def _cluster(tmp_path, vol_name: str):
    """A real 1-master/3-metanode/3-datanode subprocess cluster + volume."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    procs = []
    try:
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            api_port = s.getsockname()[1]
        master_addr = f"127.0.0.1:{api_port}"
        procs.append(_spawn({
            "role": "master", "id": 1,
            "raftPeers": {"1": "127.0.0.1:0"},
            "listen": master_addr, "walDir": str(tmp_path / "m1"),
        }, tmp_path, "m1", env))
        time.sleep(0.8)
        for i in (2, 3, 4):
            procs.append(_spawn({
                "role": "metanode", "id": i, "masterAddrs": [master_addr],
                "walDir": str(tmp_path / f"mn{i}"),
            }, tmp_path, f"mn{i}", env))
        for j in (1, 2, 3):
            procs.append(_spawn({
                "role": "datanode", "id": 100 + j, "masterAddrs": [master_addr],
                "disks": [str(tmp_path / f"dn{j}" / "d0")],
                "walDir": str(tmp_path / f"dn{j}" / "wal"),
            }, tmp_path, f"dn{j}", env))

        from chubaofs_tpu_torch.master.api_service import MasterClient

        mc = MasterClient([master_addr])
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                if sum(1 for n in mc.get_cluster()["nodes"] if n["addr"]) >= 6:
                    break
            except Exception:
                pass
            time.sleep(0.3)
        else:
            raise AssertionError("cluster did not come up")
        mc.create_volume(vol_name, cold=False)

        driver_env = dict(env)
        driver_env["CFS_PYTHONPATH"] = REPO
        yield master_addr, driver_env
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()


def test_c_smoke_against_subprocess_cluster(tmp_path):
    _build("cfs_smoke")
    with _cluster(tmp_path, "libvol") as (master_addr, env):
        cfg = json.dumps({"masterAddr": master_addr, "volName": "libvol"})
        out = subprocess.run(
            [os.path.join(LIBSDK, "build", "cfs_smoke"), cfg],
            capture_output=True, timeout=120, env=env, text=True)
        assert out.returncode == 0, f"stdout={out.stdout} stderr={out.stderr}"
        assert "libcfs smoke ok" in out.stdout


def test_posix_soak_against_subprocess_cluster(tmp_path):
    """The external POSIX proof: a Python-free pthread process soaking
    create/pwrite/truncate/rename/link/unlink/readdir/rmdir against a real
    3-node cluster through libcfs.so (LTP `runltp -f fs` analog)."""
    _build("cfs_posix_soak")
    with _cluster(tmp_path, "soakvol") as (master_addr, env):
        cfg = json.dumps({"masterAddr": master_addr, "volName": "soakvol"})
        out = subprocess.run(
            [os.path.join(LIBSDK, "build", "cfs_posix_soak"), cfg, "4", "3"],
            capture_output=True, timeout=300, env=env, text=True)
        assert out.returncode == 0, f"stdout={out.stdout} stderr={out.stderr}"
        assert "posix soak ok: 4 threads x 3 iters" in out.stdout
