"""The port's blobstore daemon held against the JAX package's, over HTTP.

Each package boots its own `cmd.start_role({"role": "blobstore", ...})` in
its own root (the JAX one on the CPU as its own tests run it, the port's
with "device": "cpu"), and the same seeded objects go through each one's
AccessClient: one EC(12,4) object, one of 1 MiB (EC(6,3)) and one of 100 KiB
(EC(3,3)). Placement, bid allocation and Location signing are deterministic
and GF(2^8) math is exact, so the two daemons must agree with tolerance 0 on
the Locations, the stored stripes, the GET bodies, every Range response
(status, Content-Range, body) and the key set of /admin/stat. Each
package's client also talks to the other's gateway.

The no-fallback cases: on a machine without a GPU the port's daemon refuses
to boot unless its config says "device": "cpu", and serves nothing.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from chubaofs_tpu.blobstore.gateway import AccessClient as JAccessClient
from chubaofs_tpu.cmd import start_role as j_start_role
from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.gateway import AccessClient
from chubaofs_tpu_torch.cmd import start_role
from chubaofs_tpu_torch.rpc.client import RPCClient

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# EC(12,4) above 1 MiB, EC(6,3) up to 1 MiB, EC(3,3) up to 128 KiB
SIZES = {"ec12p4": 1_500_000, "ec6p3": 1 << 20, "ec3p3": 100 << 10}


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


def _cfg(root, **extra):
    return {"role": "blobstore", "root": str(root), "nodes": 9,
            "disksPerNode": 2, "listen": "127.0.0.1:0", **extra}


@pytest.fixture
def daemons(tmp_path):
    j = j_start_role(_cfg(tmp_path / "jax"))
    try:
        t = start_role(_cfg(tmp_path / "port", device="cpu"))
    except BaseException:
        j.stop()
        raise
    yield j, t
    t.stop()
    j.stop()


def _objects():
    rng = np.random.default_rng(20261016)
    return {name: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for name, n in SIZES.items()}


def _stripes(daemon, loc) -> list[np.ndarray]:
    """Every shard of every blob of one object, read from the daemon's own
    blobnodes."""
    cluster = daemon.runner.handles["cluster"]
    out = []
    for b in loc.blobs:
        vol = cluster.cm.get_volume(b.vid)
        out.append(np.stack([
            np.frombuffer(cluster.nodes[u.node_id].get_shard(u.vuid, b.bid),
                          np.uint8) for u in vol.units]))
    return out


def _ranges(size: int) -> list[str]:
    return [f"bytes={size // 3}-{size // 3 + 4095}",  # 206
            "bytes=-777",                              # suffix 206
            f"bytes={size - 10}-",                     # open-ended 206
            f"bytes={size}-",                          # 416
            "pages=0-1"]                               # 400


def test_daemons_agree_byte_for_byte(daemons):
    j, t = daemons
    jc, tc = JAccessClient([j.addr]), AccessClient([t.addr])
    for name, data in _objects().items():
        jloc, tloc = jc.put(data), tc.put(data)
        assert tloc.to_json() == jloc.to_json(), name
        js, ts = _stripes(j, jloc), _stripes(t, tloc)
        assert len(js) == len(ts) >= 1
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b, a)  # tolerance 0
        assert tc.get(tloc) == jc.get(jloc) == data
        for rng in _ranges(len(data)):
            js_, jh, jb = jc.get_range(jloc, rng)
            ts_, th, tb = tc.get_range(tloc, rng)
            assert ts_ == js_, (name, rng)
            assert th.get("Content-Range") == jh.get("Content-Range"), rng
            assert tb == jb, (name, rng)
        statuses = [tc.get_range(tloc, r)[0] for r in _ranges(len(data))]
        assert statuses == [206, 206, 206, 416, 400]
    jstat = RPCClient([j.addr]).get("/admin/stat")
    tstat = RPCClient([t.addr]).get("/admin/stat")
    assert set(tstat) == set(jstat)
    assert tstat["disks"] == jstat["disks"] == 18


@pytest.mark.parametrize("direction", ["jax_client_port_gateway",
                                       "port_client_jax_gateway"])
def test_clients_cross_the_wire(daemons, direction):
    j, t = daemons
    client = (JAccessClient([t.addr]) if direction.startswith("jax")
              else AccessClient([j.addr]))
    for data in _objects().values():
        loc = client.put(data)
        assert client.get(loc) == data
        assert client.get(loc, 1000, 5000) == data[1000:6000]


def test_put_body_over_limit_is_refused_not_split(tmp_path):
    """A PUT body of MAX_BODY_BYTES + 1 is answered 413 before any of it is
    read, and nothing is stored: the gateway never splits it quietly."""
    import socket

    from chubaofs_tpu_torch.rpc.httpevloop import MAX_BODY_BYTES

    d = start_role(_cfg(tmp_path / "blob", device="cpu"))
    try:
        host, port = d.addr.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=30) as sk:
            sk.sendall(b"PUT /put HTTP/1.1\r\nHost: x\r\n"
                       b"Content-Length: %d\r\n\r\n" % (MAX_BODY_BYTES + 1))
            reply = sk.recv(4096)
        assert reply.startswith(b"HTTP/1.1 413")
        stat = RPCClient([d.addr]).get("/admin/stat")
        assert stat["volumes"] == 0  # no blob was allocated
    finally:
        d.stop()


def _skip_on_gpu_machine():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU: the case checks that the "
                    "daemon refuses to fall back to the host")


def _serving_threads() -> set[str]:
    return {th.name for th in threading.enumerate()
            if th.name.startswith(("evloop", "codec-svc", "blobstore-bg"))}


@pytest.mark.parametrize("device", [None, "cuda"])
def test_daemon_without_gpu_refuses_to_serve(tmp_path, device):
    _skip_on_gpu_machine()
    cfg = _cfg(tmp_path / "blob")
    if device is not None:
        cfg["device"] = device
    before = _serving_threads()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        start_role(cfg)
    assert _serving_threads() <= before  # nothing bound, nothing left running
    assert not os.path.exists(tmp_path / "blob")  # no cluster state written


def test_daemon_process_without_gpu_exits_without_boot_line(tmp_path):
    _skip_on_gpu_machine()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(_cfg(tmp_path / "blob")))
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-m", "chubaofs_tpu_torch.cmd", "-c", str(cfg)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""  # no {"role":..., "addr":...} boot line
    assert "no CUDA device" in proc.stderr


def test_unknown_role_names_the_valid_roles(tmp_path):
    # the console role is still unported; the six roles of the cluster are
    with pytest.raises(SystemExit, match=(
            r"unknown role 'console'; valid: \['authnode', 'blobstore', "
            r"'datanode', 'master', 'metanode', 'objectnode'\]")):
        start_role({"role": "console", "root": str(tmp_path)})
