"""Subprocess cluster harness — the docker-compose bring-up as a library.

Reference counterpart: docker/docker-compose.yml + docker/run_docker.sh
(3 masters, 4 metanodes, 4 datanodes, objectnode, console; SURVEY §4) and
blobstore/testing's reusable fixtures. This spins the same topology as REAL
OS processes via the cmd entry (`python -m chubaofs_tpu_torch.cmd`), waits for
registration, and hands back typed clients. Every control and data path
crosses real sockets and process boundaries.

The device lives in the blobstore daemon alone: `device=` names its codec
device (None: the CUDA device, "cpu": the host), and every other role runs
on the host. On a host without a GPU a blobstore daemon left on the CUDA
device refuses to boot; the harness then raises at once, quoting the
daemon's log, and reaps every daemon it spawned.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ProcCluster:
    """A full cluster of daemon subprocesses."""

    @classmethod
    def shell(cls, root: str, env: dict | None = None,
              device: str | None = None) -> "ProcCluster":
        """An empty harness (spawn/await/close machinery, no daemons) for
        tests that compose their own role mix. `device` is the blobstore
        daemon's codec device: None leaves its config's "device" key out
        (the CUDA device), "cpu" runs the codec on the host."""
        self = cls.__new__(cls)
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = REPO + os.pathsep + self.env.get("PYTHONPATH", "")
        self.env.update(env or {})
        self.device = device
        self.procs = {}
        return self

    def __init__(self, root: str, masters: int = 3, metanodes: int = 3,
                 datanodes: int = 3, blobstore: bool = False,
                 objectnode: bool = False, env: dict | None = None,
                 master_extra: dict | None = None,
                 device: str | None = None):
        shell = ProcCluster.shell(root, env, device)
        self.root = shell.root
        self.env = shell.env
        self.device = shell.device
        self.procs: dict[str, subprocess.Popen] = shell.procs
        try:
            self._boot(masters, metanodes, datanodes, blobstore, objectnode,
                       master_extra)
        except BaseException:
            # partial boot must not orphan daemons: the constructor is also an
            # OPERATOR entry (tools/localcluster), and a leader-election or
            # port-bind failure here would otherwise leak every spawned proc
            self.close()
            raise

    def _boot(self, masters, metanodes, datanodes, blobstore, objectnode,
              master_extra):
        root = self.root
        # masters need static raft + api ports so peers can dial each other
        raft_ports = {i: free_port() for i in range(1, masters + 1)}
        api_ports = {i: free_port() for i in range(1, masters + 1)}
        raft_peers = {str(i): f"127.0.0.1:{raft_ports[i]}" for i in raft_ports}
        peer_apis = {str(i): f"127.0.0.1:{api_ports[i]}" for i in api_ports}
        self.master_addrs = list(peer_apis.values())
        for i in range(1, masters + 1):
            self.spawn(f"master{i}", {
                "role": "master", "id": i, "raftPeers": raft_peers,
                "peerApis": peer_apis, "listen": peer_apis[str(i)],
                "walDir": os.path.join(root, f"m{i}"),
                **(master_extra or {}),
            })
        self._await_leader()

        # the blobstore goes first so metanode configs carry the access
        # address (their orphan-purge hook needs it for cold extents)
        self.access_addr = None
        if blobstore:
            port = free_port()
            self.access_addr = f"127.0.0.1:{port}"
            self.spawn("blobstore", self.blobstore_cfg())

        meta_base = masters + 1
        for k in range(metanodes):
            i = meta_base + k
            self.spawn(f"metanode{i}", self.metanode_cfg(i))
        data_base = 100
        for k in range(datanodes):
            i = data_base + 1 + k
            self.spawn(f"datanode{i}", self.datanode_cfg(i))
        self.s3_addr = None
        if objectnode:
            port = free_port()
            self.s3_addr = f"127.0.0.1:{port}"
            cfg = {"role": "objectnode", "masterAddrs": self.master_addrs,
                   "listen": self.s3_addr}
            if self.access_addr:
                cfg["accessAddrs"] = [self.access_addr]
            self.spawn("objectnode", cfg)

        self.await_nodes(metanodes + datanodes)
        # blobstore/objectnode bind after slow imports; wait for the sockets
        for name, addr in (("blobstore", self.access_addr),
                           ("objectnode", self.s3_addr)):
            if addr:
                self._await_listen(addr, name=name)

    # -- process management ----------------------------------------------------

    def blobstore_cfg(self) -> dict:
        cfg = {"role": "blobstore", "root": os.path.join(self.root, "blob"),
               "listen": self.access_addr, "nodes": 6, "disksPerNode": 2}
        if self.device is not None:
            cfg["device"] = self.device
        return cfg

    def metanode_cfg(self, i: int) -> dict:
        cfg = {"role": "metanode", "id": i, "masterAddrs": self.master_addrs,
               "walDir": os.path.join(self.root, f"mn{i}")}
        if self.access_addr:
            cfg["accessAddrs"] = [self.access_addr]
        return cfg

    def datanode_cfg(self, i: int) -> dict:
        return {"role": "datanode", "id": i, "masterAddrs": self.master_addrs,
                "disks": [os.path.join(self.root, f"dn{i}", "d0"),
                          os.path.join(self.root, f"dn{i}", "d1")],
                "walDir": os.path.join(self.root, f"dn{i}", "wal")}

    def spawn(self, name: str, cfg: dict) -> subprocess.Popen:
        path = os.path.join(self.root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        log = open(os.path.join(self.root, f"{name}.log"), "w")
        p = subprocess.Popen(
            [sys.executable, "-m", "chubaofs_tpu_torch.cmd", "-c", path],
            stdout=log, stderr=subprocess.STDOUT, env=self.env)
        self.procs[name] = p
        return p

    def kill(self, name: str, sig=None) -> None:
        """SIGKILL (default) a daemon — the fault-injection hammer."""
        import signal as _signal

        p = self.procs.pop(name, None)
        if p is None:
            return
        p.send_signal(sig or _signal.SIGKILL)
        p.wait(timeout=10)

    def close(self):
        for p in self.procs.values():
            p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
        self.procs.clear()

    # -- boot-line introspection ----------------------------------------------

    def boot_info(self, name: str, timeout: float = 60.0) -> dict:
        """The daemon's boot JSON line, parsed off its captured stdout log
        (cmd.main prints it as the stdout protocol). This is how a harness
        learns ephemeral side-door ports (statsListen's /metrics address).
        stderr shares the log file, so scan for the first line that parses
        as the boot record rather than trusting line one."""
        path = os.path.join(self.root, f"{name}.log")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if not line.startswith("{"):
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if isinstance(rec, dict) and "role" in rec:
                            return rec
            except OSError:
                pass
            time.sleep(0.1)
        raise TimeoutError(f"{name} printed no boot line")

    def stats_addrs(self, timeout: float = 60.0) -> list[str]:
        """Every running metanode/datanode/objectnode's /metrics side-door
        address — the extra scrape targets a console rollup needs beyond
        the masters and the blobstore gateway. The objectnode side-door is
        where the QoS plane's per-tenant metrics and throttle SLOs live
        (its PUBLIC listener mounts no /metrics: an S3 bucket named
        "metrics" must stay routable), so `cfs-capacity --s3`'s gate
        cannot see fairness without it."""
        out = []
        for name in list(self.procs):
            if not name.startswith(("metanode", "datanode", "objectnode")):
                continue
            addr = self.boot_info(name, timeout=timeout).get("stats_addr")
            if addr:
                out.append(addr)
        return out

    def spawn_console(self, metrics_addrs: list[str] | None = None,
                      timeout: float = 60.0) -> str:
        """Spawn a console daemon over this cluster's masters (plus any
        extra /metrics targets) and return its address once it listens."""
        addr = f"127.0.0.1:{free_port()}"
        self.spawn("console", {
            "role": "console", "masterAddrs": self.master_addrs,
            "listen": addr, "metricsAddrs": list(metrics_addrs or []),
        })
        self._await_listen(addr, name="console", timeout=timeout)
        return addr

    # -- cluster waiting -------------------------------------------------------

    def client_master(self):
        from chubaofs_tpu_torch.master.api_service import MasterClient

        return MasterClient(self.master_addrs)

    def _await_leader(self, timeout: float = 30.0):
        mc = self.client_master()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if mc.get_cluster()["leader_id"] is not None:
                    return
            except Exception:
                pass
            time.sleep(0.25)
        raise TimeoutError("no master leader elected")

    def _await_listen(self, addr: str, name: str, timeout: float = 120.0):
        """Wait for daemon `name` to listen on `addr`. A daemon that exits
        before it listens (a blobstore with no CUDA device) fails the wait
        at once, quoting the tail of its log."""
        host, port = addr.rsplit(":", 1)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            proc = self.procs.get(name)
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(
                    f"{name} daemon exited with code {proc.returncode} "
                    f"before listening on {addr}:\n{self.log_tail(name)}")
            try:
                with socket.create_connection((host, int(port)), timeout=2):
                    return
            except OSError:
                time.sleep(0.25)
        raise TimeoutError(f"{name} at {addr} never started listening")

    def log_tail(self, name: str, lines: int = 20) -> str:
        try:
            with open(os.path.join(self.root, f"{name}.log")) as f:
                return "".join(f.readlines()[-lines:])
        except OSError:
            return ""

    def await_nodes(self, count: int, timeout: float = 30.0):
        mc = self.client_master()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                nodes = mc.get_cluster()["nodes"]
                if sum(1 for n in nodes if n["addr"]) >= count:
                    return
            except Exception:
                pass
            time.sleep(0.25)
        raise TimeoutError(f"{count} nodes did not register")

    def remote(self):
        from chubaofs_tpu_torch.sdk.cluster import RemoteCluster

        access = [self.access_addr] if self.access_addr else None
        return RemoteCluster(self.master_addrs, access_addrs=access)

    def fs(self, volume: str):
        return self.remote().client(volume)
