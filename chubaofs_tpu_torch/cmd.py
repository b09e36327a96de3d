"""Single-entry daemon with role dispatch — `python -m chubaofs_tpu_torch.cmd -c cfg.json`.

Reference counterpart: cmd/cmd.go:125-321 — one binary, a JSON config with a
`role` field, and a switch that boots the role's services; blobstore/cmd/
cmd.go's RegisterModule plays the same part for the blobstore services. Kept:
JSON config file, role dispatch, the boot line on stdout, graceful stop on
SIGTERM. Changed: no daemonize/fork — process supervision belongs to the
operator (systemd, docker, a test harness).

The port serves the blobstore role: the EC mini-cluster behind the access
HTTP gateway and its admin API, with the codec on the device that the
config's `"device"` key names (default: the CUDA device; with no GPU the
daemon refuses to start rather than run on the host). The master, metanode,
datanode, objectnode, authnode, console and client roles wait for their
planes (master/, meta/, data/, raft/, objectnode/, authnode/, console/,
client/).
"""

from __future__ import annotations

import json
import sys
import threading

from chubaofs_tpu_torch.rpc.server import RPCServer


def _addr_split(addr: str) -> tuple[str, int]:
    host, port = addr.rsplit(":", 1)
    return host, int(port)


def _advertise(addr: str, cfg: dict) -> str:
    """Rewrite a wildcard bind host into a peer-dialable address. Binding
    0.0.0.0 is how multi-host deployments listen; registering it verbatim
    would make every peer dial its own loopback. `advertiseHost` in config
    wins; otherwise the hostname's resolved address."""
    host, port = addr.rsplit(":", 1)
    if host not in ("0.0.0.0", "::", ""):
        return addr
    adv = cfg.get("advertiseHost")
    if not adv:
        import socket

        try:
            adv = socket.gethostbyname(socket.gethostname())
        except OSError:
            adv = "127.0.0.1"
    return f"{adv}:{port}"


def _log(daemon: str, msg: str) -> None:
    # stderr IS this process's log transport: supervisors and the harness
    # redirect it to the daemon's .log file, which log collectors tail
    print(f"[{daemon}] {msg}",  # obslint: stderr is the captured daemon log
          file=sys.stderr, flush=True)


def _stats_server(cfg: dict, module: str) -> RPCServer:
    """Tiny HTTP side-door for daemons whose primary wire is packet TCP
    (metanode, datanode): mounts /metrics (the process's whole registry set,
    role-namespaced) so EVERY role is scrapeable. `statsListen` in config;
    port 0 (default) binds an ephemeral port, "off" disables."""
    from chubaofs_tpu_torch.rpc.router import Router

    listen = cfg.get("statsListen", "127.0.0.1:0")
    if listen == "off":
        return None
    host, port = _addr_split(listen)
    return RPCServer(Router(), host=host, port=port, module=module).start()


def _space_report(paths) -> dict:
    """Disk usage of the daemon's data roots, reported with heartbeats into
    the master's statinfo rollup (ref scheduleToUpdateStatInfo source).

    Accepts one path or a list; filesystems are deduplicated by st_dev so two
    data dirs on one mount don't double-count. No paths -> no report ({})."""
    if not paths:
        return {}
    if isinstance(paths, str):
        paths = [paths]
    import os as _os
    import shutil

    total = used = 0
    seen: set[int] = set()
    for p in paths:
        try:
            dev = _os.stat(p).st_dev
            if dev in seen:
                continue
            du = shutil.disk_usage(p)
        except OSError:
            continue
        seen.add(dev)  # only after BOTH calls succeed: a stat-ok but
        # statvfs-failing mount must not turn the report into zeros
        total += du.total
        used += du.used
    return {"total_space": total, "used_space": used} if seen else {}


class _Daemon:
    """Common lifecycle: background threads registered for stop()."""

    def __init__(self):
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def _spawn(self, fn, name: str):
        t = threading.Thread(target=fn, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def _every(self, interval: float, fn, name: str):
        def loop():
            last_err = ""
            while not self._stop.wait(interval):
                try:
                    fn()
                    last_err = ""
                except Exception as e:
                    # sweeps never kill the daemon, but persistent faults must
                    # be visible — log each distinct error once
                    msg = f"{type(e).__name__}: {e}"
                    if msg != last_err:
                        _log(name, msg)
                        last_err = msg

        self._spawn(loop, name)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)


class BlobstoreDaemon(_Daemon):
    """Role blobstore: the whole EC mini-cluster + access HTTP gateway.

    The reference runs access/clustermgr/proxy/blobnode/scheduler as separate
    processes under blobstore/cmd; the rebuilt services compose in one daemon
    here (they already talk through interfaces), fronted by the gateway.

    The codec runs on `cfg["device"]`: absent means the CUDA device, and the
    daemon raises at boot when there is none; "cpu" runs it on the host."""

    def __init__(self, cfg: dict):
        super().__init__()
        import torch

        from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
        from chubaofs_tpu_torch.blobstore.cmd import ModuleRunner, add_admin_routes
        from chubaofs_tpu_torch.blobstore.gateway import AccessGateway
        from chubaofs_tpu_torch.ops.rs import resolve_device

        # refuse to boot, before anything binds, when the codec's device is
        # not there: a daemon told (or defaulted) to use the card never
        # serves from the host instead
        if (resolve_device(cfg.get("device")).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(f"device {cfg.get('device')!r}: no CUDA device "
                               "available; set \"device\": \"cpu\" to run the "
                               "codec on the host")
        runner = ModuleRunner(cfg=dict(cfg))

        def up_cluster(c, handles):
            return MiniCluster(c["root"], n_nodes=int(c.get("nodes", 6)),
                               disks_per_node=int(c.get("disksPerNode", 2)),
                               azs=int(c.get("azs", 1)),
                               device=c.get("device"))

        def up_gateway(c, handles):
            host, port = _addr_split(c.get("listen", "127.0.0.1:0"))
            gw = AccessGateway(
                handles["cluster"].access, host=host, port=port,
                router_hook=lambda r: add_admin_routes(r, handles["cluster"],
                                                       runner))
            c["listen"] = gw.addr  # graceful reloads rebind the SAME address
            return gw

        runner.register("cluster", up_cluster, lambda h: h.close())
        runner.register("gateway", up_gateway, lambda h: h.stop())
        runner.start()
        self.runner = runner
        self.addr = runner.handles["gateway"].addr
        self._every(1.0, self._bg_tick, "blobstore-bg")

    def _bg_tick(self):
        # under the runner lock, so a tick can never race a concurrent
        # reload's teardown of the cluster it is sweeping
        self.runner.call_with("cluster", lambda c: c.run_background_once())

    def stop(self):
        super().stop()
        self.runner.stop()


ROLES = {
    "blobstore": BlobstoreDaemon,
}


def start_role(cfg: dict):
    role = cfg.get("role")
    ctor = ROLES.get(role)
    if ctor is None:
        raise SystemExit(f"unknown role {role!r}; valid: {sorted(ROLES)}")
    return ctor(cfg)


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="chubaofs-tpu-torch",
                                description="chubaofs_tpu_torch server daemon")
    p.add_argument("-c", "--config", required=True, help="JSON config file")
    args = p.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    daemon = start_role(cfg)
    addr = getattr(daemon, "addr", "")
    boot = {"role": cfg["role"], "addr": addr}
    stats_addr = getattr(daemon, "stats_addr", "")
    if stats_addr:
        boot["stats_addr"] = stats_addr  # /metrics side-door (statsListen)
    print(json.dumps(boot), flush=True)  # obslint: boot line IS the stdout protocol (harness parses it)
    # SIGTERM (supervisors, a test harness) must run the same graceful stop
    # as ^C
    from chubaofs_tpu_torch.utils.shutdown import await_shutdown, shutdown_event

    await_shutdown(shutdown_event())
    daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
