"""Blobstore service composition: module registry, graceful drain-and-reload,
and the admin API surface.

Reference counterpart: blobstore/cmd/cmd.go:63-80 — services RegisterModule
their setup/teardown with the runner, and a graceful restart tears the stack
down in reverse order, draining in-flight work, then brings it back up (the
reference hands sockets across an exec; here the listener rebinds the same
address, which the composed single-process daemon makes equivalent). The admin
routes are the HTTP face the blobstore CLI (blobstore/cli analog,
chubaofs_tpu_torch/cli/blobstore.py) drives.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Module:
    """One registered service (RegisterModule analog)."""

    name: str
    setup: Callable[[dict, dict], object]  # (cfg, handles) -> handle
    teardown: Callable[[object], None] = lambda h: None


@dataclass
class ModuleRunner:
    """Ordered service lifecycle with graceful reload.

    Modules start in registration order and tear down in reverse (consumers
    before providers). reload() is the graceful restart: drain + teardown the
    whole stack, then set it back up from (possibly updated) config — state
    survives because every service persists (kvstore/WAL/chunk files)."""

    cfg: dict = field(default_factory=dict)
    modules: list[Module] = field(default_factory=list)
    handles: dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        self._lock = threading.Lock()
        self.reloads = 0
        self.last_error = ""

    def register(self, name: str, setup, teardown=None) -> None:
        if any(m.name == name for m in self.modules):
            raise ValueError(f"module {name!r} already registered")
        self.modules.append(Module(name, setup, teardown or (lambda h: None)))

    def start(self) -> None:
        with self._lock:
            self._start_locked()

    def _start_locked(self) -> None:
        started: list[Module] = []
        try:
            for m in self.modules:
                self.handles[m.name] = m.setup(self.cfg, self.handles)
                started.append(m)
        except Exception:
            # partial start: unwind what came up so no service leaks
            for m in reversed(started):
                self._teardown_one(m)
            raise

    def _teardown_one(self, m: Module) -> None:
        h = self.handles.pop(m.name, None)
        if h is not None:
            try:
                m.teardown(h)
            except Exception:
                pass  # teardown is best-effort during drain

    def reload(self, cfg: dict | None = None) -> None:
        """Graceful restart: teardown in reverse, bring everything back up.
        A failed restart is RECORDED (last_error) so operators can see why the
        stack is down via status(), not just a lost daemon-thread traceback."""
        with self._lock:
            for m in reversed(self.modules):
                self._teardown_one(m)
            if cfg is not None:
                self.cfg = cfg
            try:
                self._start_locked()
            except Exception as e:
                self.last_error = f"{type(e).__name__}: {e}"
                raise
            self.last_error = ""
            self.reloads += 1

    def call_with(self, name: str, fn):
        """Run fn(handle) UNDER the runner lock — callers (background ticks)
        never race a concurrent reload's teardown. Returns None when the
        module isn't up."""
        with self._lock:
            h = self.handles.get(name)
            if h is None:
                return None
            return fn(h)

    def stop(self) -> None:
        with self._lock:
            for m in reversed(self.modules):
                self._teardown_one(m)

    def status(self) -> list[dict]:
        with self._lock:
            return [{"name": m.name, "running": m.name in self.handles}
                    for m in self.modules]


def add_admin_routes(router, cluster, runner: ModuleRunner | None = None):
    """Admin surface over a MiniCluster (clustermgr/scheduler views + task
    switches + graceful reload) — what the blobstore CLI drives."""
    import json

    from chubaofs_tpu_torch.blobstore.taskswitch import ALL_SWITCHES
    from chubaofs_tpu_torch.rpc.router import Response

    def _json(data, status=200):
        return Response(status, {"Content-Type": "application/json"},
                        json.dumps(data).encode())

    def stat(req):
        cm = cluster.cm
        return _json({
            "disks": len(cm.disks),
            "broken_disks": [d.disk_id for d in cm.broken_disks()],
            "volumes": len(cm.volumes),
            "nodes": sorted(cluster.nodes),
            "services": {k: v for k, v in cm.services.items()},
            "reloads": runner.reloads if runner else 0,
            "reload_error": runner.last_error if runner else "",
        })

    def disks(req):
        return _json([d.__dict__ for d in cluster.cm.disks.values()])

    def volumes(req):
        return _json([
            {"vid": v.vid, "code_mode": v.code_mode, "status": v.status,
             "units": len(v.units)}
            for v in cluster.cm.volumes.values()
        ])

    def volume(req):
        try:
            vol = cluster.cm.get_volume(int(req.q("vid")))
        except Exception as e:
            return _json({"error": str(e)}, 404)
        return _json({"vid": vol.vid, "code_mode": vol.code_mode,
                      "status": vol.status,
                      "units": [u.__dict__ for u in vol.units]})

    def tasks(req):
        return _json([t.__dict__ for t in cluster.scheduler.tasks()])

    def switches(req):
        sw = cluster.scheduler.switches
        return _json({n: sw.enabled(n) for n in ALL_SWITCHES})

    def set_switch(req):
        name = req.q("name")
        if name not in ALL_SWITCHES:
            return _json({"error": f"unknown switch {name!r}"}, 400)
        enabled = req.q("enabled") in ("1", "true", "on")
        cluster.scheduler.switches.set(name, enabled)
        return _json({name: enabled})

    def forgive(req):
        """Lift all access punish windows after a CONFIRMED recovery
        (Access.clear_punishments — else writes treat a healed AZ/host as
        dark until punish_secs expires, and a second failure inside the
        window leaves blobs missing two AZs' worth of shards)."""
        cluster.access.clear_punishments()
        return _json({"forgiven": True})

    def modules(req):
        return _json(runner.status() if runner else [])

    def reload(req):
        if runner is None:
            return _json({"error": "no module runner"}, 400)

        # reload from a background thread: tearing down the gateway from
        # inside one of its own handler threads would deadlock the drain.
        # Failures land in runner.last_error (surfaced by /admin/stat).
        def _reload():
            try:
                runner.reload()
            except Exception:
                pass  # recorded in runner.last_error

        threading.Thread(target=_reload, daemon=True,
                         name="blobstore-reload").start()
        return _json({"reloading": True})

    router.get("/admin/stat", stat)
    router.get("/admin/disks", disks)
    router.get("/admin/volumes", volumes)
    router.get("/admin/volume", volume)
    router.get("/admin/tasks", tasks)
    router.get("/admin/switches", switches)
    router.post("/admin/switch", set_switch)
    router.post("/admin/forgive", forgive)
    router.get("/admin/modules", modules)
    router.post("/admin/reload", reload)
    return router
