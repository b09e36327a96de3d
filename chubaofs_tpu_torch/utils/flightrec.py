"""Incident flight recorder: alert-triggered capture bundles.

When an alert transitions to firing — or an operator/harness asks
explicitly — freeze the pre-incident window this process already holds in
its observability rings into one on-disk *bundle* directory: the last K
metric-history snapshots, the recent event ring, recent traces + slowops,
the autopilot decision log, a bounded on-demand profile (or the continuous profiler's aggregate when one
is armed), the lock-sanitizer report, the CFS_* knob dump, and boot/build
info. The rings rotate in minutes; the bundle is the evidence that
survives to the postmortem.

Zero-overhead-when-disarmed, same discipline as the profiler: with
`CFS_FLIGHT` unset `activate_from_env()` touches nothing — no thread (the
recorder NEVER has one: captures run on the alert-eval thread or the HTTP
handler that asked), no alert hook, no directory, no hot-path cost.
`/debug/bundle` answers 400 with the arming hint. Explicit `capture()`
still works disarmed (the `/debug/prof?seconds=N` on-demand contract) —
the chaos-soak failure hook relies on that.

Flap safety: captures dedup by alert fingerprint inside a cooldown window
(`CFS_FLIGHT_COOLDOWN_S`) — a flapping rule returns the bundle it already
wrote instead of disk-storming — and the bundle root is size-budgeted
(`CFS_FLIGHT_MB`): oldest bundles are evicted first, never the one just
written.

Knobs: `CFS_FLIGHT` (truthy arms the alert hook), `CFS_FLIGHT_DIR`
(default a per-process tmpdir), `CFS_FLIGHT_MB` (bundle-root budget,
default 64), `CFS_FLIGHT_COOLDOWN_S` (per-fingerprint dedup window,
default 60).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
import time

from chubaofs_tpu_torch.utils.config import env_float

DEFAULT_MB = 64
DEFAULT_COOLDOWN_S = 60.0
SNAPSHOT_K = 32         # metric-history snapshots frozen per bundle
EVENTS_N = 400          # event-ring window frozen per bundle
TRACE_RECORDS_N = 400   # span records frozen per bundle
SLOWOPS_N = 200
PROFILE_SECONDS = 0.25  # on-demand profile bound when none is armed

SECTIONS = ("meta", "alert", "metrics", "events", "traces", "slowops",
            "autopilot", "profile", "locks", "config")

_FALSEY = ("", "0", "false", "no")


def enabled() -> bool:
    return os.environ.get("CFS_FLIGHT", "").strip().lower() not in _FALSEY


def flight_dir() -> str:
    return os.environ.get("CFS_FLIGHT_DIR") or os.path.join(
        tempfile.gettempdir(), f"cfs-flight-{os.getpid()}")


def budget_bytes() -> int:
    # fractional MB is legal (hygiene tests pin tiny budgets); floor 4 KiB
    # so a typo'd 0 can't evict every bundle but the newest
    return max(4096, int(env_float("CFS_FLIGHT_MB", DEFAULT_MB)
                         * 1024 * 1024))


def cooldown_s() -> float:
    return max(0.0, env_float("CFS_FLIGHT_COOLDOWN_S", DEFAULT_COOLDOWN_S))


def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", s).strip("_")[:80] or "incident"


# -- section gathers -----------------------------------------------------------
#
# Each pulls from a ring that already exists; every one is individually
# fault-isolated in capture() — a broken section degrades to an "error"
# stanza in the bundle, never a lost incident.


def _gather_meta(trigger: str, fp: str, ts: float) -> dict:
    import chubaofs_tpu_torch
    from chubaofs_tpu_torch.utils import events

    j = events.default_journal()
    return {"trigger": trigger, "fingerprint": fp, "ts": ts,
            "role": j.role, "addr": j.addr, "pid": os.getpid(),
            "version": getattr(chubaofs_tpu_torch, "__version__", "?"),
            "boot_ts": events.BOOT_TS}


def _gather_metrics() -> dict:
    from chubaofs_tpu_torch.utils import metrichist

    hist = metrichist.default_history()
    snaps = hist.snapshots(SNAPSHOT_K)
    if not snaps:
        # history disarmed or cold: one fresh snapshot beats an empty
        # section — cfs-doctor still gets the at-incident counter state
        snaps = [hist.record()]
    return {"snapshots": snaps}


def _gather_events() -> dict:
    from chubaofs_tpu_torch.utils import events

    evs, cursor = events.recent_page(EVENTS_N)
    return {"events": evs, "cursor": cursor}


def _gather_traces() -> dict:
    from chubaofs_tpu_torch.utils import tracesink

    sink = tracesink.default_sink()
    return {"records": sink.recent_records(TRACE_RECORDS_N),
            "traces": sink.recent_traces(50)}


def _gather_slowops() -> dict:
    from chubaofs_tpu_torch.utils import auditlog

    return {"slowops": auditlog.recent_slowops(SLOWOPS_N)}


def _gather_autopilot() -> dict:
    # the controller's decision ring + arming state, frozen at incident
    # time — cfs-doctor names the actions the autopilot took (or refused)
    # inside the window. Disarmed processes freeze the stub status.
    from chubaofs_tpu_torch.autopilot import controller

    return controller.autopilot_status()


def _gather_profile(profile_s: float) -> dict:
    from chubaofs_tpu_torch.utils import profiler

    cont = profiler.active()
    if cont is not None:
        out = cont.profile.to_dict()
        out["source"] = "continuous"
        return out
    out = profiler.capture(profile_s).to_dict()
    out["source"] = "capture"
    return out


def _gather_locks() -> dict:
    from chubaofs_tpu_torch.utils import locks

    return locks.report()


def _gather_config() -> dict:
    return {"env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith("CFS_")}}


# -- the recorder --------------------------------------------------------------


class FlightRecorder:
    """Per-process bundle writer. Threadless by design: `capture()` runs on
    whoever triggered it, serialized by `_lock` so a burst of distinct
    alerts can't interleave half-written bundles."""

    def __init__(self, root: str | None = None):
        self.root = root or flight_dir()
        self._lock = threading.Lock()
        self._recent: dict[str, tuple[float, str]] = {}  # fp -> (mono, path)
        self._seq = 0

    # -- capture ---------------------------------------------------------------

    def capture(self, trigger: str = "manual", fingerprint: str = "",
                alert: dict | None = None,
                profile_s: float = PROFILE_SECONDS) -> dict:
        """Freeze the window into a new bundle dir; returns its manifest.
        Same fingerprint inside the cooldown returns the EXISTING bundle's
        manifest with deduped=True and writes nothing."""
        from chubaofs_tpu_torch.utils import events
        from chubaofs_tpu_torch.utils.exporter import registry

        with self._lock:
            now_mono = time.monotonic()
            if fingerprint:
                hit = self._recent.get(fingerprint)
                if hit is not None and now_mono - hit[0] < cooldown_s() \
                        and os.path.isdir(hit[1]):
                    registry("flightrec").counter(
                        "captures", {"outcome": "deduped"}).add()
                    man = _read_json(os.path.join(hit[1], "manifest.json"))
                    man = man or {"bundle": hit[1]}
                    man["deduped"] = True
                    return man

            ts = time.time()
            self._seq += 1
            # pid in the name: daemons sharing one CFS_FLIGHT_DIR (the
            # harness arms a whole ProcCluster at once) must never collide
            name = (f"{_slug(fingerprint or trigger)}-{int(ts)}"
                    f"-{os.getpid()}-{self._seq:03d}")
            path = os.path.join(self.root, name)
            os.makedirs(path, exist_ok=True)

            gathers = {
                "meta": lambda: _gather_meta(trigger, fingerprint, ts),
                "alert": lambda: dict(alert or {}),
                "metrics": _gather_metrics,
                "events": _gather_events,
                "traces": _gather_traces,
                "slowops": _gather_slowops,
                "autopilot": _gather_autopilot,
                "profile": lambda: _gather_profile(profile_s),
                "locks": _gather_locks,
                "config": _gather_config,
            }
            sections: dict[str, str] = {}
            for sec in SECTIONS:
                try:
                    payload = gathers[sec]()
                    sections[sec] = "ok"
                except Exception as e:  # degrade, never lose the incident
                    payload = {"error": f"{type(e).__name__}: {e}"}
                    sections[sec] = "error"
                _write_json(os.path.join(path, f"{sec}.json"), payload)

            manifest = {"bundle": path, "name": name, "trigger": trigger,
                        "fingerprint": fingerprint, "ts": ts,
                        "sections": sections, "deduped": False,
                        "bytes": _dir_bytes(path)}
            _write_json(os.path.join(path, "manifest.json"), manifest)
            if fingerprint:
                self._recent[fingerprint] = (now_mono, path)
            self._evict_locked(keep=path)
            registry("flightrec").counter(
                "captures", {"outcome": "written"}).add()

        events.emit("incident_capture", events.SEV_WARNING,
                    entity=fingerprint or trigger,
                    detail={"bundle": path, "trigger": trigger,
                            "sections": sections})
        return manifest

    # -- hygiene ---------------------------------------------------------------

    def _evict_locked(self, keep: str) -> None:
        budget = budget_bytes()
        bundles = self.list_bundles()
        total = sum(b["bytes"] for b in bundles)
        for b in bundles:  # oldest first
            if total <= budget:
                break
            if os.path.abspath(b["path"]) == os.path.abspath(keep):
                continue  # never the bundle this capture just wrote
            shutil.rmtree(b["path"], ignore_errors=True)
            total -= b["bytes"]

    def list_bundles(self) -> list[dict]:
        """Bundle summaries under the root, oldest first."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            path = os.path.join(self.root, name)
            if not os.path.isdir(path):
                continue
            man = _read_json(os.path.join(path, "manifest.json")) or {}
            out.append({"name": name, "path": path,
                        "ts": man.get("ts", 0.0),
                        "trigger": man.get("trigger", "?"),
                        "fingerprint": man.get("fingerprint", ""),
                        "sections": man.get("sections", {}),
                        "bytes": _dir_bytes(path)})
        out.sort(key=lambda b: (b["ts"], b["name"]))
        return out


# -- bundle IO (shared with /debug/bundle, the console collector, cfs-doctor) --


def _write_json(path: str, payload: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, separators=(",", ":"), default=str)


def _read_json(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _dir_bytes(path: str) -> int:
    total = 0
    for base, _dirs, files in os.walk(path):
        for fn in files:
            try:
                total += os.path.getsize(os.path.join(base, fn))
            except OSError:
                pass
    return total


def bundle_payload(path: str) -> dict:
    """A bundle dir loaded into one dict: {section: payload}. Missing or
    corrupt section files surface as {"error": ...} stanzas — the collector
    and cfs-doctor render what survived."""
    out: dict = {}
    for sec in SECTIONS + ("manifest",):
        p = os.path.join(path, f"{sec}.json")
        if not os.path.exists(p):
            continue
        out[sec] = _read_json(p) or {"error": f"unreadable {sec}.json"}
    return out


def write_payload(path: str, payload: dict) -> None:
    """Inverse of bundle_payload: materialize a fetched payload as a bundle
    dir (the console collector writing one target's sections)."""
    os.makedirs(path, exist_ok=True)
    for sec, body in payload.items():
        if isinstance(body, dict):
            _write_json(os.path.join(path, f"{sec}.json"), body)


# -- process singleton + arming ------------------------------------------------

_default: FlightRecorder | None = None
_mod_lock = threading.Lock()
_hooked = False


def default_recorder() -> FlightRecorder:
    global _default
    with _mod_lock:
        if _default is None:
            _default = FlightRecorder()
        return _default


def capture(trigger: str = "manual", fingerprint: str = "",
            alert: dict | None = None,
            profile_s: float = PROFILE_SECONDS) -> dict:
    """Module-level capture on the process recorder. Works even disarmed —
    explicit triggers (soak failure hooks, ?collect=1 side-doors) are
    on-demand, like /debug/prof?seconds=N."""
    return default_recorder().capture(trigger=trigger,
                                      fingerprint=fingerprint, alert=alert,
                                      profile_s=profile_s)


def _on_alert_firing(fp: str, inst_report: dict) -> None:
    capture(trigger="alert", fingerprint=fp, alert=inst_report)


def activate_from_env() -> FlightRecorder | None:
    """Arm the alert-firing hook iff CFS_FLIGHT asks for it — the daemon-
    boot hook (rpc/server.py calls it next to the other activate_from_env
    quartet). Unset env = return None having touched nothing: no recorder
    object, no hook, no directory."""
    global _hooked
    if not enabled():
        return None
    from chubaofs_tpu_torch.utils import alerts

    with _mod_lock:
        if not _hooked:
            alerts.on_firing(_on_alert_firing)
            _hooked = True
    return default_recorder()


def deactivate() -> None:
    """Unhook + forget the process recorder (test isolation). Bundles
    already on disk are left alone — they are the evidence."""
    global _default, _hooked
    from chubaofs_tpu_torch.utils import alerts

    with _mod_lock:
        if _hooked:
            alerts.remove_firing_hook(_on_alert_firing)
            _hooked = False
        _default = None
