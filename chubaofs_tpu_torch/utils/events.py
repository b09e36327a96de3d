"""Event journal — the cluster's structured state-transition timeline.

The observability plane's third leg (spans tell WHERE time went, metrics
tell HOW MUCH, events tell WHAT CHANGED): every significant transition —
a disk leaving NORMAL, a repair lease granted or expired, a tier promote
committed, a raft leadership change, an evloop backpressure flip, an SLO
status flip, a chaos injection — lands as ONE typed record in a per-daemon
`EventJournal`:

    bounded in-memory ring (CFS_EVENTS_LEN) for the /events HTTP side-door
        +
    rotating JSONL trail (CFS_EVENT_BYTES / CFS_EVENT_FILES) through the
    same utils/auditlog.RotatingFile rotor as the slow-op audit

so "why did the SLO flip at 14:02" stops being a nine-daemon grep and
becomes `cfs-events --since 300` (tools/cfsevents.py merges the cluster's
journals via the console `/api/events` rollup, cursor-paged).

Records carry a wall stamp (display / cross-daemon merge), a monotonic
stamp (same-process ordering that survives NTP steps), a monotonically
increasing `seq` (the pagination cursor), role/addr (stamped by the daemon
at RPCServer boot), severity, a type from the closed EVENT_TYPES set, an
entity string, a small detail dict, and an optional trace id — auto-filled
from the current span when one is live, so a repair task's terminal event
joins the repair trace without the emitter knowing about tracing
(`cfs-events --correlate <trace-id>` is that join).

Discipline:

  * `emit()` NEVER raises — it runs inside serve loops, lock-sanitizer
    callbacks, and scheduler threads where a full disk must degrade to a
    lost timeline line, not a dead daemon.
  * The plane records TRANSITIONS, never per-op traffic: no PUT/GET/packet
    path calls emit(). perfbench's events-overhead smoke pins that down
    (a MiniCluster PUT/GET burst must emit zero events).
  * `cfs_events_total{type,severity}` counters ride the exporter's bounded-label
    guard: both label keys are declared closed sets, so a typo'd event type
    fails loudly at the metric layer instead of minting unbounded series.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from chubaofs_tpu_torch.utils.auditlog import RotatingFile
from chubaofs_tpu_torch.utils.locks import SanitizedLock

SEV_INFO, SEV_WARNING, SEV_CRITICAL = "info", "warning", "critical"
SEVERITIES = (SEV_INFO, SEV_WARNING, SEV_CRITICAL)

# the closed event-type set (obslint rule 1 spirit, enforced at runtime by
# exporter.declare_label_values): a new transition class is added HERE, not
# minted ad hoc at a call site
EVENT_TYPES = (
    "daemon_boot",          # RPCServer came up (role/addr stamp)
    "disk_status",          # clustermgr disk NORMAL->BROKEN->DROPPED
    "lease_acquired",       # scheduler handed a task to a worker
    "lease_expired",        # reaper requeued a silent worker's task
    "task_finished",        # repair/migrate/tier task went terminal-OK
    "task_failed",          # task went terminal FAILED
    "tier_promote",         # hot-tier redirect committed
    "tier_demote",          # hot-tier redirect dropped
    "partition_moved",      # master re-homed a partition replica
    "meta_split",           # mid-range meta split: freeze/commit/complete
    "meta_migrate",         # meta partition replica add-peer/remove-peer
    "node_decommissioned",  # master drained a node
    "scrub_finding",        # blobnode CRC scrub found bad shards
    "raft_leader",          # a raft group elected this node leader
    "backpressure_on",      # evloop paused reads on a connection
    "backpressure_off",     # evloop resumed reads
    "slo_flip",             # an SLO changed status (ok<->degraded<->failing)
    "lock_inversion",       # lock-order sanitizer saw a cycle
    "chaos_inject",         # chaos scheduler injected a fault plan step
    "chaos_lift",           # chaos scheduler lifted a fault
    "failpoint_armed",      # a failpoint was armed
    "failpoint_disarmed",   # a failpoint was disarmed
    "alert_firing",         # an alert rule started firing
    "alert_resolved",       # a firing alert cleared
    "qos_throttle",         # gateway QoS throttled a tenant (episode, 1/s)
    "bench_tick",           # perfbench events-overhead smoke traffic
    "incident_capture",     # flight recorder froze a capture bundle
    "autopilot_considered",  # a firing alert matched an armed binding
    "autopilot_damped",      # flap damper / cooldown held an action back
    "autopilot_refused",     # hourly action budget exhausted
    "autopilot_executed",    # an actuator ran (or dry-run logged intent)
    "autopilot_rolled_back",  # strict-improvement gate undid a nudge
)

_SEV_RANK = {SEV_INFO: 0, SEV_WARNING: 1, SEV_CRITICAL: 2}

_ENV_LEN = "CFS_EVENTS_LEN"
_ENV_BYTES = "CFS_EVENT_BYTES"
_ENV_FILES = "CFS_EVENT_FILES"
DEFAULT_LEN = 2048

# process boot stamp (wall): the cfs_boot_time_seconds gauge every daemon
# exports, and the UP / (restart) cross-check cfs-top renders. Wall on
# purpose — it is cross-process protocol (scrapers subtract it from their
# own wall clock), exactly like heartbeat stamps.
BOOT_TS = time.time()


class EventJournal:
    """Bounded ring + rotating JSONL of typed transition records."""

    def __init__(self, logdir: str, role: str = "", addr: str = "",
                 ring_len: int | None = None, max_bytes: int | None = None,
                 max_files: int | None = None):
        from chubaofs_tpu_torch.utils.config import env_int

        self.dir = logdir
        self.role = role
        self.addr = addr
        self._ring_len = ring_len or env_int(_ENV_LEN, DEFAULT_LEN)
        self._rotor = RotatingFile(
            logdir, "events",
            max_bytes if max_bytes is not None else env_int(_ENV_BYTES,
                                                            4 << 20),
            max_files if max_files is not None else env_int(_ENV_FILES, 4))
        self._ring: list[dict] = []
        self._seq = 0
        self._lock = SanitizedLock(name="events.journal")
        self._declare_labels()

    @staticmethod
    def _declare_labels() -> None:
        """The runtime half of the closed-set contract: cfs_events_total's
        label values are bounded BY DECLARATION, so an undeclared type
        string fails at the metric call instead of growing /metrics.

        This RESERVES the bare label keys `type`/`severity` process-wide
        (declare_label_values is keyed by label name): no metric family
        uses either key today, and any future one must either carry a
        declared event type/severity or pick a scoped key — a loud
        ValueError at the call site, which is the guard working, not a
        collision to paper over."""
        from chubaofs_tpu_torch.utils.exporter import declare_label_values

        declare_label_values("type", EVENT_TYPES)
        declare_label_values("severity", SEVERITIES)

    # -- ingest ----------------------------------------------------------------

    def emit(self, etype: str, severity: str = SEV_INFO, *, entity: str = "",
             detail: dict | None = None, trace_id: str | None = None) -> dict:
        """Append one event; returns the record. Raises on an unknown type
        or severity — emitters are code, and a typo'd type is a bug the
        module-level emit() wrapper reports rather than records."""
        if etype not in EVENT_TYPES:
            raise ValueError(f"unknown event type {etype!r}; add it to "
                             "events.EVENT_TYPES")
        if severity not in _SEV_RANK:
            raise ValueError(f"unknown severity {severity!r}")
        if trace_id is None:
            # join the live span's trace when one exists: the emitter gets
            # trace correlation (cfs-events --correlate) for free
            try:
                from chubaofs_tpu_torch.blobstore import trace

                span = trace.current_span()
                if span is not None:
                    trace_id = span.trace_id
            except Exception:
                trace_id = None
        rec = {"ts": time.time(), "mono": time.monotonic(),
               "role": self.role, "addr": self.addr,
               "severity": severity, "type": etype, "entity": entity,
               "detail": dict(detail or {})}
        if trace_id:
            rec["trace_id"] = trace_id
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            if len(self._ring) > self._ring_len:
                del self._ring[: len(self._ring) - self._ring_len]
            # the JSONL line lands INSIDE the seq critical section: the
            # on-disk trail (which outlives the ring) must stay seq-ordered,
            # and a preempted emitter writing after a later seq would break
            # every oldest-first read_lines() consumer
            self._rotor.write_line(json.dumps(rec, default=str))
        from chubaofs_tpu_torch.utils.exporter import registry

        registry("events").counter(
            "total", {"type": etype, "severity": severity}).add()
        return rec

    # -- queries ---------------------------------------------------------------

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def query(self, since: int = 0, n: int = 200,
              types: tuple | list | None = None,
              severity: tuple | list | None = None,
              min_ts: float = 0.0) -> tuple[list[dict], int]:
        """Events with seq > since (oldest first, at most n), plus the
        cursor to pass as the NEXT since. The cursor advances past filtered-
        out events too, so a poller never re-fetches what it chose to skip;
        it only stops short when `n` truncated the page (resume there)."""
        with self._lock:
            ring = list(self._ring)
            last = self._seq
        if since > last:
            # the poller's cursor outruns this journal's head: seq is
            # process-local, so the daemon RESTARTED and the cursor belongs
            # to its previous life. Reset to the start — the restart-era
            # events are exactly the forensics a cursor must not skip —
            # rather than blinding the poller forever behind a stale seq.
            since = 0
        out = []
        cursor = since
        for rec in ring:
            if rec["seq"] <= since:
                continue
            if len(out) >= max(0, n):
                return out, cursor  # page full: resume from the last taken
            cursor = rec["seq"]
            if types and rec["type"] not in types:
                continue
            if severity and rec["severity"] not in severity:
                continue
            if min_ts and rec["ts"] < min_ts:
                continue
            out.append(rec)
        # the whole ring was examined (truncated pages returned above):
        # the cursor is the journal head, even when old events already
        # fell out of the ring
        return out, max(cursor, last)

    def close(self):
        self._rotor.close()


# -- process-wide default ------------------------------------------------------

_default: EventJournal | None = None
_lock = SanitizedLock(name="events.default")


def default_journal() -> EventJournal:
    """The process journal, created on first use: directory from
    CFS_EVENTS_DIR (default a per-process tmpdir), budgets from env."""
    global _default
    with _lock:
        if _default is None:
            logdir = os.environ.get("CFS_EVENTS_DIR") or os.path.join(
                tempfile.gettempdir(), f"cfs-events-{os.getpid()}")
            _default = EventJournal(logdir)
        return _default


def configure(logdir: str | None = None, role: str | None = None,
              addr: str | None = None) -> EventJournal:
    """(Re)bind the process journal — daemons stamp their role/addr at
    RPCServer boot, tests point it at a tmpdir. Passing only role/addr
    retags in place (the ring and rotor carry forward); a logdir change
    rebuilds the journal."""
    global _default
    with _lock:
        if _default is not None and logdir is not None \
                and logdir != _default.dir:
            _default.close()
            _default = None
        if _default is None:
            _default = EventJournal(
                logdir or os.environ.get("CFS_EVENTS_DIR") or os.path.join(
                    tempfile.gettempdir(), f"cfs-events-{os.getpid()}"),
                role=role or "", addr=addr or "")
        else:
            if role is not None:
                _default.role = role
            if addr is not None:
                _default.addr = addr
        return _default


def reset() -> None:
    """Close + forget the process journal (test isolation)."""
    global _default
    with _lock:
        j, _default = _default, None
    if j is not None:
        j.close()


def emit(etype: str, severity: str = SEV_INFO, *, entity: str = "",
         detail: dict | None = None, trace_id: str | None = None) -> bool:
    """The one emitter every subsystem calls. NEVER raises — it runs in
    serve loops, reaper threads, and sanitizer callbacks, where a full disk
    or a mis-typed detail value must degrade to a lost timeline line, not a
    dead daemon. Returns True when the event was recorded."""
    try:
        default_journal().emit(etype, severity, entity=entity, detail=detail,
                               trace_id=trace_id)
        return True
    except Exception:
        return False


def recent_page(n: int = 200, types: tuple | list | None = None,
                severity: tuple | list | None = None
                ) -> tuple[list[dict], int]:
    """The newest n matching events (oldest first) plus the journal-head
    cursor FROM THE SAME QUERY — the /events one-shot response (a separate
    last_seq() read could race a fresh emit and hand a cursor that skips
    it). n<=0 is an empty window, never the whole-ring [-0:] slice."""
    evs, cursor = default_journal().query(since=0, n=10 ** 9, types=types,
                                          severity=severity)
    return (evs[-n:] if n > 0 else []), cursor


def recent(n: int = 200, types: tuple | list | None = None,
           severity: tuple | list | None = None) -> list[dict]:
    """The newest n matching events, oldest first."""
    return recent_page(n, types, severity)[0]
