"""Alert plane — declarative rules that FIRE and RESOLVE instead of gauges
an operator must watch.

utils/slo.py answers "is this daemon healthy NOW"; this module turns that
(plus the metric-history burn windows and the event journal) into stateful
alerts with the lifecycle a pager expects:

    rule evaluates true  ->  instance FIRING   (alert_firing event, counter)
    rule evaluates false ->  instance RESOLVED (alert_resolved event)

Instances are deduped by FINGERPRINT (rule name + its labels), so a broken
disk flapping through three evaluations is one alert, not three pages.
Silences suppress the firing notification (the instance still evaluates and
reports, marked silenced) — the ack knob for known work.

Rule kinds, all evaluated over the same `utils/metrichist.py` snapshot ring
the SLO evaluator reads (one implementation of "what does a window mean"):

  * `slo_failing`    — an SLO reporting FAILING for N consecutive
                       evaluations (one instance per SLO name);
  * `counter_rate`   — a counter family's restart-clamped window rate above
                       threshold (lease expiries/s);
  * `gauge_sum`      — a gauge family's current sum above threshold, with
                       the SLO evaluator's label_in restriction (broken
                       disks, repair backlog);
  * `event_seen`     — events of a type appeared since the last evaluation
                       (lock inversions); resolves after `consecutive`
                       quiet evaluations.

Surfaced per-daemon at `/alerts` (rpc/server.py mounts it next to /health),
merged at the console `/api/alerts`, rendered by `cfs-events --alerts` and
cfs-top's ALERTS column (`cfs_alerts_firing`). Evaluation cadence:
CFS_ALERT_EVAL_S arms a periodic thread at daemon boot (the metrichist
discipline — unset means zero threads); either way `/alerts` evaluates on
demand when the thread isn't armed, so polling /alerts IS the cadence.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

from chubaofs_tpu_torch.utils import events
from chubaofs_tpu_torch.utils.locks import SanitizedLock
from chubaofs_tpu_torch.utils.slo import FAILING, SLO, _env_f, _eval_window

_ENV_PERIOD = "CFS_ALERT_EVAL_S"

STATE_FIRING, STATE_RESOLVED = "firing", "resolved"


@dataclass(frozen=True)
class AlertRule:
    name: str
    # "slo_failing" | "counter_rate" | "gauge_sum" | "event_seen"
    kind: str
    severity: str = events.SEV_CRITICAL
    description: str = ""
    # slo_failing: consecutive FAILING evaluations before firing; also the
    # event_seen quiet-evaluation count before resolving
    consecutive: int = 3
    # counter_rate / gauge_sum: metric family + breach threshold (+ the SLO
    # evaluator's label_in restriction for gauges)
    family: str = ""
    threshold: float = 0.0
    label_in: tuple = ()
    window_n: int = 6  # counter_rate: snapshots in the rate window
    # event_seen: the journal type watched
    event_type: str = ""


def default_rules() -> list[AlertRule]:
    """The stock rule set, thresholds from env at call time (CFS_ALERT_*).
    Families absent on a role evaluate quiet and never fire — one rule set
    serves every daemon, the default_slos() contract."""
    return [
        AlertRule("slo_failing", "slo_failing",
                  consecutive=max(1, int(_env_f("CFS_ALERT_SLO_N", 3))),
                  description="an SLO held FAILING across N consecutive "
                              "evaluations"),
        AlertRule("lease_expiry_rate", "counter_rate",
                  family="cfs_scheduler_lease_expired",
                  threshold=_env_f("CFS_ALERT_LEASE_RATE", 1.0),
                  severity=events.SEV_WARNING,
                  description="repair lease expiries/s (workers dying or "
                              "wedged)"),
        AlertRule("broken_disks", "gauge_sum",
                  family="cfs_clustermgr_disks",
                  label_in=("status", ("broken",)),
                  threshold=_env_f("CFS_ALERT_BROKEN_DISKS", 0.0),
                  description="disks marked BROKEN awaiting repair"),
        AlertRule("repair_backlog", "gauge_sum",
                  family="cfs_scheduler_tasks",
                  label_in=("state", ("prepared", "working")),
                  threshold=_env_f("CFS_ALERT_REPAIR_BACKLOG", 256.0),
                  severity=events.SEV_WARNING,
                  description="repair tasks outstanding"),
        AlertRule("lock_inversion", "event_seen",
                  event_type="lock_inversion",
                  description="lock-order inversion observed (latent "
                              "deadlock)"),
    ]


def fingerprint(rule_name: str, labels: dict | None) -> str:
    return rule_name + "".join(
        f"|{k}={v}" for k, v in sorted((labels or {}).items()))


# -- lifecycle hooks (the alert-lifecycle subscription, ROADMAP item 4) --------
#
# Callbacks run AFTER the transition's event+counter, outside the manager
# lock, on the evaluating thread — cb(fingerprint, instance_report).
# Private managers (soak probes) never invoke them, same as they never
# publish the cfs_alerts_firing gauge: a probe's synthetic windows must not
# trigger the serving process's incident machinery. A raising hook is
# swallowed — subscribers must not kill the evaluator. on_resolved mirrors
# on_firing for the RESOLVED edge: the autopilot's strict-improvement gate
# confirms a nudge helped by watching the triggering alert clear.

_firing_hooks: list = []
_resolved_hooks: list = []


def on_firing(cb) -> None:
    if cb not in _firing_hooks:
        _firing_hooks.append(cb)


def remove_firing_hook(cb) -> None:
    try:
        _firing_hooks.remove(cb)
    except ValueError:
        pass


def on_resolved(cb) -> None:
    if cb not in _resolved_hooks:
        _resolved_hooks.append(cb)


def remove_resolved_hook(cb) -> None:
    try:
        _resolved_hooks.remove(cb)
    except ValueError:
        pass


@dataclass
class _Instance:
    rule: AlertRule
    labels: dict = field(default_factory=dict)
    state: str = STATE_FIRING
    value: float | None = None
    since_ts: float = 0.0
    since_mono: float = 0.0
    resolved_ts: float | None = None
    silenced: bool = False

    def report(self) -> dict:
        return {"name": self.rule.name, "labels": dict(self.labels),
                "state": self.state, "severity": self.rule.severity,
                "value": self.value, "since": self.since_ts,
                "resolved": self.resolved_ts, "silenced": self.silenced,
                "description": self.rule.description}


class AlertManager:
    """Evaluates a rule set and owns the firing/resolved instance table."""

    RESOLVED_KEEP = 128  # bounded resolved history for /alerts

    def __init__(self, rules: list[AlertRule] | None = None, journal=None,
                 private: bool = False):
        self.rules = list(rules if rules is not None else default_rules())
        self.journal = journal  # None = the process default, bound lazily
        # a PRIVATE manager (a soak probe, an A/B harness) must not clobber
        # the cfs_alerts_firing gauge cfs-top scrapes — that series belongs
        # to the process's serving manager (last-writer-wins would let a
        # probe's table overwrite the real one). Transition events/counters
        # still record: they are additive evidence, not a shared cell.
        self.private = private
        self._lock = SanitizedLock(name="alerts.manager")
        self._instances: dict[str, _Instance] = {}
        self._slo_streak: dict[str, int] = {}
        # event_seen cursors start at the journal HEAD: this manager judges
        # events from its own birth onward — a stale inversion emitted by
        # some earlier phase of the process must not fire a fresh manager
        try:
            base = self._journal().last_seq()
        except Exception:
            base = 0
        self._event_cursor: dict[str, int] = {
            r.name: base for r in self.rules if r.kind == "event_seen"}
        self._event_quiet: dict[str, int] = {}
        self._silences: list[dict] = []  # {pattern, until_mono}
        self._fired_names: set[str] = set()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _journal(self):
        return self.journal if self.journal is not None \
            else events.default_journal()

    # -- silences --------------------------------------------------------------

    def silence(self, pattern: str, duration_s: float = 3600.0) -> None:
        """Suppress firing notifications for instances whose fingerprint
        contains `pattern`, for duration_s from now."""
        with self._lock:
            self._silences.append({"pattern": pattern,
                                   "until_mono": time.monotonic() + duration_s})

    def _silenced_locked(self, fp: str) -> bool:
        now = time.monotonic()
        self._silences = [s for s in self._silences if s["until_mono"] > now]
        return any(s["pattern"] in fp for s in self._silences)

    # -- evaluation ------------------------------------------------------------

    def _eval_rule(self, rule: AlertRule,
                   snaps: list[dict]) -> list[tuple[dict, float | None]]:
        """Instances of one rule currently in breach: [(labels, value)]."""
        if rule.kind == "slo_failing":
            from chubaofs_tpu_torch.utils import slo as slomod

            # track_flips=False: slo_flip events belong to the /health
            # judgment stream; a second evaluator over its own windows must
            # not ping-pong the shared flip state. A PRIVATE manager (soak
            # probe) also skips publishing, or its windows would clobber
            # the serving daemon's cfs_slo_status gauges
            rep = slomod.evaluate(slomod.default_slos(), snaps,
                                  track_flips=False,
                                  publish=not self.private)
            out = []
            for name, s in rep["slos"].items():
                streak = self._slo_streak.get(name, 0)
                streak = streak + 1 if s["status"] == FAILING else 0
                self._slo_streak[name] = streak
                if streak >= rule.consecutive:
                    out.append(({"slo": name}, float(streak)))
            return out
        if rule.kind == "counter_rate":
            spec = SLO(rule.name, "counter_rate", rule.family, rule.threshold)
            v = _eval_window(spec, snaps[-rule.window_n:])
            return [({}, v)] if v is not None and v > rule.threshold else []
        if rule.kind == "gauge_sum":
            spec = SLO(rule.name, "gauge_sum", rule.family, rule.threshold,
                       label_in=rule.label_in)
            v = _eval_window(spec, snaps[-1:])
            return [({}, v)] if v is not None and v > rule.threshold else []
        if rule.kind == "event_seen":
            j = self._journal()
            since = self._event_cursor.get(rule.name, 0)
            evs, cursor = j.query(since=since, n=10 ** 6,
                                  types=(rule.event_type,))
            self._event_cursor[rule.name] = cursor
            if evs:
                self._event_quiet[rule.name] = 0
                return [({}, float(len(evs)))]
            quiet = self._event_quiet.get(rule.name, rule.consecutive) + 1
            self._event_quiet[rule.name] = quiet
            fp = fingerprint(rule.name, {})
            inst = self._instances.get(fp)
            if inst is not None and inst.state == STATE_FIRING \
                    and quiet < rule.consecutive:
                return [({}, inst.value)]  # hold until N quiet evaluations
            return []
        raise ValueError(f"unknown alert rule kind {rule.kind!r}")

    def evaluate(self, snaps: list[dict] | None = None) -> dict:
        """One evaluation pass over every rule; returns report(). With no
        `snaps`, reads (and, when the periodic recorder isn't armed, feeds)
        the process metric history — the /alerts-poll-driven cadence."""
        from chubaofs_tpu_torch.utils.exporter import registry
        from chubaofs_tpu_torch.utils.metrichist import default_history

        if snaps is None:
            hist = default_history()
            if not hist.armed:
                hist.record()
            snaps = hist.snapshots()
        transitions: list[tuple[str, _Instance]] = []
        with self._lock:
            now_firing: dict[str, tuple[AlertRule, dict, float | None]] = {}
            for rule in self.rules:
                try:
                    breaches = self._eval_rule(rule, snaps)
                except Exception:
                    continue  # one rule's bad family must not kill the pass
                for labels, value in breaches:
                    now_firing[fingerprint(rule.name, labels)] = \
                        (rule, labels, value)
            for fp, (rule, labels, value) in now_firing.items():
                inst = self._instances.get(fp)
                if inst is None or inst.state != STATE_FIRING:
                    inst = _Instance(rule=rule, labels=labels,
                                     since_ts=time.time(),
                                     since_mono=time.monotonic(),
                                     silenced=self._silenced_locked(fp))
                    self._instances[fp] = inst
                    if not inst.silenced:
                        self._fired_names.add(rule.name)
                        transitions.append((STATE_FIRING, inst))
                inst.value = value
            for fp, inst in self._instances.items():
                if inst.state == STATE_FIRING and fp not in now_firing:
                    inst.state = STATE_RESOLVED
                    inst.resolved_ts = time.time()
                    if not inst.silenced:
                        transitions.append((STATE_RESOLVED, inst))
            self._prune_resolved_locked()
            firing = sum(1 for i in self._instances.values()
                         if i.state == STATE_FIRING)
        reg = registry("alerts")
        if not self.private:
            reg.gauge("firing").set(firing)
        reg.counter("evaluations").add()
        for state, inst in transitions:
            etype = "alert_firing" if state == STATE_FIRING \
                else "alert_resolved"
            sev = inst.rule.severity if state == STATE_FIRING \
                else events.SEV_INFO
            events.emit(etype, sev, entity=inst.rule.name,
                        detail={"labels": dict(inst.labels),
                                "value": inst.value,
                                "description": inst.rule.description})
            reg.counter("transitions",
                        {"rule": inst.rule.name, "state": state}).add()
        if not self.private:
            for state, inst in transitions:
                hooks = _firing_hooks if state == STATE_FIRING \
                    else _resolved_hooks
                fp = fingerprint(inst.rule.name, inst.labels)
                for cb in list(hooks):
                    try:
                        cb(fp, inst.report())
                    except Exception:
                        pass  # a subscriber must not kill the evaluator
        return self.report()

    def _prune_resolved_locked(self) -> None:
        resolved = [(fp, i) for fp, i in self._instances.items()
                    if i.state == STATE_RESOLVED]
        if len(resolved) <= self.RESOLVED_KEEP:
            return
        resolved.sort(key=lambda kv: kv[1].resolved_ts or 0.0)
        for fp, _ in resolved[: len(resolved) - self.RESOLVED_KEEP]:
            del self._instances[fp]

    # -- report surface --------------------------------------------------------

    def report(self) -> dict:
        """The /alerts payload: firing first (newest first within a state),
        then recent resolved."""
        with self._lock:
            insts = sorted(
                self._instances.values(),
                key=lambda i: (i.state != STATE_FIRING, -i.since_mono))
            return {"alerts": [i.report() for i in insts],
                    "firing": sum(1 for i in insts
                                  if i.state == STATE_FIRING),
                    "silences": [dict(s) for s in self._silences]}

    def firing(self) -> list[dict]:
        with self._lock:
            return [i.report() for i in self._instances.values()
                    if i.state == STATE_FIRING]

    def fired_names(self) -> list[str]:
        """Every rule name that transitioned to firing (non-silenced) over
        this manager's lifetime — the soak/capacity gate's evidence."""
        with self._lock:
            return sorted(self._fired_names)

    # -- periodic evaluation (the metrichist arming discipline) ----------------

    @property
    def armed(self) -> bool:
        return self._thread is not None

    def start(self, period_s: float) -> "AlertManager":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _run():
            while not self._stop.wait(period_s):
                try:
                    self.evaluate()
                except Exception:
                    pass  # one bad pass must not kill the evaluator

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="cfs-alerts")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# -- process-wide default ------------------------------------------------------

_default: AlertManager | None = None
_dlock = threading.Lock()


def env_period() -> float:
    try:
        p = float(os.environ.get(_ENV_PERIOD, "") or 0.0)
    except ValueError:
        return 0.0
    return p if p > 0.0 else 0.0


def default_manager() -> AlertManager:
    global _default
    with _dlock:
        if _default is None:
            _default = AlertManager()
        return _default


def activate_from_env() -> AlertManager | None:
    """Arm the periodic evaluator iff CFS_ALERT_EVAL_S asks for it — the
    daemon-boot hook. Unset env = nothing started (zero overhead)."""
    if not env_period():
        return _default
    return default_manager().start(env_period())


def deactivate() -> None:
    """Stop + forget the process manager (test isolation)."""
    global _default
    with _dlock:
        m, _default = _default, None
    if m is not None:
        m.stop()


def alerts_report(evaluate_if_cold: bool = True) -> dict:
    """The /alerts payload for THIS process. When the periodic evaluator
    isn't armed, each call evaluates first — polling /alerts then IS the
    evaluation cadence (the health_report() contract)."""
    m = default_manager()
    if evaluate_if_cold and not m.armed:
        return m.evaluate()
    return m.report()
