"""Closed-loop autopilot — firing alerts drive actuators, auditably.

Every signal and every actuator in this codebase exists separately: burn
alerts (utils/alerts.py), hot-volume rebalance (master), meta
split/rebalance, tier promotion thresholds (blobstore/cache.py), QoS
shaping (utils/qos.py), scrub/repair budgets (blobstore). An operator
still has to read cfs-top and call cfs-cli. This module closes the loop:
a controller subscribes to the alert firing→resolved lifecycle
(`alerts.on_firing` / `alerts.on_resolved`) and maps firing alerts to
actuators through declarative BINDINGS.

Safety is the design center, not a rider:

  * strict-improvement gate — after an actuator runs, the triggering
    alert must RESOLVE within the binding's settle window; if it does
    not, the nudge is rolled back (when the actuator is reversible) and
    the failure is on the timeline either way;
  * per-actuator cooldowns — one nudge per actuator per cooldown window;
  * flap damping — an alert that resolves and re-fires inside the flap
    window backs off EXPONENTIALLY (a flapping signal must not drive an
    oscillating actuator);
  * bounded action budget — at most CFS_AUTOPILOT_BUDGET real actions
    per sliding hour, refusals recorded;
  * dry-run — intended actions are logged (autopilot_executed with
    dry_run=true) without touching the cluster.

Observability IS the product: every decision — considered, damped,
budget-refused, executed, rolled-back — is a typed `autopilot_*` event
carrying the causal alert fingerprint, so `cfs-events --correlate <fp>`
renders the full `alert fired → action taken → alert resolved` causal
chain. Controller state (armed bindings, cooldown clocks, remaining
budget, last N decisions) is served at the `/autopilot` side-door and by
`cfs-cli autopilot status`.

Two feed modes, one decision pipeline:

  * in-process — `attach()` subscribes to this process's alert hooks
    (armed at daemon boot by `activate_from_env()` when CFS_AUTOPILOT is
    set); the master daemon registers its rebalance/split actuators at
    boot;
  * console-fed — `observe_rollup(alerts)` feeds the controller from a
    console `/api/alerts` rollup (the cfs-capacity `--autopilot` mode),
    deduping firing↔resolved transitions by fingerprint itself, with
    MasterClient-backed actuators.

Knobs (all read at activation): CFS_AUTOPILOT (arm), CFS_AUTOPILOT_DRY
(dry-run), CFS_AUTOPILOT_BUDGET (actions/hour, default 6),
CFS_AUTOPILOT_FLAP_S (flap window, default 120), CFS_AUTOPILOT_BACKOFF_S
(base flap back-off, default 60), CFS_AUTOPILOT_COOLDOWN_S /
CFS_AUTOPILOT_SETTLE_S (default binding clocks), CFS_AUTOPILOT_TICK_S
(settle-gate sweep cadence when armed, default 5).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from chubaofs_tpu_torch.utils import events
from chubaofs_tpu_torch.utils.locks import SanitizedLock

BUDGET_WINDOW_S = 3600.0  # the sliding budget hour
MAX_BACKOFF_S = 3600.0    # flap back-off cap

# the closed decision vocabulary (bounded metric label, mirrors the
# autopilot_* event taxonomy plus the two non-event outcomes)
DECISIONS = ("considered", "damped", "refused", "executed",
             "rolled_back", "confirmed", "error")


def _env_f(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, "") or default)
    except ValueError:
        return default
    return v


@dataclass(frozen=True)
class Binding:
    """One alert-rule → actuator arm. `match_labels` (a tuple of (k, v)
    pairs) restricts the arm to instances whose labels carry that subset
    — e.g. rule="slo_failing", match_labels=(("slo", "put_p99"),)."""

    name: str
    rule: str
    actuator: str
    match_labels: tuple = ()
    cooldown_s: float = 60.0
    settle_s: float = 30.0
    description: str = ""

    def matches(self, report: dict) -> bool:
        if report.get("name") != self.rule:
            return False
        labels = report.get("labels") or {}
        for k, v in self.match_labels:
            got = str(labels.get(k, ""))
            # a trailing * prefix-matches (per-tenant SLO names like
            # qos_throttle:<tenant> are one binding, not one per tenant)
            if v.endswith("*"):
                if not got.startswith(v[:-1]):
                    return False
            elif got != v:
                return False
        return True


@dataclass
class Actuator:
    """A named remediation. `apply(fingerprint, report)` performs the
    nudge and returns an undo token; `rollback(token)` (optional)
    reverses it — knob nudges are reversible, replica moves are not, and
    the strict-improvement gate records which it got."""

    name: str
    apply: object  # callable(fp, report) -> undo token
    rollback: object = None  # callable(token) | None
    description: str = ""


class Autopilot:
    """The decision pipeline + safety gates + decision ring."""

    DECISIONS_KEEP = 64

    def __init__(self, bindings: list[Binding] | None = None,
                 actuators: dict[str, Actuator] | None = None, *,
                 budget_per_hour: int | None = None,
                 flap_window_s: float | None = None,
                 flap_backoff_s: float | None = None,
                 dry_run: bool = False, enabled: bool = True,
                 clock=time.monotonic):
        self.bindings: list[Binding] = list(bindings or [])
        self.actuators: dict[str, Actuator] = dict(actuators or {})
        self.budget_per_hour = int(
            budget_per_hour if budget_per_hour is not None
            else _env_f("CFS_AUTOPILOT_BUDGET", 6))
        self.flap_window_s = float(
            flap_window_s if flap_window_s is not None
            else _env_f("CFS_AUTOPILOT_FLAP_S", 120.0))
        self.flap_backoff_s = float(
            flap_backoff_s if flap_backoff_s is not None
            else _env_f("CFS_AUTOPILOT_BACKOFF_S", 60.0))
        self.dry_run = bool(dry_run)
        self.enabled = bool(enabled)
        self._clock = clock
        self._lock = SanitizedLock(name="autopilot.controller")
        self._decisions: list[dict] = []      # bounded ring, newest last
        self._budget_stamps: list[float] = []  # mono stamps of real actions
        self._cooldown_until: dict[str, float] = {}   # actuator -> mono
        # flap state per fingerprint: resolved_at (mono), flaps (count),
        # blocked_until (mono) — exponential back-off lives here
        self._flap: dict[str, dict] = {}
        # strict-improvement gates: fp -> pending action awaiting resolve
        self._pending: dict[str, dict] = {}
        self._rollup_firing: set[str] = set()
        self._attached = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # the bounded-label contract: decision is a closed vocabulary,
        # a typo'd decision string fails at the metric call
        from chubaofs_tpu_torch.utils.exporter import declare_label_values

        declare_label_values("decision", DECISIONS)
        self._publish_gauges()

    # -- metrics ---------------------------------------------------------------

    def _registry(self):
        from chubaofs_tpu_torch.utils.exporter import registry

        return registry("autopilot")

    def _publish_gauges(self) -> None:
        reg = self._registry()
        reg.gauge("armed").set(1.0 if self.enabled else 0.0)
        reg.gauge("budget_remaining").set(float(self._budget_remaining()))

    def _budget_remaining(self) -> int:
        now = self._clock()
        with self._lock:
            self._budget_stamps = [t for t in self._budget_stamps
                                   if now - t < BUDGET_WINDOW_S]
            return max(0, self.budget_per_hour - len(self._budget_stamps))

    # -- decision ring ---------------------------------------------------------

    def _record(self, decision: str, fp: str, report: dict,
                binding: Binding | None = None, **extra) -> dict:
        rec = {"ts": time.time(), "decision": decision, "fingerprint": fp,
               "rule": report.get("name", ""),
               "binding": binding.name if binding else "",
               "actuator": binding.actuator if binding else ""}
        rec.update(extra)
        with self._lock:
            self._decisions.append(rec)
            if len(self._decisions) > self.DECISIONS_KEEP:
                del self._decisions[: len(self._decisions)
                                    - self.DECISIONS_KEEP]
        self._registry().counter("decisions", {"decision": decision}).add()
        return rec

    def _emit_decision(self, etype: str, decision: str, fp: str,
                       report: dict, binding: Binding | None = None,
                       severity: str = events.SEV_INFO, **extra) -> dict:
        rec = self._record(decision, fp, report, binding, **extra)
        detail = {k: v for k, v in rec.items() if k != "ts"}
        events.emit(etype, severity,
                    entity=binding.name if binding else report.get("name", ""),
                    detail=detail)
        return rec

    # -- lifecycle entry points ------------------------------------------------

    def observe_firing(self, fp: str, report: dict) -> None:
        """The firing-edge entry point (alert hook / rollup feed). Runs
        the full pipeline: match → flap damper → cooldown → budget →
        execute (or dry-run) → arm the strict-improvement gate."""
        if not self.enabled:
            return
        self.tick()  # sweep overdue settle gates before deciding anew
        for binding in self.bindings:
            if binding.matches(report):
                self._decide(binding, fp, report)

    def observe_resolved(self, fp: str, report: dict) -> None:
        """The resolved edge: confirms a pending nudge (strict
        improvement) and starts the flap clock for this fingerprint."""
        now = self._clock()
        with self._lock:
            st = self._flap.setdefault(fp, {"flaps": 0, "blocked_until": 0.0})
            st["resolved_at"] = now
            pending = self._pending.pop(fp, None)
        if pending is not None:
            self._record("confirmed", fp, report, pending["binding"],
                         settle_s=round(now - pending["applied_at"], 3))

    def _decide(self, binding: Binding, fp: str, report: dict) -> None:
        self._emit_decision("autopilot_considered", "considered", fp,
                            report, binding)
        now = self._clock()
        damp: tuple[str, dict] | None = None
        with self._lock:
            st = self._flap.get(fp)
            if st is not None:
                resolved_at = st.get("resolved_at")
                if resolved_at is not None \
                        and now - resolved_at < self.flap_window_s:
                    # firing→resolved→firing inside the window: a flap.
                    # Exponential back-off, capped.
                    st["flaps"] += 1
                    backoff = min(
                        self.flap_backoff_s * (2 ** (st["flaps"] - 1)),
                        MAX_BACKOFF_S)
                    st["blocked_until"] = max(st["blocked_until"],
                                              now + backoff)
                    st.pop("resolved_at", None)
                    damp = ("flap", {"flaps": st["flaps"],
                                     "backoff_s": round(backoff, 3)})
                else:
                    if resolved_at is not None:
                        # a stable resolution ends the flap episode
                        st["flaps"] = 0
                        st.pop("resolved_at", None)
                    if now < st.get("blocked_until", 0.0):
                        damp = ("backoff",
                                {"remaining_s":
                                 round(st["blocked_until"] - now, 3)})
            if damp is None:
                until = self._cooldown_until.get(binding.actuator, 0.0)
                if now < until:
                    damp = ("cooldown",
                            {"remaining_s": round(until - now, 3)})
                elif fp in self._pending:
                    # a nudge for this alert is already settling — one
                    # gate per fingerprint, no stacked actions
                    damp = ("settling", {})
        if damp is not None:
            reason, extra = damp
            sev = events.SEV_WARNING if reason == "flap" else events.SEV_INFO
            self._emit_decision("autopilot_damped", "damped", fp, report,
                                binding, severity=sev, reason=reason,
                                **extra)
            return
        if not self.dry_run and self._budget_remaining() <= 0:
            self._emit_decision("autopilot_refused", "refused", fp, report,
                                binding, severity=events.SEV_WARNING,
                                reason="budget",
                                budget_per_hour=self.budget_per_hour)
            self._publish_gauges()
            return
        self._execute(binding, fp, report)

    def _execute(self, binding: Binding, fp: str, report: dict) -> None:
        """Run (or dry-run) the bound actuator. obslint rule 9 contract:
        the actuator invocation and its autopilot_* emit share this
        function — no silent actions."""
        act = self.actuators.get(binding.actuator)
        now = self._clock()
        if self.dry_run:
            self._emit_decision("autopilot_executed", "executed", fp,
                                report, binding, dry_run=True,
                                available=act is not None)
            return
        if act is None:
            self._emit_decision("autopilot_executed", "error", fp, report,
                                binding, severity=events.SEV_WARNING,
                                error=f"actuator {binding.actuator!r} "
                                      "not registered")
            return
        with self._lock:
            self._cooldown_until[binding.actuator] = now + binding.cooldown_s
            self._budget_stamps.append(now)
        try:
            undo = act.apply(fp, report)
        except Exception as e:
            self._emit_decision("autopilot_executed", "error", fp, report,
                                binding, severity=events.SEV_WARNING,
                                error=str(e))
            self._publish_gauges()
            return
        with self._lock:
            self._pending[fp] = {"binding": binding, "undo": undo,
                                 "applied_at": now,
                                 "deadline": now + binding.settle_s,
                                 "report": dict(report)}
        self._emit_decision("autopilot_executed", "executed", fp, report,
                            binding, dry_run=False,
                            reversible=act.rollback is not None,
                            settle_s=binding.settle_s,
                            budget_remaining=self._budget_remaining())
        self._publish_gauges()

    # -- strict-improvement sweep ----------------------------------------------

    def tick(self) -> int:
        """Roll back pending nudges whose settle window expired with the
        alert still firing (the strict-improvement gate). Returns the
        number of rollbacks. Call-driven (every observe) plus the armed
        periodic thread; obslint rule 9: rollback and its emit share
        this function."""
        now = self._clock()
        with self._lock:
            due = [(fp, p) for fp, p in self._pending.items()
                   if now >= p["deadline"]]
            for fp, _ in due:
                del self._pending[fp]
        for fp, p in due:
            binding = p["binding"]
            act = self.actuators.get(binding.actuator)
            reversed_ok, err = False, ""
            if act is not None and act.rollback is not None:
                try:
                    act.rollback(p["undo"])
                    reversed_ok = True
                except Exception as e:
                    err = str(e)
            with self._lock:
                # a nudge that did not help must not immediately re-run:
                # the failed fingerprint inherits the flap back-off clock
                st = self._flap.setdefault(
                    fp, {"flaps": 0, "blocked_until": 0.0})
                st["blocked_until"] = max(st["blocked_until"],
                                          now + self.flap_backoff_s)
            self._emit_decision(
                "autopilot_rolled_back", "rolled_back", fp, p["report"],
                binding, severity=events.SEV_WARNING, reversed=reversed_ok,
                **({"error": err} if err else {}))
        if due:
            self._publish_gauges()
        return len(due)

    # -- console-fed mode ------------------------------------------------------

    def observe_rollup(self, alerts: list[dict]) -> None:
        """Feed one /api/alerts rollup poll: the controller dedups the
        firing↔resolved edges by fingerprint itself (the console-fed
        capacity-harness mode, where no in-process hook exists)."""
        from chubaofs_tpu_torch.utils.alerts import STATE_FIRING, fingerprint

        now_firing: dict[str, dict] = {}
        for rep in alerts or []:
            if rep.get("state") == STATE_FIRING and not rep.get("silenced"):
                fp = fingerprint(rep.get("name", ""), rep.get("labels"))
                now_firing[fp] = rep
        with self._lock:
            prev = set(self._rollup_firing)
            self._rollup_firing = set(now_firing)
        for fp, rep in now_firing.items():
            if fp not in prev:
                self.observe_firing(fp, rep)
        for fp in prev - set(now_firing):
            name = fp.split("|", 1)[0]
            self.observe_resolved(fp, {"name": name})
        self.tick()

    # -- in-process hook subscription ------------------------------------------

    def attach(self) -> "Autopilot":
        from chubaofs_tpu_torch.utils import alerts

        if not self._attached:
            alerts.on_firing(self.observe_firing)
            alerts.on_resolved(self.observe_resolved)
            self._attached = True
        return self

    def detach(self) -> None:
        from chubaofs_tpu_torch.utils import alerts

        if self._attached:
            alerts.remove_firing_hook(self.observe_firing)
            alerts.remove_resolved_hook(self.observe_resolved)
            self._attached = False

    # -- registration ----------------------------------------------------------

    def register(self, actuator: Actuator,
                 bindings: list[Binding] | None = None) -> None:
        """Late-bind an actuator (daemons register theirs after boot —
        the master adds rebalance/split once its raft group is up)."""
        with self._lock:
            self.actuators[actuator.name] = actuator
            for b in bindings or []:
                if all(x.name != b.name for x in self.bindings):
                    self.bindings.append(b)

    # -- control + report surface ----------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = bool(enabled)
        self._publish_gauges()

    def set_dry_run(self, dry_run: bool) -> None:
        self.dry_run = bool(dry_run)

    def status(self) -> dict:
        """The /autopilot payload: armed bindings, cooldown clocks,
        remaining budget, pending settle gates, last N decisions."""
        now = self._clock()
        with self._lock:
            cooldowns = {name: round(until - now, 3)
                         for name, until in self._cooldown_until.items()
                         if until > now}
            pending = [{"fingerprint": fp, "binding": p["binding"].name,
                        "actuator": p["binding"].actuator,
                        "settle_remaining_s": round(p["deadline"] - now, 3)}
                       for fp, p in self._pending.items()]
            decisions = [dict(d) for d in self._decisions]
        return {"enabled": self.enabled, "dry_run": self.dry_run,
                "budget": {"per_hour": self.budget_per_hour,
                           "used": self.budget_per_hour
                                   - self._budget_remaining(),
                           "remaining": self._budget_remaining()},
                "bindings": [{"name": b.name, "rule": b.rule,
                              "labels": dict(b.match_labels),
                              "actuator": b.actuator,
                              "armed": b.actuator in self.actuators,
                              "cooldown_s": b.cooldown_s,
                              "settle_s": b.settle_s,
                              "description": b.description}
                             for b in self.bindings],
                "actuators": sorted(self.actuators),
                "cooldowns": cooldowns, "pending": pending,
                "decisions": decisions}

    # -- periodic settle sweep (the metrichist arming discipline) --------------

    @property
    def armed(self) -> bool:
        return self._thread is not None

    def start(self, period_s: float) -> "Autopilot":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _run():
            while not self._stop.wait(period_s):
                try:
                    self.tick()
                except Exception:
                    pass  # one bad sweep must not kill the gate thread

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="cfs-autopilot")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.detach()


# -- process-wide default ------------------------------------------------------

_default: Autopilot | None = None
_dlock = threading.Lock()


def enabled_from_env() -> bool:
    return (os.environ.get("CFS_AUTOPILOT", "") or "").lower() \
        in ("1", "true", "on", "yes")


def default_controller() -> Autopilot:
    """The process controller, created on first use (disabled until
    CFS_AUTOPILOT arms it or /autopilot op=enable flips it)."""
    from chubaofs_tpu_torch.autopilot.actuators import default_bindings

    global _default
    with _dlock:
        if _default is None:
            _default = Autopilot(
                bindings=default_bindings(),
                enabled=enabled_from_env(),
                dry_run=(os.environ.get("CFS_AUTOPILOT_DRY", "") or "")
                .lower() in ("1", "true", "on", "yes"))
        return _default


def activate_from_env() -> Autopilot | None:
    """Daemon-boot hook (rpc/server.py): arm the controller iff
    CFS_AUTOPILOT asks for it — unset env means no controller object, no
    hook subscription, no thread (zero overhead, the metrichist
    discipline). Daemons register their actuators afterwards."""
    if not enabled_from_env():
        return _default
    ap = default_controller().attach()
    return ap.start(_env_f("CFS_AUTOPILOT_TICK_S", 5.0))


def deactivate() -> None:
    """Stop + forget the process controller (test isolation)."""
    global _default
    with _dlock:
        ap, _default = _default, None
    if ap is not None:
        ap.stop()


def autopilot_status() -> dict:
    """The /autopilot payload for THIS process; a never-created
    controller reports disarmed without minting one."""
    with _dlock:
        ap = _default
    if ap is None:
        return {"enabled": False, "dry_run": False, "bindings": [],
                "actuators": [], "cooldowns": {}, "pending": [],
                "decisions": [],
                "budget": {"per_hour": 0, "used": 0, "remaining": 0}}
    return ap.status()
