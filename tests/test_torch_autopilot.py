"""The cases of tests/test_autopilot.py that need only the port's modules,
run against the port.

Binding label matching; the decision pipeline (considered -> executed ->
confirmed) with its typed autopilot_* events carrying the causal
fingerprint; the safety gates (strict-improvement settle/rollback,
cooldown, settling dedup, flap back-off, the sliding-hour budget, dry-run);
int-safe knob nudges and the master actuators' leader gate (on a fake
master); the alerts.on_firing/on_resolved hooks through a real
AlertManager; rollup-fed edge dedup (observe_rollup); and the flight
recorder's autopilot section; cfs-top's AUTO cell, and cfs-events' cause ->
action -> resolution chain, by library and over a daemon's /events; the
/autopilot side-door through the port's console and cfs-cli."""

import io
import json
import time
import urllib.error
import urllib.request

import pytest

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.autopilot import actuators as apa
from chubaofs_tpu_torch.autopilot import controller as apc
from chubaofs_tpu_torch.autopilot.controller import Actuator, Autopilot, Binding
from chubaofs_tpu_torch.utils import alerts, events


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture
def journal(tmp_path):
    """Fresh journal bound to a tmpdir (the test_events fixture contract);
    the process default controller is also dropped so env-armed state
    can't leak across tests."""
    from chubaofs_tpu_torch.utils import metrichist

    j = events.configure(logdir=str(tmp_path / "events"), role="test",
                         addr="t:0")
    yield j
    apc.deactivate()
    events.reset()
    alerts.deactivate()
    metrichist.deactivate()


class FakeClock:
    def __init__(self, now: float = 1000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


def _recording_actuator(name="nudge", fail=False, reversible=True):
    calls = {"applied": [], "rolled_back": []}

    def apply(fp, report):
        if fail:
            raise RuntimeError("actuator exploded")
        calls["applied"].append(fp)
        return {"undo": len(calls["applied"])}

    def rollback(token):
        calls["rolled_back"].append(token)

    return Actuator(name=name, apply=apply,
                    rollback=rollback if reversible else None,
                    description="test nudge"), calls


def _mkap(clock, *, cooldown_s=0.0, settle_s=30.0, **kw):
    act, calls = _recording_actuator()
    ap = Autopilot(
        bindings=[Binding(name="b-hot", rule="slo_failing",
                          actuator=act.name,
                          match_labels=(("slo", "put_p99"),),
                          cooldown_s=cooldown_s, settle_s=settle_s)],
        actuators={act.name: act}, clock=clock, **kw)
    return ap, calls


REPORT = {"name": "slo_failing", "labels": {"slo": "put_p99"},
          "state": "firing", "severity": "critical"}


def _decisions(ap):
    return [d["decision"] for d in ap.status()["decisions"]]


def test_binding_label_matching():
    b = Binding(name="b", rule="slo_failing", actuator="a",
                match_labels=(("slo", "put_p99"),))
    assert b.matches({"name": "slo_failing", "labels": {"slo": "put_p99"}})
    assert not b.matches({"name": "slo_failing",
                          "labels": {"slo": "get_p99"}})
    assert not b.matches({"name": "other", "labels": {"slo": "put_p99"}})
    assert not b.matches({"name": "slo_failing"})  # no labels at all
    # trailing * is a prefix arm: one binding covers per-tenant SLO names
    t = Binding(name="t", rule="slo_failing", actuator="a",
                match_labels=(("slo", "qos_throttle:*"),))
    assert t.matches({"name": "slo_failing",
                      "labels": {"slo": "qos_throttle:t7"}})
    assert not t.matches({"name": "slo_failing",
                          "labels": {"slo": "put_p99"}})


def test_fire_execute_confirm_pipeline(journal):
    clock = FakeClock()
    ap, calls = _mkap(clock, budget_per_hour=3)
    seq0 = journal.last_seq()
    fp = alerts.fingerprint("slo_failing", REPORT["labels"])
    ap.observe_firing(fp, REPORT)
    assert calls["applied"] == [fp]
    assert _decisions(ap) == ["considered", "executed"]
    st = ap.status()
    assert st["budget"] == {"per_hour": 3, "used": 1, "remaining": 2}
    assert [p["fingerprint"] for p in st["pending"]] == [fp]
    # the resolve edge confirms the pending nudge: strict improvement
    clock.advance(5.0)
    ap.observe_resolved(fp, REPORT)
    assert _decisions(ap) == ["considered", "executed", "confirmed"]
    conf = ap.status()["decisions"][-1]
    assert conf["settle_s"] == 5.0 and conf["actuator"] == "nudge"
    assert ap.status()["pending"] == []
    assert calls["rolled_back"] == []  # confirmed, never reversed
    # typed events carry the causal fingerprint end to end
    evs, _ = journal.query(since=seq0)
    typed = [(e["type"], e["detail"].get("fingerprint")) for e in evs
             if e["type"].startswith("autopilot_")]
    assert typed == [("autopilot_considered", fp),
                     ("autopilot_executed", fp)]
    ex = [e for e in evs if e["type"] == "autopilot_executed"][0]
    assert ex["detail"]["reversible"] is True
    assert ex["detail"]["binding"] == "b-hot"


def test_settle_expiry_rolls_back_and_inherits_backoff(journal):
    clock = FakeClock()
    ap, calls = _mkap(clock, settle_s=30.0, flap_backoff_s=60.0)
    fp = alerts.fingerprint("slo_failing", REPORT["labels"])
    ap.observe_firing(fp, REPORT)
    assert calls["applied"] == [fp]
    # settle window still open: nothing to sweep
    clock.advance(10.0)
    assert ap.tick() == 0
    # ...expired without a resolve: the nudge did not help — reverse it
    clock.advance(25.0)
    assert ap.tick() == 1
    assert calls["rolled_back"] == [{"undo": 1}]
    last = ap.status()["decisions"][-1]
    assert last["decision"] == "rolled_back" and last["reversed"] is True
    evs, _ = journal.query(types=("autopilot_rolled_back",))
    assert evs and evs[-1]["severity"] == events.SEV_WARNING
    # the failed fingerprint inherits a back-off block: an immediate
    # re-fire is damped, not re-actuated
    ap.observe_firing(fp, REPORT)
    assert calls["applied"] == [fp]  # no second apply
    last = ap.status()["decisions"][-1]
    assert last["decision"] == "damped" and last["reason"] == "backoff"


def test_flap_backoff_doubles(journal):
    clock = FakeClock()
    ap, calls = _mkap(clock, flap_window_s=100.0, flap_backoff_s=10.0,
                      budget_per_hour=50)
    fp = alerts.fingerprint("slo_failing", REPORT["labels"])
    ap.observe_firing(fp, REPORT)
    clock.advance(1.0)
    ap.observe_resolved(fp, REPORT)  # confirmed; flap clock starts
    backoffs = []
    for _ in range(3):
        clock.advance(5.0)  # well inside the flap window
        ap.observe_firing(fp, REPORT)
        last = ap.status()["decisions"][-1]
        assert last["decision"] == "damped" and last["reason"] == "flap"
        backoffs.append(last["backoff_s"])
        clock.advance(1.0)
        ap.observe_resolved(fp, REPORT)
    assert backoffs == [10.0, 20.0, 40.0]  # exponential, per flap count
    assert calls["applied"] == [fp]  # the flapping alert got ONE action
    evs, _ = journal.query(types=("autopilot_damped",))
    assert all(e["severity"] == events.SEV_WARNING for e in evs)
    # a stable resolution (outside the window) ends the episode, but the
    # accumulated block must still drain before the next action
    clock.advance(200.0)
    ap.observe_firing(fp, REPORT)
    assert ap.status()["decisions"][-1]["decision"] == "executed"


def test_budget_is_a_sliding_hour(journal):
    clock = FakeClock()
    act, calls = _recording_actuator()
    mk = lambda i: Binding(name=f"b{i}", rule=f"rule{i}",
                           actuator=act.name, cooldown_s=0.0)
    ap = Autopilot(bindings=[mk(i) for i in range(4)],
                   actuators={act.name: act}, budget_per_hour=2,
                   clock=clock)
    for i in range(3):
        ap.observe_firing(f"fp{i}", {"name": f"rule{i}"})
        clock.advance(1.0)
    assert len(calls["applied"]) == 2  # never more than the budget
    assert _decisions(ap)[-1] == "refused"
    refused = ap.status()["decisions"][-1]
    assert refused["reason"] == "budget"
    evs, _ = journal.query(types=("autopilot_refused",))
    assert evs and evs[-1]["severity"] == events.SEV_WARNING
    # the window slides: an hour later the stamps expire and arm 3 runs
    clock.advance(3600.0)
    ap.observe_firing("fp3", {"name": "rule3"})
    assert len(calls["applied"]) == 3
    assert ap.status()["budget"]["used"] == 1


def test_dry_run_logs_but_never_acts(journal):
    clock = FakeClock()
    ap, calls = _mkap(clock, dry_run=True, budget_per_hour=2)
    fp = alerts.fingerprint("slo_failing", REPORT["labels"])
    ap.observe_firing(fp, REPORT)
    assert calls["applied"] == []  # shadow mode: decision only
    st = ap.status()
    assert st["dry_run"] is True
    assert st["budget"]["used"] == 0 and st["pending"] == []
    assert st["cooldowns"] == {}
    ex = st["decisions"][-1]
    assert ex["decision"] == "executed" and ex["dry_run"] is True
    assert ex["available"] is True


def test_missing_and_exploding_actuators_are_error_decisions(journal):
    clock = FakeClock()
    ap = Autopilot(bindings=[Binding(name="b", rule="r",
                                     actuator="ghost", cooldown_s=0.0)],
                   clock=clock)
    ap.observe_firing("fp-a", {"name": "r"})
    last = ap.status()["decisions"][-1]
    assert last["decision"] == "error"
    assert "not registered" in last["error"]
    assert ap.status()["budget"]["used"] == 0  # nothing ran
    # a raising actuator is an error decision too — and it DID consume
    # budget (the attempt was real), with no pending gate left behind
    boom, _ = _recording_actuator(name="boom", fail=True)
    ap.register(boom, [Binding(name="b2", rule="r2", actuator="boom",
                               cooldown_s=0.0)])
    ap.observe_firing("fp-b", {"name": "r2"})
    last = ap.status()["decisions"][-1]
    assert last["decision"] == "error" and "exploded" in last["error"]
    assert ap.status()["budget"]["used"] == 1
    assert ap.status()["pending"] == []


def test_cooldown_and_settling_gates(journal):
    clock = FakeClock()
    act, calls = _recording_actuator()
    ap = Autopilot(
        bindings=[Binding(name="b", rule="r", actuator=act.name,
                          cooldown_s=40.0, settle_s=300.0)],
        actuators={act.name: act}, budget_per_hour=10, clock=clock)
    ap.observe_firing("fp-one", {"name": "r"})
    assert len(calls["applied"]) == 1
    # a DIFFERENT alert instance hits the same actuator's cooldown
    clock.advance(5.0)
    ap.observe_firing("fp-two", {"name": "r"})
    last = ap.status()["decisions"][-1]
    assert last["decision"] == "damped" and last["reason"] == "cooldown"
    assert last["remaining_s"] == pytest.approx(35.0)
    # the SAME fingerprint past the cooldown is still settling: one gate
    # per fingerprint, no stacked nudges
    clock.advance(40.0)
    ap.observe_firing("fp-one", {"name": "r"})
    last = ap.status()["decisions"][-1]
    assert last["decision"] == "damped" and last["reason"] == "settling"
    assert len(calls["applied"]) == 1


def test_disabled_controller_decides_nothing(journal):
    clock = FakeClock()
    ap, calls = _mkap(clock, enabled=False)
    ap.observe_firing("fp", REPORT)
    assert calls["applied"] == [] and _decisions(ap) == []
    ap.set_enabled(True)
    ap.observe_firing(alerts.fingerprint("slo_failing", REPORT["labels"]),
                      REPORT)
    assert len(calls["applied"]) == 1


def test_knob_nudge_is_int_safe_and_reversible():
    class Box:
        promote_hits = 4

    box = Box()
    act = apa.cache_promote_nudge(box)
    undo = act.apply("fp", {})
    assert box.promote_hits == 2 and isinstance(box.promote_hits, int)
    act.rollback(undo)
    assert box.promote_hits == 4
    # the floor stops the halving: a knob at 1 stays 1
    box.promote_hits = 1
    act.apply("fp", {})
    assert box.promote_hits == 1


def test_master_actuators_gate_on_raft_leadership():
    moves = []

    class FakeMaster:
        is_leader = False

        def rebalance_hot(self, factor=1.2, max_moves=2):
            moves.append(("hot", factor, max_moves))
            return 1

        def rebalance_meta(self, factor=1.2, max_moves=2):
            moves.append(("meta", factor, max_moves))
            return 0

    m = FakeMaster()
    acts = {a.name: a for a in apa.master_actuators(m, max_moves=2)}
    assert "rebalance_hot" in acts and "rebalance_meta" in acts
    with pytest.raises(RuntimeError, match="leader"):
        acts["rebalance_hot"].apply("fp", {})
    assert moves == []  # a follower never sweeps
    m.is_leader = True
    assert acts["rebalance_hot"].apply("fp", {}) == {"moved": 1}
    assert acts["rebalance_hot"].rollback is None  # irreversible
    assert moves == [("hot", 1.2, 2)]


def _snap(metrics: dict, mono: float) -> dict:
    return {"ts": time.time(), "mono": mono, "metrics": dict(metrics),
            "types": {}}


def test_alertmanager_hooks_drive_the_pipeline(journal):
    """End to end on the REAL firing/resolved edges: an AlertManager
    transition invokes the attached controller's hooks — the in-daemon
    wiring, no rollup polling in between."""
    clock = FakeClock()
    act, calls = _recording_actuator()
    ap = Autopilot(
        bindings=[Binding(name="b-disks", rule="broken_disks",
                          actuator=act.name, cooldown_s=0.0)],
        actuators={act.name: act}, clock=clock).attach()
    am = alerts.AlertManager(rules=[alerts.AlertRule(
        "broken_disks", "gauge_sum", family="cfs_clustermgr_disks",
        label_in=("status", ("broken",)), threshold=0.0)])
    try:
        broken = {'cfs_clustermgr_disks{status="broken"}': 2.0}
        am.evaluate([_snap(broken, 1.0)])
        fp = alerts.fingerprint("broken_disks", {})
        assert calls["applied"] == [fp]
        # still breaching: no second transition, no second action
        am.evaluate([_snap(broken, 2.0)])
        assert calls["applied"] == [fp]
        clock.advance(3.0)
        am.evaluate([_snap(
            {'cfs_clustermgr_disks{status="broken"}': 0.0}, 3.0)])
        assert _decisions(ap)[-1] == "confirmed"
        assert ap.status()["pending"] == []
    finally:
        ap.detach()


def test_observe_rollup_dedups_edges(journal):
    """The console-fed mode: the controller diffs consecutive rollup
    polls into firing/resolved edges itself."""
    clock = FakeClock()
    ap, calls = _mkap(clock, cooldown_s=0.0)
    rep = dict(REPORT, silenced=False)
    ap.observe_rollup([rep])
    fp = alerts.fingerprint("slo_failing", REPORT["labels"])
    assert calls["applied"] == [fp]
    # the same alert on the next poll is NOT a new edge
    ap.observe_rollup([rep])
    assert calls["applied"] == [fp]
    assert _decisions(ap).count("considered") == 1
    # a silenced alert never reaches the pipeline
    ap.observe_rollup([rep, dict(REPORT, silenced=True,
                                 labels={"slo": "get_p99"})])
    assert _decisions(ap).count("considered") == 1
    # vanishing from the rollup is the resolve edge -> confirmed
    clock.advance(2.0)
    ap.observe_rollup([])
    assert _decisions(ap)[-1] == "confirmed"


def test_flightrec_bundle_freezes_autopilot_state(tmp_path, journal):
    from chubaofs_tpu_torch.utils import flightrec

    clock = FakeClock()
    ap, _ = _mkap(clock)
    try:
        # arm the process default so the gatherer sees live state
        apc._default = ap
        fp = alerts.fingerprint("slo_failing", REPORT["labels"])
        ap.observe_firing(fp, REPORT)
        man = flightrec.FlightRecorder(
            root=str(tmp_path / "fr")).capture(trigger="manual")
        assert man["sections"]["autopilot"] == "ok"
        payload = json.load(open(
            f"{man['bundle']}/autopilot.json"))
        assert payload["enabled"] is True
        assert [d["decision"] for d in payload["decisions"]] == [
            "considered", "executed"]
        assert payload["decisions"][-1]["fingerprint"] == fp
    finally:
        apc._default = None


def test_cfstop_auto_row_math():
    from chubaofs_tpu_torch.tools import cfstop

    armed = {"cfs_autopilot_armed": 1.0,
             "cfs_autopilot_budget_remaining": 4.0,
             'cfs_autopilot_decisions{decision="executed"}': 7.0,
             'cfs_autopilot_decisions{decision="considered"}': 20.0}
    prev = dict(armed, **{
        'cfs_autopilot_decisions{decision="executed"}': 5.0})
    row = cfstop.compute_row("t:1", prev, armed, 10.0, {"status": "ok"})
    assert row["auto_armed"] is True
    assert row["auto_budget"] == 4
    # only the executed slice counts, not considered/damped chatter
    assert row["auto_acts"] == 2
    assert cfstop._auto_cell(row) == "2/4"
    # restart clamp: the counter fell -> post-restart total is the window
    restarted = dict(armed, **{
        'cfs_autopilot_decisions{decision="executed"}': 1.0})
    row = cfstop.compute_row("t:1", armed, restarted, 10.0,
                             {"status": "ok"})
    assert row["auto_acts"] == 1
    # a disarmed target renders '-', not 0/0
    row = cfstop.compute_row("t:2", {}, {"cfs_put_ops": 3.0}, 10.0,
                             {"status": "ok"})
    assert row["auto_armed"] is False
    assert row["auto_budget"] is None and row.get("auto_acts") is None
    assert cfstop._auto_cell(row) == "-"
    assert "AUTO" in cfstop.COLUMNS


def test_correlate_alert_chain_orders_cause_action_resolution():
    from chubaofs_tpu_torch.tools import cfsevents

    fp = alerts.fingerprint("slo_failing", {"slo": "put_p99"})
    evs = [
        {"ts": 10.0, "type": "alert_firing", "severity": "critical",
         "entity": "slo_failing", "role": "master", "addr": "m:1",
         "detail": {"labels": {"slo": "put_p99"}}},
        {"ts": 10.5, "type": "autopilot_considered", "severity": "info",
         "entity": "b-hot", "role": "master", "addr": "m:1",
         "detail": {"fingerprint": fp, "decision": "considered"}},
        {"ts": 10.6, "type": "autopilot_executed", "severity": "info",
         "entity": "b-hot", "role": "master", "addr": "m:1",
         "detail": {"fingerprint": fp, "decision": "executed",
                    "actuator": "rebalance_hot"}},
        {"ts": 42.0, "type": "alert_resolved", "severity": "info",
         "entity": "slo_failing", "role": "master", "addr": "m:1",
         "detail": {"labels": {"slo": "put_p99"}}},
        # chaff: another rule's alert and an uncorrelated event
        {"ts": 11.0, "type": "alert_firing", "severity": "warning",
         "entity": "repair_backlog", "role": "master", "addr": "m:1",
         "detail": {"labels": {}}},
        {"ts": 12.0, "type": "task_finished", "severity": "info",
         "entity": "t1", "role": "master", "addr": "m:1", "detail": {}},
    ]
    chain = cfsevents.correlate_alert_chain(evs, fp)
    assert [it["kind"] for it in chain] == ["alert", "action", "action",
                                            "alert"]
    assert [it["record"]["type"] for it in chain] == [
        "alert_firing", "autopilot_considered", "autopilot_executed",
        "alert_resolved"]
    # dt is measured from the causal firing edge
    assert chain[0]["dt"] == 0.0 and "cause" in chain[0]["line"]
    assert chain[2]["dt"] == pytest.approx(0.6)
    assert chain[3]["dt"] == pytest.approx(32.0)
    assert "+32.000s" in chain[3]["line"]
    # an unknown fingerprint yields an empty chain (the CLI then falls
    # back to the trace-id join)
    assert cfsevents.correlate_alert_chain(evs, "nope|x") == []


def test_cfsevents_cli_correlates_by_fingerprint(journal):
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer
    from chubaofs_tpu_torch.tools import cfsevents

    srv = RPCServer(Router(), module="evap").start()
    try:
        clock = FakeClock()
        ap, _ = _mkap(clock)
        fp = alerts.fingerprint("slo_failing", REPORT["labels"])
        events.emit("alert_firing", "critical", entity="slo_failing",
                    detail={"labels": dict(REPORT["labels"])})
        ap.observe_firing(fp, REPORT)
        events.emit("alert_resolved", entity="slo_failing",
                    detail={"labels": dict(REPORT["labels"])})
        buf = io.StringIO()
        rc = cfsevents.main(["--addr", srv.addr, "--correlate", fp],
                            out=buf)
        text = buf.getvalue()
        assert rc == 0
        assert f"alert {fp}" in text and "resolved" in text
        assert "autopilot_executed" in text and "cause" in text
    finally:
        srv.stop()


def _get(addr: str, path: str) -> dict:
    return json.loads(urllib.request.urlopen(
        f"http://{addr}{path}", timeout=10).read())


def test_autopilot_side_door_console_and_cli(journal):
    from chubaofs_tpu_torch.cli.main import CLI
    from chubaofs_tpu_torch.console.server import Console
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer

    srv = RPCServer(Router(), module="aptest").start()
    console = Console([srv.addr])
    try:
        # disarmed process: the stub status, no controller minted
        st = _get(srv.addr, "/autopilot")
        assert st["enabled"] is False and st["bindings"] == []
        # op=dry-run arms shadow mode; op=enable goes live; op=disable
        # stands down — each answers with the fresh status
        st = _get(srv.addr, "/autopilot?op=dry-run")
        assert st["dry_run"] is True and st["enabled"] is True
        assert any(b["rule"] == "slo_failing" for b in st["bindings"])
        st = _get(srv.addr, "/autopilot?op=dry-run&off=1")
        assert st["dry_run"] is False
        st = _get(srv.addr, "/autopilot?op=disable")
        assert st["enabled"] is False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://{srv.addr}/autopilot?op=bogus", timeout=10)
        assert ei.value.code == 400
        st = _get(srv.addr, "/autopilot?op=enable")
        assert st["enabled"] is True
        assert st["budget"]["remaining"] == st["budget"]["per_hour"]
        # console rollup: per-target rows + cluster budget totals
        roll = _get(console.addr, "/api/autopilot")
        assert roll["enabled"] is True
        assert [r["target"] for r in roll["targets"]] == [srv.addr]
        assert roll["budget"]["per_hour"] == st["budget"]["per_hour"]
        # cfs-cli renders mode, budget and the binding table
        buf = io.StringIO()
        CLI([srv.addr], out=buf).autopilot_status(None)
        text = buf.getvalue()
        assert "Autopilot : enabled" in text
        assert "slo_failing" in text and "rebalance_hot" in text
    finally:
        console.stop()
        srv.stop()
