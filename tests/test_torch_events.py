"""The cases of tests/test_events.py that import only ported modules, run
against the port on the CPU.

Event journal (emit, query, cursor, ring + rotor), span-trace joins, the
alert rules (gauge, counter rate, event seen, SLO failing), silences,
clustermgr and SLO emitters, the RPCServer's event/alert routes, and the
cfs-top UP/ALERTS columns, the console rollup, the cfs-events CLI over
the port's console, and the capacity collector (the port's
tools/capacity.py) archiving the timeline."""

import io
import json
import time
import urllib.parse
import urllib.request

import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.utils import alerts, events
from chubaofs_tpu_torch.utils.exporter import registry
from chubaofs_tpu_torch.utils.metrichist import MetricHistory


CPU = "cpu"
# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture
def journal(tmp_path):
    """A fresh journal bound to a tmpdir; the process default is restored
    to a fresh tmp-bound one afterwards so cross-test seq state is gone.
    The default metric-history ring is dropped too: the on-demand /alerts
    evaluation records into it (by design — polling IS the cadence), and a
    snapshot left behind would make a LATER suite's /health compute burn
    windows across suite boundaries (the bench_capacity salting contract)."""
    from chubaofs_tpu_torch.utils import metrichist

    j = events.configure(logdir=str(tmp_path / "events"), role="test",
                         addr="t:0")
    yield j
    events.reset()
    alerts.deactivate()
    metrichist.deactivate()


# -- the journal ---------------------------------------------------------------


def test_journal_emit_query_and_counters(journal):
    seq0 = journal.last_seq()
    c0 = registry("events").counter(
        "total", {"type": "disk_status", "severity": "critical"}).value
    assert events.emit("disk_status", "critical", entity="disk7",
                       detail={"from": "normal", "to": "broken"})
    evs, cursor = journal.query(since=seq0)
    assert len(evs) == 1
    e = evs[0]
    assert e["type"] == "disk_status" and e["severity"] == "critical"
    assert e["entity"] == "disk7" and e["detail"]["to"] == "broken"
    assert e["role"] == "test" and e["addr"] == "t:0"
    assert e["ts"] > 0 and e["mono"] > 0 and e["seq"] == seq0 + 1
    assert cursor == seq0 + 1
    assert registry("events").counter(
        "total", {"type": "disk_status", "severity": "critical"}).value \
        == c0 + 1


def test_journal_rejects_unknown_type_but_emit_never_raises(journal):
    with pytest.raises(ValueError):
        journal.emit("not_a_type")
    with pytest.raises(ValueError):
        journal.emit("disk_status", severity="fatal")
    # the module-level wrapper swallows (it runs inside serve loops)
    assert events.emit("not_a_type") is False
    assert events.emit("disk_status", severity="fatal") is False


def test_journal_cursor_pagination_and_filters(journal):
    seq0 = journal.last_seq()
    for i in range(6):
        events.emit("lease_acquired" if i % 2 else "lease_expired",
                    "info" if i % 2 else "warning", entity=f"t{i}")
    page1, cur1 = journal.query(since=seq0, n=4)
    assert [e["entity"] for e in page1] == ["t0", "t1", "t2", "t3"]
    page2, cur2 = journal.query(since=cur1, n=4)
    assert [e["entity"] for e in page2] == ["t4", "t5"]
    # cursor is stable: re-polling from cur2 returns nothing new
    page3, cur3 = journal.query(since=cur2, n=4)
    assert page3 == [] and cur3 == cur2
    # type + severity filters still advance the cursor past skipped events
    only, cur = journal.query(since=seq0, types=("lease_expired",))
    assert [e["entity"] for e in only] == ["t0", "t2", "t4"]
    assert cur == cur2
    warn, _ = journal.query(since=seq0, severity=("warning",))
    assert len(warn) == 3


def test_journal_cursor_survives_daemon_restart(tmp_path):
    """seq is process-local: a cursor ahead of a FRESH journal's head means
    the daemon restarted — the query resets to the start instead of
    blinding the poller to the restart-era events forever."""
    j = events.EventJournal(str(tmp_path / "j"))
    j.emit("daemon_boot", entity="reborn")
    evs, cursor = j.query(since=5000)  # a previous life's cursor
    assert [e["entity"] for e in evs] == ["reborn"]
    assert cursor == 1
    assert j.query(since=cursor)[0] == []


def test_journal_ring_bounded_rotor_retains(tmp_path):
    j = events.EventJournal(str(tmp_path / "j"), ring_len=4)
    for i in range(10):
        j.emit("bench_tick", detail={"i": i})
    evs, _ = j.query()
    assert len(evs) == 4 and evs[0]["detail"]["i"] == 6  # ring kept newest
    # ...but the rotating JSONL trail kept everything (budget permitting)
    lines = j._rotor.read_lines()
    assert len(lines) == 10
    assert json.loads(lines[0])["detail"]["i"] == 0
    j.close()


def test_event_joins_live_span_trace(journal):
    from chubaofs_tpu_torch.blobstore import trace

    with trace.child_of(None, "repair.test") as span:
        trace.push_span(span)
        try:
            events.emit("task_finished", entity="t9",
                        detail={"kind": "disk_repair"})
        finally:
            trace.pop_span()
    evs, _ = journal.query(types=("task_finished",))
    assert evs[-1]["trace_id"] == span.trace_id


# -- the alert manager ---------------------------------------------------------


def _snap(metrics: dict, mono: float) -> dict:
    return {"ts": time.time(), "mono": mono, "metrics": dict(metrics),
            "types": {}}


def test_gauge_rule_fires_dedups_and_resolves(journal):
    am = alerts.AlertManager(rules=[alerts.AlertRule(
        "broken_disks", "gauge_sum", family="cfs_clustermgr_disks",
        label_in=("status", ("broken",)), threshold=0.0)])
    broken = {'cfs_clustermgr_disks{status="broken"}': 2.0}
    seq0 = journal.last_seq()
    rep = am.evaluate([_snap(broken, 1.0)])
    assert rep["firing"] == 1
    assert rep["alerts"][0]["name"] == "broken_disks"
    assert rep["alerts"][0]["state"] == "firing"
    assert rep["alerts"][0]["value"] == 2.0
    # still breaching: the SAME instance, no second firing transition
    rep = am.evaluate([_snap(broken, 2.0)])
    assert rep["firing"] == 1 and len(rep["alerts"]) == 1
    firing_events, _ = journal.query(since=seq0, types=("alert_firing",))
    assert len(firing_events) == 1  # fingerprint dedup
    # breach clears -> resolved, exactly one resolve event
    rep = am.evaluate([_snap({'cfs_clustermgr_disks{status="broken"}': 0.0},
                             3.0)])
    assert rep["firing"] == 0
    assert rep["alerts"][0]["state"] == "resolved"
    resolved, _ = journal.query(since=seq0, types=("alert_resolved",))
    assert len(resolved) == 1
    assert am.fired_names() == ["broken_disks"]
    # the firing gauge cfs-top's ALERTS column reads
    assert registry("alerts").gauge("firing").value == 0


def test_counter_rate_rule_windows(journal):
    am = alerts.AlertManager(rules=[alerts.AlertRule(
        "lease_expiry_rate", "counter_rate",
        family="cfs_scheduler_lease_expired", threshold=1.0)])
    # 10 expiries over 2s = 5/s > 1/s -> firing
    snaps = [_snap({"cfs_scheduler_lease_expired": 0.0}, 0.0),
             _snap({"cfs_scheduler_lease_expired": 10.0}, 2.0)]
    assert am.evaluate(snaps)["firing"] == 1
    # quiet window resolves it
    snaps = [_snap({"cfs_scheduler_lease_expired": 10.0}, 3.0),
             _snap({"cfs_scheduler_lease_expired": 10.0}, 5.0)]
    assert am.evaluate(snaps)["firing"] == 0


def test_event_seen_rule_fires_and_quiets(journal):
    am = alerts.AlertManager(
        rules=[alerts.AlertRule("lock_inversion", "event_seen",
                                event_type="lock_inversion", consecutive=2)],
        journal=journal)
    assert am.evaluate([])["firing"] == 0
    events.emit("lock_inversion", "critical", entity="a->b")
    assert am.evaluate([])["firing"] == 1
    # holds for one quiet pass, resolves after `consecutive` quiet passes
    assert am.evaluate([])["firing"] == 1
    assert am.evaluate([])["firing"] == 0


def test_slo_failing_rule_needs_consecutive_evals(journal, monkeypatch):
    # a tight PUT p99 objective + a latency histogram that breaches it
    monkeypatch.setenv("CFS_SLO_PUT_P99_MS", "1")
    am = alerts.AlertManager(rules=[alerts.AlertRule(
        "slo_failing", "slo_failing", consecutive=2)])
    bad = {}
    for i, mono in enumerate(range(0, 14)):
        bad[f"s{i}"] = None  # placeholder; real series below
    hist = 'cfs_access_put_bucket{le="0.25"}'

    def snaps_at(count: float, n: int = 14) -> list[dict]:
        # count grows across the window so the p99 delta lands in the
        # 250ms bucket every time — failing in both windows, sustained
        return [_snap({hist: count + i, "cfs_access_put_count": count + i},
                      float(i)) for i in range(n)]

    assert am.evaluate(snaps_at(10))["firing"] == 0  # streak 1 < 2
    rep = am.evaluate(snaps_at(30))
    assert rep["firing"] == 1
    assert rep["alerts"][0]["labels"] == {"slo": "put_p99"}


def test_private_manager_leaves_firing_gauge_alone(journal):
    """A soak probe's private manager must not clobber the
    cfs_alerts_firing series cfs-top scrapes (last-writer-wins would let
    the probe's table overwrite the serving manager's)."""
    registry("alerts").gauge("firing").set(7.0)
    am = alerts.AlertManager(rules=[alerts.AlertRule(
        "broken_disks", "gauge_sum", family="cfs_clustermgr_disks",
        label_in=("status", ("broken",)), threshold=0.0)], private=True)
    rep = am.evaluate([_snap({'cfs_clustermgr_disks{status="broken"}': 3.0},
                             1.0)])
    assert rep["firing"] == 1  # the probe still judges...
    assert registry("alerts").gauge("firing").value == 7.0  # ...quietly


def test_event_seen_cursor_starts_at_manager_birth(journal):
    """A stale inversion emitted by an earlier phase of the process must
    not fire a freshly constructed manager (order-dependent flake guard)."""
    events.emit("lock_inversion", "critical", entity="old->stale")
    am = alerts.AlertManager(
        rules=[alerts.AlertRule("lock_inversion", "event_seen",
                                event_type="lock_inversion")],
        journal=journal)
    assert am.evaluate([])["firing"] == 0
    events.emit("lock_inversion", "critical", entity="fresh->new")
    assert am.evaluate([])["firing"] == 1


def test_silence_suppresses_notification(journal):
    am = alerts.AlertManager(rules=[alerts.AlertRule(
        "broken_disks", "gauge_sum", family="cfs_clustermgr_disks",
        label_in=("status", ("broken",)), threshold=0.0)])
    am.silence("broken_disks", duration_s=60.0)
    seq0 = journal.last_seq()
    rep = am.evaluate([_snap({'cfs_clustermgr_disks{status="broken"}': 1.0},
                             1.0)])
    assert rep["firing"] == 1 and rep["alerts"][0]["silenced"]
    fired, _ = journal.query(since=seq0, types=("alert_firing",))
    assert fired == [] and am.fired_names() == []


# -- emitters ------------------------------------------------------------------


def test_clustermgr_disk_transitions_emit_and_gauge(tmp_path, journal):
    from chubaofs_tpu_torch.blobstore.clustermgr import ClusterMgr

    cm = ClusterMgr()
    cm.register_disks([{"disk_id": 1, "node_id": 1},
                       {"disk_id": 2, "node_id": 1}])
    assert registry("clustermgr").gauge(
        "disks", {"status": "normal"}).value == 2
    seq0 = journal.last_seq()
    cm.set_disk_status(1, "broken", reason="io_errors")
    evs, _ = journal.query(since=seq0, types=("disk_status",))
    assert len(evs) == 1
    assert evs[0]["severity"] == "critical"
    assert evs[0]["detail"] == {"disk_id": 1, "node_id": 1, "from": "normal",
                                "to": "broken", "reason": "io_errors"}
    assert registry("clustermgr").gauge(
        "disks", {"status": "broken"}).value == 1
    # idempotent re-set: no transition, no second event
    cm.set_disk_status(1, "broken")
    evs, _ = journal.query(since=seq0, types=("disk_status",))
    assert len(evs) == 1
    # the heartbeat-silence path tags its reason
    cm._hb_mono[2] = -1e9
    assert cm.expire_heartbeats(1.0) == [2]
    evs, _ = journal.query(since=seq0, types=("disk_status",))
    assert evs[-1]["detail"]["reason"] == "heartbeat_silence"
    assert registry("clustermgr").gauge(
        "disks", {"status": "broken"}).value == 2


def test_slo_flip_emits_event(journal, monkeypatch):
    from chubaofs_tpu_torch.utils import slo

    monkeypatch.setattr(slo, "_last_status", {})
    backlog = 'cfs_scheduler_tasks{kind="shard_repair",state="prepared"}'
    quiet = [_snap({backlog: 0.0}, float(i)) for i in range(14)]
    slo.evaluate(slo.default_slos(), quiet)  # seeds the status stream
    seq0 = journal.last_seq()
    burst = [_snap({backlog: 10_000.0}, float(i)) for i in range(14)]
    slo.evaluate(slo.default_slos(), burst)
    evs, _ = journal.query(since=seq0, types=("slo_flip",))
    assert len(evs) == 1
    assert evs[0]["entity"] == "repair_backlog"
    assert evs[0]["detail"]["from"] == "ok"
    assert evs[0]["detail"]["to"] == "failing"
    assert evs[0]["severity"] == "critical"
    # same status again: no new flip
    slo.evaluate(slo.default_slos(), burst)
    evs, _ = journal.query(since=seq0, types=("slo_flip",))
    assert len(evs) == 1


# -- daemon side-doors + boot gauges -------------------------------------------


def _get(addr: str, path: str) -> dict:
    return json.loads(urllib.request.urlopen(
        f"http://{addr}{path}", timeout=10).read())


def test_rpcserver_events_alerts_and_boot_gauges(journal):
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer

    srv = RPCServer(Router(), module="evtest").start()
    try:
        seq0 = 0
        out = _get(srv.addr, "/events?n=1000")
        boots = [e for e in out["events"] if e["type"] == "daemon_boot"
                 and e["detail"].get("addr") == srv.addr]
        assert boots, "RPCServer boot did not land on the timeline"
        assert boots[0]["detail"]["role"] == "evtest"
        cursor = out["cursor"]
        events.emit("scrub_finding", "warning", entity="node3")
        out = _get(srv.addr, f"/events?since={cursor}")
        assert [e["type"] for e in out["events"]] == ["scrub_finding"]
        # filters ride the query string
        out = _get(srv.addr, "/events?type=daemon_boot&severity=info&n=1000")
        assert out["events"] and all(e["type"] == "daemon_boot"
                                     for e in out["events"])
        # one-shot mode (no ?since=) serves the NEWEST page, and n=0 is an
        # empty window, never the whole-ring [-0:] slice
        out = _get(srv.addr, "/events?n=1")
        assert len(out["events"]) == 1
        assert out["events"][0]["type"] == "scrub_finding"  # the newest
        assert _get(srv.addr, "/events?n=0")["events"] == []
        # /alerts evaluates on demand when no periodic thread is armed
        out = _get(srv.addr, "/alerts")
        assert "alerts" in out and "firing" in out
        # boot gauges render on /metrics
        text = urllib.request.urlopen(
            f"http://{srv.addr}/metrics", timeout=10).read().decode()
        assert "cfs_boot_time_seconds" in text
        assert 'cfs_build_info{role="evtest"' in text
        from chubaofs_tpu_torch.tools.cfsstat import parse_metrics
        from chubaofs_tpu_torch.utils.metrichist import family_sum

        boot = family_sum(parse_metrics(text), "cfs_boot_time_seconds")
        assert 0 < boot <= time.time()
    finally:
        srv.stop()
        alerts.deactivate()


# -- console rollups (the partial-failure battery) ----------------------------


# -- cfs-events CLI ------------------------------------------------------------


# -- cfs-top: UP / ALERTS columns + boot-stamp restart cross-check -------------


def test_cfstop_up_alerts_and_restart_crosscheck():
    from chubaofs_tpu_torch.tools.cfstop import COLUMNS, compute_row, render

    assert "UP" in COLUMNS and "ALERTS" in COLUMNS
    now = time.time()
    prev = {"cfs_boot_time_seconds": now - 100.0,
            "cfs_access_put_count": 100.0}
    cur = {"cfs_boot_time_seconds": now - 100.0,
           "cfs_alerts_firing": 2.0,
           "cfs_access_put_count": 150.0}
    row = compute_row("t:1", prev, cur, 10.0, {"status": "ok"})
    assert 90 <= row["up_s"] <= 110
    assert row["alerts"] == 2
    assert not row.get("restart")
    # the boot stamp MOVED between frames: confirmed restart, tagged even
    # though no counter went negative (the boot-stamp cross-check)
    restarted = dict(cur, **{"cfs_boot_time_seconds": now - 1.0,
                             "cfs_access_put_count": 170.0})
    row = compute_row("t:1", prev, restarted, 10.0, {"status": "ok"})
    assert row["restart"] is True
    text = render([row])
    assert "(restart)" in text and "ALERTS" in text
    # no boot gauge exported: UP renders '-', nothing crashes
    bare = compute_row("t:2", None, {"cfs_access_put_count": 1.0}, 10.0,
                       {"status": "ok"})
    assert bare["up_s"] is None


# -- capacity collector archives the timeline ----------------------------------


def test_console_events_rollup_cursor_and_partial_failure(journal):
    """Cursor pagination stable across polls; an unreachable target is
    REPORTED (and its cursor never advances past events it might hold) —
    the /api/health partial-failure contract applied to the timeline."""
    from chubaofs_tpu_torch.console.server import Console
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer
    from chubaofs_tpu_torch.testing.harness import free_port

    srv = RPCServer(Router(), module="evroll").start()
    dead = f"127.0.0.1:{free_port()}"
    console = Console([srv.addr], metrics_addrs=[dead])
    try:
        out = _get(console.addr, "/api/events?n=1000")
        assert dead in out["unreachable"]
        assert any(e["type"] == "daemon_boot" for e in out["events"])
        assert all(e["target"] == srv.addr for e in out["events"])
        cursor = out["cursor"]
        assert cursor[srv.addr] > 0 and dead not in cursor
        # poll again with the cursor: nothing re-delivered
        q = urllib.parse.quote(json.dumps(cursor))
        out2 = _get(console.addr, f"/api/events?cursor={q}")
        assert out2["events"] == []
        # a new event arrives exactly once on the next poll
        events.emit("tier_promote", entity="blob(1,2)",
                    detail={"vid": 1, "bid": 2})
        out3 = _get(console.addr, f"/api/events?cursor={q}")
        assert [e["type"] for e in out3["events"]] == ["tier_promote"]
        q3 = urllib.parse.quote(json.dumps(out3["cursor"]))
        out4 = _get(console.addr, f"/api/events?cursor={q3}")
        assert out4["events"] == []
        # malformed cursors are a 400, not a 500 — not-JSON, non-dict, and
        # a null seq (TypeError path) alike
        for bad in ("notjson", urllib.parse.quote('[1,2]'),
                    urllib.parse.quote('{"t:1": null}')):
            req = urllib.request.Request(
                f"http://{console.addr}/api/events?cursor={bad}")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=10)
            assert ei.value.code == 400, bad
        # /api/alerts: the corpse shows as a failing row, never dropped
        roll = _get(console.addr, "/api/alerts")
        by_target = {t["target"]: t for t in roll["targets"]}
        assert by_target[dead]["unreachable"] is True
        assert dead in roll["unreachable"]
        assert by_target[srv.addr].get("unreachable") is not True
        assert "alerts" in by_target[srv.addr]
    finally:
        console.stop()
        srv.stop()
        alerts.deactivate()


def test_cfsevents_cli_timeline_alerts_and_correlate(journal):
    from chubaofs_tpu_torch.blobstore import trace
    from chubaofs_tpu_torch.console.server import Console
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer
    from chubaofs_tpu_torch.tools import cfsevents
    from chubaofs_tpu_torch.utils import tracesink

    srv = RPCServer(Router(), module="evcli").start()
    console = Console([srv.addr])
    # a persisted span + a correlated event (the repair-trace join shape)
    tracesink.configure(sample=1.0)
    with trace.child_of(None, "scheduler.repair") as span:
        trace.push_span(span)
        try:
            events.emit("task_finished", entity="t42",
                        detail={"kind": "disk_repair"})
        finally:
            trace.pop_span()
    try:
        buf = io.StringIO()
        rc = cfsevents.main(["--console", console.addr, "--n", "1000"],
                            out=buf)
        text = buf.getvalue()
        assert rc == 0
        assert "daemon_boot" in text and "task_finished" in text
        # --type filter
        buf = io.StringIO()
        rc = cfsevents.main(["--console", console.addr,
                             "--type", "task_finished", "--json"], out=buf)
        out = json.loads(buf.getvalue())
        assert rc == 0
        assert {e["type"] for e in out["events"]} == {"task_finished"}
        # --alerts view
        buf = io.StringIO()
        rc = cfsevents.main(["--console", console.addr, "--alerts"], out=buf)
        assert rc == 0 and "firing:" in buf.getvalue()
        # --correlate joins the event with the trace's spans, time-ordered
        buf = io.StringIO()
        rc = cfsevents.main(["--console", console.addr,
                             "--correlate", span.trace_id, "--json"], out=buf)
        out = json.loads(buf.getvalue())
        assert rc == 0
        kinds = [i["kind"] for i in out["items"]]
        assert "event" in kinds and "span" in kinds
        ts = [i["t"] for i in out["items"]]
        assert ts == sorted(ts)
        # direct --addr mode works without a console
        buf = io.StringIO()
        rc = cfsevents.main(["--addr", srv.addr, "--type", "task_finished"],
                            out=buf)
        assert rc == 0 and "task_finished" in buf.getvalue()
    finally:
        console.stop()
        srv.stop()
        alerts.deactivate()


# -- capacity collector archives the timeline ----------------------------------


def test_capacity_collector_archives_events_and_alerts(tmp_path, journal):
    from chubaofs_tpu_torch.console.server import Console
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer
    from chubaofs_tpu_torch.tools.capacity import Collector

    srv = RPCServer(Router(), module="capev").start()
    console = Console([srv.addr])
    report = str(tmp_path / "cap.jsonl")
    col = Collector(report, console=console.addr, interval=0.3)
    col.start()
    try:
        time.sleep(0.5)
        events.emit("chaos_inject", "warning", entity="node_kill",
                    detail={"plan": "t"})
        time.sleep(0.6)
    finally:
        col.stop()
        console.stop()
        srv.stop()
        alerts.deactivate()
    frames = [json.loads(line) for line in open(report)]
    assert frames, "collector archived no frames"
    assert all("events" in f and "alerts" in f for f in frames)
    archived = [e for f in frames for e in (f["events"] or ())]
    injects = [e for e in archived if e["type"] == "chaos_inject"]
    assert len(injects) == 1, (
        "cursor paging must archive each event exactly once")
    assert "alerts_fired" in col.verdict()
