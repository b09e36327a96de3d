"""The cases of tests/test_flightrec.py that need only the port's modules,
run against the port.

Incident flight recorder: with CFS_FLIGHT unset a daemon starts no recorder
thread and /debug/bundle answers 400 with the arming hint; armed, an alert
transition to firing freezes a bundle with every section present and the
triggering fingerprint, on a MiniCluster(device="cpu") that served traffic.
Hygiene: the size budget evicts oldest-first (never the bundle just
written), a flapping fingerprint dedups inside the cooldown, and a failing
section degrades the bundle instead of failing it. Postmortem: cfs-stat
--bundle reads a bundle, and cfs-doctor lists, inspects and diffs bundles
(and refuses a directory that is none), cfs-events and cfs-trace --bundle
read one, and a failing soak attaches one. The port's console collects a
cross-daemon incident (`slow`: the loop on a ProcCluster(device="cpu"))."""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.utils import alerts, events, flightrec, metrichist
from chubaofs_tpu_torch.utils.exporter import registry


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture(autouse=True)
def _flight_clean(monkeypatch, tmp_path):
    """Every test runs disarmed-by-default against its own bundle root and
    leaks neither the alert hook nor an alert manager into the next."""
    for knob in ("CFS_FLIGHT", "CFS_FLIGHT_MB", "CFS_FLIGHT_COOLDOWN_S",
                 "CFS_ALERT_EVAL_S", "CFS_METRIC_HIST_S", "CFS_PROF_HZ"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("CFS_FLIGHT_DIR", str(tmp_path / "flight"))
    flightrec.deactivate()
    alerts.deactivate()
    metrichist.deactivate()
    yield
    flightrec.deactivate()
    alerts.deactivate()
    metrichist.deactivate()


def _get_json(addr: str, path: str, timeout: float = 30.0) -> dict:
    return json.loads(urllib.request.urlopen(
        f"http://{addr}{path}", timeout=timeout).read())


def _fire_broken_disks(value: float = 3.0) -> dict:
    """Drive a real non-private AlertManager through a firing transition
    (the hook point) off a broken-disk gauge."""
    registry("clustermgr").gauge(
        "disks", {"status": "BROKEN"}).set(value)
    metrichist.default_history().record()
    am = alerts.AlertManager(rules=[alerts.AlertRule(
        "broken_disks", "gauge_sum", family="cfs_clustermgr_disks",
        threshold=0.0)])
    return am.evaluate()


def test_disarmed_no_hook_no_thread_and_bundle_400():
    """CFS_FLIGHT unset: activate is a no-op (no recorder, no alert hook),
    no cfs-flight thread exists (the recorder NEVER owns one), and the
    /debug/bundle side-door answers 400 with the arming hint."""
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer

    assert not flightrec.enabled()
    assert flightrec.activate_from_env() is None
    assert alerts._firing_hooks == []
    srv = RPCServer(Router(), module="gate").start()
    try:
        assert alerts._firing_hooks == []
        leaked = [t.name for t in threading.enumerate()
                  if t.name.startswith("cfs-flight")]
        assert leaked == [], leaked
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get_json(srv.addr, "/debug/bundle")
        assert ei.value.code == 400
        assert "CFS_FLIGHT" in json.loads(ei.value.read())["error"]
    finally:
        srv.stop()


def test_disarmed_alert_fire_writes_nothing(tmp_path):
    _fire_broken_disks()
    assert not os.path.exists(flightrec.flight_dir())


def test_armed_alert_fire_freezes_full_bundle(monkeypatch, tmp_path):
    """The tentpole acceptance: on a MiniCluster that served a PUT/GET
    burst, an alert transition to firing captures — with zero operator
    calls — a bundle carrying every section and the triggering
    fingerprint; /debug/bundle lists it."""
    from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer
    from chubaofs_tpu_torch.utils import auditlog

    monkeypatch.setenv("CFS_FLIGHT", "1")
    auditlog.configure_slowop(logdir=str(tmp_path / "slow"),
                              threshold_ms=0.0001)
    srv = RPCServer(Router(), module="armed").start()  # boot arms the hook
    c = MiniCluster(str(tmp_path / "blob"), device="cpu", n_nodes=6)
    try:
        assert alerts._firing_hooks, "boot did not register the alert hook"
        payload = os.urandom(32 * 1024)
        loc = c.access.put(payload)
        assert c.access.get(loc) == payload
        rep = _fire_broken_disks()
        assert rep["firing"] == 1

        rec = flightrec.default_recorder()
        bundles = rec.list_bundles()
        assert len(bundles) == 1
        b = bundles[0]
        assert b["trigger"] == "alert"
        assert b["fingerprint"] == "broken_disks"
        assert set(b["sections"]) == set(flightrec.SECTIONS)
        assert all(v == "ok" for v in b["sections"].values()), b["sections"]

        payload_d = flightrec.bundle_payload(b["path"])
        assert payload_d["alert"]["name"] == "broken_disks"
        assert payload_d["meta"]["fingerprint"] == "broken_disks"
        assert payload_d["metrics"]["snapshots"], "no frozen snapshots"
        assert payload_d["slowops"]["slowops"], "burst logged no slowops"
        assert payload_d["traces"]["records"], "slowops forced no spans"
        # the firing transition itself is IN the frozen ring (hooks run
        # after the emit); the incident_capture event lands on the LIVE
        # journal after the freeze — a bundle can't contain its own capture
        assert any(e["type"] == "alert_firing"
                   for e in payload_d["events"]["events"])
        assert any(e["type"] == "incident_capture"
                   for e in events.recent(50))
        assert "env" in payload_d["config"]

        # the side-door face: bare GET lists, ?collect=1 captures inline
        listing = _get_json(srv.addr, "/debug/bundle")
        assert len(listing["bundles"]) == 1
        inline = _get_json(srv.addr, "/debug/bundle?collect=1&trigger=t1")
        assert inline["manifest"]["trigger"] == "t1"
        assert set(inline["payload"]) >= set(flightrec.SECTIONS)
    finally:
        c.close()
        srv.stop()


def test_cooldown_dedups_by_fingerprint(monkeypatch):
    monkeypatch.setenv("CFS_FLIGHT_COOLDOWN_S", "60")
    rec = flightrec.default_recorder()
    m1 = rec.capture(trigger="alert", fingerprint="fp|a=1")
    m2 = rec.capture(trigger="alert", fingerprint="fp|a=1")
    assert not m1["deduped"] and m2["deduped"]
    assert m2["bundle"] == m1["bundle"]
    assert len(rec.list_bundles()) == 1
    # a DIFFERENT fingerprint is a different incident: never deduped
    m3 = rec.capture(trigger="alert", fingerprint="fp|a=2")
    assert not m3["deduped"] and m3["bundle"] != m1["bundle"]
    assert len(rec.list_bundles()) == 2


def test_cooldown_expiry_recaptures(monkeypatch):
    monkeypatch.setenv("CFS_FLIGHT_COOLDOWN_S", "0")
    rec = flightrec.default_recorder()
    m1 = rec.capture(trigger="alert", fingerprint="fp")
    m2 = rec.capture(trigger="alert", fingerprint="fp")
    assert not m2["deduped"] and m2["bundle"] != m1["bundle"]


def test_size_budget_evicts_oldest_never_newest(monkeypatch):
    monkeypatch.setenv("CFS_FLIGHT_MB", "0.008")  # ~8 KiB -> floor 4 KiB..
    rec = flightrec.default_recorder()
    paths = [rec.capture(trigger=f"t{i}")["bundle"] for i in range(6)]
    left = [b["path"] for b in rec.list_bundles()]
    assert paths[-1] in left, "the just-written bundle was evicted"
    assert len(left) < 6, "budget never evicted anything"
    # eviction is oldest-first: whatever survived is a suffix of the
    # write order
    assert left == paths[-len(left):]


def test_capture_section_error_degrades_not_fatal(monkeypatch):
    """A broken gather (here: profiler) degrades to an error stanza; the
    bundle still lands with every other section ok."""
    from chubaofs_tpu_torch.utils import profiler

    def boom(_s):
        raise RuntimeError("sampler wedged")

    monkeypatch.setattr(flightrec, "_gather_profile", boom)
    man = flightrec.capture(trigger="degraded")
    assert man["sections"]["profile"] == "error"
    assert man["sections"]["metrics"] == "ok"
    payload = flightrec.bundle_payload(man["bundle"])
    assert "sampler wedged" in payload["profile"]["error"]
    assert profiler.active() is None



# -- postmortem CLIs (offline --bundle mode) -----------------------------------


@pytest.fixture()
def collected_bundle(tmp_path):
    """One daemon bundle with real content: events, two metric snapshots
    with movement, a forced slowop span."""
    from chubaofs_tpu_torch.blobstore.trace import start_span
    from chubaofs_tpu_torch.utils import auditlog

    events.configure(logdir=str(tmp_path / "ev"))
    auditlog.configure_slowop(logdir=str(tmp_path / "slow"),
                              threshold_ms=0.0001)
    registry("bundle").counter("ticks").add(5)
    metrichist.default_history().record()
    registry("bundle").counter("ticks").add(7)
    events.emit("bench_tick", detail={"i": 1})
    span = start_span("op_slow")
    span.finish()
    auditlog.record_slow_op("test", "op_slow", 0.25, span=span)
    metrichist.default_history().record()
    man = flightrec.capture(trigger="test", fingerprint="fp|x=1",
                            alert={"name": "broken_disks",
                                   "state": "firing", "severity": "critical",
                                   "value": 2.0, "since": time.time(),
                                   "labels": {}})
    yield man["bundle"]
    events.reset()


def test_cfs_stat_reads_bundle(collected_bundle):
    from chubaofs_tpu_torch.tools import cfsstat

    out = io.StringIO()
    rc = cfsstat.main(["--bundle", collected_bundle], out=out)
    assert rc == 0
    assert "cfs_bundle_ticks" in out.getvalue()
    rc = cfsstat.main(["--bundle", collected_bundle, "--slowops", "--json"],
                      out=(out := io.StringIO()))
    assert rc == 0
    blob = json.loads(out.getvalue())
    assert any(r["metric"].endswith('cfs_bundle_ticks_total')
               or "cfs_bundle_ticks" in r["metric"] for r in blob["rows"])
    assert blob["slowops"], "bundle slowops not surfaced"


def test_cfs_doctor_list_inspect_diff(collected_bundle, tmp_path):
    from chubaofs_tpu_torch.tools import cfsdoctor

    out = io.StringIO()
    assert cfsdoctor.main(["list", "--dir", flightrec.flight_dir()],
                          out=out) == 0
    assert "fp" in out.getvalue()

    out = io.StringIO()
    assert cfsdoctor.main(["inspect", collected_bundle], out=out) == 0
    text = out.getvalue()
    assert "broken_disks" in text          # names the firing alert
    assert "window:" in text               # shows the burn-rate window
    assert "op_slow" in text               # surfaces the in-window slowop
    assert "cfs_bundle_ticks" in text      # top burn-rate families

    registry("bundle").counter("ticks").add(100)
    metrichist.default_history().record()
    man2 = flightrec.capture(trigger="later", fingerprint="fp|x=2")
    out = io.StringIO()
    assert cfsdoctor.main(["diff", collected_bundle, man2["bundle"]],
                          out=out) == 0
    assert "cfs_bundle_ticks" in out.getvalue()


def test_read_bundle_rejects_non_bundle(tmp_path):
    from chubaofs_tpu_torch.tools.cfsdoctor import read_bundle

    with pytest.raises(ValueError):
        read_bundle(str(tmp_path))


def test_cfs_events_reads_bundle(collected_bundle):
    from chubaofs_tpu_torch.tools import cfsevents

    out = io.StringIO()
    rc = cfsevents.main(["--bundle", collected_bundle], out=out)
    assert rc == 0
    assert "incident_capture" in out.getvalue() \
        or "bench_tick" in out.getvalue()
    out = io.StringIO()
    rc = cfsevents.main(["--bundle", collected_bundle, "--alerts"], out=out)
    assert rc == 0
    assert "broken_disks" in out.getvalue()


def test_cfs_trace_reads_bundle(collected_bundle):
    from chubaofs_tpu_torch.tools import cfstrace
    from chubaofs_tpu_torch.utils import flightrec as fr

    records = fr.bundle_payload(collected_bundle)["traces"]["records"]
    mine = [r for r in records if r.get("op") == "op_slow"]
    assert mine, "fixture's forced slowop span is not in the bundle"
    tid = mine[0]["trace_id"]
    out = io.StringIO()
    rc = cfstrace.main(["--bundle", collected_bundle, "--top"], out=out)
    assert rc == 0
    out = io.StringIO()
    rc = cfstrace.main(["--bundle", collected_bundle, tid], out=out)
    assert rc == 0
    assert "op_slow" in out.getvalue()


def test_soak_failure_attaches_bundle():
    from chubaofs_tpu_torch.chaos.soak import SoakFailure, _capture_on_failure

    @_capture_on_failure
    def failing_soak():
        raise SoakFailure("gate tripped: data loss")

    with pytest.raises(SoakFailure) as ei:
        failing_soak()
    bundle = ei.value.bundle
    assert bundle and os.path.isdir(bundle)
    payload = flightrec.bundle_payload(bundle)
    assert payload["manifest"]["trigger"] == "soak_failure"
    assert payload["alert"]["error"] == "gate tripped: data loss"


def test_collector_tolerates_unreachable_daemon(monkeypatch, tmp_path):
    """/api/incident over one live armed daemon and one corpse: partial
    incident dir, live target collected, corpse listed unreachable —
    never a crash."""
    from chubaofs_tpu_torch.console.server import Console
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer

    monkeypatch.setenv("CFS_FLIGHT", "1")
    srv = RPCServer(Router(), module="live").start()
    dead = "127.0.0.1:1"
    console = Console([], metrics_addrs=[srv.addr, dead])
    try:
        inc = _get_json(console.addr,
                        "/api/incident?fingerprint=fp1&trigger=test")
        assert inc["targets"] == [srv.addr]
        assert inc["unreachable"] == [dead]
        assert inc["fingerprint"] == "fp1"
        assert os.path.isdir(inc["dir"])
        assert os.path.exists(os.path.join(inc["dir"], "incident.json"))
        subdirs = [d for d in os.listdir(inc["dir"])
                   if os.path.isdir(os.path.join(inc["dir"], d))]
        assert len(subdirs) == 1
        assert "correlation" in inc and "window" in inc["correlation"]
    finally:
        console.stop()
        srv.stop()


def test_collector_derives_fingerprint_from_firing_alert(monkeypatch):
    """With no ?fingerprint=, the collector keys the incident off the
    first firing alert in the cluster rollup (the zero-operator-calls
    contract: alert fires -> /api/incident names the cause itself)."""
    from chubaofs_tpu_torch.console.server import Console
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer

    monkeypatch.setenv("CFS_FLIGHT", "1")
    # the stock rule filters status="broken" (lower-case, the clustermgr
    # status vocabulary) — the custom-rule tests above don't
    registry("clustermgr").gauge("disks", {"status": "broken"}).set(2.0)
    metrichist.default_history().record()
    srv = RPCServer(Router(), module="firing").start()
    console = Console([], metrics_addrs=[srv.addr])
    try:
        # /alerts evaluates on demand (cold manager) — but the DEFAULT
        # manager's rule set needs the broken-disk rule, which it has
        inc = _get_json(console.addr, "/api/incident")
        assert inc["fingerprint"].startswith("broken_disks")
        assert inc["alert"]["name"] == "broken_disks"
    finally:
        console.stop()
        srv.stop()


@pytest.mark.slow
def test_e2e_alert_fire_collects_inspectable_incident(tmp_path):
    """The full loop on a real ProcCluster: a chaos-injected sustained
    put_shard delay flips the put_p99 SLO, the firing alert triggers
    capture with zero operator calls, the console assembles the incident,
    and cfs-doctor inspect names the alert, shows the window, and
    surfaces an in-window slowop trace plus a nonzero-coverage profile."""
    from chubaofs_tpu_torch.testing.harness import ProcCluster
    from chubaofs_tpu_torch.tools import cfsdoctor

    flight_root = str(tmp_path / "shared-flight")
    env = {
        "CFS_FAILPOINTS": "blobnode.put_shard=delay(0.08)",
        "CFS_SLO_PUT_P99_MS": "20",
        "CFS_ALERT_SLO_N": "1",
        "CFS_ALERT_EVAL_S": "0.5",
        "CFS_METRIC_HIST_S": "0.5",
        "CFS_SLOWOP_MS": "20",
        "CFS_PROF_HZ": "50",
        "CFS_TRACE_SAMPLE": "1",
        "CFS_FLIGHT": "1",
        "CFS_FLIGHT_DIR": flight_root,
    }
    cluster = ProcCluster(str(tmp_path / "cluster"), masters=1,
                          metanodes=1, datanodes=0, blobstore=True,
                          env=env, device="cpu")
    try:
        from chubaofs_tpu_torch.blobstore.gateway import AccessClient

        blob = os.urandom(256 * 1024)
        client = AccessClient([cluster.access_addr])
        locs = []
        deadline = time.monotonic() + 60.0
        fired_bundle = None
        while time.monotonic() < deadline:
            locs.append(client.put(blob))
            if os.path.isdir(flight_root):
                autos = [d for d in os.listdir(flight_root)
                         if d.startswith("slo_failing")]
                if autos:
                    fired_bundle = os.path.join(flight_root, autos[0])
                    break
        assert fired_bundle, (
            f"no alert-triggered bundle appeared under {flight_root} "
            f"after {len(locs)} delayed PUTs")

        # Keep delayed PUTs flowing while the console collects: the SLO
        # burn-rate window recovers within a few eval ticks once traffic
        # stops, and a resolved alert would leave /api/incident nothing
        # to derive the fingerprint from — the incident must be LIVE.
        stop_pump = threading.Event()

        def _pump():
            while not stop_pump.is_set():
                try:
                    client.put(blob)
                except Exception:
                    time.sleep(0.1)  # gateway busy/restarting: keep trying

        pump = threading.Thread(target=_pump, daemon=True)
        pump.start()
        try:
            # console assembles the cross-daemon incident off the live alert
            targets = [cluster.access_addr] + cluster.stats_addrs()
            console = cluster.spawn_console(metrics_addrs=targets)
            inc = _get_json(console, "/api/incident", timeout=120.0)
        finally:
            stop_pump.set()
            pump.join(timeout=30.0)
        assert inc["targets"], inc
        assert inc["fingerprint"].startswith("slo_failing")

        out = io.StringIO()
        assert cfsdoctor.main(["inspect", inc["dir"]], out=out) == 0
        text = out.getvalue()
        assert "slo_failing" in text           # names the firing alert
        assert "window:" in text               # the burn-rate window
        assert "trace=" in text                # >=1 in-window slowop trace
        s = cfsdoctor.summarize(cfsdoctor.read_bundle(inc["dir"]))
        assert s["slowops"], "no in-window slowop in the incident"
        assert s["trace_ids"], "slowops carried no trace ids"
        assert s["profile_coverage"] > 0, "profile froze zero coverage"
    finally:
        cluster.close()
