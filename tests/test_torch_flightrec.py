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
(and refuses a directory that is none). The console collector and
cfs-events / cfs-trace --bundle wait for their ports."""

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
