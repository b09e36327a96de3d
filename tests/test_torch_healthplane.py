"""The cases of tests/test_healthplane.py that need only the port's health
plane, run against the port on the CPU.

Sampling profiler (zero-overhead when disarmed, thread buckets, bounded
capture), metric history (ring, server-side rates, restart clamp, exposition
key and histogram helpers), SLO burn windows, the cfs-stat restart clamp, the
evloop loop-lag histogram, /health flipping failing under a sustained
latency failpoint on a MiniCluster(device="cpu"), the profile/history/health
acceptance over a PUT burst (with cfs-trace --prof on the same side-door),
and cfs-top's rollup split and row math, and cfs-top --once over the
port's console."""

import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.utils import metrichist, profiler, slo
from chubaofs_tpu_torch.utils.exporter import registry
from chubaofs_tpu_torch.utils.metrichist import (
    hist_delta, hist_quantile, is_monotonic, parse_key)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture(autouse=True)
def _profiler_clean():
    """No test leaks a continuous profiler (or an armed recorder) into the
    next one — and none inherits an earlier suite's default history ring,
    so window assertions are exact."""
    profiler.deactivate()
    metrichist.deactivate()
    yield
    profiler.deactivate()
    metrichist.deactivate()


def _get_json(addr: str, path: str, timeout: float = 30.0) -> dict:
    return json.loads(urllib.request.urlopen(
        f"http://{addr}{path}", timeout=timeout).read())


def test_disarmed_hooks_are_noop(monkeypatch):
    """With CFS_PROF_HZ / CFS_METRIC_HIST_S unset, building a daemon's HTTP
    server must start NO sampler and NO recorder — the strictly-zero-
    overhead contract the lock sanitizer set the pattern for."""
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer

    monkeypatch.delenv("CFS_PROF_HZ", raising=False)
    monkeypatch.delenv("CFS_METRIC_HIST_S", raising=False)
    assert not profiler.enabled() and not metrichist.enabled()
    assert profiler.activate_from_env() is None
    assert metrichist.activate_from_env() is None
    srv = RPCServer(Router(), module="gate").start()
    try:
        leaked = [t.name for t in threading.enumerate()
                  if t.name.startswith(("cfs-prof", "cfs-methist"))]
        assert leaked == [], leaked
        assert profiler.active() is None
        # the side-door still answers: continuous mode 400s with a hint,
        # on-demand capture (explicit, bounded cost) still works
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get_json(srv.addr, "/debug/prof")
        assert ei.value.code == 400
    finally:
        srv.stop()


def test_armed_env_starts_continuous_profiler_and_recorder(monkeypatch):
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer

    monkeypatch.setenv("CFS_PROF_HZ", "50")
    monkeypatch.setenv("CFS_METRIC_HIST_S", "0.2")
    srv = RPCServer(Router(), module="armed").start()
    try:
        assert profiler.active() is not None
        assert metrichist.default_history().armed
        time.sleep(0.3)
        rep = _get_json(srv.addr, "/debug/prof?json=1")
        assert rep["sweeps"] >= 1 and rep["hz"] == 50.0
    finally:
        srv.stop()


def test_thread_bucket_collapses_pool_digits():
    assert profiler.thread_bucket("evloop-pkt-0") == "evloop-pkt-N"
    assert profiler.thread_bucket("evloop-pkt-13") == \
        profiler.thread_bucket("evloop-pkt-7")
    assert profiler.thread_bucket("codec-svc") == "codec-svc"
    assert profiler.thread_bucket("access-read_3") == "access-read_N"
    assert profiler.thread_bucket("") == "?"


def _capture_case():
    """The body of test_capture_attributes_named_threads_with_stacks. It runs
    in a process of its own: a pytest-xdist worker keeps a receiver thread
    that the threading module does not know (it buckets as `?`), and that
    foreign thread alone would hold coverage at 2/3 in an otherwise idle
    worker."""
    stop = threading.Event()

    def spin():
        x = 0
        while not stop.is_set():
            x += 1
        return x

    t = threading.Thread(target=spin, name="hp-busy-1", daemon=True)
    t.start()
    try:
        prof = profiler.capture(0.3, hz=200)
    finally:
        stop.set()
        t.join()
    d = prof.to_dict()
    assert d["sweeps"] >= 10
    assert d["coverage"] >= 0.9, d
    assert "hp-busy-N" in d["threads"], d["threads"]
    # its own machinery never profiles itself: no sampler bucket, and the
    # blocked capture() caller is excluded too
    assert "cfs-prof-cap" not in d["threads"]
    # collapsed lines are root-first and end in this file's spin frame
    busy = [ln for ln in d["collapsed"].splitlines()
            if ln.startswith("hp-busy-N;")]
    assert busy and any("test_torch_healthplane.py:spin" in ln for ln in busy)
    # counts parse as the flamegraph.pl format: "frames count"
    frames, n = busy[0].rsplit(" ", 1)
    assert int(n) >= 1 and ";" in frames


def test_capture_attributes_named_threads_with_stacks():
    proc = subprocess.run(
        [sys.executable, "-c", "import test_torch_healthplane as t; t._capture_case()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p)})
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_capture_bounds_seconds_and_hz():
    prof = profiler.capture(0.05, hz=10_000)
    assert prof.hz <= profiler.MAX_HZ


def test_history_ring_rates_and_filter():
    h = metrichist.MetricHistory(maxlen=4)
    c = registry("hptest").counter("ops")
    h.record()
    c.add(10)
    time.sleep(0.01)
    h.record()
    rr = metrichist.rates(h.snapshots())
    assert len(rr) == 1
    key = [k for k in rr[0]["rates"] if "hptest_ops" in k]
    assert key and rr[0]["rates"][key[0]] > 0
    # ring bound holds
    for _ in range(6):
        h.record()
    assert len(h.snapshots()) == 4
    # the query shape /metrics/history serves, name-filtered
    out = h.query(n=3, flt="cfs_hptest", rate=True)
    assert out["count"] == 3
    assert all("cfs_hptest" in k for s in out["snapshots"]
               for k in s["metrics"])
    assert all("cfs_hptest" in k for r in out["rates"] for k in r["rates"])


def test_history_recorder_restartable_after_stop():
    """start() after stop() must actually record again — a stale stop flag
    would leave `armed` True with a dead thread, silently freezing the
    feed /health trusts."""
    h = metrichist.MetricHistory(maxlen=32, period_s=0.05)
    h.start()
    time.sleep(0.3)
    h.stop()
    n = len(h.snapshots())
    assert n >= 1
    h.start()
    assert h.armed
    deadline = time.monotonic() + 5.0
    while len(h.snapshots()) <= n and time.monotonic() < deadline:
        time.sleep(0.05)
    h.stop()
    assert len(h.snapshots()) > n, "recorder did not resume after restart"


def test_rates_clamp_counter_restart_and_skip_gauges():
    types = {"cfs_x_ops": "counter", "cfs_x_depth": "gauge",
             "cfs_x_lat": "histogram"}

    def snap(mono, ops, depth, lat_count):
        return {"ts": mono, "mono": mono, "types": types,
                "metrics": {"cfs_x_ops": ops, "cfs_x_depth": depth,
                            "cfs_x_lat_count": lat_count}}

    # counter fell 50 -> 5: the daemon restarted; 5 IS the window's delta
    rr = metrichist.rates([snap(100.0, 50.0, 9.0, 40.0),
                           snap(101.0, 5.0, 2.0, 4.0)])
    assert rr[0]["rates"]["cfs_x_ops"] == 5.0
    assert rr[0]["rates"]["cfs_x_lat_count"] == 4.0  # histogram child too
    # gauges legitimately go down: no rate, no clamp
    assert "cfs_x_depth" not in rr[0]["rates"]


def test_exposition_key_helpers():
    assert parse_key('m{a="x",le="0.5"}') == ("m", {"a": "x", "le": "0.5"})
    assert parse_key("plain") == ("plain", {})
    types = {"f": "histogram", "c": "counter", "g": "gauge"}
    assert is_monotonic('f_bucket{le="1.0"}', types)
    assert is_monotonic("f_count", types) and is_monotonic("c", types)
    assert not is_monotonic("g", types)
    assert not is_monotonic("f_max", types)  # the _max companion is a gauge
    assert not is_monotonic("unknown_series", types)


def test_hist_delta_and_quantile():
    m0 = {'lat_bucket{le="0.01"}': 100.0, 'lat_bucket{le="1.0"}': 100.0,
          "lat_count": 100.0}
    m1 = {'lat_bucket{le="0.01"}': 180.0, 'lat_bucket{le="1.0"}': 200.0,
          "lat_count": 200.0}
    buckets, count = hist_delta(m0, m1, "lat")
    assert count == 100.0 and buckets[0.01] == 80.0 and buckets[1.0] == 100.0
    assert hist_quantile(buckets, count, 0.5) == 0.01
    assert hist_quantile(buckets, count, 0.99) == 1.0
    assert hist_quantile({}, 0.0, 0.99) is None
    # one-snapshot window degrades to all-time totals
    b2, c2 = hist_delta({}, m1, "lat")
    assert c2 == 200.0 and b2[0.01] == 180.0
    # count went DOWN: restart inside the window — the post-restart totals
    # are the delta (blanking to zero would blind the SLOs right after a
    # restart, the same contract rates() and cfs-stat implement)
    b3, c3 = hist_delta(m1, m0, "lat")
    assert c3 == 100.0 and b3[0.01] == 100.0


def _put_snap(mono: float, fast_cum: float, slow_cum: float) -> dict:
    """A snapshot whose PUT histogram has `fast_cum` samples <=10ms and
    `slow_cum - fast_cum`... cumulative: bucket 0.01 = fast_cum, bucket
    1.0 = slow_cum, count = slow_cum."""
    return {"ts": mono, "mono": mono,
            "types": {"cfs_access_put": "histogram"},
            "metrics": {'cfs_access_put_bucket{le="0.01"}': fast_cum,
                        'cfs_access_put_bucket{le="1.0"}': slow_cum,
                        "cfs_access_put_count": slow_cum}}


def test_slo_burn_windows_ok_degraded_failing():
    spec = [slo.SLO("put_p99", "hist_p99_ms", "cfs_access_put", 100.0)]
    s0 = _put_snap(10.0, 0.0, 0.0)
    s1 = _put_snap(20.0, 980.0, 980.0)      # 980 fast samples
    s2 = _put_snap(30.0, 980.0, 985.0)      # +5 slow: fast window burns only
    s3 = _put_snap(40.0, 980.0, 1185.0)     # +200 slow: both windows burn

    rep = slo.evaluate(spec, [s0, s1], fast_n=2, slow_n=3)
    assert rep["status"] == "ok" and rep["reasons"] == []
    assert rep["slos"]["put_p99"]["fast"] == 10.0  # ms

    rep = slo.evaluate(spec, [s0, s1, s2], fast_n=2, slow_n=3)
    assert rep["status"] == "degraded"
    assert rep["slos"]["put_p99"]["status"] == "degraded"
    assert any("put_p99" in r for r in rep["reasons"])

    rep = slo.evaluate(spec, [s1, s2, s3], fast_n=2, slow_n=3)
    assert rep["status"] == "failing"
    # ... and the verdict is itself a metric (cfs_slo_status)
    text = registry("slo").render()
    assert 'cfs_slo_status{slo="put_p99"} 2.0' in text


def test_slo_flow_kinds_need_two_snapshots():
    """Lifetime totals are not a burn window: with only one snapshot, the
    flow SLOs (latency/errors/rates) report None — a long-lived daemon's
    hour-old error burst, or traffic predating the poller, must not read
    as 'failing NOW'. Gauges are state and evaluate immediately."""
    spec = [slo.SLO("put_p99", "hist_p99_ms", "cfs_access_put", 0.001),
            slo.SLO("backlog", "gauge_sum", "cfs_scheduler_tasks", 1.0)]
    one = {"ts": 1.0, "mono": 1.0, "types": {},
           "metrics": {'cfs_access_put_bucket{le="1.0"}': 500.0,
                       "cfs_access_put_count": 500.0,
                       'cfs_scheduler_tasks{kind="repair",state="pending"}': 7.0}}
    rep = slo.evaluate(spec, [one], fast_n=2, slow_n=4)
    assert rep["slos"]["put_p99"]["fast"] is None  # no window yet
    assert rep["slos"]["put_p99"]["status"] == "ok"
    # the gauge breaches NOW, but one snapshot can't prove it's SUSTAINED
    # (the slow window is the same single snapshot): degraded, not failing
    assert rep["slos"]["backlog"]["fast"] == 7.0
    assert rep["slos"]["backlog"]["status"] == "degraded"


def test_slo_no_data_is_ok_not_unknown_unhealthy():
    """A family absent on this role (no access layer on a metanode) must
    evaluate to None and never breach."""
    spec = [slo.SLO("put_p99", "hist_p99_ms", "cfs_no_such_family", 1.0),
            slo.SLO("backlog", "gauge_sum", "cfs_no_such_gauge", 1.0)]
    snaps = [_put_snap(1.0, 5.0, 5.0), _put_snap(2.0, 9.0, 9.0)]
    rep = slo.evaluate(spec, snaps, fast_n=2, slow_n=2)
    assert rep["status"] == "ok"
    assert rep["slos"]["put_p99"]["fast"] is None


def test_slo_error_ratio_and_gauge_backlog():
    types = {"cfs_access_put": "histogram",
             "cfs_access_put_errors": "counter",
             "cfs_scheduler_tasks": "gauge"}

    def snap(mono, count, errors, backlog):
        return {"ts": mono, "mono": mono, "types": types,
                "metrics": {'cfs_access_put_bucket{le="0.01"}': count,
                            "cfs_access_put_count": count,
                            "cfs_access_put_errors": errors,
                            'cfs_scheduler_tasks{kind="repair",state="pending"}': backlog}}

    spec = [slo.SLO("put_errors", "error_ratio", "cfs_access_put_errors",
                    0.01, ops_family="cfs_access_put"),
            slo.SLO("repair_backlog", "gauge_sum", "cfs_scheduler_tasks",
                    10.0)]
    healthy = [snap(1.0, 0.0, 0.0, 0.0), snap(2.0, 500.0, 1.0, 3.0),
               snap(3.0, 1000.0, 1.0, 3.0)]
    rep = slo.evaluate(spec, healthy, fast_n=2, slow_n=3)
    assert rep["status"] == "ok"
    sick = [snap(1.0, 0.0, 0.0, 0.0), snap(2.0, 50.0, 25.0, 64.0),
            snap(3.0, 100.0, 50.0, 64.0)]
    rep = slo.evaluate(spec, sick, fast_n=2, slow_n=3)
    assert rep["status"] == "failing"
    assert rep["slos"]["put_errors"]["fast"] == 0.5
    assert rep["slos"]["repair_backlog"]["fast"] == 64.0
    # the spike-vs-sustained distinction: a backlog that was high in an OLD
    # snapshot but has drained NOW burns only the slow (worst) window
    spike = [snap(1.0, 0.0, 0.0, 0.0), snap(2.0, 500.0, 1.0, 64.0),
             snap(3.0, 1000.0, 1.0, 0.0)]
    rep = slo.evaluate(spec, spike, fast_n=2, slow_n=3)
    assert rep["slos"]["repair_backlog"]["status"] == "degraded"
    assert rep["slos"]["repair_backlog"]["fast"] == 0.0  # drained NOW
    assert rep["slos"]["repair_backlog"]["slow"] == 64.0
    # restart inside the window: both counters restarted from zero, and
    # the post-restart values ARE the window (errors 25 of 50 ops = 50%
    # error rate must breach, not clamp to a clean 0/ratio)
    restarted = [snap(1.0, 9000.0, 1000.0, 0.0),
                 snap(2.0, 50.0, 25.0, 0.0)]
    rep = slo.evaluate(spec, restarted, fast_n=2, slow_n=2)
    assert rep["slos"]["put_errors"]["fast"] == 0.5


def test_gauge_sum_label_filter_excludes_finished_tasks():
    """The stock repair-backlog SLO counts only live task states: a table
    full of finished/failed HISTORY must not read as backlog."""
    spec = [s for s in slo.default_slos() if s.name == "repair_backlog"]
    assert spec and spec[0].label_in[0] == "state"
    snap = {"ts": 1.0, "mono": 1.0, "types": {}, "metrics": {
        'cfs_scheduler_tasks{kind="repair",state="finished"}': 500.0,
        'cfs_scheduler_tasks{kind="repair",state="failed"}': 40.0,
        'cfs_scheduler_tasks{kind="repair",state="prepared"}': 2.0,
        'cfs_scheduler_tasks{kind="repair",state="working"}': 1.0}}
    rep = slo.evaluate(spec, [snap], fast_n=1, slow_n=1)
    assert rep["slos"]["repair_backlog"]["fast"] == 3.0
    assert rep["status"] == "ok"


def test_diff_metrics_clamps_counter_restart():
    from chubaofs_tpu_torch.tools.cfsstat import diff_metrics

    types = {"cfs_m_ops": "counter", "cfs_m_depth": "gauge",
             "cfs_m_lat": "histogram"}
    a = {"cfs_m_ops": 100.0, "cfs_m_depth": 9.0,
         'cfs_m_lat_bucket{le="0.1"}': 80.0, "cfs_m_lat_count": 90.0}
    b = {"cfs_m_ops": 5.0, "cfs_m_depth": 2.0,
         'cfs_m_lat_bucket{le="0.1"}': 3.0, "cfs_m_lat_count": 4.0}
    rows = {r["metric"]: r for r in diff_metrics(a, b, 10.0, types=types)}
    # counter fell: daemon restarted -> clamp to the post-restart value
    assert rows["cfs_m_ops"]["delta"] == 5.0 and rows["cfs_m_ops"]["restart"]
    assert rows["cfs_m_ops"]["rate"] == 0.5
    assert rows["cfs_m_lat_count"]["restart"]
    assert rows['cfs_m_lat_bucket{le="0.1"}']["delta"] == 3.0
    # gauge went down legitimately: untouched
    assert rows["cfs_m_depth"]["delta"] == -7.0
    assert not rows["cfs_m_depth"]["restart"]
    # no types (legacy library call): no clamping
    legacy = {r["metric"]: r for r in diff_metrics(a, b, 10.0)}
    assert legacy["cfs_m_ops"]["delta"] == -95.0
    # the rendered row carries the (restart) tag
    import io as _io

    from chubaofs_tpu_torch.tools import cfsstat
    buf = _io.StringIO()
    text = ("# TYPE cfs_m_ops counter\ncfs_m_ops 100\n",
            "# TYPE cfs_m_ops counter\ncfs_m_ops 5\n")
    calls = iter(text)

    def fake_scrape(addr, path="/metrics", timeout=10.0):
        return next(calls)

    orig = cfsstat.scrape
    cfsstat.scrape = fake_scrape
    try:
        rc = cfsstat.main(["--addr", "x:1", "--interval", "0"], out=buf)
    finally:
        cfsstat.scrape = orig
    assert rc == 0 and "(restart)" in buf.getvalue()


def test_evloop_loop_lag_histogram_records():
    from chubaofs_tpu_torch.rpc.evloop import EvloopServer
    from chubaofs_tpu_torch.tools.cfsstat import parse_metrics

    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(8)
    ev = EvloopServer(lst, lambda msg: None, name="lagtest", shards=1)
    ev.start()
    try:
        time.sleep(1.1)  # a couple of _LAG_TICK periods on an idle shard
    finally:
        ev.stop()
        lst.close()
    vals = parse_metrics(registry("evloop").render())
    key = 'cfs_evloop_loop_lag_ms_count{shard="0",srv="lagtest"}'
    assert vals.get(key, 0.0) >= 1, [k for k in vals if "loop_lag" in k]
    # an idle shard's lag is near zero: p99 within the first buckets
    from chubaofs_tpu_torch.utils.metrichist import hist_totals
    buckets, count = hist_totals(
        {k: v for k, v in vals.items() if "lagtest" in k},
        "cfs_evloop_loop_lag_ms")
    assert count >= 1 and sum(buckets.values()) >= 1


@pytest.fixture(scope="module")
def burst_cluster(tmp_path_factory):
    from chubaofs_tpu_torch.blobstore.cluster import MiniCluster

    mc = MiniCluster(str(tmp_path_factory.mktemp("hp")), device="cpu", n_nodes=6,
                     disks_per_node=2)
    yield mc
    mc.close()


def test_health_flips_failing_under_sustained_latency(burst_cluster,
                                                      monkeypatch, rng):
    """The chaos acceptance: a sustained-latency failpoint on the shard
    write path pushes PUT p99 over the (tightened) objective in BOTH burn
    windows -> the daemon reports failing, with the reason naming the SLO."""
    from chubaofs_tpu_torch import chaos

    mc = burst_cluster
    monkeypatch.setenv("CFS_SLO_PUT_P99_MS", "20")
    hist = metrichist.MetricHistory(maxlen=16)
    data = rng.integers(0, 256, 60_000, dtype=np.uint8).tobytes()
    mc.access.put(data)  # warm
    hist.record()
    chaos.arm("blobnode.put_shard", "delay(0.08)")
    try:
        for _ in range(3):
            mc.access.put(data)
            hist.record()
    finally:
        chaos.disarm("blobnode.put_shard")
    rep = slo.evaluate(slo.default_slos(), hist.snapshots(),
                       fast_n=2, slow_n=4)
    assert rep["status"] == "failing", rep
    assert any("put_p99" in r for r in rep["reasons"]), rep["reasons"]


def test_minicluster_burst_profile_history_health(burst_cluster, rng):
    """The acceptance demo: profile a PUT burst, attribute wall-clock
    between Python glue and codec dispatch, read history rates, get a
    health verdict — all over the daemon side-doors."""
    from chubaofs_tpu_torch.rpc.evloop import EvloopServer
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer

    mc = burst_cluster
    # an evloop packet server shares the process (as in any datanode):
    # its shard threads must bucket in the profile
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(8)
    ev = EvloopServer(lst, lambda msg: None, name="hp")
    ev.start()
    srv = RPCServer(Router(), module="hp").start()
    hist = metrichist.default_history()
    data = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    try:
        loc = mc.access.put(data)  # warmup: jit compile outside the window
        assert mc.access.get(loc) == data
        result: dict = {}

        def grab():
            result["prof"] = _get_json(
                srv.addr, "/debug/prof?seconds=1.2&json=1", timeout=60)

        th = threading.Thread(target=grab)
        th.start()
        hist.record()
        locs = []
        deadline = time.monotonic() + 1.3
        while time.monotonic() < deadline:
            locs.append(mc.access.put(data))
        hist.record()
        for lo in locs[:3]:
            assert mc.access.get(lo) == data
        hist.record()
        th.join(timeout=90)
        prof = result["prof"]

        # -- profile: >=90% of sampled wall time lands in named buckets,
        # and the buckets distinguish evloop shards from the codec drain
        assert prof["samples"] > 0 and prof["coverage"] >= 0.9, prof
        buckets = prof["threads"]
        assert any(b.startswith("evloop-hp") for b in buckets), buckets
        assert "codec-svc" in buckets, buckets
        # collapsed stacks name real code: the codec drain loop is visible,
        # i.e. the profile attributes glue vs codec dispatch
        assert "service.py" in prof["collapsed"]

        # -- history: >=3 snapshots, a nonzero server-side rate() on the
        # access families the burst drove
        out = _get_json(
            srv.addr, "/metrics/history?rate=1&filter=cfs_access&n=10")
        assert out["count"] >= 3
        assert any(v > 0 for r in out["rates"] for v in r["rates"].values())

        # -- health: ok on the healthy cluster (default thresholds)
        health = _get_json(srv.addr, "/health")
        assert health["status"] == "ok", health
        assert "put_p99" in health["slos"]

        # -- cfs-trace --prof rides the same side-door
        from chubaofs_tpu_torch.tools.cfstrace import main as trace_main

        buf = io.StringIO()
        assert trace_main(["--prof", "0.2", "--addr", srv.addr],
                          out=buf) == 0
        assert ";" in buf.getvalue()  # collapsed-stack lines
    finally:
        srv.stop()
        ev.stop()
        lst.close()


def test_cfstop_split_rollup_marks_unreachable():
    from chubaofs_tpu_torch.tools.cfstop import split_rollup

    text = ("# == target 1.2.3.4:17010 ==\n"
            "# TYPE cfs_access_put histogram\n"
            "cfs_access_put_count 7\n"
            "# == target 5.6.7.8:17010 UNREACHABLE: timed out ==\n"
            "# == target 9.9.9.9:17010 ==\n"
            "cfs_evloop_backpressure{shard=\"0\",srv=\"pkt\"} 3\n")
    sections = split_rollup(text)
    assert sections["1.2.3.4:17010"]["cfs_access_put_count"] == 7.0
    assert sections["5.6.7.8:17010"] is None
    assert len(sections["9.9.9.9:17010"]) == 1


def test_cfstop_row_math():
    from chubaofs_tpu_torch.tools.cfstop import compute_row

    prev = {"cfs_access_put_count": 100.0,
            'cfs_access_put_bucket{le="0.01"}': 100.0,
            "cfs_codec_batch_jobs_sum": 40.0,
            "cfs_codec_batch_jobs_count": 10.0,
            'cfs_evloop_backpressure{shard="0",srv="pkt"}': 0.0}
    cur = {"cfs_access_put_count": 150.0,
           'cfs_access_put_bucket{le="0.01"}': 150.0,
           "cfs_codec_batch_jobs_sum": 120.0,
           "cfs_codec_batch_jobs_count": 20.0,
           'cfs_evloop_backpressure{shard="0",srv="pkt"}': 5.0,
           'cfs_evloop_conns{inst="0",shard="0",srv="pkt"}': 3.0,
           'cfs_scheduler_tasks{kind="repair",state="pending"}': 2.0}
    row = compute_row("t:1", prev, cur, 10.0, {"status": "ok"})
    assert row["put_s"] == 5.0
    assert row["put99_ms"] == 10.0
    assert row["conns"] == 3 and row["bp_s"] == 0.5
    assert row["codec_occ"] == 8.0  # (120-40)/(20-10)
    assert row["repair_q"] == 2 and row["slo"] == "ok"
    # an unreachable target renders as a failing row, never vanishes
    dead = compute_row("t:2", None, None, 10.0, None)
    assert dead["slo"] == "failing" and dead["unreachable"]
    # no prior frame (first poll / last scrape failed): flow cells stay
    # None — a delta against zero would render lifetime totals as a rate
    fresh = compute_row("t:3", None, cur, 10.0, {"status": "ok"})
    assert fresh.get("put_s") is None and fresh.get("put99_ms") is None
    assert fresh["conns"] == 3 and fresh["repair_q"] == 2  # state still reads
    # a transient metrics-scrape failure must not overwrite a live health
    # verdict: the row keeps 'ok' with empty cells, no unreachable flag
    hiccup = compute_row("t:4", prev, None, 10.0, {"status": "ok",
                                                   "reasons": []})
    assert hiccup["slo"] == "ok" and not hiccup.get("unreachable")
    # daemon restarted between polls (counter went DOWN): the post-restart
    # total is the window's delta — a busy restarted daemon is not idle
    restarted = dict(cur, **{"cfs_access_put_count": 40.0})
    row = compute_row("t:5", prev, restarted, 10.0, {"status": "ok"})
    assert row["put_s"] == 4.0  # 40 post-restart ops / 10s, not 0


def test_cfstop_once_over_console():
    """cfs-top --once polls a real console rollup and renders one frame."""
    from chubaofs_tpu_torch.console.server import Console
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer
    from chubaofs_tpu_torch.tools import cfstop

    srv = RPCServer(Router(), module="toptarget").start()
    console = Console([srv.addr])
    try:
        buf = io.StringIO()
        rc = cfstop.main(["--console", console.addr, "--once",
                          "--interval", "0.3"], out=buf)
        text = buf.getvalue()
        assert rc == 0
        assert srv.addr in text and "SLO" in text
        assert "cluster: ok" in text, text
        # JSON mode for scripts
        buf = io.StringIO()
        rc = cfstop.main(["--console", console.addr, "--once",
                          "--interval", "0.2", "--json"], out=buf)
        rows = json.loads(buf.getvalue())["rows"]
        assert rc == 0 and rows[0]["target"] == srv.addr
    finally:
        console.stop()
        srv.stop()
