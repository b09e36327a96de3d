"""The cases of tests/test_qos.py, run against the port on the CPU: every
name and assertion as in the reference, imports from chubaofs_tpu_torch,
and every FsCluster built with device="cpu".

The reference file's docstring:

Per-tenant QoS plane: bucket hierarchy, deficit-fair
dequeue, throttle surfaces (429/Retry-After/503, metrics, events, SLOs),
and the zero-overhead-unarmed contract on the S3 gateway."""

import http.client
import threading
import time

import pytest

from chubaofs_tpu_torch.utils.qos import ANON, OTHER, Decision, FairLimiter, QosPlane
from chubaofs_tpu_torch import chaos as t_chaos


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture(autouse=True)
def _qos_hygiene():
    """Every test leaves no provider / bounded-label / plane residue."""
    yield
    from chubaofs_tpu_torch.utils import qos as qosmod
    from chubaofs_tpu_torch.utils import slo
    from chubaofs_tpu_torch.utils.exporter import declare_label_values

    for name in [n for n in slo._slo_providers if n.startswith("qos")]:
        slo.unregister_slo_provider(name)
    qosmod._active_planes.clear()
    declare_label_values("tenant", None)


# -- FairLimiter ---------------------------------------------------------------


def test_hard_cap_denies_outright_with_retry_after():
    lim = FairLimiter("rate", parent_rate=0, tenant_rate=5)
    admits = sum(lim.admit("t0", 1).ok for _ in range(20))
    assert admits == 5  # the burst, then denial
    d = lim.admit("t0", 1)
    assert (d.ok, d.status, d.bucket, d.reason) == (
        False, 429, "rate", "tenant_cap")
    assert d.retry_after > 0
    # another tenant's cap is its own
    assert lim.admit("t1", 1).ok


def test_lone_tenant_is_work_conserving():
    lim = FairLimiter("rate", parent_rate=50, tenant_rate=0, queue_ms=50)
    assert sum(lim.admit("solo", 1).ok for _ in range(50)) == 50


def test_reserve_bucket_admits_without_queueing():
    lim = FairLimiter("rate", parent_rate=10, tenant_rate=0,
                      reserve_rate=5, queue_ms=200)
    while lim.parent.try_acquire(1):
        pass  # drain the parent: only reserves admit now
    t0 = time.monotonic()
    assert lim.admit("vip", 1).ok
    assert time.monotonic() - t0 < 0.05  # no fair-queue wait


def test_queue_overflow_is_503_queue_full():
    lim = FairLimiter("rate", parent_rate=1, tenant_rate=0,
                      queue_ms=300, queue_len=2)
    while lim.parent.try_acquire(1):
        pass
    waiters = [threading.Thread(target=lambda: lim.admit("t", 1))
               for _ in range(2)]
    for w in waiters:
        w.start()
    time.sleep(0.05)  # both parked in the tenant queue
    d = lim.admit("t", 1)
    assert (d.ok, d.status, d.reason) == (False, 503, "queue_full")
    for w in waiters:
        w.join()


def test_deficit_fair_dequeue_protects_paced_tenant():
    """Noisy floods from 4 threads; a victim paced at ~10 rps must get
    every one of its requests granted from the shared parent (40 rps) with
    bounded waits — the deficit-RR wheel alternates grants instead of
    feeding whoever camps at the head."""
    lim = FairLimiter("rate", parent_rate=40, tenant_rate=0, queue_ms=400)
    while lim.parent.try_acquire(1):
        pass
    stats = {"victim_ok": 0, "victim_thr": 0, "noisy_ok": 0}
    stop = time.monotonic() + 1.5

    def noisy():
        while time.monotonic() < stop:
            if lim.admit("noisy", 1).ok:
                stats["noisy_ok"] += 1

    def victim():
        while time.monotonic() < stop:
            d = lim.admit("victim", 1)
            stats["victim_ok" if d.ok else "victim_thr"] += 1
            time.sleep(0.1)

    ts = [threading.Thread(target=noisy) for _ in range(4)] \
        + [threading.Thread(target=victim)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert stats["victim_thr"] == 0, stats
    assert stats["victim_ok"] >= 8, stats
    assert stats["noisy_ok"] > stats["victim_ok"], stats  # work-conserving


def test_bandwidth_debit_goes_negative_and_recovers():
    lim = FairLimiter("bandwidth", parent_rate=1 << 20, tenant_rate=0,
                      quantum=64 << 10, queue_ms=10)
    assert lim.admit("t", 64 << 10).ok
    lim.debit("t", 10 << 20)  # a huge GET response: bucket goes negative
    d = lim.admit("t", 64 << 10)
    assert not d.ok and d.retry_after > 1.0  # debt must refill first


# -- QosPlane ------------------------------------------------------------------


def test_from_env_unarmed_returns_none(monkeypatch):
    for k in ("CFS_QOS_RPS", "CFS_QOS_BW_MB", "CFS_QOS_TENANT_RPS",
              "CFS_QOS_TENANT_BW_MB"):
        monkeypatch.delenv(k, raising=False)
    assert QosPlane.from_env() is None


def test_unarmed_objectnode_installs_no_middleware(monkeypatch, tmp_path):
    """The zero-overhead contract: CFS_QOS_* unset means the middleware is
    simply NOT installed — no per-request check, disabled or otherwise."""
    for k in ("CFS_QOS_RPS", "CFS_QOS_BW_MB", "CFS_QOS_TENANT_RPS",
              "CFS_QOS_TENANT_BW_MB"):
        monkeypatch.delenv(k, raising=False)
    from chubaofs_tpu_torch.deploy import FsCluster
    from chubaofs_tpu_torch.objectnode.server import ObjectNode

    cluster = FsCluster(str(tmp_path), n_nodes=3, blob_nodes=6, data_nodes=0,
                        device="cpu")
    try:
        node = ObjectNode(cluster, users={"ak": {"secret_key": "sk"}})
        assert node.qos is None
        assert node.router.middleware == []
    finally:
        cluster.close()


def test_label_folding_bounds_cardinality():
    plane = QosPlane(("good",), rps=1000)
    try:
        assert plane.label("good") == "good"
        assert plane.label(None) == ANON
        assert plane.label("attacker-minted-key") == OTHER
        # an undeclared tenant's metrics land on the bounded OTHER series
        assert plane.admit("random1") is None
        assert plane.admit("random2") is None
    finally:
        plane.close()


def test_per_tenant_slos_flip_only_for_the_throttled_tenant():
    """The fairness verdict: synthetic snapshot windows where the noisy
    tenant's throttle ratio breaches and the victim's is zero — only the
    noisy tenant's qos_throttle SLO goes failing."""
    from chubaofs_tpu_torch.utils import slo

    plane = QosPlane(("noisy", "victim"), rps=100)
    try:
        slos = [s for s in slo.default_slos()
                if s.name.startswith("qos_throttle:")]
        assert {s.name for s in slos} >= {
            "qos_throttle:noisy", "qos_throttle:victim"}

        def snap(mono, noisy_req, noisy_thr, victim_req):
            return {"mono": mono, "metrics": {
                'cfs_objectnode_requests{tenant="noisy"}': noisy_req,
                'cfs_objectnode_throttled{bucket="rate",reason="saturated",'
                'tenant="noisy"}': noisy_thr,
                'cfs_objectnode_requests{tenant="victim"}': victim_req,
            }}

        snaps = [snap(float(i), 100.0 * i, 80.0 * i, 10.0 * i)
                 for i in range(13)]
        rep = slo.evaluate(slos, snaps, fast_n=3, slow_n=12,
                           track_flips=False, publish=False)
        assert rep["slos"]["qos_throttle:noisy"]["status"] == "failing"
        assert rep["slos"]["qos_throttle:victim"]["status"] == "ok"
    finally:
        plane.close()


# -- end-to-end over the S3 surface --------------------------------------------


@pytest.fixture(scope="module")
def s3qos(tmp_path_factory):
    from chubaofs_tpu_torch.deploy import FsCluster
    from chubaofs_tpu_torch.objectnode.server import ObjectNode
    from chubaofs_tpu_torch.rpc.server import RPCServer

    root = tmp_path_factory.mktemp("s3qos")
    cluster = FsCluster(str(root), n_nodes=3, blob_nodes=6, data_nodes=0,
                        device="cpu")
    qos = QosPlane(("noisyak", "quietak"), rps=5, queue_ms=40, queue_len=4)
    node = ObjectNode(cluster, users={
        "noisyak": {"secret_key": "nsk", "uid": "noisy"},
        "quietak": {"secret_key": "qsk", "uid": "quiet"},
    }, qos=qos)
    srv = RPCServer(node.router, metrics=False, module="objectnode").start()
    yield srv
    srv.stop()
    qos.close()
    cluster.close()


def _s3req(srv, method, path, ak, sk, body=b""):
    from chubaofs_tpu_torch.objectnode.auth import sign_v4

    hdrs = sign_v4(method, path, "", {"host": srv.addr}, ak, sk, payload=body)
    host, port = srv.addr.rsplit(":", 1)
    c = http.client.HTTPConnection(host, int(port))
    try:
        c.request(method, path, body=body, headers=hdrs)
        r = c.getresponse()
        return r.status, r.getheader("Retry-After"), r.read()
    finally:
        c.close()


def test_gateway_throttles_with_retry_after_metrics_event(s3qos, tmp_path):
    from chubaofs_tpu_torch.utils import events
    from chubaofs_tpu_torch.utils.exporter import render_all

    events.configure(logdir=str(tmp_path))
    assert _s3req(s3qos, "PUT", "/tb", "noisyak", "nsk")[0] == 200
    assert _s3req(s3qos, "PUT", "/tb/k", "noisyak", "nsk", b"v")[0] == 200
    statuses = [_s3req(s3qos, "GET", "/tb/k", "noisyak", "nsk")
                for _ in range(30)]
    throttled = [s for s in statuses if s[0] in (429, 503)]
    assert throttled, statuses
    status, retry_after, body = throttled[0]
    assert retry_after and int(retry_after) >= 1
    assert b"SlowDown" in body
    txt = render_all()
    assert any(ln.startswith("cfs_objectnode_throttled")
               and 'tenant="noisyak"' in ln for ln in txt.splitlines())
    evs = events.recent(50, types=("qos_throttle",))
    assert evs, "qos_throttle missing from the timeline"
    det = evs[-1]["detail"]
    # the cfs-events satellite: tenant, bucket, deficit in the detail dict
    assert det["tenant"] == "noisyak" and det["bucket"] == "rate"
    assert "deficit" in det and "reason" in det
    # cfs-events CLI renders it
    from chubaofs_tpu_torch.tools.cfsevents import fmt_event

    line = fmt_event(evs[-1])
    assert "qos_throttle" in line and "tenant=noisyak" in line \
        and "deficit=" in line


def test_cfstop_thr_column_row_math():
    from chubaofs_tpu_torch.tools.cfstop import COLUMNS, compute_row, render

    assert "THR%" in COLUMNS
    base = {"cfs_boot_time_seconds": time.time() - 5}
    prev = {**base, 'cfs_objectnode_requests{tenant="t"}': 100.0,
            'cfs_objectnode_throttled{tenant="t"}': 10.0}
    cur = {**base, 'cfs_objectnode_requests{tenant="t"}': 200.0,
           'cfs_objectnode_throttled{tenant="t"}': 60.0}
    row = compute_row("x:1", prev, cur, 1.0, {"status": "ok"})
    assert row["thr_pct"] == 50.0  # 50 throttled of 100 new requests
    out = render([row])
    assert "THR%" in out and "50" in out
    # a target with no shaped requests renders '-'
    row = compute_row("y:1", base, dict(base), 1.0, {"status": "ok"})
    assert row["thr_pct"] is None


def test_cost_above_burst_is_admitted_and_paced():
    """Review regression: a 20MiB PUT under a 10MiB/s cap must be ADMITTED
    (clamped acquire + debt for the remainder) and pace the tenant via the
    negative balance — not 429 forever with a Retry-After that lies."""
    cap = 1 << 20
    lim = FairLimiter("bandwidth", parent_rate=cap, tenant_rate=0,
                      quantum=64 << 10, queue_ms=30)
    d = lim.admit("t", 3 * cap)  # 3x the burst: previously unadmittable
    assert d.ok
    # the debt paces: an immediate follow-up is denied until it refills
    assert not lim.admit("t", cap).ok
    # hard-cap path too: oversized cost passes the cap bucket once
    lim2 = FairLimiter("bandwidth", parent_rate=0, tenant_rate=cap,
                       quantum=64 << 10)
    assert lim2.admit("t", 3 * cap).ok
    assert not lim2.admit("t", cap).ok


def test_waiter_herd_bounded_below_worker_pool(monkeypatch):
    """Review regression: queued waiters park dispatch workers; the plane
    bounds them to half the evloop pool so a flood fails fast (429) past
    the bound instead of starving every worker for queue_ms."""
    monkeypatch.setenv("CFS_EVLOOP_WORKERS", "8")
    lim = FairLimiter("rate", parent_rate=1, tenant_rate=0,
                      queue_ms=500, queue_len=64)
    assert lim.max_waiting == 4
    while lim.parent.try_acquire(1):
        pass
    threads = [threading.Thread(target=lambda: lim.admit("t", 1))
               for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)  # all four parked
    t0 = time.monotonic()
    d = lim.admit("t", 1)
    assert not d.ok and d.reason == "saturated"
    assert time.monotonic() - t0 < 0.2  # failed FAST, didn't park a fifth
    for t in threads:
        t.join()


def test_two_planes_coexist_without_clobbering():
    """Review regression: a second plane in the process must not shrink the
    first's declared tenant set (ValueError -> 500 on its admits) nor
    unregister its SLOs on close."""
    from chubaofs_tpu_torch.utils import slo

    a = QosPlane(("ak-a",), rps=1000)
    b = QosPlane(("ak-b",), rps=1000)
    try:
        assert a.admit("ak-a") is None  # would raise if b clobbered labels
        assert b.admit("ak-b") is None
        b.close()
        assert a.admit("ak-a") is None  # close(b) must not strip a's bound
        names = {s.name for s in slo.default_slos()}
        assert "qos_throttle:ak-a" in names
        assert "qos_throttle:ak-b" not in names
    finally:
        a.close()
