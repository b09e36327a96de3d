"""The cases of tests/test_locks.py, run against the port on the CPU.

Runtime lock-order sanitizer (utils/locks.py): a deliberately inverted lock
pair is reported as a potential deadlock, and a full MiniCluster(device=
"cpu") PUT+GET running under CFS_LOCK_SANITIZER=1 (armed suite-wide by
tests/conftest.py) reports ZERO inversions. A recorded acquire site names
the file that took the lock: this one, test_torch_locks.py.
"""

import threading

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.utils import locks
from chubaofs_tpu_torch.utils.locks import SanitizedLock, SanitizedRLock


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


@pytest.fixture(autouse=True)
def _fresh_graph():
    """Each test starts with an empty order graph (the process-global graph
    accumulates edges from every suite that ran before us)."""
    locks.reset()
    yield
    locks.reset()


# -- activation gate ----------------------------------------------------------


def test_disabled_returns_plain_primitives(monkeypatch):
    monkeypatch.setenv("CFS_LOCK_SANITIZER", "0")
    lk = SanitizedLock(name="x")
    rl = SanitizedRLock(name="y")
    assert not isinstance(lk, locks._SanLock)
    assert not isinstance(rl, locks._SanLock)
    # the zero-overhead contract: these ARE the threading primitives
    assert type(lk) is type(threading.Lock())
    assert type(rl) is type(threading.RLock())


def test_enabled_wraps_and_still_locks(monkeypatch):
    monkeypatch.setenv("CFS_LOCK_SANITIZER", "1")
    lk = SanitizedLock(name="t.basic")
    assert isinstance(lk, locks._SanLock)
    with lk:
        assert lk.locked()
    assert not lk.locked()
    assert lk.acquire(blocking=False)
    lk.release()


# -- inversion detection ------------------------------------------------------


def test_inversion_reported_once_per_pair(monkeypatch):
    monkeypatch.setenv("CFS_LOCK_SANITIZER", "1")
    a = SanitizedLock(name="t.inv.A")
    b = SanitizedLock(name="t.inv.B")
    with a:
        with b:  # establishes A -> B
            pass
    assert locks.inversions() == []
    for _ in range(3):  # B -> A: the cycle; deduped per pair
        with b:
            with a:
                pass
    invs = [r for r in locks.inversions() if "t.inv.A" in (r["first"],
                                                           r["then"])]
    assert len(invs) == 1
    rec = invs[0]
    assert {rec["first"], rec["then"]} == {"t.inv.A", "t.inv.B"}
    # the report carries actionable sites: this file, both directions
    assert "test_torch_locks.py" in rec["acquire_site"]
    assert "test_torch_locks.py" in rec["reverse_site"]
    # and the metric surfaced (cfs_lock_inversion)
    from chubaofs_tpu_torch.utils.exporter import registry

    text = registry("lock").render()
    assert "cfs_lock_inversion" in text


def test_consistent_order_and_reentrancy_are_clean(monkeypatch):
    monkeypatch.setenv("CFS_LOCK_SANITIZER", "1")
    outer = SanitizedRLock(name="t.ord.outer")
    inner = SanitizedLock(name="t.ord.inner")

    def worker():
        for _ in range(50):
            with outer:
                with outer:  # reentrant re-acquire: not an ordering
                    with inner:
                        pass

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert locks.inversions() == []


def test_same_name_siblings_do_not_self_cycle(monkeypatch):
    monkeypatch.setenv("CFS_LOCK_SANITIZER", "1")
    q1 = SanitizedLock(name="t.sib")
    q2 = SanitizedLock(name="t.sib")
    with q1:
        with q2:
            pass
    with q2:
        with q1:
            pass
    assert locks.inversions() == []


def test_cross_thread_inversion_detected(monkeypatch):
    """The deadlock shape that matters: thread 1 takes A->B, thread 2 takes
    B->A. Serialized here (so the test can't actually deadlock), but the
    order graph is global and still sees the cycle."""
    monkeypatch.setenv("CFS_LOCK_SANITIZER", "1")
    a = SanitizedLock(name="t.x.A")
    b = SanitizedLock(name="t.x.B")

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    t1 = threading.Thread(target=forward)
    t1.start()
    t1.join()
    t2 = threading.Thread(target=backward)
    t2.start()
    t2.join()
    assert any({r["first"], r["then"]} == {"t.x.A", "t.x.B"}
               for r in locks.inversions())


def test_cross_thread_release_leaves_no_phantom_edges(monkeypatch):
    """threading.Lock allows handoff: acquire in one thread, release in
    another. The acquirer's stale held-stack entry must not mint order
    edges on its next acquire (a phantom edge later reads as a phantom
    deadlock)."""
    monkeypatch.setenv("CFS_LOCK_SANITIZER", "1")
    a = SanitizedLock(name="t.handoff.A")
    b = SanitizedLock(name="t.handoff.B")
    assert a.acquire()
    t = threading.Thread(target=a.release)  # handoff release
    t.start()
    t.join()
    with b:  # without reconciliation this would record A -> B
        pass
    rep = locks.report()
    assert rep["edges"] == 0, rep
    assert locks.inversions() == []


# -- hold-time outliers -------------------------------------------------------


def test_hold_outlier_recorded(monkeypatch):
    monkeypatch.setenv("CFS_LOCK_SANITIZER", "1")
    monkeypatch.setenv("CFS_LOCK_HOLD_MS", "1")
    lk = SanitizedLock(name="t.hold")
    import time

    with lk:
        time.sleep(0.01)
    recs = [r for r in locks.hold_outliers() if r["name"] == "t.hold"]
    assert recs and recs[0]["hold_ms"] >= 1.0
    assert "test_torch_locks.py" in recs[0]["site"]


def test_report_rollup(monkeypatch):
    monkeypatch.setenv("CFS_LOCK_SANITIZER", "1")
    a = SanitizedLock(name="t.rep.A")
    b = SanitizedLock(name="t.rep.B")
    with a:
        with b:
            pass
    rep = locks.report()
    assert rep["inversions"] == []
    assert rep["edges"] >= 1 and rep["locks_tracked"] >= 1


# -- tier-1 acceptance: a full e2e under the sanitizer is inversion-free ------


def test_minicluster_put_get_zero_inversions(tmp_path, rng):
    """PUT+GET across access/proxy/clustermgr/blobnode/codec with every hot
    lock named and sanitized (conftest arms CFS_LOCK_SANITIZER suite-wide):
    the data path must hold a consistent lock order end to end."""
    from chubaofs_tpu_torch.blobstore.cluster import MiniCluster

    if not locks.enabled():
        # the documented CFS_LOCK_SANITIZER=0 timing-comparison mode: the
        # probe has nothing to observe, and "not armed" is not a failure
        pytest.skip("sanitizer disarmed via CFS_LOCK_SANITIZER=0")
    before = {frozenset((r["first"], r["then"]))
              for r in locks.inversions()}
    mc = MiniCluster(str(tmp_path), n_nodes=6, disks_per_node=2, device=CPU)
    try:
        data = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
        loc = mc.access.put(data)
        assert mc.access.get(loc) == data
    finally:
        mc.close()
    new = [r for r in locks.inversions()
           if frozenset((r["first"], r["then"])) not in before]
    assert new == [], f"lock-order inversions on the PUT/GET path: {new}"
    # the instrumentation actually ran: named locks observed hold times
    from chubaofs_tpu_torch.utils.exporter import registry

    assert "cfs_lock_hold_ms" in registry("lock").render()
