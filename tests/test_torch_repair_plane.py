"""The cases of tests/test_repair_plane.py, run against the port on the CPU.

Repair plane robustness: detection (scrub + heartbeat expiry), leased
scheduling (reaper, stale reports, crash-restart re-lease), and the
pipelined rebuild's observable overlap, on MiniCluster(device="cpu"). The
kill-a-blobnode soak runs here at smoke size through
chaos/soak.run_kill_soak(device="cpu"); chip_smoke.py runs it at full size
on the card."""

import time

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
from chubaofs_tpu_torch.blobstore.clustermgr import (
    DISK_BROKEN,
    DISK_DROPPED,
    DISK_NORMAL,
)
from chubaofs_tpu_torch.blobstore.scheduler import (
    TASK_FAILED,
    TASK_FINISHED,
    TASK_PREPARED,
    TASK_WORKING,
    RepairWorker,
    Scheduler,
    stage_overlap_ratio,
)
from chubaofs_tpu_torch.codec.codemode import CodeMode
from chubaofs_tpu_torch.utils.exporter import registry


CPU = "cpu"
# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    chaos.reset()


def blob_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _counter(name, labels=None):
    return registry("scheduler").counter(name, labels).value


@pytest.fixture
def cluster(tmp_path):
    c = MiniCluster(str(tmp_path), n_nodes=9, disks_per_node=2, device=CPU)
    yield c
    c.close()


# -- leased scheduling ---------------------------------------------------------


def test_lease_expiry_reaps_and_requeues_with_backoff(cluster, rng):
    """A WORKING task whose worker went dark is reaped on lease expiry:
    requeued behind a backoff gate, counted by cfs_scheduler_lease_expired,
    and the next acquire hands out a HIGHER lease number."""
    sched = cluster.scheduler
    sched.lease_ms = 40
    sched.requeue_backoff_s = 0.05
    cluster.proxy.send_shard_repair(1, 77, [0], "test")
    sched.poll_repair_topic()
    t = sched.acquire_task()
    assert t is not None and t.state == TASK_WORKING
    lease1 = t.lease
    assert lease1 > 0
    assert sched.acquire_task() is None  # never handed out twice
    assert sched.reap_expired() == 0  # deadline not reached yet
    time.sleep(0.08)
    before = _counter("lease_expired")
    assert sched.reap_expired() == 1
    assert _counter("lease_expired") == before + 1
    assert t.state == TASK_PREPARED
    assert sched.acquire_task() is None, "requeue backoff must gate re-lease"
    time.sleep(0.08)
    t2 = sched.acquire_task()
    assert t2 is not None and t2.task_id == t.task_id
    assert t2.lease == lease1 + 1, "re-lease must advance the lease number"


def test_lease_renewal_outruns_reaper_and_expiry_cap_fails_terminal(
        cluster, rng):
    """A healthy-but-slow worker renews its lease between units and never
    loses a race against the reaper; a task whose every execution dies
    (expires max_lease_expiries times) goes terminal FAILED instead of
    re-executing forever."""
    sched = cluster.scheduler
    sched.lease_ms = 40
    sched.requeue_backoff_s = 0.01
    sched.requeue_backoff_cap_s = 0.01
    cluster.proxy.send_shard_repair(3, 99, [2], "test")
    sched.poll_repair_topic()
    t = sched.acquire_task()
    lease = t.lease
    # renewal pushes the deadline out: after the original lease would have
    # expired, the reaper finds nothing
    time.sleep(0.03)
    assert sched.renew_lease(t.task_id, lease) is True
    time.sleep(0.02)  # past the ORIGINAL deadline, inside the renewed one
    assert sched.reap_expired() == 0
    # a wrong lease (reaped + re-leased elsewhere) must refuse to renew
    assert sched.renew_lease(t.task_id, lease + 1) is False
    assert sched.renew_lease("t424242", 1) is False
    assert sched.report_task(t.task_id, ok=True, lease=lease) is True

    # expiry cap: never-reporting executions exhaust into terminal FAILED
    sched.max_lease_expiries = 3
    cluster.proxy.send_shard_repair(4, 100, [1], "test")
    sched.poll_repair_topic()
    before = _counter("lease_expired_failed")
    for i in range(3):
        time.sleep(0.02)  # clear the requeue backoff gate
        t = sched.acquire_task()
        assert t is not None, f"expiry {i}: task must still be re-leasable"
        time.sleep(0.05)  # worker dies without reporting
        assert sched.reap_expired() == 1
    assert t.state == TASK_FAILED
    assert "lease expired" in t.error
    assert _counter("lease_expired_failed") == before + 1
    assert sched.acquire_task() is None, "FAILED is terminal: no re-lease"


def test_stale_reports_dropped_with_reason_never_crash(cluster, rng):
    """Late/stale worker reports — unknown id (pruned table or
    reloaded scheduler), a task the reaper already requeued, or a lease that
    was reissued — are DROPPED with cfs_scheduler_stale_report{reason}, and
    report_task returns False instead of raising."""
    sched = cluster.scheduler

    before = _counter("stale_report", {"reason": "pruned"})
    assert sched.report_task("t999999", ok=True) is False
    assert _counter("stale_report", {"reason": "pruned"}) == before + 1

    cluster.proxy.send_shard_repair(2, 88, [1], "test")
    sched.poll_repair_topic()
    (task,) = sched.tasks(state=TASK_PREPARED)
    before = _counter("stale_report", {"reason": "not_working"})
    assert sched.report_task(task.task_id, ok=True) is False
    assert _counter("stale_report", {"reason": "not_working"}) == before + 1
    assert task.state == TASK_PREPARED, "a stale report must not move state"

    sched.lease_ms = 30
    sched.requeue_backoff_s = 0.01
    t1 = sched.acquire_task()
    old_lease = t1.lease
    time.sleep(0.05)
    assert sched.reap_expired() == 1
    time.sleep(0.03)
    t2 = sched.acquire_task()
    assert t2.task_id == t1.task_id and t2.lease == old_lease + 1
    before = _counter("stale_report", {"reason": "lease"})
    assert sched.report_task(t1.task_id, ok=True, lease=old_lease) is False
    assert _counter("stale_report", {"reason": "lease"}) == before + 1
    assert t2.state == TASK_WORKING
    # the CURRENT leaseholder's report is accepted
    assert sched.report_task(t2.task_id, ok=True, lease=t2.lease) is True
    assert t2.state == TASK_FINISHED


@pytest.mark.chaos
def test_crash_restart_mid_repair_releases_exactly_once(cluster, rng):
    """The scheduler dies between task acquire and report. The
    reloaded scheduler must re-queue the task, hand it out exactly once with
    a lease STRICTLY ABOVE every pre-crash lease (the persisted lease floor),
    drop the pre-crash worker's late report as stale, and idempotent
    write-back must leave the stripe byte-identical."""
    data = blob_bytes(rng, 2_000_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    blob = loc.blobs[0]
    vol = cluster.cm.get_volume(blob.vid)
    killed = [3, 9]
    for idx in killed:
        unit = vol.units[idx]
        cluster.nodes[unit.node_id].lose_shard(unit.vuid, blob.bid)
    cluster.proxy.send_shard_repair(blob.vid, blob.bid, killed, "test")
    cluster.scheduler.poll_repair_topic()
    t1 = cluster.scheduler.acquire_task()
    assert t1 is not None and t1.kind == "shard_repair"
    pre_crash_lease = t1.lease

    # crash: a FRESH scheduler reloads the persisted table (the old one is
    # simply abandoned, as a dead process's memory would be)
    sched2 = Scheduler(cluster.cm, cluster.proxy, cluster.nodes,
                       codec=cluster.codec)
    (reloaded,) = sched2.tasks(kind="shard_repair")
    assert reloaded.task_id == t1.task_id
    assert reloaded.state == TASK_PREPARED, "WORKING must demote on reload"

    t2 = sched2.acquire_task()
    assert t2 is not None and t2.task_id == t1.task_id
    assert t2.lease == pre_crash_lease + 1, \
        "re-leased more or less than exactly once after the crash"
    assert sched2.acquire_task() is None

    # the pre-crash worker limps back with its old lease: dropped, no crash
    before = _counter("stale_report", {"reason": "lease"})
    assert sched2.report_task(t1.task_id, ok=True,
                              lease=pre_crash_lease) is False
    assert _counter("stale_report", {"reason": "lease"}) == before + 1
    assert t2.state == TASK_WORKING

    # the new leaseholder repairs; write-back is idempotent, so ALSO
    # re-executing the repair (the lease-expiry double-run) cannot corrupt
    w2 = RepairWorker(sched2, cluster.nodes, codec=cluster.codec)
    try:
        for _ in range(2):
            w2._repair_shards(blob.vid, blob.bid, killed)
        assert sched2.report_task(t2.task_id, ok=True, lease=t2.lease) is True
    finally:
        w2.close()
    assert t2.state == TASK_FINISHED
    for idx in killed:
        unit = vol.units[idx]
        assert cluster.nodes[unit.node_id].get_shard(unit.vuid, blob.bid)
    assert cluster.access.get(loc) == data
    assert not sched2.tasks(state=TASK_WORKING)


def test_lease_numbers_survive_reload(cluster, rng):
    """The lease floor persists: tasks acquired (but never reported) before
    a crash can never see their lease number reissued by the successor."""
    cluster.proxy.send_shard_repair(5, 55, [2], "test")
    cluster.scheduler.poll_repair_topic()
    leases = []
    sched = cluster.scheduler
    sched.lease_ms = 20
    sched.requeue_backoff_s = 0.0
    for _ in range(3):  # 3 expiry cycles push the in-memory seq to 3
        leases.append(sched.acquire_task().lease)
        time.sleep(0.03)
        sched.reap_expired()
    sched2 = Scheduler(cluster.cm, cluster.proxy, cluster.nodes,
                       codec=cluster.codec)
    t = sched2.acquire_task()
    assert t.lease > max(leases)


# -- typed probe failures + read deadlines -------------------------------------


@pytest.mark.chaos
def test_probe_deadline_and_typed_failure_metrics(cluster, rng):
    """A wedged blobnode costs the probe at most read_deadline and lands in
    cfs_scheduler_probe_fail{reason=timeout}; an absent shard is 'missing';
    survivors still arrive and feed the repair-traffic byte accounting."""
    data = blob_bytes(rng, 2_000_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    blob = loc.blobs[0]
    vol = cluster.cm.get_volume(blob.vid)
    t = vol.tactic()
    worker = RepairWorker(cluster.scheduler, cluster.nodes,
                          codec=cluster.codec, read_deadline=0.3)
    hung = vol.units[1].node_id
    gone = vol.units[4]
    cluster.nodes[gone.node_id].lose_shard(gone.vuid, blob.bid)
    chaos.arm("blobnode.get_shard", "hang", node=hung)
    try:
        t0 = time.monotonic()
        b_timeout = _counter("probe_fail", {"reason": "timeout"})
        b_missing = _counter("probe_fail", {"reason": "missing"})
        b_bytes = _counter("repair_bytes_downloaded")
        reads = worker._probe(vol, blob.bid, range(t.total))
        dt = time.monotonic() - t0
        assert dt < 2.0, f"probe ran {dt:.2f}s past its deadline"
        assert 1 not in reads and 4 not in reads
        assert len(reads) >= t.N
        assert _counter("probe_fail", {"reason": "timeout"}) >= b_timeout + 1
        assert _counter("probe_fail", {"reason": "missing"}) == b_missing + 1
        assert _counter("repair_bytes_downloaded") > b_bytes
    finally:
        chaos.reset()
        worker.close()


def test_classify_io_error_taxonomy():
    from concurrent.futures import TimeoutError as FutTimeout

    from chubaofs_tpu_torch.blobstore.blobnode import NoSuchShard, classify_io_error
    from chubaofs_tpu_torch.chaos.failpoints import FailpointError

    assert classify_io_error(NoSuchShard("x")) == "missing"
    assert classify_io_error(TimeoutError()) == "timeout"
    assert classify_io_error(FutTimeout()) == "timeout"
    assert classify_io_error(OSError("disk")) == "io"
    assert classify_io_error(FailpointError("injected")) == "io"
    assert classify_io_error(ValueError("bug")) == "error"


# -- detection: budgeted scrub loop --------------------------------------------


def test_scrub_cursor_resumes_across_restart(tmp_path):
    """scrub_once walks live shards in (vuid, bid) order, max_shards per
    tick, and the cursor persists in the metadb: a restarted node resumes
    mid-sweep instead of rescanning from shard zero."""
    from chubaofs_tpu_torch.blobstore.blobnode import BlobNode

    node = BlobNode(node_id=1, disk_roots=[str(tmp_path / "d0")],
                    scrub_rate=0)  # no byte budget: isolate the cursor
    vuid = 4096  # make_vuid(1, 0, 0)-shaped; any int works for a bare node
    node.create_vuid(vuid)
    for bid in range(10):
        node.put_shard(vuid, bid, b"x" * 512)
    r1 = node.scrub_once(max_shards=4)
    assert r1 == {"scanned": 4, "bad": [], "complete": False}
    cursor = node._scrub_cursor
    assert cursor == (vuid, 3)
    node.close()

    node2 = BlobNode(node_id=1, disk_roots=[str(tmp_path / "d0")],
                     scrub_rate=0)
    assert node2._scrub_cursor == cursor, "cursor lost across restart"
    r2 = node2.scrub_once(max_shards=4)
    assert r2["scanned"] == 4 and not r2["complete"]
    r3 = node2.scrub_once(max_shards=4)
    assert r3["scanned"] == 2 and r3["complete"], "sweep must wrap"
    assert node2._scrub_cursor is None
    node2.close()


def test_scrub_token_bucket_bounds_bytes(tmp_path):
    """CFS_SCRUB_RATE is a byte budget: a starved bucket stops the tick
    early (scanned < max_shards) instead of hammering the disks."""
    from chubaofs_tpu_torch.blobstore.blobnode import BlobNode

    node = BlobNode(node_id=2, disk_roots=[str(tmp_path / "d0")],
                    scrub_rate=1.0)  # ~1 byte/s: one token, then starvation
    vuid = 8192
    node.create_vuid(vuid)
    for bid in range(8):
        node.put_shard(vuid, bid, b"y" * 2048)
    r = node.scrub_once(max_shards=8)
    assert r["scanned"] < 8 and not r["complete"]
    node.close()


@pytest.mark.chaos
def test_scrub_finds_bitrot_and_repair_heals_it(cluster, rng):
    """The datainspect loop end-to-end: on-disk bitrot (injected under the
    CRC framing) -> scrub_once CRC failure -> repair topic -> worker heals
    -> a follow-up scrub pass is clean."""
    data = blob_bytes(rng, 300_000)  # EC6P3
    loc = cluster.access.put(data)
    blob = loc.blobs[0]
    vol = cluster.cm.get_volume(blob.vid)
    unit = vol.units[2]
    node = cluster.nodes[unit.node_id]
    chaos.corrupt_shard_on_disk(node, unit.vuid, blob.bid)
    produced = cluster.scheduler.run_scrub(max_shards=100_000)
    assert produced >= 1, "scrub missed injected bitrot"
    cluster.scheduler.poll_repair_topic()
    while cluster.worker.run_once():
        pass
    assert cluster.access.get(loc) == data
    assert node.get_shard(unit.vuid, blob.bid)  # CRC-clean again
    # a full fresh sweep (cursor wrapped by the big tick above) stays quiet
    for n in cluster.nodes.values():
        n._scrub_cursor = None
    assert cluster.scheduler.run_scrub(max_shards=100_000) == 0


# -- detection: heartbeat expiry (the kill-a-blobnode path) --------------------


@pytest.mark.chaos
def test_heartbeat_silence_turns_node_kill_into_rebuild(cluster, rng):
    """Kill one blobnode (engine closed + unrouted): its heartbeats stop,
    expire_heartbeats marks its disks BROKEN, check_disks mints disk-repair
    tasks, and the worker re-homes every affected stripe — acked data stays
    byte-identical and nothing remains mapped to the dead disks."""
    payloads = [blob_bytes(rng, 120_000) for _ in range(3)]
    blobs = [(cluster.access.put(p), p) for p in payloads]
    for n in cluster.nodes.values():
        n.heartbeat(cluster.cm)
    cluster.scheduler.hb_timeout_s = 0.3

    victim = cluster.cm.get_volume(blobs[0][0].blobs[0].vid).units[0].node_id
    victim_disks = [d.disk_id for d in cluster.cm.disks.values()
                    if d.node_id == victim]
    cluster.nodes.pop(victim).close()

    deadline = time.monotonic() + 10
    newly_broken: list[int] = []
    while time.monotonic() < deadline:
        for n in list(cluster.nodes.values()):
            n.heartbeat(cluster.cm)
        newly_broken += cluster.scheduler.check_node_health()
        if set(newly_broken) >= set(victim_disks):
            break
        time.sleep(0.05)
    assert set(newly_broken) == set(victim_disks), \
        "only the dead node's disks may expire"
    assert all(cluster.cm.disks[d].status == DISK_BROKEN
               for d in victim_disks)
    assert all(d.status == DISK_NORMAL
               for d in cluster.cm.disks.values()
               if d.node_id != victim)

    tasks = cluster.scheduler.check_disks()
    assert len(tasks) == len(victim_disks)
    while cluster.worker.run_once():
        pass
    cluster.access.clear_punishments()
    for loc, want in blobs:
        assert cluster.access.get(loc) == want, "blob lost in the rebuild"
    for vol in cluster.cm.volumes.values():
        for u in vol.units:
            assert u.disk_id not in victim_disks, "unit still on a dead disk"
    assert not cluster.scheduler.tasks(state=TASK_WORKING)


def test_closed_engine_goes_heartbeat_silent(cluster, rng):
    """A closed engine must go SILENT even while still routed: the chaos
    crash plan closes the node in place (no routing pop), and heartbeat()
    itself touches no disk IO — without the closed gate a crashed node
    would keep beating forever and expiry could never detect it."""
    victim = next(iter(cluster.nodes))
    victim_disks = [d.disk_id for d in cluster.cm.disks.values()
                    if d.node_id == victim]
    for n in cluster.nodes.values():
        n.heartbeat(cluster.cm)
    cluster.nodes[victim].close()  # crashed, NOT unrouted
    cluster.scheduler.hb_timeout_s = 0.2

    deadline = time.monotonic() + 10
    newly_broken: list[int] = []
    while time.monotonic() < deadline:
        for n in list(cluster.nodes.values()):
            n.heartbeat(cluster.cm)  # the dead engine's beat must no-op
        newly_broken += cluster.scheduler.check_node_health()
        if set(newly_broken) >= set(victim_disks):
            break
        time.sleep(0.05)
    assert set(newly_broken) == set(victim_disks), \
        "closed-but-routed engine was never detected"


def test_disk_io_success_reset_keeps_inflight_failures(tmp_path):
    """_disk_io's success-path reset is a snapshot-compare: failures that
    land WHILE a successful op is in flight are newer information, and
    zeroing them would lose increments of the consecutive count the
    heartbeat's broken_after threshold gates on."""
    from chubaofs_tpu_torch.blobstore.blobnode import BlobNode

    node = BlobNode(node_id=3, disk_roots=[str(tmp_path / "d0")])
    vuid = 4096
    node.create_vuid(vuid)
    disk_id = node._chunk_of_vuid[vuid][0]

    def op_with_interleaved_failures():
        # concurrent reads fail while this one is in flight
        node._io_errors[disk_id] = 3
        return b"ok"

    assert node._disk_io(vuid, op_with_interleaved_failures) == b"ok"
    assert node._io_errors[disk_id] == 3, \
        "success reset must not erase in-flight failure increments"

    # the plain case: a stale pre-op count IS broken by this success
    assert node._disk_io(vuid, lambda: b"ok2") == b"ok2"
    assert node._io_errors[disk_id] == 0
    node.close()


def test_dropped_disk_not_remarked_broken_by_stale_io_errors(cluster, rng):
    """A repaired (DROPPED) disk's consecutive-error count never resets —
    nothing IOs it anymore — so heartbeat must only flip NORMAL disks to
    broken, else every beat would re-mint an endless
    broken -> repair -> dropped -> broken task cycle."""
    loc = cluster.access.put(blob_bytes(rng, 60_000))
    unit = cluster.cm.get_volume(loc.blobs[0].vid).units[0]
    node = cluster.nodes[unit.node_id]
    disk_id = unit.disk_id
    node._io_errors[disk_id] = 3  # a dying disk: threshold crossed
    node.heartbeat(cluster.cm)
    assert cluster.cm.disks[disk_id].status == DISK_BROKEN
    assert any(t.disk_id == disk_id for t in cluster.scheduler.check_disks())
    while cluster.worker.run_once():
        pass
    assert cluster.cm.disks[disk_id].status == DISK_DROPPED
    # error count still >= threshold: the next beat must leave the disk
    # repaired and mint no new task
    node.heartbeat(cluster.cm)
    assert cluster.cm.disks[disk_id].status == DISK_DROPPED
    assert cluster.scheduler.check_disks() == []


@pytest.mark.chaos
def test_kill_blobnode_soak_smoke(tmp_path):
    """The acceptance scenario at smoke size: kill a blobnode under
    live PUT load; every acked blob rebuilds byte-identical, rebuild
    throughput is nonzero, zero WORKING tasks remain, and the captured
    repair traces show download/decode overlap > 0."""
    from chubaofs_tpu_torch.chaos.soak import run_kill_soak

    # seed + layout are deterministic, so the victim (and with it the
    # rebuild width that makes overlap observable) is reproducible; the
    # sizes keep EC6P3/EC12P4 stripes in play so the windowed pipeline has
    # real survivor downloads to hide behind the device decode
    res = run_kill_soak(str(tmp_path), seed=7, n_nodes=9, disks_per_node=2,
                        warm_puts=6, live_puts=3, hb_timeout=0.4,
                        wire_ms=2.0, read_deadline=0.4, write_deadline=2.5,
                        max_wait_s=90.0, sizes=[120_000, 700_000], device=CPU)
    assert res["ok"], res
    assert res["rebuilt_shards"] > 0
    assert res["rebuild_shards_per_s"] > 0
    assert res["repair_overlap_ratio"] > 0, res
    assert res["bytes_per_repaired_shard"] > 0
    assert res["live_puts"] >= 1, "no PUT load actually rode the rebuild"
    assert res["critical_path"] is not None
    kinds = [(e["event"], e["fault"]) for e in res["events"]]
    assert ("inject", "node_kill") in kinds
    # Timeline acceptance: the injected kill, the broken-disk
    # detection, the repair lease, and the rebuild-finished terminal event
    # appear in causal order on the event journal (run_kill_soak raises if
    # not), correlated to the repair trace; exactly the broken_disks alert
    # fired during the outage and resolved by soak end
    tl = [t["type"] for t in res["timeline"]]
    assert tl == ["chaos_inject", "disk_status", "lease_acquired",
                  "task_finished"], res["timeline"]
    offsets = [t["t"] for t in res["timeline"]]
    assert offsets == sorted(offsets)
    assert res["repair_trace_id"], "rebuild event lost its trace id"
    assert res["alerts_fired"] == ["broken_disks"]
    assert res["alerts_firing"] == []
    # the correlate join `cfs-events --correlate <trace>` rides: the
    # rebuild-finished event shares a trace id with persisted repair spans
    from chubaofs_tpu_torch.tools.cfsevents import correlate
    from chubaofs_tpu_torch.utils import events as ev

    evs, _ = ev.default_journal().query(n=10 ** 6)
    items = correlate(evs, [], res["repair_trace_id"])
    assert any(i["kind"] == "event"
               and i["record"]["type"] == "task_finished" for i in items)


# -- pipelined rebuild: overlap math + spans -----------------------------------


def test_stage_overlap_ratio_math():
    full = [("download", 0.0, 1.0), ("codec.device", 0.0, 1.0)]
    assert stage_overlap_ratio(full) == 1.0
    half = [("download", 0.0, 1.0), ("codec.host", 0.5, 1.0)]
    assert stage_overlap_ratio(half) == pytest.approx(0.5)
    serial = [("download", 0.0, 1.0), ("codec.device", 1.0, 1.0)]
    assert stage_overlap_ratio(serial) == 0.0
    assert stage_overlap_ratio([("download", 0.0, 1.0)]) is None
    assert stage_overlap_ratio([]) is None
    # overlapping same-family intervals count once (union, not sum)
    stacked = [("download", 0.0, 1.0), ("download", 0.0, 1.0),
               ("codec.device", 0.5, 0.5)]
    assert stage_overlap_ratio(stacked) == pytest.approx(1.0)


def test_cfstrace_stage_overlap_report():
    from chubaofs_tpu_torch.tools.cfstrace import stage_overlap

    rec = {"start": 100.0, "dur_us": 2_000_000,
           "stages": [["download", 0, 1_000_000],
                      ["codec.host", 500_000, 250_000],
                      ["codec.device", 750_000, 750_000]]}
    ov = stage_overlap([rec], "download", "codec.")
    assert ov["ratio"] == pytest.approx(0.5, abs=0.01)
    assert ov["overlap_ms"] == pytest.approx(500.0, abs=1.0)
    none = stage_overlap([rec], "download", "nothing.")
    assert none["ratio"] == 0.0


# -- cfs-stat repair rollup ----------------------------------------------------


def test_cfsstat_repair_rollup_filter():
    import io
    import json as _json

    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer
    from chubaofs_tpu_torch.tools.cfsstat import is_repair_metric, main

    assert is_repair_metric("cfs_scheduler_tasks")
    assert is_repair_metric("cfs_scheduler_lease_expired_total")
    assert is_repair_metric("cfs_scheduler_stale_report_total")
    assert is_repair_metric("cfs_scheduler_probe_fail_total")
    assert is_repair_metric("cfs_blobnode_scrub_scanned_shards_total")
    assert is_repair_metric("cfs_scheduler_repair_bytes_downloaded_total")
    assert not is_repair_metric("cfs_codec_batches_total")
    assert not is_repair_metric("cfs_rpc_pool_reuse_total")

    reg = registry("scheduler")
    reg.gauge("tasks", {"kind": "shard_repair", "state": "prepared"}).set(2)
    reg.counter("lease_expired").add(0)
    registry("codec").counter("batches_total").add(0)
    srv = RPCServer(Router(), module="probe").start()
    buf = io.StringIO()
    try:
        rc = main(["--addr", srv.addr, "--interval", "0",
                   "--repair", "--json"], out=buf)
    finally:
        srv.stop()
    assert rc == 0
    rows = _json.loads(buf.getvalue())["rows"]
    names = {r["metric"] for r in rows}
    assert any(n.startswith("cfs_scheduler_tasks") for n in names), names
    assert any("lease_expired" in n for n in names)
    assert all(is_repair_metric(n) for n in names), \
        "--repair leaked non-repair metrics"
