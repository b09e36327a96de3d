"""The cases of tests/test_capacity.py, run against the port's cfs-capacity
on the CPU.

Seeded open-loop generator, SLO gate, rebalance actuator, bounded tenant
labels and cfs-top archival, with every cluster's codec on the host
(device="cpu", `--device cpu`). The generator's pure functions (plan_ops,
zipf_cdf, ramp_factor) are held against the JAX package's on the same seeded
inputs. The two daemon-cluster CLI cases stay slow, as the reference marks
them.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from chubaofs_tpu.tools import capacity as ref_capacity
from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.tools import capacity
from chubaofs_tpu_torch.utils import exporter


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


def _ops(plan):
    return [dataclasses.astuple(op) for op in plan["ops"]]


# -- plan determinism ----------------------------------------------------------


def test_plan_ops_deterministic_across_runs():
    a = capacity.plan_ops(seed=7, n_tenants=4, duration_s=10.0,
                          base_rate=50.0, zipf_s=1.2, hot=True)
    b = capacity.plan_ops(seed=7, n_tenants=4, duration_s=10.0,
                          base_rate=50.0, zipf_s=1.2, hot=True)
    assert a["ops"] == b["ops"], "same seed must yield the identical sequence"
    assert a["per_tenant"] == b["per_tenant"]
    assert a["tenants"] == b["tenants"]
    # a different seed yields a different sequence (not a constant function)
    c = capacity.plan_ops(seed=8, n_tenants=4, duration_s=10.0,
                          base_rate=50.0, zipf_s=1.2, hot=True)
    assert a["ops"] != c["ops"]
    # the JAX package plans the identical sequence from the same arguments
    for seed, kw in ((7, {"hot": True}), (8, {"hot": True}),
                     (3, {"ramp": "spike", "storm": "t1"}),
                     (5, {"keys_per_tenant": 8, "ramp": "flat"})):
        args = dict(seed=seed, n_tenants=4, duration_s=10.0, base_rate=50.0,
                    zipf_s=1.2, **kw)
        ours, ref = capacity.plan_ops(**args), ref_capacity.plan_ops(**args)
        assert _ops(ours) == _ops(ref)
        assert ours["per_tenant"] == ref["per_tenant"]
        assert ours["tenants"] == ref["tenants"]


def test_plan_ops_shape_and_blends():
    plan = capacity.plan_ops(seed=3, n_tenants=4, duration_s=20.0,
                             base_rate=40.0, zipf_s=1.2, keys_per_tenant=32)
    ops = plan["ops"]
    assert len(ops) > 100
    # arrivals are an increasing open-loop schedule inside the run window
    ats = [op.at for op in ops]
    assert ats == sorted(ats) and 0 < ats[0] and ats[-1] < 20.0
    assert all(0 <= op.key < 32 for op in ops)
    assert all(1024 <= op.size <= 256 << 10 for op in ops)
    kinds = {op.kind for op in ops}
    assert kinds <= set(capacity.OP_KINDS)
    # hot kinds only appear when the topology has a hot volume
    assert not kinds & {"hot_write", "hot_read"}
    hot = capacity.plan_ops(seed=3, n_tenants=4, duration_s=20.0,
                            base_rate=40.0, zipf_s=1.2, hot=True)
    assert {"hot_write", "hot_read"} & {op.kind for op in hot["ops"]}
    # every tenant got traffic, and the audit adds up
    assert set(plan["per_tenant"]) == set(plan["tenants"])
    assert sum(c for pt in plan["per_tenant"].values()
               for c in pt.values()) == len(ops)


def test_zipf_skew_concentrates_on_low_ranks():
    plan = capacity.plan_ops(seed=5, n_tenants=2, duration_s=30.0,
                             base_rate=60.0, zipf_s=1.2, keys_per_tenant=64)
    from collections import Counter

    freq = Counter(op.key for op in plan["ops"])
    top = sum(freq[k] for k in range(8))  # hottest 8 of 64 ranks
    assert top > 0.5 * len(plan["ops"]), \
        "zipf s=1.2 should put most traffic on the head ranks"
    assert freq[0] == max(freq.values())
    # the cumulative weights are the JAX package's, value for value
    for n, zs in ((1, 1.2), (8, 0.9), (64, 1.2), (64, 3.0), (500, 1.1)):
        assert capacity.zipf_cdf(n, zs) == ref_capacity.zipf_cdf(n, zs)


def test_ramp_shapes():
    assert capacity.ramp_factor(0.5, "flat") == 1.0
    # diurnal: midday peak well above the night floor
    assert capacity.ramp_factor(0.5, "diurnal") == pytest.approx(1.0)
    assert capacity.ramp_factor(0.0, "diurnal") == pytest.approx(0.25)
    assert capacity.ramp_factor(0.5, "spike") == 3.0
    assert capacity.ramp_factor(0.1, "spike") == 0.7
    # the arrival integral really bends with the ramp: diurnal plans put
    # more of their ops mid-run than a flat plan does
    flat = capacity.plan_ops(seed=1, n_tenants=2, duration_s=20.0,
                             base_rate=40.0, zipf_s=1.1, ramp="flat")
    diur = capacity.plan_ops(seed=1, n_tenants=2, duration_s=20.0,
                             base_rate=40.0, zipf_s=1.1, ramp="diurnal")

    def mid_fraction(plan):
        mid = [op for op in plan["ops"] if 5.0 <= op.at < 15.0]
        return len(mid) / len(plan["ops"])

    assert mid_fraction(diur) > mid_fraction(flat) + 0.1
    # the ramp curves are the JAX package's at every point
    for frac in np.random.default_rng(7).random(64).tolist() + [0.0, 0.5, 1.0]:
        for shape in ("flat", "diurnal", "spike"):
            assert (capacity.ramp_factor(frac, shape)
                    == ref_capacity.ramp_factor(frac, shape))


# -- bounded tenant labels (the runtime cardinality guard) ---------------------


def test_bounded_label_values_reject_unbounded_tenant():
    reg = exporter.registry("capacitytest")
    exporter.declare_label_values("tenant", ["t0", "t1"])
    try:
        reg.counter("ops", {"tenant": "t0", "op": "blob_put"}).add()
        # an unbounded (request-derived) tenant string must be rejected —
        # this is what keeps per-tenant families from minting a series per
        # hostile value
        with pytest.raises(ValueError, match="bounded"):
            reg.counter("ops", {"tenant": "attacker-%s" % os.getpid()}).add()
        # other label keys stay unrestricted
        reg.counter("other", {"op": "anything-goes"}).add()
    finally:
        exporter.declare_label_values("tenant", None)
    # restriction lifted: the same value now passes (teardown contract)
    reg.counter("ops", {"tenant": "late-tenant"}).add()


def test_workload_declares_and_clears_tenant_bound(tmp_path):
    plan = capacity.plan_ops(seed=2, n_tenants=2, duration_s=1.0,
                             base_rate=5.0, zipf_s=1.1)
    wl = capacity.Workload(capacity.CapacityDriver(), plan, seed=2)
    reg = exporter.registry("capacity")
    try:
        with pytest.raises(ValueError):
            reg.counter("ops", {"tenant": "not-declared"})
    finally:
        wl.close()
    reg.counter("ops", {"tenant": "not-declared"})  # cleared on close


# -- gate logic ----------------------------------------------------------------


def test_failing_slos_names_flipped_objectives():
    health = {
        "1.2.3.4:1": {"status": "ok", "slos": {"put_p99": {"status": "ok"}}},
        "1.2.3.4:2": {"status": "failing", "reasons": ["put_p99: ..."],
                      "slos": {"put_p99": {"status": "failing"},
                               "get_p99": {"status": "ok"}}},
        "1.2.3.4:3": {"status": "failing", "reasons": ["unreachable"],
                      "slos": {}},
        "1.2.3.4:4": {"status": "degraded",
                      "slos": {"get_p99": {"status": "degraded"}}},
    }
    out = capacity.failing_slos(health)
    assert out == {"1.2.3.4:2": ["put_p99"], "1.2.3.4:3": ["unreachable"]}


def test_collector_verdict_fails_iff_flipped(tmp_path):
    col = capacity.Collector(str(tmp_path / "r.jsonl"), addrs=["x:1"])
    # zero health evidence must FAIL the gate, never pass it blind — a
    # dead console yields empty health dicts on every poll
    v = col.verdict()
    assert v["verdict"] == "failing"
    assert v["flipped"] == {"collector": ["no-health-data"]}
    col.health_frames = 3
    assert col.verdict()["verdict"] == "ok"
    col.worst = "degraded"
    assert col.verdict()["verdict"] == "degraded"
    col.flipped["t:1"] = {"put_p99"}
    v = col.verdict()
    assert v["verdict"] == "failing" and v["flipped"] == {"t:1": ["put_p99"]}


# -- cfs-top archival mode (the report consumer) -------------------------------


def test_cfstop_frames_out_archives_jsonl(tmp_path):
    from chubaofs_tpu_torch.console.server import Console
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer
    from chubaofs_tpu_torch.tools import cfstop

    srv = RPCServer(Router(), module="archtarget").start()
    console = Console([srv.addr])
    path = str(tmp_path / "frames.jsonl")
    try:
        rc = cfstop.main(["--console", console.addr, "--frames", "2",
                          "--out", path, "--interval", "0.2"])
        assert rc == 0
        lines = [json.loads(ln) for ln in open(path)]
        assert len(lines) == 2
        # run-relative monotonic stamps, strictly increasing
        assert 0 < lines[0]["t"] < lines[1]["t"]
        for rec in lines:
            assert any(r["target"] == srv.addr for r in rec["rows"])
        # --frames without --out is a usage error, not a silent terminal loop
        with pytest.raises(SystemExit):
            cfstop.main(["--console", console.addr, "--frames", "2"])
    finally:
        console.stop()
        srv.stop()


# -- rebalance_hot (the actuator) ----------------------------------------------


@pytest.fixture(scope="module")
def rb_cluster(tmp_path_factory):
    from chubaofs_tpu_torch.deploy import FsCluster

    c = FsCluster(str(tmp_path_factory.mktemp("rb")), n_nodes=3,
                  blob_nodes=6, data_nodes=4, device=CPU)
    yield c
    c.close()


def test_rebalance_hot_moves_hot_replica_to_cold_node(rb_cluster):
    c = rb_cluster
    lead = c.master()
    lead.create_volume("rbvol", cold=False, data_partitions=3)
    fs = c.client("rbvol")
    payload = os.urandom(400_000)
    fs.write_file("/spanning.bin", payload)

    vol = lead.get_volume("rbvol")
    # a node hosting >=2 partitions plays the hotspot; zipfian reads would
    # concentrate there, and shedding its hottest pid must strictly improve
    by_node: dict[int, list[int]] = {}
    for dp in vol.data_partitions:
        for p in dp.peers:
            by_node.setdefault(p, []).append(dp.partition_id)
    hot_node = next(n for n, pids in by_node.items() if len(pids) >= 2)
    hot_pids = by_node[hot_node][:2]
    loads = {hot_pids[0]: 600.0, hot_pids[1]: 500.0}
    lead.heartbeat(hot_node, loads=loads)
    for n in by_node:
        if n != hot_node:
            lead.heartbeat(n, loads={by_node[n][0]: 10.0})
    spread_before = lead.data_node_loads()
    assert spread_before[hot_node] == 1100.0

    hot_dp = next(d for d in vol.data_partitions
                  if d.partition_id == hot_pids[0])
    old_peers = set(hot_dp.peers)
    moved = lead.rebalance_hot(factor=1.2, max_moves=1)
    assert moved == 1
    vol = lead.get_volume("rbvol")
    dp = next(d for d in vol.data_partitions
              if d.partition_id == hot_pids[0])
    assert hot_node not in dp.peers, "the hot node must shed its hottest pid"
    assert len(dp.peers) == 3 and len(dp.hosts) == 3
    # the replacement is the one node that wasn't hosting the pid (and is
    # colder than the victim by construction)
    newcomers = set(dp.peers) - old_peers
    assert len(newcomers) == 1
    assert spread_before[newcomers.pop()] < spread_before[hot_node]
    # reads stay byte-identical through the move (hosts re-resolved)
    assert c.client("rbvol").read_file("/spanning.bin") == payload


def test_rebalance_hot_noops_without_skew_or_leaders(rb_cluster):
    c = rb_cluster
    lead = c.master()
    # flat load: nothing exceeds factor x mean, so nothing moves
    vol_names = c.volume_names()
    assert vol_names  # rbvol from the prior test
    for n in [x for x in lead.sm.nodes.values() if x.kind == "data"]:
        lead.heartbeat(n.node_id, loads={1: 50.0})
    assert lead.rebalance_hot(factor=1.5) == 0
    # zero load: no signal, no moves
    for n in [x for x in lead.sm.nodes.values() if x.kind == "data"]:
        lead.heartbeat(n.node_id, loads={})
    assert lead.rebalance_hot() == 0


def test_heartbeat_loads_survive_snapshot_roundtrip():
    from chubaofs_tpu_torch.master.master import MasterSM

    sm = MasterSM()
    sm.apply(("register_node", {"node_id": 101, "kind": "data",
                                "addr": "x:1", "now": 1.0}), 1)
    sm.apply(("heartbeat", {"node_id": 101, "loads": {"7": 42.5},
                            "now": 2.0}), 2)
    snap = sm.snapshot()
    sm2 = MasterSM()
    sm2.restore(snap)
    assert sm2.nodes[101].loads == {7: 42.5}
    # pre-loads snapshots restore with an empty loads dict
    from dataclasses import asdict

    from chubaofs_tpu_torch.raft import snapcodec

    legacy = asdict(sm.nodes[101])
    legacy.pop("loads")
    w = snapcodec.SnapshotWriter()
    w.add("meta", {"next_id": 100, "zone_domains": {}})
    w.add_batched("nodes", [legacy])
    w.add_batched("volumes", [])
    w.add_batched("users", [])
    sm3 = MasterSM()
    sm3.restore(w.getvalue())
    assert sm3.nodes[101].loads == {}


def test_workload_hot_ops_execute_and_verify(rb_cluster):
    """The hot-tier half of the blend: hot_write/hot_read ride the replica
    path (FsClient over datanodes) and reads verify byte-identical via the
    crc ledger — zero errors, zero corruptions at smoke size."""
    c = rb_cluster
    if "capcold" not in c.volume_names():
        c.create_volume("capcold", cold=True)
    plan = capacity.plan_ops(seed=4, n_tenants=2, duration_s=1.5,
                             base_rate=30.0, zipf_s=1.2, keys_per_tenant=8,
                             hot=True)
    wl = capacity.Workload(
        capacity.LocalDriver(c, "capcold", hot_volume="rbvol", device=CPU),
        plan,
        seed=4, workers=2)
    try:
        ledger = wl.run()
    finally:
        wl.close()
    assert ledger["corruptions"] == []
    assert ledger["ops_error"] == 0, ledger
    assert ledger["ops_abandoned"] == 0
    hot_ok = sum(v for row in ledger["per_tenant"].values()
                 for k, v in row.items()
                 if k.startswith("hot_") and k.endswith("_ok"))
    assert hot_ok > 0, ledger["per_tenant"]
    done = ledger["ops_ok"] + ledger["ops_error"] + ledger["ops_miss"]
    assert done == ledger["ops_planned"]


# -- the bench smoke (tier-1 gate acceptance) ----------------------------------


def test_bench_capacity_smoke_gate_and_chaos_flip(tmp_path):
    """The CI gate: bench_capacity at smoke size must (a)
    evaluate the SLO gate to a non-None, non-failing verdict on the clean
    run, (b) archive >=3 JSONL frames, and (c) flip the verdict to failing
    under a chaos-injected sustained blobnode.put_shard delay, naming the
    flipped SLO."""
    from chubaofs_tpu_torch.tools.perfbench import bench_capacity

    out = bench_capacity(str(tmp_path), duration=2.5, rate=14.0,
                         interval=0.35, device=CPU)
    assert out["cap_verdict_clean"] in ("ok", "degraded"), out
    assert out["cap_frames_clean"] >= 3, out
    assert out["cap_corruptions"] == 0, out
    assert out["cap_ops_ok"] > 0, out
    report = os.path.join(str(tmp_path), "capacity-clean.jsonl")
    frames = [json.loads(ln) for ln in open(report)]
    assert len(frames) >= 3
    assert all("rows" in f and "worst" in f and "t" in f for f in frames)
    ts = [f["t"] for f in frames]
    assert ts == sorted(ts)
    # chaos: the sustained-latency plan must flip the gate and name the SLO
    assert out["cap_verdict_chaos"] == "failing", out
    assert "put_p99" in out["cap_chaos_flipped"], out


# -- full daemon-cluster acceptance (slow; the cfs-capacity CLI) ---------------


@pytest.mark.slow
def test_cfs_capacity_cli_clean_and_chaos(tmp_path):
    """`cfs-capacity --seed 7` against a real ProcCluster: the clean run
    exits 0 with a JSONL report archived; the same seed with a sustained
    blobnode.put_shard delay plan (and a tightened PUT objective reaching
    the daemons) exits nonzero naming the flipped SLO."""
    from chubaofs_tpu_torch.tools.capacity import main as cap_main

    report = str(tmp_path / "cap.jsonl")
    rc = cap_main(["--seed", "7", "--duration", "8", "--rate", "8",
                   "--metanodes", "3", "--datanodes", "0",
                   "--root", str(tmp_path / "clean"), "--out", report,
                   "--device", CPU, "--json"])
    assert rc == 0
    frames = [json.loads(ln) for ln in open(report)]
    assert len(frames) >= 3

    rc = cap_main(["--seed", "7", "--duration", "8", "--rate", "8",
                   "--metanodes", "3", "--datanodes", "0",
                   "--root", str(tmp_path / "chaos"),
                   "--failpoints", "blobnode.put_shard=delay(0.08)",
                   "--daemon-env", "CFS_SLO_PUT_P99_MS=20",
                   "--device", CPU, "--json"])
    assert rc == 1


@pytest.mark.slow
def test_cfs_capacity_ab_rebalance(tmp_path, capsys):
    """The acceptance A/B: the same seeded zipfian scenario with datanodes
    (hot-volume blends + RemoteDriver hot IO + SpreadMonitor) run rebalance
    off then on. Both phases must stay clean (no SLO flip, no blob loss,
    byte-identical reads via the crc ledger) and report a per-node ops
    spread. The spread-REDUCTION magnitude is environment-sensitive at
    smoke scale, so the structural contract gates here; the measured
    reduction (cv 0.251 -> 0.141 at seed 7) lives in the PR notes."""
    from chubaofs_tpu_torch.tools.capacity import main as cap_main

    rc = cap_main(["--seed", "7", "--duration", "8", "--rate", "20",
                   "--zipf-s", "1.4", "--metanodes", "3", "--datanodes", "4",
                   "--rebalance-secs", "1.5", "--ab-rebalance",
                   "--root", str(tmp_path / "ab"), "--device", CPU,
                   "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "capacity_ab"
    for side in ("off", "on"):
        res = out[side]
        assert res["verdict"] in ("ok", "degraded"), res
        assert res["corruptions"] == [], res
        assert res["ops_ok"] > 0
        assert res["spread"]["per_node"], "spread monitor collected nothing"
    assert out["off"]["rebalance"] is False and out["on"]["rebalance"] is True


def test_cli_without_gpu_refuses_before_any_boot(tmp_path, monkeypatch):
    """With no GPU and no --device, cfs-capacity fails naming the missing
    card before any daemon starts (nothing is written under --root)."""
    from chubaofs_tpu_torch.tools.capacity import main as cap_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = tmp_path / "never"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cap_main(["--seed", "7", "--duration", "1", "--root", str(root)])
    assert not root.exists()


# -- S3 surface driver ----------------------------------------------


def test_s3_driver_tenant_mix_over_live_gateway(tmp_path):
    """cfs-capacity --s3's driver against a real ObjectNode: per-tenant
    buckets + sigv4 on every blob verb, byte-identical roundtrip, and a
    QoS throttle surfacing as an op ERROR (the status the error-ratio and
    per-tenant throttle SLOs read) rather than silent data loss."""
    from chubaofs_tpu_torch.deploy import FsCluster
    from chubaofs_tpu_torch.objectnode.server import ObjectNode
    from chubaofs_tpu_torch.rpc.server import RPCServer
    from chubaofs_tpu_torch.utils.qos import QosPlane

    cluster = FsCluster(str(tmp_path), n_nodes=3, blob_nodes=6, data_nodes=0,
                        device=CPU)
    qos = QosPlane(("ak-t0", "ak-t1"), rps=30, queue_ms=20, queue_len=2)
    node = ObjectNode(cluster, users={
        "ak-t0": {"secret_key": "sk0", "uid": "t0"},
        "ak-t1": {"secret_key": "sk1", "uid": "t1"},
    }, qos=qos)
    srv = RPCServer(node.router, metrics=False, module="objectnode").start()
    try:
        driver = capacity.S3Driver(
            srv.addr, {"t0": ("ak-t0", "sk0"), "t1": ("ak-t1", "sk1")})
        driver.ensure_buckets()
        driver.ensure_buckets()  # idempotent (BucketAlreadyExists tolerated)
        tok = driver.blob_put(b"payload-t0", tenant="t0")
        assert driver.blob_get(tok, tenant="t0") == b"payload-t0"
        driver.blob_delete(tok, tenant="t0")
        with pytest.raises(RuntimeError):
            driver.blob_get(tok, tenant="t0")  # read-after-delete errors
        # tenants are isolated by bucket ownership: t1's creds cannot read
        # t0's bucket (403 surfaces as an op error)
        tok0 = driver.blob_put(b"secret", tenant="t0")
        with pytest.raises(RuntimeError):
            driver.blob_get(tok0, tenant="t1")  # t1 creds on t0's bucket
        # drive t1 past the parent cap: a throttle IS an op error
        saw_throttle = False
        for _ in range(120):
            try:
                driver.blob_put(b"x" * 64, tenant="t1")
            except RuntimeError as e:
                assert "HTTP 4" in str(e) or "HTTP 5" in str(e)
                saw_throttle = True
                break
        assert saw_throttle
    finally:
        srv.stop()
        qos.close()
        cluster.close()
