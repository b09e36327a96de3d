"""The cases of tests/test_observability.py that import only ported modules,
run against the port on the CPU.

Exposition-format conformance, cfs-stat diff, bounded track logs and
carriers, slow-op log, and cross-hop traces over a MiniCluster(device=
"cpu") and a real RPCServer, the metanode's packet-TCP hop
(meta/service.py) over an FsCluster(device="cpu"), and an empty raft batch
under a span, the port's console rollup, and the Mount (FUSE-facing) chain
as one trace."""

import json
import os

import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore import trace
from chubaofs_tpu_torch.tools.cfsstat import diff_metrics, parse_metrics, parse_types
from chubaofs_tpu_torch.utils import exporter
from chubaofs_tpu_torch.utils.auditlog import SlowOpLog, configure_slowop


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


# -- exporter: exposition-format conformance -----------------------------------


def _sample_registry():
    reg = exporter.Registry(cluster="t", module="conf")
    reg.counter("ops_total", {"op": "put"}).add(3)
    reg.counter("ops_total", {"op": "get"}).add()
    reg.gauge("depth").set(7)
    s = reg.summary("latency", {"op": "put"})
    for v in (0.0004, 0.003, 0.003, 0.2, 30.0):
        s.observe(v)
    return reg


def test_render_emits_type_headers_and_parses():
    reg = _sample_registry()
    text = reg.render()
    types = parse_types(text)
    assert types["cfs_t_conf_ops_total"] == "counter"
    assert types["cfs_t_conf_depth"] == "gauge"
    assert types["cfs_t_conf_latency"] == "histogram"
    assert types["cfs_t_conf_latency_max"] == "gauge"
    # every TYPE header precedes its family's first sample
    lines = text.splitlines()
    for fam in types:
        type_idx = lines.index(f"# TYPE {fam} {types[fam]}")
        sample_idx = next(i for i, ln in enumerate(lines)
                          if ln.startswith(fam) and not ln.startswith("#"))
        assert type_idx < sample_idx, fam
    # sample lines all parse as name{labels} value
    vals = parse_metrics(text)
    assert vals['cfs_t_conf_ops_total{op="put"}'] == 3.0
    assert vals["cfs_t_conf_depth"] == 7.0


def test_histogram_buckets_cumulative_and_inf_equals_count():
    text = _sample_registry().render()
    vals = parse_metrics(text)
    buckets = sorted(
        ((k, v) for k, v in vals.items() if "_latency_bucket{" in k),
        key=lambda kv: (float("inf") if '"+Inf"' in kv[0]
                        else float(kv[0].split('le="')[1].split('"')[0].split(",")[0])),
    )
    counts = [v for _, v in buckets]
    assert counts == sorted(counts), "bucket counts must be cumulative"
    assert counts[-1] == vals['cfs_t_conf_latency_count{op="put"}'] == 5
    # the 30s observation lands only in +Inf (outside every finite bucket)
    assert counts[-1] == counts[-2] + 1
    assert vals['cfs_t_conf_latency_sum{op="put"}'] == pytest.approx(30.2064)


def test_kind_bookkeeping_conflict_raises():
    reg = exporter.Registry(module="kinds")
    reg.counter("x", {"a": "1"})
    reg.counter("x", {"a": "2"})  # second label set, same kind: fine
    with pytest.raises(ValueError):
        reg.summary("x")  # same family name, different kind


def test_label_escaping_survives_parse():
    reg = exporter.Registry(module="esc")
    reg.counter("c", {"vol": 'a"b\nc\\d'}).add()
    vals = parse_metrics(reg.render())
    assert any(v == 1.0 for v in vals.values())


def test_summary_quantile_and_snapshot():
    s = exporter.Summary()
    for v in (0.001, 0.002, 0.004, 0.004, 5.0):
        s.observe(v)
    snap = s.snapshot()
    assert snap["count"] == 5 and snap["max"] == 5.0
    assert s.quantile(0.5) <= 0.005
    assert s.quantile(0.99) >= 2.5


def test_cfsstat_diff():
    a = {"m": 10.0, "gone": 1.0}
    b = {"m": 30.0, "new": 4.0}
    rows = {r["metric"]: r for r in diff_metrics(a, b, 10.0)}
    assert rows["m"]["delta"] == 20.0 and rows["m"]["rate"] == 2.0
    assert rows["new"]["delta"] == 4.0
    assert "gone" not in rows


# -- trace: bounded + sanitized track logs -------------------------------------


def test_track_log_cap_and_sanitize():
    span = trace.Span("t")
    for i in range(trace.TRACK_MAX + 10):
        span.append_track_log("mod")
    assert len(span.track) == trace.TRACK_MAX
    assert span.track_dropped == 10
    s2 = trace.Span("t2")
    s2.append_track_log("bad;mod\nwith:colons")
    entry = s2.track[0]
    assert ";" not in entry and "\n" not in entry
    assert entry.count(":") == 1  # only the module:ms separator survives


def test_track_merge_sanitizes_and_caps():
    span = trace.Span("t")
    span.merge_track("a:1;b:2")
    assert span.track == ["a:1", "b:2"]
    span.merge_track(["evil;x:9\n"])
    assert all(";" not in e and "\n" not in e for e in span.track)
    span.merge_track(["m:1"] * (trace.TRACK_MAX * 2))
    assert len(span.track) == trace.TRACK_MAX


def test_child_span_propagates_bounded():
    root = trace.Span("root")
    child = trace.Span("child", parent=root)
    for _ in range(trace.TRACK_MAX + 5):
        child.append_track_log("m")
    child.finish()
    assert len(root.track) == trace.TRACK_MAX
    assert root.trace_id == child.trace_id


def test_carrier_roundtrip_lowercased_headers():
    span = trace.Span("srv")
    span.append_track_log("m")
    carrier = {}
    span.inject(carrier)
    # rpc Request lower-cases header keys; extraction must still work
    lowered = {k.lower(): v for k, v in carrier.items()}
    cont = trace.start_span("next", carrier=lowered)
    assert cont.trace_id == span.trace_id
    assert cont.track and cont.track[0].startswith("m:")


# -- slow-op audit -------------------------------------------------------------


def test_slowop_threshold(tmp_path):
    log = SlowOpLog(str(tmp_path), threshold_ms=10.0)
    assert not log.maybe_log("m", "fast", 0.005)
    span = trace.Span("x")
    span.append_track_log("hop")
    assert log.maybe_log("m", "slow", 0.5, span=span, err="E")
    recs = log.records()
    assert len(recs) == 1
    r = recs[0]
    assert r["module"] == "m" and r["op"] == "slow"
    assert r["trace_id"] == span.trace_id
    assert r["track"].startswith("hop:")
    assert r["latency_ms"] == pytest.approx(500.0)
    log.close()


# -- cross-hop traces over the real stacks -------------------------------------


@pytest.fixture(scope="module")
def blob_cluster(tmp_path_factory):
    from chubaofs_tpu_torch.blobstore.cluster import MiniCluster

    c = MiniCluster(str(tmp_path_factory.mktemp("obsblob")), device=CPU)
    yield c
    c.close()


def test_minicluster_put_get_single_trace(blob_cluster):
    with trace.Span("client.roundtrip") as span:
        loc = blob_cluster.access.put(b"\xa5" * 200_000)
        assert blob_cluster.access.get(loc) == b"\xa5" * 200_000
    # one trace id spans the whole access fan-out, with per-module entries
    assert {"access", "codec", "blobnode", "proxy"} <= span.modules()
    assert all(":" in e for e in span.track)


def test_role_registries_nonempty_after_traffic(blob_cluster):
    text = exporter.render_all()
    # role-namespaced output for each blobstore-side role
    for role in ("access", "codec", "blobnode"):
        assert f"cfs_{role}_" in text, role
    # codec batch counters render with histogram buckets
    vals = parse_metrics(text)
    assert vals["cfs_codec_batches_total"] >= 1
    assert vals["cfs_codec_jobs_total"] >= 1
    assert any(k.startswith("cfs_codec_batch_jobs_bucket{") for k in vals)


@pytest.fixture(scope="module")
def fs_cluster(tmp_path_factory):
    from chubaofs_tpu_torch.deploy import FsCluster

    c = FsCluster(str(tmp_path_factory.mktemp("obsfs")), n_nodes=3,
                  blob_nodes=6, data_nodes=4, device=CPU)
    c.create_volume("obs", cold=False)
    yield c
    c.close()


def test_metanode_wire_trace_and_metrics(fs_cluster):
    """The packet TCP hop: trace id rides the arg blob out, the track log
    rides the reply back, and the metanode role registry counts the op."""
    from chubaofs_tpu_torch.meta.service import MetaService, RemoteMetaNode

    # pick a node LEADING a partition that owns the root inode (read ops are
    # leader-local; a follower would answer not-leader)
    mn, pid = next(
        (m, p) for m in fs_cluster.metanodes.values()
        for p, sm in m.partitions.items()
        if sm.start <= 1 < sm.end and m.is_leader(p))
    svc = MetaService(mn)
    try:
        rmn = RemoteMetaNode(svc.addr)
        with trace.Span("wire") as span:
            rmn.read_dir(pid, 1)
        assert "metanode" in span.modules()
        text = exporter.registry("metanode").render()
        assert "cfs_metanode_meta_op" in text
        rmn.close()
    finally:
        svc.close()


def test_rpc_server_trace_headers():
    """HTTP hops continue the caller's trace and return a track log."""
    from chubaofs_tpu_torch.rpc.client import RPCClient
    from chubaofs_tpu_torch.rpc.router import Response, Router
    from chubaofs_tpu_torch.rpc.server import RPCServer

    r = Router()
    r.get("/ping", lambda req: Response(200, {}, b"pong"))
    srv = RPCServer(r, module="pingsvc").start()
    try:
        with trace.Span("caller") as span:
            status, headers, body = RPCClient([srv.addr]).do("GET", "/ping")
        assert status == 200
        assert "pingsvc" in span.modules()
        low = {k.lower(): v for k, v in headers.items()}
        assert low[trace.TRACE_ID_KEY.lower()] == span.trace_id
    finally:
        srv.stop()


# -- chaos: injected delay lands in the slow-op log with its track -------------


def test_slowop_disabled_by_default():
    from chubaofs_tpu_torch.utils.auditlog import record_slow_op

    assert os.environ.get("CFS_SLOWOP_MS") in (None, "", "0")
    assert record_slow_op("m", "op", 99.0) in (False,)


# -- exporter edge cases + span-id carrier ------------------------------------


def test_summary_quantile_edge_cases():
    s = exporter.Summary()
    assert s.quantile(0.5) == 0.0  # empty: no samples, no quantile
    s.observe(0.003)
    # single sample: every in-range q reports its bucket's upper bound
    assert s.quantile(0.0) == 0.001  # rank 0 satisfied by the first bucket
    assert s.quantile(0.5) == 0.005
    assert s.quantile(1.0) == 0.005
    # out-of-range q (>1): rank exceeds count, degrades to the observed max
    assert s.quantile(2.0) == 0.003
    # single-bucket layout: in-bucket -> the bucket bound; beyond -> max
    s2 = exporter.Summary(buckets=(1.0,))
    s2.observe(0.5)
    s2.observe(2.0)
    assert s2.quantile(0.5) == 1.0
    assert s2.quantile(0.99) == 2.0


def test_render_label_escaping_exact_roundtrip():
    reg = exporter.Registry(cluster="", module="esc2")
    reg.counter("c", {"vol": 'a"b\\c\nd'}).add(2)
    text = reg.render()
    # the hostile value renders on ONE line with quote/backslash/newline
    # escaped per the exposition format, and parses back exactly
    vals = parse_metrics(text)
    assert vals['cfs_esc2_c{vol="a\\"b\\\\c\\nd"}'] == 2.0
    # neighbors in the same registry stay scrapeable
    reg.gauge("ok").set(1)
    assert parse_metrics(reg.render())["cfs_esc2_ok"] == 1.0


def test_span_id_carrier_roundtrip_lowercased():
    span = trace.Span("carrier")
    carrier = {}
    span.inject(carrier)
    lowered = {k.lower(): v for k, v in carrier.items()}
    cont = trace.start_span("next", carrier=lowered)
    # the continued span knows its cross-process parent even through
    # header-lowercasing transports (rpc Request lower-cases keys)
    assert cont.remote_parent == span.span_id
    assert cont.trace_id == span.trace_id
    assert trace.extract_span_id(lowered) == span.span_id
    assert trace.extract_span_id({}) is None


def test_empty_propose_batch_under_span(tmp_path):
    """An empty batch (e.g. authnode create_keys entries=[]) must return []
    even when the caller has an active span — the raft track callback has
    no future to hang off (regression: futs[-1] IndexError)."""
    from chubaofs_tpu_torch.raft import InProcNet, MultiRaft, StateMachine
    from chubaofs_tpu_torch.raft.server import run_until

    class _SM(StateMachine):
        def apply(self, data, index):
            return index

        def snapshot(self):
            return b""

        def restore(self, data):
            pass

    net = InProcNet()
    nodes = {i: MultiRaft(i, net) for i in (1, 2, 3)}
    for n in nodes.values():
        n.create_group(1, [1, 2, 3], _SM())
    assert run_until(net, lambda: any(n.is_leader(1) for n in nodes.values()))
    lead = next(n for n in nodes.values() if n.is_leader(1))
    with trace.Span("caller"):
        assert lead.propose_batch(1, []) == []


def test_http_metrics_endpoint_and_console_rollup():
    """Every RPCServer serves /metrics (render_all) by default; the console
    /api/metrics rolls scraped targets up with per-target markers."""
    from chubaofs_tpu_torch.console.server import Console
    from chubaofs_tpu_torch.rpc.router import Router
    from chubaofs_tpu_torch.rpc.server import RPCServer
    from chubaofs_tpu_torch.tools.cfsstat import scrape

    exporter.registry("codec").counter("batches_total").add(0)
    exporter.registry("raft").counter("drain_rounds_total").add(0)
    srv = RPCServer(Router(), module="probe").start()
    try:
        body = scrape(srv.addr)
        assert "cfs_codec_" in body and "cfs_raft_" in body
        console = Console([srv.addr])
        try:
            roll = scrape(console.addr, "/api/metrics")
            assert f"# == target {srv.addr} ==" in roll
            assert "cfs_codec_" in roll
        finally:
            console.stop()
    finally:
        srv.stop()


def test_fuse_create_chain_single_trace(fs_cluster):
    from chubaofs_tpu_torch.client.mount import Mount, O_CREAT, O_RDWR

    m = Mount(fs_cluster.client("obs"), volume="obs")
    with trace.Span("probe") as span:
        fd = m.open("/chain.txt", O_CREAT | O_RDWR)
        m.write(fd, b"payload")
        m.close(fd)
    # FUSE -> SDK meta -> metanode -> raft, one trace id, ≥4 modules
    assert {"fuse", "meta", "metanode", "raft"} <= span.modules()
    m.umount()
    text = exporter.render_all()
    # raft drain counters with histogram buckets, per the acceptance bar
    vals = parse_metrics(text)
    assert vals["cfs_raft_drain_rounds_total"] >= 1
    assert vals["cfs_raft_drain_entries_total"] >= 1
    assert any(k.startswith("cfs_raft_drain_batch_bucket{") for k in vals)
    # the hot write path crossed real datanode TCP dispatch
    assert "cfs_datanode_" in text


@pytest.mark.chaos
def test_failpoint_delay_lands_in_slowop_log(fs_cluster, tmp_path):
    from chubaofs_tpu_torch import chaos
    from chubaofs_tpu_torch.client.mount import Mount, O_CREAT, O_WRONLY

    log = configure_slowop(str(tmp_path / "slow"), threshold_ms=40.0)
    m = Mount(fs_cluster.client("obs"), volume="obs")
    chaos.arm("meta.submit", "delay(0.08)")
    try:
        fd = m.open("/slowop.txt", O_CREAT | O_WRONLY)
        m.close(fd)
    finally:
        chaos.disarm("meta.submit")
        m.umount()
    recs = [r for r in log.records() if r["module"] == "fuse"]
    assert recs, "delayed op must land in the slow-op audit log"
    rec = recs[0]
    assert rec["latency_ms"] >= 40.0
    assert rec["trace_id"]
    # the track log explains the latency hop by hop
    assert "meta:" in rec["track"] and "fuse:" in rec["track"]
    # structured record: json round-trips
    assert json.loads(json.dumps(rec)) == rec
    # the slowop role registry counted it
    assert "cfs_slowop_slow_ops_total" in exporter.registry("slowop").render()
    configure_slowop(threshold_ms=0.0)


def test_fs_chain_spans_reach_sink(fs_cluster, tmp_path):
    """FUSE/Mount -> meta submit -> metanode -> raft: the whole metadata
    chain lands in the trace sink as one linked span tree with the raft
    commit wait attributed as a named stage."""
    from chubaofs_tpu_torch.client.mount import Mount, O_CREAT, O_RDWR
    from chubaofs_tpu_torch.tools import cfstrace
    from chubaofs_tpu_torch.utils import tracesink

    snk = tracesink.configure(str(tmp_path / "sink"), sample=1.0)
    try:
        m = Mount(fs_cluster.client("obs"), volume="obs")
        with trace.Span("fs.probe") as span:
            fd = m.open("/sinkchain.txt", O_CREAT | O_RDWR)
            m.write(fd, b"payload")
            m.close(fd)
        m.umount()
        recs = snk.records(span.trace_id)
        ops = {r["op"] for r in recs}
        assert any(op.startswith("mount.") for op in ops), ops
        assert any(op.startswith("meta.") for op in ops), ops
        stage_names = {s[0] for r in recs for s in r.get("stages", [])}
        assert "raft" in stage_names, stage_names
        # the tree assembles: every meta span hangs off a mount span
        roots, children = cfstrace.build_tree(recs)
        assert any(children.get(r["span_id"]) for r in recs)
        rep = cfstrace.critical_path(recs)
        assert rep["root_op"] == "fs.probe" and rep["coverage"] > 0.2
    finally:
        tracesink.configure(sample=0.0)
