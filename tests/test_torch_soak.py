"""The soak harness and the three operator tools, held across both packages
on the CPU.

The same span, event and metric records, made from a numpy seed, go through
the JAX package's and the port's cfs-trace library (critical_path,
stage_overlap, waterfall, flamegraph, aggregate and their renderers),
cfs-events joins (correlate, correlate_alert_chain) and cfs-top rows
(compute_rows, render): strings and integers must be equal, floats within
1e-12 relative. For one plan and seed, run_soak of both packages must log
the same seeded injection events. With no GPU, the port's soak runners and
its cfs-chaos-soak CLI raise instead of running on the host."""

import math

import numpy as np
import pytest
import torch

from chubaofs_tpu.chaos import soak as j_soak
from chubaofs_tpu.tools import cfsevents as j_cfsevents
from chubaofs_tpu.tools import cfstop as j_cfstop
from chubaofs_tpu.tools import cfstrace as j_cfstrace
from chubaofs_tpu.utils import alerts as j_alerts
from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.chaos import soak as t_soak
from chubaofs_tpu_torch.tools import chaos_soak as t_chaos_soak
from chubaofs_tpu_torch.tools import cfsevents as t_cfsevents
from chubaofs_tpu_torch.tools import cfstop as t_cfstop
from chubaofs_tpu_torch.tools import cfstrace as t_cfstrace
from chubaofs_tpu_torch.utils import alerts as t_alerts

CPU = "cpu"
# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)

STAGES = ["download", "codec.host", "codec.device", "writeback", "encode",
          "pool.checkout"]
OPS = ["scheduler.repair", "access.put", "access.get", "blobnode.get_shard",
       "codec.reconstruct", "proxy.alloc"]


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


def assert_same(a, b, path="$"):
    """Equal structure; strings, ints and bools exact; floats within 1e-12
    relative."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), path
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0) or a == b, \
            (path, a, b)
        return
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def make_spans(seed: int, traces: int = 4) -> list[dict]:
    """Span records in the trace sink's shape: a root per trace, children
    linked by parent span id (a few orphaned, as after sampling), each with
    named stages [name, offset_us, dur_us] that overlap at random."""
    rng = np.random.default_rng(seed)
    records: list[dict] = []
    t_base = 1_700_000_000.0 + float(rng.integers(0, 10_000))
    sid = 0
    for t in range(traces):
        trace_id = f"{seed:04x}{t:04x}" + "ab" * 12
        root_start = round(t_base + t * 0.5 + float(rng.random()) * 0.1, 6)
        root_dur = int(rng.integers(20_000, 400_000))
        sid += 1
        root = {"trace_id": trace_id, "span_id": f"s{sid:06d}",
                "parent_span_id": None, "op": OPS[t % 2],
                "start": root_start, "dur_us": root_dur}
        spans = [root]
        for _ in range(int(rng.integers(2, 7))):
            parent = spans[int(rng.integers(0, len(spans)))]
            off = int(rng.integers(0, max(1, parent["dur_us"] // 2)))
            dur = int(rng.integers(1, max(2, parent["dur_us"] - off)))
            sid += 1
            pid = parent["span_id"] if rng.random() > 0.15 else "gone"
            spans.append({"trace_id": trace_id, "span_id": f"s{sid:06d}",
                          "parent_span_id": pid,
                          "op": OPS[int(rng.integers(0, len(OPS)))],
                          "start": round(parent["start"] + off / 1e6, 6),
                          "dur_us": dur})
        for rec in spans:
            n = int(rng.integers(0, 5))
            stages = []
            for _ in range(n):
                off = int(rng.integers(0, rec["dur_us"]))
                dur = int(rng.integers(0, rec["dur_us"] - off + 1))
                stages.append([STAGES[int(rng.integers(0, len(STAGES)))],
                               off, dur])
            if stages:
                rec["stages"] = stages
        records.extend(spans)
    return records


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cfstrace_library_matches_jax(seed):
    records = make_spans(seed)
    by_trace: dict[str, list[dict]] = {}
    for r in records:
        by_trace.setdefault(r["trace_id"], []).append(r)
    for recs in by_trace.values():
        for root_op in (None, "scheduler.repair", "blobnode.get_shard",
                        "no.such.op"):
            want = j_cfstrace.critical_path(recs, root_op)
            got = t_cfstrace.critical_path(recs, root_op)
            assert_same(got, want)
            if "error" not in want:
                assert t_cfstrace.render_report(got) \
                    == j_cfstrace.render_report(want)
        for a, b in (("download", "codec."), ("codec.host", "codec.device"),
                     ("encode", "writeback")):
            assert_same(t_cfstrace.stage_overlap(recs, a, b),
                        j_cfstrace.stage_overlap(recs, a, b))
        for stages in (True, False):
            assert t_cfstrace.waterfall(recs, stages) \
                == j_cfstrace.waterfall(recs, stages)
        assert t_cfstrace.flamegraph(recs) == j_cfstrace.flamegraph(recs)
        assert_same(list(t_cfstrace.build_tree(recs)),
                    list(j_cfstrace.build_tree(recs)))
    want = j_cfstrace.aggregate(records)
    got = t_cfstrace.aggregate(records)
    assert_same(got, want)
    assert t_cfstrace.render_top(got) == j_cfstrace.render_top(want)
    assert t_cfstrace.waterfall([]) == j_cfstrace.waterfall([])
    assert_same(t_cfstrace.critical_path([]), j_cfstrace.critical_path([]))


def make_events(seed: int, spans: list[dict]) -> tuple[list[dict], str]:
    """An event timeline in the journal's record shape: one alert lifecycle
    with autopilot decisions stamped with its fingerprint, chaff alerts,
    and events that carry the spans' trace ids. Returns (events, fp)."""
    rng = np.random.default_rng(seed)
    labels = {"slo": "put_p99"}
    fp = j_alerts.fingerprint("slo_failing", labels)
    assert t_alerts.fingerprint("slo_failing", labels) == fp
    t0 = 1_700_000_000.0 + float(rng.integers(0, 1000))
    trace_ids = sorted({s["trace_id"] for s in spans})
    evs = []
    ts = t0
    for i in range(int(rng.integers(12, 24))):
        ts = round(ts + float(rng.random()) * 3.0, 6)
        kind = int(rng.integers(0, 6))
        base = {"ts": ts, "role": "master", "addr": "m:1", "seq": i}
        if kind == 0:
            evs.append({**base, "type": "alert_firing",
                        "severity": "critical", "entity": "slo_failing",
                        "detail": {"labels": dict(labels)}})
        elif kind == 1:
            dec = ["considered", "executed", "confirmed"][i % 3]
            evs.append({**base, "type": f"autopilot_{dec}",
                        "severity": "info", "entity": "b-hot",
                        "detail": {"fingerprint": fp, "decision": dec}})
        elif kind == 2:
            evs.append({**base, "type": "alert_resolved", "severity": "info",
                        "entity": "slo_failing",
                        "detail": {"labels": dict(labels)}})
        elif kind == 3:
            evs.append({**base, "type": "alert_firing",
                        "severity": "warning", "entity": "repair_backlog",
                        "detail": {"labels": {}}})
        else:
            evs.append({**base, "type": "task_finished", "severity": "info",
                        "entity": f"t{i}",
                        "trace_id": trace_ids[int(rng.integers(
                            0, len(trace_ids)))],
                        "detail": {"kind": "disk_repair"}})
    rng.shuffle(evs)
    return evs, fp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cfsevents_joins_match_jax(seed):
    spans = make_spans(seed)
    evs, fp = make_events(seed, spans)
    for e in evs:
        assert t_cfsevents.event_fingerprint(e) \
            == j_cfsevents.event_fingerprint(e)
        assert t_cfsevents.fmt_event(e) == j_cfsevents.fmt_event(e)
    for f in (fp, "repair_backlog|", "nope|x"):
        assert_same(t_cfsevents.correlate_alert_chain(evs, f),
                    j_cfsevents.correlate_alert_chain(evs, f))
    assert t_cfsevents.correlate_alert_chain(evs, fp)
    for tid in sorted({s["trace_id"] for s in spans}) + ["no-such-trace"]:
        mine = [s for s in spans if s["trace_id"] == tid]
        assert_same(t_cfsevents.correlate(evs, mine, tid),
                    j_cfsevents.correlate(evs, mine, tid))


def make_frames(seed: int) -> tuple[dict, dict]:
    """Two cfs-top frames of three targets (one unreachable in the second,
    one restarted between them) over the metric families the rows read."""
    rng = np.random.default_rng(seed)
    fams = ["cfs_access_put_count", "cfs_access_get_count",
            "cfs_codec_batch_jobs_sum", "cfs_codec_batch_jobs_count",
            "cfs_cache_lookups", "cfs_cache_hits",
            "cfs_scheduler_repaired_shards",
            "cfs_scheduler_repair_bytes_downloaded",
            'cfs_access_read_bytes{kind="requested"}',
            'cfs_access_read_bytes{kind="shards_read"}',
            'cfs_evloop_backpressure{shard="0",srv="pkt"}',
            'cfs_evloop_conns{inst="0",shard="0",srv="pkt"}',
            'cfs_scheduler_tasks{kind="repair",state="pending"}',
            "cfs_alerts_firing", "cfs_autopilot_armed",
            "cfs_autopilot_budget_remaining",
            'cfs_autopilot_decisions{decision="executed"}',
            'cfs_objectnode_requests{tenant="a"}',
            'cfs_objectnode_throttled{tenant="a"}',
            'cfs_metanode_partitions', 'cfs_meta_partition_ops{pid="1"}']
    buckets = ["0.001", "0.01", "0.1", "1", "+Inf"]
    targets = ["10.0.0.1:9500", "10.0.0.2:9500", "10.0.0.3:9500"]

    def snap(scale: float) -> dict:
        out = {f: float(rng.integers(0, 1000)) * scale for f in fams}
        cum = 0.0
        for b in buckets:
            cum += float(rng.integers(0, 50)) * scale
            out[f'cfs_access_put_bucket{{le="{b}"}}'] = cum
        out["cfs_boot_time_seconds"] = 1_700_000_000.0
        return out

    prev = {"mono": 100.0, "metrics": {t: snap(1.0) for t in targets},
            "health": {t: {"status": "ok", "reasons": []} for t in targets},
            "errors": []}
    cur_m = {t: snap(2.0) for t in targets}
    cur_m[targets[1]] = None
    cur_m[targets[2]]["cfs_boot_time_seconds"] = 1_700_000_100.0
    cur_m[targets[2]]["cfs_access_put_count"] = 3.0
    cur = {"mono": 100.0 + 1.0 + float(rng.random()) * 9.0, "metrics": cur_m,
           "health": {targets[0]: {"status": "degraded",
                                   "reasons": ["put_p99 burn"]},
                      targets[1]: {"status": "failing",
                                   "reasons": ["unreachable"]},
                      targets[2]: {"status": "ok", "reasons": []}},
           "errors": ["10.0.0.2:9500: timed out"]}
    return prev, cur


class _FrozenTime:
    """Stands in for the time module in both cfstop copies, so the UP
    column and the header's clock read the same instant."""

    @staticmethod
    def time():
        return 1_700_000_500.0

    @staticmethod
    def strftime(fmt, t=None):
        return "12:00:00"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cfstop_rows_and_render_match_jax(seed, monkeypatch):
    monkeypatch.setattr(j_cfstop, "time", _FrozenTime)
    monkeypatch.setattr(t_cfstop, "time", _FrozenTime)
    prev, cur = make_frames(seed)
    want = j_cfstop.compute_rows(prev, cur)
    got = t_cfstop.compute_rows(prev, cur)
    assert_same(got, want)
    assert any(r.get("unreachable") for r in got)
    assert any(r.get("restart") for r in got)
    assert t_cfstop.render(got, cur["errors"]) \
        == j_cfstop.render(want, cur["errors"])
    assert_same(t_cfstop.frame_record(90.0, cur, got),
                j_cfstop.frame_record(90.0, cur, want))
    # the first frame has no prior: flow cells stay '-'
    first = {"mono": 0.0, "metrics": {}, "health": {}}
    assert_same(t_cfstop.compute_rows(first, prev),
                j_cfstop.compute_rows(first, prev))
    assert t_cfstop.render([]) == j_cfstop.render([])


SMOKE = dict(n_nodes=6, disks_per_node=1, rounds=4, puts_per_round=2,
             sizes=[8_000, 120_000], read_deadline=0.25, write_deadline=1.5)


@pytest.mark.chaos
@pytest.mark.parametrize("plan,seed", [("node_wedge", 11), ("link_drop", 13),
                                       ("shard_bitrot", 21)])
def test_run_soak_event_log_matches_jax(tmp_path, plan, seed):
    """The determinism contract across packages: the same plan and seed
    inject the same faults at the same virtual times on the same nodes."""
    want = j_soak.run_soak(str(tmp_path / "jax"), plan, seed=seed, **SMOKE)
    got = t_soak.run_soak(str(tmp_path / "port"), plan, seed=seed,
                          device=CPU, **SMOKE)
    assert want["ok"] and got["ok"]
    assert any(e["event"] == "inject" for e in got["events"])
    assert got["events"] == want["events"]


def test_soak_runners_and_cli_refuse_without_a_gpu(tmp_path, monkeypatch):
    """No host fallback: a runner or the CLI with no device named means the
    CUDA device, and with none present it raises before any soak runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_soak.run_soak(str(tmp_path / "a"), "node_wedge", seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_soak.run_kill_soak(str(tmp_path / "b"), seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_soak.run_cache_soak(str(tmp_path / "c"), seed=1)
    for argv in ([], ["--kill-blobnode"], ["--cache"],
                 ["--kill-blobnode", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_chaos_soak.main(argv + ["--root", str(tmp_path / "cli")])
    # nothing was built under the CLI's root: it refused before any cluster
    assert not (tmp_path / "cli").exists()
