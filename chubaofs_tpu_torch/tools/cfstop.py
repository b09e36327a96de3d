"""cfs-top — live cluster dashboard over the console health/metrics rollup.

The `top(1)` of the observability plane: poll the console's `/api/health`
(SLO verdicts, unreachable daemons reported as failing) and `/api/metrics`
(every target's exposition in one scrape), diff adjacent polls, and render
one row per daemon target:

    TARGET          SLO       PUT/S  GET/S  PUT99MS  CONNS  BP/S  LAG99  CODEC/B  REPAIRQ

  * PUT/S / GET/S — access op completions per second (histogram _count
    deltas between frames);
  * PUT99MS — window p99 of the PUT latency histogram (bucket deltas, the
    SAME math utils/slo.py uses, so the dashboard and /health cannot
    disagree);
  * CONNS / BP/S / LAG99 — evloop live connections, read-pause events per
    second, and the window p99 of `cfs_evloop_loop_lag_ms` (the shard-
    saturation signal);
  * CODEC/B — mean codec batch occupancy over the window (jobs per drained
    device batch — "is the gateway feeding the chip?");
  * CACHE% — cache-plane hit ratio over the window (`cfs_cache_hits` /
    `cfs_cache_lookups` deltas; '-' when the target serves no cache);
  * THR% — QoS throttled-request share over the window
    (`cfs_objectnode_throttled` / `cfs_objectnode_requests` deltas; '-'
    when the target saw no shaped requests);
  * META — metadata plane: partitions hosted (`cfs_metanode_partitions`
    gauge) and the hottest single partition's ops/s over the window (max
    per-pid delta of `cfs_metanode_partition_ops{pid}` / dt — the
    load-split signal), rendered `parts/hot`; '-' when the target hosts
    no meta partitions;
  * REPAIRQ — repair tasks outstanding (`cfs_scheduler_tasks` gauge sum);
  * REPB/SH — repair-traffic cost over the window: bytes downloaded per
    repaired shard (`cfs_scheduler_repair_bytes_downloaded` /
    `cfs_scheduler_repaired_shards` deltas, restart-clamped; hedged bytes
    excluded by the scheduler's accounting); '-' when the window repaired
    nothing — regenerating modes (RG6P6) show this well under the RS
    k-shard cost;
  * UP — seconds since the daemon's `cfs_boot_time_seconds` boot stamp. A
    boot stamp that MOVED between frames is a confirmed restart — the row
    tags `(restart)` from that cross-check, not just from negative-delta
    clamping (which a counter reset can also cause);
  * ALERTS — alert instances currently firing (`cfs_alerts_firing`);
  * AUTO — autopilot plane: `actions/budget` — real actuator
    runs in the window (`cfs_autopilot_decisions{decision="executed"}`
    delta, restart-clamped) over the remaining hourly action budget
    (`cfs_autopilot_budget_remaining` gauge); '-' when this target's
    controller is disarmed (`cfs_autopilot_armed` absent or 0).

`--once` renders a single frame (two scrapes `--interval` apart) for CI and
scripts; without it the terminal refreshes in place until ^C. `--addr`
(repeatable) skips the console and polls daemons' `/health` + `/metrics`
directly. `--json` emits the frame as JSON instead of the table.

`--frames N --out path` is the archival mode (the capacity-report consumer,
cfs-capacity rides the same record shape): each frame is APPENDED to `path`
as one JSON line stamped with a run-relative monotonic `t`, and the process
exits after N frames — `cfs-top --json` alone only prints to a terminal.
"""

from __future__ import annotations

import json
import sys
import time

from chubaofs_tpu_torch.utils.metrichist import (
    family_sum, hist_delta, hist_quantile, parse_key)
from chubaofs_tpu_torch.utils.slo import FAILING, RANK

COLUMNS = ("TARGET", "SLO", "UP", "PUT/S", "GET/S", "PUT99MS", "CONNS",
           "BP/S", "LAG99", "CODEC/B", "CACHE%", "RDAMP", "THR%", "META",
           "REPAIRQ", "REPB/SH", "ALERTS", "AUTO")


# -- scraping ------------------------------------------------------------------


def split_rollup(text: str) -> dict[str, dict[str, float] | None]:
    """The console /api/metrics rollup -> {target: metrics-or-None}. The
    rollup tags each section `# == target ADDR ==` and an unreachable one
    `# == target ADDR UNREACHABLE: ... ==` — those map to None so the
    dashboard renders the corpse instead of dropping it."""
    from chubaofs_tpu_torch.tools.cfsstat import parse_metrics

    out: dict[str, dict[str, float] | None] = {}
    cur: str | None = None
    body: list[str] = []

    def flush():
        if cur is not None and out.get(cur, "new") == "new":
            out[cur] = parse_metrics("\n".join(body))

    for line in text.splitlines():
        if line.startswith("# == target "):
            flush()
            rest = line[len("# == target "):].rstrip("= ").strip()
            body = []
            if " UNREACHABLE" in rest:
                cur = rest.split(" UNREACHABLE", 1)[0].strip()
                out[cur] = None
                cur = None  # nothing to parse for this section
            else:
                cur = rest
        else:
            body.append(line)
    flush()
    return out


def fetch_frame(console: str | None, addrs: list[str],
                timeout: float = 5.0) -> dict:
    """One poll: health verdicts + per-target metrics, stamped monotonic."""
    from chubaofs_tpu_torch.tools.cfsstat import scrape

    health: dict[str, dict] = {}
    metrics: dict[str, dict | None] = {}
    errors: list[str] = []
    if console:
        try:
            roll = json.loads(scrape(console, "/api/health", timeout=timeout))
            for t in roll.get("targets", ()):
                health[t.get("target", "?")] = t
        except Exception as e:
            errors.append(f"{console}/api/health: {e}")
        try:
            metrics = split_rollup(
                scrape(console, "/api/metrics", timeout=timeout))
        except Exception as e:
            errors.append(f"{console}/api/metrics: {e}")
    else:
        for addr in addrs:
            try:
                health[addr] = {"target": addr, **json.loads(
                    scrape(addr, "/health", timeout=timeout))}
            except Exception:
                health[addr] = {"target": addr, "status": FAILING,
                                "reasons": ["unreachable"]}
            try:
                from chubaofs_tpu_torch.tools.cfsstat import parse_metrics

                metrics[addr] = parse_metrics(
                    scrape(addr, "/metrics", timeout=timeout))
            except Exception:
                metrics[addr] = None
    return {"mono": time.monotonic(), "health": health, "metrics": metrics,
            "errors": errors}


# -- per-target row math -------------------------------------------------------


def _rate(prev: dict, cur: dict, family: str, dt: float) -> float:
    d = family_sum(cur, family) - family_sum(prev, family)
    if d < 0:
        # restart contract (same as metrichist.rates / hist_delta): the
        # counter restarted from zero, so the post-restart total is the
        # window's delta — a busy restarted daemon must not render idle
        d = family_sum(cur, family)
    return d / dt if dt > 0 else 0.0


def _p99(prev: dict, cur: dict, family: str) -> float | None:
    buckets, count = hist_delta(prev, cur, family)
    return hist_quantile(buckets, count, 0.99)


def _label_delta(prev: dict, cur: dict, family: str, label: str,
                 value: str) -> float:
    """Restart-clamped window delta of the series of `family` whose
    `label` equals `value` — family_sum would fold the labeled series
    together, and ratio/selector cells need one slice apart."""
    tot = 0.0
    for k, v in cur.items():
        name, labels = parse_key(k)
        if name != family or labels.get(label) != value:
            continue
        d = v - prev.get(k, 0.0)
        if d < 0:
            d = v  # counter restarted: the post-restart total is the window
        tot += d
    return tot


def _kind_delta(prev: dict, cur: dict, family: str, kind: str) -> float:
    return _label_delta(prev, cur, family, "kind", kind)


def _hottest_pid_rate(prev: dict, cur: dict, dt: float) -> float:
    """Max per-partition window rate of cfs_metanode_partition_ops{pid} —
    per-SERIES deltas (not family_sum: the hottest partition is the split
    signal, and summing would hide the skew), restart-clamped like every
    flow cell."""
    if dt <= 0:
        return 0.0
    best = 0.0
    for k, v in cur.items():
        if parse_key(k)[0] != "cfs_metanode_partition_ops":
            continue
        d = v - prev.get(k, 0.0)
        if d < 0:
            d = v  # counter restarted: the post-restart total is the window
        best = max(best, d / dt)
    return round(best, 2)


def compute_row(target: str, prev: dict | None, cur: dict | None,
                dt: float, health: dict | None) -> dict:
    """One dashboard row from two metric snapshots of one target."""
    h = health or {}
    row: dict = {"target": target, "slo": h.get("status", "?"),
                 "reasons": h.get("reasons", [])}
    if cur is None:
        # no metrics this frame — but the HEALTH verdict stands on its own:
        # only a target that answered neither surface renders as the
        # failing corpse. A transient /api/metrics hiccup on an otherwise
        # ok cluster must not flip every row to 'failing (unreachable)'.
        if not h or "unreachable" in (h.get("reasons") or ()):
            row["slo"] = FAILING
            row["unreachable"] = True
        return row
    # state gauges read from the current frame alone
    parts = family_sum(cur, "cfs_metanode_partitions")
    row["meta_parts"] = int(parts) if parts > 0 else None
    row["conns"] = int(family_sum(cur, "cfs_evloop_conns"))
    row["repair_q"] = int(family_sum(cur, "cfs_scheduler_tasks"))
    row["alerts"] = int(family_sum(cur, "cfs_alerts_firing"))
    # autopilot plane: armed flag + remaining budget are state
    # gauges (current frame); the actions count is a window delta below
    row["auto_armed"] = family_sum(cur, "cfs_autopilot_armed") > 0
    row["auto_budget"] = int(
        family_sum(cur, "cfs_autopilot_budget_remaining")) \
        if row["auto_armed"] else None
    # UP from the boot stamp (wall protocol: the daemon exports ITS wall
    # boot time, we subtract OUR wall clock — same contract as heartbeats)
    boot = family_sum(cur, "cfs_boot_time_seconds")
    now_wall = time.time()
    row["up_s"] = int(now_wall - boot) if boot > 0 else None
    if prev:
        prev_boot = family_sum(prev, "cfs_boot_time_seconds")
        if boot > 0 and prev_boot > 0 and boot > prev_boot + 0.5:
            # the boot stamp MOVED between frames: a restart happened, no
            # counter inference needed — the cross-check the (restart) tag
            # rides instead of relying only on negative-delta clamping
            row["restart"] = True
    if not prev:
        # no prior frame for this target (first poll, or its last scrape
        # failed): a delta against zero would render LIFETIME totals as a
        # window rate/p99 — a bogus spike; flow cells stay '-' until the
        # next poll, same no-data discipline as the SLO evaluator
        return row
    row["put_s"] = round(_rate(prev, cur, "cfs_access_put_count", dt), 2)
    row["get_s"] = round(_rate(prev, cur, "cfs_access_get_count", dt), 2)
    p99 = _p99(prev, cur, "cfs_access_put")
    row["put99_ms"] = None if p99 is None else round(p99 * 1e3, 2)
    row["bp_s"] = round(_rate(prev, cur, "cfs_evloop_backpressure", dt), 2)
    lag = _p99(prev, cur, "cfs_evloop_loop_lag_ms")
    row["lag99_ms"] = None if lag is None else round(lag, 2)  # already ms
    # mean jobs per drained codec batch over the window
    jobs = family_sum(cur, "cfs_codec_batch_jobs_sum") \
        - family_sum(prev, "cfs_codec_batch_jobs_sum")
    batches = family_sum(cur, "cfs_codec_batch_jobs_count") \
        - family_sum(prev, "cfs_codec_batch_jobs_count")
    row["codec_occ"] = round(jobs / batches, 2) if batches > 0 else None
    # cache-plane hit ratio over the window; '-' when this
    # target ran no cached lookups. _rate with dt=1 gives the restart-
    # clamped window DELTA — the same contract every flow cell rides.
    lookups = _rate(prev, cur, "cfs_cache_lookups", 1.0)
    hits = _rate(prev, cur, "cfs_cache_hits", 1.0)
    row["cache_pct"] = round(100.0 * hits / lookups, 1) if lookups > 0 else None
    # read amplification over the window: backend shard bytes
    # fetched per byte the callers asked for — ~1.0 means ranged reads move
    # window bytes only, stripe/range means whole-stripe gathers; '-' on
    # targets that served no reads this window
    req_b = _kind_delta(prev, cur, "cfs_access_read_bytes", "requested")
    shard_b = _kind_delta(prev, cur, "cfs_access_read_bytes", "shards_read")
    row["read_amp"] = round(shard_b / req_b, 2) if req_b > 0 else None
    # QoS throttled-request share over the window: what fraction
    # of this gateway's requests the per-tenant plane turned away; '-' on
    # targets that saw no shaped requests (plane unarmed, or not a gateway)
    reqs = _rate(prev, cur, "cfs_objectnode_requests", 1.0)
    thr = _rate(prev, cur, "cfs_objectnode_throttled", 1.0)
    row["thr_pct"] = round(100.0 * thr / reqs, 1) if reqs > 0 else None
    # metadata plane: the hottest single partition's window
    # ops/s (the load-split signal); partitions-hosted is a state gauge
    # above, so a metanode's first frame still renders `N/-`
    row["meta_hot_ops"] = _hottest_pid_rate(prev, cur, dt) \
        if row.get("meta_parts") else None
    # repair traffic: window bytes downloaded per repaired
    # shard; '-' when nothing was repaired this window. _rate with dt=1
    # gives the restart-clamped window delta, same as the cache cell.
    rep_sh = _rate(prev, cur, "cfs_scheduler_repaired_shards", 1.0)
    rep_b = _rate(prev, cur, "cfs_scheduler_repair_bytes_downloaded", 1.0)
    row["repair_bps"] = round(rep_b / rep_sh, 1) if rep_sh > 0 else None
    # autopilot actions this window: only REAL actuator runs count
    # (considered/damped/refused decisions are bookkeeping, not actions);
    # restart-clamped like every flow cell
    row["auto_acts"] = int(_label_delta(
        prev, cur, "cfs_autopilot_decisions", "decision", "executed")) \
        if row.get("auto_armed") else None
    return row


def compute_rows(prev_frame: dict, cur_frame: dict) -> list[dict]:
    dt = cur_frame["mono"] - prev_frame["mono"]
    targets = list(dict.fromkeys(
        list(cur_frame["metrics"]) + list(cur_frame["health"])))
    return [compute_row(t, (prev_frame["metrics"] or {}).get(t),
                        cur_frame["metrics"].get(t), dt,
                        cur_frame["health"].get(t))
            for t in targets]


# -- rendering -----------------------------------------------------------------


def _cell(v) -> str:
    if v is None:
        return "-"
    return f"{v:g}" if isinstance(v, float) else str(v)


def _meta_cell(r: dict) -> str:
    """META column: `parts/hot-ops` (e.g. `4/123.5`); '-' off-metanodes.
    hot-ops is '-' on the first frame (no prior to delta against)."""
    if r.get("meta_parts") is None:
        return "-"
    return f"{r['meta_parts']}/{_cell(r.get('meta_hot_ops'))}"


def _auto_cell(r: dict) -> str:
    """AUTO column: `actions/budget` (window actuator runs over remaining
    hourly budget, e.g. `1/5`); '-' when the controller is disarmed.
    actions is '-' on the first frame (no prior to delta against)."""
    if not r.get("auto_armed"):
        return "-"
    return f"{_cell(r.get('auto_acts'))}/{_cell(r.get('auto_budget'))}"


def render(rows: list[dict], errors: list[str] = ()) -> str:
    if not rows:
        return "(no targets)" + ("".join(f"\n! {e}" for e in errors))
    worst = max((r["slo"] for r in rows),
                key=lambda s: RANK.get(s, RANK[FAILING]))
    cells = [[r["target"], r["slo"]
              + (" (unreachable)" if r.get("unreachable") else "")
              + (" (restart)" if r.get("restart") else ""),
              _cell(r.get("up_s")),
              _cell(r.get("put_s")), _cell(r.get("get_s")),
              _cell(r.get("put99_ms")), _cell(r.get("conns")),
              _cell(r.get("bp_s")), _cell(r.get("lag99_ms")),
              _cell(r.get("codec_occ")), _cell(r.get("cache_pct")),
              _cell(r.get("read_amp")),
              _cell(r.get("thr_pct")), _meta_cell(r),
              _cell(r.get("repair_q")), _cell(r.get("repair_bps")),
              _cell(r.get("alerts")), _auto_cell(r)]
             for r in rows]
    widths = [max(len(COLUMNS[i]), max(len(row[i]) for row in cells))
              for i in range(len(COLUMNS))]
    lines = [f"cluster: {worst}   targets: {len(rows)}   "
             f"{time.strftime('%H:%M:%S')}"]
    lines.append("  ".join(c.ljust(w) for c, w in zip(COLUMNS, widths)))
    for row in cells:
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    for r in rows:
        for reason in r.get("reasons", ()):
            lines.append(f"! {r['target']}: {reason}")
    for e in errors:
        lines.append(f"! {e}")
    return "\n".join(lines)


# -- archival ------------------------------------------------------------------


def frame_record(t0: float, frame: dict, rows: list[dict]) -> dict:
    """One JSONL archive record: run-relative monotonic stamp + the computed
    rows. Monotonic (not wall) so frame spacing survives NTP steps; run-
    relative so two archives of the same scenario diff cleanly."""
    return {"t": round(frame["mono"] - t0, 3), "rows": rows,
            "errors": list(frame.get("errors", ()))}


# -- CLI -----------------------------------------------------------------------


def main(argv=None, out=None) -> int:
    import argparse

    out = out or sys.stdout
    p = argparse.ArgumentParser(
        prog="cfs-top",
        description="live cluster dashboard over the console rollup")
    p.add_argument("--console", default=None,
                   help="console address (uses /api/health + /api/metrics)")
    p.add_argument("--addr", action="append", default=[],
                   help="poll a daemon directly (repeatable; skips console)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between polls (and the rate window)")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit (CI mode)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--frames", type=int, default=0,
                   help="archive N frames then exit (requires --out)")
    p.add_argument("--out", default="",
                   help="append frames as JSONL records to this path")
    args = p.parse_args(argv)
    if not args.console and not args.addr:
        p.error("give --console or --addr")
    if bool(args.frames) != bool(args.out):
        p.error("--frames and --out go together")
    if args.out:
        # archival is its own mode: a stray --once would truncate the
        # archive to 1 frame with exit 0, and --json would be silently
        # ignored — both are operator mistakes worth failing loudly on
        if args.frames < 1:
            p.error("--frames must be >= 1")
        if args.once or args.json:
            p.error("--out is the archival mode; drop --once/--json")

    interval = max(0.1, args.interval)
    prev = fetch_frame(args.console, args.addr)
    t0 = prev["mono"]
    archived = 0
    try:
        while True:
            time.sleep(interval)
            cur = fetch_frame(args.console, args.addr)
            rows = compute_rows(prev, cur)
            if args.out:
                with open(args.out, "a", encoding="utf-8") as f:
                    f.write(json.dumps(frame_record(t0, cur, rows)) + "\n")
                archived += 1
                if archived >= args.frames:
                    return 0
            elif args.json:
                print(json.dumps({"rows": rows, "errors": cur["errors"]},
                                 indent=2), file=out)
            else:
                if not args.once and out is sys.stdout:
                    out.write("\x1b[2J\x1b[H")  # clear + home: live refresh
                print(render(rows, cur["errors"]), file=out)
            if args.once:
                return 0
            prev = cur
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
