"""cfs-stat — scrape a daemon's /metrics twice and diff the snapshots.

The `iostat`-style ops companion to the observability plane: point it at any
daemon role's /metrics (master API, metanode/datanode statsListen side-door,
blobstore gateway, console rollup), take two snapshots `--interval` seconds
apart, and print per-metric deltas + rates — so a perf investigation reads
raft drain-batch and codec-batch counters moving in real time instead of
eyeballing two raw exposition dumps.

Usage:
    python -m chubaofs_tpu_torch.tools.cfsstat --addr 127.0.0.1:17010 \
        [--interval 5] [--path /metrics] [--filter raft] [--json]

Also a library: parse_metrics / diff_metrics are the exposition-format
consumers the conformance tests drive.
"""

from __future__ import annotations

import json
import sys
import time


def parse_metrics(text: str) -> dict[str, float]:
    """Prometheus text exposition -> {'name{labels}': value}. Comment/TYPE
    lines are skipped; malformed lines raise (the conformance contract —
    a bad render must fail loudly here, not scrape as garbage)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        if not key:
            raise ValueError(f"unparseable metric line: {line!r}")
        out[key] = float(val)
    return out


def parse_types(text: str) -> dict[str, str]:
    """# TYPE declarations -> {metric_family: kind}."""
    out: dict[str, str] = {}
    for line in text.splitlines():
        parts = line.strip().split()
        if len(parts) == 4 and parts[0] == "#" and parts[1] == "TYPE":
            out[parts[2]] = parts[3]
    return out


def diff_metrics(before: dict[str, float], after: dict[str, float],
                 interval_s: float, types: dict[str, str] | None = None) -> list[dict]:
    """Per-metric rows: value now, delta across the window, rate/s.
    Metrics new in `after` diff against 0; vanished ones are dropped.

    With `types` (parse_types of the scrape), a NEGATIVE delta on a
    monotonic series — a counter or a histogram's _bucket/_sum/_count —
    means the daemon restarted between the two scrapes: the series restarted
    from zero, so the post-restart value IS the window's delta. Such rows
    clamp to that and carry restart=True (rendered as a `(restart)` tag)
    instead of printing a bogus negative rate. Gauges go down legitimately
    and are never clamped; without `types` nothing is (the legacy
    two-plain-dicts library call)."""
    from chubaofs_tpu_torch.utils.metrichist import is_monotonic

    rows = []
    for key in sorted(after):
        b = before.get(key, 0.0)
        a = after[key]
        delta = a - b
        restart = False
        if delta < 0 and types is not None and is_monotonic(key, types):
            delta = a
            restart = True
        rows.append({
            "metric": key,
            "value": a,
            "delta": round(delta, 6),
            "rate": round(delta / interval_s, 6) if interval_s > 0 else 0.0,
            "restart": restart,
        })
    return rows


REPAIR_METRIC_MARKS = ("cfs_scheduler_", "scrub", "repair")


def is_repair_metric(name: str) -> bool:
    """The repair-plane rollup filter (--repair): scheduler task gauges by
    kind/state, lease expiries, stale reports, probe failures, scrub
    progress, and the bytes-downloaded / shards-repaired counters the
    bytes-per-repaired-shard claim is computed from."""
    return any(mark in name for mark in REPAIR_METRIC_MARKS)


READ_METRIC_MARKS = ("cfs_access_read_bytes", "cfs_access_get",
                     "cfs_access_read_fail", "cfs_cache_", "cfs_bcache_",
                     "shard_get")


def is_read_metric(name: str) -> bool:
    """The read-path rollup filter (--reads): the read-amp byte
    ledger (requested/shards_read/decoded), GET latency/error families,
    cache-plane and block-store counters, and blobnode shard-get traffic."""
    return any(mark in name for mark in READ_METRIC_MARKS)


def read_amp_summary(before: dict[str, float],
                     after: dict[str, float]) -> dict | None:
    """Window read-amp rollup from two snapshots: shards_read/requested
    (and the decoded share), restart-clamped per series. None when the
    window served no reads — callers print nothing rather than 0.0."""
    def kind_delta(kind: str) -> float:
        tot = 0.0
        for key, a in after.items():
            if (not key.startswith("cfs_access_read_bytes")
                    or f'kind="{kind}"' not in key):
                continue
            d = a - before.get(key, 0.0)
            tot += a if d < 0 else d
        return tot

    req = kind_delta("requested")
    if req <= 0:
        return None
    shards = kind_delta("shards_read")
    decoded = kind_delta("decoded")
    return {"requested_bytes": req, "shards_read_bytes": shards,
            "decoded_bytes": decoded,
            "read_amp": round(shards / req, 3)}


def repair_summary(before: dict[str, float],
                   after: dict[str, float]) -> dict | None:
    """Window repair-traffic rollup from two snapshots (--repair):
    bytes-per-repaired-shard derived from the downloaded-bytes and
    repaired-shards counter deltas, restart-clamped per series, plus the
    hedged-byte and beta-path shares and per-mode helper bytes. None when
    the window repaired nothing — callers print `-` (idle) rather than a
    bogus 0.0 ratio."""
    def fam_of(key: str) -> str:
        # strip labels, then any bundle target prefix ("node1:cfs_...")
        return key.split("{", 1)[0].rsplit(":", 1)[-1]

    def fam_delta(fam: str) -> float:
        tot = 0.0
        for key, a in after.items():
            if fam_of(key) != fam:
                continue
            d = a - before.get(key, 0.0)
            tot += a if d < 0 else d
        return tot

    shards = fam_delta("cfs_scheduler_repaired_shards")
    if shards <= 0:
        return None
    dl = fam_delta("cfs_scheduler_repair_bytes_downloaded")
    helper: dict[str, float] = {}
    for key, a in after.items():
        if (fam_of(key) == "cfs_scheduler_repair_helper_bytes"
                and 'mode="' in key):
            m = key.split('mode="', 1)[1].split('"', 1)[0]
            d = a - before.get(key, 0.0)
            helper[m] = helper.get(m, 0.0) + (a if d < 0 else d)
    return {
        "repaired_shards": shards,
        "downloaded_bytes": dl,
        "hedged_bytes": fam_delta("cfs_scheduler_repair_bytes_hedged"),
        "beta_shards": fam_delta("cfs_scheduler_repair_beta_shards"),
        "helper_bytes": {k: v for k, v in helper.items() if v > 0},
        "bytes_per_repaired_shard": round(dl / shards, 1),
    }


def bundle_window(bundle: dict) -> tuple[dict, dict, dict, float]:
    """Offline (--bundle) window: the first vs last frozen metric-history
    snapshot across a bundle's targets, series keys prefixed with the
    target (a cfs-doctor read_bundle result — one daemon's flat bundle or
    a console incident dir). Returns (before, after, types, interval_s)."""
    before: dict[str, float] = {}
    after: dict[str, float] = {}
    types: dict[str, str] = {}
    interval = 0.0
    for tname, payload in bundle["targets"].items():
        snaps = (payload.get("metrics") or {}).get("snapshots", [])
        if not snaps:
            continue
        first, last = snaps[0], snaps[-1]
        interval = max(interval, (last.get("mono") or last.get("ts", 0.0))
                       - (first.get("mono") or first.get("ts", 0.0)))
        for k, v in first.get("metrics", {}).items():
            before[f"{tname}:{k}"] = v
        for k, v in last.get("metrics", {}).items():
            after[f"{tname}:{k}"] = v
        for fam, kind in last.get("types", {}).items():
            types[f"{tname}:{fam}"] = kind
    if not after:
        raise ValueError("bundle froze no metric snapshots")
    return before, after, types, interval


def scrape(addr: str, path: str = "/metrics", timeout: float = 10.0) -> str:
    from chubaofs_tpu_torch.rpc.pool import NullPool

    # one-shot scrape: the NullPool keeps the no-direct-HTTPConnection
    # invariant (obslint rule 3) without parking a socket per target
    pool = NullPool(timeout=timeout)
    conn, _ = pool.checkout(addr)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode("utf-8", "replace")
        if resp.status != 200:
            raise OSError(f"{addr}{path}: HTTP {resp.status}: {body[:200]}")
        return body
    finally:
        pool.checkin(addr, conn)


def main(argv=None, out=None) -> int:
    import argparse

    out = out or sys.stdout
    p = argparse.ArgumentParser(
        prog="cfs-stat", description="scrape + diff two /metrics snapshots")
    p.add_argument("--addr", help="daemon host:port")
    p.add_argument("--bundle", default="",
                   help="diff the first vs last frozen metric-history "
                        "snapshot of a collected flight-recorder bundle "
                        "instead of scraping live (postmortem mode)")
    p.add_argument("--path", default="/metrics")
    p.add_argument("--interval", type=float, default=5.0,
                   help="seconds between the two snapshots")
    p.add_argument("--filter", default="",
                   help="only metrics whose name contains this substring")
    p.add_argument("--repair", action="store_true",
                   help="repair-plane rollup: only scheduler/scrub/repair "
                        "metrics (task counts by kind/state, lease "
                        "expiries, probe failures, scrub progress, repair "
                        "traffic), statics included")
    p.add_argument("--reads", action="store_true",
                   help="read-path rollup: read-amp byte ledger, GET "
                        "latency/errors, cache plane, blobnode shard-get "
                        "traffic — plus a computed read_amp summary line")
    p.add_argument("--all", action="store_true",
                   help="include zero-delta metrics")
    p.add_argument("--slowops", action="store_true",
                   help="also fetch the daemon's recent slow-op audit "
                        "entries (/slowops; /api/slowops on a console) and "
                        "print them next to the diff")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    if not args.addr and not args.bundle:
        p.error("give --addr or --bundle")

    bundle = None
    if args.bundle:
        from chubaofs_tpu_torch.tools.cfsdoctor import read_bundle

        try:
            bundle = read_bundle(args.bundle)
            before, after, types, elapsed = bundle_window(bundle)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    else:
        try:
            t0 = time.monotonic()
            before = parse_metrics(scrape(args.addr, args.path))
            time.sleep(max(0.0, args.interval))
            text = scrape(args.addr, args.path)
            after = parse_metrics(text)
            types = parse_types(text)
            elapsed = time.monotonic() - t0
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    slowops: list[dict] = []
    if args.slowops and bundle is not None:
        for tname, payload in bundle["targets"].items():
            slowops.extend({**rec, "target": tname} for rec in
                           (payload.get("slowops") or {}).get("slowops", []))
        slowops.sort(key=lambda r: r.get("ts", ""))
    elif args.slowops:
        # /api/slowops first: on a console that's the cluster-wide rollup
        # (its local /slowops is an empty log), on a master the same local
        # data; plain daemons 404 it and fall back to /slowops
        slow_err = None
        for path in ("/api/slowops", "/slowops"):
            try:
                slowops = json.loads(scrape(args.addr, path)).get("slowops", [])
                slow_err = None
                break
            except Exception as e:
                slow_err = f"{args.addr}{path}: {e}"
        if slow_err is not None:  # neither shape answered — not a quiet
            print(f"warning: slowops unavailable: {slow_err}",  # cluster
                  file=sys.stderr)

    rows = diff_metrics(before, after, elapsed, types=types)
    if args.filter:
        rows = [r for r in rows if args.filter in r["metric"]]
    if args.repair:
        # a repair inventory is mostly GAUGES sitting still (tasks by
        # kind/state): statics are the point, so --repair implies --all
        rows = [r for r in rows if is_repair_metric(r["metric"])]
    elif args.reads:
        rows = [r for r in rows if is_read_metric(r["metric"])]
        if not args.all:
            rows = [r for r in rows if r["delta"] != 0]
    elif not args.all:
        rows = [r for r in rows if r["delta"] != 0]
    amp = read_amp_summary(before, after) if args.reads else None
    rep = repair_summary(before, after) if args.repair else None
    if args.json:
        blob = {"interval_s": round(elapsed, 3), "rows": rows}
        if amp is not None:
            blob["read_amp"] = amp
        if args.repair:
            blob["repair"] = rep
        if args.slowops:
            blob["slowops"] = slowops
        print(json.dumps(blob, indent=2), file=out)
        return 0
    if not rows:
        print(f"(no metric moved in {elapsed:.1f}s; --all shows statics)",
              file=out)
    else:
        w = max(len(r["metric"]) for r in rows)
        print(f"{'METRIC'.ljust(w)}  {'VALUE':>14}  {'DELTA':>12}  {'RATE/S':>12}",
              file=out)
        for r in rows:
            tag = "  (restart)" if r.get("restart") else ""
            print(f"{r['metric'].ljust(w)}  {r['value']:>14g}  "
                  f"{r['delta']:>12g}  {r['rate']:>12g}{tag}", file=out)
    if args.slowops:
        shown = slowops[-20:]
        note = (f"showing last {len(shown)} of {len(slowops)}"
                if len(slowops) > len(shown) else f"{len(slowops)} recent")
        print(f"\nSLOW OPS ({note})", file=out)
        for rec in shown:
            print(f"  {rec.get('ts', '-')}  {rec.get('module', '?')}."
                  f"{rec.get('op', '?')}  {rec.get('latency_ms', 0):.1f}ms"
                  f"  trace={rec.get('trace_id', '-')}"
                  + (f"  err={rec['err']}" if rec.get("err") else ""),
                  file=out)
            if rec.get("track"):
                print(f"    track: {rec['track']}", file=out)
    if amp is not None:
        print(f"\nread_amp: {amp['read_amp']:g}  "
              f"(shards_read {amp['shards_read_bytes']:g}B / "
              f"requested {amp['requested_bytes']:g}B; "
              f"decoded {amp['decoded_bytes']:g}B)", file=out)
    if args.repair:
        if rep is None:
            print("\nbytes/repaired-shard: -  (no shards repaired this "
                  "window)", file=out)
        else:
            helper = "".join(
                f", helper[{m}] {v:g}B"
                for m, v in sorted(rep["helper_bytes"].items()))
            print(f"\nbytes/repaired-shard: "
                  f"{rep['bytes_per_repaired_shard']:g}  "
                  f"(downloaded {rep['downloaded_bytes']:g}B / "
                  f"{rep['repaired_shards']:g} shards; "
                  f"hedged {rep['hedged_bytes']:g}B, "
                  f"beta {rep['beta_shards']:g}{helper})", file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
