"""cfs-doctor — collect, inspect, and diff incident flight-recorder bundles.

The postmortem face of the incident plane: the per-daemon
flight recorder (`utils/flightrec.py`) freezes evidence when an alert
fires; the console `/api/incident` fans out and assembles one cross-daemon
incident directory; this tool is how an operator drives both by hand and
reads the result after the cluster is gone.

    cfs-doctor collect --console 127.0.0.1:8500          # via the console
    cfs-doctor collect --addr H:P --addr H:P             # direct fan-out
    cfs-doctor list [--dir DIR]                          # what's on disk
    cfs-doctor inspect BUNDLE_DIR [--json]               # incident summary
    cfs-doctor diff OLD_DIR NEW_DIR                      # what moved

`inspect` renders cause→evidence: the firing alert, its burn-rate window,
the top-moving metric families over the frozen snapshots, the slowest
spans, the in-window slowops (trace ids joined against the event
timeline), the autopilot actions taken (or damped/refused) inside the
window, and the hot profile thread buckets.

Also a library: `read_bundle` / `assemble_incident` / `correlate` /
`summarize` are shared with the console collector and the `--bundle`
offline mode of cfs-events / cfs-stat / cfs-trace.
"""

from __future__ import annotations

import json
import os
import sys
import time

from chubaofs_tpu_torch.utils import flightrec

SLOWOP_TS_FMT = "%Y-%m-%d %H:%M:%S"
WINDOW_LOOKBACK_S = 120.0   # evidence window opens this far before the
                            # alert's since-stamp (the burn window that
                            # fired it plus margin for the slow tail)


# -- bundle loading ------------------------------------------------------------


def read_bundle(path: str) -> dict:
    """Load a bundle directory — either one daemon's flat bundle (the
    flightrec section files) or a console-assembled incident directory
    (incident.json + one subdir per target). Returns
    {path, kind, incident, targets: {name: payload}}."""
    path = os.path.abspath(path)
    inc = flightrec._read_json(os.path.join(path, "incident.json"))
    if inc is not None:
        targets: dict[str, dict] = {}
        for name in sorted(os.listdir(path)):
            sub = os.path.join(path, name)
            if os.path.isdir(sub):
                targets[name] = flightrec.bundle_payload(sub)
        return {"path": path, "kind": "incident", "incident": inc,
                "targets": targets}
    payload = flightrec.bundle_payload(path)
    if not payload:
        raise ValueError(f"{path}: not a bundle (no incident.json, "
                         f"no section files)")
    return {"path": path, "kind": "daemon", "incident": None,
            "targets": {"local": payload}}


# -- collection (shared with console /api/incident) ----------------------------


def assemble_incident(rows: list[tuple[str, dict | None]], out_root: str,
                      fingerprint: str = "", trigger: str = "manual",
                      alert: dict | None = None) -> dict:
    """Materialize one cross-daemon incident directory from per-target
    `/debug/bundle?collect=1` responses. Unreachable targets (None or a
    non-bundle response) are LISTED, never fatal — a partial incident
    still explains most of the failure. Returns the incident record
    (also written as incident.json)."""
    ts = time.time()
    name = f"{flightrec._slug(fingerprint or trigger)}-{int(ts)}"
    inc_dir = os.path.join(out_root, name)
    collected, missed = [], []
    targets: dict[str, dict] = {}
    for addr, out in rows:
        payload = (out or {}).get("payload")
        if not isinstance(payload, dict):
            missed.append(addr)
            continue
        tslug = flightrec._slug(addr)
        flightrec.write_payload(os.path.join(inc_dir, tslug), payload)
        targets[tslug] = payload
        collected.append(addr)
        if alert is None and payload.get("alert"):
            alert = payload["alert"]
    incident = {"dir": inc_dir, "name": name, "ts": ts,
                "fingerprint": fingerprint, "trigger": trigger,
                "alert": alert or None,
                "targets": collected, "unreachable": missed,
                "correlation": correlate(targets, alert, ts)}
    os.makedirs(inc_dir, exist_ok=True)
    flightrec._write_json(os.path.join(inc_dir, "incident.json"), incident)
    return incident


def _parse_slowop_ts(s: str) -> float | None:
    try:
        return time.mktime(time.strptime(s, SLOWOP_TS_FMT))
    except (ValueError, TypeError, OverflowError):
        return None


def correlate(targets: dict[str, dict], alert: dict | None,
              capture_ts: float) -> dict:
    """Cause→evidence join: the firing alert's rule and window, the
    in-window slowops' trace ids, and the timeline events those trace ids
    (or the window) implicate."""
    since = (alert or {}).get("since") or capture_ts
    start, end = since - WINDOW_LOOKBACK_S, capture_ts + 1.0
    slowops, trace_ids = [], []
    for tname, payload in targets.items():
        for rec in (payload.get("slowops") or {}).get("slowops", []):
            ts = _parse_slowop_ts(rec.get("ts", ""))
            if ts is None or not start <= ts <= end:
                continue
            slowops.append({"target": tname, **rec})
            tid = rec.get("trace_id")
            if tid and tid not in trace_ids:
                trace_ids.append(tid)
    slowops.sort(key=lambda r: -float(r.get("latency_ms", 0.0)))
    events = []
    for tname, payload in targets.items():
        for ev in (payload.get("events") or {}).get("events", []):
            ts = ev.get("ts", 0.0)
            in_window = isinstance(ts, (int, float)) and start <= ts <= end
            if in_window or ev.get("trace_id") in trace_ids:
                events.append({"target": tname, **ev})
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"rule": (alert or {}).get("name", ""),
            "window": {"start": start, "end": end},
            "slowops": slowops[:50], "trace_ids": trace_ids[:50],
            "events": events[-200:]}


# -- summary (the inspect view) ------------------------------------------------


def burn_families(snaps: list[dict], top: int = 10) -> list[dict]:
    """Top-moving monotonic families across the frozen snapshot window —
    first vs last, restart-clamped, histogram children collapsed onto
    their family (via _count; _bucket/_sum would double-count)."""
    from chubaofs_tpu_torch.utils.metrichist import family_of, is_monotonic

    if len(snaps) < 2:
        return []
    first, last = snaps[0], snaps[-1]
    span = max(1e-9, (last.get("mono") or last.get("ts", 0.0))
               - (first.get("mono") or first.get("ts", 0.0)))
    types = last.get("types", {})
    fams: dict[str, float] = {}
    for key, a in last.get("metrics", {}).items():
        if not is_monotonic(key, types):
            continue
        fam, sfx = family_of(key)
        if sfx in ("_bucket", "_sum"):
            continue
        d = a - first.get("metrics", {}).get(key, 0.0)
        if d < 0:
            d = a  # restart contract: post-restart total IS the delta
        fams[fam] = fams.get(fam, 0.0) + d
    rows = [{"family": f, "delta": round(d, 3),
             "rate": round(d / span, 3)}
            for f, d in fams.items() if d > 0]
    rows.sort(key=lambda r: -r["rate"])
    return rows[:top]


def summarize(bundle: dict) -> dict:
    """One incident summary from a read_bundle() result: alert → window →
    top burn-rate families → slowest spans → in-window slowops → hot
    profile buckets."""
    targets = bundle["targets"]
    inc = bundle.get("incident") or {}
    alert = inc.get("alert")
    capture_ts = inc.get("ts", 0.0)
    if alert is None:
        for payload in targets.values():
            if payload.get("alert"):
                alert = payload["alert"]
                break
    if not capture_ts:
        for payload in targets.values():
            capture_ts = max(capture_ts,
                             (payload.get("meta") or {}).get("ts", 0.0))
    corr = inc.get("correlation") or correlate(targets, alert,
                                               capture_ts or time.time())

    burns = []
    for tname, payload in targets.items():
        snaps = (payload.get("metrics") or {}).get("snapshots", [])
        for row in burn_families(snaps, top=5):
            burns.append({"target": tname, **row})
    burns.sort(key=lambda r: -r["rate"])

    spans = []
    for tname, payload in targets.items():
        for rec in (payload.get("traces") or {}).get("records", []):
            spans.append({"target": tname, "op": rec.get("op", "?"),
                          "dur_us": rec.get("dur_us", 0),
                          "trace_id": rec.get("trace_id", "")})
    spans.sort(key=lambda s: -float(s.get("dur_us") or 0))

    # the autopilot decision log frozen per target: name every
    # action the controller took (or damped/refused) inside the evidence
    # window, keyed by the causal alert fingerprint
    w = corr.get("window") or {}
    w_start, w_end = w.get("start", 0.0), w.get("end", float("inf"))
    autopilot = []
    for tname, payload in targets.items():
        ap = payload.get("autopilot") or {}
        for rec in ap.get("decisions") or []:
            ts = rec.get("ts", 0.0)
            if isinstance(ts, (int, float)) and w_start <= ts <= w_end:
                autopilot.append({"target": tname, **rec})
    autopilot.sort(key=lambda r: r.get("ts", 0.0))

    profile: dict[str, int] = {}
    coverage = []
    for payload in targets.values():
        prof = payload.get("profile") or {}
        for bucket, n in (prof.get("threads") or {}).items():
            profile[bucket] = profile.get(bucket, 0) + int(n)
        if prof.get("samples"):
            coverage.append(prof.get("coverage", 0.0))
    hot = sorted(profile.items(), key=lambda kv: -kv[1])[:10]

    return {"path": bundle["path"], "kind": bundle["kind"],
            "targets": sorted(targets),
            "unreachable": inc.get("unreachable", []),
            "fingerprint": inc.get("fingerprint")
            or next((p.get("meta", {}).get("fingerprint", "")
                     for p in targets.values()), ""),
            "alert": alert, "window": corr.get("window", {}),
            "burn_families": burns[:10],
            "slow_spans": spans[:10],
            "slowops": corr.get("slowops", [])[:10],
            "trace_ids": corr.get("trace_ids", []),
            "autopilot_actions": autopilot[-20:],
            "profile_hot": [{"bucket": b, "samples": n} for b, n in hot],
            "profile_coverage": round(sum(coverage) / len(coverage), 4)
            if coverage else 0.0}


def _fmt_ts(ts: float) -> str:
    if not ts:
        return "-"
    return time.strftime(SLOWOP_TS_FMT, time.localtime(ts))


def render_summary(s: dict, out) -> None:
    print(f"INCIDENT {s['path']}", file=out)
    print(f"  kind={s['kind']}  targets={len(s['targets'])}"
          + (f"  unreachable={','.join(s['unreachable'])}"
             if s["unreachable"] else ""), file=out)
    a = s.get("alert")
    if a:
        print(f"  alert: {a.get('name', '?')} [{a.get('severity', '?')}] "
              f"value={a.get('value')}  since={_fmt_ts(a.get('since', 0))}"
              f"  {a.get('description', '')}", file=out)
    elif s.get("fingerprint"):
        print(f"  fingerprint: {s['fingerprint']}", file=out)
    w = s.get("window") or {}
    if w:
        print(f"  window: {_fmt_ts(w.get('start', 0))} .. "
              f"{_fmt_ts(w.get('end', 0))}", file=out)
    if s["burn_families"]:
        print("  top burn-rate families:", file=out)
        for r in s["burn_families"]:
            print(f"    {r['family']:<44} {r['rate']:>10g}/s  "
                  f"(+{r['delta']:g} @{r['target']})", file=out)
    if s["slow_spans"]:
        print("  slowest spans:", file=out)
        for r in s["slow_spans"]:
            print(f"    {r['op']:<32} {r['dur_us'] / 1000.0:>9.1f}ms  "
                  f"trace={r['trace_id']}  @{r['target']}", file=out)
    if s["slowops"]:
        print(f"  in-window slowops ({len(s['trace_ids'])} traces):",
              file=out)
        for r in s["slowops"]:
            print(f"    {r.get('ts', '-')}  {r.get('module', '?')}."
                  f"{r.get('op', '?')}  {float(r.get('latency_ms', 0)):.1f}ms"
                  f"  trace={r.get('trace_id', '-')}  @{r['target']}",
                  file=out)
    if s.get("autopilot_actions"):
        print("  autopilot actions in window:", file=out)
        for r in s["autopilot_actions"]:
            print(f"    {_fmt_ts(r.get('ts', 0))}  "
                  f"{r.get('decision', '?'):<12} "
                  f"{r.get('actuator') or '-':<24} "
                  f"{r.get('fingerprint', '')}  @{r['target']}", file=out)
    if s["profile_hot"]:
        print(f"  hot profile buckets "
              f"(coverage {s['profile_coverage']:.0%}):", file=out)
        for r in s["profile_hot"]:
            print(f"    {r['bucket']:<32} {r['samples']:>8} samples",
                  file=out)


# -- diff ----------------------------------------------------------------------


def _merged_last_metrics(bundle: dict) -> tuple[dict, dict, float]:
    """(metrics, types, ts) from every target's newest frozen snapshot —
    keys prefixed with the target so two roles can't collide."""
    metrics: dict[str, float] = {}
    types: dict[str, str] = {}
    ts = 0.0
    for tname, payload in bundle["targets"].items():
        snaps = (payload.get("metrics") or {}).get("snapshots", [])
        if not snaps:
            continue
        last = snaps[-1]
        ts = max(ts, last.get("ts", 0.0))
        for k, v in last.get("metrics", {}).items():
            metrics[f"{tname}:{k}"] = v
        for fam, kind in last.get("types", {}).items():
            types[f"{tname}:{fam}"] = kind
    return metrics, types, ts


def diff_bundles(old: dict, new: dict) -> dict:
    """What moved between two bundles: metric deltas (restart-clamped via
    the shared cfs-stat differ), alert-state changes, event-count deltas
    by type."""
    from chubaofs_tpu_torch.tools.cfsstat import diff_metrics

    m0, _t0, ts0 = _merged_last_metrics(old)
    m1, t1, ts1 = _merged_last_metrics(new)
    interval = max(0.0, ts1 - ts0)
    rows = [r for r in diff_metrics(m0, m1, interval, types=t1)
            if r["delta"] != 0]
    rows.sort(key=lambda r: -abs(r["delta"]))

    def alert_names(b):
        out = set()
        a = (b.get("incident") or {}).get("alert")
        if a:
            out.add(a.get("name", "?"))
        for p in b["targets"].values():
            if p.get("alert"):
                out.add(p["alert"].get("name", "?"))
        return out

    def event_counts(b):
        out: dict[str, int] = {}
        for p in b["targets"].values():
            for ev in (p.get("events") or {}).get("events", []):
                t = ev.get("type", "?")
                out[t] = out.get(t, 0) + 1
        return out

    e0, e1 = event_counts(old), event_counts(new)
    return {"interval_s": round(interval, 1),
            "metrics": rows[:40],
            "alerts": {"old": sorted(alert_names(old)),
                       "new": sorted(alert_names(new))},
            "events": {t: e1.get(t, 0) - e0.get(t, 0)
                       for t in sorted(set(e0) | set(e1))
                       if e1.get(t, 0) != e0.get(t, 0)}}


# -- CLI -----------------------------------------------------------------------


def _get_json(addr: str, path: str, timeout: float = 30.0) -> dict:
    from chubaofs_tpu_torch.tools.cfsstat import scrape

    return json.loads(scrape(addr, path, timeout=timeout))


def _cmd_collect(args, out) -> int:
    import urllib.parse

    q = "?fingerprint=" + urllib.parse.quote(args.fingerprint or "") \
        + "&trigger=" + urllib.parse.quote(args.trigger)
    if args.console:
        incident = _get_json(args.console, "/api/incident" + q)
        if incident.get("error"):
            print(f"error: {incident['error']}", file=sys.stderr)
            return 1
    else:
        rows = []
        for addr in args.addr:
            try:
                rows.append((addr, _get_json(
                    addr, "/debug/bundle?collect=1" + q.replace("?", "&"))))
            except Exception:
                rows.append((addr, None))
        out_root = args.out or os.path.join(flightrec.flight_dir(),
                                            "incidents")
        incident = assemble_incident(rows, out_root,
                                     fingerprint=args.fingerprint or "",
                                     trigger=args.trigger)
    if args.json:
        print(json.dumps(incident, indent=2, default=str), file=out)
        return 0
    print(f"collected: {incident['dir']}", file=out)
    if incident.get("unreachable"):
        print(f"unreachable: {', '.join(incident['unreachable'])}",
              file=out)
    if not incident.get("targets"):
        print("error: no target answered /debug/bundle "
              "(is CFS_FLIGHT set on the daemons?)", file=sys.stderr)
        return 1
    render_summary(summarize(read_bundle(incident["dir"])), out)
    return 0


def _cmd_list(args, out) -> int:
    root = args.dir or flightrec.flight_dir()
    rec = flightrec.FlightRecorder(root)
    rows = [b for b in rec.list_bundles()
            if os.path.exists(os.path.join(b["path"], "manifest.json"))]
    inc_root = os.path.join(root, "incidents")
    incidents = []
    if os.path.isdir(inc_root):
        for name in sorted(os.listdir(inc_root)):
            inc = flightrec._read_json(
                os.path.join(inc_root, name, "incident.json"))
            if inc is not None:
                incidents.append(inc)
    if args.json:
        print(json.dumps({"dir": root, "bundles": rows,
                          "incidents": incidents}, indent=2), file=out)
        return 0
    if not rows and not incidents:
        print(f"(no bundles under {root})", file=out)
        return 0
    for b in rows:
        print(f"bundle    {_fmt_ts(b['ts'])}  {b['trigger']:<8} "
              f"{b['fingerprint'] or '-':<32} {b['bytes']:>8}B  {b['path']}",
              file=out)
    for inc in incidents:
        print(f"incident  {_fmt_ts(inc.get('ts', 0))}  "
              f"{inc.get('trigger', '?'):<8} "
              f"{inc.get('fingerprint') or '-':<32} "
              f"targets={len(inc.get('targets', []))}  {inc['dir']}",
              file=out)
    return 0


def _cmd_inspect(args, out) -> int:
    try:
        s = summarize(read_bundle(args.bundle))
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(s, indent=2, default=str), file=out)
    else:
        render_summary(s, out)
    return 0


def _cmd_diff(args, out) -> int:
    try:
        d = diff_bundles(read_bundle(args.old), read_bundle(args.new))
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(d, indent=2), file=out)
        return 0
    print(f"DIFF {args.old} -> {args.new}  ({d['interval_s']}s apart)",
          file=out)
    if d["alerts"]["old"] != d["alerts"]["new"]:
        print(f"  alerts: {d['alerts']['old']} -> {d['alerts']['new']}",
              file=out)
    for t, delta in d["events"].items():
        print(f"  events {t:<24} {delta:+d}", file=out)
    for r in d["metrics"]:
        tag = "  (restart)" if r.get("restart") else ""
        print(f"  {r['metric']:<64} {r['delta']:>+12g}{tag}", file=out)
    if not d["metrics"]:
        print("  (no metric moved)", file=out)
    return 0


def main(argv=None, out=None) -> int:
    import argparse

    out = out or sys.stdout
    p = argparse.ArgumentParser(
        prog="cfs-doctor",
        description="collect / inspect / diff incident bundles")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("collect", help="capture an incident now")
    c.add_argument("--console", help="console host:port (/api/incident)")
    c.add_argument("--addr", action="append", default=[],
                   help="daemon host:port to fan out to directly "
                        "(repeatable; alternative to --console)")
    c.add_argument("--fingerprint", default="",
                   help="alert fingerprint to key the incident by")
    c.add_argument("--trigger", default="manual")
    c.add_argument("--out", help="incident root (default: flight dir)")
    c.add_argument("--json", action="store_true")

    ls = sub.add_parser("list", help="bundles + incidents on disk")
    ls.add_argument("--dir", help="bundle root (default: CFS_FLIGHT_DIR)")
    ls.add_argument("--json", action="store_true")

    i = sub.add_parser("inspect", help="render one bundle's summary")
    i.add_argument("bundle")
    i.add_argument("--json", action="store_true")

    d = sub.add_parser("diff", help="what moved between two bundles")
    d.add_argument("old")
    d.add_argument("new")
    d.add_argument("--json", action="store_true")

    args = p.parse_args(argv)
    if args.cmd == "collect":
        if not args.console and not args.addr:
            print("error: need --console or at least one --addr",
                  file=sys.stderr)
            return 2
        return _cmd_collect(args, out)
    if args.cmd == "list":
        return _cmd_list(args, out)
    if args.cmd == "inspect":
        return _cmd_inspect(args, out)
    return _cmd_diff(args, out)


if __name__ == "__main__":
    sys.exit(main())
