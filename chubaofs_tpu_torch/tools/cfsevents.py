"""cfs-events — the merged cluster event timeline + alert view.

The forensics companion to cfs-top: where the dashboard shows the cluster's
state NOW, this shows what CHANGED — every daemon's event journal (disk
transitions, repair leases, tier migrations, raft elections, backpressure
flips, SLO flips, chaos injections, alert lifecycle) merged into one
wall-clock-ordered timeline via the console's `/api/events` rollup
(cursor-paged; `--addr` polls daemons' `/events` side-doors directly).

    cfs-events --console 127.0.0.1:8500 --since 600
    cfs-events --console C --type disk_status,task_finished --follow
    cfs-events --console C --alerts
    cfs-events --console C --correlate 8f3a...   # events ⋈ trace spans
    cfs-events --console C --correlate 'slo_failing|slo=put_p99'

`--correlate <trace-id>` joins the timeline against the trace sink: events
carrying that trace id and the trace's spans (console `/api/trace`, or each
daemon's `/traces`) interleave into one causally-ordered view — the
injected-fault → detection → repair-lease → rebuild-finished chain the
chaos kill soak asserts on, readable by a human.

`--correlate <alert-fingerprint>` instead joins the alert lifecycle against
the autopilot's decision log: the alert_firing edge, every `autopilot_*`
decision stamped with that causal fingerprint, and the alert_resolved edge,
each line carrying its wall-time delta from the firing edge — the auditable
cause→action→resolution chain (an argument that matches no alert falls
back to the trace join, so one flag serves both).

`--follow` keeps polling with the rollup cursor, printing only new events
(tail -f for the cluster). Unreachable targets print as warnings, never
silently vanish.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.parse

SEVERITY_MARK = {"info": " ", "warning": "W", "critical": "C"}


# -- fetching ------------------------------------------------------------------


def _get_json(addr: str, path: str, timeout: float = 5.0) -> dict:
    from chubaofs_tpu_torch.tools.cfsstat import scrape

    return json.loads(scrape(addr, path, timeout=timeout))


def _fanout_json(addrs: list[str], path_of, timeout: float) -> list[tuple]:
    """[(addr, json-or-None)] fetched CONCURRENTLY — dead daemons cost one
    timeout, not one per corpse (the console rollup discipline; this is
    the ONE fan-out both the console /api/* rollups and the CLI's direct
    --addr mode ride, so the two surfaces cannot drift)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(addr: str):
        try:
            return _get_json(addr, path_of(addr), timeout=timeout)
        except Exception:
            return None

    with ThreadPoolExecutor(max_workers=min(8, len(addrs) or 1)) as pool:
        return list(zip(addrs, pool.map(one, addrs)))


def fetch_events(console: str | None, addrs: list[str],
                 cursor: dict | None = None, n: int = 500,
                 types: str = "", severity: str = "",
                 timeout: float = 5.0) -> tuple[list[dict], dict, list[str]]:
    """One timeline page: (events tagged with target, next cursor map,
    unreachable targets). Console mode rides /api/events; --addr mode (also
    the implementation BEHIND /api/events) polls each target's /events —
    newest page when no cursor is held for it, exact oldest-first
    pagination once one is."""
    cursor = dict(cursor or {})
    extra = ""
    if types:
        extra += f"&type={urllib.parse.quote(types)}"
    if severity:
        extra += f"&severity={urllib.parse.quote(severity)}"
    if console:
        q = f"/api/events?n={n}{extra}"
        if cursor:
            q += f"&cursor={urllib.parse.quote(json.dumps(cursor))}"
        out = _get_json(console, q, timeout=timeout)
        return (out.get("events", []), out.get("cursor", cursor),
                out.get("unreachable", []))

    def path_of(addr: str) -> str:
        since = f"since={cursor[addr]}&" if addr in cursor else ""
        return f"/events?{since}n={n}{extra}"

    merged: list[dict] = []
    missed: list[str] = []
    for addr, out in _fanout_json(addrs, path_of, timeout):
        if out is None:
            missed.append(addr)  # cursor stays put: nothing is skipped
            continue
        cursor[addr] = int(out.get("cursor", cursor.get(addr, 0)))
        merged.extend({**rec, "target": addr}
                      for rec in out.get("events", ()))
    merged.sort(key=lambda e: e.get("ts", 0.0))
    return merged, cursor, missed


def fetch_alerts(console: str | None, addrs: list[str],
                 timeout: float = 5.0) -> dict:
    """The merged alert view (also the implementation behind /api/alerts):
    per-target rows + the cluster firing total, corpses marked."""
    if console:
        return _get_json(console, "/api/alerts", timeout=timeout)
    rows, missed = [], []
    total = 0
    for addr, out in _fanout_json(addrs, lambda a: "/alerts", timeout):
        if out is None or "alerts" not in out:
            missed.append(addr)
            rows.append({"target": addr, "unreachable": True, "alerts": [],
                         "firing": 0})
            continue
        rows.append({"target": addr, "alerts": out.get("alerts", []),
                     "firing": out.get("firing", 0)})
        total += int(out.get("firing", 0))
    return {"targets": rows, "firing": total, "unreachable": missed}


def fetch_spans(console: str | None, addrs: list[str],
                trace_id: str, timeout: float = 5.0) -> list[dict]:
    tid = urllib.parse.quote(trace_id)
    if console:
        out = _get_json(console, f"/api/trace?id={tid}", timeout=timeout)
        return out.get("spans", [])
    spans: dict[str, dict] = {}
    for addr in addrs:
        try:
            out = _get_json(addr, f"/traces?id={tid}", timeout=timeout)
        except Exception:
            continue
        for rec in out.get("spans", ()):
            if rec.get("span_id"):
                spans.setdefault(rec["span_id"], rec)
    return sorted(spans.values(), key=lambda r: r.get("start", 0.0))


# -- rendering -----------------------------------------------------------------


def fmt_event(e: dict) -> str:
    ts = time.strftime("%H:%M:%S", time.localtime(e.get("ts", 0.0)))
    ms = int((e.get("ts", 0.0) % 1) * 1000)
    who = e.get("role") or e.get("target") or "-"
    detail = " ".join(f"{k}={v}" for k, v in (e.get("detail") or {}).items())
    tid = f" trace={e['trace_id'][:12]}" if e.get("trace_id") else ""
    return (f"{ts}.{ms:03d} [{SEVERITY_MARK.get(e.get('severity'), '?')}] "
            f"{who:<12} {e.get('type', '?'):<18} {e.get('entity', ''):<18} "
            f"{detail}{tid}")


def render_alerts(roll: dict) -> str:
    lines = [f"firing: {roll.get('firing', 0)}"]
    for row in roll.get("targets", []):
        tag = " UNREACHABLE" if row.get("unreachable") else ""
        lines.append(f"{row['target']}{tag}:")
        for a in row.get("alerts", []):
            labels = "".join(f" {k}={v}"
                             for k, v in (a.get("labels") or {}).items())
            since = time.strftime("%H:%M:%S",
                                  time.localtime(a.get("since") or 0))
            sil = " (silenced)" if a.get("silenced") else ""
            lines.append(f"  [{a.get('state', '?'):>8}] {a['name']}{labels} "
                         f"value={a.get('value')} since={since}{sil}")
        if not row.get("alerts"):
            lines.append("  (no alerts)")
    for addr in roll.get("unreachable", []):
        lines.append(f"! {addr}: unreachable")
    return "\n".join(lines)


def event_fingerprint(e: dict) -> str | None:
    """The alert fingerprint an event belongs to, or None: autopilot_*
    decisions carry it verbatim in detail.fingerprint (the causal stamp);
    alert_firing/alert_resolved reconstruct it from entity + labels —
    the same fingerprint() the alert manager dedupes by."""
    from chubaofs_tpu_torch.utils.alerts import fingerprint

    d = e.get("detail") or {}
    if str(e.get("type", "")).startswith("autopilot_"):
        return str(d.get("fingerprint", "")) or None
    if e.get("type") in ("alert_firing", "alert_resolved"):
        return fingerprint(e.get("entity", ""), d.get("labels"))
    return None


def correlate_alert_chain(events: list[dict], fp: str) -> list[dict]:
    """The cause→action→resolution join: every alert_firing /
    autopilot_* / alert_resolved event belonging to one alert fingerprint,
    wall-ordered, each stamped with the delta since the chain's most
    recent firing edge — so `fired +0.0s → executed +2.1s → resolved
    +9.8s` reads straight down. Empty when the fingerprint matched no
    alert lifecycle (the caller falls back to the trace-span join)."""
    chain = [e for e in events if event_fingerprint(e) == fp]
    chain.sort(key=lambda e: e.get("ts", 0.0))
    items: list[dict] = []
    t_fire: float | None = None
    for e in chain:
        if e.get("type") == "alert_firing":
            t_fire = e.get("ts", 0.0)
        dt = None if t_fire is None \
            else round(e.get("ts", 0.0) - t_fire, 3)
        kind = "alert" if str(e.get("type", "")).startswith("alert_") \
            else "action"
        mark = "cause    " if e.get("type") == "alert_firing" \
            else (f"+{dt:.3f}s" if dt is not None else "?        ")
        items.append({"t": e.get("ts", 0.0), "kind": kind, "dt": dt,
                      "record": e, "line": f"{mark:>10}  {fmt_event(e)}"})
    return items


def correlate(events: list[dict], spans: list[dict],
              trace_id: str) -> list[dict]:
    """The join: events carrying the trace id + the trace's spans, merged
    into one wall-ordered item list ({'t', 'kind', 'line'})."""
    items: list[dict] = []
    for e in events:
        if e.get("trace_id") != trace_id:
            continue
        items.append({"t": e.get("ts", 0.0), "kind": "event",
                      "record": e, "line": fmt_event(e)})
    for s in spans:
        start = s.get("start", 0.0)
        dur_ms = s.get("dur_us", 0) / 1e3
        ts = time.strftime("%H:%M:%S", time.localtime(start))
        items.append({
            "t": start, "kind": "span", "record": s,
            "line": f"{ts}.{int((start % 1) * 1000):03d} [span] "
                    f"{s.get('op', '?'):<32} {dur_ms:.2f}ms"})
    items.sort(key=lambda i: i["t"])
    return items


# -- offline bundle mode ------------------------------------------------------
#
# Postmortems outlive clusters: --bundle points every view this CLI renders
# at a collected flight-recorder bundle (one daemon's dir or a console-
# assembled incident dir) instead of live side-doors.


def bundle_events(bundle: dict, types: str = "",
                  severity: str = "") -> list[dict]:
    tset = {t for t in types.split(",") if t}
    sset = {s for s in severity.split(",") if s}
    evs = []
    for payload in bundle["targets"].values():
        for e in (payload.get("events") or {}).get("events", []):
            if tset and e.get("type") not in tset:
                continue
            if sset and e.get("severity") not in sset:
                continue
            evs.append(e)
    evs.sort(key=lambda e: e.get("ts", 0.0))
    return evs


def bundle_alerts(bundle: dict) -> dict:
    """The frozen alert view in the merged-rollup shape render_alerts
    expects: each target's triggering alert (bundles freeze the CAUSE, not
    the whole /alerts table)."""
    rows, firing = [], 0
    for tname, payload in sorted(bundle["targets"].items()):
        a = payload.get("alert") or {}
        alist = [a] if a.get("name") else []
        firing += sum(1 for x in alist if x.get("state") == "firing")
        rows.append({"target": tname, "alerts": alist,
                     "firing": sum(1 for x in alist
                                   if x.get("state") == "firing")})
    inc = bundle.get("incident") or {}
    return {"targets": rows, "firing": firing,
            "unreachable": inc.get("unreachable", [])}


def bundle_spans(bundle: dict, trace_id: str) -> list[dict]:
    spans: dict[str, dict] = {}
    for payload in bundle["targets"].values():
        for rec in (payload.get("traces") or {}).get("records", []):
            if rec.get("trace_id") == trace_id and rec.get("span_id"):
                spans.setdefault(rec["span_id"], rec)
    return sorted(spans.values(), key=lambda r: r.get("start", 0.0))


# -- CLI -----------------------------------------------------------------------


def main(argv=None, out=None) -> int:
    import argparse

    out = out or sys.stdout
    p = argparse.ArgumentParser(
        prog="cfs-events",
        description="merged cluster event timeline + alerts")
    p.add_argument("--console", default=None,
                   help="console address (uses /api/events + /api/alerts)")
    p.add_argument("--addr", action="append", default=[],
                   help="poll a daemon directly (repeatable; skips console)")
    p.add_argument("--since", type=float, default=0.0,
                   help="only events newer than SINCE seconds ago")
    p.add_argument("--type", default="",
                   help="comma-separated event types to keep")
    p.add_argument("--severity", default="",
                   help="comma-separated severities to keep "
                        "(info,warning,critical)")
    p.add_argument("--n", type=int, default=500,
                   help="page size per target")
    p.add_argument("--follow", action="store_true",
                   help="keep polling and print only new events (^C stops)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--follow poll period (s)")
    p.add_argument("--alerts", action="store_true",
                   help="show the merged alert view instead of the timeline")
    p.add_argument("--correlate", default="", metavar="TRACE_ID|ALERT_FP",
                   help="join events against this trace's spans, or — given "
                        "an alert fingerprint — print its cause→action→"
                        "resolution chain with wall-time deltas")
    p.add_argument("--bundle", default="",
                   help="read from a collected flight-recorder bundle dir "
                        "instead of live side-doors (postmortem mode)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    if not args.console and not args.addr and not args.bundle:
        p.error("give --console, --addr, or --bundle")

    bundle = None
    if args.bundle:
        if args.follow:
            p.error("--follow needs a live cluster, not --bundle")
        from chubaofs_tpu_torch.tools.cfsdoctor import read_bundle

        try:
            bundle = read_bundle(args.bundle)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    if args.alerts:
        roll = (bundle_alerts(bundle) if bundle is not None
                else fetch_alerts(args.console, args.addr))
        print(json.dumps(roll, indent=2) if args.json
              else render_alerts(roll), file=out)
        return 0

    if bundle is not None:
        events, cursor, missed = (
            bundle_events(bundle, types=args.type, severity=args.severity),
            0, (bundle.get("incident") or {}).get("unreachable", []))
    else:
        events, cursor, missed = fetch_events(
            args.console, args.addr, n=args.n, types=args.type,
            severity=args.severity)
    if args.since > 0:
        # event records carry WALL stamps (the cross-daemon merge key), so
        # the --since floor is wall arithmetic by protocol
        floor = time.time() - args.since  # wallclock: event ts are cross-process wall stamps
        events = [e for e in events if e.get("ts", 0.0) >= floor]

    if args.correlate:
        # an alert fingerprint takes precedence over a trace id: when the
        # argument names an alert lifecycle in the window, render the
        # cause→action→resolution chain; otherwise it is a
        # trace id and the events ⋈ spans join applies
        chain = correlate_alert_chain(events, args.correlate)
        if chain:
            if args.json:
                print(json.dumps({"fingerprint": args.correlate,
                                  "items": chain},
                                 default=str, indent=2), file=out)
            else:
                acts = sum(1 for i in chain if i["kind"] == "action")
                resolved = any(
                    i["record"].get("type") == "alert_resolved"
                    for i in chain)
                print(f"alert {args.correlate}: {len(chain)} items "
                      f"({acts} autopilot action(s), "
                      f"{'resolved' if resolved else 'still firing'})",
                      file=out)
                for item in chain:
                    print(item["line"], file=out)
            return 0
        spans = (bundle_spans(bundle, args.correlate)
                 if bundle is not None
                 else fetch_spans(args.console, args.addr, args.correlate))
        items = correlate(events, spans, args.correlate)
        if args.json:
            print(json.dumps({"trace_id": args.correlate, "items": items},
                             default=str, indent=2), file=out)
        else:
            print(f"trace {args.correlate}: {len(items)} items "
                  f"({sum(1 for i in items if i['kind'] == 'event')} events, "
                  f"{sum(1 for i in items if i['kind'] == 'span')} spans)",
                  file=out)
            for item in items:
                print(item["line"], file=out)
        return 0

    def show(evs: list[dict], missed_now: list[str]):
        if args.json:
            print(json.dumps({"events": evs, "unreachable": missed_now},
                             indent=2), file=out)
        else:
            for e in evs:
                print(fmt_event(e), file=out)
            for addr in missed_now:
                print(f"! {addr}: unreachable", file=out)

    show(events, missed)
    if not args.follow:
        return 0
    try:
        while True:
            time.sleep(max(0.1, args.interval))
            events, cursor, missed = fetch_events(
                args.console, args.addr, cursor=cursor, n=args.n,
                types=args.type, severity=args.severity)
            if events or missed:
                show(events, missed)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
