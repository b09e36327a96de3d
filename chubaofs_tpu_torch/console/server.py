"""Console — web dashboard over the master's GraphQL API.

Reference counterpart: console/ (console/server.go:110 — a small HTTP server
hosting a SPA plus a GraphQL proxy to the master; console/service/). Kept:
the same split — static dashboard at /, a /graphql proxy that forwards the
browser's queries to the master (following leader redirects via
MasterClient's transport), and JSON convenience endpoints the dashboard
polls. The SPA is a single inline page: tables for nodes, volumes and users,
refreshed from /api/overview.
"""

from __future__ import annotations

import json
import os

from chubaofs_tpu_torch.master.api_service import MasterClient
from chubaofs_tpu_torch.rpc.errors import HTTPError
from chubaofs_tpu_torch.rpc.router import Request, Response, Router
from chubaofs_tpu_torch.rpc.server import RPCServer

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>chubaofs-tpu console</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;background:#fafafa;color:#222}
 h1{font-size:1.4rem} h2{font-size:1.05rem;margin-top:1.5rem}
 table{border-collapse:collapse;min-width:40rem;background:#fff}
 th,td{border:1px solid #ddd;padding:.35rem .6rem;text-align:left;font-size:.9rem}
 th{background:#f0f0f0} .ok{color:#0a7d38} .warn{color:#b54708}
 #err{color:#b42318;margin:.5rem 0}
</style></head><body>
<h1>chubaofs-tpu console</h1>
<div id="err"></div>
<h2>Cluster</h2><div id="cluster"></div>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Volumes</h2><table id="volumes"></table>
<h2>Users</h2><table id="users"></table>
<script>
function esc(v){
  return String(v).replace(/[&<>"']/g,
    ch=>({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[ch]));
}
function row(cells, tag){
  return "<tr>"+cells.map(c=>"<"+tag+">"+c+"</"+tag+">").join("")+"</tr>";
}
async function refresh(){
  try{
    const r = await fetch("/api/overview"); const d = await r.json();
    document.getElementById("err").textContent = "";
    const cv = d.clusterView;
    document.getElementById("cluster").textContent =
      "leader: node "+cv.leaderID+" · volumes: "+cv.volumeCount+
      " · nodes: "+cv.nodes.length;
    const now = Date.now()/1000;
    document.getElementById("nodes").innerHTML =
      row(["id","kind","addr","partitions","alive"],"th")+
      cv.nodes.map(n=>row([esc(n.id),esc(n.kind),esc(n.addr),esc(n.partitions),
        (now-n.lastHeartbeat<10)?"<span class=ok>yes</span>"
                               :"<span class=warn>stale</span>"],"td")).join("");
    document.getElementById("volumes").innerHTML =
      row(["name","owner","tier","meta partitions","data partitions"],"th")+
      d.volumeList.map(v=>row([esc(v.name),esc(v.owner||"-"),
        v.cold?"cold(EC)":"hot",
        v.metaPartitions.length,v.dataPartitions.length],"td")).join("");
    document.getElementById("users").innerHTML =
      row(["user","type","access key","own volumes"],"th")+
      d.userList.map(u=>row([esc(u.userID),esc(u.userType),esc(u.accessKey),
        esc(u.ownVols.join(", ")||"-")],"td")).join("");
  }catch(e){ document.getElementById("err").textContent = "refresh failed: "+e; }
}
refresh(); setInterval(refresh, 3000);
</script></body></html>"""

OVERVIEW_QUERY = """{
  clusterView { leaderID volumeCount
    nodes { id kind addr partitions lastHeartbeat } }
  volumeList { name owner cold
    metaPartitions { partitionID } dataPartitions { partitionID } }
  userList { userID userType accessKey ownVols }
}"""


class Console:
    def __init__(self, master_addrs: list[str], host: str = "127.0.0.1",
                 port: int = 0, metrics_addrs: list[str] | None = None):
        """metrics_addrs: extra /metrics targets (metanode/datanode stats
        side-doors, blobstore gateway...) the /api/metrics rollup scrapes in
        addition to the masters."""
        self.mc = MasterClient(master_addrs)
        self.master_addrs = list(master_addrs)
        self.metrics_addrs = list(metrics_addrs or [])
        self.router = self._build()
        self.server = RPCServer(self.router, host=host, port=port,
                                module="console").start()
        self.addr = self.server.addr

    def _graphql(self, query: str, variables=None) -> dict:
        """Forward to any master replica — /graphql serves reads on followers
        too, and RPCClient already rotates hosts on connection failure. A 400
        carries the GraphQL errors array and is returned to the browser."""
        payload = json.dumps({"query": query,
                              "variables": variables or {}}).encode()
        status, _, body = self.mc.rpc.do(
            "POST", "/graphql", payload,
            headers={"Content-Type": "application/json"})
        if status not in (200, 400):
            raise HTTPError(status, msg=body.decode(errors="replace")[:200])
        return json.loads(body.decode() or "{}")

    def _build(self) -> Router:
        r = Router()
        r.get("/", lambda req: Response(
            200, {"Content-Type": "text/html; charset=utf-8"}, PAGE.encode()))

        def overview(req: Request):
            out = self._graphql(OVERVIEW_QUERY)
            if "errors" in out:
                return Response.json(out, status=502)
            return Response.json(out["data"])

        def graphql_proxy(req: Request):
            body = req.json() or {}
            return Response.json(self._graphql(body.get("query", ""),
                                               body.get("variables")))

        def scrape_one(addr: str) -> str:
            from chubaofs_tpu_torch.tools.cfsstat import scrape

            try:
                # cfsstat.scrape raises on non-200 too, so a misconfigured
                # target (main API port instead of the stats side-door)
                # lands in the UNREACHABLE marker rather than splicing an
                # error body into the exposition
                return f"# == target {addr} ==\n{scrape(addr, timeout=3)}"
            except Exception as e:
                # a bad address (no port), a non-HTTP port, a dead daemon:
                # mark THIS target, keep serving the others
                return f"# == target {addr} UNREACHABLE: {e} ==\n"

        def metrics_rollup(req: Request):
            """Scrape every known daemon's /metrics and concatenate, each
            section prefixed with its target — the one-stop cluster scrape
            (exporter rollup; the Consul-registration consumer's view).
            Targets are scraped CONCURRENTLY so dead daemons cost one
            timeout, not one per corpse."""
            from concurrent.futures import ThreadPoolExecutor

            targets = self.master_addrs + self.metrics_addrs
            with ThreadPoolExecutor(max_workers=min(8, len(targets) or 1)) as pool:
                sections = list(pool.map(scrape_one, targets))
            return Response(200, {"Content-Type": "text/plain"},
                            "".join(sections).encode())

        def fetch_json(addr: str, path: str) -> dict | None:
            from chubaofs_tpu_torch.tools.cfsstat import scrape

            try:
                return json.loads(scrape(addr, path, timeout=3))
            except Exception:
                return None  # dead/misconfigured target: skip, keep the rest

        def _fanout(path: str) -> list[tuple[str, dict | None]]:
            from concurrent.futures import ThreadPoolExecutor

            targets = self.master_addrs + self.metrics_addrs
            with ThreadPoolExecutor(max_workers=min(8, len(targets) or 1)) as pool:
                return list(zip(targets,
                                pool.map(lambda a: fetch_json(a, path),
                                         targets)))

        def trace_rollup(req: Request):
            """The collector: fetch one trace id's span records from EVERY
            known daemon's /traces side-door and reassemble them into one
            span set (deduped by span id) — the cross-process hop tree
            `cfs-trace` renders. Unreachable targets are reported, not
            fatal: a partial tree still explains most of the request."""
            tid = req.q("id")
            if not tid:
                return Response.json({"error": "missing ?id=<trace-id>"},
                                     status=400)
            import urllib.parse

            spans: dict[str, dict] = {}
            reached, missed = [], []
            # re-encode the id: a raw space/control char would make every
            # upstream request invalid and misreport the cluster as dark
            for addr, out in _fanout(f"/traces?id={urllib.parse.quote(tid)}"):
                if out is None:
                    missed.append(addr)
                    continue
                reached.append(addr)
                for rec in out.get("spans", ()):
                    if rec.get("span_id"):
                        spans.setdefault(rec["span_id"], rec)
            return Response.json(
                {"trace_id": tid, "targets": reached, "unreachable": missed,
                 "spans": sorted(spans.values(),
                                 key=lambda r: r.get("start", 0.0))})

        def health_rollup(req: Request):
            """The cluster health verdict: every known target's /health,
            rolled up worst-status-wins. An UNREACHABLE target is reported
            AS FAILING — a daemon that can't answer "are you healthy?" is
            the opposite of omittable, and silently dropping it would let a
            dead gateway render an all-green dashboard."""
            from chubaofs_tpu_torch.utils.slo import FAILING, OK, RANK

            targets, missed = [], []
            worst = OK
            for addr, out in _fanout("/health"):
                if out is None or "status" not in out:
                    missed.append(addr)
                    entry = {"target": addr, "status": FAILING,
                             "reasons": ["unreachable"], "slos": {}}
                else:
                    entry = {"target": addr, **out}
                targets.append(entry)
                if RANK.get(entry["status"], RANK[FAILING]) > RANK[worst]:
                    # an unknown status string counts as failing too: a
                    # half-broken daemon must not launder itself to ok
                    worst = (entry["status"]
                             if entry["status"] in RANK else FAILING)
            return Response.json({"status": worst, "targets": targets,
                                  "unreachable": missed})

        def events_rollup(req: Request):
            """The cluster timeline: every target's /events merged by wall
            stamp, CURSOR-PAGED — `?cursor=` carries the per-target seq map
            from the previous poll (JSON), so repeated polls see each event
            exactly once; a target with no cursor yet serves its NEWEST
            page. Unreachable targets are REPORTED, never dropped (their
            cursors stay put so nothing is skipped). The merge itself is
            cfsevents.fetch_events — ONE implementation behind this rollup
            and the CLI's direct --addr mode."""
            from chubaofs_tpu_torch.tools.cfsevents import fetch_events

            cursor: dict = {}
            raw = req.q("cursor")
            if raw:
                try:
                    cursor = {str(k): int(v)
                              for k, v in json.loads(raw).items()}
                except (ValueError, TypeError, AttributeError):
                    return Response.json(
                        {"error": "bad ?cursor= (JSON target->seq map)"},
                        status=400)
            merged, next_cursor, missed = fetch_events(
                None, self.master_addrs + self.metrics_addrs,
                cursor=cursor, n=req.q_int("n", 200),
                types=req.q("type"), severity=req.q("severity"),
                timeout=3.0)
            return Response.json({"events": merged, "cursor": next_cursor,
                                  "unreachable": missed})

        def alerts_rollup(req: Request):
            """Every target's /alerts merged: per-target alert lists plus
            the cluster firing total. An unreachable target is reported as
            such — an alert plane that can't answer is not 'no alerts'.
            Same shared implementation as `cfs-events --alerts --addr`."""
            from chubaofs_tpu_torch.tools.cfsevents import fetch_alerts

            return Response.json(fetch_alerts(
                None, self.master_addrs + self.metrics_addrs, timeout=3.0))

        def autopilot_rollup(req: Request):
            """Every target's /autopilot controller state, per-target rows
            plus the cluster action-budget totals — which daemon is armed,
            what it decided lately. Unreachable targets are reported, and
            a target answering `enabled: false` is a DISARMED row, not an
            error (most daemons never arm a controller)."""
            rows, missed = [], []
            remaining = per_hour = 0
            for addr, out in _fanout("/autopilot"):
                if out is None or "enabled" not in out:
                    missed.append(addr)
                    continue
                rows.append({"target": addr, **out})
                b = out.get("budget") or {}
                remaining += int(b.get("remaining", 0) or 0)
                per_hour += int(b.get("per_hour", 0) or 0)
            return Response.json(
                {"targets": rows, "unreachable": missed,
                 "enabled": any(r.get("enabled") for r in rows),
                 "budget": {"remaining": remaining, "per_hour": per_hour}})

        def slowops_rollup(req: Request):
            """Recent slow-op audit entries from every daemon, each tagged
            with its source target — what `cfs-stat --slowops` renders next
            to the metric diff."""
            entries = []
            missed = []
            for addr, out in _fanout("/slowops"):
                if out is None:
                    missed.append(addr)
                    continue
                for rec in out.get("slowops", ()):
                    entries.append({**rec, "target": addr})
            entries.sort(key=lambda e: e.get("ts", ""))
            return Response.json({"slowops": entries, "unreachable": missed})

        def incident_rollup(req: Request):
            """The incident collector: fan out to every known
            daemon's /debug/bundle?collect=1 side-door and assemble ONE
            cross-daemon incident directory keyed by the triggering alert
            fingerprint, with the cause→evidence correlation cfs-doctor
            renders. ?fingerprint=/&trigger= select the key; with neither,
            the first firing alert in the cluster rollup is the cause.
            Unreachable daemons are listed, never fatal."""
            import urllib.parse

            from chubaofs_tpu_torch.tools import cfsdoctor
            from chubaofs_tpu_torch.utils import alerts as alertsmod
            from chubaofs_tpu_torch.utils import flightrec

            fp = req.q("fingerprint") or ""
            trigger = req.q("trigger") or "console"
            alert = None
            if not fp:
                from chubaofs_tpu_torch.tools.cfsevents import fetch_alerts

                rollup = fetch_alerts(
                    None, self.master_addrs + self.metrics_addrs,
                    timeout=3.0)
                for row in rollup.get("targets", []):
                    for a in row.get("alerts", []):
                        if a.get("state") == "firing":
                            alert = a
                            fp = alertsmod.fingerprint(
                                a.get("name", ""), a.get("labels"))
                            break
                    if alert is not None:
                        break
            q = (f"/debug/bundle?collect=1"
                 f"&trigger={urllib.parse.quote(trigger)}"
                 f"&fingerprint={urllib.parse.quote(fp)}")
            rows = _fanout(q)
            out_root = os.path.join(flightrec.flight_dir(), "incidents")
            incident = cfsdoctor.assemble_incident(
                rows, out_root, fingerprint=fp, trigger=trigger,
                alert=alert)
            return Response.json(incident)

        r.get("/api/overview", overview)
        r.get("/api/metrics", metrics_rollup)
        r.get("/api/health", health_rollup)
        r.get("/api/trace", trace_rollup)
        r.get("/api/slowops", slowops_rollup)
        r.get("/api/events", events_rollup)
        r.get("/api/alerts", alerts_rollup)
        r.get("/api/autopilot", autopilot_rollup)
        r.get("/api/incident", incident_rollup)
        r.post("/graphql", graphql_proxy)
        return r

    def stop(self):
        self.server.stop()


def main(argv=None) -> int:
    import argparse
    import time

    p = argparse.ArgumentParser(prog="cfs-console")
    p.add_argument("--addr", action="append", required=True,
                   help="master address (repeatable)")
    p.add_argument("--listen", default="127.0.0.1:8500")
    args = p.parse_args(argv)
    host, port = args.listen.rsplit(":", 1)
    console = Console(args.addr, host=host, port=int(port))
    print(json.dumps({"console": console.addr}), flush=True)  # obslint: boot line IS the stdout protocol (harness parses it)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        console.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
