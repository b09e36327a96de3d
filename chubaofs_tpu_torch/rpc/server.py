"""Threaded HTTP server bound to a Router, plus standard middleware.

Reference counterpart: common/rpc's server glue + middleware stack — auditlog
middleware (common/rpc/auditlog), shared-secret auth middleware
(common/rpc/auth: an HMAC of the request path with a cluster secret rides a
header), and crc-protected request bodies (clients send a crc32 header; the
server verifies before dispatch). The profile mux (common/profile: /metrics +
/debug endpoints always mounted) appears here as the default routes.
"""

from __future__ import annotations

import hashlib
import hmac
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.rpc.httpevloop import HttpEvloopCore, http_evloop_enabled
from chubaofs_tpu_torch.rpc.router import Request, Response, Router, parse_request

AUTH_HEADER = "blob-auth"
CRC_HEADER = "x-crc-body"


def auth_middleware(secret: bytes):
    """common/rpc/auth analog: HMAC-SHA1(path) must ride AUTH_HEADER."""

    def mw(req: Request, nxt):
        want = hmac.new(secret, req.path.encode(), hashlib.sha1).hexdigest()
        if not hmac.compare_digest(req.header(AUTH_HEADER), want):
            return Response(403, {}, b'{"error":"auth mismatch"}')
        return nxt(req)

    return mw


def sign_path(secret: bytes, path: str) -> str:
    return hmac.new(secret, path.encode(), hashlib.sha1).hexdigest()


def crc_middleware(req: Request, nxt):
    """Verify crc32 of the body when the client attached CRC_HEADER."""
    want = req.header(CRC_HEADER)
    if want:
        try:
            expected = int(want)
        except ValueError:
            return Response(400, {}, b'{"error":"bad crc header","code":"CrcMismatch"}')
        if expected != (zlib.crc32(req.body) & 0xFFFFFFFF):
            return Response(400, {}, b'{"error":"body crc mismatch","code":"CrcMismatch"}')
    return nxt(req)


def audit_middleware(audit):
    """common/rpc/auditlog analog over utils.auditlog.AuditLog."""

    def mw(req: Request, nxt):
        t0 = time.perf_counter()
        resp = nxt(req)
        audit.log_http(req.method, req.path, resp.status,
                       int((time.perf_counter() - t0) * 1e6), req.remote,
                       len(req.body), len(resp.body))
        return resp

    return mw


def dispatch_request(router: Router, module: str, req: Request) -> Response:
    """ONE request through the router with the serving-model-independent
    plumbing both backends share: the `rpc.server.handle` failpoint (an
    error here = the handler died before replying, the client sees a
    dropped connection), trace-span continuation, and the Trace-* reply
    headers for traced callers. The evloop HTTP core and the threaded
    fallback both call exactly this — the serving model is the ONLY
    variable between them."""
    chaos.failpoint("rpc.server.handle")
    # continue (or root) the request's trace: handlers see the span via
    # trace.current_span(); its track log rides back on the response
    # headers for the caller to fold in
    from chubaofs_tpu_torch.blobstore import trace

    # Trace-* response headers only when the REQUEST carried a trace id
    # (same guard as the packet carriers): untraced callers — every plain
    # S3 client, every scraper — pay zero extra reply bytes; the span
    # still exists for handlers' current_span() use
    traced = trace.extract_trace_id(req.headers) is not None
    span = trace.start_span(f"{module or 'rpc'}:{req.path}",
                            carrier=req.headers)
    trace.push_span(span)
    t0 = time.perf_counter()
    try:
        resp = router.dispatch(req)
    finally:
        span.append_track_log(module or "rpc", start=t0)
        span.finish()
        trace.pop_span()
    if traced:
        if span.track:
            resp.headers.setdefault(trace.TRACK_LOG_KEY,
                                    span.track_log_string())
        resp.headers.setdefault(trace.TRACE_ID_KEY, span.trace_id)
    return resp


class RPCServer:
    """HTTP server hosting one Router; /metrics mounted by default.

    Serving model: by default the evloop HTTP core
    (rpc/httpevloop.py) — acceptor + loop shards + bounded worker pool, the
    same machinery the packet servers ride, so thousands of keep-alive
    connections cost registered sockets instead of parked threads.
    `CFS_EVLOOP_HTTP=0` restores the ThreadingHTTPServer fallback for A/B
    and rollback; both backends dispatch through `dispatch_request`, so
    handlers, middleware, and the side-doors cannot tell them apart.

    /metrics renders the process's WHOLE registry set (the default registry
    plus every role registry — exporter.render_all), so any daemon role is
    scrapeable without its subsystems knowing about the server; an explicit
    `registry` argument is rendered first (legacy callers). A router that
    already mounted its own /metrics keeps it (registration order wins at
    equal rank). `module` names the daemon role in trace track-logs.
    `metrics=False` skips the mount — for PUBLIC-facing routers whose
    namespace the route would shadow (the objectnode S3 surface, where
    GET /metrics is a bucket listing and every route is auth-wrapped);
    such daemons expose a statsListen side-door instead.

    The same flag gates the trace/audit side-doors: `/traces?id=<trace-id>`
    and `/traces/recent` serve the process trace sink's span records, and
    `/slowops` the recent slow-op audit entries — so the console collector
    and `cfs-trace` can fetch one trace's spans from every daemon it
    crossed with nothing but the addresses `cfs-stat` already scrapes.
    `/debug/runtime` says which of the port's modules (and torch) the
    process has loaded and whether it holds a CUDA context.

    The health-plane side-doors ride the same mount: `/debug/prof` serves
    the sampling profiler (`?seconds=N` runs an on-demand capture; bare, it
    reports the CFS_PROF_HZ continuous profile), `/metrics/history` the
    bounded snapshot ring with server-side `?rate=1`, and `/health` the SLO
    evaluation (ok/degraded/failing + reasons) the console `/api/health`
    rollup and `cfs-top` poll."""

    def __init__(self, router: Router, host: str = "127.0.0.1", port: int = 0,
                 registry=None, module: str = "", metrics: bool = True):
        self.router = router
        self.module = module

        def metrics_route(r):
            from chubaofs_tpu_torch.utils import exporter

            text = (registry.render() if registry is not None else "")
            return Response(200, {"Content-Type": "text/plain"},
                            (text + exporter.render_all()).encode())

        def traces_route(r):
            from chubaofs_tpu_torch.utils import tracesink

            tid = r.q("id")
            if not tid:
                return Response(400, {"Content-Type": "application/json"},
                                b'{"error":"missing ?id=<trace-id>"}')
            return Response.json(
                {"trace_id": tid,
                 "spans": tracesink.default_sink().records(tid)})

        def traces_recent_route(r):
            from chubaofs_tpu_torch.utils import tracesink

            snk = tracesink.default_sink()
            return Response.json({"spans": snk.recent_records(r.q_int("n", 200)),
                                  "traces": snk.recent_traces()})

        def slowops_route(r):
            from chubaofs_tpu_torch.utils.auditlog import recent_slowops

            return Response.json({"slowops": recent_slowops(r.q_int("n", 100))})

        def debug_prof_route(r):
            from chubaofs_tpu_torch.utils import profiler

            secs = r.q("seconds")
            if secs:
                try:
                    seconds = float(secs)
                except ValueError:
                    return Response.json(
                        {"error": f"bad ?seconds={secs!r}"}, status=400)
                try:
                    hz = float(r.q("hz") or 0) or None
                except ValueError:
                    hz = None
                prof = profiler.capture(seconds, hz=hz)
            else:
                cont = profiler.active()
                if cont is None:
                    return Response.json(
                        {"error": "continuous profiling disarmed "
                                  "(set CFS_PROF_HZ) — or pass ?seconds=N "
                                  "for an on-demand capture"}, status=400)
                prof = cont.profile
            if r.q("json"):
                return Response.json(prof.to_dict())
            return Response(200, {"Content-Type": "text/plain"},
                            (prof.collapsed() + "\n").encode())

        def metrics_history_route(r):
            from chubaofs_tpu_torch.utils import metrichist

            hist = metrichist.default_history()
            return Response.json(hist.query(n=r.q_int("n", 30),
                                            flt=r.q("filter"),
                                            rate=bool(r.q("rate"))))

        def health_route(r):
            from chubaofs_tpu_torch.utils import slo

            # always HTTP 200: the status FIELD is the verdict, and a 503
            # would make the console collector count a degraded-but-
            # answering daemon as unreachable
            return Response.json(slo.health_report())

        def events_route(r):
            from chubaofs_tpu_torch.utils import events

            types = tuple(t for t in (r.q("type") or "").split(",") if t)
            sevs = tuple(s for s in (r.q("severity") or "").split(",") if s)
            n = r.q_int("n", 200)
            j = events.default_journal()
            if r.has_q("since"):  # q_int clamps negatives: presence IS mode
                since = r.q_int("since", 0)
                # cursor-paged poller mode (the console rollup): oldest
                # first from the cursor, exactly-once delivery
                evs, cursor = j.query(since=since, n=n,
                                      types=types or None,
                                      severity=sevs or None)
            else:
                # one-shot mode (bare cfs-events, --correlate): the NEWEST
                # n matching events — a busy daemon's ring must not hide
                # fresh events behind its oldest page
                evs, cursor = events.recent_page(n, types or None,
                                                 sevs or None)
            return Response.json({"events": evs, "cursor": cursor})

        def alerts_route(r):
            from chubaofs_tpu_torch.utils import alerts

            return Response.json(alerts.alerts_report())

        def autopilot_route(r):
            from chubaofs_tpu_torch.autopilot import controller as ap_ctl

            op = r.q("op")
            if op:
                ap = ap_ctl.default_controller()
                if op == "enable":
                    ap.attach().set_enabled(True)
                    if not ap.armed:
                        ap.start(ap_ctl._env_f("CFS_AUTOPILOT_TICK_S", 5.0))
                elif op == "disable":
                    ap.set_enabled(False)
                elif op == "dry-run":
                    # arm in shadow mode (decisions logged, nothing runs);
                    # ?off=1 drops back to live actuation
                    ap.set_dry_run(not r.q("off"))
                    if not r.q("off"):
                        ap.attach().set_enabled(True)
                        if not ap.armed:
                            ap.start(
                                ap_ctl._env_f("CFS_AUTOPILOT_TICK_S", 5.0))
                else:
                    return Response.json(
                        {"error": f"unknown op {op!r} (enable | disable "
                                  "| dry-run)"}, status=400)
                return Response.json(ap.status())
            return Response.json(ap_ctl.autopilot_status())

        def debug_bundle_route(r):
            from chubaofs_tpu_torch.utils import flightrec

            if not flightrec.enabled():
                return Response.json(
                    {"error": "flight recorder disarmed (set CFS_FLIGHT=1) "
                              "— alert-triggered and on-demand incident "
                              "bundles are off"}, status=400)
            rec = flightrec.default_recorder()
            if r.q("collect"):
                man = rec.capture(trigger=r.q("trigger") or "http",
                                  fingerprint=r.q("fingerprint") or "")
                # the sections ride INLINE so a console can assemble the
                # cross-daemon incident dir centrally — each daemon keeps
                # its own per-process bundle root
                return Response.json(
                    {"manifest": man,
                     "payload": flightrec.bundle_payload(man["bundle"])})
            return Response.json({"dir": rec.root,
                                  "bundles": rec.list_bundles()})

        def debug_runtime_route(r):
            # what this process has loaded and whether it opened a CUDA
            # context; torch is looked up, never imported, so a host role
            # that has not imported it reads false without paying for it
            import os
            import sys

            torch = sys.modules.get("torch")
            return Response.json({
                "pid": os.getpid(),
                "modules": sorted(m for m in sys.modules
                                  if m == "torch"
                                  or m.startswith("chubaofs_tpu_torch.")),
                "cuda_initialized": bool(torch is not None
                                         and torch.cuda.is_initialized()),
            })

        if metrics:
            router.get("/metrics", metrics_route)
            router.get("/debug/runtime", debug_runtime_route)
            router.get("/traces", traces_route)
            router.get("/traces/recent", traces_recent_route)
            router.get("/slowops", slowops_route)
            router.get("/debug/prof", debug_prof_route)
            router.get("/metrics/history", metrics_history_route)
            router.get("/health", health_route)
            router.get("/events", events_route)
            router.get("/alerts", alerts_route)
            router.get("/autopilot", autopilot_route)
            router.get("/debug/bundle", debug_bundle_route)
            # env-armed sinks go live at daemon boot, not first scrape —
            # and stay the documented no-op when their env knob is unset
            from chubaofs_tpu_torch.autopilot import controller as _autopilot
            from chubaofs_tpu_torch.utils import alerts, flightrec, metrichist, \
                profiler, tracesink

            tracesink.activate_from_env()
            profiler.activate_from_env()
            metrichist.activate_from_env()
            alerts.activate_from_env()
            flightrec.activate_from_env()
            _autopilot.activate_from_env()

        outer = self
        self._inflight = 0
        self._drain = threading.Condition()
        self._conns: set = set()  # live connection sockets (keep-alive aware)
        self.httpd = None
        self._evcore = None
        self._thread: threading.Thread | None = None

        if http_evloop_enabled():
            # the evloop HTTP core: acceptor + loop shards + worker pool
            # (rpc/httpevloop.py); drain/stop parity is the core's contract
            self._evcore = HttpEvloopCore(
                lambda req: dispatch_request(self.router, self.module, req),
                host=host, port=port, name=module or "rpc")
            self.addr = self._evcore.addr
            self.port = self._evcore.port
        else:
            # threaded fallback (CFS_EVLOOP_HTTP=0): ThreadingHTTPServer,
            # one thread per live connection — the older model, kept
            # for A/B and rollback
            class Handler(BaseHTTPRequestHandler):
                protocol_version = "HTTP/1.1"

                def setup(self):
                    super().setup()
                    with outer._drain:
                        outer._conns.add(self.connection)

                def finish(self):
                    with outer._drain:
                        outer._conns.discard(self.connection)
                    super().finish()

                def log_message(self, *a):  # silence default stderr chatter
                    pass

                def _serve(self):
                    with outer._drain:
                        outer._inflight += 1
                    try:
                        self._serve_inner()
                    finally:
                        with outer._drain:
                            outer._inflight -= 1
                            outer._drain.notify_all()

                def _serve_inner(self):
                    length = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(length) if length else b""
                    req = parse_request(self.command, self.path,
                                        dict(self.headers.items()), body,
                                        remote=self.client_address[0])
                    resp = dispatch_request(outer.router, outer.module, req)
                    self.send_response(resp.status)
                    payload = b"" if self.command == "HEAD" else resp.body
                    for k, v in resp.headers.items():
                        self.send_header(k, v)
                    # a handler-set Content-Length wins (HEAD responses
                    # describe the body they didn't send)
                    if not any(k.lower() == "content-length"
                               for k in resp.headers):
                        self.send_header("Content-Length",
                                         str(len(resp.body)))
                    self.end_headers()
                    if payload:
                        self.wfile.write(payload)

                do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = _serve
                do_OPTIONS = _serve

            self.httpd = ThreadingHTTPServer((host, port), Handler)
            self.httpd.daemon_threads = True
            self.addr = f"{host}:{self.httpd.server_address[1]}"
            self.port = self.httpd.server_address[1]
        if metrics:
            # identity + boot stamp: every daemon
            # exports cfs_boot_time_seconds (wall, cross-process protocol —
            # scrapers derive UP and the restart cross-check from it) and a
            # role/version info gauge; the journal gets the role/addr stamp
            # and one daemon_boot timeline record
            import chubaofs_tpu_torch
            from chubaofs_tpu_torch.utils import events, exporter

            # cfs_boot_time_seconds + cfs_build_info{role,version}
            exporter.registry("boot").gauge("time_seconds").set(
                events.BOOT_TS)
            exporter.registry("build").gauge(
                "info", {"role": module or "rpc",
                         "version": chubaofs_tpu_torch.__version__}).set(1)
            events.configure(role=module or "rpc", addr=self.addr)
            events.emit("daemon_boot", entity=module or "rpc",
                        detail={"role": module or "rpc", "addr": self.addr,
                                "version": chubaofs_tpu_torch.__version__})

    def start(self):
        if self._evcore is not None:
            self._evcore.start()
            return self
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name=f"rpc@{self.addr}", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain_timeout: float = 10.0):
        """Stop accepting, then DRAIN: wait for in-flight handlers to finish
        (bounded) before returning — the graceful-restart contract the
        blobstore module reload depends on (blobstore/cmd/cmd.go analog).
        Both backends then hard-close lingering keep-alive sockets, so a
        reload can never leave old-stack handlers serving pooled clients
        and the port rebinds immediately."""
        if self._evcore is not None:
            self._evcore.stop(drain_timeout)
            return
        self.httpd.shutdown()
        self.httpd.server_close()
        deadline = time.monotonic() + drain_timeout
        with self._drain:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break  # wedged handler: don't hold the restart hostage
                self._drain.wait(remaining)
            conns = list(self._conns)
        # keep-alive connections OUTLIVE shutdown(): their handler threads sit
        # in readline() waiting for the next request, and a pooled client
        # would keep being served by THIS stopped stack (a reload would leave
        # requests landing on closed components). Hard-close them — parked
        # client conns see EOF and their pool evicts + reconnects fresh.
        import socket as _socket

        for c in conns:
            try:
                c.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._thread:
            self._thread.join(timeout=5)
