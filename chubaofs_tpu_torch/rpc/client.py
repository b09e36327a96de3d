"""Retrying HTTP client (blobstore/common/rpc client + api/* typed clients).

Reference counterpart: common/rpc's LbClient — round-robin over hosts with
retry-on-5xx/conn-error, JSON bodies, crc-body headers, and error
re-hydration into typed codes (api/access/client.go:248 builds on it). Kept:
host rotation, bounded retries with backoff, HTTPError re-hydration, optional
auth signing and body crc. Transport rides the keep-alive connection pool
(rpc/pool.py) — the packet-TCP path's pooling discipline applied to the HTTP
hops — so a request stream to one host reuses one warm socket instead of
paying a TCP connect per request.
"""

from __future__ import annotations

import http.client
import itertools
import time
import zlib

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.blobstore import trace
from chubaofs_tpu_torch.rpc import pool as rpc_pool
from chubaofs_tpu_torch.rpc.errors import HTTPError
from chubaofs_tpu_torch.rpc.server import AUTH_HEADER, CRC_HEADER, sign_path

_CONN_ERRORS = (ConnectionError, OSError, http.client.HTTPException)


class RPCClient:
    def __init__(self, hosts: list[str], retries: int = 3, timeout: float = 30.0,
                 auth_secret: bytes | None = None, backoff: float = 0.05,
                 pool=None, pooled: bool = True):
        self.hosts = list(hosts)
        self.retries = retries
        self.timeout = timeout
        self.auth_secret = auth_secret
        self.backoff = backoff
        # the client is shared across pool workers: host rotation must not
        # lose/duplicate slots under concurrent do() — count() is atomic
        self._rr = itertools.count()
        # pool=None -> the process-wide default; pooled=False -> a private
        # connect-per-request NullPool (A/B control, socket-averse callers)
        self._pool = pool if pool is not None else (
            None if pooled else rpc_pool.NullPool(timeout=timeout))

    @property
    def pool(self):
        return self._pool if self._pool is not None else rpc_pool.default_pool()

    def _next_host(self) -> str:
        return self.hosts[next(self._rr) % len(self.hosts)]

    def do(self, method: str, path: str, body: bytes = b"",
           headers: dict | None = None, crc: bool = False) -> tuple[int, dict, bytes]:
        hdrs = dict(headers or {})
        if self.auth_secret is not None:
            # sign the DECODED path: the server router hands middleware the
            # percent-decoded form, so both ends must hash the same bytes
            import urllib.parse

            plain = urllib.parse.unquote(path.split("?", 1)[0])
            hdrs[AUTH_HEADER] = sign_path(self.auth_secret, plain)
        if crc and body:
            hdrs[CRC_HEADER] = str(zlib.crc32(body) & 0xFFFFFFFF)
        # cross-hop tracing: the caller's trace + span ids ride the request
        # headers (the span id is the server span's cross-process parent);
        # the server's track log rides back on the response and folds into
        # the same span (blobstore/common/trace's header carrier)
        span = trace.current_span()
        if span is not None:
            hdrs.setdefault(trace.TRACE_ID_KEY, span.trace_id)
            hdrs.setdefault(trace.SPAN_ID_KEY, span.span_id)
        last: Exception | None = None
        for attempt in range(self.retries):
            host = self._next_host()
            try:
                # FailpointError IS a ConnectionError: an injected fault takes
                # the real retry/rotate path below, no special handling
                chaos.failpoint("rpc.client.do")
                status, headers_out, data = self._roundtrip(
                    host, method, path, body, hdrs)
                # every served hop's track log folds in here — for a 5xx
                # that means BEFORE the retry, or the failed hop vanishes
                # from the trace
                if span is not None:
                    span.merge_track(headers_out.get(trace.TRACK_LOG_KEY))
                if status < 500:
                    return status, headers_out, data
                last = HTTPError.from_body(status, data)
            except _CONN_ERRORS as e:
                last = e
            if attempt + 1 < self.retries:
                # no sleep after the FINAL attempt: a terminal failure must
                # raise now, not pay backoff*retries of pointless latency
                time.sleep(self.backoff * (attempt + 1))
        raise last if last else HTTPError(503, msg="no hosts")

    # methods safe to resend when a reused conn dies mid-flight: the server
    # may have executed the request before dropping the line, so the free
    # replay is limited to READ-ONLY methods (stricter than HTTP idempotency
    # — this framework's PUT /put allocates fresh bids per call); mutating
    # methods on a stale conn surface to the counted retry loop, whose
    # resend-on-conn-error semantics predate the pool
    _REPLAYABLE = frozenset({"GET", "HEAD", "OPTIONS"})

    def _roundtrip(self, host: str, method: str, path: str, body: bytes,
                   hdrs: dict) -> tuple[int, dict, bytes]:
        """One request over a pooled connection. A REUSED keep-alive socket
        that fails before yielding a response is a stale parked conn (the
        server tore it down while idle): evict it and try the next one —
        draining to a fresh connect — without consuming a retry attempt.
        Fresh-connection failures propagate to the real retry loop."""
        pool = self.pool
        span = trace.current_span()
        while True:
            t_pool = time.perf_counter()
            conn, reused = pool.checkout(host, timeout=self.timeout)
            if span is not None:
                # named stages for the critical-path analyzer: connection
                # checkout (reuse hit or TCP connect) vs time on the wire
                span.add_stage("rpc.pool", start=t_pool)
            t_wire = time.perf_counter()
            try:
                conn.request(method, path, body=body or None, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
            except _CONN_ERRORS as e:
                # a timeout is a SLOW server, not a stale socket: no free
                # replay (it would stack full timeout waits inside one
                # counted attempt) and no flushing of the host's warm pool
                is_timeout = isinstance(e, TimeoutError)
                # half-sent/half-read state is never re-parked
                pool.checkin(host, conn, ok=False,
                             reason="stale" if reused and not is_timeout
                             else "error")
                if not reused:
                    raise
                if not is_timeout:
                    # one stale parked conn means its OLDER siblings to the
                    # same (restarted) server are dead too: flush them, so
                    # whatever comes next — free replay or counted retry —
                    # connects fresh instead of burning the retry budget
                    # one corpse at a time
                    pool.flush_host(host)
                if method not in self._REPLAYABLE or is_timeout:
                    raise
                continue
            if span is not None:
                span.add_stage("rpc.wire", start=t_wire)
            headers_out = dict(resp.getheaders())
            # body fully read above: the conn is reusable unless the server
            # asked to close (will_close covers Connection: close and EOF-
            # delimited bodies)
            pool.checkin(host, conn, ok=not resp.will_close,
                         reason="server_close")
            return resp.status, headers_out, data

    def request_json(self, method: str, path: str, obj=None, **kw):
        import json

        body = json.dumps(obj).encode() if obj is not None else b""
        status, headers, data = self.do(method, path, body, **kw)
        if status >= 400:
            raise HTTPError.from_body(status, data)
        return json.loads(data.decode() or "null")

    def get(self, path: str, **kw):
        return self.request_json("GET", path, **kw)

    def post(self, path: str, obj=None, **kw):
        return self.request_json("POST", path, obj, **kw)
