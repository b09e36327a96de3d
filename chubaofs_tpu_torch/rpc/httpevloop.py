"""HTTP/1.1 serving core on the evloop shard/worker machinery.

Reference counterpart: the reference object gateway multiplexes thousands of
keep-alive S3 connections on Go's netpoller; our HTTP daemons (objectnode,
masters, console, the access gateway) rode a thread-per-request
ThreadingHTTPServer, while the packet-TCP evloop stays flat at 1024 clients
where threads collapse ~9x. This module closes that gap: the SAME acceptor/shard/worker core (rpc/evloop.py)
serving HTTP/1.1 instead of binary packets.

  * `HttpFramer` is a GREEDY framer (evloop's variable-length read mode):
    the shard recvs into a fixed scratch buffer and hands the framer
    whatever arrived; it accumulates header bytes into a BOUNDED block
    (`MAX_HEADER_BYTES` — one hostile megabyte header line can never
    balloon memory) and, once `Content-Length` is known and bounds-checked
    against the packet layer's `MAX_DATA_LEN` precedent, preallocates
    exactly the body it was promised. An absurd Content-Length is rejected
    BEFORE any allocation (413), an oversized header block at the bound
    (431) — both answered with a real HTTP error response, then the
    connection closes.
  * Keep-alive with PIPELINED in-order responses falls out of the evloop's
    per-connection serial dispatch invariant: one recv can complete several
    requests; they dispatch one at a time on the worker pool and reply in
    arrival order, exactly like the packet path's write bursts.
  * Write-queue + inbox backpressure are inherited unchanged: a slow-reading
    client (or a flood ahead of a slow handler) crossing the high-water mark
    pauses THAT connection's reads only.
  * `Connection: close` (and HTTP/1.0 without keep-alive) rides the evloop's
    close-after-flush path: the reply fully drains, then the conn tears down.

`CFS_EVLOOP_HTTP=0` restores the threaded ThreadingHTTPServer path in
rpc/server.py for A/B and rollback — the same escape-hatch contract as
CFS_EVLOOP on the packet servers.

The face's own time for PUT requests (`registry("evloop")`, label
`method="PUT"`; the methods no reader reads are not counted), from
`time.perf_counter()` stamps the framer and the worker take where they
already run: `http_recv_seconds_total` (the request's first byte read to
its body complete), `http_queue_seconds_total` (complete to a worker
starting the handler), `http_handler_seconds_total` (the handler's wall),
`http_send_seconds_total` (the reply handed back to the evloop to the
direct send that put it whole on the wire) and `http_requests_total`. A
reply that has to queue for the shard's flush is not counted: a PUT's
small reply leaves whole. The threaded fallback keeps none of them.

Not implemented (the daemons' HTTP dialect never uses them, matching the
threaded path's Content-Length-only body reads): chunked transfer encoding
(501), obs-fold header continuations (400), interim 100-continue responses
(the body is read and the final status answers; no client of ours waits).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from http.client import responses as _REASONS

from chubaofs_tpu_torch.proto.packet import MAX_DATA_LEN
from chubaofs_tpu_torch.rpc.evloop import EvloopServer

# bound on the request line + header block, the MAX_DATA_LEN precedent for
# the header side: large enough for any signed S3 request (sigv4 auth +
# amz headers are well under 8 KiB), small enough that a hostile client
# can't park memory on the server before auth even runs
MAX_HEADER_BYTES = 32 << 10
# request bodies share the packet layer's receive bound
MAX_BODY_BYTES = MAX_DATA_LEN
# scratch recv buffer per connection (the greedy framer's `need()`)
_SCRATCH = 64 << 10
# the methods whose face time is counted (module docstring)
TIMED_METHODS = frozenset({"PUT"})


def http_evloop_enabled() -> bool:
    """The CFS_EVLOOP_HTTP escape hatch: default ON, =0 restores the
    threaded ThreadingHTTPServer path (checked at server construction, so
    one process can A/B both)."""
    return os.environ.get("CFS_EVLOOP_HTTP", "1").lower() \
        not in ("0", "false", "off")


class HttpRequest:
    """One parsed request, the framer's message unit. `err` carries a
    prepared error reply for framing violations (oversized header, absurd
    Content-Length): the dispatcher answers it without touching the router
    and the connection closes."""

    __slots__ = ("method", "target", "headers", "body", "remote", "close",
                 "err", "t_first", "t_read")

    def __init__(self, method: str = "", target: str = "",
                 headers: dict | None = None, body: bytes = b"",
                 remote: str = "-", close: bool = False, err=None):
        self.method = method
        self.target = target
        self.headers = headers or {}
        self.body = body
        self.remote = remote
        self.close = close
        self.err = err  # (status, reason-body) tuple for framing errors
        # perf_counter stamps: the request's first byte read, its body complete
        self.t_first = 0.0
        self.t_read = 0.0


class HttpReply:
    """What dispatch returns to the evloop: encode_reply() turns it into a
    header-bytes + body iovec (partial sends resume via packet.advance_iov
    in the shared shard flush)."""

    __slots__ = ("status", "headers", "body", "head_only", "close", "timing")

    def __init__(self, status: int, headers: dict, body: bytes,
                 head_only: bool = False, close: bool = False):
        self.status = status
        self.headers = headers
        self.body = body
        self.head_only = head_only
        self.close = close
        # (method, first byte, body complete, handler start, handler end) of
        # the request it answers; None where it is not counted
        self.timing = None


def encode_reply(reply: HttpReply) -> list:
    """HttpReply -> iovec. The status line + headers serialize into ONE
    bytes object; the body rides as its own element (no join of a multi-MiB
    GET payload into the header buffer)."""
    reason = _REASONS.get(reply.status, "Unknown")
    lines = [f"HTTP/1.1 {reply.status} {reason}"]
    has_cl = False
    for k, v in reply.headers.items():
        if k.lower() == "content-length":
            has_cl = True  # a handler-set Content-Length wins (HEAD
            # responses describe the body they didn't send)
        lines.append(f"{k}: {v}")
    if not has_cl:
        lines.append(f"Content-Length: {len(reply.body)}")
    if reply.close:
        lines.append("Connection: close")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    if reply.head_only or not reply.body:
        return [head]
    return [head, reply.body]


class HttpFramer:
    """Incremental HTTP/1.1 request framer — the evloop's greedy-mode read
    state machine. Contract (rpc/evloop.py consumes it): `greedy` marks the
    variable-length mode, `need()` sizes the scratch buffer once, and
    `feed_chunk(view)` consumes whatever the recv produced, returning
    [(HttpRequest, wire_bytes), ...] for every request the chunk completed
    (pipelining surfaces several). Framing violations come back as
    HttpRequest.err messages — the server answers a real HTTP error before
    the connection closes — after which the framer is dead and discards
    input."""

    greedy = True

    def __init__(self):
        self._buf = bytearray()      # bounded unparsed-bytes accumulator
        self._scan = 0               # \r\n\r\n search resume offset
        self._body: bytearray | None = None
        self._body_got = 0
        self._head_bytes = 0         # wire size of the current head
        self._msg: HttpRequest | None = None
        self._dead = False
        self._remote = "-"
        self._t_first: float | None = None  # current request's first byte

    def on_connect(self, sock: socket.socket) -> None:
        try:
            self._remote = sock.getpeername()[0]
        except (OSError, IndexError):
            self._remote = "-"

    def need(self) -> int:
        return _SCRATCH

    # -- chunk consumption -----------------------------------------------------

    def feed_chunk(self, data) -> list:
        """One recv's worth in, every completed request out. Head bytes
        accumulate in the bounded `_buf`; body bytes copy straight from the
        chunk into the preallocated body buffer (over-read head remainders
        drain from `_buf` first), so `_buf` never holds more than one header
        block plus one scratch chunk."""
        out: list = []
        mv = memoryview(data)
        while not self._dead:
            if self._msg is not None:
                # body phase: leftover head over-read first, then the chunk
                need = len(self._body) - self._body_got
                if self._buf:
                    take = min(need, len(self._buf))
                    self._body[self._body_got:self._body_got + take] = \
                        self._buf[:take]
                    del self._buf[:take]
                elif len(mv):
                    take = min(need, len(mv))
                    self._body[self._body_got:self._body_got + take] = \
                        mv[:take]
                    mv = mv[take:]
                else:
                    break
                self._body_got += take
                if self._body_got == len(self._body):
                    msg, self._msg = self._msg, None
                    msg.body = bytes(self._body)
                    self._stamp(msg)
                    out.append((msg, self._head_bytes + self._body_got))
                    self._body, self._body_got = None, 0
                continue
            # head phase: everything unparsed lives in _buf
            if self._t_first is None and (self._buf or len(mv)):
                self._t_first = time.perf_counter()
            idx = self._buf.find(b"\r\n\r\n", self._scan)
            if idx >= 0:
                head = bytes(self._buf[:idx])
                del self._buf[:idx + 4]
                self._head_bytes = idx + 4
                self._scan = 0
                self._parse_head(head, out)
                continue  # error sets _dead; else body/next-head follows
            # resume the terminator scan where this pass left off (minus
            # the 3 bytes a split \r\n\r\n could straddle) — no rescans
            self._scan = max(0, len(self._buf) - 3)
            if len(self._buf) > MAX_HEADER_BYTES:
                # bounded accumulation: the block never grew past the limit
                # plus one scratch chunk — reject, don't balloon
                self._error(out, 431, "request header block too large")
                break
            if not len(mv):
                break
            take = min(len(mv), MAX_HEADER_BYTES + 1 - len(self._buf))
            self._buf += mv[:take]
            mv = mv[take:]
        return out

    def _stamp(self, msg: HttpRequest) -> None:
        """The request is complete: its first byte's stamp and now."""
        msg.t_first = self._t_first
        msg.t_read = time.perf_counter()
        self._t_first = None

    def _error(self, out: list, status: int, detail: str) -> None:
        out.append((HttpRequest(remote=self._remote, close=True,
                                err=(status, detail)),
                    len(self._buf) + self._body_got))
        self._dead = True

    def _parse_head(self, head: bytes, out: list) -> bool:
        try:
            text = head.decode("latin-1")
        except UnicodeDecodeError:  # latin-1 can't fail, but stay defensive
            self._error(out, 400, "undecodable header block")
            return False
        lines = text.split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            self._error(out, 400, "malformed request line")
            return False
        method, target, version = parts
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            if line[0] in (" ", "\t"):  # obs-fold continuation: rejected
                self._error(out, 400, "folded header line")
                return False
            k, sep, v = line.partition(":")
            if not sep:
                self._error(out, 400, "malformed header line")
                return False
            headers[k.strip().lower()] = v.strip()
        if "transfer-encoding" in headers:
            self._error(out, 501, "transfer-encoding not supported")
            return False
        cl_raw = headers.get("content-length", "0")
        try:
            cl = int(cl_raw)
        except ValueError:
            self._error(out, 400, f"bad content-length {cl_raw!r}")
            return False
        if cl < 0:
            self._error(out, 400, f"bad content-length {cl_raw!r}")
            return False
        if cl > MAX_BODY_BYTES:
            # the hostile-header rule: bounds-checked BEFORE any allocation
            self._error(out, 413, f"content-length {cl} exceeds "
                                  f"{MAX_BODY_BYTES}")
            return False
        conn_toks = {t.strip().lower()
                     for t in headers.get("connection", "").split(",")}
        close = "close" in conn_toks or (
            version == "HTTP/1.0" and "keep-alive" not in conn_toks)
        msg = HttpRequest(method=method, target=target, headers=headers,
                          remote=self._remote, close=close)
        if cl == 0:
            self._stamp(msg)
            out.append((msg, self._head_bytes))
            return True
        self._msg = msg
        self._body = bytearray(cl)
        self._body_got = 0
        return True


def _count_sent(reply: HttpReply) -> None:
    """The evloop's on_sent: the reply is whole on the wire, so its
    request's four intervals go to the face's counters (module docstring)."""
    if reply.timing is None:
        return
    from chubaofs_tpu_torch.utils.exporter import registry

    method, t_first, t_read, t_start, t_end = reply.timing
    t_sent = time.perf_counter()
    reg = registry("evloop")
    reg.counter("http_recv_seconds_total", {"method": method}).add(t_read - t_first)
    reg.counter("http_queue_seconds_total", {"method": method}).add(t_start - t_read)
    reg.counter("http_handler_seconds_total", {"method": method}).add(t_end - t_start)
    reg.counter("http_send_seconds_total", {"method": method}).add(t_sent - t_end)
    reg.counter("http_requests_total", {"method": method}).add()


class HttpEvloopCore:
    """The evloop-backed HTTP server an RPCServer rides: owns the listener
    (SO_REUSEADDR so a restart rebinds the same port immediately — the graceful-
    reload bug class), wraps a `dispatch(Request) -> Response` callable, and
    carries the threaded path's stop contract: stop accepting, DRAIN
    in-flight handlers (bounded), let queued replies flush, then hard-close
    every lingering keep-alive socket so a pooled client sees EOF and
    reconnects fresh instead of being served by a stopped stack."""

    def __init__(self, dispatch, host: str = "127.0.0.1", port: int = 0,
                 name: str = "rpc"):
        from chubaofs_tpu_torch.rpc.router import parse_request

        self._parse_request = parse_request
        self._dispatch = dispatch
        self._inflight = 0
        self._drain = threading.Condition()
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((host, port))
        listener.listen(512)
        self.listener = listener
        self.port = listener.getsockname()[1]
        self.addr = f"{host}:{self.port}"
        self.core = EvloopServer(
            listener, self._on_message, name=f"http-{name}",
            framer_factory=HttpFramer, encode=encode_reply,
            close_reply=lambda reply: reply.close, on_sent=_count_sent)

    def start(self) -> "HttpEvloopCore":
        self.core.start()
        return self

    def _on_message(self, msg: HttpRequest) -> HttpReply:
        if msg.err is not None:
            import json

            status, detail = msg.err
            return HttpReply(status, {"Content-Type": "application/json"},
                             json.dumps({"error": detail}).encode(),
                             close=True)
        t_start = time.perf_counter()
        req = self._parse_request(msg.method, msg.target, msg.headers,
                                  msg.body, remote=msg.remote)
        with self._drain:
            self._inflight += 1
        try:
            resp = self._dispatch(req)
        finally:
            with self._drain:
                self._inflight -= 1
                self._drain.notify_all()
        method = msg.method.upper()
        reply = HttpReply(resp.status, resp.headers, resp.body,
                          head_only=(method == "HEAD"), close=msg.close)
        if method in TIMED_METHODS:
            reply.timing = (method, msg.t_first, msg.t_read, t_start,
                            time.perf_counter())
        return reply

    def _pending_write_bytes(self) -> int:
        total = 0
        for shard in self.core.shards:
            try:
                total += sum(c.wq_bytes for c in list(shard.conns.values()))
            except RuntimeError:
                return 1  # dict changed mid-iteration: something is pending
        return total

    def stop(self, drain_timeout: float = 10.0) -> None:
        # shutdown() BEFORE close(): a close alone doesn't interrupt the
        # acceptor thread blocked in accept(), and the kernel keeps the
        # LISTEN socket (and the port) alive until that syscall returns —
        # the restart-rebind would then fail with EADDRINUSE. shutdown pops
        # the blocked accept with an error; the acceptor exits on it.
        try:
            self.listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.listener.close()
        except OSError:
            pass
        deadline = time.monotonic() + drain_timeout
        with self._drain:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break  # wedged handler: don't hold the restart hostage
                self._drain.wait(remaining)
        # in-flight handlers finished; their replies may still sit on write
        # queues (the threaded path wrote synchronously inside the drained
        # handler) — give the shards a bounded window to flush before the
        # teardown hard-close discards them
        flush_deadline = time.monotonic() + min(2.0, drain_timeout)
        while self._pending_write_bytes() > 0 \
                and time.monotonic() < flush_deadline:
            time.sleep(0.01)
        self.core.stop()  # hard-closes every lingering keep-alive conn
