"""The cases of tests/test_httpevloop.py, run against the port.

HTTP-on-evloop serving core: framer edges, pipelining,
backpressure, stop parity, and the CFS_EVLOOP_HTTP=0 threaded fallback.

The framer battery drives HttpFramer directly (hostile inputs must be
rejected WITHOUT preallocation); the server tests drive a real RPCServer
over raw sockets and http.client so keep-alive, pipelining, and the
close-after-flush path are exercised on the wire.
"""

import http.client
import socket
import time

import pytest

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.rpc.httpevloop import (
    MAX_BODY_BYTES, MAX_HEADER_BYTES, HttpFramer, HttpReply, encode_reply,
    http_evloop_enabled)
from chubaofs_tpu_torch.rpc.router import Response, Router
from chubaofs_tpu_torch.rpc.server import RPCServer


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


def feed_all(framer, raw, step=None):
    out = []
    if step is None:
        out.extend(framer.feed_chunk(memoryview(raw)))
    else:
        for i in range(0, len(raw), step):
            out.extend(framer.feed_chunk(memoryview(raw[i:i + step])))
    return out


# -- framer battery ------------------------------------------------------------


def test_framer_simple_and_pipelined_order():
    raw = (b"GET /a HTTP/1.1\r\nHost: x\r\n\r\n"
           b"POST /b HTTP/1.1\r\nHost: x\r\nContent-Length: 3\r\n\r\nxyz"
           b"GET /c?q=1 HTTP/1.1\r\nHost: x\r\n\r\n")
    msgs = feed_all(HttpFramer(), raw)
    assert [(m.method, m.target) for m, _ in msgs] == [
        ("GET", "/a"), ("POST", "/b"), ("GET", "/c?q=1")]
    assert msgs[1][0].body == b"xyz"
    # wire accounting: byte-exact per message, so inbox backpressure sums
    assert sum(n for _, n in msgs) == len(raw)


@pytest.mark.parametrize("step", [1, 7])
def test_framer_resumes_across_arbitrary_chunk_splits(step):
    raw = (b"PUT /k HTTP/1.1\r\nHost: x\r\nContent-Length: 10\r\n\r\n"
           b"0123456789"
           b"GET /after HTTP/1.1\r\nHost: x\r\n\r\n")
    msgs = feed_all(HttpFramer(), raw, step=step)
    assert [(m.method, m.body) for m, _ in msgs] == [
        ("PUT", b"0123456789"), ("GET", b"")]


def test_framer_oversized_header_block_rejected_bounded():
    fr = HttpFramer()
    huge = b"GET / HTTP/1.1\r\nX-Pad: " + b"a" * (2 * MAX_HEADER_BYTES)
    msgs = feed_all(fr, huge, step=8192)
    assert len(msgs) == 1
    m, _ = msgs[0]
    assert m.err is not None and m.err[0] == 431
    assert m.close
    # bounded accumulation: the block never grew past the limit + one chunk
    assert len(fr._buf) <= MAX_HEADER_BYTES + 8192
    # dead framer discards further input instead of resurrecting
    assert feed_all(fr, b"GET / HTTP/1.1\r\n\r\n") == []


def test_framer_absurd_content_length_rejected_without_prealloc():
    fr = HttpFramer()
    raw = (f"PUT /x HTTP/1.1\r\nHost: x\r\n"
           f"Content-Length: {MAX_BODY_BYTES + 1}\r\n\r\n").encode()
    msgs = feed_all(fr, raw)
    assert msgs[0][0].err[0] == 413
    assert fr._body is None  # rejected BEFORE any body allocation
    # malformed / negative lengths are 400s, same no-alloc discipline
    for bad in (b"-5", b"zork"):
        fr = HttpFramer()
        msgs = feed_all(
            fr, b"PUT /x HTTP/1.1\r\nContent-Length: " + bad + b"\r\n\r\n")
        assert msgs[0][0].err[0] == 400
        assert fr._body is None


def test_framer_rejects_chunked_and_malformed_lines():
    msgs = feed_all(HttpFramer(),
                    b"PUT /x HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n")
    assert msgs[0][0].err[0] == 501
    msgs = feed_all(HttpFramer(), b"NONSENSE\r\n\r\n")
    assert msgs[0][0].err[0] == 400
    msgs = feed_all(HttpFramer(),
                    b"GET / HTTP/1.1\r\nFolded: a\r\n  b\r\n\r\n")
    assert msgs[0][0].err[0] == 400


def test_framer_connection_close_flavors():
    m = feed_all(HttpFramer(),
                 b"GET / HTTP/1.1\r\nConnection: close\r\n\r\n")[0][0]
    assert m.close
    m = feed_all(HttpFramer(), b"GET / HTTP/1.0\r\n\r\n")[0][0]
    assert m.close  # 1.0 default
    m = feed_all(HttpFramer(),
                 b"GET / HTTP/1.0\r\nConnection: keep-alive\r\n\r\n")[0][0]
    assert not m.close
    m = feed_all(HttpFramer(), b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")[0][0]
    assert not m.close  # 1.1 default keep-alive


def test_encode_reply_and_advance_iov_resume():
    from chubaofs_tpu_torch.proto.packet import advance_iov

    body = bytes(range(256)) * 64
    iov = encode_reply(HttpReply(200, {"X-A": "1"}, body))
    assert len(iov) == 2  # header bytes + body, never joined
    flat = b"".join(iov)
    assert flat.startswith(b"HTTP/1.1 200 OK\r\n")
    assert f"Content-Length: {len(body)}".encode() in iov[0]
    # the partial-send pointer-advance every write path shares: walking the
    # iovec in ragged steps must reproduce the exact byte stream
    views = [memoryview(b) for b in iov]
    got = b""
    for step in (3, 17, 100, 4096, 1 << 20):
        if not views:
            break
        take = min(step, sum(len(v) for v in views))
        got += b"".join(bytes(v) for v in advance_iov(
            [memoryview(flat[len(got):len(got) + take])], 0))
        views = advance_iov(views, take)
    assert got == flat[:len(got)]
    # handler-set Content-Length wins (the HEAD contract)
    iov = encode_reply(HttpReply(200, {"Content-Length": "999"}, b"",
                                 head_only=True))
    assert b"Content-Length: 999" in iov[0]
    assert len(iov) == 1


# -- live server ---------------------------------------------------------------


@pytest.fixture
def srv():
    r = Router()
    r.get("/ping", lambda req: Response(200, {}, b"pong"))
    r.post("/echo", lambda req: Response(200, {}, req.body))
    r.get("/big", lambda req: Response(200, {}, b"\xa7" * (256 << 10)))
    s = RPCServer(r, module="httptest").start()
    yield s
    s.stop()


def _recv_until_closed(sk):
    buf = b""
    sk.settimeout(10)
    while True:
        try:
            d = sk.recv(65536)
        except socket.timeout:
            break
        if not d:
            break
        buf += d
    return buf


def test_evloop_http_is_the_default_and_serves(srv):
    assert http_evloop_enabled()
    assert srv._evcore is not None  # riding loop shards, not threads
    host, port = srv.addr.rsplit(":", 1)
    c = http.client.HTTPConnection(host, int(port))
    c.request("GET", "/ping")
    assert c.getresponse().read() == b"pong"
    body = b"z" * 100_000
    c.request("POST", "/echo", body=body)  # same conn: keep-alive reuse
    assert c.getresponse().read() == body
    c.close()


def test_pipelined_keepalive_requests_answered_in_order(srv):
    host, port = srv.addr.rsplit(":", 1)
    sk = socket.create_connection((host, int(port)))
    burst = (b"GET /ping HTTP/1.1\r\nHost: x\r\n\r\n"
             b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n\r\nAB"
             b"GET /ping HTTP/1.1\r\nHost: x\r\n"
             b"Connection: close\r\n\r\n")
    sk.sendall(burst)
    buf = _recv_until_closed(sk)
    sk.close()
    # three 200s, bodies in send order, conn closed by the last one
    assert buf.count(b"HTTP/1.1 200") == 3
    assert buf.index(b"pong") < buf.index(b"AB") < buf.rindex(b"pong")
    assert b"Connection: close" in buf


def test_http10_client_gets_reply_then_close(srv):
    host, port = srv.addr.rsplit(":", 1)
    sk = socket.create_connection((host, int(port)))
    sk.sendall(b"GET /ping HTTP/1.0\r\n\r\n")
    buf = _recv_until_closed(sk)  # recv returning b"" IS the close proof
    sk.close()
    assert buf.count(b"HTTP/1.1 200") == 1 and buf.endswith(b"pong")


def test_framing_violation_answered_then_closed(srv):
    host, port = srv.addr.rsplit(":", 1)
    sk = socket.create_connection((host, int(port)))
    sk.sendall(b"PUT /x HTTP/1.1\r\nContent-Length: 99999999999\r\n\r\n")
    buf = _recv_until_closed(sk)
    sk.close()
    assert b"HTTP/1.1 413" in buf


def test_head_suppresses_body_but_describes_it():
    r = Router()
    r.head("/doc", lambda req: Response(200, {"Content-Length": "5"}, b""))
    s = RPCServer(r, module="headtest").start()
    try:
        host, port = s.addr.rsplit(":", 1)
        c = http.client.HTTPConnection(host, int(port))
        c.request("HEAD", "/doc")
        resp = c.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Length") == "5"
        assert resp.read() == b""
        c.close()
    finally:
        s.stop()


def test_stop_parity_drain_hardclose_and_rebind():
    """The graceful-reload bug class on the new core: stop() must hard-close
    parked keep-alive sockets (a pooled client sees EOF, not a stale
    old-stack server) and free the port for an immediate rebind."""
    r = Router()
    r.get("/ping", lambda req: Response(200, {}, b"pong"))
    s = RPCServer(r, module="stoptest").start()
    host, port = s.addr.rsplit(":", 1)
    port = int(port)
    c = http.client.HTTPConnection(host, port)
    c.request("GET", "/ping")
    assert c.getresponse().read() == b"pong"
    s.stop()  # conn c is parked keep-alive: must be hard-closed
    with pytest.raises(Exception):
        c.request("GET", "/ping")
        c.getresponse()
    c.close()
    s2 = RPCServer(r, module="stoptest2", port=port).start()
    try:
        assert s2.port == port
        c2 = http.client.HTTPConnection(host, port)
        c2.request("GET", "/ping")
        assert c2.getresponse().read() == b"pong"
        c2.close()
    finally:
        s2.stop()


def test_slow_reader_backpressure_pauses_only_that_conn(monkeypatch):
    """A client that floods pipelined /big requests WITHOUT reading crosses
    the write-queue high-water mark: ITS reads pause (cfs_evloop_backpressure
    counts it), a neighbor on the same server stays live, and the flooded
    conn still drains every reply byte-identical and in order."""
    monkeypatch.setenv("CFS_EVLOOP_WRITEBUF", str(64 << 10))
    r = Router()
    r.get("/ping", lambda req: Response(200, {}, b"pong"))
    body = b"\xa7" * (256 << 10)
    r.get("/big", lambda req: Response(200, {}, body))
    s = RPCServer(r, module="bptest").start()
    try:
        from chubaofs_tpu_torch.utils.exporter import render_all

        host, port = s.addr.rsplit(":", 1)
        flood = socket.create_connection((host, int(port)))
        # shrink the client's receive window so the kernel can't swallow
        # the whole reply burst before the server's write queue ever fills
        flood.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 32 << 10)
        n_reqs = 32
        flood.sendall(b"GET /big HTTP/1.1\r\nHost: x\r\n\r\n" * n_reqs)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            txt = render_all()
            bp = [ln for ln in txt.splitlines()
                  if ln.startswith("cfs_evloop_backpressure")
                  and "http-bptest" in ln]
            if any(float(ln.rsplit(" ", 1)[1]) > 0 for ln in bp):
                break
            time.sleep(0.02)
        else:
            raise AssertionError("backpressure never engaged")
        # neighbor on the same (2-shard default) server keeps being served
        c = http.client.HTTPConnection(host, int(port))
        c.request("GET", "/ping")
        assert c.getresponse().read() == b"pong"
        c.close()
        # the flooded conn drains: every reply, in order, byte-identical
        got = b""
        flood.settimeout(15)
        want = n_reqs * 1  # count of status lines
        while got.count(b"HTTP/1.1 200") < want or not got.endswith(body):
            d = flood.recv(1 << 20)
            if not d:
                break
            got += d
        flood.close()
        assert got.count(b"HTTP/1.1 200") == n_reqs
        assert got.count(body) == n_reqs
    finally:
        s.stop()


def test_threaded_fallback_mode_matrix(monkeypatch):
    """CFS_EVLOOP_HTTP=0 restores the ThreadingHTTPServer path; the same
    requests behave identically (the dispatch_request contract)."""
    monkeypatch.setenv("CFS_EVLOOP_HTTP", "0")
    r = Router()
    r.get("/ping", lambda req: Response(200, {}, b"pong"))
    r.post("/echo", lambda req: Response(200, {}, req.body))
    s = RPCServer(r, module="threadedtest").start()
    try:
        assert s._evcore is None and s.httpd is not None
        host, port = s.addr.rsplit(":", 1)
        c = http.client.HTTPConnection(host, int(port))
        c.request("GET", "/ping")
        assert c.getresponse().read() == b"pong"
        c.request("POST", "/echo", body=b"abc")
        assert c.getresponse().read() == b"abc"
        # /metrics side-door mounted identically in both modes
        c.request("GET", "/metrics")
        assert b"cfs_" in c.getresponse().read()
        c.close()
    finally:
        s.stop()


def test_sidedoors_served_from_loop_shards(srv):
    host, port = srv.addr.rsplit(":", 1)
    c = http.client.HTTPConnection(host, int(port))
    c.request("GET", "/metrics")
    txt = c.getresponse().read()
    assert b"cfs_evloop_dispatch" in txt  # the core meters itself
    c.request("GET", "/health")
    assert c.getresponse().status == 200
    c.close()
