"""The cases of tests/test_rpc_pool.py, run against the port.

Keep-alive RPC connection pool + retrying-client semantics.

Covers: reuse/miss/evict accounting against a REAL RPCServer, idle-TTL and
health eviction, the stale-parked-conn free retry (a server that closed a
parked socket must cost zero retry attempts), chaos wedging via the
rpc.pool.checkout failpoint, link-drop against a pooled connection (evict +
fresh-socket retry, no half-read reuse), and the client's edges: no
backoff sleep after the terminal attempt, thread-safe host rotation, and
5xx track-log merging."""

import threading
import time

import pytest

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.blobstore import trace
from chubaofs_tpu_torch.rpc import HTTPError, RPCClient, RPCServer, Response, Router
from chubaofs_tpu_torch.rpc.pool import ConnectionPool, NullPool
from chubaofs_tpu_torch.utils.exporter import registry


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    chaos.reset()


def _counter(name, labels=None) -> float:
    return registry("rpc").counter(name, labels).value


@pytest.fixture
def srv():
    r = Router()
    r.get("/ping", lambda req: Response(200, {}, b"pong"))
    r.get("/boom", lambda req: Response(503, {}, b'{"error":"x"}'))
    s = RPCServer(r, module="test").start()
    yield s
    s.stop()


def test_keepalive_reuse_across_requests(srv):
    pool = ConnectionPool()
    cli = RPCClient([srv.addr], pool=pool)
    reuse0, miss0 = _counter("pool_reuse"), _counter("pool_miss")
    for _ in range(5):
        status, _, body = cli.do("GET", "/ping")
        assert (status, body) == (200, b"pong")
    # one socket minted, then reused for every later request
    assert _counter("pool_miss") - miss0 == 1
    assert _counter("pool_reuse") - reuse0 == 4
    assert pool.idle_count(srv.addr) == 1
    pool.close()


def test_idle_ttl_evicts_parked_conn(srv):
    pool = ConnectionPool(idle_ttl=0.05)
    cli = RPCClient([srv.addr], pool=pool)
    cli.do("GET", "/ping")
    time.sleep(0.1)
    evict0 = _counter("pool_evict", {"reason": "idle_ttl"})
    cli.do("GET", "/ping")  # parked conn expired: evicted, fresh one minted
    assert _counter("pool_evict", {"reason": "idle_ttl"}) - evict0 == 1
    pool.close()


def test_bounded_idle_overflow_closes(srv):
    pool = ConnectionPool(max_idle_per_host=1)
    over0 = _counter("pool_evict", {"reason": "overflow"})
    c1, _ = pool.checkout(srv.addr)
    c2, _ = pool.checkout(srv.addr)
    pool.checkin(srv.addr, c1)
    pool.checkin(srv.addr, c2)  # bucket full: closed, not parked
    assert pool.idle_count(srv.addr) == 1
    assert _counter("pool_evict", {"reason": "overflow"}) - over0 == 1
    pool.close()


def test_stale_parked_conn_costs_no_retry_attempt():
    """A parked keep-alive socket the server tore down (restart) must be
    evicted and replaced on the SAME attempt — retries=1 still succeeds."""
    r = Router()
    r.get("/ping", lambda req: Response(200, {}, b"pong"))
    s1 = RPCServer(r, module="test").start()
    addr, port = s1.addr, s1.port
    pool = ConnectionPool()
    cli = RPCClient([addr], retries=1, pool=pool)
    assert cli.do("GET", "/ping")[0] == 200
    assert pool.idle_count(addr) == 1
    s1.stop()  # hard-closes the parked conn's server side
    s2 = RPCServer(r, port=port, module="test").start()
    try:
        stale0 = _counter("pool_evict", {"reason": "stale"})
        status, _, body = cli.do("GET", "/ping")  # rides the stale socket
        assert (status, body) == (200, b"pong")
        assert _counter("pool_evict", {"reason": "stale"}) - stale0 == 1
    finally:
        s2.stop()
        pool.close()


def test_link_drop_on_pooled_conn_evicts_and_retries_fresh(srv):
    """Mid-request connection death on a REUSED socket: the pool must evict
    (never re-park half-read state) and the request must complete on a
    fresh socket without burning a retry attempt."""
    pool = ConnectionPool()
    cli = RPCClient([srv.addr], retries=1, pool=pool)
    cli.do("GET", "/ping")  # park a healthy keep-alive conn
    # the handler dies before replying ONCE: the parked conn sees EOF
    chaos.arm("rpc.server.handle", "error*1")
    stale0 = _counter("pool_evict", {"reason": "stale"})
    status, _, body = cli.do("GET", "/ping")
    assert (status, body) == (200, b"pong")
    assert _counter("pool_evict", {"reason": "stale"}) - stale0 == 1
    # and the replacement socket is parked + reused afterwards
    reuse0 = _counter("pool_reuse")
    assert cli.do("GET", "/ping")[0] == 200
    assert _counter("pool_reuse") - reuse0 == 1
    pool.close()


def test_stale_conn_post_gets_no_free_replay(srv):
    """Non-idempotent methods must NOT be silently resent on a stale reused
    conn (the server may have executed them before dropping the line): the
    failure surfaces to the COUNTED retry loop instead."""
    r = Router()
    hits = []
    r.post("/op", lambda req: (hits.append(1), Response(200, {}, b"ok"))[1])
    s = RPCServer(r, module="test").start()
    pool = ConnectionPool()
    try:
        cli = RPCClient([s.addr], retries=2, backoff=0.0, pool=pool)
        assert cli.do("POST", "/op")[0] == 200  # parks a keep-alive conn
        chaos.arm("rpc.server.handle", "error*1")
        # the stale-conn failure consumes attempt 1; attempt 2 succeeds on
        # a fresh socket — and the op ran at most twice, never invisibly
        assert cli.do("POST", "/op")[0] == 200
        assert len(hits) == 2
    finally:
        s.stop()
        pool.close()


def test_flush_host_evicts_stale_siblings(srv):
    """One stale reused conn flushes the host's whole idle bucket, so a
    server restart can never burn the retry budget one dead socket at a
    time (default pool size >= default retries)."""
    pool = ConnectionPool()
    conns = [pool.checkout(srv.addr)[0] for _ in range(3)]
    for c in conns:
        pool.checkin(srv.addr, c)
    assert pool.idle_count(srv.addr) == 3
    stale0 = _counter("pool_evict", {"reason": "stale"})
    assert pool.flush_host(srv.addr) == 3
    assert pool.idle_count(srv.addr) == 0
    assert _counter("pool_evict", {"reason": "stale"}) - stale0 == 3
    pool.close()


def test_pool_checkout_failpoint_wedges(srv):
    pool = ConnectionPool()
    cli = RPCClient([srv.addr], retries=2, backoff=0.01, pool=pool)
    chaos.arm("rpc.pool.checkout", "error(wedged)")
    with pytest.raises(ConnectionError):
        cli.do("GET", "/ping")
    chaos.disarm("rpc.pool.checkout")
    assert cli.do("GET", "/ping")[0] == 200
    pool.close()


def test_no_backoff_sleep_after_terminal_attempt():
    # dead port: every attempt fails instantly with connect-refused, so
    # elapsed ~= the sleeps. retries=3/backoff=0.2 used to pay
    # 0.2+0.4+0.6=1.2s; skipping the post-final sleep pays 0.2+0.4=0.6s
    cli = RPCClient(["127.0.0.1:1"], retries=3, backoff=0.2,
                    pool=NullPool(timeout=0.2))
    t0 = time.perf_counter()
    with pytest.raises(OSError):
        cli.do("GET", "/ping")
    elapsed = time.perf_counter() - t0
    assert elapsed < 1.0, f"terminal failure paid post-final backoff: {elapsed:.2f}s"


def test_round_robin_thread_safe():
    cli = RPCClient(["a:1", "b:1"], pooled=False)
    seen = []

    def spin():
        for _ in range(500):
            seen.append(cli._next_host())

    threads = [threading.Thread(target=spin) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # count() never loses or duplicates a slot under concurrency
    assert seen.count("a:1") == seen.count("b:1") == 1000


def test_5xx_response_track_log_merged_before_retry(srv):
    """A >=500 hop's Trace-Tracklog must fold into the caller's span even
    though the attempt is retried — failed hops must not vanish from
    traces."""
    cli = RPCClient([srv.addr], retries=2, backoff=0.0, pooled=False)
    span = trace.start_span("client-op")
    trace.push_span(span)
    try:
        with pytest.raises(HTTPError):
            cli.do("GET", "/boom")
    finally:
        trace.pop_span()
    # both failed hops contributed server-side track entries
    assert len([e for e in span.track if e.startswith("test:")]) == 2
