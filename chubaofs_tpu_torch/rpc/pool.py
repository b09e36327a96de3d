"""Keep-alive HTTP connection pool — the RPC hop's transport cache.

Reference counterpart: util/connpool (the packet-TCP pool the SDK stream
already rides, utils/conn_pool.py) applied to the HTTP control/data hops:
CubeFS's access layer streams stripes over a connection-pooled transport
instead of paying a TCP connect per request (SURVEY §blobstore). Same
policy here for `http.client.HTTPConnection`:

  * per-host bounded idle list (newest-first reuse, so a hot host keeps one
    warm socket instead of round-robining N cold ones),
  * idle TTL — a socket parked past the TTL is closed, not trusted (the
    server side may have torn it down),
  * health-evict — a connection that errored is closed on check-in, never
    re-parked,
  * thread-safe checkout (the RPCClient is shared across pool workers).

Every `HTTPConnection` in the process is constructed HERE (obslint enforces
it): the unpooled path is `NullPool`, which mints a fresh connection per
checkout and closes on check-in — so the pooled/unpooled A/B in perfbench
flips an object, not a code path.

Counters ride `registry("rpc")` (cfs_rpc_pool_*): reuse / miss / evict
{reason}, so a bench or `cfs-stat` diff shows the realized hit rate. The
`rpc.pool.checkout` failpoint lets chaos wedge or fail the checkout itself.
"""

from __future__ import annotations

import http.client
import os
import time

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.utils.exporter import registry
from chubaofs_tpu_torch.utils.locks import SanitizedLock


def _counter(name: str, labels: dict | None = None):
    return registry("rpc").counter(name, labels)


class ConnectionPool:
    """Per-host keep-alive HTTPConnection pool.

    checkout(host) -> (conn, reused); check the conn back in with
    checkin(host, conn, ok=...) — broken/doubtful conns are closed and
    counted as evictions, healthy ones are parked for reuse (bounded,
    newest-first)."""

    def __init__(self, max_idle_per_host: int | None = None,
                 idle_ttl: float | None = None, timeout: float = 30.0):
        if max_idle_per_host is None:
            max_idle_per_host = int(os.environ.get("CFS_RPC_POOL_SIZE", "4"))
        if idle_ttl is None:
            idle_ttl = float(os.environ.get("CFS_RPC_POOL_TTL", "30"))
        self.max_idle_per_host = max(1, max_idle_per_host)
        self.idle_ttl = idle_ttl
        self.timeout = timeout
        self._idle: dict[str, list[tuple[http.client.HTTPConnection, float]]] = {}
        self._lock = SanitizedLock(name="rpc.pool")

    def checkout(self, host: str,
                 timeout: float | None = None) -> tuple[http.client.HTTPConnection, bool]:
        """A connection to `host`: a parked keep-alive one when available
        (reused=True), else a fresh one. TTL-expired parked conns are
        evicted on the way."""
        chaos.failpoint("rpc.pool.checkout")
        now = time.monotonic()
        reuse = None
        expired: list[http.client.HTTPConnection] = []
        with self._lock:
            bucket = self._idle.get(host)
            while bucket:
                conn, parked = bucket.pop()  # newest-first: warmest socket
                if now - parked <= self.idle_ttl:
                    reuse = conn
                    break
                # close OUTSIDE the lock: tearing down a dead socket can
                # block for ~100ms+, and every other checkout would queue
                # behind it (found by the cfs_lock_hold_ms audit)
                expired.append(conn)
        for conn in expired:
            conn.close()
            _counter("pool_evict", {"reason": "idle_ttl"}).add()
        if reuse is not None:
            if timeout is not None:
                # the parked socket keeps its creator's timeout;
                # rebind to THIS caller's budget
                reuse.timeout = timeout
                if reuse.sock is not None:
                    reuse.sock.settimeout(timeout)
            _counter("pool_reuse").add()
            return reuse, True
        _counter("pool_miss").add()
        conn = http.client.HTTPConnection(
            host, timeout=self.timeout if timeout is None else timeout)
        return conn, False

    def checkin(self, host: str, conn: http.client.HTTPConnection,
                ok: bool = True, reason: str = "error") -> None:
        """Park a healthy connection for reuse; close-and-count anything
        doubtful (IO error, server said Connection: close, response not
        fully read)."""
        if not ok:
            conn.close()
            _counter("pool_evict", {"reason": reason}).add()
            return
        with self._lock:
            bucket = self._idle.setdefault(host, [])
            if len(bucket) >= self.max_idle_per_host:
                # displace the OLDEST parked conn, keep the one that just
                # served a request — the warmest socket stays available
                old, _ = bucket.pop(0)
            else:
                old = None
            bucket.append((conn, time.monotonic()))
        if old is not None:
            old.close()
            _counter("pool_evict", {"reason": "overflow"}).add()

    def idle_count(self, host: str | None = None) -> int:
        with self._lock:
            if host is not None:
                return len(self._idle.get(host, ()))
            return sum(len(b) for b in self._idle.values())

    def flush_host(self, host: str) -> int:
        """Evict every parked conn for one host. Called when a reused conn
        proved stale: its parked siblings are OLDER sockets to the same
        (restarted) server and are dead too — draining them one counted
        retry at a time could exhaust a caller's whole retry budget."""
        with self._lock:
            bucket = self._idle.pop(host, [])
        for conn, _ in bucket:
            conn.close()
        if bucket:
            _counter("pool_evict", {"reason": "stale"}).add(len(bucket))
        return len(bucket)

    def close(self) -> None:
        """Close every parked connection (not counted as evictions: shutdown
        is lifecycle, not health)."""
        with self._lock:
            for bucket in self._idle.values():
                for conn, _ in bucket:
                    conn.close()
            self._idle.clear()


class NullPool:
    """Connect-per-request transport with the pool's interface: the unpooled
    control in A/B benches, and the opt-out for callers that must not hold
    sockets (CFS_RPC_POOL=0)."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout

    def checkout(self, host: str,
                 timeout: float | None = None) -> tuple[http.client.HTTPConnection, bool]:
        chaos.failpoint("rpc.pool.checkout")
        conn = http.client.HTTPConnection(
            host, timeout=self.timeout if timeout is None else timeout)
        return conn, False

    def checkin(self, host: str, conn: http.client.HTTPConnection,
                ok: bool = True, reason: str = "error") -> None:
        conn.close()

    def idle_count(self, host: str | None = None) -> int:
        return 0

    def flush_host(self, host: str) -> int:
        return 0

    def close(self) -> None:
        pass


_default: ConnectionPool | NullPool | None = None
_default_lock = SanitizedLock(name="rpc.pool.default")


def default_pool() -> ConnectionPool | NullPool:
    """The process-wide pool every RPCClient rides unless handed its own.
    CFS_RPC_POOL=0 makes it a NullPool (connect-per-request everywhere)."""
    global _default
    with _default_lock:
        if _default is None:
            if os.environ.get("CFS_RPC_POOL", "1") == "0":
                _default = NullPool()
            else:
                _default = ConnectionPool()
        return _default


def reset_default_pool() -> None:
    """Close and forget the process pool (tests; daemon shutdown)."""
    global _default
    with _default_lock:
        if _default is not None:
            _default.close()
            _default = None
