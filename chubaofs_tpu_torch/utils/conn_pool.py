"""Pooled TCP connections keyed by address (util/conn_pool.go analog).

The reference pools idle conns per target with an idle timeout and closes on
error (util/conn_pool.go); same policy here. A checked-out socket is returned
via put(ok=...) — broken sockets are dropped, healthy ones reused.

Observability parity with rpc/pool.py: every checkout is
a `cfs_connpool_reuse` (warm socket handed back out) or `cfs_connpool_miss`
(fresh connect), and every idle-timeout drop is a `cfs_connpool_evict` — the
same reuse/miss/evict truth the HTTP pool reports, so a packet-TCP client's
churn is visible on /metrics. Socket close() never happens under the pool
lock (close can block in the kernel flushing a dead peer's send buffer — the
exact 181 ms hold-time class the lock sanitizer caught in rpc/pool)."""

from __future__ import annotations

import socket
import time

from chubaofs_tpu_torch.utils.exporter import registry
from chubaofs_tpu_torch.utils.locks import SanitizedLock


class ConnPool:
    def __init__(self, idle_timeout: float = 30.0, connect_timeout: float = 5.0,
                 io_timeout: float = 30.0):
        self.idle_timeout = idle_timeout
        self.connect_timeout = connect_timeout
        self.io_timeout = io_timeout
        self._idle: dict[str, list[tuple[socket.socket, float]]] = {}
        self._lock = SanitizedLock(name="conn_pool.idle")
        reg = registry("connpool")
        self._reuse = reg.counter("reuse")
        self._miss = reg.counter("miss")
        self._evict = reg.counter("evict")

    @staticmethod
    def _split(addr: str) -> tuple[str, int]:
        host, port = addr.rsplit(":", 1)
        return host, int(port)

    def get(self, addr: str) -> socket.socket:
        stale: list[socket.socket] = []
        found: socket.socket | None = None
        with self._lock:
            bucket = self._idle.get(addr, [])
            while bucket:
                sock, ts = bucket.pop()
                if time.monotonic() - ts <= self.idle_timeout:
                    found = sock
                    break
                stale.append(sock)
        # closes happen OUTSIDE the lock: a dead peer's close can block in
        # the kernel, and holding the pool lock through it starves every
        # other checkout (the rpc/pool 181 ms hold-time bug class)
        for sock in stale:
            self._evict.add()
            sock.close()
        if found is not None:
            self._reuse.add()
            return found
        self._miss.add()
        host, port = self._split(addr)
        sock = socket.create_connection((host, port), timeout=self.connect_timeout)
        sock.settimeout(self.io_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def put(self, addr: str, sock: socket.socket, ok: bool = True) -> None:
        if not ok:
            sock.close()
            return
        with self._lock:
            self._idle.setdefault(addr, []).append((sock, time.monotonic()))

    def close(self) -> None:
        with self._lock:
            buckets = list(self._idle.values())
            self._idle.clear()
        for bucket in buckets:
            for sock, _ in bucket:
                sock.close()
