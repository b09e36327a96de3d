"""fdstore — unix-socket file-descriptor store for client hot-upgrade.

Reference counterpart: fdstore/fdstore.go (392 LoC): the FUSE client hands
its open descriptors (the /dev/fuse fd and friends) to a tiny daemon over a
unix socket before exec'ing its replacement, and the new process collects
them back — a mount survives a client upgrade without remounting. Kept: the
same put/get-by-key surface, fds ride SCM_RIGHTS ancillary data, one store
daemon per host. The protocol is line-oriented: `PUT <key> <n>` + n fds,
`GET <key>` -> `OK <n>` + n fds, `DEL <key>`, `LIST`.
"""

from __future__ import annotations

import array
import os
import socket
import threading

MAX_FDS = 32


def _send_fds(sock: socket.socket, msg: bytes, fds: list[int]) -> None:
    ancillary = [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                  array.array("i", fds).tobytes())] if fds else []
    sock.sendmsg([msg], ancillary)


def _recv_fds(sock: socket.socket, max_fds: int = MAX_FDS) -> tuple[bytes, list[int]]:
    fds = array.array("i")
    msg, ancdata, _flags, _addr = sock.recvmsg(
        4096, socket.CMSG_LEN(max_fds * fds.itemsize))
    for level, type_, data in ancdata:
        if level == socket.SOL_SOCKET and type_ == socket.SCM_RIGHTS:
            data = data[: len(data) - (len(data) % fds.itemsize)]
            fds.frombytes(data)
    return msg, list(fds)


class FdStore:
    """The store daemon: holds named fd bundles across client restarts."""

    def __init__(self, sock_path: str):
        self.sock_path = sock_path
        try:
            os.unlink(sock_path)
        except FileNotFoundError:
            pass
        self.listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.listener.bind(sock_path)
        self.listener.listen(8)
        self._store: dict[str, list[int]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()

    def _accept(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.listener.accept()
            except OSError:
                return
            threading.Thread(  # racelint: local unix-socket upgrade daemon — a handful of conns, and SCM_RIGHTS ancillary fds don't frame through the evloop
                target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            while True:
                msg, fds = _recv_fds(conn)
                if not msg:
                    return
                parts = msg.decode().split()
                cmd = parts[0] if parts else ""
                if cmd == "PUT" and len(parts) == 3:
                    key, n = parts[1], int(parts[2])
                    for surplus in fds[n:]:  # count mismatch must not leak fds
                        os.close(surplus)
                    with self._lock:
                        for old in self._store.pop(key, []):
                            os.close(old)
                        self._store[key] = fds[:n]
                    _send_fds(conn, b"OK 0", [])
                elif cmd == "GET" and len(parts) == 2:
                    with self._lock:
                        held = self._store.pop(parts[1], None)
                    if held is None:
                        _send_fds(conn, b"ERR not-found", [])
                    else:
                        _send_fds(conn, b"OK %d" % len(held), held)
                        for fd in held:  # ownership transferred to the caller
                            os.close(fd)
                elif cmd == "DEL" and len(parts) == 2:
                    with self._lock:
                        for fd in self._store.pop(parts[1], []):
                            os.close(fd)
                    _send_fds(conn, b"OK 0", [])
                elif cmd == "LIST":
                    with self._lock:
                        keys = " ".join(sorted(self._store)) or "-"
                    _send_fds(conn, b"OK " + keys.encode(), [])
                else:
                    _send_fds(conn, b"ERR bad-command", [])
        except OSError:
            pass
        finally:
            conn.close()

    def close(self):
        self._stop.set()
        self.listener.close()
        try:
            os.unlink(self.sock_path)
        except FileNotFoundError:
            pass
        with self._lock:
            for fds in self._store.values():
                for fd in fds:
                    os.close(fd)
            self._store.clear()


class FdStoreClient:
    def __init__(self, sock_path: str):
        self.sock_path = sock_path

    def _dial(self) -> socket.socket:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(self.sock_path)
        return s

    def put(self, key: str, fds: list[int]) -> None:
        with self._dial() as s:
            _send_fds(s, f"PUT {key} {len(fds)}".encode(), fds)
            msg, _ = _recv_fds(s)
            if not msg.startswith(b"OK"):
                raise OSError(msg.decode())

    def get(self, key: str) -> list[int]:
        with self._dial() as s:
            _send_fds(s, f"GET {key}".encode(), [])
            msg, fds = _recv_fds(s)
            if not msg.startswith(b"OK"):
                raise KeyError(key)
            return fds

    def delete(self, key: str) -> None:
        with self._dial() as s:
            _send_fds(s, f"DEL {key}".encode(), [])
            _recv_fds(s)

    def list(self) -> list[str]:
        with self._dial() as s:
            _send_fds(s, b"LIST", [])
            msg, _ = _recv_fds(s)
            body = msg.decode().split(" ", 1)[1]
            return [] if body == "-" else body.split()
