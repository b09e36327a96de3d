"""KVStore — Python face of the native libcfskv engine (RocksDB stand-in).

Reference counterpart: blobstore/common/kvstore/db.go:28,115-181 (gorocksdb
wrapper: Get/Put/Delete/WriteBatch/NewIterator-with-prefix) and
raftstore/raftstore_db. Kept: the same surface the reference code leans on —
point ops, crash-atomic write batches, ordered prefix scans, checkpoints for
raft snapshot streams — and the reference's native-engine split: the store
IS C++ (native/kvstore/kvstore.cc), loaded via ctypes the way the reference
loads RocksDB via cgo.

`PyKV` is a byte-compatible pure-Python engine: it reads and writes the
exact log format (same CRC framing), so a directory written by one engine
opens under the other. It serves two jobs: a fallback where no C++ toolchain
exists, and a cross-implementation correctness check (tests open each
engine's files with the other).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import struct
import subprocess
import threading
import zlib

from chubaofs_tpu_torch.utils.locks import SanitizedLock

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native", "kvstore")
# this package's own copy of the engine. It only ever appears by an atomic
# rename of a finished build, so a process that finds it can load it: test
# workers and daemons that open their first store together may each build,
# but none loads a file another is still writing (make writes its
# build/libcfskv.so in place, and a loader racing that write fails with
# "file too short").
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "build", "libcfskv_torch.so"))

_PUT, _DEL, _BATCH = 1, 2, 3
_U32 = struct.Struct("<I")
_SUB = struct.Struct("<BII")


class KVError(Exception):
    pass


# -- native engine loading -----------------------------------------------------

_lib = None
_lib_failed = False  # a failed build is cached: pay the make attempt once
_lib_lock = threading.Lock()


def _build_native() -> bool:
    tmp = f"{_SO_PATH}.{os.getpid()}.{threading.get_ident()}.d"
    try:
        subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR), f"BUILD={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(os.path.join(tmp, "libcfskv.so"), _SO_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _load_native():
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_failed:
            return None
        if not os.path.exists(_SO_PATH) and not _build_native():
            _lib_failed = True
            return None
        lib = ctypes.CDLL(_SO_PATH)
        lib.cfskv_open.restype = ctypes.c_void_p
        lib.cfskv_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.cfskv_close.argtypes = [ctypes.c_void_p]
        lib.cfskv_errmsg.restype = ctypes.c_char_p
        lib.cfskv_errmsg.argtypes = [ctypes.c_void_p]
        lib.cfskv_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_char_p, ctypes.c_int]
        lib.cfskv_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.cfskv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
                                  ctypes.POINTER(ctypes.c_int)]
        lib.cfskv_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        lib.cfskv_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_int]
        lib.cfskv_scan.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
                                   ctypes.POINTER(ctypes.c_int)]
        lib.cfskv_count.restype = ctypes.c_long
        lib.cfskv_count.argtypes = [ctypes.c_void_p]
        lib.cfskv_compact.argtypes = [ctypes.c_void_p]
        lib.cfskv_checkpoint.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        _lib = lib
        return lib


class NativeKV:
    """ctypes binding over libcfskv (the cgo-RocksDB analog)."""

    def __init__(self, path: str):
        lib = _load_native()
        if lib is None:
            raise KVError("libcfskv.so unavailable (no toolchain?)")
        self._lib = lib
        err = ctypes.create_string_buffer(512)
        self._h = lib.cfskv_open(path.encode(), err, len(err))
        if not self._h:
            raise KVError(f"open {path}: {err.value.decode()}")
        self._lock = SanitizedLock(name="kvstore.native")

    # Every call holds self._lock: close() then waits for the call in flight
    # and a call after close() raises, where either would otherwise hand the
    # engine a freed or null handle and crash the process. The engine takes
    # its own mutex on every call, so this serialises nothing more.

    def _handle(self):
        if not self._h:
            raise KVError("store closed")
        return self._h

    def _check(self, rc: int):
        if rc < 0:
            raise KVError(self._lib.cfskv_errmsg(self._h).decode())

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._check(self._lib.cfskv_put(self._handle(), key, len(key),
                                            value, len(value)))

    def get(self, key: bytes) -> bytes | None:
        out = ctypes.POINTER(ctypes.c_char)()
        n = ctypes.c_int()
        with self._lock:
            rc = self._lib.cfskv_get(self._handle(), key, len(key),
                                     ctypes.byref(out), ctypes.byref(n))
            if rc == 1:
                return None
            self._check(rc)
        try:
            return ctypes.string_at(out, n.value)
        finally:
            self._lib.cfskv_free(out)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._check(self._lib.cfskv_del(self._handle(), key, len(key)))

    def write_batch(self, puts=(), deletes=()) -> None:
        """Crash-atomic batch (gorocksdb WriteBatch analog)."""
        buf = bytearray()
        count = 0
        for k, v in puts:
            buf += _SUB.pack(_PUT, len(k), len(v)) + k + v
            count += 1
        for k in deletes:
            buf += _SUB.pack(_DEL, len(k), 0) + k
            count += 1
        if not count:
            return
        with self._lock:
            self._check(self._lib.cfskv_batch(self._handle(), bytes(buf),
                                              len(buf), count))

    def scan(self, prefix: bytes = b"", start: bytes = b"",
             limit: int = 1 << 30) -> list[tuple[bytes, bytes]]:
        out = ctypes.POINTER(ctypes.c_char)()
        n = ctypes.c_int()
        with self._lock:
            self._check(self._lib.cfskv_scan(self._handle(), prefix, len(prefix),
                                             start, len(start), limit,
                                             ctypes.byref(out), ctypes.byref(n)))
        try:
            blob = ctypes.string_at(out, n.value)
        finally:
            self._lib.cfskv_free(out)
        pairs, off = [], 0
        while off < len(blob):
            klen, vlen = _U32.unpack_from(blob, off)[0], _U32.unpack_from(blob, off + 4)[0]
            off += 8
            pairs.append((blob[off:off + klen], blob[off + klen:off + klen + vlen]))
            off += klen + vlen
        return pairs

    def count(self) -> int:
        with self._lock:
            return self._lib.cfskv_count(self._handle())

    def compact(self) -> None:
        with self._lock:
            self._check(self._lib.cfskv_compact(self._handle()))

    def checkpoint(self, out_dir: str) -> None:
        with self._lock:
            self._check(self._lib.cfskv_checkpoint(self._handle(), out_dir.encode()))

    def close(self) -> None:
        with self._lock:
            if self._h:
                self._lib.cfskv_close(self._h)
                self._h = None


class PyKV:
    """Pure-Python engine writing the identical on-disk format."""

    COMPACT_MIN_DEAD = 4 << 20

    def __init__(self, path: str):
        self.dir = path
        os.makedirs(path, exist_ok=True)
        # same single-handle discipline as the native engine: a second live
        # handle would keep appending to a log that compaction unlinks
        import fcntl

        self._lockf = open(os.path.join(path, "LOCK"), "a+")
        try:
            fcntl.flock(self._lockf, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lockf.close()
            raise KVError(f"store {path} already open (LOCK held)") from None
        self.index: dict[bytes, bytes] = {}
        self._live = 0
        self._total = 0
        self._lock = SanitizedLock(name="kvstore.pykv")
        ids = sorted(int(f[:8]) for f in os.listdir(path)
                     if len(f) == 12 and f.endswith(".log"))
        for i, fid in enumerate(ids):
            self._replay(self._log_path(fid), last=(i + 1 == len(ids)))
        self.active_id = ids[-1] if ids else 1
        self._f = open(self._log_path(self.active_id), "ab")

    def _log_path(self, fid: int) -> str:
        return os.path.join(self.dir, f"{fid:08d}.log")

    def _replay(self, path: str, last: bool):
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + 13 <= len(data):
            (crc,) = _U32.unpack_from(data, off)
            typ, a, b = _SUB.unpack_from(data, off + 4)
            body_len = 9 + b if typ == _BATCH else 9 + a + b
            if off + 4 + body_len > len(data):
                break
            body = data[off + 4:off + 4 + body_len]
            if zlib.crc32(body) != crc or not self._apply_body(body):
                break
            off += 4 + body_len
        self._total += off
        if off != len(data):
            if not last:
                raise KVError(f"corrupt log {path}")
            with open(path, "r+b") as f:
                f.truncate(off)

    def _apply(self, typ: int, k: bytes, v: bytes):
        if typ == _PUT:
            old = self.index.get(k)
            if old is not None:
                self._live -= len(k) + len(old)
            self.index[k] = v
            self._live += len(k) + len(v)
        elif typ == _DEL:
            old = self.index.pop(k, None)
            if old is not None:
                self._live -= len(k) + len(old)

    def _apply_body(self, body: bytes) -> bool:
        typ, a, b = _SUB.unpack_from(body, 0)
        if typ == _BATCH:
            q, rem, n = 9, len(body) - 9, 0
            while rem >= 9 and n < a:
                t, kl, vl = _SUB.unpack_from(body, q)
                if rem < 9 + kl + vl:
                    return False
                self._apply(t, body[q + 9:q + 9 + kl],
                            body[q + 9 + kl:q + 9 + kl + vl])
                q += 9 + kl + vl
                rem -= 9 + kl + vl
                n += 1
            return rem == 0 and n == a
        if 9 + a + b != len(body):
            return False
        self._apply(typ, body[9:9 + a], body[9 + a:9 + a + b])
        return True

    @staticmethod
    def _frame(body: bytes) -> bytes:
        return _U32.pack(zlib.crc32(body)) + body

    def _append_locked(self, body: bytes):
        framed = self._frame(body)
        self._f.write(framed)
        self._f.flush()
        self._total += len(framed)

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._append_locked(_SUB.pack(_PUT, len(key), len(value)) + key + value)
            self._apply(_PUT, key, value)
            self._maybe_compact()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self.index.get(key)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._append_locked(_SUB.pack(_DEL, len(key), 0) + key)
            self._apply(_DEL, key, b"")
            self._maybe_compact()

    def write_batch(self, puts=(), deletes=()) -> None:
        payload = bytearray()
        count = 0
        for k, v in puts:
            payload += _SUB.pack(_PUT, len(k), len(v)) + k + v
            count += 1
        for k in deletes:
            payload += _SUB.pack(_DEL, len(k), 0) + k
            count += 1
        if not count:
            return
        with self._lock:
            body = _SUB.pack(_BATCH, count, len(payload)) + bytes(payload)
            self._append_locked(body)
            self._apply_body(body)
            self._maybe_compact()

    def scan(self, prefix: bytes = b"", start: bytes = b"",
             limit: int = 1 << 30) -> list[tuple[bytes, bytes]]:
        with self._lock:
            lo = max(prefix, start)
            keys = sorted(k for k in self.index
                          if k >= lo and k.startswith(prefix))
            return [(k, self.index[k]) for k in keys[:limit]]

    def count(self) -> int:
        with self._lock:
            return len(self.index)

    def _write_full(self, path: str):
        tmp = path + ".tmp"
        with open(tmp, "wb") as out:
            for k in sorted(self.index):
                v = self.index[k]
                out.write(self._frame(_SUB.pack(_PUT, len(k), len(v)) + k + v))
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, path)

    def _maybe_compact(self):
        if self._total > self._live + len(self.index) * 13 + self.COMPACT_MIN_DEAD:
            self._compact_locked()

    def _compact_locked(self):
        nxt = self.active_id + 1
        self._write_full(self._log_path(nxt))
        self._f.close()
        for fid in range(1, self.active_id + 1):
            try:
                os.remove(self._log_path(fid))
            except FileNotFoundError:
                pass
        self.active_id = nxt
        self._f = open(self._log_path(nxt), "ab")
        self._total = sum(len(k) + len(v) + 13 for k, v in self.index.items())

    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    def checkpoint(self, out_dir: str) -> None:
        with self._lock:
            os.makedirs(out_dir, exist_ok=True)
            self._write_full(os.path.join(out_dir, f"{1:08d}.log"))

    def close(self) -> None:
        with self._lock:
            if self._f:
                self._f.close()
                self._f = None
            if self._lockf:
                self._lockf.close()  # releases the flock
                self._lockf = None


def open_kv(path: str, engine: str = "auto"):
    """Open a KV store. engine: 'native' | 'python' | 'auto' (native when the
    shared library loads, else python — same files either way)."""
    if engine == "python":
        return PyKV(path)
    if engine == "native":
        return NativeKV(path)
    try:
        return NativeKV(path)
    except KVError:
        return PyKV(path)
