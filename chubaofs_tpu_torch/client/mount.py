"""Mount — the client's POSIX handle layer over one volume.

Reference counterpart: client/ — the FUSE daemon's Super + fs node layer
(client/fuse.go:588 NewSuper; fs ops client/fs/file.go:316-439,
client/fs/dir.go; inode attr cache client/fs/icache.go; orphan inode list;
per-op audit log via util/auditlog, CHANGELOG.md:10). Kept: a file-descriptor
table with positional + streaming reads/writes, a TTL'd inode-attribute
cache and (parent, name) lookup cache invalidated on mutation, the orphan
list — an unlinked-but-open inode stays readable until its last close, which
evicts it — and one audit line per namespace op. This path-based surface
serves in-process consumers and libsdk's cfs_* C ABI (libsdk/libsdk.go:259).
The kernel FUSE wire lives in client/fuse_ll.py and deliberately does NOT
layer on Mount: the kernel protocol is nodeid(inode)-based with the fd
table living in the kernel, so fuse_ll drives MetaWrapper/FsClient inode
verbs directly; the one shared contract — orphan-inode eviction on last
close — is intentionally implemented in both (see fuse_ll's module doc).
"""

from __future__ import annotations

import os
import threading
import time

from chubaofs_tpu_torch.blobstore import trace
from chubaofs_tpu_torch.sdk.fs import FsClient, FsError
from chubaofs_tpu_torch.utils.auditlog import AuditLog, record_slow_op


class MountError(FsError):
    pass


O_RDONLY, O_WRONLY, O_RDWR = 0, 1, 2
O_CREAT, O_TRUNC, O_APPEND = 0o100, 0o1000, 0o2000


class _Handle:
    __slots__ = ("fd", "ino", "flags", "pos", "path")

    def __init__(self, fd: int, ino: int, flags: int, path: str):
        self.fd = fd
        self.ino = ino
        self.flags = flags
        self.pos = 0
        self.path = path


class Mount:
    """One mounted volume: fd table + caches + orphan list + audit."""

    ATTR_TTL = 1.0  # client/fs/icache.go's attr validity window
    LOOKUP_TTL = 1.0

    def __init__(self, fs: FsClient, volume: str = "", audit_dir: str | None = None,
                 client_id: str = ""):
        self.fs = fs
        self.volume = volume
        self.client_id = client_id or f"pid{os.getpid()}"
        self.audit = AuditLog(audit_dir) if audit_dir else None
        self._lock = threading.Lock()
        self._next_fd = 3
        self._fds: dict[int, _Handle] = {}
        self._open_count: dict[int, int] = {}  # ino -> open handles
        self._orphans: set[int] = set()  # unlinked while open
        self._attr: dict[int, tuple[float, dict]] = {}  # ino -> (expiry, stat)
        self._lookups: dict[str, tuple[float, int]] = {}  # path -> (expiry, ino)

    # -- audit -----------------------------------------------------------------

    def _op(self, op: str, path: str, fn):
        from chubaofs_tpu_torch.meta.metanode import OpError

        t0 = time.perf_counter()
        err = ""
        # the fs-op root (or child, under a caller's span): every meta/data
        # hop below hangs its track entry off this one trace id — the
        # FUSE→SDK→metanode→raft chain reads as one track log
        span = trace.child_of(trace.current_span(), f"mount.{op}")
        trace.push_span(span)
        try:
            return fn()
        except FsError as e:
            err = e.code
            raise
        except OpError as e:
            # direct meta calls (stat/truncate caches) surface the same
            # FsError contract the fs verbs do
            err = e.code
            raise MountError(e.code, path) from None
        finally:
            span.append_track_log("fuse", start=t0)
            span.finish()
            trace.pop_span()
            elapsed = time.perf_counter() - t0
            record_slow_op("fuse", op, elapsed, span=span, err=err)
            if self.audit:
                self.audit.log_fs_op(self.client_id, self.volume, op, path,
                                     err=err, latency_us=int(elapsed * 1e6))

    # -- caches ----------------------------------------------------------------

    def _resolve(self, path: str) -> int:
        now = time.monotonic()  # cache TTLs are deltas, never wall stamps
        hit = self._lookups.get(path)
        if hit and now < hit[0]:
            return hit[1]
        ino = self.fs.resolve(path)
        self._lookups[path] = (now + self.LOOKUP_TTL, ino)
        return ino

    def _stat_ino(self, ino: int) -> dict:
        from chubaofs_tpu_torch.meta.metanode import OpError

        now = time.monotonic()
        hit = self._attr.get(ino)
        if hit and now < hit[0]:
            return hit[1]
        try:
            inode = self.fs.meta.get_inode(ino)
        except OpError as e:
            raise MountError(e.code, f"ino {ino}") from None
        st = {"ino": inode.ino, "mode": inode.mode, "size": inode.size,
              "nlink": inode.nlink, "uid": inode.uid, "gid": inode.gid,
              "mtime": inode.mtime, "is_dir": inode.is_dir}
        self._attr[ino] = (now + self.ATTR_TTL, st)
        return st

    def _invalidate(self, *inos: int, paths: tuple[str, ...] = ()):
        for ino in inos:
            self._attr.pop(ino, None)
        for p in paths:
            self._lookups.pop(p, None)

    def _invalidate_prefix(self, path: str):
        """Rename/rmdir moves a subtree: drop every cached path under it."""
        self._lookups = {p: v for p, v in self._lookups.items()
                         if p != path and not p.startswith(path.rstrip("/") + "/")}

    # -- fd table --------------------------------------------------------------

    def open(self, path: str, flags: int = O_RDONLY, mode: int = 0o644) -> int:
        def run():
            try:
                ino = self._resolve(path)
            except FsError:
                if not flags & O_CREAT:
                    raise
                try:
                    ino = self.fs.create(path, mode)
                except FsError as e:
                    # O_CREAT without O_EXCL: losing a concurrent-create race
                    # opens the winner's file (POSIX)
                    if e.code != "EEXIST":
                        raise
                    self._lookups.pop(path, None)
                    ino = self.fs.resolve(path)
                self._invalidate(paths=(path,))
            st = self._stat_ino(ino)
            if st["is_dir"] and flags & (O_WRONLY | O_RDWR):
                raise MountError("EISDIR", path)
            if flags & O_TRUNC and not st["is_dir"]:
                self.fs.meta.truncate(ino, 0)
                self._invalidate(ino)
            with self._lock:
                fd = self._next_fd
                self._next_fd += 1
                h = _Handle(fd, ino, flags, path)
                if flags & O_APPEND:
                    h.pos = self._stat_ino(ino)["size"]
                self._fds[fd] = h
                self._open_count[ino] = self._open_count.get(ino, 0) + 1
            return fd

        return self._op("open", path, run)

    def _handle(self, fd: int) -> _Handle:
        h = self._fds.get(fd)
        if h is None:
            raise MountError("EBADF", str(fd))
        return h

    def close(self, fd: int) -> None:
        def run():
            with self._lock:
                h = self._handle(fd)
                del self._fds[fd]
                n = self._open_count.get(h.ino, 1) - 1
                if n <= 0:
                    self._open_count.pop(h.ino, None)
                    evict = h.ino in self._orphans
                    if evict:
                        self._orphans.discard(h.ino)
                else:
                    self._open_count[h.ino] = n
                    evict = False
            if evict:  # last close of an unlinked file releases it
                self.fs.evict_ino(h.ino)
                self._invalidate(h.ino)

        return self._op("close", self._fds.get(fd, _Handle(0, 0, 0, "?")).path, run)

    # -- io --------------------------------------------------------------------

    def read(self, fd: int, size: int, offset: int | None = None) -> bytes:
        """offset None = streaming read advancing the cursor; an explicit
        offset is pread — it must NOT move the cursor (POSIX)."""
        h = self._handle(fd)

        def run():
            at = h.pos if offset is None else offset
            data = self.fs.read_at(h.ino, at, size)
            if offset is None:
                h.pos = at + len(data)
            return data

        return self._op("read", h.path, run)

    def write(self, fd: int, data: bytes, offset: int | None = None) -> int:
        """offset None = streaming write (or append under O_APPEND); an
        explicit offset is pwrite and leaves the cursor alone."""
        h = self._handle(fd)

        def run():
            if not h.flags & (O_WRONLY | O_RDWR):
                raise MountError("EBADF", f"fd {fd} is read-only")
            if offset is None:
                at = (self._stat_ino(h.ino)["size"]
                      if h.flags & O_APPEND else h.pos)
            else:
                at = offset
            self.fs.write_at(h.ino, at, data)
            if offset is None:
                h.pos = at + len(data)
            self._invalidate(h.ino)
            return len(data)

        return self._op("write", h.path, run)

    def lseek(self, fd: int, offset: int, whence: int = 0) -> int:
        h = self._handle(fd)
        if whence == 0:
            h.pos = offset
        elif whence == 1:
            h.pos += offset
        elif whence == 2:
            h.pos = self._stat_ino(h.ino)["size"] + offset
        else:
            raise MountError("EINVAL", f"whence {whence}")
        return h.pos

    def fsync(self, fd: int) -> None:
        self._handle(fd)  # writes are synchronous end-to-end already

    def fstat(self, fd: int) -> dict:
        h = self._handle(fd)
        self._attr.pop(h.ino, None)  # fstat is the fresh-size call
        return self._stat_ino(h.ino)

    # -- namespace -------------------------------------------------------------

    def stat(self, path: str) -> dict:
        return self._op("stat", path, lambda: self._stat_ino(self._resolve(path)))

    def mkdir(self, path: str, mode: int = 0o755) -> int:
        def run():
            ino = self.fs.mkdir(path, mode)
            self._invalidate(paths=(path,))
            return ino

        return self._op("mkdir", path, run)

    def readdir(self, path: str) -> list[str]:
        return self._op("readdir", path, lambda: self.fs.readdir(path))

    def rmdir(self, path: str) -> None:
        def run():
            self.fs.rmdir(path)
            self._invalidate_prefix(path)

        return self._op("rmdir", path, run)

    def unlink(self, path: str) -> None:
        def run():
            # the unlinked inode's identity comes from the metanode, never a
            # cached lookup — a stale cache would orphan/evict the wrong inode
            ino = self.fs.unlink(path, evict=False)
            with self._lock:
                still_open = self._open_count.get(ino, 0) > 0
                if still_open:
                    self._orphans.add(ino)
            if not still_open:
                self.fs.evict_ino(ino)
            self._invalidate(ino, paths=(path,))

        return self._op("unlink", path, run)

    def rename(self, src: str, dst: str) -> None:
        def run():
            # same orphan contract as unlink(): an inode displaced by
            # rename-over while open stays readable until its last close
            displaced = self.fs.rename(src, dst, evict_displaced=False)
            if displaced:
                ino, nlink, is_dir = displaced
                if is_dir:
                    self.fs.evict_ino(ino)
                elif ino and nlink <= 0:
                    with self._lock:
                        still_open = self._open_count.get(ino, 0) > 0
                        if still_open:
                            self._orphans.add(ino)
                    if not still_open:
                        self.fs.evict_ino(ino)
            self._invalidate_prefix(src)
            self._invalidate_prefix(dst)

        return self._op("rename", src, run)

    def link(self, existing: str, new: str) -> None:
        def run():
            self.fs.link(existing, new)
            self._invalidate(self._resolve(existing), paths=(new,))

        return self._op("link", existing, run)

    def truncate(self, path: str, size: int) -> None:
        def run():
            ino = self._resolve(path)
            self.fs.meta.truncate(ino, size)
            self._invalidate(ino)

        return self._op("truncate", path, run)

    def setxattr(self, path: str, key: str, value: bytes) -> None:
        self._op("setxattr", path, lambda: self.fs.setxattr(path, key, value))
        self._invalidate(self._resolve(path))

    def getxattr(self, path: str, key: str) -> bytes:
        return self._op("getxattr", path, lambda: self.fs.getxattr(path, key))

    def listxattr(self, path: str) -> list[str]:
        return self._op("listxattr", path, lambda: self.fs.listxattr(path))

    def removexattr(self, path: str, key: str) -> None:
        self._op("removexattr", path, lambda: self.fs.removexattr(path, key))

    def statfs(self) -> dict:
        return {"volume": self.volume, "open_fds": len(self._fds),
                "orphans": len(self._orphans)}

    def umount(self) -> None:
        """Close every handle (evicting orphans) and the audit log."""
        for fd in list(self._fds):
            try:
                self.close(fd)
            except FsError:
                pass
        if self.audit:
            self.audit.close()
