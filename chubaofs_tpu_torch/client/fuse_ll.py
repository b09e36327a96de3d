"""Kernel FUSE wire — a low-level /dev/fuse protocol server over the SDK.

Reference counterpart: client/fuse.go:470,670 — the reference mounts a volume
through a vendored bazil.org/fuse, whose fs.Serve loop reads fuse_kernel.h
request frames from /dev/fuse and dispatches them to the Super/Node layer.
Here the same wire is spoken directly: struct layouts from fuse_kernel.h
(protocol 7.x), a mount(2) of fstype "fuse" with the /dev/fuse fd, and a
dispatch loop driving MetaWrapper/FsClient inode verbs. With this, UNMODIFIED
external programs (ls, cp, a shell, an LTP-style battery) operate on a
volume through the kernel VFS, as they do on the reference client's mount.

Design notes vs the reference:
  * The protocol layer is inode(nodeid)-based, exactly like bazil's Node API —
    and our MetaWrapper is already inode-based (lookup/get_inode/read_dir/
    create_dentry/...), so nodeid == ino with no translation table
    (ROOT_INO == FUSE_ROOT_ID == 1).
  * Orphan-inode contract (client/fs file.go + Mount): UNLINK drops the
    dentry + link; the inode stays readable for open handles, and the LAST
    RELEASE evicts it (the kernel keeps unlinked-but-open inodes alive and
    only FORGETs them after release, so this maps 1:1). Mount implements the
    same contract for its in-process fd table; here the handle table mirrors
    the KERNEL's open-file state (fh from OPEN/CREATE, dropped at RELEASE),
    which Mount's path/fd surface cannot represent — the duplication is the
    two tables, the eviction rule itself is identical in both.
  * default_permissions: the kernel does uid/gid/mode permission checks from
    GETATTR results, so the server never needs an ACCESS handler (the
    reference relies on bazil's equivalent DefaultPermissions behavior).
  * Single dispatch thread: request frames are handled in arrival order.
    The reference serves concurrently via goroutines; here correctness and
    hermetic teardown win — the data plane below is already concurrent, and
    the POSIX battery is latency-insensitive.

Gated: callers should check `fuse_available()` (needs /dev/fuse + privilege);
tests skip cleanly where the device is absent (CI containers).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno as errno_mod
import os
import stat as stat_mod
import struct
import threading
import time

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.blobstore import trace
from chubaofs_tpu_torch.meta.metanode import OpError
from chubaofs_tpu_torch.sdk.fs import FsClient, FsError
from chubaofs_tpu_torch.utils.auditlog import record_slow_op

# -- fuse_kernel.h: opcodes ----------------------------------------------------

FUSE_LOOKUP = 1
FUSE_FORGET = 2
FUSE_GETATTR = 3
FUSE_SETATTR = 4
FUSE_MKNOD = 8
FUSE_MKDIR = 9
FUSE_UNLINK = 10
FUSE_RMDIR = 11
FUSE_RENAME = 12
FUSE_LINK = 13
FUSE_OPEN = 14
FUSE_READ = 15
FUSE_WRITE = 16
FUSE_STATFS = 17
FUSE_RELEASE = 18
FUSE_FSYNC = 20
FUSE_SETXATTR = 21
FUSE_GETXATTR = 22
FUSE_LISTXATTR = 23
FUSE_REMOVEXATTR = 24
FUSE_FLUSH = 25
FUSE_INIT = 26
FUSE_OPENDIR = 27
FUSE_READDIR = 28
FUSE_RELEASEDIR = 29
FUSE_FSYNCDIR = 30
FUSE_GETLK = 31
FUSE_SETLK = 32
FUSE_SETLKW = 33
FUSE_ACCESS = 34
FUSE_CREATE = 35
FUSE_INTERRUPT = 36
FUSE_BMAP = 37
FUSE_DESTROY = 38
FUSE_BATCH_FORGET = 42
FUSE_FALLOCATE = 43
FUSE_READDIRPLUS = 44
FUSE_RENAME2 = 45
FUSE_LSEEK = 46

# -- struct layouts (x86_64 / little-endian, protocol 7.23..7.31) --------------

IN_HEADER = struct.Struct("<IIQQIIII")  # len opcode unique nodeid uid gid pid pad
OUT_HEADER = struct.Struct("<IiQ")      # len error unique
# ino size blocks atime mtime ctime atimensec mtimensec ctimensec
# mode nlink uid gid rdev blksize padding
ATTR = struct.Struct("<QQQQQQIIIIIIIIII")            # 88 bytes
ENTRY_OUT = struct.Struct("<QQQQII")                 # + ATTR = 128
ATTR_OUT = struct.Struct("<QII")                     # + ATTR = 104
OPEN_OUT = struct.Struct("<QII")                     # fh open_flags padding
WRITE_OUT = struct.Struct("<II")
INIT_OUT = struct.Struct("<IIIIHHIIHH8I")            # 64 bytes (7.23+)
GETATTR_IN = struct.Struct("<IIQ")
SETATTR_IN = struct.Struct("<IIQQQQQQIIIIIIII")      # 88 bytes
MKNOD_IN = struct.Struct("<IIII")
MKDIR_IN = struct.Struct("<II")
RENAME_IN = struct.Struct("<Q")
RENAME2_IN = struct.Struct("<QII")
LINK_IN = struct.Struct("<Q")
OPEN_IN = struct.Struct("<II")
CREATE_IN = struct.Struct("<IIII")
READ_IN = struct.Struct("<QQIIQII")
WRITE_IN = struct.Struct("<QQIIQII")
RELEASE_IN = struct.Struct("<QIIQ")
FSYNC_IN = struct.Struct("<QII")
GETXATTR_IN = struct.Struct("<II")
SETXATTR_IN = struct.Struct("<II")
GETXATTR_OUT = struct.Struct("<II")
KSTATFS = struct.Struct("<QQQQQIIII6I")              # 80 bytes
DIRENT = struct.Struct("<QQII")                      # + name, 8-aligned
FORGET_IN = struct.Struct("<Q")
BATCH_FORGET_IN = struct.Struct("<II")

FUSE_ROOT_ID = 1
FUSE_BIG_WRITES = 1 << 5
FATTR_MODE, FATTR_UID, FATTR_GID, FATTR_SIZE = 1 << 0, 1 << 1, 1 << 2, 1 << 3
FATTR_ATIME, FATTR_MTIME = 1 << 4, 1 << 5
MAX_WRITE = 128 * 1024
ATTR_TTL_S = 1  # client/fs/icache.go attr validity window (Mount.ATTR_TTL)

MS_NOSUID, MS_NODEV = 2, 4
MNT_DETACH = 2

_LIBC = None


def _libc():
    """libc for mount(2)/umount2(2), loaded at the first mount rather than
    when this module is imported."""
    global _LIBC
    if _LIBC is None:
        _LIBC = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                            use_errno=True)
    return _LIBC


def fuse_available() -> bool:
    """Mounting needs /dev/fuse AND mount(2) privilege: this server calls
    mount(2) directly (no fusermount setuid dance), which requires
    CAP_SYS_ADMIN — /dev/fuse alone is world-writable on most distros, so
    an rw-access check would pass for users whose mount would EPERM."""
    return (os.path.exists("/dev/fuse")
            and os.access("/dev/fuse", os.R_OK | os.W_OK)
            and os.geteuid() == 0)


def _errno_of(exc: Exception) -> int:
    code = getattr(exc, "code", "")
    n = getattr(errno_mod, str(code), 0)
    return n if n else errno_mod.EIO


class _Handle:
    __slots__ = ("ino", "flags")

    def __init__(self, ino: int, flags: int):
        self.ino = ino
        self.flags = flags


class FuseServer:
    """One kernel mount of one volume: /dev/fuse fd + dispatch loop."""

    def __init__(self, fs: FsClient, mountpoint: str, volume: str = "",
                 audit_dir: str | None = None):
        from chubaofs_tpu_torch.utils.auditlog import AuditLog

        self.fs = fs
        self.meta = fs.meta
        self.mountpoint = os.path.abspath(mountpoint)
        self.volume = volume or "chubaofs"
        # kernel-mounted access joins the same audit trail as the Mount
        # path (util/auditlog contract): one line per namespace-mutating op
        self.audit = AuditLog(audit_dir) if audit_dir else None
        self.client_id = f"fuse:pid{os.getpid()}"
        self.devfd = -1
        self._next_fh = 1
        self._fhs: dict[int, _Handle] = {}
        # OPENDIR snapshots: fh -> [(name, ino, mode)]. READDIR offsets index
        # the snapshot, so a directory mutated between two READDIR batches
        # never skips or repeats entries within one open handle
        self._dirhs: dict[int, list[tuple[str, int, int]]] = {}
        self._open_count: dict[int, int] = {}
        self._orphans: set[int] = set()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._mounted = False

    # -- mount / serve / unmount ----------------------------------------------

    @staticmethod
    def _disable_vfork_subprocess() -> None:
        """An in-process FUSE mount makes CPython's vfork fast path a
        process-wide deadlock trap: vfork suspends the forking thread —
        WITH the GIL held — until the child execs, and the child's pre-exec
        work can touch THIS process's own mount (chdir to a cwd under it,
        close() of an inherited writable fd sending FLUSH). The kernel then
        waits for the mount's userspace daemon, which is a Python thread
        that needs the very GIL the suspended forker holds: child waits on
        the daemon, daemon waits on the GIL, forker waits on the child.
        Plain fork() has no such window — the parent resumes immediately
        and the daemon serves the child's requests normally — so any
        process that hosts a kernel mount drops the vfork optimization.
        (Observed live: subprocess.run(cwd=<mountpoint>) under the mount's
        own process wedged in kernel_clone with every other thread parked
        on the GIL futex.)"""
        import subprocess

        if hasattr(subprocess, "_USE_VFORK"):
            subprocess._USE_VFORK = False

    def mount(self) -> None:
        self._disable_vfork_subprocess()
        self.devfd = os.open("/dev/fuse", os.O_RDWR)
        try:
            opts = (f"fd={self.devfd},rootmode=40000,user_id={os.getuid()},"
                    f"group_id={os.getgid()},default_permissions,allow_other")
            rc = _libc().mount(self.volume.encode(), self.mountpoint.encode(),
                               b"fuse.chubaofs_tpu_torch", MS_NOSUID | MS_NODEV,
                               opts.encode())
            if rc != 0:
                e = ctypes.get_errno()
                raise OSError(e, f"mount(2): {os.strerror(e)}")
            self._mounted = True
        except BaseException:
            os.close(self.devfd)
            self.devfd = -1
            raise

    def serve_background(self) -> None:
        self._thread = threading.Thread(target=self.serve, daemon=True,
                                        name=f"fuse:{self.mountpoint}")
        self._thread.start()

    def unmount(self) -> None:
        if self._mounted:
            # lazy detach: the serve loop's read() returns ENODEV and exits
            _libc().umount2(self.mountpoint.encode(), MNT_DETACH)
            self._mounted = False
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self.devfd >= 0:
            os.close(self.devfd)
            self.devfd = -1

    def serve(self) -> None:
        bufsize = MAX_WRITE + 0x1000
        while True:
            try:
                req = os.read(self.devfd, bufsize)
            except OSError as e:
                if e.errno == errno_mod.EINTR:
                    continue
                # ENODEV = unmounted; EBADF = fd closed during teardown
                return
            if not req:
                return
            (length, opcode, unique, nodeid, uid, gid, pid,
             _pad) = IN_HEADER.unpack_from(req)
            body = req[IN_HEADER.size:length]
            if opcode in (FUSE_FORGET, FUSE_BATCH_FORGET):
                continue  # reply-less by protocol; we hold no per-ino state
            if opcode == FUSE_INTERRUPT:
                continue  # ops are synchronous; nothing in flight to cancel
            t0 = time.perf_counter()
            err = ""
            # root span per kernel request: SDK/metanode/raft hops below
            # attach their track entries, so one slow VFS call explains
            # itself hop by hop in the slow-op log
            op_label = self._AUDITED.get(opcode, f"op{opcode}")
            span = trace.Span(f"fuse.{op_label}")
            trace.push_span(span)
            try:
                handler = self._DISPATCH.get(opcode)
                if handler is None:
                    err = "ENOSYS"
                    self._reply_err(unique, errno_mod.ENOSYS)
                    continue
                # injected faults surface as errno to the UNMODIFIED program
                # above the VFS (error -> EIO, delay/hang -> a stalled call)
                chaos.failpoint("fuse.dispatch")
                payload = handler(self, nodeid, body, uid, gid)
                self._reply(unique, payload or b"")
            except (FsError, OpError) as e:
                err = str(getattr(e, "code", "EIO"))
                self._reply_err(unique, _errno_of(e))
            except OSError as e:
                err = errno_mod.errorcode.get(e.errno or 0, "EIO")
                self._reply_err(unique, e.errno or errno_mod.EIO)
            except Exception:
                err = "EIO"
                self._reply_err(unique, errno_mod.EIO)
            finally:
                span.append_track_log("fuse", start=t0)
                span.finish()
                trace.pop_span()
                elapsed = time.perf_counter() - t0
                record_slow_op("fuse", op_label, elapsed, span=span, err=err)
                if self.audit is not None and opcode in self._AUDITED:
                    self.audit.log_fs_op(
                        self.client_id, self.volume, self._AUDITED[opcode],
                        f"ino{nodeid}", err=err, latency_us=int(elapsed * 1e6))
            if opcode == FUSE_DESTROY:
                return

    def _reply(self, unique: int, payload: bytes) -> None:
        hdr = OUT_HEADER.pack(OUT_HEADER.size + len(payload), 0, unique)
        os.write(self.devfd, hdr + payload)

    def _reply_err(self, unique: int, err: int) -> None:
        try:
            os.write(self.devfd, OUT_HEADER.pack(OUT_HEADER.size, -err, unique))
        except OSError:
            pass  # unmount raced the reply

    # -- attr helpers ----------------------------------------------------------

    def _inode(self, ino: int):
        try:
            return self.meta.get_inode(ino)
        except OpError as e:
            raise FsError(e.code, f"ino {ino}") from None

    def _attr_bytes(self, inode) -> bytes:
        t = int(inode.mtime)
        tn = int((inode.mtime - t) * 1e9)
        blocks = (inode.size + 511) // 512
        return ATTR.pack(inode.ino, inode.size, blocks, t, t, int(inode.ctime),
                         tn, tn, 0, inode.mode, inode.nlink, inode.uid,
                         inode.gid, 0, 4096, 0)

    def _entry_out(self, inode) -> bytes:
        return ENTRY_OUT.pack(inode.ino, 0, ATTR_TTL_S, ATTR_TTL_S, 0, 0) + \
            self._attr_bytes(inode)

    def _attr_out(self, inode) -> bytes:
        return ATTR_OUT.pack(ATTR_TTL_S, 0, 0) + self._attr_bytes(inode)

    @staticmethod
    def _name(body: bytes) -> str:
        return body.split(b"\0", 1)[0].decode()

    # -- handlers --------------------------------------------------------------

    def _do_init(self, nodeid, body, uid, gid) -> bytes:
        major, minor = struct.unpack_from("<II", body)
        if major != 7:  # kernel re-sends INIT after a bare-version reply
            return INIT_OUT.pack(7, 31, 0, 0, 0, 0, 0, 0, 0, 0, *([0] * 8))
        return INIT_OUT.pack(7, min(minor, 31), 0x20000, FUSE_BIG_WRITES,
                             12, 9, MAX_WRITE, 1, 0, 0, *([0] * 8))

    def _do_lookup(self, nodeid, body, uid, gid) -> bytes:
        try:
            d = self.meta.lookup(nodeid, self._name(body))
        except OpError as e:
            raise FsError(e.code) from None
        return self._entry_out(self._inode(d.ino))

    def _do_getattr(self, nodeid, body, uid, gid) -> bytes:
        return self._attr_out(self._inode(nodeid))

    def _do_setattr(self, nodeid, body, uid, gid) -> bytes:
        (valid, _pad, _fh, size, _lock, _atime, mtime, _ctime, _an, mtn,
         *_rest) = SETATTR_IN.unpack_from(body)
        mode = SETATTR_IN.unpack_from(body)[11]
        kw: dict = {}
        if valid & FATTR_SIZE:
            self.meta.truncate(nodeid, size)
        if valid & FATTR_MODE:
            old = self._inode(nodeid)
            kw["mode"] = (old.mode & ~0o7777) | (mode & 0o7777)
        if valid & FATTR_UID:
            kw["uid"] = SETATTR_IN.unpack_from(body)[13]
        if valid & FATTR_GID:
            kw["gid"] = SETATTR_IN.unpack_from(body)[14]
        if valid & FATTR_MTIME:
            kw["mtime"] = mtime + mtn / 1e9
        if kw:
            self.meta.update_inode(nodeid, **kw)
        return self._attr_out(self._inode(nodeid))

    def _create_child(self, parent: int, name: str, mode: int):
        """Delegates to the ONE create implementation (combined commit or
        two-op fallback with undo, FsClient._create_node)."""
        qids = self.fs._parent_quota_ids(parent)
        return self.fs._create_node(parent, name, mode, qids, name)

    def _do_mknod(self, nodeid, body, uid, gid) -> bytes:
        mode, rdev, _umask, _pad = MKNOD_IN.unpack_from(body)
        if not stat_mod.S_ISREG(mode):
            raise FsError("EPERM", "only regular files")
        name = self._name(body[MKNOD_IN.size:])
        return self._entry_out(self._create_child(nodeid, name, mode))

    def _do_mkdir(self, nodeid, body, uid, gid) -> bytes:
        mode, _umask = MKDIR_IN.unpack_from(body)
        name = self._name(body[MKDIR_IN.size:])
        inode = self._create_child(nodeid, name,
                                   stat_mod.S_IFDIR | (mode & 0o7777))
        return self._entry_out(inode)

    def _do_unlink(self, nodeid, body, uid, gid) -> None:
        name = self._name(body)
        ino, nlink = self.fs._remove_node(nodeid, name, want_dir=False,
                                          path=name)
        if nlink <= 0:
            with self._lock:
                still_open = self._open_count.get(ino, 0) > 0
                if still_open:
                    self._orphans.add(ino)
            if not still_open:
                self.fs.evict_ino(ino)

    def _do_rmdir(self, nodeid, body, uid, gid) -> None:
        name = self._name(body)
        ino, _ = self.fs._remove_node(nodeid, name, want_dir=True, path=name)
        self.meta.evict_inode(ino)

    RENAME_NOREPLACE = 1  # linux/fs.h RENAME_* flags

    def _rename(self, nodeid: int, newdir: int, rest: bytes,
                noreplace: bool = False) -> None:
        src, dst = rest.split(b"\0")[:2]
        try:
            if noreplace and self._exists(newdir, dst.decode()):
                raise FsError("EEXIST", dst.decode())
            displaced = self.meta.rename(
                nodeid, src.decode(), newdir, dst.decode(),
                src_quota_ids=self.fs._parent_quota_ids(nodeid),
                dst_quota_ids=self.fs._parent_quota_ids(newdir))
        except OpError as e:
            raise FsError(e.code) from None
        if not displaced:
            return
        # same contract as _do_unlink: an inode displaced while open joins
        # _orphans and its LAST RELEASE evicts it; otherwise evict now
        ino, nlink, is_dir = displaced
        if not ino:
            return
        if is_dir:
            self.meta.evict_inode(ino)  # empty dir: no open-handle grace
            return
        if nlink <= 0:
            with self._lock:
                still_open = self._open_count.get(ino, 0) > 0
                if still_open:
                    self._orphans.add(ino)
            if not still_open:
                self.fs.evict_ino(ino)

    def _exists(self, parent: int, name: str) -> bool:
        try:
            self.meta.lookup(parent, name)
            return True
        except OpError as e:
            if e.code == "ENOENT":
                return False
            # a transient lookup failure must NOT read as "absent": that
            # would let NOREPLACE clobber the very file it protects
            raise FsError(e.code, name) from None

    def _do_rename(self, nodeid, body, uid, gid) -> None:
        (newdir,) = RENAME_IN.unpack_from(body)
        self._rename(nodeid, newdir, body[RENAME_IN.size:])

    def _do_rename2(self, nodeid, body, uid, gid) -> None:
        newdir, flags, _pad = RENAME2_IN.unpack_from(body)
        if flags & ~self.RENAME_NOREPLACE:  # EXCHANGE/WHITEOUT unsupported
            raise FsError("EINVAL", f"rename2 flags {flags:#x}")
        self._rename(nodeid, newdir, body[RENAME2_IN.size:],
                     noreplace=bool(flags & self.RENAME_NOREPLACE))

    def _do_link(self, nodeid, body, uid, gid) -> bytes:
        (oldnode,) = LINK_IN.unpack_from(body)
        name = self._name(body[LINK_IN.size:])
        try:
            self.meta.link(nodeid, name, oldnode)
        except OpError as e:
            raise FsError(e.code, name) from None
        return self._entry_out(self._inode(oldnode))

    def _open_common(self, ino: int, flags: int) -> bytes:
        inode = self._inode(ino)
        if flags & os.O_TRUNC and not inode.is_dir:
            self.meta.truncate(ino, 0)
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self._fhs[fh] = _Handle(ino, flags)
            self._open_count[ino] = self._open_count.get(ino, 0) + 1
        return OPEN_OUT.pack(fh, 0, 0)

    def _do_open(self, nodeid, body, uid, gid) -> bytes:
        flags, _ = OPEN_IN.unpack_from(body)
        return self._open_common(nodeid, flags)

    def _do_create(self, nodeid, body, uid, gid) -> bytes:
        flags, mode, _umask, _pad = CREATE_IN.unpack_from(body)
        name = self._name(body[CREATE_IN.size:])
        try:
            inode = self._create_child(
                nodeid, name, stat_mod.S_IFREG | (mode & 0o7777))
        except FsError as e:
            # O_CREAT without O_EXCL: losing the race opens the winner's file
            if e.code != "EEXIST" or flags & os.O_EXCL:
                raise
            inode = self._inode(self.meta.lookup(nodeid, name).ino)
        return self._entry_out(inode) + self._open_common(inode.ino, flags)

    def _do_read(self, nodeid, body, uid, gid) -> bytes:
        fh, offset, size, *_ = READ_IN.unpack_from(body)
        h = self._fhs.get(fh)
        if h is None:
            raise FsError("EBADF", str(fh))
        return self.fs.read_at(h.ino, offset, size)

    def _do_write(self, nodeid, body, uid, gid) -> bytes:
        fh, offset, size, *_ = WRITE_IN.unpack_from(body)
        h = self._fhs.get(fh)
        if h is None:
            raise FsError("EBADF", str(fh))
        data = body[WRITE_IN.size:WRITE_IN.size + size]
        self.fs.write_at(h.ino, offset, data)
        return WRITE_OUT.pack(len(data), 0)

    def _do_release(self, nodeid, body, uid, gid) -> None:
        fh, *_ = RELEASE_IN.unpack_from(body)
        with self._lock:
            h = self._fhs.pop(fh, None)
            if h is None:
                return
            n = self._open_count.get(h.ino, 1) - 1
            evict = False
            if n <= 0:
                self._open_count.pop(h.ino, None)
                evict = h.ino in self._orphans
                self._orphans.discard(h.ino)
            else:
                self._open_count[h.ino] = n
        if evict:  # last close of an unlinked file releases it
            self.fs.evict_ino(h.ino)

    def _do_flush(self, nodeid, body, uid, gid) -> None:
        return None  # writes are synchronous end-to-end (Mount.fsync contract)

    def _do_fsync(self, nodeid, body, uid, gid) -> None:
        return None

    def _list_dir(self, nodeid) -> list[tuple[str, int, int]]:
        try:
            dentries = self.meta.read_dir(nodeid)
        except OpError as e:
            raise FsError(e.code) from None
        entries = [(".", nodeid, stat_mod.S_IFDIR),
                   ("..", nodeid, stat_mod.S_IFDIR)]
        entries += [(d.name, d.ino, d.mode) for d in dentries]
        return entries

    def _do_opendir(self, nodeid, body, uid, gid) -> bytes:
        # snapshot the listing into a REAL fh: READDIR resumes by positional
        # offset, and re-fetching on every batch would skip/duplicate entries
        # whenever the directory mutates between batches of a large listing
        entries = self._list_dir(nodeid)
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self._dirhs[fh] = entries
        return OPEN_OUT.pack(fh, 0, 0)

    def _do_readdir(self, nodeid, body, uid, gid) -> bytes:
        fh, offset, size, *_ = READ_IN.unpack_from(body)
        entries = self._dirhs.get(fh)
        if entries is None:  # unknown fh (e.g. server restart): best effort
            entries = self._list_dir(nodeid)
        out = bytearray()
        for i, (name, ino, mode) in enumerate(entries):
            if i < offset:
                continue
            nb = name.encode()
            ent = DIRENT.pack(ino, i + 1, len(nb), (mode >> 12) & 0xF) + nb
            ent += b"\0" * (-len(ent) % 8)
            if len(out) + len(ent) > size:
                break
            out += ent
        return bytes(out)

    def _do_releasedir(self, nodeid, body, uid, gid) -> None:
        fh, *_ = RELEASE_IN.unpack_from(body)
        with self._lock:
            self._dirhs.pop(fh, None)
        return None

    def _do_statfs(self, nodeid, body, uid, gid) -> bytes:
        # capacity numbers are advisory here (master owns real accounting);
        # report a roomy filesystem so tools don't refuse to write
        blocks = 1 << 30
        return KSTATFS.pack(blocks, blocks // 2, blocks // 2, 1 << 20,
                            1 << 20, 4096, 255, 4096, 0, *([0] * 6))

    def _do_setxattr(self, nodeid, body, uid, gid) -> None:
        size, _flags = SETXATTR_IN.unpack_from(body)
        rest = body[SETXATTR_IN.size:]
        name, rest = rest.split(b"\0", 1)
        try:
            self.meta.set_xattr(nodeid, name.decode(), rest[:size])
        except OpError as e:
            raise FsError(e.code) from None

    def _do_getxattr(self, nodeid, body, uid, gid) -> bytes:
        size, _pad = GETXATTR_IN.unpack_from(body)
        name = self._name(body[GETXATTR_IN.size:])
        inode = self._inode(nodeid)
        if name not in inode.xattrs:
            raise FsError("ENODATA", name)
        value = inode.xattrs[name]
        if size == 0:
            return GETXATTR_OUT.pack(len(value), 0)
        if len(value) > size:
            raise FsError("ERANGE", name)
        return value

    def _do_listxattr(self, nodeid, body, uid, gid) -> bytes:
        size, _pad = GETXATTR_IN.unpack_from(body)
        names = b"".join(k.encode() + b"\0"
                         for k in sorted(self._inode(nodeid).xattrs))
        if size == 0:
            return GETXATTR_OUT.pack(len(names), 0)
        if len(names) > size:
            raise FsError("ERANGE")
        return names

    def _do_removexattr(self, nodeid, body, uid, gid) -> None:
        try:
            self.meta.remove_xattr(nodeid, self._name(body))
        except OpError as e:
            raise FsError(e.code) from None

    def _do_destroy(self, nodeid, body, uid, gid) -> None:
        return None

    # namespace-mutating ops carry an audit line (Mount logs the same set);
    # READ/GETATTR/LOOKUP are deliberately unaudited — per-page logging
    # would swamp the trail the way the reference's auditlog never does
    _AUDITED = {
        FUSE_MKNOD: "create", FUSE_CREATE: "create", FUSE_MKDIR: "mkdir",
        FUSE_UNLINK: "unlink", FUSE_RMDIR: "rmdir", FUSE_RENAME: "rename",
        FUSE_RENAME2: "rename", FUSE_LINK: "link", FUSE_SETATTR: "setattr",
        FUSE_SETXATTR: "setxattr", FUSE_REMOVEXATTR: "removexattr",
    }

    _DISPATCH = {
        FUSE_INIT: _do_init,
        FUSE_LOOKUP: _do_lookup,
        FUSE_GETATTR: _do_getattr,
        FUSE_SETATTR: _do_setattr,
        FUSE_MKNOD: _do_mknod,
        FUSE_MKDIR: _do_mkdir,
        FUSE_UNLINK: _do_unlink,
        FUSE_RMDIR: _do_rmdir,
        FUSE_RENAME: _do_rename,
        FUSE_RENAME2: _do_rename2,
        FUSE_LINK: _do_link,
        FUSE_OPEN: _do_open,
        FUSE_CREATE: _do_create,
        FUSE_READ: _do_read,
        FUSE_WRITE: _do_write,
        FUSE_RELEASE: _do_release,
        FUSE_FLUSH: _do_flush,
        FUSE_FSYNC: _do_fsync,
        FUSE_OPENDIR: _do_opendir,
        FUSE_READDIR: _do_readdir,
        FUSE_RELEASEDIR: _do_releasedir,
        FUSE_FSYNCDIR: _do_fsync,
        FUSE_STATFS: _do_statfs,
        FUSE_SETXATTR: _do_setxattr,
        FUSE_GETXATTR: _do_getxattr,
        FUSE_LISTXATTR: _do_listxattr,
        FUSE_REMOVEXATTR: _do_removexattr,
        FUSE_DESTROY: _do_destroy,
    }


def mount_volume(master_addrs: list[str], volume: str, mountpoint: str,
                 access_addrs: list[str] | None = None) -> FuseServer:
    """Dial the cluster, build the volume's FsClient, kernel-mount it.

    The `mount.fuse`-style composition: RemoteCluster -> FsClient ->
    FuseServer.mount() + serve_background(). Caller owns unmount()."""
    from chubaofs_tpu_torch.sdk.cluster import RemoteCluster

    cluster = RemoteCluster(master_addrs, access_addrs=access_addrs)
    fs = cluster.client(volume)
    srv = FuseServer(fs, mountpoint, volume=volume)
    srv.mount()
    srv.serve_background()
    return srv


def main(argv=None) -> int:
    """cfs-fuse: mount a volume at PATH until SIGINT/SIGTERM (fuse.go main)."""
    import argparse

    p = argparse.ArgumentParser(prog="cfs-fuse")
    p.add_argument("--master", required=True, action="append",
                   help="master addr (repeatable)")
    p.add_argument("--volume", required=True)
    p.add_argument("--access", action="append", default=[],
                   help="blobstore access addr for cold volumes")
    p.add_argument("mountpoint")
    args = p.parse_args(argv)
    if not fuse_available():
        print("/dev/fuse unavailable", flush=True)  # obslint: cfs-fuse CLI entry; stdout is the interface
        return 1
    from chubaofs_tpu_torch.utils.shutdown import await_shutdown, shutdown_event

    stop = shutdown_event()
    srv = mount_volume(args.master, args.volume, args.mountpoint,
                       access_addrs=args.access or None)
    print(f'{{"mounted": "{args.mountpoint}", "volume": "{args.volume}"}}',  # obslint: mount line IS the stdout protocol (scripts parse it)
          flush=True)
    await_shutdown(stop)
    srv.unmount()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
