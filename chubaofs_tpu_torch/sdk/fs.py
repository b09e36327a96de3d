"""FsClient — the POSIX-ish filesystem facade over meta + data planes.

Reference counterpart: the client-side verbs of libsdk/libsdk.go (cfs_open,
cfs_read, cfs_write, cfs_mkdirs, ...) and client/fs (file.go Read/Write via the
extent client, dir.go). Data placement follows the volume's tier:

  * cold volumes write file data through the blobstore access gateway (EC on
    the GPU) and record the signed locations as obj_extents — the
    sdk/data/blobstore writer.go:472 + ObjExtentKey flow;
  * hot volumes write through the extent client to replicated datanodes
    (chubaofs_tpu_torch/data) and record ExtentKeys.

Paths resolve component-by-component through MetaWrapper (the FUSE-side icache
is a straightforward addition; kept out of the core verbs)."""

from __future__ import annotations

import stat as stat_mod

from chubaofs_tpu_torch.meta.metanode import OpError
from chubaofs_tpu_torch.meta.partition import ROOT_INO
from chubaofs_tpu_torch.sdk.meta_wrapper import MetaWrapper


class FsError(Exception):
    def __init__(self, code: str, msg: str = ""):
        super().__init__(f"{code}: {msg}")
        self.code = code


class VolQos:
    """Per-volume client throttle, rates owned by the MASTER (volume view
    qos_read_mbps/qos_write_mbps; ref master/limiter.go assignment flowing
    to clients). Shapes rather than rejects: callers block until tokens
    arrive. 0 = unlimited. With a `fetch` closure (() -> (read_mbps,
    write_mbps), normally a master get_volume call), limits RE-ARM every
    REFRESH_SECS from the data path — so tightening QoS on a misbehaving
    tenant reaches live clients without rebuilding them, at one metadata
    call per interval."""

    REFRESH_SECS = 30.0

    def __init__(self, read_mbps: int = 0, write_mbps: int = 0, fetch=None):
        import time as _time

        from chubaofs_tpu_torch.utils.ratelimit import TokenBucket

        self.read = TokenBucket(read_mbps * (1 << 20))
        self.write = TokenBucket(write_mbps * (1 << 20))
        self._fetch = fetch
        self._next_fetch = _time.monotonic() + self.REFRESH_SECS

    @classmethod
    def from_view(cls, vol, fetch=None) -> "VolQos | None":
        """The one construction policy for both local and remote clients:
        with a fetch closure, always build (an unlimited volume may gain
        limits later); without one, only when a limit is set now."""
        if fetch is None and not (vol.qos_read_mbps or vol.qos_write_mbps):
            return None
        return cls(vol.qos_read_mbps, vol.qos_write_mbps, fetch=fetch)

    def refresh(self, read_mbps: int, write_mbps: int) -> None:
        self.read.rate = float(read_mbps * (1 << 20))
        self.read.burst = max(self.read.rate, 1.0)
        self.write.rate = float(write_mbps * (1 << 20))
        self.write.burst = max(self.write.rate, 1.0)

    def _maybe_refetch(self) -> None:
        import time as _time

        if self._fetch is None or _time.monotonic() < self._next_fetch:
            return
        self._next_fetch = _time.monotonic() + self.REFRESH_SECS
        try:
            r, w = self._fetch()
            self.refresh(r, w)
        except Exception:
            pass  # keep the last-known limits through master hiccups

    def _charge(self, bucket, nbytes: int) -> None:
        self._maybe_refetch()
        if bucket.rate <= 0:
            return  # unlimited: never loop per-byte against a 1-token burst
        # charge in burst-sized chunks: one huge IO must pay for ALL its
        # bytes (a single clamped acquire would let any write <= burst
        # through untouched), while still never requesting more than the
        # bucket can physically accrue
        while nbytes > 0:
            take = min(nbytes, bucket.burst)
            bucket.acquire(take)
            nbytes -= int(take)

    def throttle_read(self, nbytes: int) -> None:
        self._charge(self.read, nbytes)

    def throttle_write(self, nbytes: int) -> None:
        self._charge(self.write, nbytes)


class FsClient:
    def __init__(self, meta: MetaWrapper, data_backend, hot_backend=None,
                 cold: bool = True, bcache=None, qos: "VolQos | None" = None):
        """Cold volumes: data_backend implements write(data)->location_json,
        read(location_json, offset, size)->bytes, delete(location_json).
        Hot volumes: hot_backend is a chubaofs_tpu_torch.sdk.stream.HotBackend
        (write(ino, offset, data), read(ino, offset, size), delete(ino, keys)).
        bcache: optional BcacheClient — cold reads go read-through local cache
        (sdk/data/blobstore/reader.go:30,66 bcache hooks). Cache keys hash the
        extent LOCATION (immutable identity), not (ino, offset): a truncate +
        rewrite reuses offsets but never locations, so stale hits are
        impossible by construction."""
        self.meta = meta
        self.data = data_backend
        self.hot = hot_backend
        self.cold = cold or hot_backend is None
        self.bcache = bcache
        self.qos = qos  # master-assigned per-volume throttle (VolQos)

    # -- path resolution --------------------------------------------------------

    def resolve(self, path: str) -> int:
        ino = ROOT_INO
        for part in [p for p in path.split("/") if p]:
            try:
                d = self.meta.lookup(ino, part)
            except OpError as e:
                raise FsError(e.code, path) from None
            ino = d.ino
        return ino

    def _resolve_parent(self, path: str) -> tuple[int, str]:
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise FsError("EINVAL", "root")
        parent = ROOT_INO
        for part in parts[:-1]:
            parent = self.meta.lookup(parent, part).ino
        return parent, parts[-1]

    # -- directory verbs --------------------------------------------------------

    def _parent_quota_ids(self, parent: int) -> list[int]:
        try:
            return self.meta.quota_ids_of(parent)
        except OpError:
            return []

    def _undo_create(self, ino: int) -> None:
        """A failed dentry insert must not leak the fresh inode."""
        try:
            self.meta.unlink_inode(ino)
            self.meta.evict_inode(ino)
        except OpError:
            pass  # freelist sweeps catch stragglers

    def _create_node(self, parent: int, name: str, mode: int,
                     qids: list[int], path: str):
        """Create inode+dentry under parent, returning the Inode: ONE
        combined commit when the tail partition owns the parent
        (MetaWrapper.create_file), else the two-op flow with the
        undo-on-conflict contract. The ONE create implementation — the
        FUSE server delegates here too."""
        try:
            inode = self.meta.create_file(parent, name, mode, quota_ids=qids)
        except OpError as e:
            raise FsError(e.code, path) from None
        if inode is not None:
            return inode
        inode = self.meta.create_inode(mode, quota_ids=qids)
        try:
            self.meta.create_dentry(parent, name, inode.ino, inode.mode,
                                    quota_ids=qids)
        except OpError as e:
            self._undo_create(inode.ino)
            raise FsError(e.code, path) from None
        return inode

    def mkdir(self, path: str, mode: int = 0o755) -> int:
        parent, name = self._resolve_parent(path)
        qids = self._parent_quota_ids(parent)
        return self._create_node(parent, name, stat_mod.S_IFDIR | mode,
                                 qids, path).ino

    def mkdirs(self, path: str, mode: int = 0o755) -> int:
        """mkdir -p (libsdk cfs_mkdirs analog); returns the leaf inode."""
        ino = ROOT_INO
        for part in [p for p in path.split("/") if p]:
            try:
                d = self.meta.lookup(ino, part)
                if not stat_mod.S_ISDIR(d.mode):
                    raise FsError("ENOTDIR", path)
                ino = d.ino
            except OpError:
                qids = self._parent_quota_ids(ino)
                child = self.meta.create_inode(stat_mod.S_IFDIR | mode,
                                               quota_ids=qids)
                try:
                    self.meta.create_dentry(ino, part, child.ino, child.mode,
                                            quota_ids=qids)
                    ino = child.ino
                except OpError:
                    # lost a create race: take whoever won
                    self._undo_create(child.ino)
                    ino = self.meta.lookup(ino, part).ino
        return ino

    def readdir(self, path: str) -> list[str]:
        try:
            return [d.name for d in self.meta.read_dir(self.resolve(path))]
        except OpError as e:
            raise FsError(e.code, path) from None

    def _remove_node(self, parent: int, name: str, want_dir: bool,
                     path: str) -> tuple[int, int]:
        """Remove dentry + drop a link, returning (ino, nlink_after): ONE
        combined commit when one partition owns parent and child (also
        saving the pre-lookup round-trip), else the lookup + per-op flow.
        The ONE remove implementation — the FUSE server delegates here."""
        qids = self._parent_quota_ids(parent)
        try:
            res = self.meta.remove_entry(parent, name, want_dir,
                                         quota_ids=qids)
            if res is not None:
                return res
            # cross-partition child: classic flow
            d = self.meta.lookup(parent, name)
            if stat_mod.S_ISDIR(d.mode) != want_dir:
                raise FsError("ENOTDIR" if want_dir else "EISDIR", path)
            self.meta.delete_dentry(parent, name, quota_ids=qids)
            inode = self.meta.unlink_inode(d.ino)
        except OpError as e:
            raise FsError(e.code, path) from None
        return d.ino, inode.nlink

    def rmdir(self, path: str) -> None:
        parent, name = self._resolve_parent(path)
        ino, _ = self._remove_node(parent, name, want_dir=True, path=path)
        self.meta.evict_inode(ino)

    # -- file verbs --------------------------------------------------------------

    def create(self, path: str, mode: int = 0o644) -> int:
        parent, name = self._resolve_parent(path)
        qids = self._parent_quota_ids(parent)
        return self._create_node(parent, name, stat_mod.S_IFREG | mode,
                                 qids, path).ino

    def write_file(self, path: str, data: bytes) -> int:
        """Whole-file write (create-or-truncate), the common S3/batch shape."""
        try:
            ino = self.resolve(path)
            self.meta.truncate(ino, 0)
        except FsError:
            ino = self.create(path)
        if data:
            self.write_at(ino, 0, data)
        return ino

    def append_file(self, path: str, data: bytes) -> int:
        try:
            ino = self.resolve(path)
        except FsError:
            ino = self.create(path)
        if data:
            self.write_at(ino, self.meta.get_inode(ino).size, data)
        return ino

    def write_at(self, ino: int, offset: int, data: bytes) -> None:
        """Positional write, tier-dispatched (file.go:367-439 Write analog)."""
        if self.qos is not None:
            self.qos.throttle_write(len(data))
        try:
            if not self.cold:
                self.hot.write(ino, offset, data)
                return
            if offset != self.meta.get_inode(ino).size:
                raise FsError("EINVAL", "cold volumes are append-only")
            loc = self.data.write(data)
            self.meta.append_obj_extents(
                ino, [{"loc": loc, "size": len(data)}], offset + len(data))
        except OpError as e:  # e.g. EDQUOT from the quota charge
            raise FsError(e.code, f"ino {ino}") from None

    def read_file(self, path: str, offset: int = 0, size: int | None = None) -> bytes:
        return self.read_at(self.resolve(path), offset, size)

    def read_at(self, ino: int, offset: int = 0, size: int | None = None) -> bytes:
        """Positional read by inode — open files stay readable after their
        path is unlinked (the client orphan-inode contract)."""
        try:
            inode = self.meta.get_inode(ino)
        except OpError as e:
            raise FsError(e.code, f"ino {ino}") from None
        if size is None:
            size = inode.size - offset
        size = max(0, min(size, inode.size - offset))
        if self.qos is not None and size:
            self.qos.throttle_read(size)
        if not self.cold:
            return self.hot.read(inode.ino, offset, size)
        out = bytearray()
        pos = 0
        for ext in inode.obj_extents:
            ext_size = ext["size"]
            lo, hi = pos, pos + ext_size
            pos = hi
            if hi <= offset or lo >= offset + size:
                continue
            s = max(0, offset - lo)
            e = min(ext_size, offset + size - lo)
            out += self._read_extent(ext, s, e - s, ext_size)
        return bytes(out)

    # extents above this bypass the cache: a miss would otherwise turn a tiny
    # range read into a full-extent EC reconstruct + a cache fill that a
    # capacity-bounded LRU evicts straight away (thrash)
    BCACHE_MAX_EXTENT = 8 << 20

    def _read_extent(self, ext: dict, start: int, length: int,
                     ext_size: int) -> bytes:
        """One cold extent read, through the local block cache when present."""
        if self.bcache is None or ext_size > self.BCACHE_MAX_EXTENT:
            return self.data.read(ext["loc"], start, length)
        import hashlib

        key = "loc_" + hashlib.sha256(ext["loc"].encode()).hexdigest()[:32]
        blk = self.bcache.get(key, start, length)
        if blk is not None and len(blk) == length:
            return blk
        whole = self.data.read(ext["loc"], 0, ext_size)
        self.bcache.put(key, whole)
        return whole[start:start + length]

    def unlink(self, path: str, evict: bool = True) -> int:
        """Remove the dentry + drop a link. evict=False keeps the inode alive
        for holders of open handles (client orphan list); the caller must
        evict_ino() on last close. Returns the inode id."""
        parent, name = self._resolve_parent(path)
        ino, _ = self._remove_node(parent, name, want_dir=False, path=path)
        if evict:
            self.meta.evict_inode(ino)
        return ino

    def evict_ino(self, ino: int) -> None:
        """Release an orphaned inode once its last open handle closes."""
        try:
            self.meta.evict_inode(ino)
        except OpError as e:
            raise FsError(e.code, f"ino {ino}") from None

    def rename(self, src: str, dst: str, evict_displaced: bool = True):
        """POSIX replace semantics: an existing destination is displaced.
        With evict_displaced (default, mirrors unlink(evict=True)) a fully
        unlinked displaced inode is evicted here; callers holding their own
        open-handle tables (Mount, the FUSE server) pass False and apply
        their orphan contract to the returned (ino, nlink, is_dir)."""
        sp, sn = self._resolve_parent(src)
        dp, dn = self._resolve_parent(dst)
        try:
            displaced = self.meta.rename(
                sp, sn, dp, dn,
                src_quota_ids=self._parent_quota_ids(sp),
                dst_quota_ids=self._parent_quota_ids(dp))
        except OpError as e:
            raise FsError(e.code, f"{src} -> {dst}") from None
        if displaced and evict_displaced:
            ino, nlink, is_dir = displaced
            if ino and (is_dir or nlink <= 0):
                self.evict_ino(ino)
        return displaced

    def stat(self, path: str) -> dict:
        try:
            inode = self.meta.get_inode(self.resolve(path))
        except OpError as e:
            raise FsError(e.code, path) from None
        return {
            "ino": inode.ino,
            "mode": inode.mode,
            "size": inode.size,
            "nlink": inode.nlink,
            "uid": inode.uid,
            "gid": inode.gid,
            "mtime": inode.mtime,
            "is_dir": inode.is_dir,
        }

    def link(self, existing: str, new: str) -> None:
        ino = self.resolve(existing)
        parent, name = self._resolve_parent(new)
        try:
            self.meta.link(parent, name, ino)
        except OpError as e:
            raise FsError(e.code, new) from None

    def setxattr(self, path: str, key: str, value: bytes) -> None:
        try:
            self.meta.set_xattr(self.resolve(path), key, value)
        except OpError as e:
            raise FsError(e.code, path) from None

    def getxattr(self, path: str, key: str) -> bytes:
        try:
            inode = self.meta.get_inode(self.resolve(path))
        except OpError as e:
            raise FsError(e.code, path) from None
        if key not in inode.xattrs:
            raise FsError("ENODATA", key)
        return inode.xattrs[key]

    def removexattr(self, path: str, key: str) -> None:
        try:
            self.meta.remove_xattr(self.resolve(path), key)
        except OpError as e:
            raise FsError(e.code, path) from None

    def listxattr(self, path: str) -> list[str]:
        """All extended-attribute keys on path (ref objectnode ListXAttrs)."""
        try:
            inode = self.meta.get_inode(self.resolve(path))
        except OpError as e:
            raise FsError(e.code, path) from None
        return sorted(inode.xattrs)
