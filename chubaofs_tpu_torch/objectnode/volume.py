"""Bucket-on-volume object semantics (objectnode/fs_volume.go analog).

Reference counterpart: objectnode/fs_volume.go — `Volume.PutObject` (:596)
maps an S3 key to a filesystem path inside the bucket's volume, creating
implicit intermediate directories; object metadata (etag, content type, user
meta, tags, ACL) live as xattrs on the object inode; listing walks the
directory tree in key order. Delete prunes now-empty parent directories so
phantom CommonPrefixes don't outlive their objects.
"""

from __future__ import annotations

import hashlib
import json
import time

from chubaofs_tpu_torch.sdk.fs import FsClient, FsError

XATTR_ETAG = "oss:etag"
XATTR_CONTENT_TYPE = "oss:content-type"
XATTR_USER_META = "oss:meta"
XATTR_TAGGING = "oss:tagging"
XATTR_DIR_MARKER = "oss:dir"
XATTR_VERSIONING = "oss:versioning"  # bucket: "Enabled" | "Suspended"
XATTR_VERSION_ID = "oss:version-id"  # current object's version id
XATTR_DELETE_MARKER = "oss:delete-marker"

DEFAULT_CONTENT_TYPE = "application/octet-stream"
VERSIONS_ROOT = ".versions"  # hidden prefix hosting archived versions


class NoSuchKey(Exception):
    pass


class ReservedKey(Exception):
    """Key addresses the hidden version store — not a legal object key."""


def _guard_key(key: str):
    if key == VERSIONS_ROOT or key.startswith(VERSIONS_ROOT + "/"):
        raise ReservedKey(key)


def _etag(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


class OSSVolume:
    """One bucket == one volume; verbs the S3 handlers call."""

    def __init__(self, fs: FsClient, bucket: str, owner: str = ""):
        self.fs = fs
        self.bucket = bucket
        self.owner = owner

    # -- write -------------------------------------------------------------------

    def put_object(self, key: str, data: bytes, content_type: str = "",
                   user_meta: dict | None = None, etag: str | None = None) -> str:
        _guard_key(key)
        if key.endswith("/"):
            # directory marker object (the console/aws-cli "create folder" shape)
            ino_path = "/" + key.rstrip("/")
            self.fs.mkdirs(ino_path)
            self.fs.setxattr(ino_path, XATTR_DIR_MARKER, b"1")
            self.fs.setxattr(ino_path, XATTR_ETAG, _etag(b"").encode())
            return _etag(b"")
        path = "/" + key
        parent = path.rsplit("/", 1)[0]
        if parent:
            self.fs.mkdirs(parent)
        self.fs.write_file(path, data)
        tag = etag or _etag(data)
        self.fs.setxattr(path, XATTR_ETAG, tag.encode())
        self.fs.setxattr(path, XATTR_CONTENT_TYPE,
                         (content_type or DEFAULT_CONTENT_TYPE).encode())
        if user_meta:
            self.fs.setxattr(path, XATTR_USER_META, json.dumps(user_meta).encode())
        return tag

    # -- read --------------------------------------------------------------------

    def info(self, key: str) -> dict:
        _guard_key(key)
        path = "/" + key.rstrip("/")
        try:
            st = self.fs.stat(path)
        except FsError:
            raise NoSuchKey(key) from None
        if st["is_dir"]:
            # only explicit dir markers are objects
            try:
                self.fs.getxattr(path, XATTR_DIR_MARKER)
            except FsError:
                raise NoSuchKey(key) from None
        out = {"key": key, "size": 0 if st["is_dir"] else st["size"],
               "mtime": st["mtime"], "is_dir": st["is_dir"],
               "etag": "", "content_type": DEFAULT_CONTENT_TYPE, "meta": {}}
        for xk, field in ((XATTR_ETAG, "etag"), (XATTR_CONTENT_TYPE, "content_type")):
            try:
                out[field] = self.fs.getxattr(path, xk).decode()
            except FsError:
                pass
        try:
            out["meta"] = json.loads(self.fs.getxattr(path, XATTR_USER_META))
        except FsError:
            pass
        return out

    def get_object(self, key: str, offset: int = 0, size: int | None = None) -> bytes:
        info = self.info(key)
        if info["is_dir"]:
            return b""
        try:
            return self.fs.read_file("/" + key, offset, size)
        except FsError:
            raise NoSuchKey(key) from None

    # -- delete ------------------------------------------------------------------

    def delete_object(self, key: str) -> None:
        """Idempotent like S3 DeleteObject (no error on missing key)."""
        _guard_key(key)
        path = "/" + key.rstrip("/")
        try:
            st = self.fs.stat(path)
        except FsError:
            return
        try:
            if st["is_dir"]:
                self.fs.rmdir(path)
            else:
                self.fs.unlink(path)
        except FsError:
            return  # non-empty dir marker: S3 leaves the prefix alive
        self._prune_empty_parents(path)

    def _prune_empty_parents(self, path: str):
        parts = [p for p in path.split("/") if p][:-1]
        while parts:
            parent = "/" + "/".join(parts)
            try:
                if self.fs.readdir(parent):
                    return
                # keep explicit dir markers even when empty
                try:
                    self.fs.getxattr(parent, XATTR_DIR_MARKER)
                    return
                except FsError:
                    pass
                self.fs.rmdir(parent)
            except FsError:
                return
            parts.pop()

    # -- tagging -----------------------------------------------------------------

    def get_tagging(self, key: str) -> dict:
        self.info(key)
        try:
            return json.loads(self.fs.getxattr("/" + key.rstrip("/"), XATTR_TAGGING))
        except FsError:
            return {}

    def set_tagging(self, key: str, tags: dict):
        self.info(key)
        self.fs.setxattr("/" + key.rstrip("/"), XATTR_TAGGING,
                         json.dumps(tags).encode())

    def delete_tagging(self, key: str):
        self.info(key)
        self.fs.removexattr("/" + key.rstrip("/"), XATTR_TAGGING)

    # -- object xattr passthrough (ref objectnode SetXAttr/GetXAttr/DeleteXAttr/
    # ListXAttrs, fs_volume.go:288-459). Deliberate divergence from the
    # reference: internal oss:* keys (ACL, etag, version ids, delete markers)
    # are NOT reachable through this API — the reference exposes them raw, but
    # here the ACL/versioning engines key their permission checks off those
    # xattrs, so a plain-WRITE principal writing oss:acl would bypass the
    # WRITE_ACP/READ_ACP split. The version store is guarded like every other
    # object verb. --------------------------------------------------------------

    _XATTR_INTERNAL = "oss:"

    def _xattr_path(self, key: str, name: str | None = None) -> str:
        _guard_key(key)
        if name is not None and name.startswith(self._XATTR_INTERNAL):
            raise ReservedKey(name)
        self.info(key)  # real objects only, like the tagging verbs (404 else)
        return "/" + key.rstrip("/")

    def set_xattr(self, key: str, name: str, value: bytes):
        self.fs.setxattr(self._xattr_path(key, name), name, value)

    def get_xattr(self, key: str, name: str) -> bytes:
        return self.fs.getxattr(self._xattr_path(key, name), name)

    def delete_xattr(self, key: str, name: str):
        self.fs.removexattr(self._xattr_path(key, name), name)

    def list_xattrs(self, key: str) -> list[str]:
        return [k for k in self.fs.listxattr(self._xattr_path(key))
                if not k.startswith(self._XATTR_INTERNAL)]

    # -- xattr passthrough for bucket-level configs (acl/policy/cors) ------------

    def get_bucket_xattr(self, key: str) -> bytes | None:
        try:
            return self.fs.getxattr("/", key)
        except FsError:
            return None

    def set_bucket_xattr(self, key: str, value: bytes):
        self.fs.setxattr("/", key, value)

    def del_bucket_xattr(self, key: str):
        self.fs.removexattr("/", key)

    # -- versioning (objectnode versioning semantics) ------------------------------
    #
    # Archived versions live under the hidden /.versions/<quoted-key>/<vid>
    # tree: an archive is ONE rename (the inode keeps its xattrs), never a data
    # copy. Version ids are zero-padded hex timestamps, so lexicographic order
    # IS recency order. A delete under versioning archives the current object
    # and records a delete-marker entry.

    def versioning_status(self) -> str:
        raw = self.get_bucket_xattr(XATTR_VERSIONING)
        return raw.decode() if raw else ""

    def set_versioning(self, status: str):
        if status not in ("Enabled", "Suspended"):
            raise ValueError(f"bad versioning status {status!r}")
        self.set_bucket_xattr(XATTR_VERSIONING, status.encode())

    @staticmethod
    def new_version_id() -> str:
        return f"{time.time_ns():020x}"

    def _vdir(self, key: str) -> str:
        import urllib.parse

        return f"/{VERSIONS_ROOT}/" + urllib.parse.quote(key, safe="")

    def archive_current(self, key: str) -> str | None:
        """Move the live object into the version store; returns its version id
        (the one it carried, or a fresh 'null'-era id), None if absent."""
        path = "/" + key
        try:
            st = self.fs.stat(path)
        except FsError:
            return None
        if st["is_dir"]:
            return None
        try:
            vid = self.fs.getxattr(path, XATTR_VERSION_ID).decode()
        except FsError:
            vid = self.new_version_id()
        self.fs.mkdirs(self._vdir(key))
        self.fs.rename(path, f"{self._vdir(key)}/{vid}")
        self._prune_empty_parents(path)
        return vid

    def put_delete_marker(self, key: str) -> str:
        vid = self.new_version_id()
        self.fs.mkdirs(self._vdir(key))
        marker = f"{self._vdir(key)}/{vid}"
        self.fs.write_file(marker, b"")
        self.fs.setxattr(marker, XATTR_DELETE_MARKER, b"1")
        return vid

    def list_versions(self, prefix: str = "") -> list[dict]:
        """All versions of all keys, newest first per key, currents included."""
        import urllib.parse

        out: list[dict] = []
        keys: set[str] = set()
        try:
            names = self.fs.readdir("/" + VERSIONS_ROOT)
        except FsError:
            names = []
        for quoted in names:
            key = urllib.parse.unquote(quoted)
            if prefix and not key.startswith(prefix):
                continue
            keys.add(key)
        contents, _, _, _ = self.list_objects(prefix=prefix, max_keys=100000)
        current_by_key = {o["key"]: o for o in contents}
        for key in sorted(keys | set(current_by_key)):
            entries = []
            cur = current_by_key.get(key)
            if cur is not None:
                vid = "null"
                try:
                    vid = self.fs.getxattr("/" + key, XATTR_VERSION_ID).decode()
                except FsError:
                    pass
                entries.append({"key": key, "version_id": vid, "is_latest": True,
                                "delete_marker": False, "size": cur["size"],
                                "mtime": cur["mtime"],
                                "etag": cur.get("etag", "")})
            vdir = self._vdir(key)
            try:
                vids = sorted(self.fs.readdir(vdir), reverse=True)
            except FsError:
                vids = []
            for i, vid in enumerate(vids):
                vp = f"{vdir}/{vid}"
                st = self.fs.stat(vp)
                marker = False
                try:
                    self.fs.getxattr(vp, XATTR_DELETE_MARKER)
                    marker = True
                except FsError:
                    pass
                etag = ""
                try:
                    etag = self.fs.getxattr(vp, XATTR_ETAG).decode()
                except FsError:
                    pass
                entries.append({"key": key, "version_id": vid,
                                "is_latest": cur is None and i == 0,
                                "delete_marker": marker, "size": st["size"],
                                "mtime": st["mtime"], "etag": etag})
            out.extend(entries)
        return out

    def _current_vid(self, key: str) -> str | None:
        try:
            return self.fs.getxattr("/" + key, XATTR_VERSION_ID).decode()
        except FsError:
            return None

    def _is_current(self, key: str, version_id: str) -> bool:
        """'null' names the current object only when it carries NO real
        version id (S3 null-version identity)."""
        cur = self._current_vid(key)
        return version_id == cur or (version_id == "null" and cur is None)

    def stat_version(self, key: str, version_id: str) -> dict:
        """Metadata of one version (current or archived) WITHOUT reading its
        body; raises NoSuchKey if absent or a delete marker."""
        if self._is_current(key, version_id):
            return self.info(key)
        vp = f"{self._vdir(key)}/{version_id}"
        try:
            st = self.fs.stat(vp)
        except FsError:
            raise NoSuchKey(f"{key}?versionId={version_id}") from None
        try:
            self.fs.getxattr(vp, XATTR_DELETE_MARKER)
            raise NoSuchKey(f"{key}?versionId={version_id} is a delete marker")
        except FsError:
            pass
        info = {"key": key, "size": st["size"], "mtime": st["mtime"],
                "is_dir": False, "etag": "", "meta": {},
                "content_type": DEFAULT_CONTENT_TYPE}
        for xk, field in ((XATTR_ETAG, "etag"), (XATTR_CONTENT_TYPE, "content_type")):
            try:
                info[field] = self.fs.getxattr(vp, xk).decode()
            except FsError:
                pass
        return info

    def read_version(self, key: str, version_id: str, offset: int = 0,
                     size: int | None = None) -> bytes:
        if self._is_current(key, version_id):
            return self.get_object(key, offset, size)
        vp = f"{self._vdir(key)}/{version_id}"
        try:
            return self.fs.read_file(vp, offset, size)
        except FsError:
            raise NoSuchKey(f"{key}?versionId={version_id}") from None

    def get_version(self, key: str, version_id: str) -> tuple[bytes, dict]:
        info = self.stat_version(key, version_id)
        return self.read_version(key, version_id), info

    def delete_version(self, key: str, version_id: str) -> None:
        """Permanently remove one version (current or archived); idempotent.
        Deleting the CURRENT version promotes the newest archived non-marker
        version back to live (S3: the previous version becomes latest)."""
        if self._is_current(key, version_id):
            self.delete_object(key)
            self._promote_newest(key)
            return
        vp = f"{self._vdir(key)}/{version_id}"
        try:
            self.fs.unlink(vp)
        except FsError:
            return
        try:
            if not self.fs.readdir(self._vdir(key)):
                self.fs.rmdir(self._vdir(key))
        except FsError:
            pass

    def _promote_newest(self, key: str) -> None:
        """Move the newest archived version back to the live path — unless it
        is a delete marker (then the key stays logically deleted)."""
        vdir = self._vdir(key)
        try:
            vids = sorted(self.fs.readdir(vdir), reverse=True)
        except FsError:
            return
        if not vids:
            return
        vp = f"{vdir}/{vids[0]}"
        try:
            self.fs.getxattr(vp, XATTR_DELETE_MARKER)
            return  # a marker stays latest: the key remains deleted
        except FsError:
            pass
        path = "/" + key
        parent = path.rsplit("/", 1)[0]
        if parent:
            self.fs.mkdirs(parent)
        self.fs.rename(vp, path)  # xattrs (etag, vid, meta) travel with it
        self.fs.setxattr(path, XATTR_VERSION_ID, vids[0].encode())
        try:
            if not self.fs.readdir(vdir):
                self.fs.rmdir(vdir)
        except FsError:
            pass

    # -- listing -----------------------------------------------------------------

    def _walk(self, dirpath: str, out: list[dict]):
        """DFS in lexicographic order; emits files and dir-marker dirs."""
        for name in sorted(self.fs.readdir(dirpath or "/")):
            if dirpath == "" and name == VERSIONS_ROOT:
                continue  # the version store is not part of the namespace
            child = f"{dirpath}/{name}"
            st = self.fs.stat(child)
            key = child.lstrip("/")
            if st["is_dir"]:
                try:
                    self.fs.getxattr(child, XATTR_DIR_MARKER)
                    out.append({"key": key + "/", "size": 0, "mtime": st["mtime"]})
                except FsError:
                    pass
                self._walk(child, out)
            else:
                out.append({"key": key, "size": st["size"], "mtime": st["mtime"]})

    def list_objects(self, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000):
        """Returns (contents, common_prefixes, is_truncated, next_marker).

        Flat walk + in-memory filtering: correct for the full S3 semantics
        (prefix, delimiter grouping, marker resume, max-keys truncation). The
        walk starts from the deepest directory implied by the prefix so cost
        scales with the listed subtree, not the bucket."""
        base = ""
        if "/" in prefix:
            cand = prefix.rsplit("/", 1)[0]
            try:
                if self.fs.stat("/" + cand)["is_dir"]:
                    base = "/" + cand
            except FsError:
                return [], [], False, ""
        everything: list[dict] = []
        try:
            self._walk(base, everything)
        except FsError:
            return [], [], False, ""

        contents: list[dict] = []
        prefixes: list[str] = []
        seen_prefixes: set[str] = set()
        truncated = False
        next_marker = ""
        for obj in everything:
            key = obj["key"]
            if prefix and not key.startswith(prefix):
                continue
            # marker compares against the ROLLED-UP name: with a delimiter,
            # keys that group into CommonPrefix "a/" are represented by "a/"
            # itself, so marker="a/" (a NextMarker that was a prefix) skips
            # the whole group instead of re-emitting it forever
            rolled = key
            if delimiter:
                rest = key[len(prefix):]
                if delimiter in rest:
                    rolled = prefix + rest.split(delimiter, 1)[0] + delimiter
            if marker and rolled <= marker:
                continue
            if delimiter:
                rest = key[len(prefix):]
                if delimiter in rest:
                    cp = rolled
                    if cp not in seen_prefixes:
                        if len(contents) + len(seen_prefixes) >= max_keys:
                            truncated = True
                            break
                        seen_prefixes.add(cp)
                        prefixes.append(cp)
                        next_marker = cp  # resume point may be a prefix too
                    continue
            if len(contents) + len(seen_prefixes) >= max_keys:
                truncated = True
                break
            # etag lazily — only for emitted keys
            try:
                obj = dict(obj, etag=self.fs.getxattr(
                    "/" + key.rstrip("/"), XATTR_ETAG).decode())
            except FsError:
                obj = dict(obj, etag="")
            contents.append(obj)
            next_marker = key
        return contents, prefixes, truncated, (next_marker if truncated else "")

    def is_empty(self) -> bool:
        names = [n for n in self.fs.readdir("/")]
        return not names

    @staticmethod
    def http_time(ts: float) -> str:
        return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts))
