"""S3 multipart uploads (objectnode multipart + metanode multipart state).

Reference counterpart: objectnode's multipart handlers backed by metanode
multipart sessions (SURVEY §2.1 metanode "multipart state for S3"). Parts are
written straight to the data backend (EC on the GPU for cold volumes) and their
locations parked in the raft-replicated session; CompleteMultipartUpload
LINKS the part locations into the final inode's obj_extents — completion is
zero-copy, no concatenation read-back. Cold volumes only: the hot tier's
extent keys are inode-bound, so the reference routes multipart to EC volumes
too.
"""

from __future__ import annotations

import hashlib

from chubaofs_tpu_torch.meta.metanode import OpError
from chubaofs_tpu_torch.objectnode.volume import (
    XATTR_CONTENT_TYPE, XATTR_ETAG, DEFAULT_CONTENT_TYPE, OSSVolume,
)


class NoSuchUpload(Exception):
    pass


class InvalidPart(Exception):
    pass


def _parts(session: dict) -> dict[int, dict]:
    """A session's parts by part number. Over the metanode's packet wire the
    session dict travels as JSON, whose object keys are strings: read them
    back as the ints they were stored as (0 is the sidecar entry)."""
    return {int(num): info for num, info in session["parts"].items()}


class MultipartManager:
    def __init__(self, vol: OSSVolume, data_backend):
        self.vol = vol
        self.meta = vol.fs.meta
        self.data = data_backend

    def initiate(self, key: str, content_type: str = "") -> str:
        upload_id = self.meta.multipart_create(key)
        if content_type:
            # session metadata rides a sidecar entry in the same session dict
            self.meta.multipart_put_part(upload_id, 0, {
                "content_type": content_type})
        return upload_id

    def put_part(self, upload_id: str, part_num: int, data: bytes) -> str:
        if part_num < 1 or part_num > 10000:
            raise InvalidPart(f"part number {part_num} out of [1, 10000]")
        etag = hashlib.md5(data).hexdigest()
        loc = self.data.write(data)
        try:
            old = self.meta.multipart_put_part(upload_id, part_num, {
                "loc": loc, "size": len(data), "etag": etag})
        except OpError:
            self.data.delete(loc)
            raise NoSuchUpload(upload_id) from None
        if old and "loc" in old:
            # retried part upload: reclaim the superseded data now
            try:
                self.data.delete(old["loc"])
            except Exception:
                pass
        return etag

    def list_parts(self, upload_id: str) -> tuple[str, list[dict]]:
        try:
            session = self.meta.multipart_get(upload_id)
        except OpError:
            raise NoSuchUpload(upload_id) from None
        parts = [dict(info, part_number=num)
                 for num, info in sorted(_parts(session).items()) if num != 0]
        return session["key"], parts

    def list_uploads(self) -> list[dict]:
        return [{"upload_id": uid, "key": s["key"]}
                for uid, s in sorted(self.meta.multipart_list().items())]

    def complete(self, upload_id: str, parts_spec: list[tuple[int, str]]) -> tuple[str, str]:
        """parts_spec: client-ordered [(part_number, etag)]. Returns (key, etag)."""
        try:
            session = self.meta.multipart_get(upload_id)
        except OpError:
            raise NoSuchUpload(upload_id) from None
        have = _parts(session)
        ordered = []
        md5s = b""
        for num, etag in parts_spec:
            info = have.get(num)
            if info is None or info["etag"].strip('"') != etag.strip('"'):
                raise InvalidPart(f"part {num}")
            ordered.append(info)
            md5s += bytes.fromhex(info["etag"])
        if not ordered:
            raise InvalidPart("no parts")
        final_etag = f"{hashlib.md5(md5s).hexdigest()}-{len(ordered)}"

        key = session["key"]
        path = "/" + key
        parent = path.rsplit("/", 1)[0]
        if parent:
            self.vol.fs.mkdirs(parent)
        fs = self.vol.fs
        try:
            ino = fs.resolve(path)
            fs.meta.truncate(ino, 0)
        except Exception:
            ino = fs.create(path)
        size = 0
        locations = []
        for info in ordered:
            locations.append({"loc": info["loc"], "size": info["size"]})
            size += info["size"]
        fs.meta.append_obj_extents(ino, locations, size)
        fs.setxattr(path, XATTR_ETAG, final_etag.encode())
        ct = (have.get(0) or {}).get("content_type", "")
        fs.setxattr(path, XATTR_CONTENT_TYPE, (ct or DEFAULT_CONTENT_TYPE).encode())
        # unused parts (uploaded but not listed in the complete spec) are orphan
        # data: delete them now, then drop the session
        linked = {info["loc"] for info in ordered}
        session = self.meta.multipart_complete(upload_id)
        for info in _parts(session).values():
            if "loc" in info and info["loc"] not in linked:
                try:
                    self.data.delete(info["loc"])
                except Exception:
                    pass
        return key, final_etag

    def abort(self, upload_id: str) -> None:
        try:
            session = self.meta.multipart_abort(upload_id)
        except OpError:
            raise NoSuchUpload(upload_id) from None
        for num, info in _parts(session).items():
            if "loc" in info:
                try:
                    self.data.delete(info["loc"])
                except Exception:
                    pass
