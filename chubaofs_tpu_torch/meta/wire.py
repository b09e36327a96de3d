"""Tagged wire/state encoding for metanode values.

Results and snapshot records carry dataclasses (Inode/Dentry/ExtentKey) and
bytes; this tagged encoding round-trips them through JSON (the packet wire,
meta/service.py) and through raft.codec (snapshot sections) identically.
Reference counterpart: the request/response struct marshaling of
sdk/meta/operation.go + metanode inode/dentry binary marshal methods.
"""

from __future__ import annotations

import base64

from chubaofs_tpu_torch.meta.partition import Dentry, ExtentKey, Inode


def enc(v):
    if isinstance(v, Inode):
        d = {k: enc(getattr(v, k)) for k in (
            "ino", "mode", "uid", "gid", "size", "nlink", "ctime", "mtime",
            "extents", "obj_extents", "xattrs")}
        return {"__inode__": d}
    if isinstance(v, Dentry):
        return {"__dentry__": {"parent": v.parent, "name": v.name,
                               "ino": v.ino, "mode": v.mode}}
    if isinstance(v, ExtentKey):
        return {"__ek__": {"file_offset": v.file_offset, "size": v.size,
                           "partition_id": v.partition_id,
                           "extent_id": v.extent_id,
                           "extent_offset": v.extent_offset}}
    if isinstance(v, (bytes, bytearray)):
        return {"__bytes__": base64.b64encode(bytes(v)).decode()}
    if isinstance(v, tuple):
        return {"__tuple__": [enc(x) for x in v]}
    if isinstance(v, list):
        return [enc(x) for x in v]
    if isinstance(v, dict):
        return {k: enc(x) for k, x in v.items()}
    return v


def dec(v):
    if isinstance(v, dict):
        if "__inode__" in v:
            d = {k: dec(x) for k, x in v["__inode__"].items()}
            return Inode(**d)
        if "__dentry__" in v:
            return Dentry(**v["__dentry__"])
        if "__ek__" in v:
            return ExtentKey(**v["__ek__"])
        if "__bytes__" in v:
            return base64.b64decode(v["__bytes__"])
        if "__tuple__" in v:
            return tuple(dec(x) for x in v["__tuple__"])
        return {k: dec(x) for k, x in v.items()}
    if isinstance(v, list):
        return [dec(x) for x in v]
    return v
