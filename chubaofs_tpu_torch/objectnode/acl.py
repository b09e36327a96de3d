"""S3 ACL engine (objectnode/acl*.go analog).

Reference counterpart: objectnode's ACL handling — canned ACLs
(x-amz-acl header) and grant XML, stored per bucket/object and consulted
before policy evaluation. Stored here as JSON in the `oss:acl` xattr of the
bucket root / object inode. Permissions follow the S3 model: READ, WRITE,
READ_ACP, WRITE_ACP, FULL_CONTROL.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

XATTR_ACL = "oss:acl"

ALL_USERS = "*"  # the AllUsers group URI, shortened
PERM_READ = "READ"
PERM_WRITE = "WRITE"
PERM_READ_ACP = "READ_ACP"
PERM_WRITE_ACP = "WRITE_ACP"
PERM_FULL = "FULL_CONTROL"

CANNED = {
    "private": [],
    "public-read": [(ALL_USERS, PERM_READ)],
    "public-read-write": [(ALL_USERS, PERM_READ), (ALL_USERS, PERM_WRITE)],
    "authenticated-read": [("authenticated", PERM_READ)],
}


@dataclass
class ACL:
    owner: str
    grants: list[tuple[str, str]] = field(default_factory=list)  # (grantee, perm)

    @classmethod
    def canned(cls, owner: str, name: str) -> "ACL":
        if name not in CANNED:
            raise ValueError(f"unknown canned acl {name!r}")
        return cls(owner, list(CANNED[name]))

    def allows(self, principal: str | None, perm: str) -> bool:
        if principal == self.owner:
            return True
        for grantee, granted in self.grants:
            if granted not in (perm, PERM_FULL):
                continue
            if grantee == ALL_USERS:
                return True
            if grantee == "authenticated" and principal is not None:
                return True
            if grantee == principal:
                return True
        return False

    def to_json(self) -> bytes:
        return json.dumps({"owner": self.owner, "grants": self.grants}).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "ACL":
        d = json.loads(raw.decode())
        return cls(d["owner"], [tuple(g) for g in d["grants"]])

    def to_xml(self) -> str:
        grants = "".join(
            f"<Grant><Grantee>{g}</Grantee><Permission>{p}</Permission></Grant>"
            for g, p in ([(self.owner, PERM_FULL)] + self.grants))
        return (f'<AccessControlPolicy><Owner><ID>{self.owner}</ID></Owner>'
                f"<AccessControlList>{grants}</AccessControlList>"
                f"</AccessControlPolicy>")
