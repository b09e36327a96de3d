"""S3 bucket policy engine (objectnode/policy*.go analog).

Reference counterpart: objectnode's ~3k-LoC policy engine — JSON bucket
policies with Version/Statement[], each statement Effect Allow|Deny,
Principal, Action (s3:* wildcards), Resource (arn wildcards), evaluated
deny-overrides. Stored as the `oss:policy` xattr on the bucket root inode.
Condition operators are out of scope here (the reference supports a subset;
the evaluation order and wildcard semantics below are the load-bearing part).
"""

from __future__ import annotations

import fnmatch
import json

XATTR_POLICY = "oss:policy"

ALLOW = "Allow"
DENY = "Deny"

# objectnode action names: s3:GetObject, s3:PutObject, ...
ACTION_GET = "s3:GetObject"
ACTION_PUT = "s3:PutObject"
ACTION_DELETE = "s3:DeleteObject"
ACTION_LIST = "s3:ListBucket"


class PolicyError(ValueError):
    pass


def _as_list(v) -> list:
    return v if isinstance(v, list) else [v]


class Policy:
    def __init__(self, doc: dict):
        if "Statement" not in doc:
            raise PolicyError("policy missing Statement")
        self.doc = doc
        for st in _as_list(doc["Statement"]):
            if st.get("Effect") not in (ALLOW, DENY):
                raise PolicyError(f"bad Effect {st.get('Effect')!r}")
            if "Action" not in st or "Resource" not in st:
                raise PolicyError("statement missing Action/Resource")

    @classmethod
    def from_json(cls, raw: bytes) -> "Policy":
        try:
            return cls(json.loads(raw.decode()))
        except (ValueError, AttributeError) as e:
            raise PolicyError(str(e)) from None

    def to_json(self) -> bytes:
        return json.dumps(self.doc).encode()

    @staticmethod
    def _principal_matches(st: dict, principal: str | None) -> bool:
        p = st.get("Principal", "*")
        if p == "*" or p == {"AWS": "*"}:
            return True
        values = p.get("AWS", []) if isinstance(p, dict) else p
        return principal is not None and principal in _as_list(values)

    @staticmethod
    def _matches(patterns, value: str) -> bool:
        return any(fnmatch.fnmatchcase(value, pat) for pat in _as_list(patterns))

    def evaluate(self, action: str, resource: str, principal: str | None) -> str | None:
        """Returns Allow, Deny, or None (no statement matched).

        resource is "bucket" or "bucket/key"; statement resources use the
        arn:aws:s3::: prefix or the bare form — both accepted. Deny overrides.
        """
        verdict = None
        for st in _as_list(self.doc["Statement"]):
            if not self._principal_matches(st, principal):
                continue
            if not self._matches(st["Action"], action):
                continue
            resources = [r.removeprefix("arn:aws:s3:::")
                         for r in _as_list(st["Resource"])]
            if not self._matches(resources, resource):
                continue
            if st["Effect"] == DENY:
                return DENY
            verdict = ALLOW
        return verdict
