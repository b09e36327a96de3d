"""Typed RPC errors (blobstore/common/rpc error codes analog).

Reference counterpart: common/rpc's Error{Status,Code,Error} JSON body — every
blobstore service returns {"error": msg, "code": code} with an HTTP status;
clients re-hydrate the code. Kept: one exception type carrying status + code +
message, a JSON wire shape, and the well-known code table subset the rebuilt
services use.
"""

from __future__ import annotations

import json


class HTTPError(Exception):
    def __init__(self, status: int, code: str = "", msg: str = ""):
        super().__init__(msg or code or str(status))
        self.status = status
        self.code = code or str(status)
        self.msg = msg or code

    def body(self) -> bytes:
        return json.dumps({"error": self.msg, "code": self.code}).encode()

    @classmethod
    def from_body(cls, status: int, body: bytes) -> "HTTPError":
        try:
            d = json.loads(body.decode() or "{}")
            return cls(status, d.get("code", str(status)), d.get("error", ""))
        except (ValueError, AttributeError):
            return cls(status, str(status), body[:200].decode("utf-8", "replace"))


def err_response(status: int, code: str = "", msg: str = ""):
    raise HTTPError(status, code, msg)


# well-known codes (subset of blobstore/common/rpc/error codes)
CodeBadRequest = "BadRequest"
CodeNotFound = "NotFound"
CodeForbidden = "Forbidden"
CodeUnauthorized = "Unauthorized"
CodeConflict = "Conflict"
CodeInternal = "InternalServerError"
CodeCRCMismatch = "CrcMismatch"
CodeServiceUnavailable = "ServiceUnavailable"
