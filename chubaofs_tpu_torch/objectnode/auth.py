"""S3 signature auth — AWS V4 (SigV4) and V2, sign + verify.

Reference counterpart: objectnode/auth_signature_v4.go and auth_signature_v2.go
(header-based Authorization parsing, canonical request construction, derived
signing key chain) with the check driven from the router wrapper. Both the
verifier (server side) and a signer (client side, like the api clients and the
s3tests harness) live here so the two directions share one canonicalization.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from base64 import b64encode

UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
V4_ALGO = "AWS4-HMAC-SHA256"


class AuthError(Exception):
    pass


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "~" if encode_slash else "~/"
    return urllib.parse.quote(s, safe=safe)


def _canonical_query(raw_query: str, drop: frozenset = frozenset()) -> str:
    pairs = urllib.parse.parse_qsl(raw_query, keep_blank_values=True)
    enc = sorted((_uri_encode(k), _uri_encode(v)) for k, v in pairs
                 if k not in drop)
    return "&".join(f"{k}={v}" for k, v in enc)


# -- SigV4 ---------------------------------------------------------------------

def signing_key(secret: str, date: str, region: str, service: str = "s3") -> bytes:
    k = _hmac(b"AWS4" + secret.encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def canonical_request_v4(method: str, path: str, raw_query: str,
                         headers: dict[str, str], signed_headers: list[str],
                         payload_hash: str) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n" for h in signed_headers)
    return "\n".join([
        method.upper(),
        _uri_encode(path, encode_slash=False) or "/",
        _canonical_query(raw_query),
        canon_headers,
        ";".join(signed_headers),
        payload_hash,
    ])


def string_to_sign_v4(amz_date: str, scope: str, canonical_request: str) -> str:
    digest = hashlib.sha256(canonical_request.encode()).hexdigest()
    return "\n".join([V4_ALGO, amz_date, scope, digest])


def sign_v4(method: str, path: str, raw_query: str, headers: dict[str, str],
            access_key: str, secret_key: str, region: str = "cfs",
            payload: bytes = b"") -> dict[str, str]:
    """Client side: return headers with Authorization et al. attached.

    `headers` must already include `host`; x-amz-date and the payload hash are
    filled in here."""
    import time

    hdrs = {k.lower(): v for k, v in headers.items()}
    # canonicalize from the DECODED path (the server router verifies against
    # its decoded req.path); callers may pass the percent-encoded target
    path = urllib.parse.unquote(path)
    amz_date = hdrs.get("x-amz-date") or time.strftime("%Y%m%dT%H%M%SZ",
                                                       time.gmtime())
    hdrs["x-amz-date"] = amz_date
    hdrs["x-amz-content-sha256"] = hashlib.sha256(payload).hexdigest()
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    signed = sorted(h for h in hdrs
                    if h in ("host", "content-type") or h.startswith("x-amz-"))
    creq = canonical_request_v4(method, path, raw_query, hdrs, signed,
                                hdrs["x-amz-content-sha256"])
    sts = string_to_sign_v4(amz_date, scope, creq)
    sig = hmac.new(signing_key(secret_key, date, region), sts.encode(),
                   hashlib.sha256).hexdigest()
    hdrs["authorization"] = (
        f"{V4_ALGO} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return hdrs


def parse_auth_v4(auth_header: str) -> dict:
    if not auth_header.startswith(V4_ALGO):
        raise AuthError("not a v4 authorization header")
    fields: dict[str, str] = {}
    for item in auth_header[len(V4_ALGO):].split(","):
        k, _, v = item.strip().partition("=")
        fields[k] = v
    try:
        cred = fields["Credential"].split("/")
        return {
            "access_key": cred[0],
            "date": cred[1],
            "region": cred[2],
            "service": cred[3],
            "signed_headers": fields["SignedHeaders"].split(";"),
            "signature": fields["Signature"],
        }
    except (KeyError, IndexError) as e:
        raise AuthError(f"malformed v4 authorization: {e}") from None


def verify_v4(req, secret_key: str) -> bool:
    """req is an rpc Request; verifies header-based SigV4."""
    info = parse_auth_v4(req.header("authorization"))
    payload_hash = req.header("x-amz-content-sha256") or UNSIGNED_PAYLOAD
    if payload_hash not in (UNSIGNED_PAYLOAD,):
        if hashlib.sha256(req.body).hexdigest() != payload_hash:
            return False
    creq = canonical_request_v4(req.method, req.path, req.raw_query,
                                req.headers, info["signed_headers"],
                                payload_hash)
    amz_date = req.header("x-amz-date") or req.header("date")
    scope = f"{info['date']}/{info['region']}/{info['service']}/aws4_request"
    sts = string_to_sign_v4(amz_date, scope, creq)
    key = signing_key(secret_key, info["date"], info["region"], info["service"])
    want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    return hmac.compare_digest(want, info["signature"])


# -- SigV4 presigned URLs (query auth) -----------------------------------------

def presign_v4(method: str, path: str, host: str, access_key: str,
               secret_key: str, region: str = "cfs", expires: int = 900,
               extra_query: str = "", amz_date: str | None = None) -> str:
    """Return the full query string of a presigned-V4 URL for `path`.

    Only `host` is signed (the aws-cli default); the payload is UNSIGNED."""
    import time

    path = urllib.parse.unquote(path)
    amz_date = amz_date or time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    q = {
        "X-Amz-Algorithm": V4_ALGO,
        "X-Amz-Credential": f"{access_key}/{scope}",
        "X-Amz-Date": amz_date,
        "X-Amz-Expires": str(expires),
        "X-Amz-SignedHeaders": "host",
    }
    raw = extra_query + ("&" if extra_query else "") + urllib.parse.urlencode(q)
    creq = canonical_request_v4(method, path, raw, {"host": host}, ["host"],
                                UNSIGNED_PAYLOAD)
    sts = string_to_sign_v4(amz_date, scope, creq)
    sig = hmac.new(signing_key(secret_key, date, region), sts.encode(),
                   hashlib.sha256).hexdigest()
    return raw + "&X-Amz-Signature=" + sig


def verify_presigned_v4(req, secret_key: str) -> bool:
    """Verify a query-auth (presigned) V4 request, including expiry."""
    import time

    import calendar

    q = {k: v[0] for k, v in req.query.items() if v}
    try:
        cred = q["X-Amz-Credential"].split("/")
        amz_date, expires = q["X-Amz-Date"], int(q["X-Amz-Expires"])
        signed_headers = q["X-Amz-SignedHeaders"].split(";")
        sig = q["X-Amz-Signature"]
        t0 = calendar.timegm(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
        date, region, service = cred[1], cred[2], cred[3]
    except (KeyError, IndexError, ValueError):
        return False  # malformed presigned params = failed auth, never a 500
    if time.time() > t0 + expires:
        return False
    raw = _canonical_query(req.raw_query, drop=frozenset(("X-Amz-Signature",)))
    creq = canonical_request_v4(req.method, req.path, raw, req.headers,
                                signed_headers, UNSIGNED_PAYLOAD)
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = string_to_sign_v4(amz_date, scope, creq)
    key = signing_key(secret_key, date, region, service)
    want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    return hmac.compare_digest(want, sig)


# -- SigV2 ---------------------------------------------------------------------

_V2_SUBRESOURCES = ("acl", "cors", "delete", "lifecycle", "location", "policy",
                    "tagging", "uploads", "uploadId", "partNumber",
                    "versionId", "versioning", "versions")


def _canonical_resource_v2(path: str, raw_query: str) -> str:
    qs = urllib.parse.parse_qsl(raw_query, keep_blank_values=True)
    keep = sorted((k, v) for k, v in qs if k in _V2_SUBRESOURCES)
    out = path or "/"
    if keep:
        out += "?" + "&".join(k if v == "" else f"{k}={v}" for k, v in keep)
    return out


def string_to_sign_v2(method: str, path: str, raw_query: str,
                      headers: dict[str, str]) -> str:
    amz = sorted((k, v) for k, v in headers.items() if k.startswith("x-amz-"))
    amz_lines = "".join(f"{k}:{v}\n" for k, v in amz)
    return (f"{method.upper()}\n{headers.get('content-md5', '')}\n"
            f"{headers.get('content-type', '')}\n{headers.get('date', '')}\n"
            f"{amz_lines}{_canonical_resource_v2(path, raw_query)}")


def sign_v2(method: str, path: str, raw_query: str, headers: dict[str, str],
            access_key: str, secret_key: str) -> dict[str, str]:
    hdrs = {k.lower(): v for k, v in headers.items()}
    sts = string_to_sign_v2(method, urllib.parse.unquote(path), raw_query, hdrs)
    sig = b64encode(hmac.new(secret_key.encode(), sts.encode(),
                             hashlib.sha1).digest()).decode()
    hdrs["authorization"] = f"AWS {access_key}:{sig}"
    return hdrs


def verify_v2(req, secret_key: str) -> bool:
    auth = req.header("authorization")
    if not auth.startswith("AWS ") or ":" not in auth:
        return False
    _, sig = auth[4:].rsplit(":", 1)
    sts = string_to_sign_v2(req.method, req.path, req.raw_query, req.headers)
    want = b64encode(hmac.new(secret_key.encode(), sts.encode(),
                              hashlib.sha1).digest()).decode()
    return hmac.compare_digest(want, sig)


def presign_v2(method: str, path: str, access_key: str, secret_key: str,
               expires_at: int, subresource_query: str = "") -> str:
    """Query string of a V2 presigned URL (AWSAccessKeyId/Expires/Signature).

    `subresource_query` is any signed subresource the URL targets (e.g.
    "versionId=x"); it is part of the canonical resource, so the URL holder
    cannot retarget the signature at a different subresource."""
    path = urllib.parse.unquote(path)
    resource = _canonical_resource_v2(path, subresource_query)
    sts = f"{method.upper()}\n\n\n{expires_at}\n{resource}"
    sig = b64encode(hmac.new(secret_key.encode(), sts.encode(),
                             hashlib.sha1).digest()).decode()
    out = {"AWSAccessKeyId": access_key, "Expires": expires_at, "Signature": sig}
    q = urllib.parse.urlencode(out)
    return f"{subresource_query}&{q}" if subresource_query else q


def verify_presigned_v2(req, secret_key: str) -> bool:
    import time

    try:
        expires_at = int(req.query["Expires"][0])
        sig = req.query["Signature"][0]
    except (KeyError, IndexError, ValueError):
        return False
    if time.time() > expires_at:
        return False
    # the canonical resource includes the request's signed subresources
    # (auth params like Signature/Expires aren't in _V2_SUBRESOURCES, so the
    # filter drops them automatically)
    resource = _canonical_resource_v2(req.path, req.raw_query)
    sts = f"{req.method.upper()}\n\n\n{expires_at}\n{resource}"
    want = b64encode(hmac.new(secret_key.encode(), sts.encode(),
                              hashlib.sha1).digest()).decode()
    return hmac.compare_digest(want, sig)


def is_presigned(req) -> bool:
    return "X-Amz-Signature" in req.query or "Signature" in req.query


def verify_presigned(req, secret_key: str) -> bool:
    if "X-Amz-Signature" in req.query:
        return verify_presigned_v4(req, secret_key)
    return verify_presigned_v2(req, secret_key)


def access_key_of(req) -> str | None:
    """Pull the access key out of any auth flavor (router pre-step)."""
    auth = req.header("authorization")
    if auth.startswith(V4_ALGO):
        try:
            return parse_auth_v4(auth)["access_key"]
        except AuthError:
            return None
    if auth.startswith("AWS ") and ":" in auth:
        return auth[4:].rsplit(":", 1)[0]
    # presigned flavors carry the key in the query
    cred = req.query.get("X-Amz-Credential")
    if cred:
        return cred[0].split("/")[0]
    ak = req.query.get("AWSAccessKeyId")
    if ak:
        return ak[0]
    return None
