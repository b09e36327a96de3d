"""ObjectNode — the S3-compatible gateway (objectnode/ analog).

Reference counterpart: objectnode/router.go:26 (gorilla/mux routing of the S3
action set), api_handler_object.go:1172 (putObjectHandler),
fs_volume.go:596 (Volume.PutObject), auth_signature_v2.go/v4.go, the
policy/acl/cors/tagging engines, objectnode/server.go. Buckets map 1:1 onto
volumes; object data rides the same meta+data planes as the POSIX client —
EC on the GPU for cold volumes — so S3 and FUSE views of a volume agree
(CHANGELOG.md:12's blobstore docking).

Supported S3 actions (~60): ListBuckets, Create/Delete/Head Bucket,
GetBucketLocation, ListObjects V1/V2 (continuation tokens, delimiters),
Put/Get/Head/Delete Object, CopyObject (COPY/REPLACE metadata directive),
DeleteObjects (batch + Quiet), Range GET, GetObjectAttributes,
Bucket+Object ACL (grant XML + canned x-amz-acl), Bucket Policy +
GetBucketPolicyStatus, Bucket CORS (+ preflight), Bucket+Object Tagging,
full multipart (Initiate/UploadPart/UploadPartCopy with source ranges/
List/Complete/Abort/ListUploads), Bucket Versioning (Put/Get,
ListObjectVersions, versionId GET/HEAD/DELETE, delete markers, Suspended
semantics), Bucket Lifecycle (Put/Get/Delete + expiry sweeper),
presigned URLs (SigV4 query auth and SigV2 Expires/Signature).
"""

from __future__ import annotations

import base64
import re
import urllib.parse
import xml.etree.ElementTree as ET
from xml.sax.saxutils import escape as esc

from chubaofs_tpu_torch.objectnode import auth as s3auth
from chubaofs_tpu_torch.objectnode.acl import ACL, XATTR_ACL
from chubaofs_tpu_torch.objectnode.cors import CORSConfig, XATTR_CORS
from chubaofs_tpu_torch.objectnode.multipart import (
    InvalidPart, MultipartManager, NoSuchUpload,
)
from chubaofs_tpu_torch.objectnode.policy import (
    ACTION_DELETE, ACTION_GET, ACTION_LIST, ACTION_PUT, ALLOW, DENY, Policy,
    PolicyError, XATTR_POLICY,
)
from chubaofs_tpu_torch.objectnode.volume import NoSuchKey, OSSVolume, ReservedKey
from chubaofs_tpu_torch.rpc import Response, Router
from chubaofs_tpu_torch.rpc.router import Request
from chubaofs_tpu_torch.sdk.fs import FsError


XATTR_LIFECYCLE = "oss:lifecycle"


class S3Error(Exception):
    def __init__(self, status: int, code: str, msg: str = ""):
        super().__init__(code)
        self.status = status
        self.code = code
        self.msg = msg or code


def _xml_error(e: S3Error, resource: str = "") -> Response:
    body = (f"<Error><Code>{esc(e.code)}</Code><Message>{esc(e.msg)}</Message>"
            f"<Resource>{esc(resource)}</Resource></Error>")
    return Response.xml(body, e.status)


def _parse_xml(body: bytes) -> ET.Element:
    """Parse an S3 request body, stripping the S3 namespace: boto/aws-cli send
    xmlns=http://s3.amazonaws.com/doc/2006-03-01/ and ElementTree would
    otherwise tag every element as {ns}Name. Malformed input is the client's
    fault — 400 MalformedXML, never a 500."""
    try:
        root = ET.fromstring(body.decode())
    except (ET.ParseError, UnicodeDecodeError) as e:
        raise S3Error(400, "MalformedXML", str(e)) from None
    for el in root.iter():
        el.tag = re.sub(r"^\{.*\}", "", el.tag)
    return root


def _text(el, tag: str, default: str = "") -> str:
    child = el.find(tag)
    return child.text or default if child is not None else default


def _etag_matches(header: str, etag: str) -> bool:
    """RFC 9110 If-(None-)Match list: `*`, or any listed etag equal to the
    object's — quoted or bare, weak prefixes tolerated (crc etags here are
    always strong, so W/ comparison degenerates to equality)."""
    for v in header.split(","):
        v = v.strip()
        if v == "*":
            return True
        if v.startswith("W/"):
            v = v[2:]
        if v.strip('"') == etag:
            return True
    return False


# sub-resources the reference routes to unsupportedOperationHandler
# (router.go; v3.2.1 also lists lifecycle/versioning/versions there, which
# THIS gateway implements)
_UNSUPPORTED_BUCKET_QUERIES = (
    "object-lock", "encryption", "website", "publicAccessBlock",
    "requestPayment", "replication",
)
_UNSUPPORTED_OBJECT_QUERIES = ("legal-hold", "retention", "torrent", "restore")


class ObjectNode:
    """cluster must provide: create_volume(name, cold), delete_volume(name),
    volume_names(), client(name) -> FsClient, data_backend. FsCluster does."""

    def __init__(self, cluster, users: dict[str, dict] | None = None,
                 region: str = "cfs", anonymous_ok: bool = False,
                 qos=None):
        self.cluster = cluster
        # users: access_key -> {"secret_key": ..., "uid": ...}
        self.users = users or {}
        self.region = region
        self.anonymous_ok = anonymous_ok
        self._vols: dict[str, OSSVolume] = {}
        self.router = self._build_router()
        # per-tenant QoS plane: pass one explicitly or arm via
        # CFS_QOS_* env. Unarmed (the default) installs NO middleware —
        # zero per-request overhead, not a disabled check
        from chubaofs_tpu_torch.utils.qos import QosPlane

        self.qos = qos if qos is not None else QosPlane.from_env()
        if self.qos is not None:
            self.router.middleware.append(self._qos_middleware)

    def _qos_middleware(self, req: Request, nxt):
        """Admission/shaping BEFORE auth: tenant identity is the claimed
        sigv4 access key (throttling must cost less than the HMAC chain it
        protects — the signature check still rejects forgeries afterward).
        Request-body bytes charge the bandwidth plane up front; response
        bytes are debited after, driving the tenant's bucket negative
        until the debt refills."""
        tenant = s3auth.access_key_of(req)
        deny = self.qos.admit(tenant, len(req.body))
        if deny is not None:
            return deny
        resp = nxt(req)
        self.qos.debit_out(tenant, len(resp.body))
        return resp

    # -- volume plumbing ---------------------------------------------------------

    def _vol(self, bucket: str) -> OSSVolume:
        vol = self._vols.get(bucket)
        if vol is None:
            try:
                fs = self.cluster.client(bucket)
            except Exception:
                raise S3Error(404, "NoSuchBucket", bucket) from None
            vol = self._vols[bucket] = OSSVolume(fs, bucket)
        return vol

    def _mpu(self, bucket: str) -> MultipartManager:
        return MultipartManager(self._vol(bucket), self.cluster.data_backend)

    # -- auth --------------------------------------------------------------------

    def _authenticate(self, req: Request) -> str | None:
        """Returns the principal uid, or None for anonymous."""
        ak = s3auth.access_key_of(req)
        if ak is None:
            if self.anonymous_ok or not self.users:
                return None
            raise S3Error(403, "AccessDenied", "anonymous access disabled")
        user = self.users.get(ak)
        if user is None:
            raise S3Error(403, "InvalidAccessKeyId", ak)
        sk = user["secret_key"]
        if s3auth.is_presigned(req):
            # query-string auth (presigned URLs), expiry enforced
            if not s3auth.verify_presigned(req, sk):
                raise S3Error(403, "SignatureDoesNotMatch",
                              "presigned signature invalid or expired")
            return user.get("uid", ak)
        authz = req.header("authorization")
        ok = (s3auth.verify_v4(req, sk) if authz.startswith(s3auth.V4_ALGO)
              else s3auth.verify_v2(req, sk))
        if not ok:
            raise S3Error(403, "SignatureDoesNotMatch")
        return user.get("uid", ak)

    def _check(self, req: Request, bucket: str, action: str, key: str = "",
               perm: str | None = None):
        """Owner → policy (deny-overrides) → object ACL → bucket ACL → deny.

        perm names the ACL permission to demand; defaults to READ/WRITE by
        action. ACL mutation handlers pass READ_ACP/WRITE_ACP — a plain WRITE
        grant must NOT allow rewriting ACLs (S3's ACP permission split)."""
        principal = self._authenticate(req)
        vol = self._vol(bucket)
        if principal is not None and principal == self._owner(vol):
            return principal
        raw = vol.get_bucket_xattr(XATTR_POLICY)
        if raw:
            resource = f"{bucket}/{key}" if key else bucket
            verdict = Policy.from_json(raw).evaluate(action, resource, principal)
            if verdict == DENY:
                raise S3Error(403, "AccessDenied", "denied by bucket policy")
            if verdict == ALLOW:
                return principal
        if perm is None:
            perm = "READ" if action in (ACTION_GET, ACTION_LIST) else "WRITE"
        if key:
            try:
                raw = vol.fs.getxattr("/" + key.rstrip("/"), XATTR_ACL)
                if ACL.from_json(raw).allows(principal, perm):
                    return principal
            except FsError:
                pass
        raw = vol.get_bucket_xattr(XATTR_ACL)
        if raw:
            if ACL.from_json(raw).allows(principal, perm):
                return principal
        if principal is None and not self.users:
            return None  # wide-open dev mode: no user table configured
        raise S3Error(403, "AccessDenied")

    def _owner(self, vol: OSSVolume) -> str:
        raw = vol.get_bucket_xattr(XATTR_ACL)
        if raw:
            return ACL.from_json(raw).owner
        return vol.owner

    # -- router ------------------------------------------------------------------

    def _build_router(self) -> Router:
        r = Router()
        w = self._wrap
        # service
        r.get("/", w(self.list_buckets))
        # bucket sub-resources (query-matched routes bind tighter)
        r.get("/:bucket", w(self.get_bucket_location), queries={"location": None})
        r.get("/:bucket", w(self.get_bucket_acl), queries={"acl": None})
        r.put("/:bucket", w(self.put_bucket_acl), queries={"acl": None})
        r.get("/:bucket", w(self.get_bucket_policy_status),
              queries={"policyStatus": None})
        r.get("/:bucket", w(self.get_bucket_policy), queries={"policy": None})
        r.put("/:bucket", w(self.put_bucket_policy), queries={"policy": None})
        r.delete("/:bucket", w(self.delete_bucket_policy), queries={"policy": None})
        r.get("/:bucket", w(self.get_bucket_cors), queries={"cors": None})
        r.put("/:bucket", w(self.put_bucket_cors), queries={"cors": None})
        r.delete("/:bucket", w(self.delete_bucket_cors), queries={"cors": None})
        r.get("/:bucket", w(self.get_bucket_tagging), queries={"tagging": None})
        r.put("/:bucket", w(self.put_bucket_tagging), queries={"tagging": None})
        r.delete("/:bucket", w(self.delete_bucket_tagging), queries={"tagging": None})
        r.get("/:bucket", w(self.list_uploads), queries={"uploads": None})
        r.get("/:bucket", w(self.get_bucket_versioning), queries={"versioning": None})
        r.put("/:bucket", w(self.put_bucket_versioning), queries={"versioning": None})
        r.get("/:bucket", w(self.list_object_versions), queries={"versions": None})
        r.get("/:bucket", w(self.get_bucket_lifecycle), queries={"lifecycle": None})
        r.put("/:bucket", w(self.put_bucket_lifecycle), queries={"lifecycle": None})
        r.delete("/:bucket", w(self.delete_bucket_lifecycle),
                 queries={"lifecycle": None})
        r.get("/:bucket", w(self.list_objects_v2), queries={"list-type": "2"})
        r.post("/:bucket", w(self.delete_objects), queries={"delete": None})
        # unimplemented sub-resources answer 501 NotImplemented explicitly so
        # they can't fall through to the catch-all core routes (e.g. a
        # ?replication GET must not run ListObjects) — ref router.go registers
        # unsupportedOperationHandler for exactly these (api_handler.go:130)
        for q in _UNSUPPORTED_BUCKET_QUERIES:
            for meth in ("GET", "PUT", "DELETE"):
                r.handle(meth, "/:bucket", w(self.unsupported), queries={q: None})
        for q in _UNSUPPORTED_OBJECT_QUERIES:
            for meth in ("GET", "PUT", "DELETE", "POST"):
                r.handle(meth, "/:bucket/*key", w(self.unsupported),
                         queries={q: None})
        # bucket core
        r.get("/:bucket", w(self.list_objects_v1))
        r.put("/:bucket", w(self.create_bucket))
        r.delete("/:bucket", w(self.delete_bucket))
        r.head("/:bucket", w(self.head_bucket))
        r.handle("OPTIONS", "/:bucket", w(self.preflight))
        # object sub-resources
        r.get("/:bucket/*key", w(self.get_object_attributes),
              queries={"attributes": None})
        r.get("/:bucket/*key", w(self.get_object_acl), queries={"acl": None})
        r.put("/:bucket/*key", w(self.put_object_acl), queries={"acl": None})
        r.get("/:bucket/*key", w(self.get_object_tagging), queries={"tagging": None})
        r.put("/:bucket/*key", w(self.put_object_tagging), queries={"tagging": None})
        r.delete("/:bucket/*key", w(self.delete_object_tagging),
                 queries={"tagging": None})
        # object xattr (CubeFS-owned API, ref router.go:77-91,340-345; GET
        # branches on ?key= between single-get and list inside the handler)
        r.get("/:bucket/*key", w(self.get_object_xattr), queries={"xattr": None})
        r.put("/:bucket/*key", w(self.put_object_xattr), queries={"xattr": None})
        r.delete("/:bucket/*key", w(self.delete_object_xattr),
                 queries={"xattr": None})
        # multipart
        r.post("/:bucket/*key", w(self.initiate_multipart), queries={"uploads": None})
        r.put("/:bucket/*key", w(self.upload_part),
              queries={"partNumber": None, "uploadId": None})
        r.get("/:bucket/*key", w(self.list_parts), queries={"uploadId": None})
        r.post("/:bucket/*key", w(self.complete_multipart), queries={"uploadId": None})
        r.delete("/:bucket/*key", w(self.abort_multipart), queries={"uploadId": None})
        # object core
        r.put("/:bucket/*key", w(self.put_object))
        r.get("/:bucket/*key", w(self.get_object))
        r.head("/:bucket/*key", w(self.head_object))
        r.delete("/:bucket/*key", w(self.delete_object))
        r.handle("OPTIONS", "/:bucket/*key", w(self.preflight))
        return r

    def _wrap(self, fn):
        def handler(req: Request):
            try:
                return fn(req)
            except S3Error as e:
                return _xml_error(e, req.path)
            except NoSuchKey as e:
                return _xml_error(S3Error(404, "NoSuchKey", str(e)), req.path)
            except ReservedKey as e:
                return _xml_error(
                    S3Error(400, "InvalidArgument", f"key {e} is reserved"),
                    req.path)
            except NoSuchUpload as e:
                return _xml_error(S3Error(404, "NoSuchUpload", str(e)), req.path)
            except InvalidPart as e:
                return _xml_error(S3Error(400, "InvalidPart", str(e)), req.path)
            except PolicyError as e:
                return _xml_error(S3Error(400, "MalformedPolicy", str(e)), req.path)
            except FsError as e:
                code = "NoSuchKey" if e.code == "ENOENT" else "InternalError"
                status = 404 if e.code == "ENOENT" else 500
                return _xml_error(S3Error(status, code, str(e)), req.path)
        return handler

    # -- service -----------------------------------------------------------------

    def list_buckets(self, req: Request):
        self._authenticate(req)
        names = self.cluster.volume_names()
        buckets = "".join(
            f"<Bucket><Name>{esc(n)}</Name><CreationDate></CreationDate></Bucket>"
            for n in sorted(names))
        return Response.xml(
            "<ListAllMyBucketsResult><Buckets>"
            f"{buckets}</Buckets></ListAllMyBucketsResult>")

    # -- bucket ------------------------------------------------------------------

    def create_bucket(self, req: Request):
        principal = self._authenticate(req)
        bucket = req.params["bucket"]
        if bucket in self.cluster.volume_names():
            raise S3Error(409, "BucketAlreadyExists", bucket)
        self.cluster.create_volume(bucket, cold=True)
        vol = self._vol(bucket)
        canned = req.header("x-amz-acl", "private")
        vol.set_bucket_xattr(XATTR_ACL, ACL.canned(principal or "", canned).to_json())
        return Response(200, {"Location": f"/{bucket}"})

    def head_bucket(self, req: Request):
        self._authenticate(req)
        self._vol(req.params["bucket"])
        return Response(200)

    def delete_bucket(self, req: Request):
        bucket = req.params["bucket"]
        vol = self._vol(bucket)
        self._check(req, bucket, ACTION_DELETE)
        if not vol.is_empty():
            raise S3Error(409, "BucketNotEmpty", bucket)
        self.cluster.delete_volume(bucket)
        self._vols.pop(bucket, None)
        return Response(204)

    def get_bucket_location(self, req: Request):
        self._check(req, req.params["bucket"], ACTION_GET)
        self._vol(req.params["bucket"])
        return Response.xml(
            f"<LocationConstraint>{self.region}</LocationConstraint>")

    # -- listing -----------------------------------------------------------------

    def _list_common(self, req: Request, v2: bool):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_LIST)
        vol = self._vol(bucket)
        prefix = req.q("prefix")
        delim = req.q("delimiter")
        try:
            max_keys = min(int(req.q("max-keys", "1000")), 1000)
        except ValueError:
            raise S3Error(400, "InvalidArgument", "max-keys") from None
        marker = req.q("continuation-token") or req.q("start-after") if v2 \
            else req.q("marker")
        contents, prefixes, truncated, next_marker = vol.list_objects(
            prefix, marker, delim, max_keys)
        parts = [f"<Name>{esc(bucket)}</Name><Prefix>{esc(prefix)}</Prefix>",
                 f"<MaxKeys>{max_keys}</MaxKeys>",
                 f"<IsTruncated>{str(truncated).lower()}</IsTruncated>"]
        if v2:
            parts.append(f"<KeyCount>{len(contents) + len(prefixes)}</KeyCount>")
            if truncated:
                parts.append(
                    f"<NextContinuationToken>{esc(next_marker)}</NextContinuationToken>")
        elif truncated:
            parts.append(f"<NextMarker>{esc(next_marker)}</NextMarker>")
        for o in contents:
            parts.append(
                f"<Contents><Key>{esc(o['key'])}</Key><Size>{o['size']}</Size>"
                f"<ETag>&quot;{o.get('etag', '')}&quot;</ETag>"
                f"<LastModified>{OSSVolume.http_time(o['mtime'])}</LastModified>"
                f"<StorageClass>STANDARD</StorageClass></Contents>")
        for p in prefixes:
            parts.append(f"<CommonPrefixes><Prefix>{esc(p)}</Prefix></CommonPrefixes>")
        tag = "ListBucketResult"
        return Response.xml(f"<{tag}>{''.join(parts)}</{tag}>")

    def list_objects_v1(self, req: Request):
        return self._list_common(req, v2=False)

    def list_objects_v2(self, req: Request):
        return self._list_common(req, v2=True)

    # -- object core -------------------------------------------------------------

    @staticmethod
    def _version_prologue(vol: OSSVolume, key: str) -> str | None:
        """Before overwriting `key`: retain the prior version per the bucket's
        versioning state. Enabled — archive whatever is current and mint a new
        version id for the incoming write. Suspended — archive only a current
        that carries a REAL version id (the 'null' version is overwritten, the
        versioned history is retained; S3 Suspended semantics); the incoming
        write stays the null version. Returns the new version id or None."""
        status = vol.versioning_status()
        if not status or key.endswith("/"):
            return None
        if status == "Enabled":
            vol.archive_current(key)
            return vol.new_version_id()
        if vol._current_vid(key) is not None:  # Suspended, real current
            vol.archive_current(key)
        return None

    @staticmethod
    def _version_epilogue(vol: OSSVolume, key: str, vid: str | None):
        if vid is not None:
            from chubaofs_tpu_torch.objectnode.volume import XATTR_VERSION_ID

            vol.fs.setxattr("/" + key, XATTR_VERSION_ID, vid.encode())

    def put_object(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_PUT, key)
        vol = self._vol(bucket)
        src = req.header("x-amz-copy-source")
        if src:
            return self._copy_object(req, vol, key, src)
        acl = self._parse_canned_acl(req, vol, key)  # validate BEFORE writing
        vid = self._version_prologue(vol, key)
        user_meta = {k[len("x-amz-meta-"):]: v for k, v in req.headers.items()
                     if k.startswith("x-amz-meta-")}
        etag = vol.put_object(key, req.body, req.header("content-type"),
                              user_meta or None)
        self._version_epilogue(vol, key, vid)
        if acl is not None:
            vol.fs.setxattr("/" + key, XATTR_ACL, acl.to_json())
        headers = {"ETag": f'"{etag}"'}
        if vid is not None:
            headers["x-amz-version-id"] = vid
        return Response(200, headers)

    def _parse_canned_acl(self, req: Request, vol: OSSVolume,
                          key: str) -> ACL | None:
        """x-amz-acl header -> ACL, validated up front: a bad header must 400
        before any state changes (no object written, no version consumed)."""
        canned = req.header("x-amz-acl")
        if not canned or key.endswith("/"):
            return None
        try:
            return ACL.canned(self._owner(vol), canned)
        except ValueError:
            raise S3Error(400, "InvalidArgument",
                          f"x-amz-acl {canned!r}") from None

    def _copy_object(self, req: Request, vol: OSSVolume, key: str, src: str):
        src = urllib.parse.unquote(src).lstrip("/")
        src_bucket, _, src_key = src.partition("/")
        self._check(req, src_bucket, ACTION_GET, src_key)
        src_vol = self._vol(src_bucket)
        info = src_vol.info(src_key)
        data = src_vol.get_object(src_key)
        if req.header("x-amz-metadata-directive", "COPY").upper() == "REPLACE":
            content_type = req.header("content-type") or info["content_type"]
            meta = {k[len("x-amz-meta-"):]: v for k, v in req.headers.items()
                    if k.startswith("x-amz-meta-")}
        else:
            content_type, meta = info["content_type"], info["meta"]
        acl = self._parse_canned_acl(req, vol, key)
        vid = self._version_prologue(vol, key)
        etag = vol.put_object(key, data, content_type, meta or None)
        self._version_epilogue(vol, key, vid)
        if acl is not None:
            vol.fs.setxattr("/" + key, XATTR_ACL, acl.to_json())
        return Response.xml(
            f"<CopyObjectResult><ETag>&quot;{etag}&quot;</ETag>"
            f"<LastModified>{OSSVolume.http_time(info['mtime'])}</LastModified>"
            f"</CopyObjectResult>")

    def _object_headers(self, info: dict) -> dict:
        h = {"ETag": f'"{info["etag"]}"',
             "Content-Type": info["content_type"],
             "Last-Modified": OSSVolume.http_time(info["mtime"]),
             "Accept-Ranges": "bytes"}
        for k, v in info["meta"].items():
            h[f"x-amz-meta-{k}"] = v
        return h

    def get_object(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_GET, key)
        vol = self._vol(bucket)
        vid = req.q("versionId")
        if vid:
            info = vol.stat_version(key, vid)

            def read(off, sz):
                return vol.read_version(key, vid, off, sz)
        else:
            info = vol.info(key)

            def read(off, sz):
                return vol.get_object(key, off, sz)
        headers = self._object_headers(info)
        if vid:
            headers["x-amz-version-id"] = vid
        # conditional GET (RFC 9110 §13): the validator is the etag the crc
        # ledger already stamped on the object — If-Match guards a stale
        # reader (412), If-None-Match serves revalidations headers-only (304)
        im = req.header("if-match")
        if im and not _etag_matches(im, info["etag"]):
            raise S3Error(412, "PreconditionFailed", "If-Match")
        inm = req.header("if-none-match")
        if inm and _etag_matches(inm, info["etag"]):
            return Response(304, headers)
        rng = req.header("range")
        if rng and rng.startswith("bytes="):
            try:
                lo_s, _, hi_s = rng[len("bytes="):].partition("-")
                if lo_s == "":  # suffix form bytes=-N
                    length = int(hi_s)
                    lo = max(0, info["size"] - length)
                    hi = info["size"] - 1
                else:
                    lo = int(lo_s)
                    hi = int(hi_s) if hi_s else info["size"] - 1
            except ValueError:
                raise S3Error(416, "InvalidRange", rng) from None
            if lo >= info["size"] or lo > hi:
                raise S3Error(416, "InvalidRange", rng)
            hi = min(hi, info["size"] - 1)
            headers["Content-Range"] = f"bytes {lo}-{hi}/{info['size']}"
            return Response(206, headers, read(lo, hi - lo + 1))
        return Response(200, headers, read(0, None))

    def head_object(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_GET, key)
        vol = self._vol(bucket)
        vid = req.q("versionId")
        # stat only — HEAD must never pay a whole-object read
        info = vol.stat_version(key, vid) if vid else vol.info(key)
        headers = self._object_headers(info)
        headers["Content-Length"] = str(info["size"])
        return Response(200, headers)

    def get_object_attributes(self, req: Request):
        """GetObjectAttributes: the metadata subset named by the
        x-amz-object-attributes header, without the body."""
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_GET, key)
        vol = self._vol(bucket)
        vid = req.q("versionId")
        info = vol.stat_version(key, vid) if vid else vol.info(key)
        want = {a.strip() for a in
                req.header("x-amz-object-attributes", "ETag,ObjectSize").split(",")}
        parts = []
        if "ETag" in want:
            parts.append(f"<ETag>{esc(info['etag'])}</ETag>")
        if "ObjectSize" in want:
            parts.append(f"<ObjectSize>{info['size']}</ObjectSize>")
        if "StorageClass" in want:
            parts.append("<StorageClass>STANDARD</StorageClass>")
        headers = {"Last-Modified": OSSVolume.http_time(info["mtime"])}
        if vid:
            headers["x-amz-version-id"] = vid
        return Response(200, {**headers, "Content-Type": "application/xml"},
                        ("<GetObjectAttributesOutput>" + "".join(parts) +
                         "</GetObjectAttributesOutput>").encode())

    def delete_object(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_DELETE, key)
        vol = self._vol(bucket)
        vid = req.q("versionId")
        if vid:
            vol.delete_version(key, vid)
            return Response(204, {"x-amz-version-id": vid})
        marker_vid = self._versioned_delete(vol, key)
        if marker_vid:
            return Response(204, {"x-amz-delete-marker": "true",
                                  "x-amz-version-id": marker_vid})
        return Response(204)

    @staticmethod
    def _versioned_delete(vol: OSSVolume, key: str) -> str | None:
        """Shared delete semantics for DeleteObject AND batch DeleteObjects:
        under versioning, retain history and record a marker (Suspended still
        removes the null current but keeps real versions); unversioned buckets
        delete outright. Returns the marker's version id, or None."""
        status = vol.versioning_status()
        if not status:
            vol.delete_object(key)
            return None
        if status == "Enabled" or vol._current_vid(key) is not None:
            vol.archive_current(key)
        else:
            vol.delete_object(key)
        return vol.put_delete_marker(key)

    def delete_objects(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_DELETE)
        vol = self._vol(bucket)
        root = _parse_xml(req.body)
        quiet = _text(root, "Quiet").lower() == "true"
        deleted = []
        for obj in root.iter("Object"):
            key = _text(obj, "Key")
            if key:
                self._versioned_delete(vol, key)
                deleted.append(key)
        body = "" if quiet else "".join(
            f"<Deleted><Key>{esc(k)}</Key></Deleted>" for k in deleted)
        return Response.xml(f"<DeleteResult>{body}</DeleteResult>")

    # -- acl ---------------------------------------------------------------------

    def get_bucket_acl(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_GET, perm="READ_ACP")
        raw = self._vol(bucket).get_bucket_xattr(XATTR_ACL)
        acl = ACL.from_json(raw) if raw else ACL(self._vol(bucket).owner)
        return Response.xml(acl.to_xml())

    def put_bucket_acl(self, req: Request):
        bucket = req.params["bucket"]
        principal = self._check(req, bucket, ACTION_PUT, perm="WRITE_ACP")
        vol = self._vol(bucket)
        canned = req.header("x-amz-acl", "private")
        owner = self._owner(vol) or principal or ""
        try:
            vol.set_bucket_xattr(XATTR_ACL, ACL.canned(owner, canned).to_json())
        except ValueError as e:
            raise S3Error(400, "InvalidArgument", str(e)) from None
        return Response(200)

    def get_object_acl(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_GET, key, perm="READ_ACP")
        vol = self._vol(bucket)
        vol.info(key)
        try:
            raw = vol.fs.getxattr("/" + key.rstrip("/"), XATTR_ACL)
            return Response.xml(ACL.from_json(raw).to_xml())
        except FsError:
            return Response.xml(ACL(self._owner(vol)).to_xml())

    def put_object_acl(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        principal = self._check(req, bucket, ACTION_PUT, key, perm="WRITE_ACP")
        vol = self._vol(bucket)
        vol.info(key)
        canned = req.header("x-amz-acl", "private")
        try:
            acl = ACL.canned(self._owner(vol) or principal or "", canned)
        except ValueError as e:
            raise S3Error(400, "InvalidArgument", str(e)) from None
        vol.fs.setxattr("/" + key.rstrip("/"), XATTR_ACL, acl.to_json())
        return Response(200)

    # -- policy ------------------------------------------------------------------

    def get_bucket_policy_status(self, req: Request):
        """GetBucketPolicyStatus: IsPublic when any Allow statement grants to
        the anonymous principal."""
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_GET, perm="READ_ACP")
        raw = self._vol(bucket).get_bucket_xattr(XATTR_POLICY)
        if not raw:
            # S3 distinguishes "no policy" (404) from "policy, not public"
            raise S3Error(404, "NoSuchBucketPolicy", bucket)
        # same matcher the request path uses: IsPublic must never diverge
        # from actual anonymous evaluation
        pol = Policy.from_json(raw)
        statements = pol.doc["Statement"]
        if isinstance(statements, dict):
            statements = [statements]
        public = any(
            st.get("Effect") == ALLOW
            and Policy._principal_matches(st, None)
            for st in statements)
        return Response.xml(
            f"<PolicyStatus><IsPublic>{str(public).lower()}</IsPublic>"
            f"</PolicyStatus>")

    def get_bucket_policy(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_GET)
        raw = self._vol(bucket).get_bucket_xattr(XATTR_POLICY)
        if not raw:
            raise S3Error(404, "NoSuchBucketPolicy", bucket)
        return Response(200, {"Content-Type": "application/json"}, raw)

    def put_bucket_policy(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_PUT)
        policy = Policy.from_json(req.body)  # validates
        self._vol(bucket).set_bucket_xattr(XATTR_POLICY, policy.to_json())
        return Response(204)

    def delete_bucket_policy(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_DELETE)
        self._vol(bucket).del_bucket_xattr(XATTR_POLICY)
        return Response(204)

    # -- cors --------------------------------------------------------------------

    def get_bucket_cors(self, req: Request):
        self._check(req, req.params["bucket"], ACTION_GET)
        raw = self._vol(req.params["bucket"]).get_bucket_xattr(XATTR_CORS)
        if not raw:
            raise S3Error(404, "NoSuchCORSConfiguration")
        return Response(200, {"Content-Type": "application/json"}, raw)

    def put_bucket_cors(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_PUT)
        try:
            cfg = self._parse_cors(req)
        except (ET.ParseError, ValueError) as e:
            raise S3Error(400, "MalformedXML", str(e)) from None
        self._vol(bucket).set_bucket_xattr(XATTR_CORS, cfg.to_json())
        return Response(200)

    @staticmethod
    def _parse_cors(req: Request) -> CORSConfig:
        if req.header("content-type", "").startswith("application/json"):
            return CORSConfig.from_json(req.body)
        root = _parse_xml(req.body)
        rules = []
        from chubaofs_tpu_torch.objectnode.cors import CORSRule

        for rule in root.iter("CORSRule"):
            rules.append(CORSRule(
                [e.text for e in rule.findall("AllowedOrigin")],
                [e.text for e in rule.findall("AllowedMethod")],
                [e.text for e in rule.findall("AllowedHeader")],
                [e.text for e in rule.findall("ExposeHeader")],
                int(_text(rule, "MaxAgeSeconds", "0"))))
        return CORSConfig(rules)

    def delete_bucket_cors(self, req: Request):
        self._check(req, req.params["bucket"], ACTION_DELETE)
        self._vol(req.params["bucket"]).del_bucket_xattr(XATTR_CORS)
        return Response(204)

    def preflight(self, req: Request):
        bucket = req.params["bucket"]
        raw = self._vol(bucket).get_bucket_xattr(XATTR_CORS)
        origin = req.header("origin")
        method = req.header("access-control-request-method") or req.method
        if not raw or not origin:
            return Response(403)
        headers = CORSConfig.from_json(raw).headers_for(origin, method)
        return Response(200 if headers else 403, headers)

    # -- tagging -----------------------------------------------------------------

    @staticmethod
    def _parse_tagging(body: bytes) -> dict:
        root = _parse_xml(body)
        return {_text(t, "Key"): _text(t, "Value") for t in root.iter("Tag")}

    @staticmethod
    def _tagging_xml(tags: dict) -> str:
        inner = "".join(f"<Tag><Key>{esc(k)}</Key><Value>{esc(v)}</Value></Tag>"
                        for k, v in sorted(tags.items()))
        return f"<Tagging><TagSet>{inner}</TagSet></Tagging>"

    def get_bucket_tagging(self, req: Request):
        self._check(req, req.params["bucket"], ACTION_GET)
        vol = self._vol(req.params["bucket"])
        raw = vol.get_bucket_xattr("oss:tagging")
        import json

        tags = json.loads(raw) if raw else {}
        return Response.xml(self._tagging_xml(tags))

    def put_bucket_tagging(self, req: Request):
        import json

        self._check(req, req.params["bucket"], ACTION_PUT)
        vol = self._vol(req.params["bucket"])
        tags = self._parse_tagging(req.body)
        vol.set_bucket_xattr("oss:tagging", json.dumps(tags).encode())
        return Response(204)

    def delete_bucket_tagging(self, req: Request):
        self._check(req, req.params["bucket"], ACTION_DELETE)
        self._vol(req.params["bucket"]).del_bucket_xattr("oss:tagging")
        return Response(204)

    def get_object_tagging(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_GET, key)
        tags = self._vol(bucket).get_tagging(key)
        return Response.xml(self._tagging_xml(tags))

    def put_object_tagging(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_PUT, key)
        self._vol(bucket).set_tagging(key, self._parse_tagging(req.body))
        return Response(200)

    def delete_object_tagging(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_DELETE, key)
        self._vol(bucket).delete_tagging(key)
        return Response(204)

    def unsupported(self, req: Request):
        """501 for sub-resources the gateway deliberately does not implement
        (ref unsupportedOperationHandler, api_handler.go:130)."""
        self._authenticate(req)
        return _xml_error(
            S3Error(501, "NotImplemented",
                    "A header you provided implies functionality that is not "
                    "implemented."),
            req.path)

    # -- object xattr (CubeFS-owned extension, ref api_handler_object.go:1491-
    # 1691: XML bodies PutXAttrRequest/GetXAttrOutput/ListXAttrsResult) ----------

    def put_object_xattr(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_PUT, key)
        try:
            root = _parse_xml(req.body)  # <PutXAttrRequest><XAttr>...
            x = root.find("XAttr")
            if x is None:
                x = root
            name = _text(x, "Key")
            velem = x.find("Value")
            value = (velem.text or "") if velem is not None else ""
            # symmetric with get_object_xattr: a <Value encoding="base64">
            # carries raw bytes, so a GET -> PUT round-trip of a binary
            # xattr restores the original bytes, not the base64 text
            if velem is not None and velem.get("encoding") == "base64":
                # tolerate pretty-printed / line-wrapped payloads; still
                # reject non-alphabet garbage
                raw = base64.b64decode("".join(value.split()), validate=True)
            else:
                raw = value.encode()
        except S3Error:
            raise
        except Exception:
            raise S3Error(400, "BadRequest", "malformed PutXAttrRequest") from None
        if not name:
            return Response(200)  # ref: empty key is a silent no-op
        self._vol(bucket).set_xattr(key, name, raw)
        return Response(200)

    def get_object_xattr(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_GET, key)
        vol = self._vol(bucket)
        if not req.has_q("key"):  # ListXAttrs: GET ?xattr without key=
            keys = "".join(f"<Keys>{esc(k)}</Keys>" for k in vol.list_xattrs(key))
            return Response.xml(f"<ListXAttrsResult>{keys}</ListXAttrsResult>")
        name = req.q("key")
        if not name:
            raise S3Error(400, "InvalidArgument", "key is required")
        try:
            value = vol.get_xattr(key, name)
        except FsError as e:
            if e.code == "ENODATA":
                value = b""  # ref: missing attribute reads as empty value
            else:
                raise
        # a binary value set through the FUSE/sdk path cannot travel as XML
        # text: base64-encode it and flag the encoding, instead of a lossy
        # utf-8 'replace' that silently corrupts the bytes. Control bytes
        # other than tab/lf are valid UTF-8 but ILLEGAL in XML 1.0 (and \r
        # is legal yet normalized to \n by every parser), so those take the
        # base64 path too or the response is unparseable/corrupted.
        try:
            text, enc = value.decode("utf-8"), ""
            if any((ord(c) < 0x20 and c not in "\t\n")
                   or ord(c) in (0xFFFE, 0xFFFF) for c in text):
                raise UnicodeDecodeError("utf-8", value, 0, 1, "xml-invalid")
        except UnicodeDecodeError:
            text, enc = base64.b64encode(value).decode("ascii"), \
                ' encoding="base64"'
        return Response.xml(
            f"<GetXAttrOutput><XAttr><Key>{esc(name)}</Key>"
            f"<Value{enc}>{esc(text)}</Value>"
            f"</XAttr></GetXAttrOutput>")

    def delete_object_xattr(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_DELETE, key)
        name = req.q("key")
        if not name:
            raise S3Error(400, "InvalidArgument", "key is required")
        try:
            self._vol(bucket).delete_xattr(key, name)
        except FsError as e:
            if e.code != "ENODATA":
                raise
        return Response(204)

    # -- multipart ---------------------------------------------------------------

    def initiate_multipart(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_PUT, key)
        upload_id = self._mpu(bucket).initiate(key, req.header("content-type"))
        return Response.xml(
            f"<InitiateMultipartUploadResult><Bucket>{esc(bucket)}</Bucket>"
            f"<Key>{esc(key)}</Key><UploadId>{upload_id}</UploadId>"
            f"</InitiateMultipartUploadResult>")

    def upload_part(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_PUT, key)
        try:
            part_num = int(req.q("partNumber"))
        except ValueError:
            raise S3Error(400, "InvalidArgument", "partNumber") from None
        src = req.header("x-amz-copy-source")
        if src:
            return self._upload_part_copy(req, bucket, part_num, src)
        etag = self._mpu(bucket).put_part(req.q("uploadId"), part_num, req.body)
        return Response(200, {"ETag": f'"{etag}"'})

    def _upload_part_copy(self, req: Request, bucket: str, part_num: int,
                          src: str):
        """UploadPartCopy: the part's bytes come from an existing object
        (optionally a byte range), not the request body."""
        src = urllib.parse.unquote(src).lstrip("/")
        src_bucket, _, src_key = src.partition("/")
        self._check(req, src_bucket, ACTION_GET, src_key)
        src_vol = self._vol(src_bucket)
        info = src_vol.info(src_key)
        rng = req.header("x-amz-copy-source-range")
        if rng:
            m = re.fullmatch(r"bytes=(\d+)-(\d+)", rng.strip())
            if not m:
                raise S3Error(400, "InvalidArgument", rng)
            lo, hi = int(m.group(1)), int(m.group(2))
            if lo > hi or hi >= info["size"]:
                raise S3Error(416, "InvalidRange", rng)
            data = src_vol.get_object(src_key, lo, hi - lo + 1)
        else:
            data = src_vol.get_object(src_key)
        etag = self._mpu(bucket).put_part(req.q("uploadId"), part_num, data)
        return Response.xml(
            f"<CopyPartResult><ETag>&quot;{etag}&quot;</ETag>"
            f"<LastModified>{OSSVolume.http_time(info['mtime'])}</LastModified>"
            f"</CopyPartResult>")

    def list_parts(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_GET)
        key, parts = self._mpu(bucket).list_parts(req.q("uploadId"))
        inner = "".join(
            f"<Part><PartNumber>{p['part_number']}</PartNumber>"
            f"<ETag>&quot;{p['etag']}&quot;</ETag><Size>{p['size']}</Size></Part>"
            for p in parts)
        return Response.xml(
            f"<ListPartsResult><Bucket>{esc(bucket)}</Bucket><Key>{esc(key)}</Key>"
            f"<UploadId>{req.q('uploadId')}</UploadId>{inner}</ListPartsResult>")

    def list_uploads(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_LIST)
        ups = self._mpu(bucket).list_uploads()
        inner = "".join(
            f"<Upload><Key>{esc(u['key'])}</Key><UploadId>{u['upload_id']}</UploadId>"
            f"</Upload>" for u in ups)
        return Response.xml(
            f"<ListMultipartUploadsResult><Bucket>{esc(bucket)}</Bucket>{inner}"
            f"</ListMultipartUploadsResult>")

    def complete_multipart(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_PUT, key)
        root = _parse_xml(req.body)
        try:
            spec = [(int(_text(p, "PartNumber")), _text(p, "ETag"))
                    for p in root.iter("Part")]
        except ValueError:
            raise S3Error(400, "MalformedXML", "PartNumber") from None
        vol = self._vol(bucket)
        mpu = self._mpu(bucket)
        # archive against the SESSION's key (the one complete() overwrites)
        session_key, _ = mpu.list_parts(req.q("uploadId"))
        vid = self._version_prologue(vol, session_key)
        final_key, etag = mpu.complete(req.q("uploadId"), spec)
        self._version_epilogue(vol, final_key, vid)
        return Response.xml(
            f"<CompleteMultipartUploadResult><Bucket>{esc(bucket)}</Bucket>"
            f"<Key>{esc(final_key)}</Key><ETag>&quot;{etag}&quot;</ETag>"
            f"</CompleteMultipartUploadResult>")

    def abort_multipart(self, req: Request):
        bucket, key = req.params["bucket"], req.params["key"]
        self._check(req, bucket, ACTION_DELETE, key)
        self._mpu(bucket).abort(req.q("uploadId"))
        return Response(204)

    # -- versioning ----------------------------------------------------------------

    def get_bucket_versioning(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_GET)
        status = self._vol(bucket).versioning_status()
        inner = f"<Status>{status}</Status>" if status else ""
        return Response.xml(f"<VersioningConfiguration>{inner}"
                            f"</VersioningConfiguration>")

    def put_bucket_versioning(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_PUT)
        status = _text(_parse_xml(req.body), "Status")
        try:
            self._vol(bucket).set_versioning(status)
        except ValueError:
            raise S3Error(400, "MalformedXML", f"Status {status!r}") from None
        return Response(200)

    def list_object_versions(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_LIST)
        entries = self._vol(bucket).list_versions(prefix=req.q("prefix"))
        parts = []
        for e in entries:
            tag = "DeleteMarker" if e["delete_marker"] else "Version"
            body = (f"<Key>{esc(e['key'])}</Key>"
                    f"<VersionId>{e['version_id']}</VersionId>"
                    f"<IsLatest>{'true' if e['is_latest'] else 'false'}</IsLatest>"
                    f"<LastModified>{OSSVolume.http_time(e['mtime'])}</LastModified>")
            if not e["delete_marker"]:
                body += (f"<ETag>&quot;{e['etag']}&quot;</ETag>"
                         f"<Size>{e['size']}</Size>")
            parts.append(f"<{tag}>{body}</{tag}>")
        return Response.xml(
            f"<ListVersionsResult><Name>{esc(bucket)}</Name>"
            f"{''.join(parts)}</ListVersionsResult>")

    # -- lifecycle -----------------------------------------------------------------
    #
    # Rules persist as a JSON bucket xattr; apply_lifecycle() is the expiry
    # sweeper the deployment pumps (the reference runs it inside objectnode's
    # lifecycle service).

    def get_bucket_lifecycle(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_GET)
        raw = self._vol(bucket).get_bucket_xattr(XATTR_LIFECYCLE)
        if not raw:
            raise S3Error(404, "NoSuchLifecycleConfiguration", bucket)
        import json as _json

        rules = _json.loads(raw)
        inner = "".join(
            f"<Rule><ID>{esc(r['id'])}</ID>"
            f"<Filter><Prefix>{esc(r['prefix'])}</Prefix></Filter>"
            f"<Status>{r['status']}</Status>"
            f"<Expiration><Days>{r['days']}</Days></Expiration></Rule>"
            for r in rules)
        return Response.xml(
            f"<LifecycleConfiguration>{inner}</LifecycleConfiguration>")

    def put_bucket_lifecycle(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_PUT)
        root = _parse_xml(req.body)
        rules = []
        for rule in root.iter("Rule"):
            exp = rule.find("Expiration")
            days = _text(exp, "Days") if exp is not None else ""
            if not days:
                raise S3Error(400, "MalformedXML", "Expiration.Days required")
            filt = rule.find("Filter")
            prefix = _text(filt, "Prefix") if filt is not None else _text(rule, "Prefix")
            try:
                days_n = int(days)
            except ValueError:
                raise S3Error(400, "MalformedXML",
                              f"Expiration.Days {days!r}") from None
            rules.append({"id": _text(rule, "ID") or f"rule{len(rules)}",
                          "prefix": prefix,
                          "status": _text(rule, "Status") or "Enabled",
                          "days": days_n})
        if not rules:
            raise S3Error(400, "MalformedXML", "no Rule")
        import json as _json

        self._vol(bucket).set_bucket_xattr(XATTR_LIFECYCLE,
                                           _json.dumps(rules).encode())
        return Response(200)

    def delete_bucket_lifecycle(self, req: Request):
        bucket = req.params["bucket"]
        self._check(req, bucket, ACTION_DELETE)
        self._vol(bucket).del_bucket_xattr(XATTR_LIFECYCLE)
        return Response(204)

    def apply_lifecycle(self, now: float | None = None) -> int:
        """Expire objects per enabled rules; returns objects expired. The
        deployment pumps this like the master's background checks."""
        import json as _json
        import time as _time

        now = now if now is not None else _time.time()
        expired = 0
        for bucket in self.cluster.volume_names():
            try:
                vol = self._vol(bucket)
            except S3Error:
                continue
            raw = vol.get_bucket_xattr(XATTR_LIFECYCLE)
            if not raw:
                continue
            versioned = vol.versioning_status() == "Enabled"
            for rule in _json.loads(raw):
                if rule["status"] != "Enabled":
                    continue
                contents, _, _, _ = vol.list_objects(
                    prefix=rule["prefix"], max_keys=100000)
                cutoff = now - rule["days"] * 86400
                for obj in contents:
                    if obj["key"].endswith("/"):
                        continue  # dir markers never expire (and can't archive)
                    if obj["mtime"] <= cutoff:
                        if versioned:
                            vol.archive_current(obj["key"])
                            vol.put_delete_marker(obj["key"])
                        else:
                            vol.delete_object(obj["key"])
                        expired += 1
        return expired
