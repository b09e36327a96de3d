"""The cases of tests/test_s3_breadth.py, run against the port on the CPU:
every name and assertion as in the reference, imports from
chubaofs_tpu_torch, and the FsCluster built with device="cpu".

The reference file's docstring:

S3 breadth: versioning, lifecycle, UploadPartCopy, presigned URLs.

Reference: objectnode/router.go's versioning/lifecycle/part-copy routes and
query-auth (presigned) verification. Same harness as test_objectnode: real
FsCluster + live HTTP + real signatures.
"""

import http.client
import time
import xml.etree.ElementTree as ET

import pytest

from chubaofs_tpu_torch.deploy import FsCluster
from chubaofs_tpu_torch.objectnode import ObjectNode
from chubaofs_tpu_torch.objectnode.auth import presign_v2, presign_v4, sign_v4
from chubaofs_tpu_torch.rpc import RPCServer
from chubaofs_tpu_torch import chaos as t_chaos


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()

AK, SK = "testak", "testsk"


@pytest.fixture(scope="module")
def s3env(tmp_path_factory):
    root = tmp_path_factory.mktemp("s3breadth")
    cluster = FsCluster(str(root), n_nodes=3, blob_nodes=6, data_nodes=0,
                        device="cpu")
    node = ObjectNode(cluster, users={AK: {"secret_key": SK, "uid": "alice"}})
    srv = RPCServer(node.router).start()
    yield srv, node
    srv.stop()
    cluster.close()


def req(s3, method, path, body=b"", headers=None, raw_query=""):
    host = s3.addr
    hdrs = {"host": host}
    hdrs.update(headers or {})
    hdrs = sign_v4(method, path, raw_query, hdrs, AK, SK, payload=body)
    target = path + (f"?{raw_query}" if raw_query else "")
    conn = http.client.HTTPConnection(host, timeout=30)
    try:
        conn.request(method, target, body=body or None, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def raw_req(s3, method, target):
    """No Authorization header — query-auth only (presigned URLs)."""
    conn = http.client.HTTPConnection(s3.addr, timeout=30)
    try:
        conn.request(method, target, headers={"host": s3.addr})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def xml_of(body):
    return ET.fromstring(body.decode())


# -- versioning ----------------------------------------------------------------


def test_versioning_roundtrip(s3env):
    s3, _ = s3env
    assert req(s3, "PUT", "/verbkt")[0] == 200
    body = b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>"
    assert req(s3, "PUT", "/verbkt", body=body, raw_query="versioning")[0] == 200
    status, _, got = req(s3, "GET", "/verbkt", raw_query="versioning")
    assert status == 200 and b"<Status>Enabled</Status>" in got

    s1, h1, _ = req(s3, "PUT", "/verbkt/doc", body=b"version-one")
    assert s1 == 200
    v1 = h1["x-amz-version-id"]
    s2, h2, _ = req(s3, "PUT", "/verbkt/doc", body=b"version-two!")
    v2 = h2["x-amz-version-id"]
    assert v1 != v2

    # latest wins on plain GET; versionId reaches the archive
    assert req(s3, "GET", "/verbkt/doc")[2] == b"version-two!"
    status, _, old = req(s3, "GET", "/verbkt/doc", raw_query=f"versionId={v1}")
    assert status == 200 and old == b"version-one"

    # list versions: two entries, newest is latest
    status, _, body = req(s3, "GET", "/verbkt", raw_query="versions")
    root = xml_of(body)
    versions = root.findall("Version")
    assert [v.findtext("VersionId") for v in versions] == [v2, v1]
    assert versions[0].findtext("IsLatest") == "true"


def test_versioned_delete_marker(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/verbkt2")
    body = b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>"
    req(s3, "PUT", "/verbkt2", body=body, raw_query="versioning")
    _, h, _ = req(s3, "PUT", "/verbkt2/k", body=b"data")
    vid = h["x-amz-version-id"]

    status, h, _ = req(s3, "DELETE", "/verbkt2/k")
    assert status == 204 and h.get("x-amz-delete-marker") == "true"
    # plain GET 404s, versioned GET still serves the archived bytes
    assert req(s3, "GET", "/verbkt2/k")[0] == 404
    status, _, got = req(s3, "GET", "/verbkt2/k", raw_query=f"versionId={vid}")
    assert status == 200 and got == b"data"
    # the marker appears in the version listing
    _, _, body = req(s3, "GET", "/verbkt2", raw_query="versions")
    assert xml_of(body).find("DeleteMarker") is not None
    # permanently removing the archived version
    assert req(s3, "DELETE", "/verbkt2/k",
               raw_query=f"versionId={vid}")[0] == 204
    assert req(s3, "GET", "/verbkt2/k",
               raw_query=f"versionId={vid}")[0] == 404


def test_versions_hidden_from_listing(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/verbkt3")
    body = b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>"
    req(s3, "PUT", "/verbkt3", body=body, raw_query="versioning")
    req(s3, "PUT", "/verbkt3/a", body=b"1")
    req(s3, "PUT", "/verbkt3/a", body=b"2")
    _, _, body = req(s3, "GET", "/verbkt3")
    keys = [c.findtext("Key") for c in xml_of(body).findall("Contents")]
    assert keys == ["a"]  # the .versions store never leaks into ListObjects


# -- lifecycle -------------------------------------------------------------------


LC = (b"<LifecycleConfiguration><Rule><ID>exp</ID>"
      b"<Filter><Prefix>tmp/</Prefix></Filter><Status>Enabled</Status>"
      b"<Expiration><Days>1</Days></Expiration></Rule></LifecycleConfiguration>")


def test_lifecycle_config_roundtrip(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/lcbkt")
    assert req(s3, "GET", "/lcbkt", raw_query="lifecycle")[0] == 404
    assert req(s3, "PUT", "/lcbkt", body=LC, raw_query="lifecycle")[0] == 200
    status, _, body = req(s3, "GET", "/lcbkt", raw_query="lifecycle")
    assert status == 200
    rule = xml_of(body).find("Rule")
    assert rule.findtext("ID") == "exp"
    assert rule.find("Expiration").findtext("Days") == "1"
    assert req(s3, "DELETE", "/lcbkt", raw_query="lifecycle")[0] == 204
    assert req(s3, "GET", "/lcbkt", raw_query="lifecycle")[0] == 404


def test_lifecycle_expiry_sweeper(s3env):
    s3, node = s3env
    req(s3, "PUT", "/lcbkt2")
    req(s3, "PUT", "/lcbkt2", body=LC, raw_query="lifecycle")
    req(s3, "PUT", "/lcbkt2/tmp/old", body=b"expired soon")
    req(s3, "PUT", "/lcbkt2/keep/me", body=b"not matching prefix")
    # pretend 2 days passed: everything under tmp/ ages out
    expired = node.apply_lifecycle(now=time.time() + 2 * 86400)
    assert expired >= 1
    assert req(s3, "GET", "/lcbkt2/tmp/old")[0] == 404
    assert req(s3, "GET", "/lcbkt2/keep/me")[0] == 200


# -- UploadPartCopy ---------------------------------------------------------------


def test_upload_part_copy(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/cpbkt")
    src = bytes(range(256)) * 1024  # 256 KiB
    assert req(s3, "PUT", "/cpbkt/src", body=src)[0] == 200

    _, _, body = req(s3, "POST", "/cpbkt/dst", raw_query="uploads")
    upload_id = xml_of(body).findtext("UploadId")

    # part 1: full-object copy; part 2: ranged copy; part 3: plain bytes
    status, _, body = req(s3, "PUT", "/cpbkt/dst",
                          headers={"x-amz-copy-source": "/cpbkt/src"},
                          raw_query=f"partNumber=1&uploadId={upload_id}")
    assert status == 200
    etag1 = xml_of(body).findtext("ETag").strip('"')
    status, _, body = req(s3, "PUT", "/cpbkt/dst",
                          headers={"x-amz-copy-source": "/cpbkt/src",
                                   "x-amz-copy-source-range": "bytes=0-65535"},
                          raw_query=f"partNumber=2&uploadId={upload_id}")
    assert status == 200
    etag2 = xml_of(body).findtext("ETag").strip('"')
    status, _, _ = req(s3, "PUT", "/cpbkt/dst", body=b"tail",
                       raw_query=f"partNumber=3&uploadId={upload_id}")
    assert status == 200
    _, h, _ = req(s3, "PUT", "/cpbkt/dst", body=b"tail",
                  raw_query=f"partNumber=3&uploadId={upload_id}")
    etag3 = h["ETag"].strip('"')

    complete = (
        "<CompleteMultipartUpload>"
        f"<Part><PartNumber>1</PartNumber><ETag>{etag1}</ETag></Part>"
        f"<Part><PartNumber>2</PartNumber><ETag>{etag2}</ETag></Part>"
        f"<Part><PartNumber>3</PartNumber><ETag>{etag3}</ETag></Part>"
        "</CompleteMultipartUpload>").encode()
    status, _, _ = req(s3, "POST", "/cpbkt/dst", body=complete,
                       raw_query=f"uploadId={upload_id}")
    assert status == 200
    _, _, got = req(s3, "GET", "/cpbkt/dst")
    assert got == src + src[:65536] + b"tail"


def test_upload_part_copy_bad_range(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/cpbkt2")
    req(s3, "PUT", "/cpbkt2/s", body=b"x" * 100)
    _, _, body = req(s3, "POST", "/cpbkt2/d", raw_query="uploads")
    uid = xml_of(body).findtext("UploadId")
    status, _, body = req(s3, "PUT", "/cpbkt2/d",
                          headers={"x-amz-copy-source": "/cpbkt2/s",
                                   "x-amz-copy-source-range": "bytes=0-1000"},
                          raw_query=f"partNumber=1&uploadId={uid}")
    assert status == 416


# -- presigned URLs ---------------------------------------------------------------


def test_presigned_v4_get(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/psbkt")
    req(s3, "PUT", "/psbkt/obj", body=b"presigned payload")
    q = presign_v4("GET", "/psbkt/obj", s3.addr, AK, SK, expires=300)
    status, got = raw_req(s3, "GET", "/psbkt/obj?" + q)
    assert status == 200 and got == b"presigned payload"


def test_presigned_v4_expired(s3env):
    s3, _ = s3env
    old = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(time.time() - 3600))
    q = presign_v4("GET", "/psbkt/obj", s3.addr, AK, SK, expires=60,
                   amz_date=old)
    status, body = raw_req(s3, "GET", "/psbkt/obj?" + q)
    assert status == 403 and b"SignatureDoesNotMatch" in body


def test_presigned_v4_tamper(s3env):
    s3, _ = s3env
    q = presign_v4("GET", "/psbkt/obj", s3.addr, AK, SK, expires=300)
    status, _ = raw_req(s3, "GET", "/psbkt/other?" + q)  # different key
    assert status == 403


def test_presigned_v2_get(s3env):
    s3, _ = s3env
    q = presign_v2("GET", "/psbkt/obj", AK, SK, int(time.time()) + 300)
    status, got = raw_req(s3, "GET", "/psbkt/obj?" + q)
    assert status == 200 and got == b"presigned payload"
    q = presign_v2("GET", "/psbkt/obj", AK, SK, int(time.time()) - 10)
    assert raw_req(s3, "GET", "/psbkt/obj?" + q)[0] == 403


def test_versioning_covers_copy_batch_delete_and_multipart(s3env):
    """CopyObject, DeleteObjects, and CompleteMultipartUpload honor versioning
    the same way single-key PUT/DELETE do."""
    s3, _ = s3env
    req(s3, "PUT", "/verbkt4")
    body = b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>"
    req(s3, "PUT", "/verbkt4", body=body, raw_query="versioning")
    _, h, _ = req(s3, "PUT", "/verbkt4/k", body=b"original")
    v1 = h["x-amz-version-id"]

    # copy over k: the original survives as v1
    req(s3, "PUT", "/verbkt4/src", body=b"copied-bytes")
    status, _, _ = req(s3, "PUT", "/verbkt4/k",
                       headers={"x-amz-copy-source": "/verbkt4/src"})
    assert status == 200
    assert req(s3, "GET", "/verbkt4/k")[2] == b"copied-bytes"
    assert req(s3, "GET", "/verbkt4/k",
               raw_query=f"versionId={v1}")[2] == b"original"

    # batch delete leaves a marker, not a destructive unlink
    dele = b"<Delete><Object><Key>k</Key></Object></Delete>"
    req(s3, "POST", "/verbkt4", body=dele, raw_query="delete")
    assert req(s3, "GET", "/verbkt4/k")[0] == 404
    assert req(s3, "GET", "/verbkt4/k",
               raw_query=f"versionId={v1}")[2] == b"original"

    # multipart completion over an existing key archives it first
    _, h, _ = req(s3, "PUT", "/verbkt4/m", body=b"before-mpu")
    vm = h["x-amz-version-id"]
    _, _, ibody = req(s3, "POST", "/verbkt4/m", raw_query="uploads")
    uid = xml_of(ibody).findtext("UploadId")
    _, hp, _ = req(s3, "PUT", "/verbkt4/m", body=b"part-one",
                   raw_query=f"partNumber=1&uploadId={uid}")
    etag = hp["ETag"].strip('"')
    comp = (f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
            f"<ETag>{etag}</ETag></Part></CompleteMultipartUpload>").encode()
    assert req(s3, "POST", "/verbkt4/m", body=comp,
               raw_query=f"uploadId={uid}")[0] == 200
    assert req(s3, "GET", "/verbkt4/m")[2] == b"part-one"
    assert req(s3, "GET", "/verbkt4/m",
               raw_query=f"versionId={vm}")[2] == b"before-mpu"


def test_suspended_versioning_retains_real_versions(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/verbkt5")
    en = b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>"
    su = b"<VersioningConfiguration><Status>Suspended</Status></VersioningConfiguration>"
    req(s3, "PUT", "/verbkt5", body=en, raw_query="versioning")
    _, h, _ = req(s3, "PUT", "/verbkt5/k", body=b"v-real")
    v_real = h["x-amz-version-id"]
    req(s3, "PUT", "/verbkt5", body=su, raw_query="versioning")
    # suspended PUT: real version retained, write becomes the null version
    _, h, _ = req(s3, "PUT", "/verbkt5/k", body=b"null-one")
    assert "x-amz-version-id" not in h
    _, h, _ = req(s3, "PUT", "/verbkt5/k", body=b"null-two")
    assert req(s3, "GET", "/verbkt5/k")[2] == b"null-two"
    assert req(s3, "GET", "/verbkt5/k",
               raw_query=f"versionId={v_real}")[2] == b"v-real"


def test_reserved_version_store_key_rejected(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/verbkt6")
    status, _, body = req(s3, "PUT", "/verbkt6/.versions/forged/1", body=b"x")
    assert status == 400 and b"InvalidArgument" in body
    assert req(s3, "GET", "/verbkt6/.versions/forged/1")[0] == 400
    assert req(s3, "DELETE", "/verbkt6/.versions/forged/1")[0] == 400


def test_malformed_lifecycle_xml_is_400(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/lcbkt3")
    bad = (b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
           b"<Expiration><Days>ten</Days></Expiration></Rule>"
           b"</LifecycleConfiguration>")
    status, _, body = req(s3, "PUT", "/lcbkt3", body=bad, raw_query="lifecycle")
    assert status == 400 and b"MalformedXML" in body
    status, _, body = req(s3, "PUT", "/lcbkt3", body=b"<notxml",
                          raw_query="lifecycle")
    assert status == 400 and b"MalformedXML" in body


def test_versioned_get_supports_range(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/verbkt7")
    en = b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>"
    req(s3, "PUT", "/verbkt7", body=en, raw_query="versioning")
    _, h, _ = req(s3, "PUT", "/verbkt7/k", body=b"0123456789")
    vid = h["x-amz-version-id"]
    req(s3, "PUT", "/verbkt7/k", body=b"new-content")
    status, hh, got = req(s3, "GET", "/verbkt7/k", raw_query=f"versionId={vid}",
                          headers={"range": "bytes=2-5"})
    assert status == 206 and got == b"2345"
    assert hh["Content-Range"] == "bytes 2-5/10"


def test_delete_current_version_promotes_previous(s3env):
    """Deleting the current version by id surfaces the previous version as
    latest (the S3 'undo an overwrite' flow)."""
    s3, _ = s3env
    req(s3, "PUT", "/verbkt8")
    en = b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>"
    req(s3, "PUT", "/verbkt8", body=en, raw_query="versioning")
    _, h1, _ = req(s3, "PUT", "/verbkt8/k", body=b"first")
    v1 = h1["x-amz-version-id"]
    _, h2, _ = req(s3, "PUT", "/verbkt8/k", body=b"second")
    v2 = h2["x-amz-version-id"]
    assert req(s3, "DELETE", "/verbkt8/k", raw_query=f"versionId={v2}")[0] == 204
    status, hh, got = req(s3, "GET", "/verbkt8/k")
    assert status == 200 and got == b"first"
    status, _, got = req(s3, "GET", "/verbkt8/k", raw_query=f"versionId={v1}")
    assert status == 200 and got == b"first"


def test_null_version_id_is_not_a_real_version(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/verbkt9")
    en = b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>"
    req(s3, "PUT", "/verbkt9", body=en, raw_query="versioning")
    req(s3, "PUT", "/verbkt9/k", body=b"real-version")  # current has a REAL id
    assert req(s3, "GET", "/verbkt9/k", raw_query="versionId=null")[0] == 404


def test_batch_delete_respects_suspended_versioning(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/verbkt10")
    en = b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>"
    su = b"<VersioningConfiguration><Status>Suspended</Status></VersioningConfiguration>"
    req(s3, "PUT", "/verbkt10", body=en, raw_query="versioning")
    _, h, _ = req(s3, "PUT", "/verbkt10/k", body=b"keep-me")
    v1 = h["x-amz-version-id"]
    req(s3, "PUT", "/verbkt10", body=su, raw_query="versioning")
    dele = b"<Delete><Object><Key>k</Key></Object></Delete>"
    req(s3, "POST", "/verbkt10", body=dele, raw_query="delete")
    # the real version survived the batch delete under Suspended
    assert req(s3, "GET", "/verbkt10/k",
               raw_query=f"versionId={v1}")[2] == b"keep-me"


def test_presigned_v2_subresource_bound(s3env):
    """A V2 presigned URL for the plain object cannot be retargeted at a
    subresource (the canonical resource covers them)."""
    s3, _ = s3env
    q = presign_v2("GET", "/psbkt/obj", AK, SK, int(time.time()) + 300)
    assert raw_req(s3, "GET", "/psbkt/obj?" + q)[0] == 200
    assert raw_req(s3, "GET", "/psbkt/obj?acl&" + q)[0] == 403
    # signing the subresource explicitly works
    q = presign_v2("GET", "/psbkt/obj", AK, SK, int(time.time()) + 300,
                   subresource_query="acl")
    assert raw_req(s3, "GET", "/psbkt/obj?" + q)[0] == 200


def test_malformed_presigned_params_403_not_500(s3env):
    s3, _ = s3env
    bad = ("X-Amz-Algorithm=AWS4-HMAC-SHA256&X-Amz-Credential=" + AK +
           "&X-Amz-Date=garbage&X-Amz-Expires=60&X-Amz-SignedHeaders=host"
           "&X-Amz-Signature=deadbeef")
    status, body = raw_req(s3, "GET", "/psbkt/obj?" + bad)
    assert status == 403


# -- action breadth: attributes, policy status, canned ACLs, directives --------


def test_get_object_attributes(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/attrbkt")
    req(s3, "PUT", "/attrbkt/k", body=b"x" * 1234)
    status, h, body = req(s3, "GET", "/attrbkt/k", raw_query="attributes",
                          headers={"x-amz-object-attributes":
                                   "ETag,ObjectSize,StorageClass"})
    assert status == 200
    root = xml_of(body)
    assert root.findtext("ObjectSize") == "1234"
    assert root.findtext("StorageClass") == "STANDARD"
    assert root.findtext("ETag")
    assert "Last-Modified" in h


def test_bucket_policy_status(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/polbkt")
    # no policy -> 404 NoSuchBucketPolicy (S3 distinguishes this from private)
    status, _, body = req(s3, "GET", "/polbkt", raw_query="policyStatus")
    assert status == 404 and b"NoSuchBucketPolicy" in body
    private = (b'{"Statement": [{"Effect": "Allow", "Principal": {"AWS": "me"},'
               b' "Action": ["s3:GetObject"], "Resource": ["polbkt/*"]}]}')
    assert req(s3, "PUT", "/polbkt", body=private,
               raw_query="policy")[0] in (200, 204)
    status, _, body = req(s3, "GET", "/polbkt", raw_query="policyStatus")
    assert status == 200 and b"<IsPublic>false</IsPublic>" in body
    policy = (b'{"Statement": [{"Effect": "Allow", "Principal": "*",'
              b' "Action": ["s3:GetObject"], "Resource": ["polbkt/*"]}]}')
    assert req(s3, "PUT", "/polbkt", body=policy, raw_query="policy")[0] in (200, 204)
    _, _, body = req(s3, "GET", "/polbkt", raw_query="policyStatus")
    assert b"<IsPublic>true</IsPublic>" in body


def test_copy_metadata_directive_replace(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/mdbkt")
    req(s3, "PUT", "/mdbkt/src", body=b"data",
        headers={"x-amz-meta-color": "red", "content-type": "text/plain"})
    # COPY (default): source metadata travels
    req(s3, "PUT", "/mdbkt/c1", headers={"x-amz-copy-source": "/mdbkt/src"})
    _, h, _ = req(s3, "HEAD", "/mdbkt/c1")
    assert h.get("x-amz-meta-color") == "red"
    # REPLACE: request metadata wins
    req(s3, "PUT", "/mdbkt/c2",
        headers={"x-amz-copy-source": "/mdbkt/src",
                 "x-amz-metadata-directive": "REPLACE",
                 "x-amz-meta-color": "blue", "content-type": "text/csv"})
    _, h, _ = req(s3, "HEAD", "/mdbkt/c2")
    assert h.get("x-amz-meta-color") == "blue"
    assert h.get("Content-Type") == "text/csv"


def test_put_object_canned_acl(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/aclbkt")
    req(s3, "PUT", "/aclbkt/pub", body=b"open",
        headers={"x-amz-acl": "public-read"})
    status, _, body = req(s3, "GET", "/aclbkt/pub", raw_query="acl")
    assert status == 200 and b"<Grantee>*</Grantee>" in body
    status, _, body = req(s3, "PUT", "/aclbkt/bad", body=b"x",
                          headers={"x-amz-acl": "nonsense"})
    assert status == 400


def test_batch_delete_quiet_mode(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/qbkt")
    req(s3, "PUT", "/qbkt/a", body=b"1")
    dele = (b"<Delete><Quiet>true</Quiet>"
            b"<Object><Key>a</Key></Object></Delete>")
    status, _, body = req(s3, "POST", "/qbkt", body=dele, raw_query="delete")
    assert status == 200 and b"<Deleted>" not in body
    assert req(s3, "GET", "/qbkt/a")[0] == 404


def test_invalid_canned_acl_writes_nothing(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/aclbkt2")
    status, _, _ = req(s3, "PUT", "/aclbkt2/k", body=b"x",
                       headers={"x-amz-acl": "nonsense"})
    assert status == 400
    assert req(s3, "GET", "/aclbkt2/k")[0] == 404  # nothing was written


def test_copy_applies_canned_acl(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/aclbkt3")
    req(s3, "PUT", "/aclbkt3/src", body=b"data")
    req(s3, "PUT", "/aclbkt3/dst",
        headers={"x-amz-copy-source": "/aclbkt3/src",
                 "x-amz-acl": "public-read"})
    status, _, body = req(s3, "GET", "/aclbkt3/dst", raw_query="acl")
    assert status == 200 and b"<Grantee>*</Grantee>" in body


def test_object_xattr_put_get_list_delete(s3env):
    """CubeFS-owned xattr API (ref router.go:77-91,340-345)."""
    s3, _ = s3env
    req(s3, "PUT", "/xbkt")
    req(s3, "PUT", "/xbkt/obj", body=b"payload")
    body = (b"<PutXAttrRequest><XAttr><Key>user.color</Key>"
            b"<Value>teal</Value></XAttr></PutXAttrRequest>")
    status, _, _ = req(s3, "PUT", "/xbkt/obj", body=body, raw_query="xattr")
    assert status == 200
    # single get
    status, _, out = req(s3, "GET", "/xbkt/obj", raw_query="xattr&key=user.color")
    assert status == 200
    x = xml_of(out)
    assert x.find("XAttr/Key").text == "user.color"
    assert x.find("XAttr/Value").text == "teal"
    # list includes the user key; internal oss:* keys are NOT exposed (the
    # ACL/versioning engines key permissions off them — see volume.py)
    status, _, out = req(s3, "GET", "/xbkt/obj", raw_query="xattr")
    keys = [k.text for k in xml_of(out).iter("Keys")]
    assert "user.color" in keys and not any(k.startswith("oss:") for k in keys)
    # delete, then the key is gone from the listing and reads empty
    status, _, _ = req(s3, "DELETE", "/xbkt/obj", raw_query="xattr&key=user.color")
    assert status == 204
    _, _, out = req(s3, "GET", "/xbkt/obj", raw_query="xattr")
    assert "user.color" not in [k.text for k in xml_of(out).iter("Keys")]
    _, _, out = req(s3, "GET", "/xbkt/obj", raw_query="xattr&key=user.color")
    assert xml_of(out).find("XAttr/Value").text is None  # empty value


def test_object_xattr_binary_value_base64(s3env):
    """A binary xattr set via the sdk path must not be silently corrupted
    by the XML response: it travels base64 with an encoding flag."""
    import base64
    s3, node = s3env
    req(s3, "PUT", "/xbin")
    req(s3, "PUT", "/xbin/obj", body=b"payload")
    raw = bytes([0xFF, 0x00, 0x9C, 0x41])  # invalid UTF-8
    node._vol("xbin").set_xattr("obj", "user.blob", raw)
    status, _, out = req(s3, "GET", "/xbin/obj",
                         raw_query="xattr&key=user.blob")
    assert status == 200
    val = xml_of(out).find("XAttr/Value")
    assert val.get("encoding") == "base64"
    assert base64.b64decode(val.text) == raw
    # a text value still reads as plain text, no flag
    node._vol("xbin").set_xattr("obj", "user.txt", b"plain")
    _, _, out = req(s3, "GET", "/xbin/obj", raw_query="xattr&key=user.txt")
    val = xml_of(out).find("XAttr/Value")
    assert val.get("encoding") is None and val.text == "plain"
    # control bytes are valid UTF-8 but illegal in XML 1.0 text: they must
    # also travel base64 or the response is unparseable
    node._vol("xbin").set_xattr("obj", "user.ctl", b"\x01\x02")
    _, _, out = req(s3, "GET", "/xbin/obj", raw_query="xattr&key=user.ctl")
    val = xml_of(out).find("XAttr/Value")  # xml_of parsing IS the assertion
    assert val.get("encoding") == "base64"
    assert base64.b64decode(val.text) == b"\x01\x02"
    # U+FFFF is valid UTF-8 but an XML noncharacter: base64 path too
    node._vol("xbin").set_xattr("obj", "user.nc", "￿".encode())
    _, _, out = req(s3, "GET", "/xbin/obj", raw_query="xattr&key=user.nc")
    val = xml_of(out).find("XAttr/Value")
    assert val.get("encoding") == "base64"
    # \r is XML-legal but parsers normalize it to \n — must travel base64
    # or the round-trip silently turns a\rb into a\nb
    node._vol("xbin").set_xattr("obj", "user.cr", b"a\rb")
    _, _, out = req(s3, "GET", "/xbin/obj", raw_query="xattr&key=user.cr")
    val = xml_of(out).find("XAttr/Value")
    assert val.get("encoding") == "base64"
    assert base64.b64decode(val.text) == b"a\rb"
    # GET -> PUT round-trip: echoing the flagged element back restores the
    # original BYTES, not the base64 text (whitespace-wrapped payload OK)
    body = (b'<PutXAttrRequest><XAttr><Key>user.blob2</Key>'
            b'<Value encoding="base64">\n  ' + base64.b64encode(raw) +
            b"\n</Value></XAttr></PutXAttrRequest>")
    status, _, _ = req(s3, "PUT", "/xbin/obj", body=body, raw_query="xattr")
    assert status == 200
    assert node._vol("xbin").get_xattr("obj", "user.blob2") == raw


def test_object_xattr_errors(s3env):
    s3, _ = s3env
    req(s3, "PUT", "/xbkt2")
    req(s3, "PUT", "/xbkt2/obj", body=b"x")
    # delete without key= -> InvalidArgument
    status, _, body = req(s3, "DELETE", "/xbkt2/obj", raw_query="xattr")
    assert status == 400 and b"InvalidArgument" in body
    # malformed body -> BadRequest
    status, _, body = req(s3, "PUT", "/xbkt2/obj", body=b"not-xml",
                          raw_query="xattr")
    assert status == 400
    # missing object -> NoSuchKey family
    status, _, _ = req(s3, "GET", "/xbkt2/nope", raw_query="xattr")
    assert status == 404
    # internal oss:* keys are unreachable: no ACL forging via plain WRITE
    body = (b"<PutXAttrRequest><XAttr><Key>oss:acl</Key>"
            b"<Value>{}</Value></XAttr></PutXAttrRequest>")
    status, _, out = req(s3, "PUT", "/xbkt2/obj", body=body, raw_query="xattr")
    assert status == 400 and b"reserved" in out
    status, _, out = req(s3, "GET", "/xbkt2/obj", raw_query="xattr&key=oss:etag")
    assert status == 400 and b"reserved" in out
    # the hidden version store is guarded like every other object verb
    status, _, _ = req(s3, "GET", "/xbkt2/.versions/obj/v1", raw_query="xattr")
    assert status == 400
    # non-objects (implicit prefix dirs) are not addressable, like tagging
    req(s3, "PUT", "/xbkt2/a/obj", body=b"y")
    status, _, _ = req(s3, "GET", "/xbkt2/a", raw_query="xattr")
    assert status == 404


def test_unsupported_subresources_return_501(s3env):
    """Unimplemented sub-resources answer NotImplemented instead of falling
    through to the catch-all routes (ref unsupportedOperationHandler)."""
    s3, _ = s3env
    req(s3, "PUT", "/ubkt")
    req(s3, "PUT", "/ubkt/o", body=b"x")
    for q in ("replication", "website", "encryption", "object-lock",
              "publicAccessBlock", "requestPayment"):
        status, _, body = req(s3, "GET", "/ubkt", raw_query=q)
        assert status == 501 and b"NotImplemented" in body, q
    for q in ("legal-hold", "retention", "torrent", "restore"):
        status, _, body = req(s3, "GET", "/ubkt/o", raw_query=q)
        assert status == 501 and b"NotImplemented" in body, q
    # implemented sub-resources are unaffected
    assert req(s3, "GET", "/ubkt", raw_query="versioning")[0] == 200
    assert req(s3, "GET", "/ubkt", raw_query="lifecycle")[0] in (200, 404)
