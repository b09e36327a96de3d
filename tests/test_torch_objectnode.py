"""The cases of tests/test_objectnode.py, run against the port on the CPU:
every name and assertion as in the reference, imports from
chubaofs_tpu_torch, and the FsCluster built with device="cpu".

The reference file's docstring:

S3 gateway behavior tests (docker/s3tests analog, SURVEY §4).

A real FsCluster (cold volumes → EC on the codec) fronted by ObjectNode over a
live HTTP server; requests go through http.client with real SigV4/V2
signatures, exercising router+auth+handlers end-to-end.
"""

import http.client
import json
import urllib.parse
import xml.etree.ElementTree as ET

import pytest

from chubaofs_tpu_torch.deploy import FsCluster
from chubaofs_tpu_torch.objectnode import ObjectNode
from chubaofs_tpu_torch.objectnode.auth import sign_v2, sign_v4
from chubaofs_tpu_torch.rpc import RPCServer
from chubaofs_tpu_torch import chaos as t_chaos


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()

AK, SK = "testak", "testsk"
AK2, SK2 = "otherak", "othersk"


@pytest.fixture(scope="module")
def s3(tmp_path_factory):
    root = tmp_path_factory.mktemp("s3")
    cluster = FsCluster(str(root), n_nodes=3, blob_nodes=6, data_nodes=0,
                        device="cpu")
    node = ObjectNode(cluster, users={
        AK: {"secret_key": SK, "uid": "alice"},
        AK2: {"secret_key": SK2, "uid": "bob"},
    })
    srv = RPCServer(node.router).start()
    yield srv
    srv.stop()
    cluster.close()


def req(s3, method, path, body=b"", headers=None, ak=AK, sk=SK, v2=False,
        raw_query=""):
    host = s3.addr
    hdrs = {"host": host}
    hdrs.update(headers or {})
    target = path + (f"?{raw_query}" if raw_query else "")
    if ak is not None:
        sign = sign_v2 if v2 else sign_v4
        kw = {} if v2 else {"payload": body}
        hdrs = sign(method, path, raw_query, hdrs, ak, sk, **kw)
    conn = http.client.HTTPConnection(host, timeout=30)
    try:
        conn.request(method, target, body=body or None, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def xml_of(body):
    return ET.fromstring(body.decode())


# -- signatures ----------------------------------------------------------------

def test_v4_signature_accepted_and_bad_sig_rejected(s3):
    status, _, _ = req(s3, "PUT", "/sigbkt")
    assert status == 200
    status, _, body = req(s3, "PUT", "/sigbkt2", sk="wrongsecret")
    assert status == 403 and b"SignatureDoesNotMatch" in body


def test_v2_signature_accepted(s3):
    import time

    status, _, _ = req(s3, "PUT", "/v2bkt",
                       headers={"date": time.strftime(
                           "%a, %d %b %Y %H:%M:%S GMT", time.gmtime())},
                       v2=True)
    assert status == 200


def test_unknown_access_key_rejected(s3):
    status, _, body = req(s3, "PUT", "/nokey", ak="missing", sk="x")
    assert status == 403 and b"InvalidAccessKeyId" in body


# -- bucket lifecycle ----------------------------------------------------------

def test_bucket_create_head_list_delete(s3):
    assert req(s3, "PUT", "/b1")[0] == 200
    assert req(s3, "HEAD", "/b1")[0] == 200
    status, _, body = req(s3, "GET", "/")
    assert status == 200 and b"<Name>b1</Name>" in body
    # duplicate create
    status, _, body = req(s3, "PUT", "/b1")
    assert status == 409 and b"BucketAlreadyExists" in body
    # location
    status, _, body = req(s3, "GET", "/b1", raw_query="location=")
    assert status == 200 and b"cfs" in body
    assert req(s3, "DELETE", "/b1")[0] == 204
    assert req(s3, "HEAD", "/b1")[0] == 404


def test_delete_nonempty_bucket_rejected(s3):
    req(s3, "PUT", "/b2")
    req(s3, "PUT", "/b2/x.txt", body=b"data")
    status, _, body = req(s3, "DELETE", "/b2")
    assert status == 409 and b"BucketNotEmpty" in body
    req(s3, "DELETE", "/b2/x.txt")
    assert req(s3, "DELETE", "/b2")[0] == 204


# -- object core ---------------------------------------------------------------

def test_object_put_get_head_delete_roundtrip(s3):
    req(s3, "PUT", "/obj")
    payload = b"The quick brown fox jumps over the lazy dog" * 1000
    status, headers, _ = req(s3, "PUT", "/obj/dir/sub/file.bin", body=payload,
                             headers={"content-type": "text/plain",
                                      "x-amz-meta-color": "blue"})
    assert status == 200 and headers["ETag"].strip('"')
    status, headers, body = req(s3, "GET", "/obj/dir/sub/file.bin")
    assert status == 200 and body == payload
    assert headers["Content-Type"] == "text/plain"
    assert headers["x-amz-meta-color"] == "blue"
    status, headers, body = req(s3, "HEAD", "/obj/dir/sub/file.bin")
    assert status == 200 and headers["Content-Length"] == str(len(payload))
    assert req(s3, "DELETE", "/obj/dir/sub/file.bin")[0] == 204
    assert req(s3, "GET", "/obj/dir/sub/file.bin")[0] == 404
    # implicit dirs pruned: prefix no longer listed
    status, _, body = req(s3, "GET", "/obj", raw_query="delimiter=%2F")
    assert b"<Prefix>dir/</Prefix>" not in body


def test_get_missing_key_is_nosuchkey(s3):
    req(s3, "PUT", "/missbkt")
    status, _, body = req(s3, "GET", "/missbkt/nope")
    assert status == 404 and b"NoSuchKey" in body


def test_range_get(s3):
    req(s3, "PUT", "/rangebkt")
    data = bytes(range(256)) * 64
    req(s3, "PUT", "/rangebkt/blob", body=data)
    status, headers, body = req(s3, "GET", "/rangebkt/blob",
                                headers={"range": "bytes=100-199"})
    assert status == 206 and body == data[100:200]
    assert headers["Content-Range"] == f"bytes 100-199/{len(data)}"
    # suffix range
    status, _, body = req(s3, "GET", "/rangebkt/blob",
                          headers={"range": "bytes=-50"})
    assert status == 206 and body == data[-50:]
    # open-ended
    status, _, body = req(s3, "GET", "/rangebkt/blob",
                          headers={"range": f"bytes={len(data)-10}-"})
    assert status == 206 and body == data[-10:]
    # invalid
    status, _, _ = req(s3, "GET", "/rangebkt/blob",
                       headers={"range": f"bytes={len(data)}-"})
    assert status == 416


def test_conditional_get_if_none_match(s3):
    req(s3, "PUT", "/condbkt")
    data = b"conditional body " * 100
    _, headers, _ = req(s3, "PUT", "/condbkt/obj", body=data)
    etag = headers["ETag"]
    # matching If-None-Match: 304, no body, cacheable headers still present
    status, headers, body = req(s3, "GET", "/condbkt/obj",
                                headers={"if-none-match": etag})
    assert status == 304 and body == b""
    assert headers["ETag"] == etag
    # bare (unquoted), weak, and wildcard forms all match
    for form in (etag.strip('"'), f"W/{etag}", "*",
                 f'"deadbeef", {etag}'):
        status, _, body = req(s3, "GET", "/condbkt/obj",
                              headers={"if-none-match": form})
        assert status == 304 and body == b"", form
    # mismatch: normal 200
    status, _, body = req(s3, "GET", "/condbkt/obj",
                          headers={"if-none-match": '"deadbeef"'})
    assert status == 200 and body == data


def test_conditional_get_if_match(s3):
    req(s3, "PUT", "/condbkt2")
    data = b"if-match body"
    _, headers, _ = req(s3, "PUT", "/condbkt2/obj", body=data)
    etag = headers["ETag"]
    for form in (etag, "*"):
        status, _, body = req(s3, "GET", "/condbkt2/obj",
                              headers={"if-match": form})
        assert status == 200 and body == data, form
    status, _, body = req(s3, "GET", "/condbkt2/obj",
                          headers={"if-match": '"deadbeef"'})
    assert status == 412 and b"PreconditionFailed" in body
    # conditional + Range compose: fresh etag ranges normally
    status, _, body = req(s3, "GET", "/condbkt2/obj",
                          headers={"if-match": etag, "range": "bytes=0-4"})
    assert status == 206 and body == data[:5]
    # If-None-Match wins over Range on a match (304 beats 206)
    status, _, body = req(s3, "GET", "/condbkt2/obj",
                          headers={"if-none-match": etag,
                                   "range": "bytes=0-4"})
    assert status == 304 and body == b""


def test_copy_object(s3):
    req(s3, "PUT", "/srcb")
    req(s3, "PUT", "/dstb")
    req(s3, "PUT", "/srcb/orig", body=b"copy me",
        headers={"content-type": "text/csv"})
    status, _, body = req(s3, "PUT", "/dstb/copied",
                          headers={"x-amz-copy-source": "/srcb/orig"})
    assert status == 200 and b"CopyObjectResult" in body
    status, headers, body = req(s3, "GET", "/dstb/copied")
    assert body == b"copy me" and headers["Content-Type"] == "text/csv"


def test_batch_delete(s3):
    req(s3, "PUT", "/batchb")
    for i in range(3):
        req(s3, "PUT", f"/batchb/k{i}", body=b"x")
    xml = ("<Delete>" + "".join(
        f"<Object><Key>k{i}</Key></Object>" for i in range(3)) + "</Delete>")
    status, _, body = req(s3, "POST", "/batchb", body=xml.encode(),
                          raw_query="delete=")
    assert status == 200 and body.count(b"<Deleted>") == 3
    for i in range(3):
        assert req(s3, "GET", f"/batchb/k{i}")[0] == 404


# -- listing -------------------------------------------------------------------

def test_list_v1_prefix_delimiter_and_truncation(s3):
    req(s3, "PUT", "/listb")
    keys = ["a/1.txt", "a/2.txt", "b/3.txt", "top.txt"]
    for k in keys:
        req(s3, "PUT", f"/listb/{k}", body=b"v")
    # no filters: all 4 keys
    _, _, body = req(s3, "GET", "/listb")
    root = xml_of(body)
    assert [e.findtext("Key") for e in root.iter("Contents")] == sorted(keys)
    # delimiter groups prefixes
    _, _, body = req(s3, "GET", "/listb", raw_query="delimiter=%2F")
    root = xml_of(body)
    assert [e.findtext("Prefix") for e in root.iter("CommonPrefixes")] == ["a/", "b/"]
    assert [e.findtext("Key") for e in root.iter("Contents")] == ["top.txt"]
    # prefix filter
    _, _, body = req(s3, "GET", "/listb", raw_query="prefix=a%2F")
    root = xml_of(body)
    assert [e.findtext("Key") for e in root.iter("Contents")] == ["a/1.txt", "a/2.txt"]
    # max-keys truncation + marker resume
    _, _, body = req(s3, "GET", "/listb", raw_query="max-keys=2")
    root = xml_of(body)
    assert root.findtext("IsTruncated") == "true"
    marker = root.findtext("NextMarker")
    _, _, body = req(s3, "GET", "/listb",
                     raw_query=f"marker={marker.replace('/', '%2F')}")
    root = xml_of(body)
    got = [e.findtext("Key") for e in root.iter("Contents")]
    assert got == [k for k in sorted(keys) if k > marker]


def test_list_v2(s3):
    req(s3, "PUT", "/listv2")
    for k in ("x/a", "x/b", "y"):
        req(s3, "PUT", f"/listv2/{k}", body=b"v")
    _, _, body = req(s3, "GET", "/listv2", raw_query="list-type=2")
    root = xml_of(body)
    assert root.findtext("KeyCount") == "3"


# -- multipart -----------------------------------------------------------------

def test_multipart_roundtrip(s3):
    req(s3, "PUT", "/mpb")
    status, _, body = req(s3, "POST", "/mpb/big.bin", raw_query="uploads=",
                          headers={"content-type": "video/mp4"})
    assert status == 200
    upload_id = xml_of(body).findtext("UploadId")
    parts = [b"A" * (1 << 18), b"B" * (1 << 18), b"C" * 1000]
    etags = []
    for i, part in enumerate(parts, start=1):
        status, headers, _ = req(
            s3, "PUT", "/mpb/big.bin", body=part,
            raw_query=f"partNumber={i}&uploadId={upload_id}")
        assert status == 200
        etags.append(headers["ETag"].strip('"'))
    # list parts
    status, _, body = req(s3, "GET", "/mpb/big.bin",
                          raw_query=f"uploadId={upload_id}")
    assert status == 200 and body.count(b"<Part>") == 3
    # list uploads
    status, _, body = req(s3, "GET", "/mpb", raw_query="uploads=")
    assert upload_id.encode() in body
    # complete
    xml = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i}</PartNumber><ETag>{e}</ETag></Part>"
        for i, e in enumerate(etags, start=1)) + "</CompleteMultipartUpload>")
    status, _, body = req(s3, "POST", "/mpb/big.bin", body=xml.encode(),
                          raw_query=f"uploadId={upload_id}")
    assert status == 200 and b"-3" in body  # multipart etag suffix
    status, headers, body = req(s3, "GET", "/mpb/big.bin")
    assert status == 200 and body == b"".join(parts)
    assert headers["Content-Type"] == "video/mp4"


def test_multipart_abort_and_bad_part(s3):
    req(s3, "PUT", "/mab")
    _, _, body = req(s3, "POST", "/mab/f", raw_query="uploads=")
    upload_id = xml_of(body).findtext("UploadId")
    req(s3, "PUT", "/mab/f", body=b"junk",
        raw_query=f"partNumber=1&uploadId={upload_id}")
    # wrong etag on complete
    xml = ("<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
           "<ETag>deadbeef</ETag></Part></CompleteMultipartUpload>")
    status, _, body = req(s3, "POST", "/mab/f", body=xml.encode(),
                          raw_query=f"uploadId={upload_id}")
    assert status == 400 and b"InvalidPart" in body
    assert req(s3, "DELETE", "/mab/f",
               raw_query=f"uploadId={upload_id}")[0] == 204
    # upload to aborted session
    status, _, body = req(s3, "PUT", "/mab/f", body=b"junk",
                          raw_query=f"partNumber=2&uploadId={upload_id}")
    assert status == 404 and b"NoSuchUpload" in body


# -- acl/policy ----------------------------------------------------------------

def test_acl_blocks_other_user_until_public(s3):
    req(s3, "PUT", "/aclb")
    req(s3, "PUT", "/aclb/secret", body=b"top")
    # bob can't read alice's private bucket
    status, _, body = req(s3, "GET", "/aclb/secret", ak=AK2, sk=SK2)
    assert status == 403 and b"AccessDenied" in body
    # flip to public-read
    assert req(s3, "PUT", "/aclb", headers={"x-amz-acl": "public-read"},
               raw_query="acl=")[0] == 200
    status, _, body = req(s3, "GET", "/aclb/secret", ak=AK2, sk=SK2)
    assert status == 200 and body == b"top"
    # but bob still can't write
    assert req(s3, "PUT", "/aclb/w", body=b"x", ak=AK2, sk=SK2)[0] == 403
    # acl xml readable
    status, _, body = req(s3, "GET", "/aclb", raw_query="acl=")
    assert status == 200 and b"AccessControlPolicy" in body


def test_bucket_policy_grants_and_denies(s3):
    req(s3, "PUT", "/polb")
    req(s3, "PUT", "/polb/public/doc", body=b"open")
    req(s3, "PUT", "/polb/private/doc", body=b"closed")
    policy = {
        "Version": "2012-10-17",
        "Statement": [
            {"Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
             "Resource": "arn:aws:s3:::polb/public/*"},
            {"Effect": "Deny", "Principal": "*", "Action": "s3:GetObject",
             "Resource": "arn:aws:s3:::polb/private/*"},
        ],
    }
    assert req(s3, "PUT", "/polb", body=json.dumps(policy).encode(),
               raw_query="policy=")[0] == 204
    assert req(s3, "GET", "/polb/public/doc", ak=AK2, sk=SK2)[0] == 200
    assert req(s3, "GET", "/polb/private/doc", ak=AK2, sk=SK2)[0] == 403
    # malformed policy rejected
    status, _, body = req(s3, "PUT", "/polb", body=b'{"nope": 1}',
                          raw_query="policy=")
    assert status == 400 and b"MalformedPolicy" in body
    # get + delete
    status, _, body = req(s3, "GET", "/polb", raw_query="policy=")
    assert status == 200 and json.loads(body)["Version"] == "2012-10-17"
    assert req(s3, "DELETE", "/polb", raw_query="policy=")[0] == 204
    assert req(s3, "GET", "/polb", raw_query="policy=")[0] == 404


# -- cors / tagging ------------------------------------------------------------

def test_cors_config_and_preflight(s3):
    req(s3, "PUT", "/corsb")
    xml = ("<CORSConfiguration><CORSRule>"
           "<AllowedOrigin>https://ok.example</AllowedOrigin>"
           "<AllowedMethod>GET</AllowedMethod>"
           "<MaxAgeSeconds>300</MaxAgeSeconds>"
           "</CORSRule></CORSConfiguration>")
    assert req(s3, "PUT", "/corsb", body=xml.encode(),
               raw_query="cors=")[0] == 200
    status, headers, _ = req(s3, "OPTIONS", "/corsb/any", ak=None, headers={
        "origin": "https://ok.example", "access-control-request-method": "GET"})
    assert status == 200
    assert headers["Access-Control-Allow-Origin"] == "https://ok.example"
    assert headers["Access-Control-Max-Age"] == "300"
    status, _, _ = req(s3, "OPTIONS", "/corsb/any", ak=None, headers={
        "origin": "https://evil.example", "access-control-request-method": "GET"})
    assert status == 403
    assert req(s3, "DELETE", "/corsb", raw_query="cors=")[0] == 204


def test_object_tagging_roundtrip(s3):
    req(s3, "PUT", "/tagb")
    req(s3, "PUT", "/tagb/obj", body=b"x")
    xml = ("<Tagging><TagSet><Tag><Key>env</Key><Value>prod</Value></Tag>"
           "</TagSet></Tagging>")
    assert req(s3, "PUT", "/tagb/obj", body=xml.encode(),
               raw_query="tagging=")[0] == 200
    status, _, body = req(s3, "GET", "/tagb/obj", raw_query="tagging=")
    assert status == 200 and b"<Key>env</Key><Value>prod</Value>" in body
    assert req(s3, "DELETE", "/tagb/obj", raw_query="tagging=")[0] == 204
    _, _, body = req(s3, "GET", "/tagb/obj", raw_query="tagging=")
    assert b"<Tag>" not in body


def test_delimiter_pagination_advances_past_prefixes(s3):
    """NextMarker that is a CommonPrefix must not re-emit the same group."""
    req(s3, "PUT", "/pageb")
    for k in ("a/1", "a/2", "b/1", "c.txt"):
        req(s3, "PUT", f"/pageb/{k}", body=b"v")
    seen_prefixes, seen_keys, marker = [], [], ""
    for _ in range(10):
        q = "delimiter=%2F&max-keys=1" + (
            f"&marker={marker.replace('/', '%2F')}" if marker else "")
        _, _, body = req(s3, "GET", "/pageb", raw_query=q)
        root = xml_of(body)
        seen_prefixes += [e.findtext("Prefix") for e in root.iter("CommonPrefixes")]
        seen_keys += [e.findtext("Key") for e in root.iter("Contents")]
        if root.findtext("IsTruncated") != "true":
            break
        marker = root.findtext("NextMarker")
    else:
        pytest.fail("pagination never terminated")
    assert seen_prefixes == ["a/", "b/"]
    assert seen_keys == ["c.txt"]


def test_write_grant_cannot_rewrite_acl(s3):
    """S3 ACP split: WRITE lets you put objects, not replace the ACL."""
    req(s3, "PUT", "/acpb", headers={"x-amz-acl": "public-read-write"})
    # bob can write objects...
    assert req(s3, "PUT", "/acpb/bobfile", body=b"x", ak=AK2, sk=SK2)[0] == 200
    # ...but cannot flip the bucket private
    status, _, _ = req(s3, "PUT", "/acpb", headers={"x-amz-acl": "private"},
                       raw_query="acl=", ak=AK2, sk=SK2)
    assert status == 403


def test_object_acl_grants_access(s3):
    """A public-read OBJECT acl opens that object in a private bucket."""
    req(s3, "PUT", "/oaclb")
    req(s3, "PUT", "/oaclb/open", body=b"shared")
    req(s3, "PUT", "/oaclb/closed", body=b"private")
    assert req(s3, "PUT", "/oaclb/open", headers={"x-amz-acl": "public-read"},
               raw_query="acl=")[0] == 200
    assert req(s3, "GET", "/oaclb/open", ak=AK2, sk=SK2)[0] == 200
    assert req(s3, "GET", "/oaclb/closed", ak=AK2, sk=SK2)[0] == 403


def test_namespaced_xml_bodies(s3):
    """boto3-style bodies carry the S3 xmlns; parsing must still see tags."""
    req(s3, "PUT", "/nsb")
    req(s3, "PUT", "/nsb/k1", body=b"x")
    xml = ('<Delete xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
           "<Object><Key>k1</Key></Object></Delete>")
    status, _, body = req(s3, "POST", "/nsb", body=xml.encode(),
                          raw_query="delete=")
    assert status == 200 and b"<Deleted><Key>k1</Key></Deleted>" in body
    assert req(s3, "GET", "/nsb/k1")[0] == 404


def test_xml_special_chars_in_keys_escaped(s3):
    req(s3, "PUT", "/escb")
    key = "a&b<c>.txt"
    req(s3, "PUT", f"/escb/{urllib.parse.quote(key)}", body=b"v")
    status, _, body = req(s3, "GET", "/escb")
    assert status == 200
    root = xml_of(body)  # would raise on bare & or <
    assert [e.findtext("Key") for e in root.iter("Contents")] == [key]


def test_bucket_tagging_requires_auth(s3):
    req(s3, "PUT", "/tauth")
    xml = ("<Tagging><TagSet><Tag><Key>a</Key><Value>b</Value></Tag>"
           "</TagSet></Tagging>")
    # unsigned write rejected
    status, _, _ = req(s3, "PUT", "/tauth", body=xml.encode(), ak=None,
                       raw_query="tagging=")
    assert status == 403
    status, _, _ = req(s3, "DELETE", "/tauth", ak=None, raw_query="cors=")
    assert status == 403


def test_malformed_upload_id_is_404_not_500(s3):
    req(s3, "PUT", "/badup")
    status, _, body = req(s3, "DELETE", "/badup/k",
                          raw_query="uploadId=garbage")
    assert status == 404 and b"NoSuchUpload" in body
    status, _, body = req(s3, "PUT", "/badup/k", body=b"x",
                          raw_query="partNumber=abc&uploadId=1.x")
    assert status == 400 and b"InvalidArgument" in body


def test_dir_marker_objects(s3):
    req(s3, "PUT", "/dirb")
    assert req(s3, "PUT", "/dirb/folder/")[0] == 200
    status, _, body = req(s3, "GET", "/dirb")
    assert status == 200 and b"<Key>folder/</Key>" in body
    assert req(s3, "DELETE", "/dirb/folder/")[0] == 204
