"""The cases of tests/test_authnode.py, run against the port on the CPU.

AuthNode ticket service + cryptoutil tests (authnode/ + util/cryptoutil)."""

import json
import time

import pytest
import torch

from chubaofs_tpu_torch.authnode import AUTH_GROUP, AuthClient, TicketError
from chubaofs_tpu_torch.authnode.api import build_router
from chubaofs_tpu_torch.authnode.server import verify_ticket
from chubaofs_tpu_torch.deploy import FsCluster
from chubaofs_tpu_torch.rpc import HTTPError, RPCClient, RPCServer
from chubaofs_tpu_torch.utils import cryptoutil

from chubaofs_tpu_torch import chaos as t_chaos

# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


CPU = "cpu"


# -- cryptoutil ----------------------------------------------------------------

def test_seal_open_roundtrip_and_tamper():
    key = cryptoutil.gen_key()
    msg = b"the keystore payload" * 10
    blob = cryptoutil.seal(key, msg, aad=b"svc1")
    assert cryptoutil.open_sealed(key, blob, aad=b"svc1") == msg
    # wrong aad
    with pytest.raises(cryptoutil.AuthTagError):
        cryptoutil.open_sealed(key, blob, aad=b"svc2")
    # flipped ciphertext bit
    bad = bytearray(blob)
    bad[20] ^= 1
    with pytest.raises(cryptoutil.AuthTagError):
        cryptoutil.open_sealed(key, bytes(bad), aad=b"svc1")
    # wrong key
    with pytest.raises(cryptoutil.AuthTagError):
        cryptoutil.open_sealed(cryptoutil.gen_key(), blob, aad=b"svc1")


def test_seal_unique_nonces():
    key = cryptoutil.gen_key()
    assert cryptoutil.seal(key, b"x") != cryptoutil.seal(key, b"x")


# -- ticket flow ---------------------------------------------------------------

@pytest.fixture(scope="module")
def auth_cluster(tmp_path_factory):
    root = tmp_path_factory.mktemp("auth")
    cluster = FsCluster(str(root), n_nodes=3, blob_nodes=6, data_nodes=0,
                        device=CPU)
    cluster.settle(lambda: any(
        r.is_leader(AUTH_GROUP) for r in cluster.rafts.values()))
    yield cluster
    cluster.close()


def test_ticket_grant_and_service_verify(auth_cluster):
    an = auth_cluster.authnode()
    svc_key = an.create_key("objectnode", "service")
    cli_key = an.create_key("alice", "client",
                            caps=["objectnode:GetObject", "objectnode:PutObject"])
    client = AuthClient(an, "alice", cli_key)
    grant = client.get_ticket("objectnode")
    assert grant["exp"] > time.time()
    claims = verify_ticket("objectnode", svc_key, grant["ticket"],
                           action="PutObject")
    assert claims["client_id"] == "alice"
    assert claims["session_key"] == grant["session_key"]
    # cap not granted
    with pytest.raises(TicketError):
        verify_ticket("objectnode", svc_key, grant["ticket"],
                      action="DeleteObject")
    # ticket sealed for another service can't be opened
    other_key = an.create_key("master", "service")
    with pytest.raises(TicketError):
        verify_ticket("master", other_key, grant["ticket"])


def test_ticket_requires_valid_client_verifier(auth_cluster):
    an = auth_cluster.authnode()
    an.create_key("svc2", "service")
    an.create_key("mallory", "client")
    with pytest.raises(TicketError):
        an.get_ticket("mallory", "svc2", "AAAA", time.time())
    # replay window
    client = AuthClient(an, "mallory", b"wrongkey-32-bytes-wrongkey-32-by")
    with pytest.raises(TicketError):
        client.get_ticket("svc2")


def test_keystore_replicated_across_nodes(auth_cluster):
    an = auth_cluster.authnode()
    an.create_key("replicated-id", "client")
    auth_cluster.settle(lambda: all(
        "replicated-id" in sm.keys
        for sm in auth_cluster.keystore_sms.values()))
    for sm in auth_cluster.keystore_sms.values():
        assert sm.get("replicated-id")["role"] == "client"
    an.delete_key("replicated-id")
    auth_cluster.settle(lambda: all(
        "replicated-id" not in sm.keys
        for sm in auth_cluster.keystore_sms.values()))


def test_duplicate_key_error_does_not_poison_raft(auth_cluster):
    """Errors travel as values through the SM — a duplicate create must fail
    cleanly and later proposals on the same raft node must still work."""
    from chubaofs_tpu_torch.authnode.server import AuthError

    an = auth_cluster.authnode()
    an.create_key("dup", "client")
    with pytest.raises(AuthError):
        an.create_key("dup", "client")
    # the pump survived: a fresh create still commits
    an.create_key("after-dup", "client")
    assert an.sm.get("after-dup")["role"] == "client"
    with pytest.raises(AuthError):
        an.delete_key("never-existed")


def test_bulk_create_keys_one_commit_round(auth_cluster):
    """create_keys mints several keys through ONE drained raft batch; all
    land, all replicate, and a duplicate in a later batch fails alone."""
    from chubaofs_tpu_torch.authnode.server import AuthError

    an = auth_cluster.authnode()
    keys = an.create_keys([("bulk-svc", "service"), ("bulk-a", "client"),
                           ("bulk-b", "client")])
    assert set(keys) == {"bulk-svc", "bulk-a", "bulk-b"}
    assert an.sm.get("bulk-svc")["role"] == "service"
    auth_cluster.settle(lambda: all(
        "bulk-b" in sm.keys for sm in auth_cluster.keystore_sms.values()))
    with pytest.raises(AuthError):
        an.create_keys([("bulk-a", "client")])  # dup fails as a value
    an.create_key("bulk-c", "client")  # pump healthy after the error


def test_caps_grant_scoped_to_service(auth_cluster):
    an = auth_cluster.authnode()
    skey = an.create_key("svcA", "service")
    an.create_key("svcB", "service")
    ckey = an.create_key("carol", "client", caps=["svcA:Read", "svcB:Write"])
    grant = AuthClient(an, "carol", ckey).get_ticket("svcA")
    claims = verify_ticket("svcA", skey, grant["ticket"])
    assert claims["caps"] == ["svcA:Read"]  # svcB caps filtered out
    an.add_caps("carol", ["svcA:Write"])
    grant = AuthClient(an, "carol", ckey).get_ticket("svcA")
    claims = verify_ticket("svcA", skey, grant["ticket"], action="Write")
    assert "svcA:Write" in claims["caps"]


# -- HTTP API ------------------------------------------------------------------

def test_authnode_http_api(auth_cluster):
    an = auth_cluster.authnode()
    srv = RPCServer(build_router(an, admin_secret=b"adm1n")).start()
    try:
        admin = RPCClient([srv.addr], auth_secret=b"adm1n")
        out = admin.post("/admin/createkey",
                         {"id": "httpsvc", "role": "service"})
        import base64

        svc_key = base64.b64decode(out["key"])
        out = admin.post("/admin/createkey",
                         {"id": "httpcli", "role": "client",
                          "caps": ["httpsvc:*"]})
        cli_key = base64.b64decode(out["key"])
        out = admin.post("/admin/createkeys", {"entries": [
            {"id": "hbulk1", "role": "client"},
            {"id": "hbulk2", "role": "client"}]})
        assert set(out["keys"]) == {"hbulk1", "hbulk2"}
        # unauthenticated admin rejected
        noauth = RPCClient([srv.addr])
        with pytest.raises(HTTPError) as ei:
            noauth.post("/admin/createkey", {"id": "x", "role": "client"})
        assert ei.value.status == 403
        # ticket over HTTP
        ts = time.time()
        msg = f"httpcli:httpsvc:{ts}".encode()
        verifier = base64.b64encode(
            cryptoutil.hmac_sha256(cli_key, msg)).decode()
        reply = noauth.post("/client/getticket", {
            "client_id": "httpcli", "service_id": "httpsvc",
            "verifier": verifier, "ts": ts})
        plain = cryptoutil.open_sealed(cli_key,
                                       base64.b64decode(reply["sealed"]),
                                       aad=b"httpcli")
        grant = json.loads(plain)
        claims = verify_ticket("httpsvc", svc_key, grant["ticket"],
                               action="Anything")
        assert claims["client_id"] == "httpcli"
    finally:
        srv.stop()
