"""The rpc cases of tests/test_infra.py, run against the port.

Routes with path params and typed errors, crc-protected bodies with
/metrics, shared-secret auth middleware, and query-conditioned routes over a
real RPCServer and RPCClient."""

import pytest

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.rpc import HTTPError, RPCClient, RPCServer, Response, Router
from chubaofs_tpu_torch.rpc.server import audit_middleware, auth_middleware, crc_middleware
from chubaofs_tpu_torch.utils.auditlog import AuditLog
from chubaofs_tpu_torch.utils.exporter import Registry


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture()
def rpc_server(tmp_path):
    router = Router()
    reg = Registry("t", "svc")
    reg.gauge("up").set(1)
    audit = AuditLog(str(tmp_path))
    router.middleware.append(audit_middleware(audit))
    router.middleware.append(crc_middleware)
    router.get("/get/:vid", lambda r: {"vid": int(r.params["vid"])})
    router.post("/echo", lambda r: Response(200, {}, r.body))
    router.get("/boom", lambda r: (_ for _ in ()).throw(
        HTTPError(404, "NotFound", "vanished")))
    srv = RPCServer(router, registry=reg).start()
    yield srv
    srv.stop()
    audit.close()


def test_rpc_route_params_and_errors(rpc_server):
    cli = RPCClient([rpc_server.addr])
    assert cli.get("/get/42") == {"vid": 42}
    with pytest.raises(HTTPError) as ei:
        cli.get("/boom")
    assert ei.value.status == 404 and ei.value.code == "NotFound"
    status, _, _ = cli.do("GET", "/nope")
    assert status == 404


def test_rpc_crc_body_and_metrics(rpc_server):
    cli = RPCClient([rpc_server.addr])
    status, _, data = cli.do("POST", "/echo", b"payload", crc=True)
    assert status == 200 and data == b"payload"
    # corrupt crc rejected
    status, _, _ = cli.do("POST", "/echo", b"payload",
                          headers={"x-crc-body": "1"})
    assert status == 400
    status, _, text = cli.do("GET", "/metrics")
    assert status == 200 and b"cfs_t_svc" in text


def test_rpc_auth_middleware():
    router = Router()
    router.middleware.append(auth_middleware(b"s3cret"))
    router.get("/ok", lambda r: {"ok": True})
    srv = RPCServer(router).start()
    try:
        good = RPCClient([srv.addr], auth_secret=b"s3cret")
        assert good.get("/ok") == {"ok": True}
        bad = RPCClient([srv.addr], auth_secret=b"wrong")
        with pytest.raises(HTTPError) as ei:
            bad.get("/ok")
        assert ei.value.status == 403
    finally:
        srv.stop()


def test_router_query_conditions():
    router = Router()
    router.get("/b/:name", lambda r: {"which": "uploads"}, queries={"uploads": None})
    router.get("/b/:name", lambda r: {"which": "plain"})
    from chubaofs_tpu_torch.rpc.router import parse_request

    req = parse_request("GET", "/b/x?uploads=", {}, b"")
    assert router.dispatch(req).body == b'{"which": "uploads"}'
    req2 = parse_request("GET", "/b/x", {}, b"")
    assert router.dispatch(req2).body == b'{"which": "plain"}'

