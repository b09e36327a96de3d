"""AuthNode HTTP API (authnode/api_service.go surface over the rpc framework).

Routes mirror the reference's ticket + key admin endpoints:
  POST /client/getticket   {client_id, service_id, verifier, ts} -> {sealed}
  POST /admin/createkey    {id, role, caps?}          -> {id, key(b64)}
  POST /admin/deletekey    {id}
  POST /admin/addcaps      {id, caps}                 -> {caps}
Admin routes are protected by the shared-secret auth middleware
(common/rpc/auth analog), standing in for the reference's admin tickets.
"""

from __future__ import annotations

import base64

from chubaofs_tpu_torch.authnode.server import AuthError, AuthNode, TicketError
from chubaofs_tpu_torch.rpc import HTTPError, Response, Router
from chubaofs_tpu_torch.rpc.server import auth_middleware


def build_router(node: AuthNode, admin_secret: bytes | None = None) -> Router:
    r = Router()

    def getticket(req):
        d = req.json()
        try:
            return node.get_ticket(d["client_id"], d["service_id"],
                                   d["verifier"], float(d["ts"]))
        except TicketError as e:
            raise HTTPError(403, "TicketDenied", str(e)) from None
        except AuthError as e:
            raise HTTPError(404, "NoSuchKey", str(e)) from None

    r.post("/client/getticket", getticket)

    admin = Router()

    def createkey(req):
        d = req.json()
        try:
            key = node.create_key(d["id"], d["role"], d.get("caps"))
        except AuthError as e:
            raise HTTPError(409, "KeyExists", str(e)) from None
        return {"id": d["id"], "key": base64.b64encode(key).decode()}

    def createkeys(req):
        # bulk bootstrap: every key in ONE raft group-commit round
        d = req.json()
        try:
            keys = node.create_keys([(e["id"], e["role"]) for e in d["entries"]])
        except AuthError as e:
            raise HTTPError(409, "KeyExists", str(e)) from None
        return {"keys": {i: base64.b64encode(k).decode()
                         for i, k in keys.items()}}

    def deletekey(req):
        try:
            node.delete_key(req.json()["id"])
        except AuthError as e:
            raise HTTPError(404, "NoSuchKey", str(e)) from None
        return Response(204)

    def addcaps(req):
        d = req.json()
        try:
            return {"caps": node.add_caps(d["id"], d["caps"])}
        except AuthError as e:
            raise HTTPError(404, "NoSuchKey", str(e)) from None

    if admin_secret is not None:
        admin.middleware.append(auth_middleware(admin_secret))
    admin.post("/admin/createkey", createkey)
    admin.post("/admin/createkeys", createkeys)
    admin.post("/admin/deletekey", deletekey)
    admin.post("/admin/addcaps", addcaps)

    # mount admin under the same router; its middleware applies to /admin/*
    def admin_dispatch(req):
        return admin.dispatch(req)

    r.post("/admin/:op", admin_dispatch)
    return r


class RemoteAuthNode:
    """HTTP twin of the in-process AuthNode ticket surface: lets AuthClient /
    RenewingTicket target a remote authnode daemon (sdk/auth over the wire)."""

    def __init__(self, addrs: list[str]):
        from chubaofs_tpu_torch.rpc.client import RPCClient

        self.rpc = RPCClient(list(addrs), retries=3)

    def get_ticket(self, client_id: str, service_id: str, verifier: str,
                   ts: float) -> dict:
        return self.rpc.post("/client/getticket", {
            "client_id": client_id, "service_id": service_id,
            "verifier": verifier, "ts": ts,
        })
