"""Access HTTP gateway — the network face of the blobstore access layer.

Reference counterpart: blobstore/access/service.go (HTTP PUT/GET/DELETE
stream API) + api/access/client.go:248,388 (the typed client every consumer
uses). Kept: the three-verb surface (put returns a signed Location token the
caller must present back; get takes a byte range; delete is fire-and-ack),
JSON Location bodies, and a client whose put/get/delete signature matches the
in-process `Access` object so `sdk/data/blobstore`-style consumers are
transport-blind. Changed: the reference streams multi-blob bodies with
chunked encoding; blobs here ride whole HTTP bodies (the codec service under
the gateway already batches stripes for the device)."""

from __future__ import annotations

from chubaofs_tpu_torch.blobstore.access import Access, AccessError, Location
from chubaofs_tpu_torch.rpc.client import RPCClient
from chubaofs_tpu_torch.rpc.errors import HTTPError
from chubaofs_tpu_torch.rpc.router import Request, Response, Router
from chubaofs_tpu_torch.rpc.server import RPCServer


def parse_http_range(rng: str, size: int) -> tuple[int, int] | None:
    """`bytes=lo-hi` / `bytes=lo-` / `bytes=-N` -> (offset, length), clipped
    to the object. None means syntactically valid but unsatisfiable (RFC
    9110: the caller answers 416); malformed raises ValueError (400)."""
    if not rng.startswith("bytes="):
        raise ValueError(f"unsupported range unit: {rng}")
    lo_s, dash, hi_s = rng[len("bytes="):].partition("-")
    if not dash or (not lo_s and not hi_s):
        raise ValueError(f"malformed range: {rng}")
    if lo_s == "":  # suffix form bytes=-N: the last N bytes
        length = int(hi_s)
        if length <= 0:
            return None
        lo = max(0, size - length)
        hi = size - 1
    else:
        lo = int(lo_s)
        hi = int(hi_s) if hi_s else size - 1
    if lo >= size or lo > hi:
        return None
    hi = min(hi, size - 1)
    return lo, hi - lo + 1


def build_router(access: Access) -> Router:
    r = Router()

    def put(req: Request):
        try:
            loc = access.put(req.body)
        except AccessError as e:
            raise HTTPError(500, msg=str(e), code="AccessError") from None
        return Response(200, {"Content-Type": "application/json"},
                        loc.to_json().encode())

    def get(req: Request):
        loc = req.q("location")
        rng = req.header("range")
        if rng:
            # HTTP Range surface (the S3-shaped path): 206 + Content-Range,
            # 416 on an unsatisfiable window — the ranged read underneath is
            # the byte-window shard gather, so the wire AND the backend both
            # move window bytes only
            try:
                obj_size = Location.from_json(loc).size
            except Exception:
                raise HTTPError(400, msg="bad location token",
                                code="LocationError") from None
            try:
                parsed = parse_http_range(rng, obj_size)
            except ValueError as e:
                raise HTTPError(400, msg=str(e), code="InvalidRange") from None
            if parsed is None:
                return Response(416, {"Content-Range": f"bytes */{obj_size}"})
            offset, size = parsed
            try:
                data = access.get(loc, offset, size)
            except AccessError as e:
                raise HTTPError(404, msg=str(e), code="AccessError") from None
            return Response(
                206,
                {"Content-Type": "application/octet-stream",
                 "Content-Range":
                     f"bytes {offset}-{offset + size - 1}/{obj_size}"},
                data)
        offset = int(req.q("offset", "0"))
        size = int(req.q("size", "-1"))
        try:
            data = access.get(loc, offset, None if size < 0 else size)
        except AccessError as e:
            raise HTTPError(404, msg=str(e), code="AccessError") from None
        return Response(200, {"Content-Type": "application/octet-stream"}, data)

    def delete(req: Request):
        try:
            access.delete(req.body.decode())
        except AccessError as e:
            raise HTTPError(500, msg=str(e), code="AccessError") from None
        return Response(200)

    def get_by_body(req: Request):
        # the Location token is long; it rides the body of a POST /get
        import json

        body = json.loads(req.body.decode())
        offset = int(body.get("offset", 0))
        size = int(body.get("size", -1))
        try:
            data = access.get(body["location"], offset,
                              None if size < 0 else size)
        except AccessError as e:
            raise HTTPError(404, msg=str(e), code="AccessError") from None
        return Response(200, {"Content-Type": "application/octet-stream"}, data)

    r.put("/put", put)
    r.post("/get", get_by_body)
    r.get("/get", get)
    r.post("/delete", delete)
    return r


class AccessGateway:
    """Standalone access server. `router_hook(router)` lets the caller mount
    extra routes (the blobstore daemon adds its admin surface this way)."""

    def __init__(self, access: Access, host: str = "127.0.0.1", port: int = 0,
                 router_hook=None):
        router = build_router(access)
        if router_hook is not None:
            router_hook(router)
        self.server = RPCServer(router, host=host, port=port, module="access")
        self.server.start()
        self.addr = self.server.addr

    def stop(self):
        self.server.stop()


class AccessClient:
    """api/access client analog; mirrors the in-process Access surface.
    `pooled=False` forces connect-per-request (the perfbench A/B control)."""

    def __init__(self, hosts: list[str], retries: int = 3, pooled: bool = True):
        self.rpc = RPCClient(hosts, retries=retries, pooled=pooled)

    def put(self, data: bytes) -> Location:
        status, _, body = self.rpc.do("PUT", "/put", data)
        if status != 200:
            raise AccessError(body.decode() or f"put failed: {status}")
        return Location.from_json(body.decode())

    def get(self, loc: Location | str, offset: int = 0,
            size: int | None = None) -> bytes:
        import json

        token = loc.to_json() if isinstance(loc, Location) else loc
        payload = json.dumps({"location": token, "offset": offset,
                              "size": -1 if size is None else size}).encode()
        status, _, body = self.rpc.do("POST", "/get", payload)
        if status != 200:
            raise AccessError(body.decode() or f"get failed: {status}")
        return body

    def get_range(self, loc: Location | str,
                  rng: str) -> tuple[int, dict, bytes]:
        """HTTP `Range:` GET — returns the raw (status, headers, body) so
        the caller sees 206/416 and Content-Range, the contract an S3-style
        frontend proxies through verbatim."""
        import urllib.parse

        token = loc.to_json() if isinstance(loc, Location) else loc
        return self.rpc.do(
            "GET", f"/get?location={urllib.parse.quote(token, safe='')}",
            headers={"Range": rng})

    def delete(self, loc: Location | str) -> None:
        token = loc.to_json() if isinstance(loc, Location) else loc
        status, _, body = self.rpc.do("POST", "/delete", token.encode())
        if status != 200:
            raise AccessError(body.decode() or f"delete failed: {status}")
