"""Pattern router (blobstore/common/rpc router + gorilla/mux analog).

Reference counterpart: common/rpc's router (method + path patterns with
:params, e.g. /get/:vid) and gorilla/mux as used by objectnode/router.go:26.
Kept: method tables, ``:name`` path parameters, longest-literal-first match
order, per-route middleware chain, and query-condition matching (mux's
``Queries``) which S3 routing leans on (?uploads, ?acl, list-type=2...).
"""

from __future__ import annotations

import json
import urllib.parse
from dataclasses import dataclass, field


@dataclass
class Request:
    method: str
    path: str  # decoded path, no query
    query: dict[str, list[str]]
    headers: dict[str, str]  # lower-cased keys
    body: bytes
    params: dict[str, str] = field(default_factory=dict)
    remote: str = "-"
    raw_query: str = ""

    def q(self, key: str, default: str = "") -> str:
        v = self.query.get(key)
        return v[0] if v else default

    def q_int(self, key: str, default: int) -> int:
        """Integer query param; malformed values degrade to the default and
        negatives clamp to 0 (introspection endpoints must not 500 on a
        typo'd ?n=, and ?n=-5 must not invert a recency window)."""
        try:
            return max(0, int(self.q(key) or default))
        except ValueError:
            return default

    def has_q(self, key: str) -> bool:
        return key in self.query

    def header(self, key: str, default: str = "") -> str:
        return self.headers.get(key.lower(), default)

    def json(self):
        return json.loads(self.body.decode() or "null")


@dataclass
class Response:
    status: int = 200
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    @classmethod
    def json(cls, obj, status: int = 200) -> "Response":
        return cls(status, {"Content-Type": "application/json"},
                   json.dumps(obj).encode())

    @classmethod
    def xml(cls, text: str, status: int = 200) -> "Response":
        return cls(status, {"Content-Type": "application/xml"}, text.encode())


class _Route:
    def __init__(self, method: str, pattern: str, handler, queries: dict | None):
        self.method = method
        self.parts = [p for p in pattern.split("/") if p != ""]
        self.wildcard = (self.parts[-1][1:]
                         if self.parts and self.parts[-1].startswith("*") else None)
        self.absolute = pattern == "/"
        self.handler = handler
        self.queries = queries or {}
        # more literal segments + more query conditions bind tighter
        self.rank = (sum(1 for p in self.parts if not p.startswith(":")),
                     len(self.queries))

    def match(self, method: str, path_parts: list[str],
              query: dict[str, list[str]]) -> dict | None:
        if method != self.method:
            return None
        if self.absolute:
            return {} if not path_parts else None
        if len(path_parts) != len(self.parts):
            # a trailing *param swallows extra segments (objectnode object
            # keys) but never matches empty — /b must not match /:bucket/*key
            if not (self.parts and self.parts[-1].startswith("*")
                    and len(path_parts) >= len(self.parts)):
                return None
        params: dict[str, str] = {}
        for i, spec in enumerate(self.parts):
            if spec.startswith("*"):
                params[spec[1:]] = "/".join(path_parts[i:])
                break
            if i >= len(path_parts):
                return None
            if spec.startswith(":"):
                params[spec[1:]] = path_parts[i]
            elif spec != path_parts[i]:
                return None
        for k, want in self.queries.items():
            got = query.get(k)
            if got is None:
                return None
            if want is not None and (not got or got[0] != want):
                return None
        return params


class Router:
    def __init__(self):
        self._routes: list[_Route] = []
        self.middleware: list = []  # callables: (request, next) -> Response

    def handle(self, method: str, pattern: str, handler, queries: dict | None = None):
        self._routes.append(_Route(method.upper(), pattern, handler, queries))
        self._routes.sort(key=lambda r: r.rank, reverse=True)

    def get(self, pattern: str, handler, **kw):
        self.handle("GET", pattern, handler, **kw)

    def post(self, pattern: str, handler, **kw):
        self.handle("POST", pattern, handler, **kw)

    def put(self, pattern: str, handler, **kw):
        self.handle("PUT", pattern, handler, **kw)

    def delete(self, pattern: str, handler, **kw):
        self.handle("DELETE", pattern, handler, **kw)

    def head(self, pattern: str, handler, **kw):
        self.handle("HEAD", pattern, handler, **kw)

    def dispatch(self, req: Request) -> Response:
        from chubaofs_tpu_torch.rpc.errors import HTTPError

        parts = [p for p in req.path.split("/") if p != ""]
        chosen = None
        for route in self._routes:
            params = route.match(req.method, parts, req.query)
            if params is not None:
                # wildcard params keep the trailing slash (S3 dir-marker keys)
                if (route.wildcard and req.path.endswith("/")
                        and params.get(route.wildcard)):
                    params[route.wildcard] += "/"
                chosen = (route, params)
                break

        def run(r: Request) -> Response:
            if chosen is None:
                return Response(404, {}, b'{"error":"no route"}')
            r.params = chosen[1]
            try:
                out = chosen[0].handler(r)
            except HTTPError as e:
                return Response(e.status, {"Content-Type": "application/json"},
                                e.body())
            if isinstance(out, Response):
                return out
            if out is None:
                return Response(200)
            if isinstance(out, (bytes, bytearray)):
                return Response(200, {}, bytes(out))
            return Response.json(out)

        handler = run
        for mw in reversed(self.middleware):
            handler = (lambda m, nxt: lambda r: m(r, nxt))(mw, handler)
        try:
            return handler(req)
        except HTTPError as e:
            return Response(e.status, {"Content-Type": "application/json"}, e.body())
        except Exception as e:  # handler/middleware bug -> 500, never a dead socket
            body = json.dumps({"error": f"{type(e).__name__}: {e}",
                               "code": "InternalServerError"}).encode()
            return Response(500, {"Content-Type": "application/json"}, body)


def parse_request(method: str, target: str, headers, body: bytes,
                  remote: str = "-") -> Request:
    parsed = urllib.parse.urlsplit(target)
    query = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
    hdrs = {k.lower(): v for k, v in headers.items()}
    return Request(method.upper(), urllib.parse.unquote(parsed.path), query,
                   hdrs, body, remote=remote, raw_query=parsed.query)
