"""GraphQL endpoint on the master (master/gapi_*.go analog).

Reference counterpart: master/gapi_cluster.go, gapi_volume.go, gapi_user.go —
the console's query surface. Kept: a POST /graphql endpoint taking
{"query": "...", "variables": {...}} and the reference's root fields
(clusterView, clusterStat, volumeList, volume(name), userList,
userInfo(userID)).
Changed: a purpose-built micro-parser for the query subset the console
emits — field selection with scalar arguments and nested selection sets —
instead of a full GraphQL implementation; unknown syntax is rejected.
"""

from __future__ import annotations

import re
from dataclasses import asdict

TOKEN = re.compile(r"""
    (?P<name>[_A-Za-z][_0-9A-Za-z]*)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<punct>[{}():,$!\[\]=@])
  | (?P<ws>[\s]+)
""", re.VERBOSE)


class GQLError(Exception):
    pass


def _tokenize(src: str):
    pos = 0
    out = []
    while pos < len(src):
        m = TOKEN.match(src, pos)
        if not m:
            raise GQLError(f"bad character at {pos}: {src[pos:pos+10]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append((kind, m.group()))
    return out


class _Parser:
    """query ::= ['query' name? varDefs?] selectionSet
    selectionSet ::= '{' field+ '}'
    field ::= name args? selectionSet?
    args ::= '(' (name ':' value),* ')'"""

    def __init__(self, tokens, variables):
        self.toks = tokens
        self.i = 0
        self.vars = variables or {}

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def take(self, want_val=None):
        kind, val = self.peek()
        if kind is None or (want_val is not None and val != want_val):
            raise GQLError(f"expected {want_val!r}, got {val!r}")
        self.i += 1
        return kind, val

    def parse(self):
        kind, val = self.peek()
        if kind == "name" and val in ("query", "mutation"):
            if val == "mutation":
                raise GQLError("mutations not supported")
            self.take()
            if self.peek()[0] == "name":  # operation name
                self.take()
            if self.peek()[1] == "(":  # variable defs: skip to matching ')'
                depth = 0
                while True:
                    _, v = self.take()
                    if v == "(":
                        depth += 1
                    elif v == ")":
                        depth -= 1
                        if depth == 0:
                            break
        return self.selection_set()

    def selection_set(self):
        self.take("{")
        fields = []
        while self.peek()[1] != "}":
            fields.append(self.field())
        self.take("}")
        return fields

    def field(self):
        _, name = self.take()
        args = {}
        if self.peek()[1] == "(":
            self.take("(")
            while self.peek()[1] != ")":
                _, argname = self.take()
                self.take(":")
                args[argname] = self.value()
                if self.peek()[1] == ",":
                    self.take(",")
            self.take(")")
        sub = None
        if self.peek()[1] == "{":
            sub = self.selection_set()
        return {"name": name, "args": args, "fields": sub}

    def value(self):
        import json as _json

        kind, val = self.take()
        if kind == "string":
            # GraphQL string escapes are JSON's; json.loads keeps UTF-8 intact
            # (unicode_escape would mojibake non-ASCII)
            return _json.loads(val)
        if kind == "number":
            return float(val) if "." in val else int(val)
        if val == "$":
            _, var = self.take()
            if var not in self.vars:
                raise GQLError(f"variable ${var} not provided")
            return self.vars[var]
        if kind == "name":  # true/false/null/enums
            return {"true": True, "false": False, "null": None}.get(val, val)
        raise GQLError(f"bad value {val!r}")


def _project(obj, fields):
    """Apply a selection set to a dict/list-of-dicts value."""
    if fields is None:
        return obj
    if isinstance(obj, list):
        return [_project(o, fields) for o in obj]
    if obj is None:
        return None
    out = {}
    for f in fields:
        if f["name"] not in obj:
            raise GQLError(f"unknown field {f['name']!r}")
        out[f["name"]] = _project(obj[f["name"]], f["fields"])
    return out


class GraphQLAPI:
    """Root resolvers over the Master facade (gapi_* analog)."""

    def __init__(self, master):
        self.master = master

    # -- root fields -----------------------------------------------------------

    def _cluster_view(self, args):
        sm = self.master.sm
        from chubaofs_tpu_torch.master.master import MASTER_GROUP

        return {
            "leaderID": self.master.raft.leader_of(MASTER_GROUP),
            "volumeCount": len(sm.volumes),
            "nodes": [
                {"id": n.node_id, "kind": n.kind, "addr": n.addr,
                 "raftAddr": n.raft_addr, "partitions": n.partition_count,
                 "lastHeartbeat": n.last_heartbeat}
                for n in sm.nodes.values()
            ],
        }

    def _vol_dict(self, v):
        d = asdict(v)
        return {
            "name": d["name"], "owner": d["owner"], "capacity": d["capacity"],
            "cold": d["cold"],
            "metaPartitions": [
                {"partitionID": mp["partition_id"], "start": mp["start"],
                 "end": -1 if mp["end"] >= (1 << 62) else mp["end"],
                 "peers": mp["peers"], "leader": mp["leader"]}
                for mp in d["meta_partitions"]
            ],
            "dataPartitions": [
                {"partitionID": dp["partition_id"], "peers": dp["peers"],
                 "hosts": dp["hosts"], "status": dp["status"]}
                for dp in d["data_partitions"]
            ],
        }

    def _volume_list(self, args):
        return [self._vol_dict(v) for v in self.master.sm.volumes.values()]

    @staticmethod
    def _arg(args, name):
        if name not in args:
            raise GQLError(f"missing required argument {name!r}")
        return args[name]

    def _volume(self, args):
        return self._vol_dict(self.master.get_volume(self._arg(args, "name")))

    def _user_dict(self, u):
        # no secretKey: the console proxies GraphQL to any browser, and S3
        # credentials must not be harvestable there
        return {"userID": u.user_id, "accessKey": u.access_key,
                "userType": u.user_type,
                "ownVols": list(u.own_vols),
                "authorizedVols": dict(u.authorized_vols)}

    def _user_list(self, args):
        return [self._user_dict(u) for u in self.master.sm.users.values()]

    def _user_info(self, args):
        return self._user_dict(self.master.get_user(self._arg(args, "userID")))

    def _cluster_stat(self, args):
        """Space/health rollup (the dashboard's capacity tiles; ref
        /admin/getClusterStat) — camelCased like every other root field,
        zones as a selectable list."""
        st = self.master.cluster_stat()
        return {
            "totalSpace": st["total_space"], "usedSpace": st["used_space"],
            "dataTotalSpace": st["data"]["total_space"],
            "dataUsedSpace": st["data"]["used_space"],
            "metaTotalSpace": st["meta"]["total_space"],
            "metaUsedSpace": st["meta"]["used_space"],
            "nodes": st["nodes"], "active": st["active"],
            "volumes": st["volumes"],
            "metaPartitions": st["meta_partitions"],
            "dataPartitions": st["data_partitions"],
            "zones": [
                {"name": z, "totalSpace": v["total_space"],
                 "usedSpace": v["used_space"], "nodes": v["nodes"],
                 "active": v["active"]}
                for z, v in sorted(st["zones"].items())
            ],
        }

    ROOTS = {
        "clusterView": _cluster_view,
        "volumeList": _volume_list,
        "volume": _volume,
        "userList": _user_list,
        "userInfo": _user_info,
        "clusterStat": _cluster_stat,
    }

    def execute(self, query: str, variables: dict | None = None) -> dict:
        fields = _Parser(_tokenize(query), variables).parse()
        data = {}
        for f in fields:
            resolver = self.ROOTS.get(f["name"])
            if resolver is None:
                raise GQLError(f"unknown root field {f['name']!r}")
            data[f["name"]] = _project(resolver(self, f["args"]), f["fields"])
        return data

    def handle(self, req):
        """POST /graphql handler (mount on the MasterAPI router)."""
        import json

        from chubaofs_tpu_torch.master.master import MasterError
        from chubaofs_tpu_torch.rpc.router import Response

        try:
            body = req.json() or {}
            data = self.execute(body.get("query", ""), body.get("variables"))
            return Response.json({"data": data})
        except (GQLError, MasterError, ValueError) as e:
            return Response.json({"errors": [{"message": str(e)}]}, status=400)
