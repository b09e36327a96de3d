"""cfs-cli — cluster/volume/node/user administration from the terminal.

Reference counterpart: cli/ (the cobra `cfs-cli` binary; command tree in
cli/cmd/*.go — cluster.go, vol.go, metanode.go, datanode.go, user.go,
config.go). Kept: the same command tree and spellings (`cfs-cli cluster
info`, `vol create NAME OWNER`, `user info NAME`…), a config file holding
the master addresses (cli/cmd/config.go stores ~/.cfs-cli.json the same
way), table output for humans with a `--json` escape hatch for scripts, and
a `completion` command emitting bash completion (cobra generates these).
Changed: argparse instead of cobra; the reference's ~60 subcommands collapse
to the admin surface the rebuilt master exposes.

Usage: python -m chubaofs_tpu_torch.cli [--addr host:port]... <noun> <verb> [args]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from chubaofs_tpu_torch.master.api_service import MasterClient
from chubaofs_tpu_torch.master.master import MasterError

CONFIG_PATH = os.path.expanduser("~/.cfs-cli.json")


def load_config() -> dict:
    try:
        with open(CONFIG_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def save_config(cfg: dict) -> None:
    with open(CONFIG_PATH, "w") as f:
        json.dump(cfg, f, indent=2)


def table(rows: list[dict], columns: list[str], out) -> None:
    """Fixed-width table (the reference CLI's aligned output style)."""
    if not rows:
        print("(none)", file=out)
        return
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in columns}
    print("  ".join(c.upper().ljust(widths[c]) for c in columns), file=out)
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in columns),
              file=out)


class CLI:
    def __init__(self, addrs: list[str], out=None, as_json: bool = False,
                 ticket: str | None = None):
        self.addrs = list(addrs)
        self.mc = MasterClient(addrs, admin_ticket=ticket)
        self.out = out or sys.stdout
        self.as_json = as_json

    def _emit(self, data, rows=None, columns=None):
        if self.as_json or rows is None:
            print(json.dumps(data, indent=2, default=str), file=self.out)
        else:
            table(rows, columns, self.out)

    # -- cluster ---------------------------------------------------------------

    def cluster_info(self, args):
        c = self.mc.get_cluster()
        if self.as_json:
            return self._emit(c)
        print(f"Leader     : node {c['leader_id']}", file=self.out)
        print(f"Volumes    : {len(c['volumes'])}", file=self.out)
        print(f"Users      : {len(c['users'])}", file=self.out)
        rows = [{"id": n["node_id"], "kind": n["kind"], "addr": n["addr"],
                 "zone": n.get("zone", ""), "status": n.get("status", ""),
                 "partitions": n["partition_count"]} for n in c["nodes"]]
        table(rows, ["id", "kind", "addr", "zone", "status", "partitions"],
              self.out)

    def cluster_stat(self, args):
        st = self.mc.cluster_stat()
        if self.as_json:
            return self._emit(st)
        gib = 1 << 30
        d, m = st["data"], st["meta"]
        print(f"Data space : {d['used_space'] / gib:.1f} / "
              f"{d['total_space'] / gib:.1f} GiB used", file=self.out)
        print(f"Meta space : {m['used_space'] / gib:.1f} / "
              f"{m['total_space'] / gib:.1f} GiB used", file=self.out)
        print(f"Nodes      : {st['active']}/{st['nodes']} active", file=self.out)
        print(f"Volumes    : {st['volumes']} "
              f"(mp={st['meta_partitions']} dp={st['data_partitions']})",
              file=self.out)
        for zone, z in sorted(st["zones"].items()):
            print(f"  zone {zone or '-'}: {z['active']}/{z['nodes']} active, "
                  f"{z['used_space'] / gib:.1f}/{z['total_space'] / gib:.1f} GiB",
                  file=self.out)

    def cluster_domains(self, args):
        """zone -> fault domain assignments (domain mode when non-empty)."""
        doms = self.mc.get_zone_domains()
        if self.as_json:
            return self._emit(doms)
        if not doms:
            print("domain mode off (no assignments)", file=self.out)
            return
        table([{"zone": z, "domain": d} for z, d in sorted(doms.items())],
              ["zone", "domain"], self.out)

    def cluster_setdomain(self, args):
        res = self.mc.set_zone_domain(args.zone, args.domain)
        if self.as_json:
            return self._emit(res)
        if res.get("warning"):
            print(f"warning: {res['warning']}", file=self.out)
        print(f"{len(res['domains'])} assignment(s)", file=self.out)

    def cluster_topology(self, args):
        """Zones -> nodesets -> nodes, rendered from the master's own
        topology view (`cfs-cli zone list` analog)."""
        topo = self.mc.get_topology()
        if self.as_json:
            return self._emit(topo)
        by_id = {n["node_id"]: n for n in self.mc.get_cluster()["nodes"]}
        rows = []
        for zone in sorted(topo):
            for ns in sorted(topo[zone], key=int):
                for nid in topo[zone][ns]:
                    n = by_id.get(nid, {})
                    rows.append({"zone": zone or "(none)", "nodeset": ns,
                                 "id": nid, "kind": n.get("kind", "?"),
                                 "status": n.get("status", "")})
        table(rows, ["zone", "nodeset", "id", "kind", "status"], self.out)

    # -- volumes ---------------------------------------------------------------

    def vol_create(self, args):
        v = self.mc.create_volume(args.name, owner=args.owner,
                                  cold=args.cold, capacity=args.capacity,
                                  dp_count=args.dp_count)
        self._emit(v)

    def vol_update(self, args):
        fr = None if args.follower_read is None else args.follower_read == "true"
        v = self.mc.update_volume(
            args.name, capacity=args.capacity, follower_read=fr,
            qos_read_mbps=args.qos_read_mbps,
            qos_write_mbps=args.qos_write_mbps)
        self._emit(v)

    def vol_list(self, args):
        vols = self.mc.list_volumes()
        self._emit(vols, rows=vols,
                   columns=["name", "owner", "cold", "mp_count", "dp_count"])

    def vol_info(self, args):
        self._emit(self.mc.get_volume(args.name))

    def vol_delete(self, args):
        if not args.yes:
            print(f"refusing to delete {args.name!r} without --yes",
                  file=self.out)
            raise SystemExit(2)
        self.mc.delete_volume(args.name)
        print(f"volume {args.name} deleted", file=self.out)

    # -- nodes -----------------------------------------------------------------

    def _nodes(self, kind: str):
        nodes = [n for n in self.mc.get_cluster()["nodes"] if n["kind"] == kind]
        rows = [{"id": n["node_id"], "addr": n["addr"],
                 "raft": n["raft_addr"], "partitions": n["partition_count"],
                 "last_heartbeat": round(n["last_heartbeat"], 1)}
                for n in nodes]
        self._emit(nodes, rows=rows,
                   columns=["id", "addr", "raft", "partitions", "last_heartbeat"])

    def metanode_list(self, args):
        self._nodes("meta")

    def datanode_list(self, args):
        self._nodes("data")

    def metanode_decommission(self, args):
        self._emit(self.mc.decommission_node(args.id, "meta"))

    def metanode_rebalance(self, args):
        """One hot-meta-partition migration sweep (heartbeat-load driven)."""
        res = self.mc.rebalance_meta(factor=args.factor,
                                     max_moves=args.max_moves)
        if self.as_json:
            return self._emit(res)
        print(f"moved {res['moved']} replica(s)", file=self.out)
        rows = [{"id": nid, "window_ops": int(load)}
                for nid, load in sorted(res["loads"].items(),
                                        key=lambda kv: int(kv[0]))]
        table(rows, ["id", "window_ops"], self.out)

    def datanode_decommission(self, args):
        self._emit(self.mc.decommission_node(args.id, "data"))

    def datanode_rebalance(self, args):
        """One hot-volume spreading sweep (heartbeat-load driven)."""
        res = self.mc.rebalance_hot(factor=args.factor,
                                    max_moves=args.max_moves)
        if self.as_json:
            return self._emit(res)
        print(f"moved {res['moved']} replica(s)", file=self.out)
        rows = [{"id": nid, "window_ops": int(load)}
                for nid, load in sorted(res["loads"].items(),
                                        key=lambda kv: int(kv[0]))]
        table(rows, ["id", "window_ops"], self.out)

    # -- partitions ------------------------------------------------------------

    def mp_list(self, args):
        mps = self.mc.meta_partitions(args.volume)
        self._emit(mps, rows=mps,
                   columns=["partition_id", "start", "end", "peers", "leader"])

    def dp_list(self, args):
        dps = self.mc.data_partitions(args.volume)
        rows = [{"pid": d["pid"], "peers": d["peers"], "hosts": d["hosts"]}
                for d in dps]
        self._emit(dps, rows=rows, columns=["pid", "peers", "hosts"])

    def dp_create(self, args):
        self._emit(self.mc.create_data_partition(args.volume))

    # -- users -----------------------------------------------------------------

    def user_create(self, args):
        self._emit(self.mc.create_user(args.name, args.type))

    def user_delete(self, args):
        self.mc.delete_user(args.name)
        print(f"user {args.name} deleted", file=self.out)

    def user_info(self, args):
        self._emit(self.mc.user_info(args.name))

    def user_list(self, args):
        users = self.mc.list_users()
        rows = [{"user_id": u["user_id"], "type": u["user_type"],
                 "access_key": u["access_key"], "own_vols": u["own_vols"]}
                for u in users]
        self._emit(users, rows=rows,
                   columns=["user_id", "type", "access_key", "own_vols"])

    def user_perm(self, args):
        actions = [] if args.none else [f"perm:{args.perm}"]
        u = self.mc.update_user_policy(args.name, args.volume, actions,
                                       grant=not args.none)
        self._emit(u)

    # -- autopilot ---------------------------------------------------------------

    def _autopilot_call(self, op: str | None = None,
                        off: bool = False) -> dict:
        """The /autopilot side-door (plain JSON, not the admin envelope):
        first reachable configured master wins."""
        from chubaofs_tpu_torch.tools.cfsstat import scrape

        path = "/autopilot"
        if op:
            path += f"?op={op}" + ("&off=1" if off else "")
        last_err: Exception | None = None
        for addr in self.addrs:
            try:
                return json.loads(scrape(addr, path, timeout=5))
            except Exception as e:
                last_err = e
        raise MasterError(f"no /autopilot endpoint reachable: {last_err}")

    def _autopilot_render(self, st: dict) -> None:
        if self.as_json:
            return self._emit(st)
        mode = "dry-run" if st.get("dry_run") else \
            ("enabled" if st.get("enabled") else "disabled")
        b = st.get("budget") or {}
        print(f"Autopilot : {mode}", file=self.out)
        print(f"Budget    : {b.get('remaining', 0)}/{b.get('per_hour', 0)} "
              "action(s) remaining this hour", file=self.out)
        cooldowns = st.get("cooldowns") or {}
        rows = [{"binding": x["name"], "rule": x["rule"],
                 "actuator": x["actuator"],
                 "armed": "yes" if x.get("armed") else "no",
                 "cooldown_s": cooldowns.get(x["actuator"], "")}
                for x in st.get("bindings", [])]
        table(rows, ["binding", "rule", "actuator", "armed", "cooldown_s"],
              self.out)
        decisions = st.get("decisions") or []
        if decisions:
            print("Recent decisions:", file=self.out)
            rows = [{"decision": d.get("decision"),
                     "binding": d.get("binding"),
                     "fingerprint": d.get("fingerprint")}
                    for d in decisions[-10:]]
            table(rows, ["decision", "binding", "fingerprint"], self.out)

    def autopilot_status(self, args):
        self._autopilot_render(self._autopilot_call())

    def autopilot_enable(self, args):
        self._autopilot_render(self._autopilot_call("enable"))

    def autopilot_disable(self, args):
        self._autopilot_render(self._autopilot_call("disable"))

    def autopilot_dry_run(self, args):
        self._autopilot_render(self._autopilot_call("dry-run", off=args.off))


COMPLETION = """# bash completion for cfs-cli
_cfs_cli() {
  local cur prev nouns verbs
  cur="${COMP_WORDS[COMP_CWORD]}"
  prev="${COMP_WORDS[COMP_CWORD-1]}"
  nouns="cluster vol metanode datanode metapartition datapartition user autopilot config completion"
  case "$prev" in
    cluster) verbs="info topology" ;;
    autopilot) verbs="status enable disable dry-run" ;;
    vol) verbs="create list info delete" ;;
    metanode|datanode) verbs="list decommission rebalance" ;;
    metapartition) verbs="list" ;;
    datapartition) verbs="list create" ;;
    user) verbs="create delete info list perm" ;;
    config) verbs="set show" ;;
    *) verbs="$nouns" ;;
  esac
  COMPREPLY=( $(compgen -W "$verbs" -- "$cur") )
}
complete -F _cfs_cli cfs-cli
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cfs-cli", description="chubaofs-tpu cluster admin CLI")
    p.add_argument("--addr", action="append", default=None,
                   help="master address host:port (repeatable); defaults to "
                        "the configured masters")
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument("--ticket", default=None,
                   help="authnode master:admin capability ticket (b64); "
                        "defaults to the configured adminTicket")
    sub = p.add_subparsers(dest="noun", required=True)

    cluster = sub.add_parser("cluster").add_subparsers(dest="verb", required=True)
    cluster.add_parser("info").set_defaults(fn="cluster_info")
    cluster.add_parser("topology").set_defaults(fn="cluster_topology")
    cluster.add_parser("stat").set_defaults(fn="cluster_stat")
    cluster.add_parser("domains").set_defaults(fn="cluster_domains")
    sd = cluster.add_parser("setdomain")
    sd.add_argument("zone")
    sd.add_argument("domain", help="empty string clears the assignment")
    sd.set_defaults(fn="cluster_setdomain")

    vol = sub.add_parser("vol", aliases=["volume"]).add_subparsers(
        dest="verb", required=True)
    c = vol.add_parser("create")
    c.add_argument("name")
    c.add_argument("owner", nargs="?", default="")
    c.add_argument("--cold", action="store_true",
                   help="erasure-coded blobstore tier")
    c.add_argument("--capacity", type=int, default=1 << 40)
    c.add_argument("--dp-count", type=int, default=3)
    c.set_defaults(fn="vol_create")
    u = vol.add_parser("update")
    u.add_argument("name")
    u.add_argument("--capacity", type=int, default=None)
    u.add_argument("--follower-read", choices=["true", "false"], default=None)
    u.add_argument("--qos-read-mbps", type=int, default=None)
    u.add_argument("--qos-write-mbps", type=int, default=None)
    u.set_defaults(fn="vol_update")
    vol.add_parser("list").set_defaults(fn="vol_list")
    i = vol.add_parser("info")
    i.add_argument("name")
    i.set_defaults(fn="vol_info")
    d = vol.add_parser("delete")
    d.add_argument("name")
    d.add_argument("--yes", action="store_true")
    d.set_defaults(fn="vol_delete")

    mn = sub.add_parser("metanode").add_subparsers(dest="verb", required=True)
    mn.add_parser("list").set_defaults(fn="metanode_list")
    md = mn.add_parser("decommission")
    md.add_argument("id", type=int)
    md.set_defaults(fn="metanode_decommission")
    mrb = mn.add_parser("rebalance")
    mrb.add_argument("--factor", type=float, default=1.5)
    mrb.add_argument("--max-moves", type=int, default=1)
    mrb.set_defaults(fn="metanode_rebalance")
    dn = sub.add_parser("datanode").add_subparsers(dest="verb", required=True)
    dn.add_parser("list").set_defaults(fn="datanode_list")
    rb = dn.add_parser("rebalance")
    rb.add_argument("--factor", type=float, default=1.5)
    rb.add_argument("--max-moves", type=int, default=2)
    rb.set_defaults(fn="datanode_rebalance")
    dd = dn.add_parser("decommission")
    dd.add_argument("id", type=int)
    dd.set_defaults(fn="datanode_decommission")

    mp = sub.add_parser("metapartition").add_subparsers(dest="verb", required=True)
    m = mp.add_parser("list")
    m.add_argument("volume")
    m.set_defaults(fn="mp_list")
    dp = sub.add_parser("datapartition").add_subparsers(dest="verb", required=True)
    dl = dp.add_parser("list")
    dl.add_argument("volume")
    dl.set_defaults(fn="dp_list")
    dc = dp.add_parser("create")
    dc.add_argument("volume")
    dc.set_defaults(fn="dp_create")

    user = sub.add_parser("user").add_subparsers(dest="verb", required=True)
    uc = user.add_parser("create")
    uc.add_argument("name")
    uc.add_argument("--type", default="normal", choices=["root", "admin", "normal"])
    uc.set_defaults(fn="user_create")
    ud = user.add_parser("delete")
    ud.add_argument("name")
    ud.set_defaults(fn="user_delete")
    ui = user.add_parser("info")
    ui.add_argument("name")
    ui.set_defaults(fn="user_info")
    user.add_parser("list").set_defaults(fn="user_list")
    up = user.add_parser("perm")
    up.add_argument("name")
    up.add_argument("volume")
    up.add_argument("perm", nargs="?", default="readonly",
                    choices=["readonly", "writable"])
    up.add_argument("--none", action="store_true", help="revoke")
    up.set_defaults(fn="user_perm")

    ap = sub.add_parser("autopilot").add_subparsers(dest="verb", required=True)
    ap.add_parser("status").set_defaults(fn="autopilot_status")
    ap.add_parser("enable").set_defaults(fn="autopilot_enable")
    ap.add_parser("disable").set_defaults(fn="autopilot_disable")
    adr = ap.add_parser("dry-run")
    adr.add_argument("--off", action="store_true",
                     help="leave shadow mode (actions run again)")
    adr.set_defaults(fn="autopilot_dry_run")

    cfg = sub.add_parser("config").add_subparsers(dest="verb", required=True)
    cs = cfg.add_parser("set")
    cs.add_argument("--addr", action="append", required=True)
    cs.set_defaults(fn="config_set")
    cfg.add_parser("show").set_defaults(fn="config_show")

    sub.add_parser("completion").set_defaults(fn="completion")
    return p


def main(argv: list[str] | None = None, out=None) -> int:
    out = out or sys.stdout
    args = build_parser().parse_args(argv)

    if args.fn == "completion":
        print(COMPLETION, file=out)
        return 0
    if args.fn == "config_set":
        save_config({"masterAddrs": args.addr})
        print(f"masters set: {args.addr}", file=out)
        return 0
    if args.fn == "config_show":
        print(json.dumps(load_config(), indent=2), file=out)
        return 0

    cfg = load_config()
    addrs = args.addr or cfg.get("masterAddrs")
    ticket = args.ticket or cfg.get("adminTicket")
    if not addrs:
        print("no master address: pass --addr or run "
              "`cfs-cli config set --addr host:port`", file=sys.stderr)
        return 2
    from chubaofs_tpu_torch.rpc.errors import HTTPError

    cli = CLI(addrs, out=out, as_json=args.json, ticket=ticket)
    try:
        getattr(cli, args.fn)(args)
    except (MasterError, HTTPError, OSError) as e:
        # unreachable master / transport errors read as clean errors, not
        # tracebacks
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
