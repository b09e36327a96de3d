"""blobstore-cli — admin CLI for the blobstore daemon (blobstore/cli analog).

Reference counterpart: blobstore/cli (the interactive admin shell over
clustermgr/scheduler/access APIs). Kept: the noun-verb command tree (stat,
disk ls, vol ls/info, task ls, switch ls/set, reload) plus an interactive
REPL when no command is given. Changed: one flat HTTP admin surface on the
access gateway instead of per-service endpoints — the rebuilt blobstore
composes its services into one daemon.

Usage:
    python -m chubaofs_tpu_torch.cli.blobstore --addr host:port [cmd...]
    (no cmd -> interactive shell)
"""

from __future__ import annotations

import argparse
import json
import sys

from chubaofs_tpu_torch.rpc.client import RPCClient


class BlobCli:
    def __init__(self, addr: str):
        self.rpc = RPCClient([addr], retries=2)

    # -- plumbing -------------------------------------------------------------

    def _req(self, method: str, path: str):
        status, _, body = self.rpc.do(method, path, b"")
        if status != 200:
            raise RuntimeError(body.decode() or f"HTTP {status}")
        return json.loads(body)

    def _get(self, path: str):
        return self._req("GET", path)

    def _post(self, path: str):
        return self._req("POST", path)

    @staticmethod
    def _table(rows: list[dict], cols: list[str]) -> str:
        if not rows:
            return "(none)"
        widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
                  for c in cols}
        head = "  ".join(c.upper().ljust(widths[c]) for c in cols)
        lines = [head] + [
            "  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols)
            for r in rows
        ]
        return "\n".join(lines)

    # -- commands -------------------------------------------------------------

    def cmd_stat(self, *a) -> str:
        return json.dumps(self._get("/admin/stat"), indent=2)

    def cmd_disk(self, verb: str = "ls", *a) -> str:
        disks = self._get("/admin/disks")
        return self._table(disks, ["disk_id", "node_id", "az", "status",
                                   "chunk_count"])

    def cmd_vol(self, verb: str = "ls", vid: str = "", *a) -> str:
        if verb == "info":
            return json.dumps(self._get(f"/admin/volume?vid={int(vid)}"),
                              indent=2)
        return self._table(self._get("/admin/volumes"),
                           ["vid", "code_mode", "status", "units"])

    def cmd_task(self, verb: str = "ls", *a) -> str:
        return self._table(self._get("/admin/tasks"),
                           ["task_id", "kind", "state", "vid", "bid",
                            "disk_id", "retries"])

    def cmd_switch(self, verb: str = "ls", name: str = "", value: str = "", *a) -> str:
        if verb == "set":
            on = value in ("1", "on", "true")
            out = self._post(f"/admin/switch?name={name}&enabled={'1' if on else '0'}")
            return json.dumps(out)
        sw = self._get("/admin/switches")
        return self._table([{"switch": k, "enabled": v} for k, v in sw.items()],
                           ["switch", "enabled"])

    def cmd_forgive(self, *a) -> str:
        """Lift access punish windows after a confirmed host/AZ recovery."""
        self._post("/admin/forgive")
        return "punish windows cleared"

    def cmd_module(self, *a) -> str:
        return self._table(self._get("/admin/modules"), ["name", "running"])

    def cmd_reload(self, *a) -> str:
        return json.dumps(self._post("/admin/reload"))

    def cmd_help(self, *a) -> str:
        return ("commands: stat | disk ls | vol ls | vol info VID | task ls | "
                "switch ls | switch set NAME on|off | forgive | module ls | "
                "reload | help | exit")

    def dispatch(self, argv: list[str]) -> str:
        if not argv:
            return self.cmd_help()
        fn = getattr(self, "cmd_" + argv[0], None)
        if fn is None:
            return f"unknown command {argv[0]!r}\n{self.cmd_help()}"
        return fn(*argv[1:])

    def repl(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        print("blobstore-cli (help for commands, exit to quit)", file=stdout)
        while True:
            print("bs> ", end="", file=stdout, flush=True)
            line = stdin.readline()
            if not line or line.strip() in ("exit", "quit"):
                return
            argv = line.split()
            if not argv:
                continue
            try:
                print(self.dispatch(argv), file=stdout)
            except Exception as e:
                print(f"error: {e}", file=stdout)


def main(argv: list[str] | None = None, stdout=None) -> int:
    p = argparse.ArgumentParser(prog="blobstore-cli")
    p.add_argument("--addr", required=True, help="blobstore daemon host:port")
    p.add_argument("cmd", nargs="*", help="command; omit for interactive shell")
    args = p.parse_args(argv)
    cli = BlobCli(args.addr)
    out = stdout or sys.stdout
    if not args.cmd:
        cli.repl(stdout=out)
        return 0
    try:
        print(cli.dispatch(args.cmd), file=out)
        return 0
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
