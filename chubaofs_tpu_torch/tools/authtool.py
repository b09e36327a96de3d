"""authtool — key and ticket utility for the authnode.

Reference counterpart: authtool/ (522 LoC: generates auth keys, crafts
ticket requests, decodes tickets for debugging). Subcommands:

  genkey                     print a fresh 32-byte base64 key
  createkey ID ROLE          register a key at the authnode (HTTP)
  ticket CLIENT SERVICE      fetch a ticket for CLIENT to talk to SERVICE
  decode TICKET KEY          decrypt+dump a ticket with the service key
"""

from __future__ import annotations

import argparse
import base64
import json
import secrets
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cfs-authtool")
    p.add_argument("--addr", help="authnode HTTP address host:port")
    p.add_argument("--admin-secret", default="", help="authnode admin secret")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("genkey")

    ck = sub.add_parser("createkey")
    ck.add_argument("id")
    ck.add_argument("role", choices=["client", "service"])
    ck.add_argument("--caps", default="", help="comma-separated capabilities")

    tk = sub.add_parser("ticket")
    tk.add_argument("client")
    tk.add_argument("service")
    tk.add_argument("--key", required=True, help="client key (base64)")

    dc = sub.add_parser("decode")
    dc.add_argument("ticket")
    dc.add_argument("key", help="service key (base64)")
    dc.add_argument("--service", required=True)

    args = p.parse_args(argv)

    if args.cmd == "genkey":
        print(base64.b64encode(secrets.token_bytes(32)).decode())
        return 0

    if args.cmd == "decode":
        from chubaofs_tpu_torch.authnode.server import verify_ticket

        info = verify_ticket(args.service, base64.b64decode(args.key),
                             args.ticket)
        print(json.dumps(info, indent=2, default=str))
        return 0

    if not args.addr:
        print("need --addr for authnode commands", file=sys.stderr)
        return 2
    from chubaofs_tpu_torch.rpc.client import RPCClient

    if args.cmd == "createkey":
        # /admin/* rides the shared-secret path-HMAC middleware
        rpc = RPCClient([args.addr],
                        auth_secret=args.admin_secret.encode() or None)
        caps = [c for c in args.caps.split(",") if c]
        out = rpc.post("/admin/createkey",
                       {"id": args.id, "role": args.role, "caps": caps})
        print(json.dumps(out, indent=2))
        return 0

    if args.cmd == "ticket":
        import time

        from chubaofs_tpu_torch.utils import cryptoutil

        rpc = RPCClient([args.addr])
        ts = time.time()
        key = base64.b64decode(args.key)
        msg = f"{args.client}:{args.service}:{ts}".encode()
        verifier = base64.b64encode(
            cryptoutil.hmac_sha256(key, msg)).decode()
        out = rpc.post("/client/getticket", {
            "client_id": args.client, "service_id": args.service,
            "verifier": verifier, "ts": ts})
        # the reply is sealed with the client key; open it like sdk/auth does
        plain = cryptoutil.open_sealed(
            key, base64.b64decode(out["sealed"]), aad=args.client.encode())
        print(json.dumps(json.loads(plain.decode()), indent=2))
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
