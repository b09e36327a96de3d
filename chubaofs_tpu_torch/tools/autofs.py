"""autofs — automount map helper.

Reference counterpart: autofs/ (403 LoC: the `cfs-autofs` mount helper that
automount invokes with a key + options string to mount a CubeFS volume on
demand). Kept: the same option grammar (`-fstype=chubaofs,master=...,vol=...`)
and the map-entry parsing; instead of exec'ing a kernel-FUSE mount (out of
scope here), it emits the client config JSON the mount daemon consumes — the
piece automount integration actually needs from us.
"""

from __future__ import annotations

import json


def parse_options(opts: str) -> dict:
    """'-fstype=chubaofs,master=h1:p;h2:p,vol=media,ro' -> config dict."""
    cfg: dict = {}
    for field in opts.lstrip("-").split(","):
        if not field:
            continue
        if "=" in field:
            k, v = field.split("=", 1)
        else:
            k, v = field, "true"
        if k == "master":
            cfg["masterAddr"] = v.split(";")
        elif k == "vol":
            cfg["volName"] = v
        elif k == "access":
            cfg["accessAddr"] = v.split(";")
        elif k == "fstype":
            cfg["fstype"] = v
        else:
            cfg.setdefault("options", {})[k] = v
    return cfg


def map_entry_to_config(key: str, opts: str) -> dict:
    cfg = parse_options(opts)
    if cfg.get("fstype") not in ("chubaofs", "cfs", None):
        raise ValueError(f"unsupported fstype {cfg.get('fstype')!r}")
    cfg.pop("fstype", None)
    cfg.setdefault("volName", key)
    if "masterAddr" not in cfg:
        raise ValueError("map options need master=host:port[;host:port]")
    cfg["mountPoint"] = f"/{key}"
    return cfg


def main(argv=None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="cfs-autofs",
                                description="automount map helper")
    p.add_argument("key", help="automount key (volume)")
    p.add_argument("options", help="map options, e.g. "
                   "-fstype=chubaofs,master=h:p,vol=v")
    args = p.parse_args(argv)
    try:
        print(json.dumps(map_entry_to_config(args.key, args.options), indent=2))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
