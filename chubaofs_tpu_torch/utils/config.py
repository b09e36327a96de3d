"""JSON daemon config (util/config analog).

Reference counterpart: util/config — every daemon takes one JSON file via
`-c path` (cmd/cmd.go:85,138) and reads typed keys with defaults; blobstore
modules bind sub-structs (blobstore/cmd/cmd.go:46-62). Kept: typed getters
with defaults and a required-key check; added: dotted-path access for nested
module sections so one file can configure an in-process cluster.
"""

from __future__ import annotations

import json


class ConfigError(Exception):
    pass


class Config:
    def __init__(self, data: dict):
        self.data = dict(data)

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    @classmethod
    def from_string(cls, s: str) -> "Config":
        return cls(json.loads(s))

    def _lookup(self, key: str):
        node = self.data
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return None, False
            node = node[part]
        return node, True

    def get_string(self, key: str, default: str = "") -> str:
        v, ok = self._lookup(key)
        return str(v) if ok else default

    def get_int(self, key: str, default: int = 0) -> int:
        v, ok = self._lookup(key)
        return int(v) if ok else default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v, ok = self._lookup(key)
        return float(v) if ok else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v, ok = self._lookup(key)
        if not ok:
            return default
        if isinstance(v, bool):
            return v
        return str(v).lower() in ("1", "true", "yes")

    def get_slice(self, key: str, default=None) -> list:
        v, ok = self._lookup(key)
        return list(v) if ok else (default or [])

    def sub(self, key: str) -> "Config":
        v, ok = self._lookup(key)
        return Config(v if ok and isinstance(v, dict) else {})

    def check_required(self, *keys: str):
        missing = [k for k in keys if not self._lookup(k)[1]]
        if missing:
            raise ConfigError(f"missing required config keys: {missing}")


# -- env knob parsing (the CFS_* idiom shared by tools/daemons) ----------------
#
# The unclamped canonical pair: a malformed value degrades to the default
# (these parses often run during daemon boot, where a typo'd env var must
# not kill the process). Callers needing a floor (evloop's >=1 shard count,
# slo's window sizes) keep their own clamped wrappers.


def env_int(name: str, default: int) -> int:
    import os

    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    import os

    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default
