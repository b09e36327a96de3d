"""Bucket CORS engine (objectnode CORS handling analog).

Reference counterpart: objectnode's CORS config (XML rules with
AllowedOrigin/AllowedMethod/AllowedHeader/ExposeHeader/MaxAgeSeconds) matched
against the Origin + Access-Control-Request-Method of a request; first
matching rule wins. Stored as JSON in the `oss:cors` xattr of the bucket root.
"""

from __future__ import annotations

import fnmatch
import json

XATTR_CORS = "oss:cors"


class CORSRule:
    def __init__(self, allowed_origins: list[str], allowed_methods: list[str],
                 allowed_headers: list[str] | None = None,
                 expose_headers: list[str] | None = None,
                 max_age_seconds: int = 0):
        self.allowed_origins = allowed_origins
        self.allowed_methods = [m.upper() for m in allowed_methods]
        self.allowed_headers = allowed_headers or []
        self.expose_headers = expose_headers or []
        self.max_age_seconds = max_age_seconds

    def matches(self, origin: str, method: str) -> bool:
        if method.upper() not in self.allowed_methods:
            return False
        return any(fnmatch.fnmatchcase(origin, pat)
                   for pat in self.allowed_origins)

    def to_dict(self) -> dict:
        return {
            "AllowedOrigin": self.allowed_origins,
            "AllowedMethod": self.allowed_methods,
            "AllowedHeader": self.allowed_headers,
            "ExposeHeader": self.expose_headers,
            "MaxAgeSeconds": self.max_age_seconds,
        }


class CORSConfig:
    def __init__(self, rules: list[CORSRule]):
        self.rules = rules

    @classmethod
    def from_json(cls, raw: bytes) -> "CORSConfig":
        rules = []
        for r in json.loads(raw.decode()).get("CORSRule", []):
            rules.append(CORSRule(r.get("AllowedOrigin", []),
                                  r.get("AllowedMethod", []),
                                  r.get("AllowedHeader", []),
                                  r.get("ExposeHeader", []),
                                  r.get("MaxAgeSeconds", 0)))
        return cls(rules)

    def to_json(self) -> bytes:
        return json.dumps({"CORSRule": [r.to_dict() for r in self.rules]}).encode()

    def match(self, origin: str, method: str) -> CORSRule | None:
        for rule in self.rules:
            if rule.matches(origin, method):
                return rule
        return None

    def headers_for(self, origin: str, method: str) -> dict[str, str]:
        rule = self.match(origin, method)
        if rule is None:
            return {}
        out = {
            "Access-Control-Allow-Origin":
                origin if "*" not in rule.allowed_origins else "*",
            "Access-Control-Allow-Methods": ", ".join(rule.allowed_methods),
        }
        if rule.allowed_headers:
            out["Access-Control-Allow-Headers"] = ", ".join(rule.allowed_headers)
        if rule.expose_headers:
            out["Access-Control-Expose-Headers"] = ", ".join(rule.expose_headers)
        if rule.max_age_seconds:
            out["Access-Control-Max-Age"] = str(rule.max_age_seconds)
        return out
