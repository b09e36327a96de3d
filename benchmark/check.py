"""How `correct` is decided: what the timed path produced, against the plain
reference (benchmark/reference), after the window has closed.

  * PUT: every acknowledged object's Location names the code mode its
    policy band gives, and every shard the blobnodes hold for each of its
    blobs, local parities included, equals the reference stripe of the
    object's bytes; every blob holds at least its mode's put quorum of its
    global shards (the gateway counts those alone toward the quorum, after
    CubeFS stream_put.go: local parities never satisfy it).
  * GET: every answer due in the window came, with the status and
    Content-Range asked for, and equals the object's bytes (compared by the
    client on arrival, tallied here).

Every number is an exact count with the limit 0; a degraded mix also has to
have decoded on the fly (a lower limit), or it did not read what it says.
A mix of range pairs decodes exactly the bytes its degraded halves ask
for, no more and no fewer: each half, window by window, and nothing served
from a decode made before.
"""

from __future__ import annotations

import json
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark import system, traffic
from benchmark.reference import codes


def _check_put(cluster, policies, seed, rec) -> dict:
    out = {"mode_wrong": 0, "shards_wrong": 0, "shards_missing": 0, "blobs_under_quorum": 0,
           "blobs": 0}
    loc = json.loads(rec["loc"])
    mode = codes.pick_mode(policies, rec["size"])
    if loc["code_mode"] != mode.code or loc["size"] != rec["size"]:
        out["mode_wrong"] = 1
        return out
    data = traffic.payload(seed, traffic.WINDOW, rec["idx"], rec["size"]).tobytes()
    off = 0
    for blob in loc["blobs"]:
        want = codes.stripe(mode, data[off:off + blob["size"]])
        off += blob["size"]
        got = system.read_stripe(cluster, blob["vid"], blob["bid"])
        missing = sum(1 for g in got if g is None)
        wrong = sum(1 for i, g in enumerate(got)
                    if g is not None and not np.array_equal(np.frombuffer(g, np.uint8), want[i]))
        out["blobs"] += 1
        out["shards_missing"] += missing
        out["shards_wrong"] += wrong
        if sum(g is not None for g in got[:mode.global_count]) < mode.put_quorum:
            out["blobs_under_quorum"] += 1
    if off != rec["size"]:
        out["mode_wrong"] = 1
    return out


def check_puts(cluster, policies: list[dict], seed: int, records: list[dict]) -> dict:
    """Counts over every PUT of the window (acknowledged or not)."""
    puts = [r for r in records if r["op"] == "put"]
    acked = [r for r in puts if r["status"] == 200]
    with ThreadPoolExecutor(8) as ex:
        parts = list(ex.map(lambda r: _check_put(cluster, policies, seed, r), acked))
    total = {k: sum(p[k] for p in parts) for k in
             ("mode_wrong", "shards_wrong", "shards_missing", "blobs_under_quorum", "blobs")}
    total["failed"] = len(puts) - len(acked)
    total["acked"] = len(acked)
    return total


def check_gets(records: list[dict]) -> dict:
    gets = [r for r in records if r["op"] == "get"]
    return {"failed": sum(1 for r in gets if r["status"] not in (200, 206)),
            "wrong": sum(1 for r in gets if r["status"] in (200, 206) and not r["ok"])}


def warm_bad(records: list[dict]) -> int:
    """Warm-up requests that failed or answered wrong (GETs are compared on
    arrival like the window's)."""
    return sum(1 for r in records if r["status"] not in (200, 206) or not r.get("ok", True))


def degraded_halves_bytes(records: list[dict]) -> int | None:
    """The bytes the window's range-pair halves over a lost shard ask for,
    or None where the window has no range pairs."""
    halves = [r for r in records if r["op"] == "get" and r.get("role") is not None]
    return sum(r["length"] for r in halves if r["role"] == "degraded") if halves else None


def verdict(puts: dict | None, gets: dict | None, decoded_mib: float | None,
            warm_bad: int, decoded_b: int | None = None,
            degraded_halves_b: int | None = None) -> dict:
    """name -> {"value", and "max", "min" or both}: every number compared,
    with its limit."""
    checks = {"warmup_bad": {"value": warm_bad, "max": 0}}
    if puts is not None:
        for k in ("failed", "mode_wrong", "shards_wrong", "blobs_under_quorum"):
            checks[f"put_{k}"] = {"value": puts[k], "max": 0}
    if gets is not None:
        for k in ("failed", "wrong"):
            checks[f"get_{k}"] = {"value": gets[k], "max": 0}
    if decoded_mib is not None:
        checks["decoded_MiB"] = {"value": decoded_mib, "min": 1}
    if degraded_halves_b is not None:
        checks["decoded_B"] = {"value": decoded_b, "min": degraded_halves_b,
                               "max": degraded_halves_b}
    return checks


def passed(checks: dict) -> bool:
    return all(c["value"] <= c.get("max", math.inf) and c["value"] >= c.get("min", -math.inf)
               for c in checks.values())
