"""cfs-capacity — SLO-gated open-loop capacity harness.

Simulate the million-user day and let the health plane judge it: a seeded,
deterministic workload generator drives a real cluster with a multi-tenant
mix (blob PUT/GET/DELETE through the SDK access path plus FUSE-style
metadata ops and hot-volume file IO), zipfian key popularity, and a
configurable diurnal ramp — OPEN loop, so the ARRIVAL rate sets the pace and
a slow cluster accumulates backlog instead of quietly throttling the bench.
Meanwhile a collector thread polls the console's `/api/health` +
`/api/metrics` and archives timestamped cfs-top frames to a JSONL capacity
report. The run FAILS (nonzero exit, flipped SLOs named) if any burn-window
SLO flips to failing on any target — the same gate discipline
`cfs-chaos-soak --sanitize` gave the lock sanitizer, applied to capacity.

Dataflow:  generator → cluster → health rollup → gate → archived report

Knobs (env defaults, CLI flags override):

    CFS_CAP_TENANTS   tenant count (default 4; archetypes cycle)
    CFS_CAP_ZIPF_S    zipf skew exponent s (default 1.2)
    CFS_CAP_RAMP      arrival ramp shape: diurnal | flat | spike
    CFS_CAP_SEED      generator seed (default 0)

Determinism contract (the chaos-scheduler reproducibility contract applied
to load): `plan_ops` is a pure function of its arguments — same seed ⇒ the
IDENTICAL op sequence (tenant, kind, key, size, arrival time) and identical
per-tenant op counts, run over run. Execution-side completion order rides
thread scheduling and is not part of the contract.

The closing actuator: `--rebalance` arms the master's hot-volume spreading
sweep (`rebalance_hot`, cmd.py's rebalanceHotSecs knob), and
`--ab-rebalance` runs the same seeded scenario twice — rebalance off, then
on — reporting the per-node ops spread of each so the A/B shows the skew
the generator created and the spread reduction the actuator bought.

The closed loop: `--autopilot` arms a console-fed Autopilot on
the collector's alert polls — firing alerts map through the declarative
bindings to MasterClient actuators (rebalance/split), gated by budget,
cooldown, and flap damping, every decision a typed `autopilot_*` event.
`--ab-autopilot` runs the control arm (off) then the closed loop (on);
`--scenario hotspot|tenant-storm|node-kill` injects the canned stress both
arms must face.

    cfs-capacity --seed 7 --duration 20 --out cap.jsonl
    cfs-capacity --seed 7 --failpoints 'blobnode.put_shard=delay(0.08)' \
        --daemon-env CFS_SLO_PUT_P99_MS=20      # must exit nonzero
    cfs-capacity --seed 7 --ab-rebalance --datanodes 5
    cfs-capacity --seed 7 --scenario hotspot --ab-autopilot --datanodes 5
    cfs-capacity --seed 7 --duration 8 --device cpu   # codec on the host

Device: the blobstore daemon (the one role with a codec) runs on the CUDA
device unless `--device` (or `run_capacity(device=)`) names another. With no
GPU and no `--device` the command fails before any cluster boots; it never
moves the codec to the host on its own. `LocalDriver` holds an in-process
cluster to the same rule.
"""

from __future__ import annotations

import bisect
import itertools
import json
import math
import os
import random
import sys
import threading
import time
import zlib
from dataclasses import dataclass

from chubaofs_tpu_torch.utils import exporter
from chubaofs_tpu_torch.utils.config import env_float, env_int
from chubaofs_tpu_torch.utils.locks import SanitizedLock
from chubaofs_tpu_torch.utils.slo import FAILING, OK, RANK

# -- the plan (pure, seeded) ---------------------------------------------------

# tenant archetypes: op blends along the system-characteristics axes of
# arxiv 1709.05365 (write-heavy ingest, read-heavy serving, metadata-bound,
# delete-heavy churn). Tenants cycle through these by index.
PROFILES: list[tuple[str, dict[str, float]]] = [
    ("ingest", {"blob_put": 0.45, "blob_get": 0.20, "blob_delete": 0.05,
                "meta_create": 0.15, "meta_stat": 0.10, "meta_list": 0.05}),
    ("serve", {"blob_get": 0.60, "blob_put": 0.10, "meta_stat": 0.20,
               "meta_list": 0.10}),
    ("metabound", {"meta_create": 0.30, "meta_stat": 0.35, "meta_list": 0.15,
                   "meta_delete": 0.10, "blob_put": 0.05, "blob_get": 0.05}),
    ("churn", {"blob_put": 0.25, "blob_get": 0.25, "blob_delete": 0.25,
               "meta_create": 0.10, "meta_delete": 0.15}),
]

# blends gain these when the cluster has a hot (replica-tier) volume: the
# datanode plane must see the same zipfian skew the rebalancer acts on
HOT_BLEND = {"hot_write": 0.15, "hot_read": 0.35}

OP_KINDS = ("blob_put", "blob_get", "blob_delete", "meta_create", "meta_stat",
            "meta_list", "meta_delete", "hot_write", "hot_read")
STATUSES = ("ok", "error", "miss")


@dataclass(frozen=True)
class Op:
    at: float      # arrival offset from run start (s) — the open-loop clock
    tenant: str
    kind: str
    key: int       # zipf-ranked object key within the tenant's keyspace
    size: int      # payload bytes for writes


def zipf_cdf(n: int, s: float) -> list[float]:
    """Cumulative zipf weights over ranks 1..n (bisect target)."""
    weights = [1.0 / (r ** s) for r in range(1, n + 1)]
    total = sum(weights)
    cdf, acc = [], 0.0
    for w in weights:
        acc += w
        cdf.append(acc / total)
    return cdf


def ramp_factor(frac: float, shape: str) -> float:
    """Arrival-rate multiplier at run fraction `frac` in [0, 1]."""
    if shape == "flat":
        return 1.0
    if shape == "spike":
        return 3.0 if 0.45 <= frac < 0.55 else 0.7
    # diurnal: night floor ramping to a midday peak and back (half-sine)
    return 0.25 + 0.75 * math.sin(math.pi * min(max(frac, 0.0), 1.0))


def plan_ops(seed: int, n_tenants: int, duration_s: float, base_rate: float,
             zipf_s: float, keys_per_tenant: int = 64, ramp: str = "diurnal",
             mean_kb: int = 16, hot: bool = False,
             storm: str | None = None) -> dict:
    """The full open-loop schedule, a pure function of its arguments: a
    seeded arrival process (rate = base_rate x ramp) where each op draws a
    tenant, a blend-weighted kind, a zipf-popular key, and a size. Returns
    {"tenants", "ops", "per_tenant"} — per_tenant is the count audit the
    determinism test compares run-over-run. `storm` names one tenant that
    soaks up 60% of the arrivals (the tenant-storm scenario): the mix stays
    seeded-deterministic, only the tenant draw is biased."""
    rng = random.Random(seed)
    tenants = [f"t{i}" for i in range(n_tenants)]
    blends: dict[str, list[tuple[str, float]]] = {}
    for i, t in enumerate(tenants):
        blend = dict(PROFILES[i % len(PROFILES)][1])
        if hot:
            blend.update(HOT_BLEND)
        total = sum(blend.values())
        acc, items = 0.0, []
        for kind, w in sorted(blend.items()):
            acc += w / total
            items.append((kind, acc))
        blends[t] = items
    cdf = zipf_cdf(keys_per_tenant, zipf_s)
    ops: list[Op] = []
    per_tenant: dict[str, dict[str, int]] = {t: {} for t in tenants}
    t_now = 0.0
    while True:
        rate = base_rate * max(0.05, ramp_factor(t_now / duration_s, ramp))
        t_now += rng.expovariate(rate)
        if t_now >= duration_s:
            break
        if storm is not None and storm in tenants and rng.random() < 0.6:
            tenant = storm
        else:
            tenant = tenants[rng.randrange(n_tenants)]
        roll = rng.random()
        kind = next(k for k, edge in blends[tenant] if roll <= edge)
        key = bisect.bisect_left(cdf, rng.random())
        size = max(1024, min(256 << 10, int(rng.expovariate(1.0 / (mean_kb * 1024)))))
        ops.append(Op(round(t_now, 6), tenant, kind, key, size))
        pt = per_tenant[tenant]
        pt[kind] = pt.get(kind, 0) + 1
    return {"tenants": tenants, "ops": ops, "per_tenant": per_tenant,
            "seed": seed}


# -- drivers -------------------------------------------------------------------


class CapacityDriver:
    """The cluster face the executor calls. Blob verbs ride the SDK access
    client (PUT returns an opaque location token), metadata and hot-tier
    verbs ride FsClients. `fs()`/`hot_fs()` may be called from worker
    threads concurrently — implementations hand out thread-local clients
    when the transport needs it. `tenant` rides every blob verb so a
    multi-tenant surface (the S3 gateway) can present per-tenant
    credentials; the SDK drivers ignore it."""

    def blob_put(self, data: bytes, tenant: str | None = None) -> str:
        raise NotImplementedError

    def blob_get(self, token: str, tenant: str | None = None) -> bytes:
        raise NotImplementedError

    def blob_delete(self, token: str, tenant: str | None = None) -> None:
        raise NotImplementedError

    def fs(self):
        raise NotImplementedError

    def hot_fs(self):
        return None


class RemoteDriver(CapacityDriver):
    """Over a daemon cluster: AccessClient for blobs, RemoteCluster
    FsClients (thread-local — the metanode packet transport is per-client)
    for metadata / hot IO."""

    def __init__(self, master_addrs: list[str], access_addrs: list[str],
                 cold_volume: str, hot_volume: str | None = None):
        from chubaofs_tpu_torch.blobstore.gateway import AccessClient

        self.master_addrs = list(master_addrs)
        self.access_addrs = list(access_addrs)
        self.cold_volume = cold_volume
        self.hot_volume = hot_volume
        self.ac = AccessClient(self.access_addrs)
        self._tls = threading.local()

    def _clients(self):
        if not hasattr(self._tls, "fs"):
            from chubaofs_tpu_torch.sdk.cluster import RemoteCluster

            rc = RemoteCluster(self.master_addrs,
                               access_addrs=self.access_addrs)
            self._tls.fs = rc.client(self.cold_volume)
            self._tls.hot = (rc.client(self.hot_volume)
                             if self.hot_volume else None)
        return self._tls

    def blob_put(self, data: bytes, tenant: str | None = None) -> str:
        return self.ac.put(data).to_json()

    def blob_get(self, token: str, tenant: str | None = None) -> bytes:
        return self.ac.get(token)

    def blob_delete(self, token: str, tenant: str | None = None) -> None:
        self.ac.delete(token)

    def fs(self):
        return self._clients().fs

    def hot_fs(self):
        return self._clients().hot


class LocalDriver(CapacityDriver):
    """Over an in-process deploy.FsCluster (the bench/CI smoke): blobs ride
    the MiniCluster access layer directly, metadata the in-proc clients.

    `device` is where the blobs must be coded: None means the CUDA device.
    A cluster whose codec runs anywhere else is refused, so a capacity run
    never measures a host codec in place of the card's."""

    def __init__(self, cluster, cold_volume: str, hot_volume: str | None = None,
                 device=None):
        from chubaofs_tpu_torch.ops.rs import resolve_device

        want = resolve_device(device)
        have = cluster.blobstore.codec.device
        index_differs = (None not in (have.index, want.index)
                         and have.index != want.index)
        if have.type != want.type or index_differs:
            raise ValueError(f"LocalDriver: the cluster's codec runs on "
                             f"{have}, not on {want}")
        self.cluster = cluster
        self.access = cluster.blobstore.access
        self._fs = cluster.client(cold_volume)
        self._hot = cluster.client(hot_volume) if hot_volume else None

    def blob_put(self, data: bytes, tenant: str | None = None) -> str:
        return self.access.put(data).to_json()

    def blob_get(self, token: str, tenant: str | None = None) -> bytes:
        return self.access.get(token)

    def blob_delete(self, token: str, tenant: str | None = None) -> None:
        self.access.delete(token)

    def fs(self):
        return self._fs

    def hot_fs(self):
        return self._hot


class S3Driver(CapacityDriver):
    """Blob verbs over the objectnode S3 surface with PER-TENANT sigv4
    credentials: the tenant mix lands on the gateway the QoS
    plane shapes, so `cfs-capacity --s3` gates fairness through the same
    SLO burn-window verdict as every other scenario. Each tenant owns its
    bucket (`cap-<tenant>`); a PUT mints a fresh key and the returned
    token is the object path. Any non-2xx — INCLUDING a 429/503 throttle —
    surfaces as an op error, which is exactly what feeds the error-ratio
    and per-tenant throttle SLOs the gate reads. Metadata/hot verbs
    delegate to an inner SDK driver (the S3 dialect has no metadata-op
    analog)."""

    def __init__(self, s3_addr: str, creds: dict[str, tuple[str, str]],
                 inner: CapacityDriver | None = None):
        self.addr = s3_addr
        self.creds = dict(creds)
        self.inner = inner
        self._tls = threading.local()
        self._uid = itertools.count()

    def _request(self, method: str, path: str, tenant: str,
                 body: bytes = b"") -> tuple[int, bytes]:
        import http.client

        from chubaofs_tpu_torch.objectnode.auth import sign_v4

        ak, sk = self.creds[tenant]
        hdrs = sign_v4(method, path, "", {"host": self.addr}, ak, sk,
                       payload=body)
        conn = getattr(self._tls, "conn", None)
        for attempt in (0, 1):  # one free retry on a stale keep-alive conn
            if conn is None:
                host, port = self.addr.rsplit(":", 1)
                conn = http.client.HTTPConnection(  # obslint: per-tenant sigv4 S3 client; the rpc pool neither signs nor models per-tenant conns
                    host, int(port), timeout=60)
                self._tls.conn = conn
            try:
                conn.request(method, path, body=body or None, headers=hdrs)
                resp = conn.getresponse()
                return resp.status, resp.read()
            except Exception:
                conn.close()
                conn = self._tls.conn = None
                if attempt:
                    raise
        raise RuntimeError("unreachable")

    def ensure_buckets(self) -> None:
        for tenant in self.creds:
            status, body = self._request("PUT", f"/cap-{tenant}", tenant)
            if status != 200 and b"BucketAlreadyExists" not in body:
                raise RuntimeError(
                    f"bucket create for {tenant}: HTTP {status} {body[:200]}")

    def blob_put(self, data: bytes, tenant: str | None = None) -> str:
        path = f"/cap-{tenant}/o{next(self._uid)}"
        status, body = self._request("PUT", path, tenant, body=data)
        if status != 200:
            raise RuntimeError(f"S3 PUT {path}: HTTP {status} {body[:120]}")
        return path

    def blob_get(self, token: str, tenant: str | None = None) -> bytes:
        status, body = self._request("GET", token, tenant)
        if status != 200:
            raise RuntimeError(f"S3 GET {token}: HTTP {status} {body[:120]}")
        return body

    def blob_delete(self, token: str, tenant: str | None = None) -> None:
        status, body = self._request("DELETE", token, tenant)
        if status not in (200, 204):
            raise RuntimeError(f"S3 DELETE {token}: HTTP {status} "
                               f"{body[:120]}")

    def fs(self):
        return self.inner.fs() if self.inner is not None else None

    def hot_fs(self):
        return self.inner.hot_fs() if self.inner is not None else None


# -- the open-loop executor ----------------------------------------------------


class DataLossError(AssertionError):
    """A created blob vanished or read back different bytes — the one
    failure class the gate reports independently of the SLO verdict."""


class Workload:
    """Executes a plan open-loop: ops are SUBMITTED at their arrival times
    regardless of completion progress, so a cluster that can't keep up shows
    rising lateness and server-side latency (which is exactly what the SLO
    burn windows exist to catch) instead of a silently stretched run.

    Correctness ledger: per-(tenant, key) the last PUT's crc32 is held and
    every GET verifies against it — byte-identical reads and no created-blob
    loss are hard failures, not metrics. Per-key locks serialize ops on one
    key (per-object consistency), so verification is exact while distinct
    keys still fan out across the worker pool."""

    def __init__(self, driver: CapacityDriver, plan: dict, seed: int = 0,
                 workers: int = 8):
        self.driver = driver
        self.plan = plan
        self.workers = workers
        self.rng = random.Random(f"capacity-payload-{seed}")
        # tenant is a BOUNDED label from here on: any stray string aborts
        exporter.declare_label_values("tenant", plan["tenants"])
        self.reg = exporter.registry("capacity")
        # registries are process-global: baseline every counter this run will
        # read so an A/B's second phase reports ITS ops, not the sum
        self._base = {(t, k, s): self.reg.counter(
            "ops", {"tenant": t, "op": k, "status": s}).value
            for t in plan["tenants"] for k in OP_KINDS for s in STATUSES}
        self._lock = SanitizedLock(name="capacity.workload")
        self._blob: dict[tuple[str, int], tuple[str, int]] = {}  # (t,k) -> (token, crc)
        self._hotcrc: dict[tuple[str, int], int] = {}
        self._keylocks: dict[tuple[str, int], threading.Lock] = {}
        self.corruptions: list[str] = []
        self.max_late_s = 0.0

    # -- bookkeeping ----------------------------------------------------------

    def _keylock(self, tenant: str, key: int) -> threading.Lock:
        with self._lock:
            lk = self._keylocks.get((tenant, key))
            if lk is None:
                lk = self._keylocks[(tenant, key)] = threading.Lock()
            return lk

    def _count(self, op: Op, status: str) -> None:
        self.reg.counter("ops", {"tenant": op.tenant, "op": op.kind,
                                 "status": status}).add()

    def _payload(self, size: int) -> bytes:
        with self._lock:  # Random instances are not thread-safe
            return self.rng.randbytes(size)

    # -- op bodies ------------------------------------------------------------

    def _path(self, op: Op) -> str:
        return f"/cap/{op.tenant}/k{op.key}"

    def _exec(self, op: Op) -> str:
        k = (op.tenant, op.key)
        with self._keylock(*k):
            if op.kind == "blob_put":
                data = self._payload(op.size)
                token = self.driver.blob_put(data, tenant=op.tenant)
                with self._lock:
                    old = self._blob.get(k)
                    self._blob[k] = (token, zlib.crc32(data))
                if old:  # overwrite semantics: retire the displaced blob
                    self.driver.blob_delete(old[0], tenant=op.tenant)
                return "ok"
            if op.kind == "blob_get":
                with self._lock:
                    ent = self._blob.get(k)
                if ent is None:
                    return "miss"  # nothing PUT under this key yet
                data = self.driver.blob_get(ent[0], tenant=op.tenant)
                if zlib.crc32(data) != ent[1]:
                    raise DataLossError(
                        f"blob {k} read back different bytes")
                return "ok"
            if op.kind == "blob_delete":
                with self._lock:
                    ent = self._blob.pop(k, None)
                if ent is None:
                    return "miss"
                self.driver.blob_delete(ent[0], tenant=op.tenant)
                return "ok"
            if op.kind in ("hot_write", "hot_read"):
                return self._exec_hot(op, k)
            return self._exec_meta(op)

    def _exec_hot(self, op: Op, k: tuple) -> str:
        from chubaofs_tpu_torch.sdk.fs import FsError

        fs = self.driver.hot_fs()
        if fs is None:
            return "miss"  # no hot volume in this topology
        path = f"/hot/{op.tenant}/k{op.key}"
        if op.kind == "hot_write":
            data = self._payload(op.size)
            fs.mkdirs(f"/hot/{op.tenant}")
            fs.write_file(path, data)
            with self._lock:
                self._hotcrc[k] = zlib.crc32(data)
            return "ok"
        with self._lock:
            want = self._hotcrc.get(k)
        if want is None:
            return "miss"
        try:
            data = fs.read_file(path)
        except FsError:
            raise DataLossError(f"hot file {path} vanished") from None
        if zlib.crc32(data) != want:
            raise DataLossError(f"hot file {path} read back different bytes")
        return "ok"

    def _exec_meta(self, op: Op) -> str:
        from chubaofs_tpu_torch.sdk.fs import FsError

        fs = self.driver.fs()
        path = self._path(op)
        try:
            if op.kind == "meta_create":
                fs.mkdirs(f"/cap/{op.tenant}")
                try:
                    fs.create(path)
                except FsError as e:
                    if e.code != "EEXIST":
                        raise
                return "ok"
            if op.kind == "meta_stat":
                fs.stat(path)
                return "ok"
            if op.kind == "meta_list":
                fs.readdir(f"/cap/{op.tenant}")
                return "ok"
            if op.kind == "meta_delete":
                fs.unlink(path)
                return "ok"
        except FsError as e:
            if e.code in ("ENOENT", "ENOTDIR"):
                return "miss"  # deletes/stats race by design under churn
            raise
        raise ValueError(f"unknown op kind {op.kind!r}")

    def _run_one(self, op: Op, sched_mono: float) -> None:
        # lateness measured at EXECUTION start, not submit: submit to the
        # unbounded executor queue is instant, so only this stamp exposes
        # the backlog an overwhelmed cluster accumulates (the open-loop
        # signal this harness exists to surface)
        late_s = time.monotonic() - sched_mono
        with self._lock:
            if late_s > self.max_late_s:
                self.max_late_s = late_s
        self.reg.summary("op_lateness_s").observe(max(0.0, late_s))
        try:
            with self.reg.tp("op_latency", {"op": op.kind}):
                status = self._exec(op)
        except DataLossError as e:
            with self._lock:
                self.corruptions.append(str(e))
            self._count(op, "error")
            return
        except Exception:
            status = "error"
        self._count(op, status)

    # -- the loop -------------------------------------------------------------

    def run(self, drain_timeout: float = 120.0) -> dict:
        from concurrent.futures import ThreadPoolExecutor, wait

        start = time.monotonic()
        futs = []
        pool = ThreadPoolExecutor(self.workers, thread_name_prefix="cap-worker")
        try:
            for op in self.plan["ops"]:
                delay = (start + op.at) - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                futs.append(pool.submit(self._run_one, op, start + op.at))
            _, pending = wait(futs, timeout=drain_timeout)
        finally:
            # no `with`: the context exit is shutdown(wait=True), which would
            # block PAST drain_timeout on a wedged cluster — the gate must
            # get to report. cancel_futures drops the queued backlog so
            # abandoned ops don't keep executing into the counters either.
            pool.shutdown(wait=False, cancel_futures=True)
        return self.summary(abandoned=len(pending),
                            wall_s=time.monotonic() - start)

    def summary(self, abandoned: int = 0, wall_s: float = 0.0) -> dict:
        per_tenant: dict[str, dict] = {}
        totals = dict.fromkeys(STATUSES, 0)
        for t in self.plan["tenants"]:
            row: dict[str, int] = {}
            for kind in OP_KINDS:
                for status in STATUSES:
                    v = int(self.reg.counter(
                        "ops", {"tenant": t, "op": kind,
                                "status": status}).value
                        - self._base[(t, kind, status)])
                    if v:
                        row[f"{kind}_{status}"] = v
                        totals[status] += v
            per_tenant[t] = row
        return {"ops_planned": len(self.plan["ops"]), **{
            f"ops_{s}": v for s, v in totals.items()},
            "ops_abandoned": abandoned, "wall_s": round(wall_s, 2),
            "max_late_s": round(self.max_late_s, 3),
            "corruptions": list(self.corruptions),
            "per_tenant": per_tenant}

    def close(self) -> None:
        exporter.declare_label_values("tenant", None)


# -- the collector + gate ------------------------------------------------------


def failing_slos(health: dict[str, dict]) -> dict[str, list[str]]:
    """target -> names of its FAILING SLOs (['unreachable'] for a corpse,
    ['failing'] for a target failing without naming one)."""
    out: dict[str, list[str]] = {}
    for target, h in (health or {}).items():
        if (h or {}).get("status") != FAILING:
            continue
        names = sorted(name for name, s in (h.get("slos") or {}).items()
                       if (s or {}).get("status") == FAILING)
        if not names:
            names = (["unreachable"]
                     if "unreachable" in (h.get("reasons") or ()) else
                     ["failing"])
        out[target] = names
    return out


class Collector(threading.Thread):
    """Polls the console (or direct daemon addrs) every `interval` and
    archives one cfs-top frame per poll as a JSONL record — the capacity
    report — while accumulating the gate's evidence: every (target, slo)
    pair seen failing and the worst status observed."""

    def __init__(self, out_path: str, console: str | None = None,
                 addrs: list[str] | None = None, interval: float = 1.0,
                 autopilot=None):
        super().__init__(name="cap-collector", daemon=True)
        self.out_path = out_path
        self.console = console
        self.addrs = list(addrs or [])
        self.interval = interval
        # the console-fed closed loop: each alert poll is also
        # forwarded to an Autopilot's observe_rollup, so the controller
        # sees the firing↔resolved edges the harness's gate judges by
        self.autopilot = autopilot
        self._halt = threading.Event()
        self._lock = SanitizedLock(name="capacity.collector")
        self.frames = 0
        self.health_frames = 0  # frames that carried >=1 target verdict
        self.worst = OK
        self.flipped: dict[str, set] = {}
        self.poll_errors = 0
        # the event/alert timeline rides the same report: each
        # frame archives the events that arrived since the last poll
        # (cursor-paged, so nothing double-archives) and the alerts
        # currently firing; the verdict NAMES every alert that fired
        self._events_cursor: dict = {}
        self.alerts_fired: dict[str, set] = {}  # target -> rule names

    def stop(self, timeout: float = 30.0) -> None:
        self._halt.set()
        self.join(timeout=timeout)

    def _poll_timeline(self, rec: dict) -> None:
        """Fold the since-last-poll event slice and the firing alerts into
        this frame's archive record. Best-effort per surface: a console
        that predates the event plane costs a poll error, never the frame."""
        from chubaofs_tpu_torch.tools.cfsevents import fetch_alerts, fetch_events

        try:
            evs, cursor, _ = fetch_events(self.console, self.addrs,
                                          cursor=self._events_cursor, n=500)
            self._events_cursor = cursor
            rec["events"] = [
                {"ts": e.get("ts"), "type": e.get("type"),
                 "severity": e.get("severity"), "entity": e.get("entity"),
                 "target": e.get("target", ""), "detail": e.get("detail")}
                for e in evs]
        except Exception:
            rec["events"] = None  # surface unavailable, distinct from []
            with self._lock:
                self.poll_errors += 1
        try:
            roll = fetch_alerts(self.console, self.addrs)
            firing: dict[str, list[str]] = {}
            for row in roll.get("targets", ()):
                names = sorted({a["name"] for a in row.get("alerts", ())
                                if a.get("state") == "firing"})
                if names:
                    firing[row["target"]] = names
                    with self._lock:
                        self.alerts_fired.setdefault(
                            row["target"], set()).update(names)
            rec["alerts"] = firing
            if self.autopilot is not None:
                # the whole rollup, all states: observe_rollup dedups the
                # firing set itself and derives the resolved edges
                self.autopilot.observe_rollup(
                    [a for row in roll.get("targets", ())
                     for a in row.get("alerts", ())])
        except Exception:
            rec["alerts"] = None
            with self._lock:
                self.poll_errors += 1

    def _poll_once(self, t0: float, prev: dict) -> dict:
        from chubaofs_tpu_torch.tools.cfstop import (
            compute_rows, fetch_frame, frame_record)

        cur = fetch_frame(self.console, self.addrs)
        rows = compute_rows(prev, cur)
        rec = frame_record(t0, cur, rows)
        self._poll_timeline(rec)
        flips = failing_slos(cur["health"])
        statuses = [h.get("status", FAILING)
                    for h in cur["health"].values()] or [OK]
        worst_now = max(statuses, key=lambda s: RANK.get(s, RANK[FAILING]))
        rec["worst"] = worst_now if worst_now in RANK else FAILING
        rec["failing"] = {t: sorted(n) for t, n in flips.items()}
        with self._lock:
            self.frames += 1
            if cur["health"]:
                self.health_frames += 1
            if cur["errors"]:
                self.poll_errors += 1
            if RANK.get(rec["worst"], RANK[FAILING]) > RANK[self.worst]:
                self.worst = rec["worst"]
            for target, names in flips.items():
                self.flipped.setdefault(target, set()).update(names)
        with open(self.out_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
        return cur

    def run(self) -> None:
        from chubaofs_tpu_torch.tools.cfstop import fetch_frame

        prev = fetch_frame(self.console, self.addrs)
        t0 = prev["mono"]
        while not self._halt.wait(self.interval):
            try:
                prev = self._poll_once(t0, prev)
            except Exception:
                with self._lock:
                    self.poll_errors += 1
        # one closing frame so a fault injected near the end still lands
        try:
            self._poll_once(t0, prev)
        except Exception:
            with self._lock:
                self.poll_errors += 1

    def verdict(self) -> dict:
        """The gate: failing iff any SLO flipped on any target — or iff the
        collector gathered NO health evidence at all. A dead/misaddressed
        console yields empty health dicts on every poll; an all-green
        verdict built on zero verdicts would let a capacity run pass
        blind, so absence of evidence fails the gate loudly."""
        with self._lock:
            flipped = {t: sorted(n) for t, n in self.flipped.items()}
            if self.health_frames == 0:
                flipped.setdefault("collector", []).append("no-health-data")
            return {"verdict": FAILING if flipped else self.worst,
                    "flipped": flipped, "frames": self.frames,
                    "health_frames": self.health_frames,
                    "poll_errors": self.poll_errors,
                    # the gate NAMES the alerts that fired during the run —
                    # the operator reads which rule paged, not just that an
                    # SLO burn window flipped
                    "alerts_fired": {t: sorted(n)
                                     for t, n in self.alerts_fired.items()}}


# -- spread measurement (the A/B's metric) -------------------------------------


class SpreadMonitor(threading.Thread):
    """Accumulates per-datanode op load across heartbeat windows by sampling
    the master registry; windows are deduped on last_heartbeat so each
    report counts once. The summary is the per-node ops spread the
    rebalance A/B compares (coefficient of variation + max/mean)."""

    def __init__(self, mc, interval: float = 0.5):
        super().__init__(name="cap-spread", daemon=True)
        self.mc = mc
        self.interval = interval
        self._halt = threading.Event()
        self._lock = SanitizedLock(name="capacity.spread")
        self.totals: dict[int, float] = {}
        self._seen_hb: dict[int, float] = {}

    def stop(self, timeout: float = 10.0) -> None:
        self._halt.set()
        self.join(timeout=timeout)

    def sample(self) -> None:
        cluster = self.mc.get_cluster()
        with self._lock:
            for n in cluster["nodes"]:
                if n.get("kind") != "data":
                    continue
                nid = int(n["node_id"])
                hb = float(n.get("last_heartbeat") or 0.0)
                if hb and self._seen_hb.get(nid) == hb:
                    continue  # same window as last sample
                self._seen_hb[nid] = hb
                self.totals[nid] = self.totals.get(nid, 0.0) + sum(
                    (n.get("loads") or {}).values())

    def run(self) -> None:
        while not self._halt.wait(self.interval):
            try:
                self.sample()
            except Exception:
                pass  # master hiccup: next sample catches up
        try:
            self.sample()
        except Exception:
            pass

    def summary(self) -> dict:
        with self._lock:
            totals = dict(self.totals)
        vals = list(totals.values())
        if not vals or sum(vals) <= 0:
            return {"per_node": totals, "cv": 0.0, "max_over_mean": 0.0}
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / len(vals)
        return {"per_node": {str(k): round(v, 1) for k, v in totals.items()},
                "cv": round(math.sqrt(var) / mean, 3),
                "max_over_mean": round(max(vals) / mean, 3)}


# -- orchestration -------------------------------------------------------------


def run_capacity(args, rebalance: bool, root: str, out_path: str,
                 autopilot: bool | None = None, device=None) -> dict:
    """One full harness phase: boot a ProcCluster + console, run the seeded
    open-loop workload under the collector, tear down, return the summary
    (gate verdict + workload ledger + spread). With `autopilot` a
    console-fed Autopilot rides the Collector's alert polls and drives the
    master through MasterClient actuators — the closed loop under test.
    `device` is the blobstore daemon's codec device (None: the CUDA
    device)."""
    from chubaofs_tpu_torch.testing.harness import ProcCluster

    autopilot = (getattr(args, "autopilot", False)
                 if autopilot is None else autopilot)
    scenario = getattr(args, "scenario", "none")

    env = {}
    for kv in args.daemon_env:
        k, _, v = kv.partition("=")
        env[k] = v
    if args.failpoints:
        env["CFS_FAILPOINTS"] = args.failpoints
    # the harness IS an incident consumer: arm every daemon's flight
    # recorder so an SLO-gate flip can collect evidence (--daemon-env
    # CFS_FLIGHT=0 opts out for the zero-overhead A/B)
    env.setdefault("CFS_FLIGHT", "1")
    if getattr(args, "cache_mb", 0) > 0:
        # the cache-tier A/B lever: the blobstore daemon's MiniCluster
        # builds a BlobCache from this env knob, so the harness's zipfian
        # GET head rides the tiered read plane (cfs_cache_* families then
        # show up in the capacity report's frames)
        env["CFS_CACHE_MB"] = str(args.cache_mb)
    master_extra = {}
    if rebalance:
        master_extra["rebalanceHotSecs"] = args.rebalance_secs
    s3_mode = bool(getattr(args, "s3", False))
    s3_creds: dict[str, tuple[str, str]] = {}
    if s3_mode:
        # deterministic per-tenant credentials, minted BEFORE the daemons
        # boot so the objectnode's QoS plane can be told the tenant set up
        # front — random create-time keys would all fold into the 'other'
        # label and per-tenant shaping/SLOs could never engage
        s3_creds = {t: (f"cap-ak-{t}", f"cap-sk-{t}")
                    for t in (f"t{i}" for i in range(args.tenants))}
        env.setdefault("CFS_QOS_TENANTS",
                       ",".join(ak for ak, _ in s3_creds.values()))
    cluster = ProcCluster(root, masters=args.masters,
                          metanodes=args.metanodes, datanodes=args.datanodes,
                          blobstore=True, objectnode=s3_mode, env=env,
                          master_extra=master_extra or None,
                          device=None if device is None else str(device))
    collector = spread = workload = None
    try:
        mc = cluster.client_master()
        mc.create_volume("cap_cold", cold=True)
        hot_vol = None
        if args.datanodes >= 3:
            mc.create_volume("cap_hot", cold=False,
                             dp_count=max(3, args.datanodes))
            hot_vol = "cap_hot"
        targets = [cluster.access_addr] + cluster.stats_addrs()
        console = cluster.spawn_console(metrics_addrs=targets)
        # scenario shaping: pure plan-side skew, so the A/B phases see the
        # identical injected stress (the determinism contract holds — the
        # scenario only changes plan_ops arguments)
        zipf_s, ramp, storm = args.zipf_s, args.ramp, None
        if scenario == "hotspot":
            zipf_s, ramp = max(zipf_s, 3.0), "spike"
        elif scenario == "tenant-storm":
            storm = "t0"
        plan = plan_ops(args.seed, args.tenants, args.duration, args.rate,
                        zipf_s, keys_per_tenant=args.keys,
                        ramp=ramp, hot=hot_vol is not None, storm=storm)
        driver = RemoteDriver(cluster.master_addrs, [cluster.access_addr],
                              "cap_cold", hot_volume=hot_vol)
        if s3_mode:
            # the tenant mix lands on the S3 gateway instead of the SDK
            # access client: per-tenant master users (the deterministic
            # credentials the daemon env already declares), per-tenant
            # buckets, sigv4 on every blob verb — the surface the
            # CFS_QOS_* plane (armed via --daemon-env) shapes. Meta/hot
            # verbs still ride the SDK driver underneath.
            for t in plan["tenants"]:
                ak, sk = s3_creds[t]
                mc.create_user(f"cap-{t}", ak=ak, sk=sk)
            driver = S3Driver(cluster.s3_addr, s3_creds, inner=driver)
            driver.ensure_buckets()
        ctl = None
        if autopilot:
            from chubaofs_tpu_torch import autopilot as ap

            ctl = ap.Autopilot(bindings=ap.default_bindings(), enabled=True)
            for act in ap.client_actuators(mc):
                ctl.register(act)
        collector = Collector(out_path, console=console,
                              interval=args.interval, autopilot=ctl)
        spread = SpreadMonitor(mc)
        collector.start()
        spread.start()
        workload = Workload(driver, plan, seed=args.seed,
                            workers=args.workers)
        killer = None
        if scenario == "node-kill" and args.datanodes >= 3:
            # SIGKILL a replica-bearing datanode mid-run: the repair plane
            # (and the autopilot, when armed) must absorb it — with <3
            # datanodes there is no replicated volume to survive the loss
            victim = f"datanode{args.datanodes - 1}"
            killer = threading.Timer(max(1.0, args.duration * 0.4),
                                     lambda: cluster.kill(victim))
            killer.daemon = True
            killer.start()
        ledger = workload.run()
        if killer is not None:
            killer.cancel()
        time.sleep(max(2 * args.interval, 1.0))  # tail windows land
        spread.stop()
        collector.stop()
        out = {"rebalance": rebalance, "report": out_path,
               **collector.verdict(), **ledger,
               "spread": spread.summary()}
        if ctl is not None:
            ctl.tick()  # settle gates that expired after the last poll
            st = ctl.status()
            by: dict[str, int] = {}
            for d in st["decisions"]:
                by[d["decision"]] = by.get(d["decision"], 0) + 1
            out["autopilot"] = {"enabled": True, "decisions": by,
                                "actions": by.get("executed", 0),
                                "rolled_back": by.get("rolled_back", 0),
                                "budget": st["budget"]}
        if ledger["corruptions"]:
            out["verdict"] = FAILING
            out["flipped"] = {**out.get("flipped", {}),
                              "workload": ["data-loss"]}
        if out["verdict"] == FAILING:
            # gate flipped: collect the cross-daemon incident bundle NOW,
            # while the cluster (and its rings) is still alive — the
            # failure report prints the path. Best-effort: a collection
            # error must never mask the verdict itself.
            try:
                from chubaofs_tpu_torch.tools.cfsstat import scrape

                incident = json.loads(
                    scrape(console, "/api/incident?trigger=capacity_gate",
                           timeout=60.0))
                out["incident_bundle"] = incident.get("dir")
            except Exception:
                out["incident_bundle"] = None
        return out
    finally:
        for th in (collector, spread):
            if th is not None and th.is_alive():
                th.stop()
        if workload is not None:
            workload.close()
        cluster.close()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="cfs-capacity", description=__doc__)
    p.add_argument("--seed", type=int, default=env_int("CFS_CAP_SEED", 0))
    p.add_argument("--tenants", type=int,
                   default=env_int("CFS_CAP_TENANTS", 4))
    p.add_argument("--zipf-s", type=float,
                   default=env_float("CFS_CAP_ZIPF_S", 1.2))
    p.add_argument("--ramp", default=os.environ.get("CFS_CAP_RAMP", "diurnal"),
                   choices=("diurnal", "flat", "spike"))
    p.add_argument("--duration", type=float, default=30.0,
                   help="workload length (s)")
    p.add_argument("--rate", type=float, default=40.0,
                   help="peak arrival rate (ops/s, open loop)")
    p.add_argument("--keys", type=int, default=64,
                   help="keyspace size per tenant (zipf ranks)")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--interval", type=float, default=1.0,
                   help="collector poll period (s) — also the burn-window "
                        "snapshot cadence on the polled daemons")
    p.add_argument("--out", default="", help="capacity report JSONL path "
                   "(default <root>/capacity.jsonl)")
    p.add_argument("--root", default="", help="cluster state dir")
    p.add_argument("--masters", type=int, default=1)
    p.add_argument("--metanodes", type=int, default=3)
    p.add_argument("--datanodes", type=int, default=0,
                   help=">=3 adds a hot volume + hot IO to the blends")
    p.add_argument("--failpoints", default="",
                   help="CFS_FAILPOINTS spec injected into every daemon "
                        "(e.g. 'blobnode.put_shard=delay(0.08)')")
    p.add_argument("--daemon-env", action="append", default=[],
                   metavar="K=V", help="extra env for daemons (repeatable; "
                   "e.g. CFS_SLO_PUT_P99_MS=20)")
    p.add_argument("--cache-mb", type=int,
                   default=env_int("CFS_CACHE_MB", 0),
                   help="arm the blobstore daemon's tiered read cache with "
                        "this memory budget (MiB); 0 = cold EC path only")
    p.add_argument("--s3", action="store_true",
                   help="drive the tenant mix at the objectnode S3 surface "
                        "(per-tenant users + buckets + sigv4) instead of "
                        "the SDK access client; combine with --daemon-env "
                        "CFS_QOS_*=... to shape it")
    p.add_argument("--rebalance", action="store_true",
                   help="arm the master's hot-volume spreading sweep")
    p.add_argument("--rebalance-secs", type=float, default=2.0)
    p.add_argument("--ab-rebalance", action="store_true",
                   help="run the same seeded scenario twice (rebalance "
                        "off, then on) and report both spreads")
    p.add_argument("--autopilot", action="store_true",
                   help="arm the console-fed autopilot: firing alerts "
                        "drive master actuators through the declarative "
                        "bindings, gated by budget/cooldown/flap damping")
    p.add_argument("--ab-autopilot", action="store_true",
                   help="run the same seeded scenario twice (autopilot "
                        "off, then on); only the ON phase gates the exit "
                        "code — the OFF phase is the control arm")
    p.add_argument("--scenario", default="none",
                   choices=("none", "hotspot", "tenant-storm", "node-kill"),
                   help="canned stress: zipf hotspot under a spike ramp, "
                        "one tenant soaking 60%% of arrivals, or a "
                        "mid-run datanode SIGKILL (needs --datanodes>=3)")
    p.add_argument("--device", default=None,
                   help="the blobstore daemon's codec device (default: the "
                        "CUDA device; 'cpu' runs the codec math on the host)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    import shutil
    import tempfile

    import torch

    from chubaofs_tpu_torch.ops.rs import resolve_device

    # refuse before any cluster boots: a run told (or defaulted) to use the
    # card never runs its codec on the host instead
    if (resolve_device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError(f"device {args.device!r}: no CUDA device "
                           "available; pass --device cpu to run the codec "
                           "on the host")

    root = args.root or tempfile.mkdtemp(prefix="cfscap")
    try:
        if args.ab_rebalance:
            res_off = run_capacity(
                args, rebalance=False, root=os.path.join(root, "off"),
                out_path=args.out or os.path.join(root, "capacity-off.jsonl"),
                device=args.device)
            res_on = run_capacity(
                args, rebalance=True, root=os.path.join(root, "on"),
                out_path=(args.out + ".on" if args.out
                          else os.path.join(root, "capacity-on.jsonl")),
                device=args.device)
            result = {"metric": "capacity_ab", "seed": args.seed,
                      "off": res_off, "on": res_on,
                      "spread_cv_off": res_off["spread"]["cv"],
                      "spread_cv_on": res_on["spread"]["cv"]}
            failing = (res_off["verdict"] == FAILING
                       or res_on["verdict"] == FAILING)
        elif args.ab_autopilot:
            res_off = run_capacity(
                args, rebalance=args.rebalance, autopilot=False,
                root=os.path.join(root, "off"),
                out_path=args.out or os.path.join(root, "capacity-off.jsonl"),
                device=args.device)
            res_on = run_capacity(
                args, rebalance=args.rebalance, autopilot=True,
                root=os.path.join(root, "on"),
                out_path=(args.out + ".on" if args.out
                          else os.path.join(root, "capacity-on.jsonl")),
                device=args.device)
            result = {"metric": "capacity_ab_autopilot", "seed": args.seed,
                      "scenario": args.scenario,
                      "off": res_off, "on": res_on,
                      "verdict_off": res_off["verdict"],
                      "verdict_on": res_on["verdict"],
                      "actions_on": (res_on.get("autopilot") or {})
                      .get("actions", 0)}
            # the control arm is EXPECTED to degrade under a scenario —
            # only the closed-loop arm gates the exit code
            failing = res_on["verdict"] == FAILING
        else:
            res = run_capacity(
                args, rebalance=args.rebalance, root=root,
                out_path=args.out or os.path.join(root, "capacity.jsonl"),
                device=args.device)
            result = {"metric": "capacity_verdict", "seed": args.seed, **res}
            failing = res["verdict"] == FAILING
    finally:
        if not args.root:
            shutil.rmtree(root, ignore_errors=True)

    print(json.dumps(result) if args.json
          else json.dumps(result, indent=2))
    if failing:
        flipped = result.get("flipped") or {
            **result.get("off", {}).get("flipped", {}),
            **result.get("on", {}).get("flipped", {})}
        alerts = result.get("alerts_fired") or {
            **result.get("off", {}).get("alerts_fired", {}),
            **result.get("on", {}).get("alerts_fired", {})}
        bundle = (result.get("incident_bundle")
                  or result.get("off", {}).get("incident_bundle")
                  or result.get("on", {}).get("incident_bundle"))
        print(f"CAPACITY GATE FAILED: {json.dumps(flipped)}"
              f" alerts={json.dumps(alerts)}"
              + (f" incident_bundle={bundle} (cfs-doctor inspect)"
                 if bundle else ""),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
