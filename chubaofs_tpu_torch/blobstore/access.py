"""Access — the stateless blobstore gateway: PUT / GET / DELETE.

Reference counterpart: blobstore/access (stream_put.go:45-442, stream_get.go:112,
server_location.go). Semantics kept:

  * PUT splits the object into blobs of at most MAX_BLOB_SIZE, picks a code mode
    by size (SelectCodeMode analog), allocates a volume + bids, EC-encodes, and
    writes shards to blobnodes with a put-quorum; shards that fail the write are
    queued on the repair topic (stream_put.go:377-397).
  * GET reads data shards directly and falls back to on-the-fly reconstruction
    from parity when shards are missing/corrupt (stream_get.go:427-430,
    getDataShardOnly :527), emitting repair messages for what it found broken.
  * Locations are HMAC-signed tokens (server_location.go) carrying the blob map.

Device difference: all codec math goes through the batching CodecService, so
concurrent PUT/GET streams share device batches (one GF(2^8) kernel launch
each, ops/cuda_gf.py) instead of each paying a dispatch. Access(codec=None)
takes codec.service.default_service(), which runs on the CUDA device.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import threading
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field

import numpy as np

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.blobstore.blobnode import BlobNode
from chubaofs_tpu_torch.blobstore.clustermgr import ClusterMgr, VolumeInfo
from chubaofs_tpu_torch.blobstore.proxy import Proxy
from chubaofs_tpu_torch.codec.codemode import CodeMode, get_tactic
from chubaofs_tpu_torch.codec.service import CodecService, default_service
from chubaofs_tpu_torch.utils.auditlog import record_slow_op
from chubaofs_tpu_torch.utils.breaker import CircuitBreaker
from chubaofs_tpu_torch.utils.locks import SanitizedLock
from chubaofs_tpu_torch.utils.exporter import BATCH_BUCKETS, registry

MAX_BLOB_SIZE = 4 * 1024 * 1024


class AccessError(Exception):
    pass


class QuorumError(AccessError):
    pass


class VolumeFullError(AccessError):
    """Quorum failed because the volume's chunks are full — rotate volumes."""


class LocationError(AccessError):
    pass


class DiskPunished(AccessError):
    """Disk is in its punish window after repeated errors/timeouts — writes
    fail fast instead of queueing behind a wedged device (stream_put.go:303-340
    punishDisk analog)."""


class _PipelineAborted(Exception):
    """Internal: a later pipeline stage was skipped because an earlier blob's
    quorum already failed — never user-visible (the first real error wins)."""


@dataclass(frozen=True)
class CodeModePolicy:
    """One enabled size band for a code mode (access/codemode.go:24-45 analog)."""

    mode: CodeMode
    min_size: int = 0
    max_size: int = 1 << 62


def default_policies(az_count: int) -> list[CodeModePolicy]:
    """Size-tiered, AZ-aware policy table. Small blobs favor low shard-count
    modes (less per-shard overhead); large blobs favor wide stripes; clusters
    with >=2 AZs put LRC modes on the live path so repairs stay AZ-local
    (codemode.go:119-126)."""
    K, M_ = 1024, 1024 * 1024
    if az_count >= 3:
        return [
            CodeModePolicy(CodeMode.EC6P6, 0, 128 * K),
            CodeModePolicy(CodeMode.EC12P9, 128 * K + 1, M_),
            CodeModePolicy(CodeMode.EC6P3L3, M_ + 1),  # LRC archive tier
        ]
    if az_count == 2:
        return [
            CodeModePolicy(CodeMode.EC6P10L2, 0, M_),
            CodeModePolicy(CodeMode.EC16P20L2, M_ + 1),  # LRC archive tier
        ]
    return [
        CodeModePolicy(CodeMode.EC3P3, 0, 128 * K),
        CodeModePolicy(CodeMode.EC6P3, 128 * K + 1, M_),
        CodeModePolicy(CodeMode.EC12P4, M_ + 1),
    ]


def select_code_mode(size: int, policies: list[CodeModePolicy] | None = None) -> CodeMode:
    """Policy-table code-mode choice (stream_put.go:64 SelectCodeMode analog)."""
    for p in policies or default_policies(1):
        if p.min_size <= size <= p.max_size:
            return p.mode
    raise AccessError(f"no code-mode policy covers size {size}")


@dataclass
class Blob:
    bid: int
    vid: int
    size: int


@dataclass
class Location:
    cluster_id: int
    code_mode: int
    size: int
    blobs: list[Blob] = field(default_factory=list)
    crc: int = 0
    signature: str = ""

    def to_json(self) -> str:
        d = {
            "cluster_id": self.cluster_id,
            "code_mode": self.code_mode,
            "size": self.size,
            "blobs": [b.__dict__ for b in self.blobs],
            "crc": self.crc,
            "signature": self.signature,
        }
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "Location":
        d = json.loads(s)
        blobs = [Blob(**b) for b in d.pop("blobs")]
        return cls(**{**d, "blobs": blobs})


class _ReadWaits:
    """The read pool's waits of one fan-out of shard reads, for the span
    current where it is made. Reads submitted in one `submit` call are a
    burst; close(), once the fan-out is done, gives each burst one
    `wait.read_pool` stage on the span, from its submission until the last
    of its reads started on a worker (or until close, for a read still
    queued then). So a fan-out adds a stage per burst, however many reads
    the burst holds."""

    def __init__(self, pool: ThreadPoolExecutor):
        from chubaofs_tpu_torch.blobstore import trace

        self._pool = pool
        self._span = trace.current_span()
        self._bursts: list[tuple[float, list]] = []

    def submit(self, fn, calls: list[tuple]) -> list:
        """fn(*args) on the pool for each args in `calls`: their futures."""
        if self._span is None:
            return [self._pool.submit(fn, *args) for args in calls]
        starts: list = [None] * len(calls)
        self._bursts.append((time.perf_counter(), starts))

        def timed(i, args):
            starts[i] = time.perf_counter()
            return fn(*args)

        return [self._pool.submit(timed, i, args) for i, args in enumerate(calls)]

    def close(self) -> None:
        t_end = time.perf_counter()
        for t_submit, starts in self._bursts:
            if starts:
                last = max(t_end if s is None else s for s in starts)
                self._span.add_stage("wait.read_pool", start=t_submit, dur=last - t_submit)


class Access:
    """One gateway instance. nodes maps node_id -> BlobNode (transport-pluggable)."""

    def __init__(
        self,
        cm: ClusterMgr,
        proxy: Proxy,
        nodes: dict[int, BlobNode],
        codec: CodecService | None = None,
        secret: bytes = b"chubaofs-tpu-location-secret",
        cluster_id: int = 1,
        max_workers: int = 16,
        policies: list[CodeModePolicy] | None = None,
        per_disk_cap: int = 4,
        write_deadline: float = 10.0,
        read_deadline: float = 3.0,
        punish_secs: float = 30.0,
        qos=None,
        cache=None,
    ):
        self.cm = cm
        self.proxy = proxy
        self.nodes = nodes
        # optional blobstore.cache.BlobCache: zipfian GET traffic
        # serves its hot head from here instead of an EC shard gather per
        # read; None keeps the pre-cache read path byte-identical
        self.cache = cache
        self.codec = codec or default_service()
        self.secret = secret
        self.cluster_id = cluster_id
        if policies is None:
            azs = {d.az for d in cm.disks.values()} or {0}
            policies = default_policies(len(azs))
        self.policies = policies
        # failure containment (stream_put.go:303-351): bounded in-flight writes
        # per disk, a hard deadline per stripe write, and a punish window after
        # errors so one wedged blobnode can't exhaust the pool or stall
        # unrelated PUTs
        self.per_disk_cap = per_disk_cap
        self.write_deadline = write_deadline
        # direct-read patience before a shard is handed to the degraded
        # path: a wedged blobnode turns into a reconstruct, not a stall
        self.read_deadline = read_deadline
        self.punish_secs = punish_secs
        self.qos = qos  # optional utils.ratelimit.KeyedLimiter ("put"/"get" bytes)
        self.qos_timeout = 30.0  # max throttle wait before failing the request
        self._disk_sems: dict[int, threading.Semaphore] = {}
        self._punished: dict[int, float] = {}
        self._punish_lock = SanitizedLock(name="access.punish")
        # client-side breaker around control-plane (allocator/proxy) calls:
        # a dead allocator fails PUTs fast instead of stacking every request
        # behind its timeouts (stream_put.go:68 hystrix analog)
        self._alloc_breaker = CircuitBreaker("proxy-alloc", failures=5,
                                             window=10.0, cooldown=5.0)
        self._pool = ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="access")
        # reads NEVER share the write pool: stripe writes can legitimately
        # hold slots up to write_deadline (wedged-disk containment), and a GET
        # queued behind them would trade its millisecond latency for seconds
        self._read_pool = ThreadPoolExecutor(max_workers=max_workers,
                                             thread_name_prefix="access-read")
        # background integrity probes get their OWN small executors: a probe
        # against a wedged blobnode may pin its worker for the wedge duration,
        # and that must starve neither PUT stripes nor GET hedges
        self._probe_pool = ThreadPoolExecutor(max_workers=2,
                                              thread_name_prefix="access-probe")
        self._probe_io = ThreadPoolExecutor(max_workers=4,
                                            thread_name_prefix="access-probe-io")
        self._probing: set[tuple[int, int]] = set()  # (vid, bid) dedupe
        self._probe_lock = SanitizedLock(name="access.probe")
        # data-path pipeline: bounded encode->write overlap window for
        # multi-blob PUTs, and blob-level GET readahead depth. 0 = serial.
        self.pipeline_window = int(os.environ.get("CFS_PIPELINE_WINDOW", "3"))
        # how many blobs may be ENCODED ahead of the write window: wide
        # enough that the codec service still forms full device batches
        # (window-sized encode submission would cap batches at 2-4 jobs),
        # bounded so a 1000-blob object doesn't materialize 1000 stripes
        self.encode_ahead = int(os.environ.get("CFS_PUT_ENCODE_AHEAD", "16"))
        self.max_blob_size = MAX_BLOB_SIZE
        # blob-level pipeline stages get their OWN executor: a PUT stage
        # blocks on a codec future plus shard fan-outs running on self._pool
        # (and a GET stage on self._read_pool) — running stages on either of
        # those pools would let W blocked stages starve their own shard IO
        self._pipe_pool = ThreadPoolExecutor(max_workers=8,
                                             thread_name_prefix="access-pipe")

    # -- failure containment --------------------------------------------------

    def _sem(self, disk_id: int) -> threading.Semaphore:
        with self._punish_lock:
            sem = self._disk_sems.get(disk_id)
            if sem is None:
                sem = threading.Semaphore(self.per_disk_cap)
                self._disk_sems[disk_id] = sem
            return sem

    def _is_punished(self, disk_id: int) -> bool:
        with self._punish_lock:
            return self._punished.get(disk_id, 0.0) > time.monotonic()

    def punish_disk(self, disk_id: int, reason: str = "") -> None:
        with self._punish_lock:
            self._punished[disk_id] = time.monotonic() + self.punish_secs
        registry("access").counter(
            "disk_punish", {"reason": reason or "error"}).add()

    def clear_punishments(self) -> None:
        """Drop every active punish window (ops lever): once an AZ/host
        recovery is CONFIRMED, writes may trust it again immediately instead
        of waiting out punish_secs — otherwise a second failure inside the
        window sees the healed AZ as still dark and blobs land with two AZs'
        worth of shards missing."""
        with self._punish_lock:
            self._punished.clear()

    # -- location signing ----------------------------------------------------

    def _sign(self, loc: Location) -> str:
        payload = json.dumps(
            [loc.cluster_id, loc.code_mode, loc.size, [(b.bid, b.vid, b.size) for b in loc.blobs], loc.crc]
        ).encode()
        return hmac.new(self.secret, payload, hashlib.sha256).hexdigest()

    def _check_sig(self, loc: Location):
        if not hmac.compare_digest(self._sign(loc), loc.signature):
            raise LocationError("bad location signature")

    # -- PUT -----------------------------------------------------------------

    def put(self, data: bytes, code_mode: CodeMode | int | None = None) -> Location:
        from chubaofs_tpu_torch.blobstore import trace

        if self.qos is not None and not self.qos.wait("put", len(data), timeout=self.qos_timeout):
            registry("access").counter("qos_reject", {"op": "put"}).add()
            raise AccessError("put bandwidth limit exceeded")
        with trace.child_of(trace.current_span(), "access.put") as span, \
                registry("access").tp("put"):
            span.set_tag("size", len(data))
            err: Exception | None = None
            try:
                loc = self._put(data, code_mode)
                return loc
            except Exception as e:
                err = e
                raise
            finally:
                span.append_track_log("access", err=err)
                record_slow_op("access", "put",
                               time.perf_counter() - span.start, span=span,
                               err=type(err).__name__ if err else "")

    def _put(self, data: bytes, code_mode: CodeMode | int | None = None) -> Location:
        from chubaofs_tpu_torch.blobstore import trace

        if not data:
            raise AccessError("empty put")
        span = trace.current_span()
        t_prep = time.perf_counter()
        mode = (
            int(code_mode)
            if code_mode is not None
            else int(select_code_mode(len(data), self.policies))
        )
        loc = Location(cluster_id=self.cluster_id, code_mode=mode, size=len(data), crc=zlib.crc32(data))

        blobs = [data[i : i + self.max_blob_size]
                 for i in range(0, len(data), self.max_blob_size)]
        if span is not None:  # crc + blob split: the host-prepare stage
            span.add_stage("prepare", start=t_prep)
        t_alloc = time.perf_counter()
        first_bid, _ = self._alloc_breaker.call(self.proxy.alloc_bids, len(blobs))
        if span is not None:
            span.add_stage("alloc", start=t_alloc)
        t = get_tactic(mode)
        window = int(self.pipeline_window)
        if window >= 1 and len(blobs) > 1:
            loc.blobs.extend(self._put_pipelined(t, mode, blobs, first_bid,
                                                 window))
        else:
            loc.blobs.extend(self._put_serial(t, mode, blobs, first_bid))
        loc.signature = self._sign(loc)
        return loc

    @staticmethod
    def _cancel_encodes(enc_futs: dict) -> None:
        """Best-effort cancel of encode-ahead futures a failed pipeline will
        never consume: queued codec jobs are dropped before device work
        (the service's running-handshake makes this race-free); running
        ones finish and are discarded — waste bounded by encode_ahead."""
        for f in enc_futs.values():
            f.cancel()
        enc_futs.clear()

    def _encode_blob(self, t, blob: bytes):
        """Submit one blob to the codec service; returns the stripe future.
        One composed-matrix device pass yields global AND local parity."""
        shard_len = t.shard_size(len(blob))
        mat = np.zeros((t.N, shard_len), np.uint8)
        flat = mat.reshape(-1)
        flat[: len(blob)] = np.frombuffer(blob, np.uint8)
        return self.codec.encode_tactic(t, mat)

    def _write_blob(self, t, mode: int, vol: VolumeInfo, bid: int,
                    stripe: np.ndarray) -> VolumeInfo:
        """Stripe write with the full-volume rotation retry; returns the
        volume the blob actually landed on. The grant set rotates across
        active_vols volumes that fill in LOCKSTEP, so a re-alloc after
        retiring one full volume may hand back one of its equally-full
        siblings — allow one rotation per granted volume before a fresh
        replacement is guaranteed; the final attempt propagates."""
        rotations = getattr(self.proxy, "active_vols", 1) + 1
        for _ in range(rotations):
            try:
                self._write_stripe(t, vol, bid, stripe)
                return vol
            except VolumeFullError:
                # rotate: retire the full volume, take another, retry
                self.cm.set_volume_status(vol.vid, "idle")
                self.proxy.invalidate(mode)
                vol = self._alloc_breaker.call(self.proxy.alloc_volume, mode)
        self._write_stripe(t, vol, bid, stripe)
        return vol

    def _put_serial(self, t, mode: int, blobs: list[bytes],
                    first_bid: int) -> list[Blob]:
        """Pre-pipeline path (pipeline_window=0 or single blob): encode all
        blobs first (they batch inside the codec service), then fan shard
        writes out per blob, one blob at a time."""
        from chubaofs_tpu_torch.blobstore import trace

        span = trace.current_span()
        futures = []
        metas = []
        for i, blob in enumerate(blobs):
            t_alloc = time.perf_counter()
            vol = self._alloc_breaker.call(self.proxy.alloc_volume, mode)
            if span is not None:
                span.append_track_log("proxy", start=t_alloc)
                span.add_stage("alloc", start=t_alloc)
            futures.append(self._encode_blob(t, blob))
            metas.append((first_bid + i, vol, len(blob)))

        out = []
        for fut, (bid, vol, size) in zip(futures, metas):
            t_enc = time.perf_counter()
            stripe = fut.result()  # (total, shard_len), locals included
            if span is not None:
                span.append_track_log("codec", start=t_enc)
                # wait-for-stripe: codec queue + device batch, as the PUT
                # experiences it (the codec side adds its own host/device
                # sub-stages to the same span)
                span.add_stage("encode", start=t_enc)
            vol = self._write_blob(t, mode, vol, bid, stripe)
            out.append(Blob(bid=bid, vid=vol.vid, size=size))
        return out

    def _put_pipelined(self, t, mode: int, blobs: list[bytes], first_bid: int,
                       window: int) -> list[Blob]:
        """Windowed encode->write pipeline (the tentpole): volume alloc and
        encode submission for blob i+1..i+W overlap blob i's shard fan-out,
        with at most `window` stripes in flight — so the codec never starves
        waiting on the network and the network never idles waiting on the
        codec. Blob order in the returned list is bid order regardless of
        completion order. A quorum failure aborts the window cleanly: stages
        not yet started are skipped (no orphaned writes, no repair-queue spam
        for blobs the client will never see), in-flight ones finish, and the
        first failing blob's error is raised."""
        from chubaofs_tpu_torch.blobstore import trace

        span = trace.current_span()
        if span is not None:  # pipeline shape rides the span record
            span.set_tag("pipeline_window", window)
            span.set_tag("encode_ahead", self.encode_ahead)
        reg = registry("access")
        occ = reg.summary("put_pipeline_occupancy", buckets=BATCH_BUCKETS)
        abort = threading.Event()
        vols: list[VolumeInfo | None] = [None] * len(blobs)
        write_secs = [0.0] * len(blobs)

        def stage(i: int, enc_fut, vol: VolumeInfo, bid: int):
            if abort.is_set():
                raise _PipelineAborted()
            # the request span follows the stage onto the pipe worker so
            # codec/blobnode track entries keep landing on the PUT's trace
            if span is not None:
                trace.push_span(span)
            try:
                t_enc = time.perf_counter()
                stripe = enc_fut.result()
                if span is not None:
                    span.append_track_log("codec", start=t_enc)
                    # encode-ahead wait as THIS stage saw it (queue depth
                    # already bought most of it during older blobs' writes)
                    span.add_stage("encode", start=t_enc)
                if abort.is_set():
                    raise _PipelineAborted()
                t_w = time.perf_counter()
                vols[i] = self._write_blob(t, mode, vol, bid, stripe)
                write_secs[i] = time.perf_counter() - t_w
            except _PipelineAborted:
                raise
            except BaseException:
                abort.set()
                raise
            finally:
                if span is not None:
                    trace.pop_span()

        inflight: deque = deque()  # (blob index, stage future)
        first_err: tuple[int, Exception] | None = None

        def reap_oldest():
            nonlocal first_err
            i, f = inflight.popleft()
            try:
                f.result()
            except _PipelineAborted:
                pass
            except Exception as e:
                if first_err is None or i < first_err[0]:
                    first_err = (i, e)

        t_wall = time.perf_counter()
        # encodes run AHEAD of the write window (bounded by encode_ahead):
        # the codec service still gathers full device batches — submitting
        # encodes window-at-a-time would cap every batch at 2-4 jobs — while
        # blob i's stripe is on the wire and blob i+1..i+W's stages drain
        enc_futs: dict[int, object] = {}
        next_enc = 0

        def encode_up_to(limit: int):
            nonlocal next_enc
            while next_enc < min(limit, len(blobs)):
                enc_futs[next_enc] = self._encode_blob(t, blobs[next_enc])
                next_enc += 1

        ahead = max(window, self.encode_ahead)
        try:
            for i, blob in enumerate(blobs):
                while len(inflight) >= window:
                    reap_oldest()
                if abort.is_set():
                    break
                encode_up_to(i + ahead)
                # alloc for blob i rides the caller thread while blob i-1's
                # (and older, up to the window) fan-outs are still in flight
                t_alloc = time.perf_counter()
                vol = self._alloc_breaker.call(self.proxy.alloc_volume, mode)
                if span is not None:
                    span.append_track_log("proxy", start=t_alloc)
                    span.add_stage("alloc", start=t_alloc)
                inflight.append(
                    (i, self._pipe_pool.submit(stage, i, enc_futs.pop(i), vol,
                                               first_bid + i)))
                occ.observe(len(inflight))
        except BaseException:
            # a CALLER-side failure mid-window (alloc breaker open, cluster
            # can't place a volume) must honor the same abort contract as a
            # stage failure: stop unstarted stages, drain in-flight ones —
            # never leave workers writing blobs the client will not see.
            # A stage error collected while draining is the root cause (it
            # likely tripped the breaker the caller then hit) and wins.
            abort.set()
            while inflight:
                reap_oldest()
            self._cancel_encodes(enc_futs)
            if first_err is not None:
                raise first_err[1]
            raise
        while inflight:
            reap_oldest()
        if first_err is not None or abort.is_set():
            self._cancel_encodes(enc_futs)
        if first_err is not None:
            raise first_err[1]
        if abort.is_set() or any(v is None for v in vols):
            raise AccessError("put pipeline aborted")  # defensive: unreachable
        # realized overlap: sum of per-stripe write times over the wall clock
        # of the whole pipelined phase — >1.0 means stripes actually
        # overlapped on the wire, ~1.0 means the window degenerated to serial
        wall = time.perf_counter() - t_wall
        busy = sum(write_secs)
        if wall > 0 and busy > 0:
            reg.summary("put_overlap_ratio",
                        buckets=BATCH_BUCKETS).observe(busy / wall)
        reg.counter("put_pipeline_blobs").add(len(blobs))
        return [Blob(bid=first_bid + i, vid=vols[i].vid, size=len(b))
                for i, b in enumerate(blobs)]

    def _write_stripe(self, t, vol: VolumeInfo, bid: int, stripe: np.ndarray):
        from chubaofs_tpu_torch.blobstore import trace
        from chubaofs_tpu_torch.blobstore.blobnode import ChunkFull

        # the stripe-write fan-out is the blobnode hop as the gateway sees
        # it; one track entry covers the whole shard fan-out (stream_put.go
        # logs the same aggregate)
        span = trace.current_span()
        t_hop = time.perf_counter()
        deadline = time.monotonic() + self.write_deadline
        started = [False] * t.total

        def write_one(idx: int):
            started[idx] = True
            unit = vol.units[idx]
            if self._is_punished(unit.disk_id):
                raise DiskPunished(f"disk {unit.disk_id} punished")
            node = self.nodes[unit.node_id]
            sem = self._sem(unit.disk_id)
            budget = deadline - time.monotonic()
            if budget <= 0 or not sem.acquire(timeout=budget):
                # concurrency cap exhausted within the deadline: the disk is
                # wedged — punish it so later PUTs fail fast
                self.punish_disk(unit.disk_id, "cap_exhausted")
                raise DiskPunished(f"disk {unit.disk_id} at concurrency cap")
            try:
                chaos.failpoint("access.write_shard", node=unit.node_id)
                node.create_vuid(unit.vuid, unit.disk_id)
                node.put_shard(unit.vuid, bid, stripe[idx].tobytes())
            except ChunkFull:
                raise  # full != broken: rotate the volume, don't punish
            except Exception:
                self.punish_disk(unit.disk_id, "error")
                raise
            finally:
                sem.release()
            return idx

        futs = [self._pool.submit(self._try, write_one, i) for i in range(t.total)]
        results = []
        for idx, f in enumerate(futs):
            budget = deadline + 0.25 - time.monotonic()  # workers self-deadline
            try:
                results.append(f.result(timeout=max(0.01, budget)))
            except FutureTimeout:
                # a RUNNING write that outlives the deadline is the wedged-disk
                # signal (stream_put.go:343-346 punishDiskWith on timeout); a
                # task still queued behind a busy pool says nothing about its
                # disk — punishing it would blacklist healthy devices
                if started[idx]:
                    self.punish_disk(vol.units[idx].disk_id, "timeout")
                results.append(TimeoutError("stripe write deadline"))
        if span is not None:
            span.append_track_log("blobnode", start=t_hop)
            span.add_stage("write", start=t_hop)  # whole shard fan-out
        ok = {i for i, r in zip(range(t.total), results) if r is None}
        failed = sorted(set(range(t.total)) - ok)
        # quorum counts global-stripe shards only (stream_put.go:226,362:
        # maxWrittenIndex = N+M — local parities never satisfy the quorum)
        written = len([i for i in ok if i < t.global_count])
        if written < t.put_quorum and not self._one_dark_az(t, ok):
            if any(isinstance(r, ChunkFull) for r in results):
                raise VolumeFullError(f"volume {vol.vid} chunks full")
            raise QuorumError(
                f"wrote {written}/{t.global_count} global shards, quorum "
                f"{t.put_quorum}; failures: {failed}"
            )
        if failed:
            # queue missing shards for background repair (stream_put.go:377-397)
            self.proxy.send_shard_repair(vol.vid, bid, failed, "put_failed")

    @staticmethod
    def _one_dark_az(t, ok: set[int]) -> bool:
        """Tolerate exactly one fully-dark AZ at >=3 AZs, iff every other AZ is
        fully written (stream_put.go:405-437)."""
        if t.az_count < 3:
            return False
        all_fine = all_down = 0
        for az in range(t.az_count):
            idx = t.shards_in_az(az)
            wrote = sum(1 for i in idx if i in ok)
            if wrote == len(idx):
                all_fine += 1
            if wrote == 0:
                all_down += 1
        return all_fine == t.az_count - 1 and all_down == 1

    @staticmethod
    def _try(fn, *args):
        try:
            fn(*args)
            return None
        except Exception as e:
            return e

    # -- GET -----------------------------------------------------------------

    def get(self, loc: Location | str, offset: int = 0, size: int | None = None) -> bytes:
        from chubaofs_tpu_torch.blobstore import trace

        if isinstance(loc, str):
            loc = Location.from_json(loc)
        if self.qos is not None:
            # charge the real read size: a default full-object get is loc.size
            want = size if size is not None else max(0, loc.size - offset)
            if not self.qos.wait("get", max(1, want), timeout=self.qos_timeout):
                registry("access").counter("qos_reject", {"op": "get"}).add()
                raise AccessError("get bandwidth limit exceeded")
        with trace.child_of(trace.current_span(), "access.get") as span, \
                registry("access").tp("get"):
            err: Exception | None = None
            try:
                return self._get(loc, offset, size)
            except Exception as e:
                err = e
                raise
            finally:
                span.append_track_log("access", err=err)
                record_slow_op("access", "get",
                               time.perf_counter() - span.start, span=span,
                               err=type(err).__name__ if err else "")

    def _get(self, loc: Location | str, offset: int = 0, size: int | None = None) -> bytes:
        from chubaofs_tpu_torch.blobstore import trace

        span = trace.current_span()
        t_prep = time.perf_counter()
        if isinstance(loc, str):
            loc = Location.from_json(loc)
        self._check_sig(loc)
        if size is None:
            size = loc.size - offset
        if offset < 0 or size < 0 or offset + size > loc.size:
            raise AccessError(f"range [{offset}, {offset+size}) outside object of {loc.size}")
        # read-amp ledger (window bytes the CALLER asked for; the shard
        # reads below count what the backend actually moved for them —
        # cfs-top's RDAMP column is the window ratio of the two)
        registry("access").counter(
            "read_bytes", {"kind": "requested"}).add(size)

        segs = []  # (blob, intra-blob offset, length) the range touches
        pos = 0
        for blob in loc.blobs:
            blob_start, blob_end = pos, pos + blob.size
            pos = blob_end
            if blob_end <= offset or blob_start >= offset + size:
                continue
            lo = max(0, offset - blob_start)
            hi = min(blob.size, offset + size - blob_start)
            segs.append((blob, lo, hi - lo))
        if span is not None:  # location parse + sig check + range plan
            span.add_stage("prepare", start=t_prep)
        window = int(self.pipeline_window)
        if len(segs) > 1 and window >= 1:
            return self._get_readahead(loc.code_mode, segs, window)
        if len(segs) == 1:  # whole-blob/single-blob GET: no reassembly copy
            blob, lo, n = segs[0]
            return self._read_blob(loc.code_mode, blob, lo, n)
        out = bytearray()
        for blob, lo, n in segs:
            out += self._read_blob(loc.code_mode, blob, lo, n)
        return bytes(out)

    def _get_readahead(self, mode: int, segs: list, window: int) -> bytes:
        """Multi-blob ranged GET with readahead: the next blobs' shard
        gathers are prefetched on the pipe pool (their shard reads still ride
        the read pool) while the current blob's bytes are consumed, bounded
        by the same pipeline window as PUT. Byte order is segment order —
        results are consumed strictly FIFO however the gathers complete."""
        from chubaofs_tpu_torch.blobstore import trace

        span = trace.current_span()
        reg = registry("access")
        occ = reg.summary("get_readahead_occupancy", buckets=BATCH_BUCKETS)

        def gather(blob, lo, n):
            if span is not None:
                trace.push_span(span)
            try:
                return self._read_blob(mode, blob, lo, n)
            finally:
                if span is not None:
                    trace.pop_span()

        q: deque = deque()
        nxt = 0
        out = bytearray()
        try:
            while q or nxt < len(segs):
                while nxt < len(segs) and len(q) < window:
                    q.append(self._pipe_pool.submit(gather, *segs[nxt]))
                    if nxt > 0:  # segment 0 is the current read, not readahead
                        reg.counter("get_readahead_prefetch").add()
                    nxt += 1
                occ.observe(len(q))
                out += q.popleft().result()
        except BaseException:
            for f in q:  # queued prefetches must not run for a dead request
                f.cancel()
            raise
        return bytes(out)

    def _read_blob(self, mode: int, blob: Blob, offset: int, size: int) -> bytes:
        """Tiered read: cache -> hot Replica3 copy -> EC cold path. Every
        lookup feeds the cache's heat accounting; blobs that cross the
        promote threshold are reported to the hot-blob topic, where the
        scheduler's tier sweep copies them into the replica engine."""
        cache = self.cache
        fill_ver = None
        f_lo, f_len = offset, size
        if cache is not None:
            cached = cache.get(blob.vid, blob.bid, offset, size)
            if cache.promote_signal(blob.vid, blob.bid):
                try:
                    self.proxy.send_blob_hot(blob.vid, blob.bid, blob.size)
                except Exception:
                    pass  # advisory: lost heat re-accumulates next epoch
            if cached is not None and len(cached) == size:
                return bytes(cached)
            # version captured BEFORE the backend read: a DELETE racing
            # this miss invalidates the version and the fill is dropped.
            # The backend window is rounded OUT to cache-block boundaries
            # (clipped to the blob) so a ranged miss fills exactly the
            # blocks it touches — the next overlapping range hits.
            fill_ver = cache.fill_version(blob.vid, blob.bid)
            blk = cache.block
            f_lo = (offset // blk) * blk
            f_len = min(blob.size,
                        ((offset + size + blk - 1) // blk) * blk) - f_lo
        hot = self.cm.hot_location(blob.vid, blob.bid)
        if hot is not None:
            data = self._read_blob_hot(hot, f_lo, f_len)
            if data is not None:
                if fill_ver is not None:
                    cache.fill(blob.vid, blob.bid, fill_ver, data,
                               offset=f_lo, total=blob.size)
                return (data if f_len == size
                        else data[offset - f_lo: offset - f_lo + size])
        data = self._read_blob_ec(mode, blob, f_lo, f_len)
        if fill_ver is not None:
            cache.fill(blob.vid, blob.bid, fill_ver, data,
                       offset=f_lo, total=blob.size)
        return (data if f_len == size
                else data[offset - f_lo: offset - f_lo + size])

    def _read_blob_hot(self, hot: tuple[int, int], offset: int,
                       size: int) -> bytes | None:
        """One direct read of the Replica3 copy's data shard (shard 0 IS the
        blob bytes — systematic RS(1,2), exact-size shards). Any failure
        falls back to the authoritative EC copy: the hot tier accelerates,
        it never gates availability."""
        hot_vid, hot_bid = hot
        reg = registry("cache")
        try:
            vol = self.cm.get_volume(hot_vid)
            unit = vol.units[0]
            node = self.nodes.get(unit.node_id)
            if node is None:
                raise ConnectionError(f"hot node {unit.node_id} unknown")
            chaos.failpoint("access.read_shard", node=unit.node_id)
            data = node.get_shard(unit.vuid, hot_bid, offset=offset, size=size)
            if len(data) != size:
                raise AccessError("short hot read")
        except Exception:
            reg.counter("tier_fallbacks").add()
            return None
        reg.counter("tier_hits").add()
        registry("access").counter(
            "read_bytes", {"kind": "shards_read"}).add(size)
        return bytes(data)

    def _read_blob_ec(self, mode: int, blob: Blob, offset: int, size: int) -> bytes:
        t = get_tactic(mode)
        vol = self.cm.get_volume(blob.vid)
        shard_len = t.shard_size(blob.size)

        # fast path: ranged sub-shard reads of only the data shards the byte
        # range touches (blobnode serves CRC-framed sub-ranges natively),
        # issued CONCURRENTLY — a full-stripe GET pays one shard's latency,
        # not N of them (stream_get.go fans reads out the same way)
        first_shard = offset // shard_len
        last_shard = (offset + size - 1) // shard_len

        def read_one(idx: int):
            lo = max(offset, idx * shard_len) - idx * shard_len
            hi = min(offset + size, (idx + 1) * shard_len) - idx * shard_len
            return self._read_shard(vol, idx, blob.bid, lo, hi - lo)

        # every direct read races a deadline: a shard that cannot answer in
        # read_deadline (wedged node/disk) is treated as missing and the
        # degraded path reconstructs around it — the stall is bounded even
        # when the node never errors (stream_get races laggards the same way)
        from chubaofs_tpu_torch.blobstore import trace

        span = trace.current_span()
        t_hop = time.perf_counter()
        idxs = list(range(first_shard, last_shard + 1))
        pieces = []
        slow: set[int] = set()  # timed out, node possibly wedged
        reads = _ReadWaits(self._read_pool)
        futs = reads.submit(read_one, [(i,) for i in idxs])
        deadline = time.monotonic() + self.read_deadline
        for i, f in zip(idxs, futs):
            try:
                pieces.append(f.result(timeout=max(0.0, deadline - time.monotonic())))
            except FutureTimeout:
                pieces.append(None)
                slow.add(i)
        reads.close()
        if span is not None:
            span.append_track_log("blobnode", start=t_hop)
        if all(p is not None for p in pieces):
            data = b"".join(pieces)
            if span is not None:  # fan-out + reassembly: the read stage
                span.add_stage("read", start=t_hop)
            return data
        if span is not None:
            span.add_stage("read", start=t_hop)  # the failed direct attempt
        for f in futs:  # queued laggards must not hold pool workers
            f.cancel()
        # hand the degraded path everything the direct phase learned: the
        # sub-range bytes it DID read (reused verbatim — never refetched),
        # the shards that errored (excluded from the survivor gather), and
        # the ones that hung (deprioritized, probed asynchronously)
        have = {i: p for i, p in zip(idxs, pieces) if p is not None}
        failed_direct = {i for i, p in zip(idxs, pieces)
                         if p is None and i not in slow}
        return self._read_blob_degraded(t, vol, blob, shard_len, offset, size,
                                        have=have, failed=failed_direct,
                                        deprioritize=slow)

    def _recover_locals_inplace(self, t, vol, blob, stripe, present: list,
                                shard_len: int,
                                deadline: float | None = None) -> None:
        """Repair missing GLOBAL shards via their AZ-local stripes, updating
        stripe/present in place. Each AZ is independent: damage within an
        AZ's local-parity budget is fixed reading ONLY that AZ's shards.
        `deadline` (monotonic) bounds the parity fetches: this runs on the
        latency-critical degraded path, so a wedged local-parity holder is
        abandoned like any other straggler, never waited out."""
        pres = set(present)
        for idx_list, local_n, local_m in t.local_stripes():
            globals_in_az = [g for g in idx_list if g < t.N + t.M]
            recoverable = [g for g in globals_in_az if g not in pres]
            if not recoverable:
                continue  # nothing this AZ's stripe could win back
            locals_in_az = [g for g in idx_list if g >= t.N + t.M]
            az_reads: dict[int, np.ndarray] = {
                g: stripe[g] for g in globals_in_az if g in pres
            }
            reads = _ReadWaits(self._read_pool)
            futs = reads.submit(self._read_shard,
                                [(vol, g, blob.bid, 0, shard_len) for g in locals_in_az])
            for g, fut in zip(locals_in_az, futs):
                budget = (max(0.0, deadline - time.monotonic())
                          if deadline is not None else None)
                try:
                    data = fut.result(timeout=budget)
                except FutureTimeout:
                    fut.cancel()
                    continue
                if data is not None:
                    az_reads[g] = np.frombuffer(data, np.uint8)
            reads.close()
            az_bad = [g for g in idx_list if g not in az_reads]
            if len(az_bad) > local_m:
                continue
            sub = np.zeros((len(idx_list), shard_len), np.uint8)
            pos = {g: p for p, g in enumerate(idx_list)}
            for g, d in az_reads.items():
                sub[pos[g]] = d
            fixed = self.codec.reconstruct(
                local_n, local_m, sub, [pos[g] for g in az_bad]
            ).result()
            for g in recoverable:
                stripe[g] = fixed[pos[g]]
                present.append(g)

    def _read_shard(
        self, vol: VolumeInfo, idx: int, bid: int, offset: int, size: int,
        count: bool = True,
    ) -> bytes | None:
        from chubaofs_tpu_torch.blobstore.blobnode import classify_io_error

        unit = vol.units[idx]
        node = self.nodes.get(unit.node_id)
        if node is None:
            registry("access").counter(
                "read_fail", {"reason": "no_node"}).add()
            return None
        try:
            chaos.failpoint("access.read_shard", node=unit.node_id)
            data = node.get_shard(unit.vuid, bid, offset=offset, size=size)
            if len(data) != size:
                registry("access").counter(
                    "read_fail", {"reason": "short"}).add()
                return None
            if count:
                # count=False for background probes: read_amp measures bytes
                # moved ON BEHALF OF the GET window, not repair-plane sweeps
                registry("access").counter(
                    "read_bytes", {"kind": "shards_read"}).add(size)
            return data
        except Exception as e:
            # the caller's contract stays None-on-failure (degraded path
            # reconstructs around it) but the CLASS of failure is no longer
            # discarded: a fleet of {timeout}s and a fleet of {error}s need
            # different pages (same taxonomy as scheduler probe_fail)
            registry("access").counter(
                "read_fail", {"reason": classify_io_error(e)}).add()
            return None

    def _read_blob_degraded(self, t, vol, blob, shard_len, offset, size,
                            have: dict[int, bytes] | None = None,
                            failed: set[int] | None = None,
                            deprioritize: set[int] | None = None) -> bytes:
        """Degraded read, range-scoped first: reconstruct ONLY the in-window
        shards the direct phase could not serve, from a survivor gather over
        just the window's byte columns (row-sliced decode matrix — decode
        cost scales with the window, not the stripe). Deep damage — the
        global stripe can't reach N survivors, so AZ-local parities are
        needed — falls back to the full-stripe gather, which itself launches
        only the survivors it selects (never the old `read_hedge`-deep
        speculative parity fan-out). Read-only: durable healing stays with
        the repair plane via the shard-repair topic."""
        have = dict(have or {})
        slow = set(deprioritize or ())
        failed = set(failed or ())
        if t.is_regenerating:
            # PM sub-unit layout: a shard-byte window couples to a column
            # range in EVERY one of the survivor's alpha sub-units, which
            # the single-range windowed gather can't express — regenerating
            # stripes take the full-stripe path (any-N decode) directly
            out = None
        else:
            out = self._degraded_window(t, vol, blob, shard_len, offset,
                                        size, have, slow, failed)
        if out is not None:
            return out
        return self._degraded_full(t, vol, blob, shard_len, offset, size,
                                   slow)

    def _gather_survivors(self, vol, bid: int, candidates: list[int],
                          needed: int, lo: int,
                          n: int) -> tuple[dict[int, bytes], list[int]]:
        """Hedged sub-range gather of exactly `needed` shard reads from
        `candidates` (preference order). Only the reads the selection wants
        are ever launched — a FAILED read immediately launches the next
        candidate to keep gather depth, and a read silent past read_deadline
        launches a hedge replacement while the original keeps running (slow-
        but-alive may still answer first) — so unselected candidates (the
        parity tail of the list) are never fetched unless a selected read
        lets the gather down. Returns (idx -> bytes, failed idxs).

        Every read launched to replace another (after a failure, or as a
        hedge after a hang) is counted in `gather_replaced` by cause and
        gives the request's span one `gather.replace` stage, from its launch
        to its answer (to the gather's end, for one abandoned)."""
        from concurrent.futures import FIRST_COMPLETED, wait

        from chubaofs_tpu_torch.blobstore import trace

        got: dict[int, bytes] = {}
        failures: list[int] = []
        if needed <= 0:
            return got, failures
        pending: dict = {}
        launched: dict = {}  # future -> launch time (hang-hedge input)
        hedged: set = set()  # futures already replaced for being slow
        replacing: dict = {}  # replacement future -> perf_counter at launch
        next_i = 0

        span = trace.current_span()
        reads = _ReadWaits(self._read_pool)

        def launch(count: int = 1, cause: str | None = None) -> None:
            """The next `count` candidates' reads, submitted together;
            `cause` names what a replacement read replaces."""
            nonlocal next_i
            idxs = candidates[next_i:next_i + count]
            next_i += len(idxs)
            futs = reads.submit(self._read_shard, [(vol, idx, bid, lo, n) for idx in idxs])
            t_launch = time.perf_counter()
            for idx, f in zip(idxs, futs):
                pending[f] = idx
                launched[f] = time.monotonic()
                if cause is not None:
                    replacing[f] = t_launch
                    registry("access").counter("gather_replaced", {"cause": cause}).add()

        def replaced(fut, t_end: float) -> None:
            t_launch = replacing.pop(fut, None)
            if t_launch is not None and span is not None:
                span.add_stage("gather.replace", start=t_launch, dur=t_end - t_launch)

        launch(min(needed, len(candidates)))
        # overall gather budget: stragglers can be slow-but-alive, so this
        # is the generous write_deadline, not the per-read read_deadline
        gather_deadline = time.monotonic() + self.write_deadline
        while pending and len(got) < needed:
            # wake for the earliest of: gather budget, or the moment an
            # un-hedged in-flight read crosses read_deadline
            now = time.monotonic()
            timeout = gather_deadline - now
            nxt_slow = min((launched[f] + self.read_deadline
                            for f in pending if f not in hedged), default=None)
            if nxt_slow is not None:
                timeout = min(timeout, nxt_slow - now)
            done, _ = wait(pending, return_when=FIRST_COMPLETED,
                           timeout=max(0.0, timeout))
            if not done:
                now = time.monotonic()
                if now >= gather_deadline:
                    break  # budget exhausted: abandon what never answered
                # an in-flight read exceeded read_deadline without FAILING —
                # a hung-but-silent replica. Launch a replacement from the
                # not-yet-tried candidates (the original keeps running), so
                # gather depth holds against hangs exactly as against
                # failures.
                for f in list(pending):
                    if (f in hedged
                            or now - launched[f] < self.read_deadline):
                        continue
                    hedged.add(f)
                    launch(cause="slow")
                continue
            t_done = time.perf_counter()
            for fut in done:
                idx = pending.pop(fut)
                launched.pop(fut, None)
                replaced(fut, t_done)
                was_hedged = fut in hedged  # replacement already launched
                hedged.discard(fut)
                data = fut.result()
                if data is not None:
                    got[idx] = data
                else:
                    failures.append(idx)
                    if not was_hedged:
                        launch(cause="failed")  # keep gather depth
        t_end = time.perf_counter()
        for fut in pending:  # abandon stragglers (queued ones cancel cleanly)
            fut.cancel()
            replaced(fut, t_end)
        reads.close()
        return got, failures

    def _degraded_window(self, t, vol, blob, shard_len, offset, size,
                         have: dict[int, bytes], slow: set[int],
                         failed_direct: set[int]) -> bytes | None:
        """Range-scoped degraded read: decode ONLY the in-window shards the
        direct phase is missing, over only the window's byte columns. RS is
        column-independent, so t.N survivor rows sliced to the SAME columns
        decode the missing rows' slice exactly (RSKernel.window_matrix).
        Returns None when the gather can't reach N global survivors — deep
        damage, which the full-stripe path (with AZ-local recovery) owns."""
        from chubaofs_tpu_torch.blobstore import trace

        span = trace.current_span()
        t_gather = time.perf_counter()
        first = offset // shard_len
        last = (offset + size - 1) // shard_len

        def window_of(idx: int) -> tuple[int, int]:
            lo = max(offset, idx * shard_len) - idx * shard_len
            hi = min(offset + size, (idx + 1) * shard_len) - idx * shard_len
            return lo, hi

        need = [i for i in range(first, last + 1) if i not in have]
        # the union byte-column window the decode must cover
        col_lo = min(window_of(i)[0] for i in need)
        col_hi = max(window_of(i)[1] for i in need)
        width = col_hi - col_lo
        # survivors the direct phase already fetched, column-sliced — only
        # reads fully covering the decode window count (edge shards of the
        # byte range may cover less; those shards just aren't reused)
        reuse: dict[int, bytes] = {}
        for i, data in have.items():
            lo_i, hi_i = window_of(i)
            if lo_i <= col_lo and hi_i >= col_hi:
                reuse[i] = data[col_lo - lo_i: col_hi - lo_i]
        # candidates in preference order: untouched data shards first, then
        # parity; shards that just FAILED are excluded, known-slow go last.
        # The gather fetches exactly the survivors it selects — unselected
        # parity is never read (no speculative parity fan-out).
        candidates = [i for i in range(t.N + t.M)
                      if i not in reuse and i not in failed_direct
                      and i not in need]
        candidates.sort(key=lambda i: (i in slow, i))
        got, gather_failed = self._gather_survivors(
            vol, blob.bid, candidates, t.N - len(reuse), col_lo, width)
        got.update(reuse)
        if span is not None:
            span.add_stage("gather", start=t_gather)  # windowed sub-reads
        if len(got) < t.N:
            return None  # the full path re-proves and reports damage
        present = sorted(got)[: t.N]
        survivors = np.stack(
            [np.frombuffer(got[i], np.uint8) for i in present])
        t_dec = time.perf_counter()
        rows = self.codec.decode_rows(t.N, t.M, present, survivors,
                                      need).result()
        registry("access").counter(
            "read_bytes", {"kind": "decoded"}).add(len(need) * width)
        if span is not None:
            span.add_stage("decode", start=t_dec)  # row-sliced window decode
        # assemble: verbatim direct-phase bytes, decoded rows sliced to each
        # missing shard's own sub-window
        rowpos = {i: p for p, i in enumerate(need)}
        out = bytearray()
        for i in range(first, last + 1):
            if i in have:
                out += have[i]
            else:
                lo_i, hi_i = window_of(i)
                out += rows[rowpos[i],
                            lo_i - col_lo: hi_i - col_lo].tobytes()
        # the repair plane must hear what this read PROVED damaged; shards
        # it never touched are probed asynchronously (off the latency path)
        # so ranged reads don't narrow get_miss-driven healing
        damaged = sorted(failed_direct | set(gather_failed))
        self.proxy.send_shard_repair(vol.vid, blob.bid, damaged, "get_miss")
        touched = set(got) | set(have) | set(damaged)
        self._probe_unread(t, vol, blob, shard_len,
                           [i for i in range(t.N + t.M) if i not in touched])
        return bytes(out)

    def _degraded_full(self, t, vol, blob, shard_len, offset, size,
                       slow: set[int]) -> bytes:
        """Full-stripe degraded gather (stream_get.go:427 ReconstructData
        fallback) — the deep-damage path: whole shards are read because
        AZ-local stripes repair whole shards. The gather still launches only
        the t.N survivors it selects (failure replacement + hang-hedge per
        read); parity beyond the selection stays unread. When the global
        stripe alone can't reach N and the mode carries local parities,
        AZ-local stripes are tried next (work_shard_recover.go:517
        recoverByLocalStripe applied at READ time)."""
        from chubaofs_tpu_torch.blobstore import trace

        span = trace.current_span()
        t_gather = time.perf_counter()
        total = t.N + t.M
        # data shards first (they skip the matmul); known-wedged ones last
        order = sorted(range(total), key=lambda i: (i in slow, i))
        gather_deadline = time.monotonic() + self.write_deadline
        got, failed = self._gather_survivors(vol, blob.bid, order, t.N,
                                             0, shard_len)
        stripe = np.zeros((total, shard_len), np.uint8)
        present: list[int] = []
        for i, data in got.items():
            stripe[i] = np.frombuffer(data, np.uint8)
            present.append(i)
        if span is not None:
            span.add_stage("gather", start=t_gather)  # hedged stripe reads
        # the repair plane must hear about everything the gather PROVED
        # damaged — including shards the local-stripe pass then fixes only
        # in memory (they are still broken on disk). Shards the hedge never
        # reached are probed ASYNCHRONOUSLY (off the latency path), so
        # hedging does not narrow get_miss-driven healing vs a full gather.
        damaged = sorted(failed)
        if len(present) < t.N and getattr(t, "L", 0):
            self._recover_locals_inplace(t, vol, blob, stripe, present,
                                         shard_len, deadline=gather_deadline)
        missing = [i for i in range(t.N + t.M) if i not in present]
        if len(present) < t.N:
            raise AccessError(
                f"blob {blob.bid}: only {len(present)} shards readable, need {t.N}"
            )
        t_dec = time.perf_counter()
        fixed = self.codec.reconstruct_tactic(
            t, stripe, missing, data_only=True).result()
        registry("access").counter("read_bytes", {"kind": "decoded"}).add(
            sum(shard_len for i in missing if i < t.N))
        if span is not None:
            span.add_stage("decode", start=t_dec)  # on-the-fly reconstruct
        self.proxy.send_shard_repair(vol.vid, blob.bid, damaged, "get_miss")
        self._probe_unread(t, vol, blob, shard_len,
                           [i for i in range(total)
                            if i not in present and i not in failed])
        data_region = fixed[: t.N].reshape(-1)
        return data_region[offset : offset + size].tobytes()

    def _probe_unread(self, t, vol, blob, shard_len,
                      unprobed: list[int]) -> None:
        """Launch the async integrity probe for shards a degraded read never
        touched. Probes ride their OWN executor (never the PUT/write pool: a
        wedged blobnode would pin write workers and stall unrelated stripe
        writes) and dedupe per (vid, bid): a burst of degraded GETs of one
        hot blob probes it once."""
        if not unprobed:
            return
        key = (vol.vid, blob.bid)
        with self._probe_lock:
            fresh = key not in self._probing
            if fresh:
                self._probing.add(key)
        if fresh:
            self._probe_pool.submit(self._probe_shards, t, vol, blob,
                                    shard_len, unprobed)

    def _probe_shards(self, t, vol, blob, shard_len, idxs: list[int]) -> None:
        """Background integrity probe of shards a hedged gather skipped or
        abandoned: full CRC-framed reads, failures reported to the repair
        plane. Keeps get_miss healing as wide as the old full-stripe gather
        without ever charging the GET's latency. Every read is bounded by
        read_deadline — a wedged node makes the probe REPORT, not hang."""
        try:
            futs = {self._probe_io.submit(
                self._read_shard, vol, i, blob.bid, 0, shard_len, False): i
                for i in idxs}
            bad = []
            for fut, i in futs.items():
                try:
                    data = fut.result(timeout=self.read_deadline)
                except FutureTimeout:
                    if fut.cancel():
                        # never started (probe-pool backlog): its health is
                        # UNKNOWN, not bad — the scrub sweeps cover it; a
                        # repair message here would heal shards nobody read
                        continue
                    data = None  # ran past its deadline: wedged, report it
                if data is None:
                    bad.append(i)
            if bad:
                try:
                    self.proxy.send_shard_repair(vol.vid, blob.bid, bad,
                                                 "get_probe")
                except Exception:
                    pass  # scrub/inspector sweeps remain the durable backstop
        finally:
            with self._probe_lock:
                self._probing.discard((vol.vid, blob.bid))

    # -- DELETE --------------------------------------------------------------

    def delete(self, loc: Location | str) -> None:
        if isinstance(loc, str):
            loc = Location.from_json(loc)
        self._check_sig(loc)
        for blob in loc.blobs:
            # write-through punch-out BEFORE the async delete fans out: once
            # invalidate returns (however long a chaos failpoint stretches
            # it), no cached copy is reachable — so by the time the deleter
            # punches shards, a GET can only see the backend's truth
            if self.cache is not None:
                self.cache.invalidate(blob.vid, blob.bid)
            self.proxy.send_blob_delete(blob.vid, blob.bid)

    def close(self) -> None:
        """Shut down the gateway's worker pools (racelint: unjoined-thread).
        wait=False: a wedged blobnode may pin a write worker up to
        write_deadline, and close() runs on teardown paths (MiniCluster,
        daemon reload) that must not inherit that stall; in-flight futures
        fail on their own deadlines."""
        self._pipe_pool.shutdown(wait=False)
        self._pool.shutdown(wait=False)
        self._read_pool.shutdown(wait=False)
        self._probe_pool.shutdown(wait=False)
        self._probe_io.shutdown(wait=False)
