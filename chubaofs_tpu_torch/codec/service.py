"""CodecService — the batching device sidecar for erasure-coding math.

Reference analog: the access layer encodes each blob inline on the CPU
(stream_put.go:143 `encoder.Encode`) and blobnode workers reconstruct per-task
(work_shard_recover.go:422). On a GPU, per-blob dispatch would waste the card:
each call pays host->device latency and a launch, and one small stripe cannot
fill it. This service batches instead:

  * callers submit encode/repair jobs (numpy matrices) and get futures back;
  * a dispatcher thread drains the queue, groups jobs by (layout, k-bucket),
    pads each shard length up to the bucket, stacks them into one (B, n, k)
    batch in page-locked host memory, copies it to the device, runs ONE
    kernel call (ops/cuda_gf.py), copies the result back and scatters it to
    the futures;
  * shard lengths are bucketed to powers of two (>= 16 KiB), the same buckets
    as the JAX package's service, so both batch identically;
  * the service runs on the device it was built for: CodecService() means
    the CUDA device (and raises without one); device="cpu" runs the same code
    on the host through the plain PyTorch lowering — same numerics, same API.

Batching trades a bounded latency (max_wait_ms) for throughput, exactly like the
reference's proxy-side volume-allocation batching — but for math instead of
metadata.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field

import numpy as np

from chubaofs_tpu_torch.ops import rs
from chubaofs_tpu_torch.utils.locks import SanitizedLock

MIN_BUCKET = 16 * 1024


def bucket_len(k: int) -> int:
    """Round a shard length up to the service's shape bucket."""
    b = MIN_BUCKET
    while b < k:
        b *= 2
    return b


class _ChainFuture(Future):
    """Wrapper future whose cancel() propagates to the upstream codec job,
    so a caller holding only the composed LRC result (encode_tactic) can
    still drop the queued device work (access pipeline aborts)."""

    def __init__(self, upstream: Future):
        super().__init__()
        self._upstream = upstream

    def cancel(self) -> bool:
        self._upstream.cancel()  # best-effort: running jobs finish
        return super().cancel()


@dataclass
class _Job:
    kind: str  # "encode" | "matmul"
    n: int
    m: int
    data: np.ndarray  # (rows, kb) uint8 — PRE-PADDED to the shape bucket
    k: int  # true shard length (result is sliced back to it)
    kb: int  # bucket_len(k), computed at submission
    future: Future = field(default_factory=Future)
    # matmul jobs carry their GF matrix (repair rows x survivors)
    mat: np.ndarray | None = None
    # the SUBMITTER's trace span (if any): the dispatcher attributes its
    # batch's host/device time back onto it as named stages, so a PUT's
    # critical-path report splits encode wait into host-ms vs device-ms
    span: object | None = None


def _pad_to_bucket(data: np.ndarray, k: int, kb: int) -> np.ndarray:
    """Pad (rows, k) up to (rows, kb) on the SUBMITTING thread — the drain
    loop then only stacks, and padding cost parallelizes across callers
    instead of serializing on the dispatcher."""
    if k == kb:
        return np.ascontiguousarray(data, np.uint8)
    out = np.zeros((data.shape[0], kb), np.uint8)
    out[:, :k] = data
    return out


class CodecService:
    """Queue -> padded device batches -> futures. Thread-safe, one device stream."""

    def __init__(self, max_batch: int = 32, max_wait_ms: float = 2.0,
                 mesh=None, device=None):
        """device: where the batches run — None means the CUDA device and
        raises when there is none; "cpu" runs on the host. mesh (the JAX
        package's multi-chip dispatch) is not ported yet and is refused."""
        if mesh is not None:
            raise NotImplementedError(
                "CodecService(mesh=...) is not ported: multi-GPU dispatch is "
                "ROADMAP item A9")
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.device = rs.resolve_device(device)
        self._q: queue.Queue[_Job | None] = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True, name="codec-svc")
        self._started = False
        self._closed = False
        self._lock = SanitizedLock(name="codec.lifecycle")
        # dispatcher observability: how well jobs coalesce into device batches
        # (same counter shape as MultiRaft.drain_stats for the raft drain).
        # The codec role registry (cfs_codec_*) is the primary surface; this
        # dict is the legacy view, mutated only under _stats_lock so readers
        # get consistent snapshots (stats_snapshot).
        self.stats = {"batches": 0, "jobs": 0, "max_batch": 0}
        self._stats_lock = SanitizedLock(name="codec.stats")

    def _ensure_started(self):
        with self._lock:
            if self._closed:
                raise RuntimeError("CodecService is closed")
            if not self._started:
                self._thread.start()
                self._started = True

    # -- public API --------------------------------------------------------

    def encode(self, n: int, m: int, data: np.ndarray) -> Future:
        """data (n, k) uint8 -> Future[(n+m, k) uint8 full stripe]."""
        if data.shape[0] != n:
            raise ValueError(f"want {n} data rows, got {data.shape}")
        k = data.shape[1]
        kb = bucket_len(k)
        job = _Job("encode", n, m, _pad_to_bucket(data, k, kb), k, kb)
        self._submit(job)
        return job.future

    def matmul(self, mat: np.ndarray, data: np.ndarray) -> Future:
        """Generic GF(2^8) matmul job: data (rows, k) uint8 ->
        Future[(mat.shape[0], k) uint8]. The raw entry the regenerating-code
        paths ride: PM parity blocks, beta-repair decodes, and any-k
        fallback decodes are all just content-keyed matrices, so they batch
        on the device exactly like RS repairs."""
        mat = np.ascontiguousarray(mat, np.uint8)
        data = np.asarray(data, np.uint8)
        if data.ndim != 2 or mat.ndim != 2 or data.shape[0] != mat.shape[1]:
            raise ValueError(
                f"matmul shape mismatch: mat {mat.shape} @ data {data.shape}")
        k = data.shape[1]
        kb = bucket_len(k)
        job = _Job("matmul", data.shape[0], mat.shape[0],
                   _pad_to_bucket(data, k, kb), k, kb, mat=mat)
        self._submit(job)
        return job.future

    def encode_tactic(self, t, data: np.ndarray) -> Future:
        """data (N, k) uint8 -> Future[(total, k) full stripe], local parities
        included for LRC tactics — computed in ONE composed-matrix matmul
        (encoder.lrc_parity_matrix), not a second device pass. Regenerating
        tactics run their PM parity block the same way: one matmul over the
        stripe's sub-unit rows."""
        if t.is_regenerating:
            return self._encode_pm(t, data)
        if not t.L:
            return self.encode(t.N, t.M, data)
        from chubaofs_tpu_torch.codec.encoder import lrc_parity_matrix

        if data.shape[0] != t.N:
            raise ValueError(f"want {t.N} data rows, got {data.shape}")
        # snapshot ONCE (explicit copy) and build the result from the same
        # snapshot the job computed parity from — caller-side dtype changes or
        # post-submit mutation must never yield a stripe whose data rows don't
        # match its parity
        data = np.array(data, np.uint8, order="C")
        mat = lrc_parity_matrix(t)
        k = data.shape[1]
        kb = bucket_len(k)
        job = _Job("matmul", t.N, t.M + t.L, _pad_to_bucket(data, k, kb),
                   k, kb, mat=mat)
        self._submit(job)
        out = _ChainFuture(job.future)

        def _finish(f: Future):
            if f.cancelled() or out.cancelled():
                # cancelled upstream (drain handshake dropped the job) or
                # downstream (pipeline abort): nothing to deliver
                return
            try:
                if f.exception():
                    out.set_exception(f.exception())
                else:
                    out.set_result(
                        np.concatenate([data, f.result()], axis=0))
            except InvalidStateError:
                pass  # out.cancel() raced the delivery: outcome discarded

        job.future.add_done_callback(_finish)
        return out

    def _encode_pm(self, t, data: np.ndarray) -> Future:
        """Product-matrix encode: shard rows reshaped (free) to sub-unit
        rows, parity block applied as one matmul, parity rows reshaped back
        to shards. Same snapshot discipline as the LRC path."""
        from chubaofs_tpu_torch.codec import pm

        if data.shape[0] != t.N:
            raise ValueError(f"want {t.N} data rows, got {data.shape}")
        size = data.shape[1]
        if size % t.sub_units:
            raise ValueError(
                f"shard size {size} not a multiple of sub_units={t.sub_units}")
        data = np.array(data, np.uint8, order="C")
        kernel = pm.get_kernel(t.total, t.N)
        f = self.matmul(kernel.parity_mat,
                        data.reshape(t.N * t.sub_units, -1))
        out = _ChainFuture(f)

        def _finish(fut: Future):
            if fut.cancelled() or out.cancelled():
                return
            try:
                if fut.exception():
                    out.set_exception(fut.exception())
                else:
                    parity = fut.result().reshape(t.M, size)
                    out.set_result(np.concatenate([data, parity], axis=0))
            except InvalidStateError:
                pass  # out.cancel() raced the delivery: outcome discarded

        f.add_done_callback(_finish)
        return out

    def reconstruct_tactic(self, t, shards: np.ndarray, bad_idx: list[int],
                           data_only: bool = False) -> Future:
        """Tactic-aware full-stripe rebuild: RS/LRC global stripes use the
        windowed RS repair matrix; regenerating stripes decode from any N
        intact nodes via the PM generator (the multi-loss fallback — the
        single-loss beta-fetch path lives in the scheduler)."""
        if not t.is_regenerating:
            return self.reconstruct(t.N, t.M, shards, bad_idx, data_only)
        from chubaofs_tpu_torch.codec import pm

        kernel = pm.get_kernel(t.total, t.N)
        bad = sorted(set(int(i) for i in bad_idx))
        want = [i for i in bad if i < t.N] if data_only else bad
        if not want:
            f: Future = Future()
            f.set_result(np.array(shards, copy=True))
            return f
        alive = [i for i in range(t.total) if i not in bad]
        if len(alive) < t.N:
            f = Future()
            f.set_exception(ValueError(
                f"{len(bad)} losses > M={t.M} for regenerating stripe"))
            return f
        srv = alive[: t.N]
        mat = kernel.decode_matrix(srv, want)
        shards = np.asarray(shards, np.uint8)
        size = shards.shape[1]
        job_f = self.matmul(
            mat, shards[np.asarray(srv)].reshape(t.N * t.sub_units, -1))
        out_future: Future = Future()

        def _finish(fut: Future):
            if fut.exception():
                out_future.set_exception(fut.exception())
                return
            fixed = np.array(shards, copy=True)
            fixed[np.asarray(want)] = fut.result().reshape(len(want), size)
            out_future.set_result(fixed)

        job_f.add_done_callback(_finish)
        return out_future

    def reconstruct(
        self, n: int, m: int, shards: np.ndarray, bad_idx: list[int], data_only=False
    ) -> Future:
        """shards (n+m, k) with garbage rows at bad_idx -> Future[repaired copy]."""
        kernel = rs.get_kernel(n, m, self.device)
        mat, present, missing = kernel.repair_matrix(list(bad_idx), data_only)
        if not missing:
            f: Future = Future()
            f.set_result(np.array(shards, copy=True))
            return f
        k = shards.shape[1]
        kb = bucket_len(k)
        survivors = _pad_to_bucket(
            np.asarray(shards, np.uint8)[np.asarray(present)], k, kb)
        job = _Job("matmul", n, m, survivors, k, kb, mat=mat)
        self._submit(job)

        out_future: Future = Future()

        def _finish(f: Future):
            if f.exception():
                out_future.set_exception(f.exception())
                return
            rows = f.result()
            fixed = np.array(shards, copy=True)
            fixed[np.asarray(missing)] = rows
            out_future.set_result(fixed)

        job.future.add_done_callback(_finish)
        return out_future

    def decode_rows(self, n: int, m: int, present: list[int],
                    survivors: np.ndarray, want: list[int]) -> Future:
        """Range-scoped degraded decode: survivors (n, w) uint8 — the chosen
        n survivor shards' bytes over just the window's byte columns, row
        order matching `present` — -> Future[(len(want), w) uint8] holding
        ONLY the wanted shard rows over those columns.

        Never materializes the full stripe: the decode matrix is sliced to
        the wanted rows on the host (RSKernel.window_matrix), so the device
        pass is (len(want), n) @ (n, w) — window-sized both ways. Jobs with
        the identical (present, want) pattern batch on the device exactly
        like repairs (content-keyed matrix signature).
        """
        kernel = rs.get_kernel(n, m, self.device)
        mat = kernel.window_matrix(present, want)
        survivors = np.asarray(survivors, np.uint8)
        if survivors.ndim != 2 or survivors.shape[0] != n:
            raise ValueError(
                f"want ({n}, w) survivors, got {survivors.shape}")
        k = survivors.shape[1]
        kb = bucket_len(k)
        job = _Job("matmul", n, m, _pad_to_bucket(survivors, k, kb),
                   k, kb, mat=mat)
        self._submit(job)
        return job.future

    def close(self):
        """Idempotent shutdown; jobs enqueued after close() fail fast, jobs
        still queued when the sentinel lands get an exception (never a hang)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            started = self._started
        if started:
            self._q.put(None)
            self._thread.join(timeout=5)

    # -- dispatcher --------------------------------------------------------

    def _submit(self, job: _Job):
        from chubaofs_tpu_torch.blobstore import trace

        job.span = trace.current_span()
        self._ensure_started()
        self._q.put(job)

    def _drain(self) -> list[_Job]:
        try:
            first = self._q.get(timeout=0.2)
        except queue.Empty:
            return []
        if first is None:
            raise StopIteration
        batch = [first]
        deadline = self.max_wait
        import time

        t0 = time.monotonic()
        while len(batch) < self.max_batch:
            remaining = deadline - (time.monotonic() - t0)
            try:
                job = self._q.get(timeout=max(0.0, remaining))
            except queue.Empty:
                break
            if job is None:
                self._q.put(None)  # re-post sentinel for the outer loop
                break
            batch.append(job)
        return batch

    def _run(self):
        while True:
            try:
                batch = self._drain()
            except StopIteration:
                # fail anything still queued so no caller blocks forever
                while True:
                    try:
                        job = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if job is not None and not job.future.done():
                        job.future.set_exception(RuntimeError("CodecService closed"))
                return
            if not batch:
                continue
            # honor caller-side cancellation (pipeline aborts drop their
            # encode-ahead jobs): a cancelled job is skipped before any
            # device work, and the running-handshake means a later cancel()
            # fails cleanly instead of racing set_result
            batch = [j for j in batch
                     if j.future.set_running_or_notify_cancel()]
            if not batch:
                continue
            # group by compatible shape signature (kb was bucketed at
            # submission; the drain loop never re-derives shapes)
            groups: dict[tuple, list[_Job]] = {}
            for j in batch:
                if j.kind == "encode":
                    sig = ("encode", j.n, j.m, j.kb)
                else:
                    # matrices are tiny (<= 36x36): key by CONTENT so only jobs
                    # with the identical repair matrix share a batch
                    sig = ("matmul", j.mat.tobytes(), j.data.shape[0], j.kb)
                groups.setdefault(sig, []).append(j)
            for sig, jobs in groups.items():
                try:
                    self._run_group(sig, jobs)
                except Exception as e:  # propagate to every waiter
                    for j in jobs:
                        if not j.future.done():
                            j.future.set_exception(e)

    def stats_snapshot(self) -> dict:
        """Consistent copy of the legacy counters (no torn reads)."""
        with self._stats_lock:
            return dict(self.stats)

    def _record_batch(self, jobs: int, elapsed_s: float,
                      kind: str = "") -> None:
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["jobs"] += jobs
            self.stats["max_batch"] = max(self.stats["max_batch"], jobs)
        from chubaofs_tpu_torch.utils.exporter import BATCH_BUCKETS, registry

        reg = registry("codec")
        reg.counter("batches_total").add()
        reg.counter("jobs_total").add(jobs)
        if kind:
            # the encode/matmul split: proves repair DECODE really batches
            # on the device (bench_repair and the kill soak read this)
            reg.counter("kind_jobs_total", {"kind": kind}).add(jobs)
            reg.counter("kind_batches_total", {"kind": kind}).add()
        reg.summary("batch_jobs", buckets=BATCH_BUCKETS).observe(jobs)
        reg.summary("dispatch_seconds").observe(elapsed_s)

    def _run_group(self, sig: tuple, jobs: list[_Job]):
        import time as _time

        t0 = _time.perf_counter()
        # jobs arrive pre-padded to the bucket: stacking into the (pinned,
        # on a GPU) host staging buffer is the whole host job here
        first = jobs[0].data
        buf = rs.host_buffer((len(jobs), *first.shape), self.device)
        stack = buf.numpy()
        np.stack([j.data for j in jobs], out=stack)
        t_dev = _time.perf_counter()
        # H2D copy, one kernel launch, D2H copy (rs.gf_matmul_hostbatch)
        if sig[0] == "encode":
            kernel = rs.get_kernel(jobs[0].n, jobs[0].m, self.device)
            parity = rs.gf_matmul_hostbatch(kernel.parity_bits, buf, self.device)
            out = np.concatenate([stack, parity], axis=1)  # (B, n+m, kb)
        else:
            from chubaofs_tpu_torch.ops import bitmatrix

            out = rs.gf_matmul_hostbatch(
                bitmatrix.expand_matrix(jobs[0].mat).astype(np.int8), buf,
                self.device)
        t_done = _time.perf_counter()
        self._record_batch(len(jobs), t_done - t0, kind=str(sig[0]))
        for j in jobs:
            if j.span is not None:
                # the BATCH's wall intervals, attributed to every rider: the
                # job was on the host/device during exactly these windows
                # (shared across the batch — sums can exceed device seconds,
                # wall-clock union cannot)
                j.span.add_stage("codec.host", start=t0, dur=t_dev - t0)
                j.span.add_stage("codec.device", start=t_dev,
                                 dur=t_done - t_dev)
        for i, j in enumerate(jobs):
            j.future.set_result(out[i, :, : j.k])


_default: CodecService | None = None
_default_lock = SanitizedLock(name="codec.default")


def default_service() -> CodecService:
    """The process-wide service, on the CUDA device (raises without one)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = CodecService()
        return _default
