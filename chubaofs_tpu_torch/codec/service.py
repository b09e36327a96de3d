"""CodecService — the batching device sidecar for erasure-coding math.

Reference analog: the access layer encodes each blob inline on the CPU
(stream_put.go:143 `encoder.Encode`) and blobnode workers reconstruct per-task
(work_shard_recover.go:422). On a GPU, per-blob dispatch would waste the card:
each call pays host->device latency and a launch, and one small stripe cannot
fill it. This service batches instead:

  * every entry point submits one kind of job — a GF(2^8) matrix, the rows
    it multiplies and a finisher that shapes the product into the entry's
    result — and gets a future back;
  * a dispatcher thread drains the queue, groups jobs by (matrix, rows,
    k-bucket) — shard lengths are padded up to the bucket at submission —
    stacks each group into one (B, n, k) batch in page-locked host memory,
    copies it to the device, runs ONE kernel call (ops/cuda_gf.py), copies
    the result back and scatters it to the futures;
  * shard lengths are bucketed to powers of two (>= 16 KiB), the same buckets
    as the JAX package's service, so both batch identically;
  * the service runs on the device it was built for: CodecService() means
    the CUDA device (and raises without one); device="cpu" runs the same code
    on the host through the plain PyTorch lowering — same numerics, same API.

Batching trades a bounded latency (max_wait_ms) for throughput, exactly like the
reference's proxy-side volume-allocation batching — but for math instead of
metadata.

Each job's time rides its submitter's trace span (trace.current_span() at
submission) as stages on the time.perf_counter clock:

  * `wait.codec`: from submission to the start of the job's batch (the
    queue, and the drain's max_wait_ms coalescing window);
  * the batch's wall, [start, end], given to every job of the batch in two
    stages that meet end to end: `codec.host` (stacking into the staging
    buffer) and `codec.launch`, the rest of the call: the matrix's lowering
    to its bit operand (ops/rs.py bit_operand), the
    host->device copy, the kernel, the device->host copy and the wait for
    the stream on a card; the matmul on the CPU device; the whole fan-out
    with a mesh. The card's own share of it is the profiler's to give: CUDA
    events around a few-microsecond kernel time their own cost, not the
    kernel's.

`wait.codec` is not named `codec.*` on purpose: the repair plane's
download/decode overlap (scheduler.stage_overlap_ratio, the soak's
cfs-trace proof) counts the `codec.` stages as codec work.
"""

from __future__ import annotations

import queue
import threading
import time
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
    """The future every entry returns: cancel() propagates to the upstream
    codec job, so a caller holding only the finished result can still drop
    the queued device work (access pipeline aborts)."""

    def __init__(self, upstream: Future):
        super().__init__()
        self._upstream = upstream

    def cancel(self) -> bool:
        self._upstream.cancel()  # best-effort: running jobs finish
        return super().cancel()


@dataclass
class _Job:
    kind: str  # "encode" | "matmul": the counters' label, nothing more
    mat: np.ndarray  # (r, rows) GF(2^8) matrix the job's rows are multiplied by
    data: np.ndarray  # (rows, kb) uint8 — PRE-PADDED to the shape bucket
    k: int  # true shard length (result is sliced back to it)
    kb: int  # bucket_len(k), computed at submission
    future: Future = field(default_factory=Future)
    # the SUBMITTER's trace span (if any) and when the job was queued: the
    # dispatcher attributes the job's queue wait and its batch's stages
    # back onto it (module docstring)
    span: object | None = None
    submitted: float = 0.0


def _pad_to_bucket(data: np.ndarray, k: int, kb: int) -> np.ndarray:
    """Pad (rows, k) up to (rows, kb) on the SUBMITTING thread — the drain
    loop then only stacks, and padding cost parallelizes across callers
    instead of serializing on the dispatcher."""
    if k == kb:
        return np.ascontiguousarray(data, np.uint8)
    out = np.zeros((data.shape[0], kb), np.uint8)
    out[:, :k] = data
    return out


def _data_above(parity: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Finisher of an encode: the full stripe, data rows above parity rows."""
    return np.concatenate([data, parity], axis=0)


def _patch(shards, idx: list[int]):
    """Finisher of a rebuild: a copy of `shards` with the product's rows
    written at `idx` (sub-unit rows folded back into shard rows)."""
    def finish(rows: np.ndarray, _) -> np.ndarray:
        fixed = np.array(shards, copy=True)
        fixed[np.asarray(idx)] = rows.reshape(len(idx), -1)
        return fixed
    return finish


class CodecService:
    """Queue -> padded device batches -> futures. Thread-safe; one device
    stream, or each grid device's stream with a mesh."""

    def __init__(self, max_batch: int = 32, max_wait_ms: float = 2.0,
                 mesh=None, device=None, mesh_interpret: bool = False):
        """device: where the batches run — None means the CUDA device and
        raises when there is none; "cpu" runs on the host.
        mesh: optional parallel.mesh.CodecMesh (dp, sp) — drained batches
        then run through parallel.mesh.sharded_gf_matmul instead of the
        single-device path, which takes the whole blobstore data plane
        (access PUT/GET, scheduler bulk repair) onto every device of the
        grid without any caller change. The service's device is then the
        grid's first device. mesh_interpret names B1's plain version on a
        CPU grid (the reference's interpret mode); a CUDA grid refuses it."""
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.mesh = mesh
        self._mesh_mm = None
        if mesh is not None:
            from chubaofs_tpu_torch.parallel.mesh import as_device, sharded_gf_matmul

            first = mesh.devices.flat[0]
            if device is not None and as_device(device) != first:
                raise ValueError(f"device={device} is not the grid's first "
                                 f"device {first}")
            device = first
            self._mesh_mm = sharded_gf_matmul(mesh, interpret=mesh_interpret)
        self.device = rs.resolve_device(device)
        self._q: queue.Queue[_Job | None] = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True, name="codec-svc")
        self._started = False
        self._closed = False
        self._lock = SanitizedLock(name="codec.lifecycle")

    def _ensure_started(self):
        with self._lock:
            if self._closed:
                raise RuntimeError("CodecService is closed")
            if not self._started:
                self._thread.start()
                self._started = True

    # -- public API --------------------------------------------------------
    #
    # Every entry is a (GF matrix, rows, finisher) triple handed to _submit:
    # the device only ever multiplies, and the finisher shapes the product
    # into what the entry returns.

    def encode(self, n: int, m: int, data: np.ndarray) -> Future:
        """data (n, k) uint8 -> Future[(n+m, k) uint8 full stripe]."""
        if data.shape[0] != n:
            raise ValueError(f"want {n} data rows, got {data.shape}")
        gen = rs.get_kernel(n, m, self.device).gen
        return self._submit("encode", gen[n:], data, _data_above)

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
        return self._submit("matmul", mat, data)

    def encode_tactic(self, t, data: np.ndarray) -> Future:
        """data (N, k) uint8 -> Future[(total, k) full stripe], local parities
        included for LRC tactics — computed in ONE composed-matrix matmul
        (encoder.lrc_parity_matrix), not a second device pass. Regenerating
        tactics run their PM parity block the same way: one matmul over the
        stripe's sub-unit rows, the parity rows reshaped back to shards."""
        if not t.is_regenerating and not t.L:
            return self.encode(t.N, t.M, data)
        if data.shape[0] != t.N:
            raise ValueError(f"want {t.N} data rows, got {data.shape}")
        # snapshot ONCE (explicit copy) and build the result from the same
        # snapshot the job computed parity from — caller-side dtype changes or
        # post-submit mutation must never yield a stripe whose data rows don't
        # match its parity
        data = np.array(data, np.uint8, order="C")
        if not t.is_regenerating:
            from chubaofs_tpu_torch.codec.encoder import lrc_parity_matrix

            return self._submit("encode", lrc_parity_matrix(t), data, _data_above)
        from chubaofs_tpu_torch.codec import pm

        size = data.shape[1]
        if size % t.sub_units:
            raise ValueError(
                f"shard size {size} not a multiple of sub_units={t.sub_units}")
        return self._submit(
            "encode", pm.get_kernel(t.total, t.N).parity_mat,
            data.reshape(t.N * t.sub_units, -1),
            lambda parity, _: _data_above(parity.reshape(t.M, size), data))

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
        shards = np.asarray(shards, np.uint8)
        return self._submit(
            "matmul", kernel.decode_matrix(srv, want),
            shards[np.asarray(srv)].reshape(t.N * t.sub_units, -1),
            _patch(shards, want))

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
        survivors = np.asarray(shards, np.uint8)[np.asarray(present)]
        return self._submit("matmul", mat, survivors, _patch(shards, missing))

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
        return self._submit("matmul", mat, survivors)

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

    def _submit(self, kind: str, mat: np.ndarray, rows: np.ndarray,
                finish=None) -> Future:
        """Queue mat (r, n) GF(2^8) @ rows (n, k) uint8 as one job. Returns a
        future of finish(product, rows) — the (r, k) product itself when
        finish is None — whose cancel() drops the job while it is queued."""
        from chubaofs_tpu_torch.blobstore import trace

        k = rows.shape[1]
        kb = bucket_len(k)
        job = _Job(kind, mat, _pad_to_bucket(rows, k, kb), k, kb)
        out = _ChainFuture(job.future)

        def deliver(f: Future):
            if f.cancelled() or out.cancelled():
                # cancelled upstream (drain handshake dropped the job) or
                # downstream (pipeline abort): nothing to deliver
                return
            try:
                if f.exception():
                    out.set_exception(f.exception())
                elif finish is None:
                    out.set_result(f.result())
                else:
                    out.set_result(finish(f.result(), job.data[:, :k]))
            except InvalidStateError:
                pass  # out.cancel() raced the delivery: outcome discarded

        job.future.add_done_callback(deliver)
        job.span = trace.current_span()
        job.submitted = time.perf_counter()
        self._ensure_started()
        self._q.put(job)
        return out

    def _drain(self) -> list[_Job]:
        try:
            first = self._q.get(timeout=0.2)
        except queue.Empty:
            return []
        if first is None:
            raise StopIteration
        batch = [first]
        deadline = self.max_wait
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
            # submission; the drain loop never re-derives shapes). Matrices
            # are tiny (<= 36x36): key by CONTENT so only jobs with the
            # identical matrix share a batch; the kind only labels counters
            groups: dict[tuple, list[_Job]] = {}
            for j in batch:
                sig = (j.kind, j.mat.tobytes(), j.data.shape[0], j.kb)
                groups.setdefault(sig, []).append(j)
            for jobs in groups.values():
                try:
                    self._run_group(jobs)
                except Exception as e:  # propagate to every waiter
                    for j in jobs:
                        if not j.future.done():
                            j.future.set_exception(e)

    def _record_batch(self, jobs: int, elapsed_s: float, kind: str) -> None:
        from chubaofs_tpu_torch.utils.exporter import BATCH_BUCKETS, registry

        reg = registry("codec")
        reg.counter("batches_total").add()
        reg.counter("jobs_total").add(jobs)
        # the encode/matmul split: proves repair DECODE really batches on
        # the device (bench_repair and the kill soak read this)
        reg.counter("kind_jobs_total", {"kind": kind}).add(jobs)
        reg.counter("kind_batches_total", {"kind": kind}).add()
        reg.summary("batch_jobs", buckets=BATCH_BUCKETS).observe(jobs)
        reg.summary("dispatch_seconds").observe(elapsed_s)

    def _run_group(self, jobs: list[_Job]):
        t0 = time.perf_counter()
        for j in jobs:
            if j.span is not None:
                j.span.add_stage("wait.codec", start=j.submitted, dur=t0 - j.submitted)
        # jobs arrive pre-padded to the bucket: stacking into the (pinned,
        # on a GPU) host staging buffer is the whole host job here
        first = jobs[0].data
        buf = rs.host_buffer((len(jobs), *first.shape), self.device)
        stack = buf.numpy()
        np.stack([j.data for j in jobs], out=stack)
        t_dev = time.perf_counter()
        # the group's one product: H2D copy, one kernel launch, D2H copy
        # (rs.gf_matmul_hostbatch) — or, with a mesh, the same fanned out in
        # blocks over every device
        bits = rs.bit_operand(jobs[0].mat)
        if self._mesh_mm is not None:
            out = self._mesh_mm(bits, stack)
        else:
            out = rs.gf_matmul_hostbatch(bits, buf, device=self.device)
        t_done = time.perf_counter()
        self._record_batch(len(jobs), t_done - t0, jobs[0].kind)
        for j in jobs:
            if j.span is not None:
                # the BATCH's wall intervals, attributed to every rider: the
                # job was in each for exactly these windows (shared across
                # the batch — sums over riders can exceed the batch's
                # seconds, the wall-clock union cannot)
                j.span.add_stage("codec.host", start=t0, dur=t_dev - t0)
                j.span.add_stage("codec.launch", start=t_dev, dur=t_done - t_dev)
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
