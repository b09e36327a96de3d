"""Audit log — append-only, size-rotated op log shared by client and gateways.

Reference counterpart: util/auditlog/auditlog.go:74-161 (client fs-op audit —
timestamp, client addr, volume, op, path, error, latency, ino — written to a
rotating file set with a shrink-on-total-size policy) and the blobstore HTTP
auditlog middleware (common/rpc/auditlog). One implementation serves both: a
`AuditLog` with `log_fs_op` / `log_http` formatters over the same rotor.

Slow-op audit: any op slower than the `CFS_SLOWOP_MS` threshold emits one
STRUCTURED record — module, op, trace id, the span's whole track log, latency
— through the same rotor discipline, so a single slow FUSE create or access
PUT explains itself hop by hop (the blobstore access gateway's slow-request
track-log line, generalized to every entry point)."""

from __future__ import annotations

import json
import os
import tempfile
import time

from chubaofs_tpu_torch.utils.locks import SanitizedLock


class RotatingFile:
    """Size-rotated append file ring: name.log, name.log.1 .. name.log.N.

    The one rotor shared by the fs audit log, the blobstore recordlog, and any
    other append-only trail (auditlog.go's total-size shrink policy, expressed
    as a bounded file ring). Thread-safe; lines are written whole."""

    def __init__(self, logdir: str, prefix: str, max_bytes: int, max_files: int):
        self.dir = logdir
        self.prefix = prefix
        self.max_bytes = max_bytes
        self.max_files = max_files
        # bounded name set: one rotor per trail kind (audit/slowop/traces/...)
        self._lock = SanitizedLock(name=f"auditlog.{prefix}")
        os.makedirs(logdir, exist_ok=True)
        self._fh = None
        self._open_locked()

    def path(self, n: int = 0) -> str:
        return os.path.join(self.dir, f"{self.prefix}.log" + (f".{n}" if n else ""))

    def _open_locked(self):
        self._fh = open(self.path(), "a", encoding="utf-8")
        self._size = self._fh.tell()

    def _rotate_locked(self):
        self._fh.close()
        for n in range(self.max_files - 1, 0, -1):
            src = self.path(n - 1) if n > 1 else self.path()
            if os.path.exists(src):
                os.replace(src, self.path(n))
        self._open_locked()

    def write_line(self, line: str):
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line + "\n")
            self._fh.flush()
            self._size += len(line) + 1
            if self._size >= self.max_bytes:
                self._rotate_locked()

    def read_lines(self) -> list[str]:
        """Every retained line, oldest first, across rotations. Reads race
        the writer's rotation (the trace/slowop HTTP side-doors read a LIVE
        rotor): a file that vanishes between listing and open — os.replace'd
        up the ring — is skipped, never a request-killing error."""
        out: list[str] = []
        for n in range(self.max_files, -1, -1):
            p = self.path(n)
            try:
                with open(p, encoding="utf-8") as f:
                    out.extend(line.rstrip("\n") for line in f if line.strip())
            except OSError:
                continue
        return out

    def close(self):
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None


class AuditLog:
    def __init__(self, logdir: str, prefix: str = "audit",
                 max_bytes: int = 4 << 20, max_files: int = 8):
        self._rotor = RotatingFile(logdir, prefix, max_bytes, max_files)

    def log_fs_op(self, client: str, volume: str, op: str, path: str,
                  err: str = "", latency_us: int = 0, ino: int = 0):
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        self._rotor.write_line(",".join([ts, client, volume, op, path,
                                         err or "nil", str(latency_us), str(ino)]))

    def log_http(self, method: str, path: str, status: int, latency_us: int,
                 remote: str = "-", req_bytes: int = 0, resp_bytes: int = 0):
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        self._rotor.write_line(",".join([ts, remote, method, path, str(status),
                                         str(req_bytes), str(resp_bytes),
                                         str(latency_us)]))

    def close(self):
        self._rotor.close()


# -- slow-op audit (CFS_SLOWOP_MS) ---------------------------------------------


class SlowOpLog:
    """Structured slow-op trail: one JSON line per over-threshold op, with
    the op's trace id and track log so the latency is attributable hop by
    hop. Threshold in milliseconds; <= 0 disables (the default)."""

    def __init__(self, logdir: str, threshold_ms: float = 0.0,
                 max_bytes: int = 4 << 20, max_files: int = 4):
        self.threshold_ms = threshold_ms
        self._rotor = RotatingFile(logdir, "slowop", max_bytes, max_files)

    def maybe_log(self, module: str, op: str, latency_s: float,
                  span=None, err: str = "") -> bool:
        """Record the op if it crossed the threshold; True when logged."""
        ms = latency_s * 1e3
        if self.threshold_ms <= 0 or ms < self.threshold_ms:
            return False
        rec = {"ts": time.strftime("%Y-%m-%d %H:%M:%S"),
               "module": module, "op": op, "latency_ms": round(ms, 3)}
        if span is not None:
            rec["trace_id"] = span.trace_id
            rec["track"] = span.track_log_string()
        if err:
            rec["err"] = err
        self._rotor.write_line(json.dumps(rec))
        return True

    def records(self) -> list[dict]:
        out = []
        for line in self._rotor.read_lines():
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
        return out

    def close(self):
        self._rotor.close()


_slowop: SlowOpLog | None = None
_slowop_lock = SanitizedLock(name="auditlog.slowop.default")


_env_ms_cache: float | None = None


def _env_threshold_ms() -> float:
    """CFS_SLOWOP_MS, parsed ONCE — the disabled fast path in every packet/
    fs-op dispatch must not pay an environ lookup per call. Overrides after
    startup go through configure_slowop()."""
    global _env_ms_cache
    if _env_ms_cache is None:
        try:
            _env_ms_cache = float(os.environ.get("CFS_SLOWOP_MS", "0") or 0)
        except ValueError:
            _env_ms_cache = 0.0
    return _env_ms_cache


def slowop_log() -> SlowOpLog:
    """The process-wide slow-op log. Directory from `CFS_SLOWOP_DIR` (default
    a per-process dir under the system tmpdir), threshold from
    `CFS_SLOWOP_MS` — both re-read on first use; tests reconfigure via
    configure_slowop()."""
    global _slowop
    with _slowop_lock:
        if _slowop is None:
            logdir = os.environ.get("CFS_SLOWOP_DIR") or os.path.join(
                tempfile.gettempdir(), f"cfs-slowop-{os.getpid()}")
            _slowop = SlowOpLog(logdir, threshold_ms=_env_threshold_ms())
        return _slowop


def configure_slowop(logdir: str | None = None,
                     threshold_ms: float | None = None) -> SlowOpLog:
    """(Re)bind the process slow-op log — daemons point it at their log dir,
    tests at a tmpdir with a tiny threshold."""
    global _slowop
    with _slowop_lock:
        if _slowop is not None and logdir is not None:
            _slowop.close()
            _slowop = None
        if _slowop is None:
            _slowop = SlowOpLog(
                logdir or os.environ.get("CFS_SLOWOP_DIR") or os.path.join(
                    tempfile.gettempdir(), f"cfs-slowop-{os.getpid()}"),
                threshold_ms=(_env_threshold_ms() if threshold_ms is None
                              else threshold_ms))
        elif threshold_ms is not None:
            _slowop.threshold_ms = threshold_ms
        return _slowop


def recent_slowops(n: int = 100) -> list[dict]:
    """The newest n slow-op records — the one accessor behind every HTTP
    face of the audit (RPCServer /slowops, the master's /api/slowops
    alias), so the windows can't drift apart. n<=0 is an empty window,
    never the [-0:] whole-log slice."""
    if n <= 0:
        return []
    return slowop_log().records()[-n:]


def record_slow_op(module: str, op: str, latency_s: float, span=None,
                   err: str = "") -> bool:
    """Entry-point hook: cheap when disabled (one cached float compare, no
    files ever opened), one JSON line + a metrics counter when the op
    crossed CFS_SLOWOP_MS. NEVER raises — it runs in serve loops' finally
    blocks (FUSE dispatch, packet dispatch), where a full disk or an
    unwritable CFS_SLOWOP_DIR must degrade to lost audit lines, not to a
    dead mount."""
    try:
        if _slowop is None and _env_threshold_ms() <= 0:
            return False  # disabled and never configured: no rotor to create
        log = slowop_log()
        if log.threshold_ms <= 0:
            return False
        if not log.maybe_log(module, op, latency_s, span=span, err=err):
            return False
        from chubaofs_tpu_torch.utils.exporter import registry

        registry("slowop").counter("slow_ops_total",
                                   {"module": module, "op": op}).add()
        if span is not None:
            # slow ops are always-on for the trace sink: the span behind
            # every slowop line persists whatever CFS_TRACE_SAMPLE says
            from chubaofs_tpu_torch.utils import tracesink

            tracesink.force(span)
        return True
    except Exception:
        return False
