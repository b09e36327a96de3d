"""Trace sink — sampled, bounded, persisted span records per daemon.

The collection half of the observability plane: trace.py's spans carry the
timing tree, but until they land somewhere a trace lives only as the
ephemeral response-header track log. The sink persists finished spans as one
JSON SpanRecord line each through the same `utils/auditlog.RotatingFile`
rotor discipline as the slow-op audit — so the byte budget is configured,
enforced, and shared-nothing — and keeps a bounded in-memory index of recent
records for the `/traces` HTTP side-door (rpc/server.py mounts it next to
/metrics).

Sampling (`CFS_TRACE_SAMPLE`, a 0..1 fraction, default 0 = off) is decided
per TRACE by a deterministic hash of the trace id, so every daemon a request
crosses keeps or drops the same traces and the collector always sees whole
trees. Unsampled spans cost one float compare in the finish hook — no record
is built, nothing is written. Slow ops are ALWAYS persisted: the slow-op
audit (utils/auditlog.record_slow_op) forces the span into the sink
regardless of the sample rate, so the trace behind every slowop line is
fetchable by id.

`tools/cfstrace.py` (`cfs-trace`) reassembles the hop tree from these
records and runs the critical-path analyzer over them.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import zlib

from chubaofs_tpu_torch.utils.auditlog import RotatingFile
from chubaofs_tpu_torch.utils.locks import SanitizedLock


class TraceSink:
    """Bounded span-record store: RotatingFile ring + recent-record deque."""

    def __init__(self, logdir: str, sample: float = 0.0,
                 max_bytes: int = 4 << 20, max_files: int = 4,
                 recent_max: int = 1024):
        self.sample = float(sample)
        self.max_bytes = max_bytes
        self.max_files = max_files
        self.dir = logdir
        self._rotor = RotatingFile(logdir, "traces", max_bytes, max_files)
        self._recent: collections.deque = collections.deque(maxlen=recent_max)
        self._lock = SanitizedLock(name="tracesink.recent")

    # -- ingest ----------------------------------------------------------------

    def sampled(self, trace_id: str) -> bool:
        """Deterministic per-trace decision: every process hashing the same
        trace id reaches the same verdict (no coordination, whole trees)."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        h = zlib.crc32(trace_id.encode()) & 0xFFFFFFFF
        return h / 4294967296.0 < self.sample

    def on_span_finish(self, span) -> bool:
        """The trace.set_finish_hook target. Unsampled spans return after a
        float compare — no record building, no IO (the bounded-overhead
        contract)."""
        if getattr(span, "_sink_force", False):
            return self._persist(span)
        if self.sample <= 0.0:
            return False
        if not self.sampled(span.trace_id):
            return False
        return self._persist(span)

    def force(self, span) -> bool:
        """Persist regardless of sampling (the slow-op path). A span still
        running is flagged instead — its finish hook persists the COMPLETE
        record (entry points audit inside their span, before finish())."""
        if span.finished_us is None:
            span._sink_force = True
            return False
        return self._persist(span)

    def _persist(self, span) -> bool:
        if getattr(span, "_sink_recorded", False):
            return False  # force-after-finish meets the finish hook: once
        span._sink_recorded = True
        rec = span.to_record()
        with self._lock:
            self._recent.append(rec)
        self._rotor.write_line(json.dumps(rec, default=str))
        return True

    # -- queries ---------------------------------------------------------------

    def records(self, trace_id: str) -> list[dict]:
        """Every persisted span of one trace, oldest-start first — the rotor
        ring is scanned too, so a trace survives the recent-deque window (and
        a restart) as long as its lines haven't rotated out."""
        out: dict[str, dict] = {}
        for line in self._rotor.read_lines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("trace_id") == trace_id and rec.get("span_id"):
                out[rec["span_id"]] = rec
        with self._lock:
            recent = list(self._recent)
        for rec in recent:
            if rec.get("trace_id") == trace_id and rec.get("span_id"):
                out[rec["span_id"]] = rec
        return sorted(out.values(), key=lambda r: r.get("start", 0.0))

    def recent_records(self, n: int = 200) -> list[dict]:
        """The newest n span records (newest last) — the aggregation feed
        for per-hop p50/p99 (`cfs-trace --top`). n<=0 is an empty window."""
        if n <= 0:
            return []
        with self._lock:
            recent = list(self._recent)
        return recent[-n:]

    def recent_traces(self, n: int = 50) -> list[dict]:
        """Per-trace summaries of the recent window, newest last."""
        groups: dict[str, list[dict]] = {}
        for rec in self.recent_records(len(self._recent) or 1):
            groups.setdefault(rec["trace_id"], []).append(rec)
        out = []
        for tid, recs in groups.items():
            root = max(recs, key=lambda r: r.get("dur_us", 0))
            out.append({"trace_id": tid, "root_op": root.get("op", "?"),
                        "dur_us": root.get("dur_us", 0),
                        "start": root.get("start", 0.0), "spans": len(recs)})
        out.sort(key=lambda t: t["start"])
        return out[-n:]

    def close(self):
        self._rotor.close()


# -- process-wide default ------------------------------------------------------

_default: TraceSink | None = None
_lock = SanitizedLock(name="tracesink.default")


def _env_sample() -> float:
    try:
        return float(os.environ.get("CFS_TRACE_SAMPLE", "0") or 0)
    except ValueError:
        return 0.0


def _env_int(name: str, default: int) -> int:
    """Malformed byte/file budgets degrade to defaults — this parse runs
    inside RPCServer construction (activate_from_env), where a typo'd env
    var must not kill daemon boot. Canonical impl: utils.config.env_int."""
    from chubaofs_tpu_torch.utils.config import env_int

    return env_int(name, default)


def default_sink() -> TraceSink:
    """The process trace sink, created on first use (like the slow-op log):
    directory from CFS_TRACE_DIR (default per-process tmpdir), sample rate
    from CFS_TRACE_SAMPLE, byte budget from CFS_TRACE_BYTES/CFS_TRACE_FILES.
    Creation installs the span-finish hook."""
    global _default
    with _lock:
        if _default is None:
            logdir = os.environ.get("CFS_TRACE_DIR") or os.path.join(
                tempfile.gettempdir(), f"cfs-traces-{os.getpid()}")
            _default = TraceSink(
                logdir, sample=_env_sample(),
                max_bytes=_env_int("CFS_TRACE_BYTES", 4 << 20),
                max_files=_env_int("CFS_TRACE_FILES", 4))
            from chubaofs_tpu_torch.blobstore import trace

            trace.set_finish_hook(_default.on_span_finish)
        return _default


def configure(logdir: str | None = None, sample: float | None = None,
              max_bytes: int | None = None,
              max_files: int | None = None) -> TraceSink:
    """(Re)bind the process sink — daemons point it at their log dir, tests
    at a tmpdir with sample=1.0. Passing only `sample` retunes in place;
    a logdir or byte-budget change rebuilds the sink, carrying forward
    every setting the caller did NOT pass — an earlier explicit sample
    rate or budget is never silently reset to env defaults."""
    global _default
    with _lock:
        if _default is not None and (
                logdir is not None
                or (max_bytes is not None and max_bytes != _default.max_bytes)
                or (max_files is not None and max_files != _default.max_files)):
            logdir = logdir or _default.dir
            if sample is None:
                sample = _default.sample
            if max_bytes is None:
                max_bytes = _default.max_bytes
            if max_files is None:
                max_files = _default.max_files
            _default.close()
            _default = None
        if _default is None:
            _default = TraceSink(
                logdir or os.environ.get("CFS_TRACE_DIR") or os.path.join(
                    tempfile.gettempdir(), f"cfs-traces-{os.getpid()}"),
                sample=_env_sample() if sample is None else sample,
                max_bytes=(_env_int("CFS_TRACE_BYTES", 4 << 20)
                           if max_bytes is None else max_bytes),
                max_files=(_env_int("CFS_TRACE_FILES", 4)
                           if max_files is None else max_files))
            from chubaofs_tpu_torch.blobstore import trace

            trace.set_finish_hook(_default.on_span_finish)
        elif sample is not None:
            _default.sample = float(sample)
        return _default


def activate_from_env() -> TraceSink | None:
    """Arm the sink iff CFS_TRACE_SAMPLE asks for sampling — the daemon-boot
    hook (RPCServer construction) that makes env-configured tracing live
    without any subsystem knowing about the sink."""
    if _env_sample() > 0.0:
        return default_sink()
    return _default


def force(span) -> bool:
    """Slow-op entry: persist this span whatever the sample rate says."""
    return default_sink().force(span)
