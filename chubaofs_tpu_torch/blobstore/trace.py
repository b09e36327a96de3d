"""Distributed tracing — spans with in-band propagation + RPC track logs.

Reference counterpart: blobstore/common/trace (tracer.go:34 opentracing
aliases, span.go:25-35) — every blobstore ctx carries a span; services append
"track log" entries (module:latency/result) that ride response headers so the
access gateway can log one line covering the whole fan-out (used at
access/stream_put.go:47,100). Kept: trace-id propagation, child spans, track
logs appended bottom-up. The carrier is a plain dict standing in for HTTP
headers (inject/extract), so both in-process and HTTP hops propagate the same
way; the packet TCP wire carries the same two fields in its arg blob
(proto/packet.py trace_inject/trace_reply).

Track logs are BOUNDED: at most TRACK_MAX entries per span (a failpoint-looped
fan-out must not blow the response-header budget), and module names are
sanitized (`;`/newlines/`:` would corrupt the ';'-joined wire form).

Beyond the wire-form track log, every span is a STRUCTURED record: a span id,
its parent (in-process parent span, or the remote caller's span id carried
next to the trace id), a wall-clock start stamp plus monotonic duration, and
named STAGES — (name, offset, duration) attributions inside the span
that the critical-path analyzer (tools/cfstrace.py) projects onto the
request's wall time. Stage names are one family: `wait.<resource>` for time
spent waiting on a resource (`wait.codec`, the codec service's queue;
`wait.read_pool`, the gateway's read pool) and `<layer>.<what>` or a plain
step name for work (`read`, `gather`, `decode`, `encode`, `write`; the
codec's `codec.host` and `codec.launch`, codec/service.py; `rpc.pool`,
`raft`...). `finish()` hands the span to the trace sink (utils/tracesink.py)
when one is installed; with no sink the hook is a single None check.
"""

from __future__ import annotations

import threading
import time
import uuid

TRACE_ID_KEY = "Trace-Id"
TRACK_LOG_KEY = "Trace-Tracklog"
SPAN_ID_KEY = "Trace-Span-Id"

# hard cap on track entries per span: deep fan-outs degrade to a truncated
# track log, never to an unbounded response header
TRACK_MAX = 64
# stage attributions are richer than track entries but just as bounded: a
# retry-looped hop must not grow a span record without limit
STAGE_MAX = 128
_ENTRY_MAX = 128  # one hostile module name must not be the whole header

# sink hook installed by utils/tracesink (None = tracing-only, zero
# persistence work); called with the finished span, must never raise
_finish_hook = None


def set_finish_hook(fn) -> None:
    """Install (or clear, with None) the span-finish hook the trace sink
    rides. Process-global, like the span machinery itself."""
    global _finish_hook
    _finish_hook = fn


def finish_hook():
    """The currently installed span-finish hook (None if none) — a caller
    that temporarily swaps its own hook in must save this and CHAIN to it,
    or an active trace sink silently loses every span it swallows."""
    return _finish_hook


def union_len(intervals) -> float:
    """Total length of the union of [s, e) intervals (overlap counts once).
    THE sweep-line both overlap consumers share — the scheduler's
    repair-span overlap ratio and cfs-trace's critical-path/stage-overlap
    analyzers must agree on this math or their reported ratios drift."""
    total = 0.0
    end = float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def intersect_len(a, b) -> float:
    """Length of the intersection of two interval unions (inclusion-
    exclusion over union_len): how long BOTH families were active at once."""
    if not a or not b:
        return 0.0
    return union_len(a) + union_len(b) - union_len(list(a) + list(b))


def overlap_ratio(a, b) -> float | None:
    """Intersection of two interval-union families over the SMALLER union —
    1.0 means the lesser family ran entirely inside the greater (perfect
    pipelining), 0.0 means strictly back-to-back, None means either side
    never happened. THE ratio definition shared by the scheduler's
    repair-span metric and cfs-trace's --overlap report: one implementation
    so the dashboard number and the CLI report can never drift apart."""
    if not a or not b:
        return None
    floor = min(union_len(a), union_len(b))
    return (intersect_len(a, b) / floor) if floor > 0 else 0.0

_local = threading.local()

_SANITIZE = str.maketrans({";": "_", ":": "_", "\n": "_", "\r": "_"})
# a whole entry keeps its own "module:ms" colon; only the separators that
# would corrupt the ';'-joined wire form are rewritten
_SANITIZE_ENTRY = str.maketrans({";": "_", "\n": "_", "\r": "_"})


def sanitize_module(module: str) -> str:
    """Track-log entries are ';'-joined and ':'-split downstream; a module
    name carrying either (or newlines, which break log lines) is rewritten."""
    return str(module).translate(_SANITIZE)[:_ENTRY_MAX]


class Span:
    def __init__(self, operation: str, trace_id: str | None = None,
                 parent: "Span | None" = None):
        self.operation = operation
        # lazy: the id mints on first READ. Dispatch loops create a span per
        # packet/VFS op unconditionally; an untraced op whose id nobody asks
        # for must not pay os.urandom entropy on the hot path.
        self._trace_id = trace_id or (parent.trace_id if parent else None)
        self.parent = parent
        self.start = time.perf_counter()
        # wall stamp pairs records from different processes onto one
        # timeline (same-host skew only); NEVER used for durations — those
        # stay on the monotonic clock
        self.start_wall = time.time()
        self.tags: dict[str, object] = {}
        self.logs: list[tuple[float, str]] = []
        self.track: list[str] = []  # track-log entries, e.g. "blobnode:12"
        self.track_dropped = 0  # entries the TRACK_MAX cap swallowed
        # named in-span attributions: (name, offset_s from start, dur_s)
        self.stages: list[tuple[str, float, float]] = []
        self.stage_dropped = 0
        # span id of the remote CALLER's span when this span continued a
        # carrier that named one (the cross-process parent edge)
        self.remote_parent: str | None = None
        self._span_id: str | None = None
        self.finished_us: int | None = None

    @property
    def trace_id(self) -> str:
        if self._trace_id is None:
            self._trace_id = uuid.uuid4().hex[:16]
        return self._trace_id

    @property
    def span_id(self) -> str:
        # lazy like trace_id: minted only when someone records/propagates it
        if self._span_id is None:
            self._span_id = uuid.uuid4().hex[:16]
        return self._span_id

    # -- opentracing-style surface ---------------------------------------------
    def set_tag(self, k: str, v) -> "Span":
        self.tags[k] = v
        return self

    def log(self, msg: str):
        self.logs.append((time.perf_counter() - self.start, msg))

    def _push_track(self, entry: str):
        if len(self.track) >= TRACK_MAX:
            if self.track_dropped == 0:
                # first drop on this span: count it (cold path — truncation
                # is the anomaly the counter exists to surface)
                try:
                    from chubaofs_tpu_torch.utils.exporter import registry

                    registry("trace").counter("track_truncated").add()
                except Exception:
                    pass
            self.track_dropped += 1
            return
        self.track.append(entry)

    def add_stage(self, name: str, start: float, dur: float | None = None):
        """Attribute a named stage of this span: `start` is a
        time.perf_counter() stamp (any thread — one global clock), `dur`
        seconds (elapsed-since-start when omitted). Bounded by STAGE_MAX."""
        if dur is None:
            dur = time.perf_counter() - start
        if len(self.stages) >= STAGE_MAX:
            self.stage_dropped += 1
            return
        self.stages.append((sanitize_module(name), start - self.start, dur))

    def append_track_log(self, module: str, start: float | None = None,
                         err: Exception | None = None):
        """stream_put.go:100-style: module + elapsed ms + error class."""
        ms = int(((time.perf_counter() - (start or self.start)) * 1000))
        entry = f"{sanitize_module(module)}:{ms}"
        if err is not None:
            entry += f"/{sanitize_module(type(err).__name__)}"
        self._push_track(entry)

    def merge_track(self, entries):
        """Fold a remote hop's track entries (list or ';'-joined string) into
        this span, sanitized and bounded — the client side of a reply that
        carried a track log back."""
        if not entries:
            return
        if isinstance(entries, str):
            entries = entries.split(";")
        for e in entries:
            e = str(e).translate(_SANITIZE_ENTRY)[:_ENTRY_MAX]
            if e:
                self._push_track(e)

    def finish(self):
        if self.finished_us is None:
            self.finished_us = int((time.perf_counter() - self.start) * 1e6)
            if self.parent is not None:
                for e in self.track:
                    self.parent._push_track(e)
                self.parent.track_dropped += self.track_dropped
            hook = _finish_hook
            if hook is not None:
                try:
                    hook(self)
                except Exception:
                    pass  # a sink failure must never fail the traced op

    def __enter__(self):
        push_span(self)
        return self

    def __exit__(self, et, ev, tb):
        self.finish()
        pop_span()
        return False

    # -- propagation -----------------------------------------------------------
    def track_entries(self) -> list[str]:
        """Track entries as they go on the wire (always a fresh list — a
        caller may attach it to a reply that outlives this span's next
        append): a dropped-entry count is no longer silent — the
        `...truncated:<n>` sentinel rides in-band so a reader knows the log
        is a prefix, not the whole story."""
        if self.track_dropped:
            return self.track + [f"...truncated:{self.track_dropped}"]
        return list(self.track)

    def inject(self, carrier: dict):
        carrier[TRACE_ID_KEY] = self.trace_id
        carrier[SPAN_ID_KEY] = self.span_id
        if self.track:
            carrier[TRACK_LOG_KEY] = ";".join(self.track_entries())

    def track_log_string(self) -> str:
        return ";".join(self.track_entries())

    def modules(self) -> set[str]:
        """Distinct module names present in the track log."""
        return {e.split(":", 1)[0] for e in self.track if e}

    def to_record(self) -> dict:
        """The span as a JSON-able SpanRecord — what the trace sink persists
        and /traces serves; tools/cfstrace.py reassembles trees from these."""
        dur = self.finished_us
        if dur is None:  # unfinished span recorded early (best effort)
            dur = int((time.perf_counter() - self.start) * 1e6)
        rec: dict = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": (self.parent.span_id if self.parent is not None
                               else self.remote_parent),
            "op": self.operation,
            "start": round(self.start_wall, 6),
            "dur_us": dur,
        }
        if self.stages:
            rec["stages"] = [[n, int(off * 1e6), int(d * 1e6)]
                             for n, off, d in self.stages]
        if self.stage_dropped:
            rec["stages_dropped"] = self.stage_dropped
        if self.tags:
            rec["tags"] = dict(self.tags)
        if self.track:
            rec["track"] = self.track_log_string()
        return rec


def extract_trace_id(carrier: dict | None) -> str | None:
    """Trace id from a carrier dict, tolerant of lower-cased header keys
    (rpc Request lower-cases everything)."""
    if not carrier:
        return None
    return carrier.get(TRACE_ID_KEY) or carrier.get(TRACE_ID_KEY.lower())


def extract_span_id(carrier: dict | None) -> str | None:
    """The remote caller's span id, same lower-case tolerance."""
    if not carrier:
        return None
    return carrier.get(SPAN_ID_KEY) or carrier.get(SPAN_ID_KEY.lower())


def start_span(operation: str, carrier: dict | None = None) -> Span:
    """New root (or remote-continued, when carrier holds a trace id) span."""
    span = Span(operation, trace_id=extract_trace_id(carrier))
    if carrier:
        span.remote_parent = extract_span_id(carrier)
        tl = carrier.get(TRACK_LOG_KEY) or carrier.get(TRACK_LOG_KEY.lower())
        if tl:
            span.merge_track(tl)
    return span


def child_of(parent: Span | None, operation: str) -> Span:
    return Span(operation, parent=parent) if parent else Span(operation)


def push_span(span: Span):
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(span)


def pop_span():
    stack = getattr(_local, "stack", None)
    if stack:
        stack.pop()


def current_span() -> Span | None:
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None
