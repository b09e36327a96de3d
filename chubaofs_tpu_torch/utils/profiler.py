"""Sampling wall-clock profiler — stack-based "where does daemon CPU go".

The third leg of the observability plane: metrics say *how much*, traces say
*which request*, but neither says where a daemon's threads actually SPEND
wall time (cfs-trace flamegraphs are span-based — they only see what was
instrumented). This is the pprof-style answer: a timer thread samples
`sys._current_frames()` at `CFS_PROF_HZ` and aggregates whole stacks, so the
ROADMAP item-4 question — "is PUT bottlenecked on Python glue or device
encode?" — reads off a profile instead of being guessed.

Discipline (mirrors utils/locks.py's sanitizer):

  * **Disarmed (CFS_PROF_HZ unset, the default): strictly zero overhead.**
    `activate_from_env()` returns without creating anything; no thread, no
    hook, no import cost on any hot path. The zero-overhead test asserts
    this stays true.
  * **Armed:** one daemon-wide sampler thread (`cfs-prof-cont`) keeps a
    rolling aggregate; `/debug/prof` (rpc/server.py mounts it next to
    /metrics) serves it. With `?seconds=N` the endpoint runs a fresh scoped
    capture instead — on-demand profiling works on ANY daemon, armed or
    not, because the cost is explicit and bounded by the request.

Aggregation is per THREAD-NAME bucket (digit runs collapsed, so
`evloop-pkt-0`/`evloop-pkt-1` fold into one `evloop-pkt-N` bucket while
staying distinct from `codec-svc`, `raft-tick`, `access-pipe_N`, ...): the
repo names every hot thread, which makes "which subsystem burns the CPU"
the profile's FIRST axis, before any stack is read. Output is collapsed-
stack text (`bucket;frame;frame count` — the flamegraph.pl/speedscope
format `cfs-trace --flame` also emits), root frame first.

Sampling bias note: `sys._current_frames()` needs the GIL, so samples land
at bytecode boundaries — C-extension/IO waits attribute to the Python frame
that entered them, which is exactly the "glue vs device dispatch" split the
codec roofline work needs.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time

_ENV = "CFS_PROF_HZ"

DEFAULT_HZ = 97.0       # prime: never phase-locks with periodic daemon work
MAX_HZ = 1000.0
MAX_SECONDS = 120.0     # on-demand capture bound (a typo'd ?seconds= must
                        # not pin a handler thread for an hour)
MAX_DEPTH = 48          # frames kept per stack, leaf-side truncated
MAX_STACKS = 4096       # distinct (bucket, stack) keys before lumping


def env_hz() -> float:
    """The armed sample rate, 0.0 when disarmed/malformed (a typo'd env var
    must not kill daemon boot — same contract as the trace sink's budgets)."""
    try:
        hz = float(os.environ.get(_ENV, "") or 0.0)
    except ValueError:
        return 0.0
    return min(hz, MAX_HZ) if hz > 0.0 else 0.0


def enabled() -> bool:
    """Is continuous profiling armed for THIS process?"""
    return env_hz() > 0.0


_DIGITS = re.compile(r"\d+")


def thread_bucket(name: str) -> str:
    """Thread name -> bounded bucket: digit runs collapse to `N` so pool
    members aggregate (`evw-pkt-3` -> `evw-pkt-N`) without erasing the
    subsystem (`evloop-pkt-N` vs `codec-svc` vs `raft-tick` stay apart)."""
    return _DIGITS.sub("N", name or "?")


class Profile:
    """One aggregation: (thread bucket, stack) -> sample count.

    `samples` counts every thread-sample taken; `attributed` the ones whose
    thread was nameable (a tid in `sys._current_frames()` with no live
    `threading` entry — foreign C threads, just-died threads — buckets as
    `?` and is NOT attributed). coverage = attributed / samples is the
    "per-thread-name buckets cover X% of sampled wall time" claim."""

    __slots__ = ("hz", "counts", "samples", "attributed", "sweeps",
                 "seconds", "_lock")

    def __init__(self, hz: float):
        self.hz = hz
        self.counts: dict[tuple[str, tuple[str, ...]], int] = {}
        self.samples = 0
        self.attributed = 0
        self.sweeps = 0
        self.seconds = 0.0
        self._lock = threading.Lock()

    # -- ingest (sampler thread only) ------------------------------------------

    def add_sweep(self, stacks: list[tuple[str, tuple[str, ...]]]) -> None:
        with self._lock:
            self.sweeps += 1
            for bucket, stack in stacks:
                self.samples += 1
                if bucket != "?":
                    self.attributed += 1
                key = (bucket, stack)
                if key not in self.counts and len(self.counts) >= MAX_STACKS:
                    # bounded cardinality: overflow stacks keep their thread
                    # bucket (the first axis survives) but lump the frames
                    key = (bucket, ("<other>",))
                self.counts[key] = self.counts.get(key, 0) + 1

    # -- report ----------------------------------------------------------------

    def thread_totals(self) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for (bucket, _stack), n in self.counts.items():
                out[bucket] = out.get(bucket, 0) + n
            return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def collapsed(self) -> str:
        """Collapsed-stack lines, root frame first — what flamegraph.pl /
        speedscope ingest, and the same shape `cfs-trace --flame` emits for
        span trees. The thread bucket is the root frame."""
        with self._lock:
            items = sorted(self.counts.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        return "\n".join(
            ";".join((bucket,) + stack) + f" {n}"
            for (bucket, stack), n in items)

    def coverage(self) -> float:
        with self._lock:
            return self.attributed / self.samples if self.samples else 0.0

    def to_dict(self) -> dict:
        with self._lock:
            samples, attributed = self.samples, self.attributed
            sweeps, stacks = self.sweeps, len(self.counts)
        return {
            "hz": self.hz,
            "seconds": round(self.seconds, 3),
            "sweeps": sweeps,
            "samples": samples,
            "attributed": attributed,
            "coverage": round(attributed / samples, 4) if samples else 0.0,
            "stacks": stacks,
            "threads": self.thread_totals(),
            "collapsed": self.collapsed(),
        }


def _sample_once(exclude: frozenset[int]) -> list[tuple[str, tuple[str, ...]]]:
    """One sweep over every live thread's current stack. `exclude` drops the
    profiler's own machinery (sampler thread + a blocked capture caller)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        if tid in exclude:
            continue
        stack: list[str] = []
        f = frame
        while f is not None and len(stack) < MAX_DEPTH:
            co = f.f_code
            stack.append(f"{os.path.basename(co.co_filename)}:{co.co_name}")
            f = f.f_back
        stack.reverse()  # root first: the collapsed-stack convention
        out.append((thread_bucket(names.get(tid, "?")) if tid in names
                    else "?", tuple(stack)))
    return out


class SamplingProfiler:
    """The sampler thread around a Profile. `rolling=True` keeps one
    process-lifetime aggregate (the continuous mode); capture() builds a
    fresh bounded one."""

    def __init__(self, hz: float, name: str = "cfs-prof-cont"):
        self.hz = max(0.1, min(float(hz), MAX_HZ))
        self.profile = Profile(self.hz)
        self._stop = threading.Event()
        self._started = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._extra_exclude: frozenset[int] = frozenset()

    def start(self) -> "SamplingProfiler":
        self._started = time.monotonic()
        self._thread.start()
        return self

    def _run(self) -> None:
        period = 1.0 / self.hz
        next_at = time.monotonic()
        while not self._stop.is_set():
            exclude = self._extra_exclude | {self._thread.ident}
            self.profile.add_sweep(_sample_once(frozenset(exclude)))
            self.profile.seconds = time.monotonic() - self._started
            next_at += period
            delay = next_at - time.monotonic()
            if delay > 0:
                self._stop.wait(delay)
            else:
                next_at = time.monotonic()  # overran: don't burst to catch up

    def stop(self) -> Profile:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self.profile.seconds = time.monotonic() - self._started
        return self.profile


def capture(seconds: float, hz: float | None = None) -> Profile:
    """On-demand scoped capture: sample for `seconds` (bounded), return the
    Profile. Blocks the caller — that blocked frame is excluded from its own
    profile (it is profiler machinery, not workload)."""
    seconds = max(0.05, min(float(seconds), MAX_SECONDS))
    p = SamplingProfiler(hz or env_hz() or DEFAULT_HZ, name="cfs-prof-cap")
    caller = threading.current_thread().ident
    if caller is not None:
        p._extra_exclude = frozenset({caller})
    p.start()
    time.sleep(seconds)
    return p.stop()


# -- process-wide continuous profiler ------------------------------------------

_active: SamplingProfiler | None = None
_lock = threading.Lock()


def active() -> SamplingProfiler | None:
    return _active


def activate_from_env() -> SamplingProfiler | None:
    """Arm the continuous profiler iff CFS_PROF_HZ asks for it — the daemon-
    boot hook (rpc/server.py calls it next to tracesink.activate_from_env).
    Unset env = return None having touched nothing: the zero-overhead gate."""
    global _active
    if not enabled():
        return _active
    with _lock:
        if _active is None:
            _active = SamplingProfiler(env_hz()).start()
        return _active


def deactivate() -> None:
    """Stop + forget the continuous profiler (test isolation)."""
    global _active
    with _lock:
        p, _active = _active, None
    if p is not None:
        p.stop()
