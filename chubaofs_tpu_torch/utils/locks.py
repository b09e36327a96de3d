"""Lock sanitizer — named locks with an opt-in runtime order/hold checker.

The runtime half of the concurrency plane (tools/racelint.py is the static
half). `SanitizedLock(name=...)` / `SanitizedRLock(name=...)` are drop-in
factories for `threading.Lock()` / `threading.RLock()`:

  * **Disabled (the default):** they return the plain threading primitive —
    zero wrapper, zero overhead, nothing imported on the hot path.
  * **`CFS_LOCK_SANITIZER=1`:** they return instrumented locks that record,
    per thread, the stack of locks currently held and a short acquisition
    site for each; every acquire while other locks are held adds
    `held -> acquired` edges to a process-global lock-ORDER graph. An edge
    whose reverse path already exists is a cycle — the classic A->B / B->A
    inversion that becomes a deadlock the day the two threads interleave the
    other way — and is reported ONCE per lock pair: a
    `cfs_lock_inversion` counter sample, one structured JSON audit line on
    stderr (daemon logs capture it), and an in-memory record that tests and
    `cfs-chaos-soak --sanitize` read via `inversions()`.
  * Hold times ride the same instrumentation: every release observes
    `cfs_lock_hold_ms{name=...}`, and holds longer than `CFS_LOCK_HOLD_MS`
    (default 100 ms) additionally emit a `lock_hold` audit line with the
    acquisition site — the "who slept inside a lock" answer that turns a
    p99 cliff into a file:line.

The activation check happens at lock CONSTRUCTION: daemons and tests that
set the env var before building their components (the test suite's conftest does,
so every MiniCluster e2e doubles as a race probe) get full coverage; a
process that never sets it pays nothing.

Names are part of the contract: `SanitizedLock(name="rpc.pool")` makes the
inversion report and the hold-time series readable. Same-name edges are NOT
tracked (two instances of one class sharing a name would self-cycle on
first contact); give distinct instances that can nest distinct names, as
raft does with `raft.node<N>`.

The sanitizer itself must not deadlock or recurse: the graph lock below is
a plain `threading.Lock`, metric emission happens OUTSIDE it, and the
exporter's internal micro-locks stay unsanitized (a sanitized counter lock
would re-enter the sanitizer from its own bookkeeping).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time

_ENV = "CFS_LOCK_SANITIZER"
_HOLD_ENV = "CFS_LOCK_HOLD_MS"

# hold-time histogram buckets, in MILLISECONDS (sub-0.1ms lock flashes up to
# multi-second stalls)
HOLD_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                100.0, 250.0, 1000.0)


def enabled() -> bool:
    """Is the sanitizer armed for locks constructed NOW?"""
    return os.environ.get(_ENV, "") not in ("", "0")


def hold_threshold_ms() -> float:
    try:
        return float(os.environ.get(_HOLD_ENV, "") or 100.0)
    except ValueError:
        return 100.0


def SanitizedLock(name: str = "anon"):
    """threading.Lock(), instrumented iff CFS_LOCK_SANITIZER is set."""
    if not enabled():
        return threading.Lock()
    return _SanLock(name, threading.Lock(), reentrant=False)


def SanitizedRLock(name: str = "anon"):
    """threading.RLock(), instrumented iff CFS_LOCK_SANITIZER is set."""
    if not enabled():
        return threading.RLock()
    return _SanLock(name, threading.RLock(), reentrant=True)


# -- process-global order graph ------------------------------------------------

# all four structures below are guarded by _graph_lock (a PLAIN lock: the
# sanitizer must never sanitize itself)
_graph_lock = threading.Lock()
_order: dict[str, set[str]] = {}  # name -> names acquired while it was held
_edge_site: dict[tuple[str, str], str] = {}  # first site that added each edge
_inversions: list[dict] = []
_reported_pairs: set[frozenset] = set()
_hold_outliers: list[dict] = []
_HOLD_OUTLIER_MAX = 256  # bounded: an audit trail, not a profile

_tls = threading.local()  # .held: list of [lock_obj, name, t0, site, token]
_acquire_tokens = itertools.count(1)  # unique token per tracked acquire


def _held_stack() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _site(skip: int = 2, frames: int = 4) -> str:
    """Short acquisition site: 'file:line:func < caller < ...'. Walks raw
    frames (no line-text formatting) so the per-acquire cost stays in the
    microseconds."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return "?"
    out = []
    while f is not None and len(out) < frames:
        co = f.f_code
        base = os.path.basename(co.co_filename)
        if base != "locks.py":
            out.append(f"{base}:{f.f_lineno}:{co.co_name}")
        f = f.f_back
    return " < ".join(out) or "?"


def _path_exists(src: str, dst: str) -> bool:
    """DFS over the order graph (called under _graph_lock)."""
    if src == dst:
        return True
    seen = {src}
    stack = [src]
    while stack:
        for nxt in _order.get(stack.pop(), ()):
            if nxt == dst:
                return True
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return False


def _audit_line(kind: str, rec: dict) -> None:
    """One structured audit line on stderr — daemon .log files and the
    harness capture it; never raises (the sanitizer must not break the
    locked path it watches)."""
    try:
        print(json.dumps({"audit": kind, **rec}),  # obslint: structured audit line; stderr is the captured daemon log
              file=sys.stderr, flush=True)
    except Exception:
        pass


def _metric_counter(name: str, labels: dict | None = None):
    from chubaofs_tpu_torch.utils.exporter import registry

    return registry("lock").counter(name, labels)


def _note_edges_locked(acq_name: str, acq_site: str,
                       held: list) -> list[dict]:
    """Record held->acquired edges; returns inversion records to report.
    Caller holds _graph_lock (metric/audit emission happens OUTSIDE it)."""
    new_inversions: list[dict] = []
    for _, held_name, _, held_site, _ in held:
        if held_name == acq_name:
            continue  # reentrancy / same-name siblings: not an ordering
        after = _order.setdefault(held_name, set())
        if acq_name in after:
            continue  # known edge: fast path
        if _path_exists(acq_name, held_name):
            pair = frozenset((held_name, acq_name))
            if pair not in _reported_pairs:
                _reported_pairs.add(pair)
                rec = {
                    "first": held_name, "then": acq_name,
                    "held_site": held_site, "acquire_site": acq_site,
                    "reverse_site": _edge_site.get(
                        (acq_name, held_name), "?"),
                    "thread": threading.current_thread().name,
                }
                _inversions.append(rec)
                new_inversions.append(rec)
        after.add(acq_name)
        _edge_site.setdefault((held_name, acq_name), acq_site)
    return new_inversions


class _SanLock:
    """The instrumented lock: acquire/release/context-manager compatible
    with threading.Lock/RLock."""

    __slots__ = ("name", "_lock", "_reentrant", "_summary", "_holder",
                 "_stale")

    def __init__(self, name: str, lock, reentrant: bool):
        self.name = name
        self._lock = lock
        self._reentrant = reentrant
        self._summary = None
        # cross-thread handoff bookkeeping (plain Lock may legally be
        # released by a thread that never acquired it): _holder is the
        # TOKEN of the outermost live acquire, _stale the tokens whose
        # acquire was released from another thread — the acquirer's stack
        # entry is reconciled lazily, BY TOKEN, on its next acquire, so a
        # handoff can neither mint phantom order edges nor (the failure a
        # thread-agnostic counter had) evict a later legitimate holder's
        # entry
        self._holder = None
        self._stale: set[int] = set()

    # -- the instrumented path ---------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if not ok:
            return False
        held = _held_stack()
        site = _site()
        tok = next(_acquire_tokens)
        new_inversions: list[dict] = []
        # ONE critical section for reconcile + edges + holder: a concurrent
        # handoff release linearizes entirely before it (its stale mark is
        # seen and the dead entry dropped before edge-noting) or entirely
        # after (the entry was legitimately held when the edge was recorded)
        # — a half-applied release can't mint a phantom edge
        with _graph_lock:
            for i in range(len(held) - 1, -1, -1):
                lk = held[i][0]
                if held[i][4] in lk._stale:
                    lk._stale.discard(held[i][4])
                    held.pop(i)
            reentered = self._reentrant and any(e[0] is self for e in held)
            if held and not reentered:
                new_inversions = _note_edges_locked(self.name, site, held)
            if not reentered:
                self._holder = tok
        for rec in new_inversions:
            try:
                _metric_counter("inversion",
                                {"first": rec["first"],
                                 "then": rec["then"]}).add()
            except Exception:
                pass
            _audit_line("lock_inversion", rec)
            # the timeline record the alert plane's lock_inversion rule
            # watches. Lazy import + never-raises: the sanitizer must not
            # break (or import-cycle) the locked path it instruments
            try:
                from chubaofs_tpu_torch.utils import events

                events.emit("lock_inversion", events.SEV_CRITICAL,
                            entity=f"{rec['first']}->{rec['then']}",
                            detail=dict(rec))
            except Exception:
                pass
        held.append([self, self.name, time.monotonic(), site, tok])
        return True

    def release(self) -> None:
        held = _held_stack()
        entry = None
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                entry = held.pop(i)
                break
        if entry is None:
            # cross-thread handoff release: mark the acquirer's live token
            # stale so ITS next acquire drops exactly that entry — and do it
            # BEFORE the primitive is released, while no fresh acquirer can
            # install a live token we would wrongly stale (the dead token
            # surviving instead would mint phantom order edges)
            with _graph_lock:
                victim, self._holder = self._holder, None
                if victim is not None:
                    self._stale.add(victim)
            try:
                self._lock.release()
            except BaseException:
                # un-acquired RLock etc: the release failed, so the holder
                # is NOT dead — restore its tracking before propagating
                with _graph_lock:
                    if victim is not None:
                        self._stale.discard(victim)
                        if self._holder is None:
                            self._holder = victim
                raise
            return
        self._lock.release()
        with _graph_lock:
            # atomic check-and-clear: self._lock is already released, so a
            # new holder's token may land concurrently and must survive
            if entry[4] == self._holder:
                self._holder = None
        dt_ms = (time.monotonic() - entry[2]) * 1e3
        try:
            if self._summary is None:
                from chubaofs_tpu_torch.utils.exporter import registry

                self._summary = registry("lock").summary(
                    "hold_ms", {"name": self.name}, buckets=HOLD_BUCKETS)
            self._summary.observe(dt_ms)
        except Exception:
            pass
        if dt_ms >= hold_threshold_ms():
            rec = {"name": self.name, "hold_ms": round(dt_ms, 3),
                   "site": entry[3],
                   "thread": threading.current_thread().name}
            with _graph_lock:
                if len(_hold_outliers) < _HOLD_OUTLIER_MAX:
                    _hold_outliers.append(rec)
            _audit_line("lock_hold", rec)

    # -- lock API surface ---------------------------------------------------

    def locked(self) -> bool:
        return self._lock.locked() if hasattr(self._lock, "locked") else False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, et, ev, tb):
        self.release()
        return False

    def __repr__(self):
        return f"<SanitizedLock {self.name!r} wrapping {self._lock!r}>"


# -- report surface ------------------------------------------------------------


def inversions() -> list[dict]:
    """Every lock-order inversion observed so far (one record per pair)."""
    with _graph_lock:
        return list(_inversions)


def hold_outliers() -> list[dict]:
    """Holds that crossed CFS_LOCK_HOLD_MS (bounded window)."""
    with _graph_lock:
        return list(_hold_outliers)


def report() -> dict:
    """The soak/test rollup: inversions + hold outliers + graph size."""
    with _graph_lock:
        return {
            "inversions": list(_inversions),
            "hold_outliers": list(_hold_outliers),
            "locks_tracked": len(_order),
            "edges": sum(len(v) for v in _order.values()),
        }


def reset() -> None:
    """Forget the graph and all records (tests isolate themselves with
    this; per-thread held stacks are live state and stay)."""
    with _graph_lock:
        _order.clear()
        _edge_site.clear()
        _inversions.clear()
        _reported_pairs.clear()
        _hold_outliers.clear()
