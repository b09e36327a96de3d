"""Metric history — a bounded in-process ring of registry snapshots.

`cfs-stat` can diff two hand-timed scrapes, but nothing in a daemon
remembers what its counters looked like a minute ago — so every dashboard
re-derives deltas client-side and a p99 regression that happened before the
operator attached is simply gone. This module keeps the short-term memory:
a deque of periodic `exporter.render_all()` snapshots (parsed back into the
exact `name{labels} -> value` keys a scraper sees, so history keys and
scrape keys can never drift), plus server-side `rate()` over adjacent
snapshots — monotonic families only, with counter-reset clamping — served
by the `/metrics/history` side-door rpc/server.py mounts next to /metrics.

Discipline (mirrors utils/profiler.py and the lock sanitizer):

  * **Disarmed (CFS_METRIC_HIST_S unset): zero overhead.** No recorder
    thread, nothing snapshotted, `activate_from_env()` touches nothing.
  * **Armed:** one `cfs-methist` thread records every CFS_METRIC_HIST_S
    seconds into a CFS_METRIC_HIST_LEN-bounded ring (default 240 — an hour
    at 15 s).
  * Either way `record()` works on demand: the SLO evaluator (utils/slo.py)
    snapshots per /health poll when the recorder isn't armed, so health is
    poll-driven history rather than a second bespoke pipeline.

The exposition-key helpers at the bottom (parse_key / histogram deltas /
bucket quantiles) are shared by utils/slo.py and tools/cfstop.py — one
implementation of "p99 from bucket deltas", so the health plane and the
dashboard can never disagree about what a latency window means.
"""

from __future__ import annotations

import collections
import os
import re
import threading
import time

from chubaofs_tpu_torch.utils.locks import SanitizedLock

_ENV_PERIOD = "CFS_METRIC_HIST_S"
_ENV_LEN = "CFS_METRIC_HIST_LEN"
DEFAULT_LEN = 240


def env_period() -> float:
    """Armed snapshot period, 0.0 when disarmed/malformed (a typo'd env var
    must not kill daemon boot)."""
    try:
        p = float(os.environ.get(_ENV_PERIOD, "") or 0.0)
    except ValueError:
        return 0.0
    return p if p > 0.0 else 0.0


def enabled() -> bool:
    return env_period() > 0.0


def _env_len() -> int:
    try:
        n = int(os.environ.get(_ENV_LEN, "") or DEFAULT_LEN)
    except ValueError:
        return DEFAULT_LEN
    return max(2, n)


class MetricHistory:
    """The ring. Snapshots are dicts: ts (wall, display), mono (monotonic —
    every rate/window delta uses THIS, never the jumpable wall clock),
    metrics (key -> value), types (family -> kind, for monotonicity)."""

    def __init__(self, maxlen: int | None = None, period_s: float = 0.0):
        self.period_s = float(period_s)
        self._ring: collections.deque = collections.deque(
            maxlen=maxlen or _env_len())
        self._lock = SanitizedLock(name="metrichist.ring")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def armed(self) -> bool:
        return self._thread is not None

    # -- ingest ----------------------------------------------------------------

    def record(self) -> dict:
        """Snapshot the whole process registry set now; returns the record.
        Render+parse round-trips through the text exposition on purpose:
        the history's keys are BY CONSTRUCTION the keys a scraper sees."""
        from chubaofs_tpu_torch.tools.cfsstat import parse_metrics, parse_types
        from chubaofs_tpu_torch.utils.exporter import render_all

        text = render_all()
        snap = {"ts": time.time(), "mono": time.monotonic(),
                "metrics": parse_metrics(text), "types": parse_types(text)}
        with self._lock:
            self._ring.append(snap)
        return snap

    def start(self) -> "MetricHistory":
        """Start the periodic recorder (idempotent; restartable after
        stop() — a stale stop flag would spawn a thread that exits on its
        first wait while `armed` still read True, silently freezing the
        feed /health trusts)."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cfs-methist")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.period_s or 15.0):
            try:
                self.record()
            except Exception:
                pass  # one bad render must not kill the recorder

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- queries ---------------------------------------------------------------

    def snapshots(self, n: int = 0) -> list[dict]:
        """The newest n snapshots (0 = all), oldest first."""
        with self._lock:
            snaps = list(self._ring)
        return snaps[-n:] if n > 0 else snaps

    def query(self, n: int = 30, flt: str = "", rate: bool = False) -> dict:
        """The /metrics/history response shape: snapshots (optionally
        name-filtered) and, with rate=True, per-adjacent-pair rates."""
        snaps = self.snapshots(n)

        def keep(metrics: dict) -> dict:
            if not flt:
                return metrics
            return {k: v for k, v in metrics.items() if flt in k}

        out = {
            "period_s": self.period_s,
            "count": len(snaps),
            "snapshots": [{"ts": s["ts"], "mono": s["mono"],
                           "metrics": keep(s["metrics"])} for s in snaps],
        }
        if rate:
            out["rates"] = [
                {"ts": r["ts"], "interval_s": r["interval_s"],
                 "rates": keep(r["rates"])} for r in rates(snaps)]
        return out


def rates(snaps: list[dict]) -> list[dict]:
    """Server-side rate(): per adjacent snapshot pair, per-second deltas of
    every MONOTONIC series (counters + histogram _bucket/_count/_sum) present
    in both. A negative delta means the daemon restarted between snapshots —
    the counter restarted from zero, so the whole post-restart value IS the
    delta (clamping, the same contract as cfs-stat's restart tag). Gauges
    are excluded: their current value is the signal, not their derivative."""
    out = []
    for prev, cur in zip(snaps, snaps[1:]):
        dt = cur["mono"] - prev["mono"]
        if dt <= 0:
            continue
        types = cur.get("types") or prev.get("types") or {}
        rr: dict[str, float] = {}
        pm = prev["metrics"]
        for key, v in cur["metrics"].items():
            if not is_monotonic(key, types) or key not in pm:
                continue
            d = v - pm[key]
            if d < 0:
                d = v  # restart: the series restarted from zero
            rr[key] = round(d / dt, 6)
        out.append({"ts": cur["ts"], "interval_s": round(dt, 6), "rates": rr})
    return out


# -- process-wide default ------------------------------------------------------

_default: MetricHistory | None = None
_lock = threading.Lock()


def default_history() -> MetricHistory:
    """The process history ring, created on first use (recorder NOT started
    — start() / activate_from_env() does that)."""
    global _default
    with _lock:
        if _default is None:
            _default = MetricHistory(period_s=env_period())
        return _default


def activate_from_env() -> MetricHistory | None:
    """Arm the periodic recorder iff CFS_METRIC_HIST_S asks for it — the
    daemon-boot hook. Unset env = return the existing object (maybe None)
    having started nothing: the zero-overhead gate."""
    if not enabled():
        return _default
    return default_history().start()


def deactivate() -> None:
    """Stop + forget the process ring (test isolation)."""
    global _default
    with _lock:
        h, _default = _default, None
    if h is not None:
        h.stop()


# -- exposition-key helpers (shared by slo.py and cfs-top) ---------------------

_LABELS = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_key(key: str) -> tuple[str, dict[str, str]]:
    """`name{a="x",b="y"}` -> (name, {a: x, b: y}); unescapes label values."""
    name, brace, rest = key.partition("{")
    if not brace:
        return key, {}
    labels = {m.group(1): m.group(2).replace('\\"', '"')
              .replace("\\n", "\n").replace("\\\\", "\\")
              for m in _LABELS.finditer(rest)}
    return name, labels


def family_sum(metrics: dict[str, float], family: str,
               label_in: tuple = ()) -> float:
    """Sum one family's value across its label sets (exact name match) —
    the shared flat-series aggregator slo.py and cfs-top both use, so the
    health plane and the dashboard can never disagree on what a counter
    family's total means. `label_in` = (label_key, (allowed values...))
    restricts the sum to matching series — the per-tenant SLO slice."""
    if not label_in:
        return sum(v for k, v in metrics.items() if parse_key(k)[0] == family)
    lk, allowed = label_in
    total = 0.0
    for k, v in metrics.items():
        name, labels = parse_key(k)
        if name == family and labels.get(lk) in allowed:
            total += v
    return total


def family_of(key: str) -> tuple[str, str]:
    """Series key -> (family, suffix): histogram children map back to their
    family name (`x_bucket`/`x_sum`/`x_count` -> `x`), everything else is
    its own family with no suffix."""
    name, _ = parse_key(key)
    for sfx in ("_bucket", "_sum", "_count"):
        if name.endswith(sfx):
            return name[: -len(sfx)], sfx
    return name, ""


def is_monotonic(key: str, types: dict[str, str]) -> bool:
    """Does this series only ever go up (modulo restarts)? Counters and
    histogram children are; gauges (incl. the `_max` companions) are not.
    Unknown families are NOT monotonic — never clamp what we can't type."""
    fam, sfx = family_of(key)
    if sfx:  # _bucket/_sum/_count of a histogram family
        return types.get(fam) == "histogram"
    return types.get(fam) == "counter"


def hist_totals(metrics: dict[str, float],
                family: str) -> tuple[dict[float, float], float]:
    """Aggregate one histogram family across its label sets: cumulative
    bucket totals by `le` (finite buckets only) and the total count."""
    buckets: dict[float, float] = {}
    count = 0.0
    bucket_name, count_name = family + "_bucket", family + "_count"
    for key, v in metrics.items():
        name, labels = parse_key(key)
        if name == bucket_name:
            le = labels.get("le", "")
            if le and le != "+Inf":
                try:
                    buckets[float(le)] = buckets.get(float(le), 0.0) + v
                except ValueError:
                    continue
        elif name == count_name:
            count += v
    return buckets, count


def hist_delta(m0: dict[str, float], m1: dict[str, float],
               family: str) -> tuple[dict[float, float], float]:
    """Window delta of a histogram family (m0 older, m1 newer). A count
    that went DOWN means the daemon restarted inside the window — the
    post-restart totals ARE the window's delta (the same restart contract
    as rates() and cfs-stat's `(restart)` tag; clamping to zero instead
    would blank the latency/error SLOs for a whole slow window right when
    a restarting daemon most needs watching). m0 may be empty ({}): the
    delta is then the all-time totals."""
    b0, c0 = hist_totals(m0, family)
    b1, c1 = hist_totals(m1, family)
    if c1 < c0:
        return b1, c1
    db = {le: max(0.0, v - b0.get(le, 0.0)) for le, v in b1.items()}
    return db, c1 - c0


def hist_quantile(buckets: dict[float, float], count: float,
                  q: float) -> float | None:
    """Bucket-resolution quantile over CUMULATIVE bucket deltas: the upper
    bound of the bucket holding the q-th sample (exporter.Summary.quantile's
    math, applied to a window delta). None when the window saw no samples;
    samples beyond the last finite bucket report that bucket's bound (the
    floor of the true value — still enough to breach any threshold below
    it)."""
    if count <= 0 or not buckets:
        return None
    rank = q * count
    last = None
    for le in sorted(buckets):
        last = le
        if buckets[le] >= rank:
            return le
    return last
