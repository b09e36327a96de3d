"""SLO health plane — declarative objectives evaluated over metric history.

"Is the cluster healthy?" finally gets a machine answer: a small set of
declarative SLO specs (PUT/GET p99 latency, error rate, repair backlog,
evloop backpressure) evaluated over utils/metrichist.py's snapshot ring
with the multi-window burn-rate discipline of SRE alerting — a FAST window
(is it burning right now?) and a SLOW window (has it been burning long
enough to matter?):

    breach in both windows  -> failing   (sustained: page-worthy)
    breach in one window    -> degraded  (spiking or recovering)
    breach in neither       -> ok

Surfaced three ways, all from the same evaluation:

  * `/health` on every daemon (rpc/server.py mounts it next to /metrics):
    `{status, reasons, slos}` — always HTTP 200; machine clients read the
    status field, and the console's `/api/health` rollup treats a target
    that can't answer at all as FAILING rather than omitting it;
  * `cfs_slo_status{slo=...}` gauges (0 ok / 1 degraded / 2 failing) and a
    `cfs_slo_evaluations` counter, so SLO state is itself scrapeable and
    history'd;
  * `cfs-top` (tools/cfstop.py) renders the rollup live.

Thresholds are env knobs (CFS_SLO_*) read at evaluation time, so a test or
an operator can retune without a restart. An SLO with no data in the window
(no traffic, series absent on this role) evaluates to None and does NOT
breach — a quiet metanode is healthy, not unknown-unhealthy; reachability
is the console rollup's job.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from chubaofs_tpu_torch.utils.metrichist import (
    default_history, family_sum, hist_delta, hist_quantile, parse_key)

OK, DEGRADED, FAILING = "ok", "degraded", "failing"
RANK = {OK: 0, DEGRADED: 1, FAILING: 2}


@dataclass(frozen=True)
class SLO:
    """One objective: `kind` picks the evaluator, `family` the metric
    family, `threshold` the breach bound (value > threshold = breach)."""

    name: str
    # "hist_p99_ms" | "error_ratio" | "counter_rate" | "counter_ratio"
    # | "gauge_sum"
    kind: str
    family: str
    threshold: float
    # error_ratio denominator (a histogram family); counter_ratio
    # denominator (a plain counter family)
    ops_family: str = ""
    # label restriction: (label_key, (allowed values...)) — gauge_sum uses
    # it to keep live task states only, counter_ratio to slice BOTH
    # families down to one tenant's series (the per-tenant QoS SLOs)
    label_in: tuple = ()
    description: str = ""


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_n(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, "") or default))
    except ValueError:
        return default


# dynamic objective providers (name -> zero-arg callable returning [SLO]):
# subsystems whose objectives exist only when configured — the QoS plane's
# per-tenant throttle ratios — register here at arm time and unregister at
# teardown, and every /health evaluation picks them up live
_slo_providers: dict = {}


def register_slo_provider(name: str, fn) -> None:
    _slo_providers[name] = fn


def unregister_slo_provider(name: str) -> None:
    _slo_providers.pop(name, None)


def default_slos() -> list[SLO]:
    """The stock objectives, thresholds from env at call time. Families
    missing on a role (no access layer on a metanode) evaluate to None and
    never breach — one spec set serves every daemon."""
    err = _env_f("CFS_SLO_ERR_RATIO", 0.01)
    out = _base_slos(err)
    for fn in list(_slo_providers.values()):
        out.extend(fn())
    return out


def _base_slos(err: float) -> list[SLO]:
    return [
        SLO("put_p99", "hist_p99_ms", "cfs_access_put",
            _env_f("CFS_SLO_PUT_P99_MS", 2000.0),
            description="access PUT p99 latency (ms)"),
        SLO("get_p99", "hist_p99_ms", "cfs_access_get",
            _env_f("CFS_SLO_GET_P99_MS", 2000.0),
            description="access GET p99 latency (ms)"),
        SLO("put_errors", "error_ratio", "cfs_access_put_errors", err,
            ops_family="cfs_access_put", description="PUT error ratio"),
        SLO("get_errors", "error_ratio", "cfs_access_get_errors", err,
            ops_family="cfs_access_get", description="GET error ratio"),
        SLO("repair_backlog", "gauge_sum", "cfs_scheduler_tasks",
            _env_f("CFS_SLO_REPAIR_BACKLOG", 256.0),
            label_in=("state", ("prepared", "working")),
            description="repair tasks outstanding (prepared+working)"),
        SLO("evloop_backpressure", "counter_rate", "cfs_evloop_backpressure",
            _env_f("CFS_SLO_BP_RATE", 16.0),
            description="evloop read-pause events/s"),
        # cache plane: sustained miss ratio above threshold means
        # the zipfian hot head is NOT being absorbed — admission broken,
        # budget too small, or an invalidation storm. Absent families (no
        # cache configured on this role) evaluate to None and never breach.
        SLO("cache_miss_ratio", "counter_ratio", "cfs_cache_misses",
            _env_f("CFS_SLO_CACHE_MISS", 0.95),
            ops_family="cfs_cache_lookups",
            description="block-cache miss ratio (misses/lookups)"),
    ]


# -- per-window evaluators -----------------------------------------------------


def _restart_delta(first: dict, last: dict, family: str,
                   label_in: tuple = ()) -> float:
    """Counter-family window delta under the restart contract shared with
    metrichist.rates() / hist_delta / cfs-stat: a total that went DOWN
    means the daemon restarted, and the post-restart total IS the delta —
    clamping to zero would read a restarting-and-erroring daemon as clean
    exactly when it most needs watching."""
    end = family_sum(last, family, label_in)
    d = end - family_sum(first, family, label_in)
    return end if d < 0 else d


def _eval_window(slo: SLO, window: list[dict],
                 worst: bool = False) -> float | None:
    """The SLO's value over one snapshot window; None = no data (series
    absent, zero traffic, no window yet).

    Flow kinds (latency, error ratio, rate) need a DELTA, so they need at
    least two snapshots: a single snapshot only offers process-lifetime
    totals, and lifetime is not a burn window — one error-burst an hour
    after boot would read as "failing NOW" forever, and a just-booted
    daemon would inherit a verdict from traffic that predates the poller.
    Until the second snapshot lands, flow SLOs report None (no data).
    Gauge kinds carry state, not flow, and evaluate from one snapshot."""
    if not window:
        return None
    last = window[-1]["metrics"]
    first = window[0]["metrics"]
    if slo.kind == "hist_p99_ms":
        if len(window) < 2:
            return None
        buckets, count = hist_delta(first, last, slo.family)
        q = hist_quantile(buckets, count, 0.99)
        return None if q is None else q * 1e3  # exporter buckets are seconds
    if slo.kind == "error_ratio":
        if len(window) < 2:
            return None
        errs = _restart_delta(first, last, slo.family)
        _, ops = hist_delta(first, last, slo.ops_family)
        if ops <= 0:
            return None if errs <= 0 else 1.0  # errors with zero completions
        return errs / ops
    if slo.kind == "counter_ratio":
        # two plain counter families, numerator over denominator (the cache
        # miss-ratio shape); same restart contract as error_ratio. label_in
        # slices BOTH families (per-tenant QoS throttle ratios)
        if len(window) < 2:
            return None
        num = _restart_delta(first, last, slo.family, slo.label_in)
        den = _restart_delta(first, last, slo.ops_family, slo.label_in)
        if den <= 0:
            return None  # no lookups in the window: a quiet cache is healthy
        return num / den
    if slo.kind == "counter_rate":
        if len(window) < 2:
            return None
        dt = window[-1]["mono"] - window[0]["mono"]
        if dt <= 0:
            return None
        return _restart_delta(first, last, slo.family) / dt
    if slo.kind == "gauge_sum":
        def keep(key: str) -> bool:
            name, labels = parse_key(key)
            if name != slo.family:
                return False
            if slo.label_in:
                lk, allowed = slo.label_in
                return labels.get(lk) in allowed
            return True

        if not any(keep(k) for k in last):
            return None
        # gauges carry state, not flow: the FAST window is the backlog NOW
        # (latest snapshot — a drained spike is over); only the SLOW window
        # (worst=True) takes the worst snapshot, so a sustained-high backlog
        # that dips at poll time still registers as burning
        per_snap = [sum(v for k, v in s["metrics"].items() if keep(k))
                    for s in window]
        return max(per_snap) if worst else per_snap[-1]
    raise ValueError(f"unknown SLO kind {slo.kind!r}")


# last published status per SLO name, for flip detection. Module state on
# purpose: ONE judgment stream per process — the /health evaluation path
# (health_report) owns it. Secondary evaluators over their own snapshot
# windows (the alert plane's slo_failing rule, soak probes) pass
# track_flips=False, or each pass would flip the shared stream back and
# forth and spray spurious slo_flip pairs onto the timeline.
_last_status: dict[str, str] = {}


def evaluate(slos: list[SLO], snaps: list[dict],
             fast_n: int | None = None, slow_n: int | None = None,
             track_flips: bool = True, publish: bool = True) -> dict:
    """Evaluate every SLO over the fast (last CFS_SLO_FAST_N snapshots) and
    slow (last CFS_SLO_SLOW_N) windows; returns the /health payload and
    (with publish, the serving-path default) the cfs_slo_* metrics. With
    track_flips (the /health stream), status CHANGES (ok<->degraded<->
    failing) land on the event timeline as `slo_flip`, emitted once per
    transition. A PRIVATE evaluator over its own snapshot windows (a soak
    probe's slo_failing rule) passes publish=False + track_flips=False so
    it neither clobbers the shared cfs_slo_status gauges nor ping-pongs the
    flip stream."""
    from chubaofs_tpu_torch.utils.exporter import registry

    fast_n = fast_n or _env_n("CFS_SLO_FAST_N", 3)
    slow_n = slow_n or _env_n("CFS_SLO_SLOW_N", 12)
    reg = registry("slo")
    out: dict[str, dict] = {}
    reasons: list[str] = []
    worst = OK
    # "breach in both windows" only means SUSTAINED when the slow window
    # actually extends beyond the fast one; on a young ring (or fast_n >=
    # slow_n) the two windows are the same snapshots and a single spike
    # would trivially "breach both" — cap that at degraded until the slow
    # window has independent evidence
    fast_win = snaps[-fast_n:]
    slow_win = snaps[-slow_n:]
    sustained_provable = len(slow_win) > len(fast_win)
    flips: list[tuple[SLO, str, str, float | None, float | None]] = []
    for slo in slos:
        v_fast = _eval_window(slo, fast_win)
        v_slow = _eval_window(slo, slow_win, worst=True)
        b_fast = v_fast is not None and v_fast > slo.threshold
        b_slow = v_slow is not None and v_slow > slo.threshold
        status = FAILING if (b_fast and b_slow and sustained_provable) else (
            DEGRADED if (b_fast or b_slow) else OK)
        out[slo.name] = {
            "status": status, "threshold": slo.threshold,
            "fast": None if v_fast is None else round(v_fast, 6),
            "slow": None if v_slow is None else round(v_slow, 6),
            "description": slo.description,
        }
        if status != OK:
            reasons.append(
                f"{slo.name}: fast={v_fast if v_fast is None else round(v_fast, 3)}"
                f" slow={v_slow if v_slow is None else round(v_slow, 3)}"
                f" > {slo.threshold} ({status})")
        if RANK[status] > RANK[worst]:
            worst = status
        if publish:
            reg.gauge("status", {"slo": slo.name}).set(RANK[status])
        if track_flips:
            prev = _last_status.get(slo.name)
            if prev is not None and prev != status:
                flips.append((slo, prev, status, v_fast, v_slow))
            _last_status[slo.name] = status
    if publish:
        reg.counter("evaluations").add()
    for slo, prev, status, v_fast, v_slow in flips:
        from chubaofs_tpu_torch.utils import events

        sev = (events.SEV_CRITICAL if status == FAILING else
               events.SEV_WARNING if status == DEGRADED else events.SEV_INFO)
        events.emit("slo_flip", sev, entity=slo.name,
                    detail={"from": prev, "to": status,
                            "fast": v_fast, "slow": v_slow,
                            "threshold": slo.threshold})
    return {"status": worst, "reasons": reasons, "slos": out}


def health_report(fast_n: int | None = None,
                  slow_n: int | None = None) -> dict:
    """The /health payload for THIS process. When the periodic recorder
    isn't armed, each call records a snapshot first — polling /health then
    IS the history feed (bounded by the ring), so the burn windows fill at
    the poller's cadence instead of needing a second config knob."""
    hist = default_history()
    if not hist.armed:
        hist.record()
    snaps = hist.snapshots()
    rep = evaluate(default_slos(), snaps, fast_n=fast_n, slow_n=slow_n)
    rep["snapshots"] = len(snaps)
    return rep
