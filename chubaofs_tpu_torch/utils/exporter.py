"""Metrics exporter — Prometheus-style registry + text exposition + TP timers.

Reference counterpart: util/exporter/exporter.go:31-42,100 (Prometheus registry
with namespace `cfs_{cluster}_{module}`, Counter/Gauge/TP metric kinds,
optional Consul self-registration via util/exporter/consul_register.go) and the
UMP-style TP counters wrapped by exporter.NewTPCnt (metanode/manager.go:109).
Design kept: a process-global registry, metrics keyed by (name, sorted labels),
`NewTPCnt`-style timers that record both a count and latency; the render format
is the Prometheus text format so any scraper can consume it. Consul
registration is represented by a registration record (host/port/path) the
deployment can act on — no live agent in this environment.

Role registries: every daemon subsystem owns a module registry obtained via
`registry("raft")`, `registry("codec")`, ... — namespaced `cfs_<module>_` so
one scrape of a daemon's /metrics (which renders `render_all()`) tells which
role each sample came from. Summaries carry fixed histogram buckets so p50/p99
are renderable downstream (the UMP TP logs' aggregation, done in-process).
"""

from __future__ import annotations

import bisect
import threading
import time

# fixed latency buckets (seconds): sub-ms to 10s, the span client ops cover
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# size/count buckets for batch-occupancy summaries (raft drain, codec batches)
BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
# buckets for values in [0, 1] (overlap/occupancy ratios) — count buckets
# would dump every ratio into the first bucket and flatten the histogram
RATIO_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


def _key(name: str, labels: dict[str, str] | None) -> tuple:
    return (name, tuple(sorted((labels or {}).items())))


# -- bounded label values (the runtime half of obslint rule 1) -----------------
#
# A label like `tenant` is legitimate ONLY while its value set is closed: one
# request-derived string per series turns /metrics into a memory leak. A
# subsystem that mints per-tenant families declares the closed set up front
# (declare_label_values); any metric call carrying that key with an
# undeclared value then fails loudly instead of silently growing the registry.

_BOUNDED_LABELS: dict[str, frozenset] = {}
_bounded_lock = threading.Lock()


def declare_label_values(key: str, values) -> None:
    """Register the closed value set for a label key (e.g. the configured
    tenant ids). Re-declaring replaces the set; `values=None` removes the
    restriction (test teardown)."""
    with _bounded_lock:
        if values is None:
            _BOUNDED_LABELS.pop(key, None)
        else:
            _BOUNDED_LABELS[key] = frozenset(str(v) for v in values)


def _check_bounded(labels: dict | None) -> None:
    if not labels or not _BOUNDED_LABELS:
        return  # the common daemon: nothing declared, zero overhead
    for k, v in labels.items():
        allowed = _BOUNDED_LABELS.get(k)
        if allowed is not None and str(v) not in allowed:
            raise ValueError(
                f"label {k}={v!r} is outside its declared bounded set "
                f"({len(allowed)} values) — an unbounded {k} string would "
                "mint a fresh series per value (high-cardinality guard); "
                "declare it via exporter.declare_label_values or use a "
                "bounded id")


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def add(self, v: float = 1.0):
        with self._lock:
            self.value += v


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self.value = float(v)


class Summary:
    """Latency summary: count, sum, max — the shape UMP TP logs report
    (util/ump/ump.go:76-92 logs elapsed micros per key) — PLUS fixed
    histogram buckets so a scraper can render p50/p99 without raw samples."""

    __slots__ = ("count", "sum", "max", "buckets", "bucket_counts", "_lock")

    def __init__(self, buckets: tuple = DEFAULT_BUCKETS):
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * len(self.buckets)
        self._lock = threading.Lock()

    def observe(self, value: float):
        with self._lock:
            self.count += 1
            self.sum += value
            if value > self.max:
                self.max = value
            i = bisect.bisect_left(self.buckets, value)
            if i < len(self.bucket_counts):
                self.bucket_counts[i] += 1

    def snapshot(self) -> dict:
        """Consistent copy (no torn reads across count/sum/buckets)."""
        with self._lock:
            return {"count": self.count, "sum": self.sum, "max": self.max,
                    "buckets": dict(zip(self.buckets, self.bucket_counts))}

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket holding the
        q-th sample); inf-bucket samples report the observed max."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = q * self.count
            seen = 0
            for b, c in zip(self.buckets, self.bucket_counts):
                seen += c
                if seen >= rank:
                    return b
            return self.max


class TPObject:
    """exporter.NewTPCnt analog: time an op, count it, flag errors."""

    def __init__(self, registry: "Registry", name: str, labels: dict | None):
        self.registry = registry
        self.name = name
        self.labels = labels
        self.start = time.perf_counter()

    def set(self, err: Exception | None = None):
        elapsed = time.perf_counter() - self.start
        self.registry.summary(self.name, self.labels).observe(elapsed)
        if err is not None:
            self.registry.counter(self.name + "_errors", self.labels).add()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.set(ev if isinstance(ev, Exception) else None)
        return False


class Registry:
    def __init__(self, cluster: str = "cfs", module: str = ""):
        self.namespace = "_".join(x for x in ("cfs", cluster, module) if x)
        self._metrics: dict[tuple, object] = {}
        # metric-family kind, keyed per NAME and set for every family (not
        # just the first label set) — and conflict-checked, so one name can
        # never render half counter / half histogram
        self._kinds: dict[str, str] = {}
        self._lock = threading.Lock()
        self.consul_registration: dict | None = None

    def _get(self, kind: str, name: str, labels, factory):
        _check_bounded(labels)
        k = _key(name, labels)
        with self._lock:
            have = self._kinds.get(name)
            if have is not None and have != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {have}, not {kind}")
            m = self._metrics.get(k)
            if m is None:
                m = self._metrics[k] = factory()
                self._kinds[name] = kind
            return m

    def counter(self, name: str, labels: dict | None = None) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, labels: dict | None = None) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def summary(self, name: str, labels: dict | None = None,
                buckets: tuple | None = None) -> Summary:
        m = self._get("summary", name, labels,
                      lambda: Summary(buckets or DEFAULT_BUCKETS))
        if buckets is not None:
            want = tuple(sorted(float(b) for b in buckets))
            if m.buckets != want:
                # same family, different bucket spec: the earlier creator
                # (possibly a bucket-less reader that minted the defaults)
                # fixed the layout — mis-bucketing silently would render a
                # wrong histogram, so fail loudly instead
                raise ValueError(
                    f"summary {name!r} exists with buckets {m.buckets}, "
                    f"caller wants {want}")
        return m

    def tp(self, name: str, labels: dict | None = None) -> TPObject:
        """Start a TP timer; call .set(err) or use as a context manager."""
        return TPObject(self, name, labels)

    def unregister(self, name: str, labels: dict | None = None) -> None:
        """Drop one metric (a closed component's series must not render as
        a live idle one forever). The family kind stays reserved."""
        with self._lock:
            self._metrics.pop(_key(name, labels), None)

    def register_consul(self, addr: str, port: int, path: str = "/metrics"):
        """util/exporter/consul_register.go analog — record the registration."""
        self.consul_registration = {"addr": addr, "port": port, "path": path}

    def render(self) -> str:
        """Prometheus text exposition of every metric in the registry:
        one `# TYPE` header per family (counter/gauge/histogram), histogram
        buckets cumulative with an explicit +Inf, `_sum`/`_count`, and the
        UMP-style `_max` as its own gauge family."""

        def esc(v) -> str:
            # label-value escaping per the text format: one hostile value
            # (e.g. a volume named 'a"b') must not invalidate the whole
            # scrape for every other metric
            return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def lab_str(labels, extra: list[tuple[str, str]] = ()) -> str:
            pairs = list(labels) + list(extra)
            if not pairs:
                return ""
            return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in pairs) + "}"

        with self._lock:
            items = sorted(self._metrics.items())
            kinds = dict(self._kinds)
        lines: list[str] = []
        max_lines: dict[str, list[str]] = {}  # histogram family -> _max gauges
        typed: set[str] = set()
        for (name, labels), m in items:
            full = f"{self.namespace}_{name}"
            kind = kinds.get(name, "gauge")
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {full} "
                             f"{'histogram' if kind == 'summary' else kind}")
            lab = lab_str(labels)
            if isinstance(m, Summary):
                snap = m.snapshot()
                cum = 0
                for b, c in snap["buckets"].items():
                    cum += c
                    lines.append(
                        f"{full}_bucket{lab_str(labels, [('le', repr(b))])} {cum}")
                lines.append(
                    f"{full}_bucket{lab_str(labels, [('le', '+Inf')])} "
                    f"{snap['count']}")
                lines.append(f"{full}_sum{lab} {snap['sum']}")
                lines.append(f"{full}_count{lab} {snap['count']}")
                max_lines.setdefault(full, []).append(
                    f"{full}_max{lab} {snap['max']}")
            else:
                lines.append(f"{full}{lab} {m.value}")
        for full, mlines in max_lines.items():
            lines.append(f"# TYPE {full}_max gauge")
            lines.extend(mlines)
        return "\n".join(lines) + "\n" if lines else ""


_default = Registry()
_registries: dict[str, Registry] = {}
_reg_lock = threading.Lock()


def default_registry() -> Registry:
    return _default


def registry(module: str) -> Registry:
    """The role/module registry (namespace `cfs_<module>_`), shared
    process-wide — raft, codec, access, blobnode, metanode, datanode, ...
    each own one, and every daemon's /metrics renders them all."""
    with _reg_lock:
        r = _registries.get(module)
        if r is None:
            r = _registries[module] = Registry(cluster="", module=module)
        return r


def render_all() -> str:
    """Every registry in the process: the default one plus each module's —
    what a daemon's /metrics endpoint serves."""
    with _reg_lock:
        regs = [_default] + [_registries[m] for m in sorted(_registries)]
    return "".join(r.render() for r in regs)


def dump(path: str) -> str:
    """Write the full exposition snapshot to `path` (bench/perfbench drop
    one next to their BENCH_*.json lines); returns the rendered text."""
    text = render_all()
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return text


def init(cluster: str, module: str) -> Registry:
    """Re-namespace the process-global registry (exporter.Init analog)."""
    global _default
    _default = Registry(cluster, module)
    return _default
