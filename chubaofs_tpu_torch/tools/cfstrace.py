"""cfs-trace — fetch persisted spans, render one trace, attribute its time.

The analysis half of the trace sink (utils/tracesink.py): span records are
flat JSON lines; this tool reassembles the hop tree (parent span ids link
in-process children; the carrier's span id links cross-process hops), renders
it as a WATERFALL or text FLAMEGRAPH, and runs the CRITICAL-PATH analyzer —
projecting every named stage (encode host/device ms, raft commit wait, shard
fan-out, pool checkout) onto the root span's wall time so "what fraction of
this PUT was encode vs raft vs wire?" has a printable answer. `--top`
aggregates per-hop p50/p99 over the recent-trace window instead.

Span sources, in precedence order: `--addr` targets' `/traces` side-doors
(repeatable — point it at every daemon of a localcluster, or once at a
console, whose `/api/trace` collector already fans out), or `--dir`, a trace
sink directory read straight from its rotor files.

Usage:
    cfs-trace <trace-id> --addr 127.0.0.1:9500 --addr 127.0.0.1:9600
    cfs-trace <trace-id> --dir /tmp/cfs-traces-1234 --flame
    cfs-trace --top --addr 127.0.0.1:9500
    cfs-trace --prof 5 --addr 127.0.0.1:9500   # stack-based profile

`--prof N` is the stack-sampled companion to the span-based flamegraph: it
asks the first --addr's `/debug/prof?seconds=N` side-door (utils/profiler)
for an on-demand capture and prints the collapsed-stack lines — the same
`path;to;frame <count>` format `--flame` emits for spans, so both feed the
same downstream renderers (flamegraph.pl, speedscope).

Also a library: build_tree / critical_path / waterfall / flamegraph /
aggregate are what the acceptance tests drive.
"""

from __future__ import annotations

import json
import os
import sys

# the one sweep-line interval union + overlap-ratio math both overlap
# consumers share (the scheduler's repair overlap ratio rides the same
# functions, so the dashboard metric and this CLI can never drift)
from chubaofs_tpu_torch.blobstore.trace import intersect_len as _intersect
from chubaofs_tpu_torch.blobstore.trace import overlap_ratio as _overlap_ratio
from chubaofs_tpu_torch.blobstore.trace import union_len as _union

BAR_WIDTH = 40


# -- tree assembly -------------------------------------------------------------


def build_tree(records: list[dict]) -> tuple[list[dict], dict[str, list[dict]]]:
    """Flat span records -> (roots, children-by-parent-id). Spans whose
    parent never made it into the record set (dropped by sampling on one
    daemon, rotated out) surface as roots — a partial tree still renders."""
    by_id = {r["span_id"]: r for r in records if r.get("span_id")}
    children: dict[str, list[dict]] = {}
    roots: list[dict] = []
    for rec in sorted(records, key=lambda r: r.get("start", 0.0)):
        pid = rec.get("parent_span_id")
        if pid and pid != rec.get("span_id") and pid in by_id:
            children.setdefault(pid, []).append(rec)
        else:
            roots.append(rec)
    return roots, children


def _span_interval(rec: dict) -> tuple[float, float]:
    s = float(rec.get("start", 0.0))
    return s, s + rec.get("dur_us", 0) / 1e6


def _pick_root(records: list[dict], root_op: str | None) -> dict | None:
    roots, _ = build_tree(records)
    if root_op is not None:
        named = [r for r in records if r.get("op") == root_op]
        if named:
            return max(named, key=lambda r: r.get("dur_us", 0))
        return None
    if not roots:
        return None
    return max(roots, key=lambda r: r.get("dur_us", 0))


# -- critical path -------------------------------------------------------------


def critical_path(records: list[dict], root_op: str | None = None) -> dict:
    """Attribute the root span's wall time to named stages.

    Contributions, all projected (clipped) onto the root's wall interval:
      * every stage of the root and its descendants, under the stage name;
      * every DESCENDANT span's own interval, under `span:<op>` — so a hop
        that recorded no finer stages still attributes as itself.
    Coverage is the wall-clock UNION of all contributions over the root
    duration — overlap (a pipelined window, a shared codec batch) never
    counts twice, which is what makes "≥95% attributed" a real claim.
    Per-stage milliseconds are each name's own union (parallel shards of one
    stage don't double-count; different names may overlap by design)."""
    root = _pick_root(records, root_op)
    if root is None:
        return {"error": "no spans" if not records else
                f"no span with op {root_op!r}"}
    t0, t1 = _span_interval(root)
    _, children = build_tree(records)

    per_name: dict[str, list[tuple[float, float]]] = {}

    def clip(s: float, e: float) -> tuple[float, float] | None:
        s, e = max(s, t0), min(e, t1)
        return (s, e) if e > s else None

    def add_stages(rec: dict):
        base = float(rec.get("start", 0.0))
        for name, off_us, dur_us in rec.get("stages", ()):
            iv = clip(base + off_us / 1e6, base + (off_us + dur_us) / 1e6)
            if iv:
                per_name.setdefault(str(name), []).append(iv)

    seen: set[str] = set()

    def visit(rec: dict, is_root: bool):
        sid = rec.get("span_id")
        if sid in seen:
            return  # defensive: a cyclic/duplicated record set must not hang
        seen.add(sid)
        add_stages(rec)
        if not is_root:
            iv = clip(*_span_interval(rec))
            if iv:
                per_name.setdefault(f"span:{rec.get('op', '?')}", []).append(iv)
        for ch in children.get(sid, ()):
            visit(ch, False)

    visit(root, True)

    wall = t1 - t0
    stages = sorted(
        ({"stage": name, "ms": round(_union(ivs) * 1e3, 3),
          "calls": len(ivs)} for name, ivs in per_name.items()),
        key=lambda s: -s["ms"])
    covered = _union([iv for ivs in per_name.values() for iv in ivs])
    return {
        "trace_id": root.get("trace_id"),
        "root_op": root.get("op"),
        "root_span_id": root.get("span_id"),
        "wall_ms": round(wall * 1e3, 3),
        "attributed_ms": round(covered * 1e3, 3),
        "unattributed_ms": round(max(0.0, wall - covered) * 1e3, 3),
        "coverage": round(covered / wall, 4) if wall > 0 else 0.0,
        "spans": len(records),
        "stages": stages,
    }


def stage_overlap(records: list[dict], a: str, b: str) -> dict:
    """How much two stage families of a trace ran CONCURRENTLY: collect the
    intervals of every stage whose name matches `a` (exact or prefix — pass
    "codec." to cover codec.host+codec.device) and likewise `b`, then
    measure the intersection of the two interval unions. `ratio` is that
    intersection over the SMALLER union — 1.0 means the lesser stage was
    entirely hidden behind the greater (perfect pipelining), 0.0 means they
    ran back-to-back. The repair plane's download/decode overlap proof."""

    def intervals(prefix: str) -> list[tuple[float, float]]:
        out = []
        for rec in records:
            base = float(rec.get("start", 0.0))
            for name, off_us, dur_us in rec.get("stages", ()):
                if name == prefix or str(name).startswith(prefix):
                    s = base + off_us / 1e6
                    out.append((s, s + dur_us / 1e6))
        return out

    ia, ib = intervals(a), intervals(b)
    ratio = _overlap_ratio(ia, ib)
    return {
        "a": a, "b": b,
        "a_ms": round(_union(ia) * 1e3, 3), "b_ms": round(_union(ib) * 1e3, 3),
        "overlap_ms": round(_intersect(ia, ib) * 1e3, 3),
        "ratio": 0.0 if ratio is None else round(ratio, 4),
    }


# -- renderers -----------------------------------------------------------------


def _bar(t0: float, t1: float, s: float, e: float, ch: str = "#") -> str:
    """A BAR_WIDTH-wide timeline bar for [s, e) inside [t0, t1)."""
    if t1 <= t0:
        return " " * BAR_WIDTH
    lo = int((max(s, t0) - t0) / (t1 - t0) * BAR_WIDTH)
    hi = int((min(e, t1) - t0) / (t1 - t0) * BAR_WIDTH + 0.9999)
    lo = min(max(lo, 0), BAR_WIDTH)
    hi = min(max(hi, lo + 1), BAR_WIDTH)
    return " " * lo + ch * (hi - lo) + " " * (BAR_WIDTH - hi)


def waterfall(records: list[dict], stages: bool = True) -> str:
    """One trace as an offset-aligned text waterfall: spans as '#' bars in
    tree order (indent = depth), their named stages as '-' sub-bars."""
    if not records:
        return "(no spans)"
    roots, children = build_tree(records)
    t0 = min(_span_interval(r)[0] for r in records)
    t1 = max(_span_interval(r)[1] for r in records)
    head = records[0]
    lines = [f"trace {head.get('trace_id', '?')}  "
             f"wall {(t1 - t0) * 1e3:.2f}ms  spans {len(records)}"]
    label_w = max(min(36, max(len(r.get("op", "?")) + 2 for r in records)), 12)
    seen: set[str] = set()

    def visit(rec: dict, depth: int):
        sid = rec.get("span_id")
        if sid in seen:
            return
        seen.add(sid)
        s, e = _span_interval(rec)
        label = ("  " * depth + rec.get("op", "?"))[:label_w]
        lines.append(f"{label.ljust(label_w)} |{_bar(t0, t1, s, e)}| "
                     f"{(e - s) * 1e3:9.2f}ms")
        if stages:
            base = float(rec.get("start", 0.0))
            for name, off_us, dur_us in rec.get("stages", ()):
                ss = base + off_us / 1e6
                lbl = ("  " * depth + "· " + str(name))[:label_w]
                lines.append(
                    f"{lbl.ljust(label_w)} |"
                    f"{_bar(t0, t1, ss, ss + dur_us / 1e6, '-')}| "
                    f"{dur_us / 1e3:9.2f}ms")
        for ch in children.get(sid, ()):
            visit(ch, depth + 1)

    for root in roots:
        visit(root, 0)
    return "\n".join(lines)


def _stage_tree(rec: dict) -> tuple[list[tuple[str, float, float]],
                                    dict[int, list[int]], list[int]]:
    """A span's stages as a containment hierarchy: stage B whose interval
    sits inside a strictly-larger stage A is A's child (encode contains
    codec.host/codec.device). Returns (intervals, children-by-idx, tops)."""
    base = float(rec.get("start", 0.0))
    ivs = [(str(n), base + off / 1e6, base + (off + dur) / 1e6)
           for n, off, dur in rec.get("stages", ())]
    kids: dict[int, list[int]] = {}
    tops: list[int] = []
    for i, (_n, s, e) in enumerate(ivs):
        best = None
        for j, (_nj, sj, ej) in enumerate(ivs):
            if j == i or not (sj <= s and e <= ej) or (ej - sj) <= (e - s):
                continue  # strict containment only: equal intervals stay
                # siblings (no parent cycles)
            if best is None or (ej - sj) < (ivs[best][2] - ivs[best][1]):
                best = j
        if best is None:
            tops.append(i)
        else:
            kids.setdefault(best, []).append(i)
    return ivs, kids, tops


def flamegraph(records: list[dict]) -> str:
    """Collapsed-stack text flamegraph: one `path;to;frame <ms>` line per
    span and per stage (the format flamegraph.pl and speedscope ingest),
    self-time style. Stages nest by interval containment (a 10ms encode
    wait containing 7ms of codec.device emits 3/7, not 10/7), and a span
    frame excludes its child spans and top-level stages — summing a frame
    with its prefixed children reproduces the span's width, never more."""
    roots, children = build_tree(records)
    out: list[str] = []
    seen: set[str] = set()

    def emit_stage(ivs, kids, idx: int, path: str):
        name, s, e = ivs[idx]
        sub = kids.get(idx, ())
        covered = _union([(max(ivs[j][1], s), min(ivs[j][2], e))
                          for j in sub])
        out.append(f"{path};{name} {max(0.0, (e - s) - covered) * 1e3:.3f}")
        for j in sub:
            emit_stage(ivs, kids, j, f"{path};{name}")

    def visit(rec: dict, path: str):
        sid = rec.get("span_id")
        if sid in seen:
            return
        seen.add(sid)
        frame = f"{path};{rec.get('op', '?')}" if path else rec.get("op", "?")
        kid_spans = children.get(sid, ())
        s, e = _span_interval(rec)
        ivs, kids, tops = _stage_tree(rec)
        sub_ivs = [_span_interval(c) for c in kid_spans]
        sub_ivs += [(ivs[i][1], ivs[i][2]) for i in tops]
        covered = _union([(max(cs, s), min(ce, e))
                          for cs, ce in sub_ivs if min(ce, e) > max(cs, s)])
        self_ms = max(0.0, rec.get("dur_us", 0) / 1e3 - covered * 1e3)
        out.append(f"{frame} {self_ms:.3f}")
        for i in tops:
            emit_stage(ivs, kids, i, frame)
        for ch in kid_spans:
            visit(ch, frame)

    for root in roots:
        visit(root, "")
    return "\n".join(out)


def aggregate(records: list[dict]) -> dict[str, dict]:
    """Per-hop latency aggregation over many traces' records: op ->
    {count, p50_ms, p99_ms, max_ms} (nearest-rank percentiles)."""
    groups: dict[str, list[float]] = {}
    for rec in records:
        groups.setdefault(rec.get("op", "?"), []).append(
            rec.get("dur_us", 0) / 1e3)

    def pct(vals: list[float], q: float) -> float:
        return vals[min(len(vals) - 1, int(q * (len(vals) - 1) + 0.5))]

    out = {}
    for op, vals in groups.items():
        vals.sort()
        out[op] = {"count": len(vals), "p50_ms": round(pct(vals, 0.50), 3),
                   "p99_ms": round(pct(vals, 0.99), 3),
                   "max_ms": round(vals[-1], 3)}
    return out


def render_top(per_op: dict[str, dict]) -> str:
    if not per_op:
        return "(no recent spans)"
    w = max(len(op) for op in per_op)
    lines = [f"{'HOP'.ljust(w)}  {'COUNT':>7}  {'P50MS':>10}  "
             f"{'P99MS':>10}  {'MAXMS':>10}"]
    for op, st in sorted(per_op.items(), key=lambda kv: -kv[1]["p99_ms"]):
        lines.append(f"{op.ljust(w)}  {st['count']:>7}  {st['p50_ms']:>10g}  "
                     f"{st['p99_ms']:>10g}  {st['max_ms']:>10g}")
    return "\n".join(lines)


def render_report(rep: dict) -> str:
    if rep.get("error"):
        return f"error: {rep['error']}"
    lines = [f"critical path of {rep['root_op']}  trace {rep['trace_id']}",
             f"  wall {rep['wall_ms']}ms  attributed {rep['attributed_ms']}ms "
             f"({rep['coverage'] * 100:.1f}%)  "
             f"unattributed {rep['unattributed_ms']}ms  "
             f"spans {rep['spans']}"]
    for st in rep["stages"]:
        pct = st["ms"] / rep["wall_ms"] * 100 if rep["wall_ms"] else 0.0
        lines.append(f"  {st['stage'].ljust(24)} {st['ms']:>10.3f}ms "
                     f"{pct:>6.1f}%  x{st['calls']}")
    return "\n".join(lines)


# -- span sources --------------------------------------------------------------


def read_dir(logdir: str, trace_id: str | None = None) -> list[dict]:
    """Span records straight from a sink directory's rotor files
    (traces.log, traces.log.1, ...), oldest first."""
    def _order(name: str) -> int:
        # oldest first: highest rotation suffix, the live traces.log last
        if name == "traces.log":
            return 0
        try:
            return -int(name.rsplit(".", 1)[-1])
        except ValueError:
            return 0

    names = sorted((n for n in os.listdir(logdir)
                    if n == "traces.log" or n.startswith("traces.log.")),
                   key=_order)
    out: dict[str, dict] = {}
    for name in names:
        try:
            with open(os.path.join(logdir, name), encoding="utf-8") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if not rec.get("span_id"):
                        continue
                    if trace_id is None or rec.get("trace_id") == trace_id:
                        out[rec["span_id"]] = rec
        except OSError:
            continue
    return sorted(out.values(), key=lambda r: r.get("start", 0.0))


def fetch(addrs: list[str], trace_id: str | None = None,
          n: int = 200) -> list[dict]:
    """Span records from every target, deduped by span id. For a trace-id
    fetch BOTH endpoint shapes are queried per target — the console's
    `/api/trace` collector (which fans out to every daemon) AND the local
    `/traces` side-door — because a console mounts both, and its local sink
    is usually empty: stopping at the first 200 would miss the rollup."""
    import urllib.parse

    from chubaofs_tpu_torch.tools.cfsstat import scrape

    out: dict[str, dict] = {}
    tid_q = urllib.parse.quote(trace_id or "")  # hostile/typo'd ids stay inert
    for addr in addrs:
        paths = ([f"/api/trace?id={tid_q}", f"/traces?id={tid_q}"]
                 if trace_id else [f"/traces/recent?n={n}"])
        errors = []
        for path in paths:
            try:
                body = json.loads(scrape(addr, path, timeout=5))
            except Exception as e:
                errors.append(f"{addr}{path}: {e}")
                continue
            for rec in body.get("spans", ()):
                if rec.get("span_id"):
                    out.setdefault(rec["span_id"], rec)
        if len(errors) == len(paths):  # NO shape answered: say so
            print(f"warning: {'; '.join(errors)}", file=sys.stderr)
    return sorted(out.values(), key=lambda r: r.get("start", 0.0))


# -- CLI -----------------------------------------------------------------------


def main(argv=None, out=None) -> int:
    import argparse

    out = out or sys.stdout
    p = argparse.ArgumentParser(
        prog="cfs-trace",
        description="render + analyze persisted traces (sink side-doors)")
    p.add_argument("trace_id", nargs="?", default=None)
    p.add_argument("--addr", action="append", default=[],
                   help="daemon or console address (repeatable)")
    p.add_argument("--dir", default=None,
                   help="read a local trace-sink directory instead of HTTP")
    p.add_argument("--bundle", default=None,
                   help="read spans from a collected flight-recorder "
                        "bundle dir instead of live side-doors "
                        "(postmortem mode)")
    p.add_argument("--top", action="store_true",
                   help="per-hop p50/p99 over recent traces")
    p.add_argument("--prof", type=float, default=None, metavar="SECONDS",
                   help="fetch a SECONDS-long stack-sampled profile from "
                        "the first --addr's /debug/prof side-door and print "
                        "its collapsed stacks (flamegraph.pl format)")
    p.add_argument("--n", type=int, default=200,
                   help="recent spans to aggregate with --top")
    p.add_argument("--flame", action="store_true",
                   help="collapsed-stack flamegraph instead of a waterfall")
    p.add_argument("--no-report", action="store_true",
                   help="skip the critical-path report")
    p.add_argument("--root-op", default=None,
                   help="analyze this op's span as the critical-path root")
    p.add_argument("--overlap", default=None, metavar="A,B",
                   help="also report how much stage families A and B ran "
                        "concurrently (prefix match; e.g. "
                        "'download,codec.' proves repair download/decode "
                        "overlap)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    if args.prof is not None:
        if not args.addr:
            p.error("--prof needs --addr (the daemon to profile)")
        from chubaofs_tpu_torch.tools.cfsstat import scrape

        path = f"/debug/prof?seconds={args.prof:g}" \
            + ("&json=1" if args.json else "")
        try:
            body = scrape(args.addr[0], path,
                          timeout=max(30.0, args.prof * 2 + 10.0))
        except Exception as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(body.rstrip("\n"), file=out)
        return 0

    if not args.top and not args.trace_id:
        p.error("a trace id is required unless --top")
    if not args.addr and not args.dir and not args.bundle:
        env_dir = os.environ.get("CFS_TRACE_DIR")
        if env_dir:
            args.dir = env_dir
        else:
            p.error("give --addr (repeatable), --dir, or --bundle "
                    "(or set CFS_TRACE_DIR)")

    if args.bundle:
        from chubaofs_tpu_torch.tools.cfsdoctor import read_bundle

        try:
            bundle = read_bundle(args.bundle)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        seen: dict[str, dict] = {}
        for payload in bundle["targets"].values():
            for rec in (payload.get("traces") or {}).get("records", []):
                if args.trace_id and rec.get("trace_id") != args.trace_id:
                    continue
                if rec.get("span_id"):
                    seen.setdefault(rec["span_id"], rec)
        records = sorted(seen.values(), key=lambda r: r.get("start", 0.0))
        if args.top:
            records = records[-args.n:]
    elif args.dir:
        records = read_dir(args.dir, args.trace_id)
        if args.top:
            records = records[-args.n:]
    else:
        records = fetch(args.addr, args.trace_id, n=args.n)

    if args.top:
        per_op = aggregate(records)
        print(json.dumps(per_op, indent=2) if args.json
              else render_top(per_op), file=out)
        return 0

    if not records:
        print(f"no spans for trace {args.trace_id}", file=sys.stderr)
        return 1
    rep = critical_path(records, root_op=args.root_op)
    overlap = None
    if args.overlap:
        a, _, b = args.overlap.partition(",")
        overlap = stage_overlap(records, a.strip(), b.strip())
    if args.json:
        blob = {"spans": records, "report": rep}
        if overlap is not None:
            blob["overlap"] = overlap
        print(json.dumps(blob, indent=2), file=out)
        return 0
    print(flamegraph(records) if args.flame else waterfall(records), file=out)
    if not args.no_report:
        print("", file=out)
        print(render_report(rep), file=out)
    if overlap is not None:
        print(f"overlap {overlap['a']} ∩ {overlap['b']}: "
              f"{overlap['overlap_ms']}ms of "
              f"min({overlap['a_ms']}, {overlap['b_ms']})ms "
              f"(ratio {overlap['ratio']})", file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
