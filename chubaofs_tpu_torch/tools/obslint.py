"""obslint — static lint for the observability plane's invariants.

1. **No high-cardinality metric labels.** A label whose KEY names a per-object
   id (inode, blob id, volume id, extent id, request/trace id, path, upload
   id) explodes the registry: every distinct value mints a fresh time series,
   and one busy volume turns /metrics into a memory leak. Label sets must be
   bounded by construction (op names, reasons, disk kinds). Labels whose
   values are configured identities rather than literals — `tenant` in the
   capacity harness — are bounded at RUNTIME instead: the subsystem declares
   the closed set via `exporter.declare_label_values`, and any undeclared
   value is rejected at the metric call (the runtime half of this rule).

2. **No new ad-hoc stats dicts.** Counters live in `exporter.Registry` (role
   registries), where they are locked, rendered, and scrape-able — not in
   `self.stats = {...}` dict literals that every subsystem reinvents and no
   endpoint can see. The two pre-registry dicts that were MIGRATED to the
   registry (raft drain, codec batches) remain as documented read-only legacy
   views and are allowlisted here.

3. **No direct `http.client.HTTPConnection(...)` outside `rpc/pool.py`.**
   Every HTTP connection rides the keep-alive pool (or its NullPool opt-out)
   so reuse/evict counters stay truthful and the connect-per-request data
   path can never be silently reintroduced.

4. **No latency/deadline arithmetic on `time.time()`.** The wall clock jumps
   (NTP slew/step, manual set); a retry deadline or an idle-TTL delta built
   from it can expire instantly or never. Any `+`/`-` arithmetic whose
   operand is a direct `time.time()` call is flagged — elapsed times and
   deadlines use `time.monotonic()` (or `perf_counter`). Wall stamps that
   only get STORED or COMPARED as timestamps (proposal `now=`, mtimes,
   heartbeat records) don't involve such arithmetic and pass; files whose
   wall-clock arithmetic is cross-process protocol (authnode ticket
   freshness windows) are allowlisted.

5. **No `sock.sendall(pkt.encode())` framing outside the packet layer.**
   `encode()` concatenates header + arg + a possibly multi-MB payload into
   one fresh bytes object — the exact copy the zero-copy iovec path
   (`proto/packet.send_packet` via `sendmsg`) exists to avoid. Call sites
   use `send_packet` (or queue iovecs through `rpc/evloop.py`); only those
   two files may hand-frame packet bytes onto a socket. `# obslint: <why>`
   pragmas an exception.

6. **No bare `print(` diagnostics in daemon code.** Outside `tools/` and
   `cli/` (whose stdout IS the user interface), a print is a log line that
   no .log file rotates, no level filters, and no operator finds — daemon
   diagnostics route through `utils/logger.py` or the structured audit
   trails (`utils/auditlog.py`). The few legitimate prints — a boot line a
   harness parses off stdout, a structured audit line flushed to stderr —
   are PROTOCOL, and each carries a reasoned `# obslint: <why>` pragma
   saying so.

7. **No ad-hoc state-transition writes outside `utils/`.** A bare
   `sys.stderr.write(...)` or a hand-rolled audit record (a dict literal
   carrying an `"audit"` key) in daemon code is a state transition only a
   log-grep can find — no ring, no rotation, no /events, no cursor, no
   cluster merge. Transitions route through `utils/events.EventJournal`
   (`events.emit(...)`), whose records the console `/api/events` rollup and
   `cfs-events` serve. The sanctioned writers live under `utils/` (the
   journal itself, the auditlog rotor, the lock sanitizer's stderr audit
   line); `tools/`/`cli/` stdout-stderr is the user interface, as in rule 6.
   A reasoned `# obslint: <why>` pragma documents a true protocol line.

8. **Every `EVENT_TYPES` name has an emit site.** The journal's type set is
   a closed contract: the runtime validator accepts exactly these names,
   dashboards and tests filter on them, and cfs-events documents them. A
   type nobody emits is a dead promise that silently rots the timeline —
   nothing can ever appear under it, and readers can't tell "quiet" from
   "unwired". This is a package-GLOBAL pass (`lint_event_types`): a name
   counts as covered when a string literal reaches any `*emit*(...)` call's
   first argument (including computed `"a" if c else "b"` forms) or an
   `etype`-named assignment anywhere in the package.

9. **Every actuator invocation in `autopilot/` emits a typed event.** The
   autopilot's whole contract is the auditable cause→action→resolution
   timeline: an actuator `.apply(`/`.rollback(` call whose function emits no
   `autopilot_*` event is an invisible actuation — the cluster changed and
   the timeline can't say why, which is exactly the operator trust the
   closed loop lives or dies on. Scoped per FUNCTION (the emit must share
   the function with the invocation, so the event can carry the causal
   fingerprint from the same frame); a reasoned `# obslint: <why>` pragma
   documents a true exception.

Wired into tier-1 (tests/test_torch_obslint.py) so a regression fails fast.

File-walk, pragma, and CLI plumbing live in tools/lintcore.py, shared with
racelint (the concurrency pass) so the two linters cannot drift.
"""

from __future__ import annotations

import ast
import sys

from chubaofs_tpu_torch.tools import lintcore

# label keys that smell like unbounded per-object ids
BANNED_LABEL_KEYS = {
    "ino", "inode", "bid", "blob_id", "vid", "vuid", "extent", "extent_id",
    "req_id", "request_id", "trace_id", "path", "upload_id", "key", "tx_id",
    "partition_id",
}

# metric-emitting call attributes whose `labels` argument we inspect
_METRIC_METHODS = {"counter", "gauge", "summary", "tp"}

# (path suffix, attribute) pairs of the documented legacy stat dicts — the
# registry migration kept them as read-only views for perfbench/tests
ALLOWED_STATS_DICTS = {
    ("raft/server.py", "drain_stats"),
    ("codec/service.py", "stats"),
}

# the ONE module allowed to construct HTTPConnection: the keep-alive pool
CONN_POOL_PATH = "rpc/pool.py"

# the packet-framing layer: the only files allowed to sendall(pkt.encode())
# (rule 5) — everyone else goes through send_packet's sendmsg iovec path
PACKET_LAYER_PATHS = lintcore.PACKET_LAYER_PATHS

# files whose wall-clock arithmetic is PROTOCOL, not latency: authnode
# verifies request-timestamp freshness across processes, where monotonic
# clocks don't compare and wall time is the contract
ALLOWED_WALLCLOCK_FILES = ("authnode/server.py",)

# directory SEGMENTS whose stdout IS the interface — rule 6 (bare print)
# does not apply: operator CLIs and the lint/bench tools themselves.
# Matched as path segments (not prefixes) so linting an installed package
# (relpath `tools/x.py`) and linting a checkout root (relpath
# `chubaofs_tpu_torch/tools/x.py`) agree — the same contract as path_matches
PRINT_OK_DIRS = ("tools", "cli")

# rule 7's sanctioned writers: utils/ owns the journal, the auditlog rotor
# and the sanitizer's structured stderr line; tools/cli stderr is operator
# diagnostics (their stdout is the interface, rule 6's contract)
EVENTS_OK_DIRS = ("utils", "tools", "cli")


# rule 9's scope: the closed-loop controller package, where every actuator
# invocation must leave a fingerprint-stamped record on the timeline
AUTOPILOT_DIR = "autopilot"
ACTUATOR_CALL_ATTRS = ("apply", "rollback")


def _in_autopilot_dir(relpath: str) -> bool:
    parts = relpath.replace("\\", "/").split("/")
    return AUTOPILOT_DIR in parts[:-1]


def _in_print_ok_dir(relpath: str) -> bool:
    parts = relpath.replace("\\", "/").split("/")
    return any(seg in PRINT_OK_DIRS for seg in parts[:-1])


def _in_events_ok_dir(relpath: str) -> bool:
    parts = relpath.replace("\\", "/").split("/")
    return any(seg in EVENTS_OK_DIRS for seg in parts[:-1])


def _is_stderr_attr(node: ast.expr) -> bool:
    """`sys.stderr` (any `import sys as _sys` alias)."""
    return (isinstance(node, ast.Attribute) and node.attr == "stderr"
            and isinstance(node.value, ast.Name)
            and node.value.id.lstrip("_") == "sys")


def _is_walltime_call(node: ast.expr) -> bool:
    """A direct time.time() call (any `* as <alias>` import of the module:
    `time.time()`, `_time.time()`)."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "time"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id.lstrip("_") == "time")


def _names_a_packet(node: ast.expr) -> bool:
    """True when an expression's terminal name reads as a Packet (`pkt`,
    `reply_packet`, `self.pkt`, ...) — rule 5's receiver filter."""
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    else:
        return False
    return "pkt" in name.lower() or "packet" in name.lower()


def _labels_arg(call: ast.Call) -> ast.expr | None:
    """The labels argument of a metric call: 2nd positional or labels=."""
    if len(call.args) >= 2:
        return call.args[1]
    for kw in call.keywords:
        if kw.arg == "labels":
            return kw.value
    return None


def lint_source(src: str, relpath: str) -> list[str]:
    """Lint one file's source; returns human-readable findings."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [f"{relpath}: syntax error: {e}"]
    src_lines = src.splitlines()
    findings: list[str] = []
    for node in ast.walk(tree):
        # -- rule 1: banned/high-cardinality metric label keys --------------
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _METRIC_METHODS:
            labels = _labels_arg(node)
            if isinstance(labels, ast.Dict):
                for k, v in zip(labels.keys, labels.values):
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        if k.value.lower() in BANNED_LABEL_KEYS:
                            findings.append(
                                f"{relpath}:{node.lineno}: metric label key "
                                f"{k.value!r} is a per-object id — unbounded "
                                "cardinality; put the id in the trace/log, "
                                "not a label")
                    if isinstance(v, ast.JoinedStr):
                        findings.append(
                            f"{relpath}:{node.lineno}: metric label value is "
                            "an f-string — interpolated ids mint unbounded "
                            "series; use a bounded enum value")
        # -- rule 3: direct HTTPConnection construction outside the pool ----
        # a reasoned `# obslint: <why>` pragma documents the exceptions that
        # are the WORKLOAD, not a client: bench load generators where one
        # keep-alive conn per simulated client is the thing being measured,
        # and per-tenant signed S3 clients the pool doesn't model
        if isinstance(node, ast.Call) and not relpath.endswith(CONN_POOL_PATH):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            if name in ("HTTPConnection", "HTTPSConnection") \
                    and not lintcore.has_pragma(src_lines, node.lineno,
                                                "obslint"):
                findings.append(
                    f"{relpath}:{node.lineno}: direct {name}( construction — "
                    "every HTTP conn rides rpc/pool.py (ConnectionPool or "
                    "NullPool), so keep-alive reuse and evict counters stay "
                    "truthful; the unpooled path must not sneak back")
        # -- rule 4: latency/deadline arithmetic on the wall clock ----------
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Sub)) \
                and (_is_walltime_call(node.left) or _is_walltime_call(node.right)) \
                and not lintcore.path_matches(relpath, ALLOWED_WALLCLOCK_FILES) \
                and not lintcore.has_pragma(src_lines, node.lineno, "wallclock"):
            # a `# wallclock: <why>` pragma documents the exception — wall
            # arithmetic that IS the protocol (e.g. a tx deadline riding a
            # raft proposal, compared by every replica)
            findings.append(
                f"{relpath}:{node.lineno}: latency/deadline arithmetic on "
                "time.time() — the wall clock jumps (NTP, manual set); "
                "deltas and deadlines use time.monotonic()")
        # -- rule 5: hand-framed sendall(pkt.encode()) outside the layer ----
        # only when the encode() receiver NAMES a packet (pkt/packet/...):
        # sendall(json.dumps(cmd).encode()) and friends are text protocols,
        # not the shard-payload concat this rule exists for
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "sendall" and len(node.args) == 1 \
                and isinstance(node.args[0], ast.Call) \
                and isinstance(node.args[0].func, ast.Attribute) \
                and node.args[0].func.attr == "encode" \
                and _names_a_packet(node.args[0].func.value) \
                and not lintcore.path_matches(relpath, PACKET_LAYER_PATHS) \
                and not lintcore.has_pragma(src_lines, node.lineno, "obslint"):
            findings.append(
                f"{relpath}:{node.lineno}: sendall(<x>.encode()) hand-frames "
                "a packet through a full payload concat — the zero-copy "
                "iovec path (proto/packet.send_packet via sendmsg) exists "
                "so multi-MB shard buffers cross the wire uncopied; use "
                "send_packet or the evloop write queue")
        # -- rule 6: bare print( diagnostics in daemon code -----------------
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "print" \
                and not _in_print_ok_dir(relpath) \
                and not lintcore.has_pragma(src_lines, node.lineno, "obslint"):
            findings.append(
                f"{relpath}:{node.lineno}: bare print( in daemon code — "
                "stdout/stderr diagnostics bypass rotation, levels, and "
                "every log consumer; route through utils/logger.py or the "
                "structured audit trails, or pragma a protocol line with "
                "`# obslint: <why>`")
        # -- rule 7: ad-hoc state-transition writes outside utils/ ----------
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "write" \
                and _is_stderr_attr(node.func.value) \
                and not _in_events_ok_dir(relpath) \
                and not lintcore.has_pragma(src_lines, node.lineno, "obslint"):
            findings.append(
                f"{relpath}:{node.lineno}: bare sys.stderr.write( in daemon "
                "code — a state transition written here reaches no ring, no "
                "rotation, no /events cursor; route it through "
                "utils/events.emit() (or pragma a protocol line with "
                "`# obslint: <why>`)")
        if isinstance(node, ast.Dict) and not _in_events_ok_dir(relpath) \
                and any(isinstance(k, ast.Constant) and k.value == "audit"
                        for k in node.keys if k is not None) \
                and not lintcore.has_pragma(src_lines, node.lineno, "obslint"):
            findings.append(
                f"{relpath}:{node.lineno}: hand-rolled audit dict (literal "
                "with an 'audit' key) — structured transition records belong "
                "in utils/events.EventJournal so the console rollup and "
                "cfs-events can serve them; use events.emit() or pragma "
                "with `# obslint: <why>`")
        # -- rule 2: ad-hoc self.*stats* = {...} dict counters --------------
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and ("stats" in tgt.attr or tgt.attr.endswith("_counters"))):
                    if any(relpath.endswith(sfx) and tgt.attr == attr
                           for sfx, attr in ALLOWED_STATS_DICTS):
                        continue
                    findings.append(
                        f"{relpath}:{node.lineno}: ad-hoc stats dict "
                        f"`self.{tgt.attr} = {{...}}` — counters belong in "
                        "exporter.registry(<role>) so /metrics can render "
                        "them (allowlisted legacy views excepted)")
    # -- rule 9: silent actuator invocations inside autopilot/ --------------
    if _in_autopilot_dir(relpath):
        findings.extend(_lint_actuator_emits(tree, src_lines, relpath))
    return findings


def _scope_calls(fn: ast.AST):
    """Call nodes in a function's OWN scope — nested def/async-def bodies
    are their own rule-9 scopes and are not descended into (an emit hidden
    in a closure can't prove the outer invocation was recorded)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def _lint_actuator_emits(tree: ast.AST, src_lines: list[str],
                         relpath: str) -> list[str]:
    """Rule 9: inside autopilot/, any function invoking an actuator
    (`<x>.apply(` / `<x>.rollback(`) must, in the SAME function, emit an
    event whose type literal starts `autopilot_` — the invocation and its
    timeline record share a frame, so the record carries the causal
    fingerprint. `# obslint: <why>` on the invocation line escapes."""
    findings: list[str] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        invocations: list[ast.Call] = []
        emits_typed = False
        for call in _scope_calls(fn):
            f = call.func
            if isinstance(f, ast.Attribute) \
                    and f.attr in ACTUATOR_CALL_ATTRS:
                invocations.append(call)
            name = (f.attr if isinstance(f, ast.Attribute)
                    else f.id if isinstance(f, ast.Name) else "")
            if "emit" in name and call.args:
                for sub in ast.walk(call.args[0]):
                    if isinstance(sub, ast.Constant) \
                            and isinstance(sub.value, str) \
                            and sub.value.startswith("autopilot_"):
                        emits_typed = True
        if emits_typed:
            continue
        for call in invocations:
            if lintcore.has_pragma(src_lines, call.lineno, "obslint"):
                continue
            findings.append(
                f"{relpath}:{call.lineno}: actuator `.{call.func.attr}(` in "
                f"`{fn.name}` with no autopilot_* event emitted in the same "
                "function — an unrecorded actuation breaks the cause→action"
                "→resolution audit trail; emit autopilot_executed/"
                "autopilot_rolled_back here (or pragma with "
                "`# obslint: <why>`)")
    return findings


def _emit_literals(tree: ast.AST) -> set[str]:
    """Every string literal that can reach an emit call in this module: a
    literal anywhere inside a Call whose callee name/attr mentions `emit`
    (covers `events.emit("x", ...)`, `self._emit_bp("x", ...)`, and the
    IfExp form `ev.emit("a" if c else "b", ...)`), plus literals assigned
    to an `etype`-named variable (the alert plane computes the type first,
    then emits it)."""
    out: set[str] = set()

    def literals_under(node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                out.add(sub.value)

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else "")
            if "emit" in name and node.args:
                literals_under(node.args[0])
        elif isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and "etype" in t.id
                   for t in node.targets):
                literals_under(node.value)
    return out


def lint_event_types(root: str | None = None) -> list[str]:
    """Rule 8, a package-GLOBAL pass (per-file rules can't see it): every
    name in `events.EVENT_TYPES` must have at least one emit site somewhere
    in the package. A type with no emitter is a dead timeline contract —
    dashboards and tests filter on it, the runtime validator accepts it,
    and nothing can ever appear."""
    from chubaofs_tpu_torch.utils.events import EVENT_TYPES

    emitted: set[str] = set()
    for abspath, relpath in lintcore.iter_py_files(
            root or lintcore.package_root()):
        try:
            with open(abspath, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=relpath)
        except (OSError, SyntaxError):
            continue
        emitted |= _emit_literals(tree)
    return [f"utils/events.py: EVENT_TYPES entry `{t}` has no emit( site "
            f"in the package — a dead event type silently rots the "
            f"timeline contract (emit it or prune it)"
            for t in EVENT_TYPES if t not in emitted]


def run(root: str | None = None) -> list[str]:
    """Lint every .py file under the package (rules 1-7 plus rule 9's
    autopilot actuator-audit pass), then the package-global event-type
    coverage pass (rule 8); returns all findings."""
    return lintcore.run_package(lint_source, root) + lint_event_types(root)


def main(argv=None) -> int:
    return lintcore.lint_main(
        "obslint", "lint metric-label cardinality + ad-hoc stats dicts",
        run, argv)


if __name__ == "__main__":
    sys.exit(main())
