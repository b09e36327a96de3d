"""racelint — static lint for lock discipline (the concurrency half of the
static-analysis plane; obslint is the observability half).

The Go reference keeps its daemons honest with `go test -race` and vet; a
Python port gets neither, and this package carries ~50 threading.Lock/RLock/
Condition instances across the raft drain pump, the PUT pipeline window, the
conn pools, the trace sink, and the codec dispatcher. These rules catch the
mistakes that actually bite that kind of code:

1. **Guarded-field escape** (`guarded-field-escape`). Within one class, an
   attribute that is written under `with self._lock:` in one method but
   written bare in another has no discipline at all — the guarded sites pay
   for a contract the bare site silently voids. Writes include plain/aug
   assignment, subscript stores/deletes, and the standard container mutators
   (`append`, `pop`, `update`, ...). `__init__`/`__new__` are construction
   (happens-before publication) and exempt; methods whose name ends in
   `_locked` declare "caller holds the lock" (the reference's `fooLocked`
   convention) and count as guarded.

2. **Threaded global mutation** (`threaded-global-mutation`). Module-level
   mutable state (dict/list/set/deque literals or constructors) mutated
   outside any lock from a method of a class that also spawns threads or
   executors: the class proved it runs concurrently, so its bare writes to
   shared module state are races by construction.

3. **Unjoined thread** (`unjoined-thread`). A `threading.Thread` /
   `ThreadPoolExecutor` created with no reachable `join`/`shutdown`: not
   daemonized, not a `with` block, and no `<target>.join()`/`.shutdown()`
   call anywhere in scope (its CLASS for `self.x`, the enclosing function
   for locals — a same-named handle joined elsewhere in the file does not
   count). Leaked workers outlive their owner, pin its state alive, and
   turn shutdown into a hang.

4. **Check-then-act** (`check-then-act`). `if k in d: del d[k]` (and
   `d.pop(k)`, and `if k not in d: d[k] = ...`) on a `self.*` or
   module-level dict outside a lock: the membership test and the mutation
   are separate bytecodes, and another thread can interleave between them.
   Locals are exempt (unshared by construction).

5. **Thread-per-connection serving** (`thread-per-conn`). A
   `threading.Thread(target=..., args=(conn,...))` spawned per accepted
   connection is the scaling wall the event loop removed: at hundreds of
   clients the thread stacks and GIL churn dominate before the network does.
   Packet serving rides `rpc/evloop.py` (loop shards + bounded workers);
   the CFS_EVLOOP=0 rollback shims carry the pragma. `rpc/evloop.py` and
   `proto/packet.py` are exempt by path (they ARE the sanctioned layer).

Exceptions carry a `# racelint: <why>` pragma on the flagged line, or a
per-file allowlist entry below — both REQUIRE a written reason. Shared
walk/pragma/CLI plumbing: tools/lintcore.py. Wired into tier-1
(tests/test_torch_racelint.py); the runtime half of the same plan is
utils/locks.py (the CFS_LOCK_SANITIZER lock-order sanitizer).
"""

from __future__ import annotations

import ast

from chubaofs_tpu_torch.tools import lintcore

PRAGMA = "racelint"

# Per-file allowlist: path suffix -> {rule: reason}. An entry suppresses that
# RULE for that file and MUST carry a written reason (it is the file-wide
# sibling of the line pragma). Currently empty: every in-tree exception is
# narrow enough for a `# racelint: <why>` on the flagged line.
ALLOWLIST: dict[str, dict[str, str]] = {}

# container-mutating method names that count as writes for rule 1
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "remove", "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault",
}

# names that make a `with` item a lock guard (threading.Lock/RLock/Condition
# attributes by convention: self._lock, g.pending_lock, _LOCK, self._cond)
def _is_lockish_name(name: str) -> bool:
    low = name.lower()
    return any(t in low for t in ("lock", "cond", "mutex", "mtx"))


def _is_lockish_expr(expr: ast.expr) -> bool:
    if isinstance(expr, ast.Attribute):
        return _is_lockish_name(expr.attr)
    if isinstance(expr, ast.Name):
        return _is_lockish_name(expr.id)
    return False


def _with_is_guard(node: ast.With) -> bool:
    return any(_is_lockish_expr(item.context_expr) for item in node.items)


def _self_attr(expr: ast.expr) -> str | None:
    """'x' when expr is `self.x`, else None."""
    if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        return expr.attr
    return None


def _mutable_literal(value: ast.expr) -> bool:
    """Dict/list/set literal, comprehension, or bare dict()/list()/set()/
    deque()/defaultdict() constructor — module state a thread can mutate."""
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                          ast.ListComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call):
        fn = value.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")
        return name in ("dict", "list", "set", "deque", "defaultdict",
                        "OrderedDict", "Counter")
    return False


def _thread_call_kind(node: ast.Call) -> str | None:
    """'thread' / 'executor' when node constructs one, else None."""
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else "")
    if name == "Thread":
        return "thread"
    if name == "ThreadPoolExecutor":
        return "executor"
    return None


class _Write:
    __slots__ = ("attr", "lineno", "guarded")

    def __init__(self, attr: str, lineno: int, guarded: bool):
        self.attr = attr
        self.lineno = lineno
        self.guarded = guarded


def _scan_writes(body: list[ast.stmt], depth: int, out: list[_Write],
                 global_muts: list[tuple[str, int, bool]],
                 module_globals: set[str]) -> None:
    """Walk statements tracking lock depth; record self-attribute writes and
    module-global mutations with their guardedness."""

    def record_target(tgt: ast.expr, lineno: int) -> None:
        attr = _self_attr(tgt)
        if attr is not None and not _is_lockish_name(attr) \
                and not attr.startswith("__"):
            out.append(_Write(attr, lineno, depth > 0))
        if isinstance(tgt, ast.Subscript):
            base = tgt.value
            attr = _self_attr(base)
            if attr is not None and not _is_lockish_name(attr):
                out.append(_Write(attr, lineno, depth > 0))
            if isinstance(base, ast.Name) and base.id in module_globals:
                global_muts.append((base.id, lineno, depth > 0))

    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue  # nested defs run later, on their caller's terms
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = depth + 1 if _with_is_guard(stmt) else depth
            _scan_writes(stmt.body, inner, out, global_muts, module_globals)
            continue
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                record_target(tgt, stmt.lineno)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if stmt.value is not None or isinstance(stmt, ast.AugAssign):
                record_target(stmt.target, stmt.lineno)
                if isinstance(stmt, ast.AugAssign) \
                        and isinstance(stmt.target, ast.Name) \
                        and stmt.target.id in module_globals:
                    global_muts.append((stmt.target.id, stmt.lineno, depth > 0))
        elif isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                record_target(tgt, stmt.lineno)
        # recurse into compound statements (if/for/while/try bodies)
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:  # With/AsyncWith never reach here (handled above)
                _scan_writes(sub, depth, out, global_muts, module_globals)
        for handler in getattr(stmt, "handlers", ()) or ():
            _scan_writes(handler.body, depth, out, global_muts, module_globals)
        # expression statements: container mutator calls on self.x / globals
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            fn = stmt.value.func
            if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
                attr = _self_attr(fn.value)
                if attr is not None and not _is_lockish_name(attr):
                    out.append(_Write(attr, stmt.lineno, depth > 0))
                if isinstance(fn.value, ast.Name) \
                        and fn.value.id in module_globals:
                    global_muts.append((fn.value.id, stmt.lineno, depth > 0))


def _module_mutable_globals(tree: ast.Module) -> set[str]:
    out: set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and _mutable_literal(stmt.value):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name) and not _is_lockish_name(tgt.id):
                    out.add(tgt.id)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                and _mutable_literal(stmt.value) \
                and isinstance(stmt.target, ast.Name) \
                and not _is_lockish_name(stmt.target.id):
            out.add(stmt.target.id)
    return out


def _class_spawns_threads(cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, ast.Call) and _thread_call_kind(node):
            return True
    return False


_CTOR_SEEDS = ("__init__", "__new__", "__del__", "__post_init__")


def _construction_only_methods(cls: ast.ClassDef) -> set[str]:
    """Methods whose every intra-class call site is inside __init__/__new__
    (transitively): they run before the object is published, so their bare
    writes are construction, not races. Methods with NO intra-class callers
    are public API and never qualify."""
    methods = {m.name: m for m in cls.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    callers: dict[str, set[str]] = {name: set() for name in methods}
    for name, m in methods.items():
        for node in ast.walk(m):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                callee = _self_attr(node.func)
                if callee in callers:
                    callers[callee].add(name)
    result: set[str] = set()
    changed = True
    while changed:
        changed = False
        for name in methods:
            if name in result or name in _CTOR_SEEDS:
                continue
            cs = callers[name]
            if cs and all(c in _CTOR_SEEDS or c in result for c in cs):
                result.add(name)
                changed = True
    return result


# -- rule 3 helpers ------------------------------------------------------------


def _call_has_true_kw(call: ast.Call, kw_name: str) -> bool:
    for kw in call.keywords:
        if kw.arg == kw_name and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return True
    return False


def _joinish_targets(tree: ast.AST) -> tuple[set[str], set[str]]:
    """(self attrs, local names) that have .join()/.shutdown() called on
    them anywhere under `tree`."""
    attrs: set[str] = set()
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("join", "shutdown"):
            base = node.func.value
            attr = _self_attr(base)
            if attr is not None:
                attrs.add(attr)
            elif isinstance(base, ast.Name):
                names.add(base.id)
    return attrs, names


def _with_context_calls(tree: ast.AST) -> set[int]:
    """Line numbers of calls used directly as `with <call>(...)` items —
    context-managed executors shut down on exit."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if isinstance(item.context_expr, ast.Call):
                    out.add(id(item.context_expr))
    return out


# -- the pass ------------------------------------------------------------------


def lint_source(src: str, relpath: str) -> list[str]:
    """Lint one file's source; returns human-readable findings tagged with
    their rule id."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [f"{relpath}: syntax error: {e}"]
    src_lines = src.splitlines()
    allow = {}
    for sfx, rules in ALLOWLIST.items():
        if lintcore.path_matches(relpath, (sfx,)):
            allow.update(rules)
    findings: list[str] = []

    def flag(rule: str, lineno: int, msg: str) -> None:
        if rule in allow:
            return
        if lintcore.has_pragma(src_lines, lineno, PRAGMA):
            return
        findings.append(f"{relpath}:{lineno}: [{rule}] {msg}")

    module_globals = _module_mutable_globals(tree)

    # -- rules 1 + 2: per-class write-discipline inference --------------------
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        writes: list[_Write] = []
        global_muts: list[tuple[str, int, bool]] = []
        ctor_only = _construction_only_methods(cls)
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if meth.name in _CTOR_SEEDS or meth.name in ctor_only:
                continue  # construction/teardown happens-before publication
            # `*_locked` methods document "caller holds the lock": their
            # writes are guarded at every call site by contract
            depth = 1 if meth.name.endswith("_locked") else 0
            _scan_writes(meth.body, depth, writes, global_muts, module_globals)
        guarded = {w.attr for w in writes if w.guarded}
        for w in writes:
            if not w.guarded and w.attr in guarded:
                flag("guarded-field-escape", w.lineno,
                     f"self.{w.attr} is written under a lock elsewhere in "
                     f"{cls.name} but bare here — either every write holds "
                     "the lock or none meaningfully does; hold the lock, or "
                     "rename the method *_locked if the caller already "
                     "does")
        if global_muts and _class_spawns_threads(cls):
            for name, lineno, is_guarded in global_muts:
                if not is_guarded:
                    flag("threaded-global-mutation", lineno,
                         f"module-level `{name}` mutated without a lock from "
                         f"{cls.name}, which spawns threads/executors — "
                         "shared module state needs a module lock (or move "
                         "the state onto the instance)")

    # -- rule 3: thread/executor creation without reachable join/shutdown -----
    _scan_unjoined(tree, flag)

    # -- rule 4: check-then-act on shared dicts outside a lock ----------------
    _scan_check_then_act(tree, module_globals, flag)

    # -- rule 5: thread-per-connection serving --------------------------------
    _scan_thread_per_conn(tree, relpath, flag)
    return findings


# files that ARE the sanctioned serving layer (rule 5)
_EVLOOP_PATHS = lintcore.PACKET_LAYER_PATHS

# arg names that mark a Thread target as per-connection serving
_CONNISH = ("conn", "sock", "client", "peer")


def _scan_thread_per_conn(tree: ast.AST, relpath: str, flag) -> None:
    """Rule 5: `threading.Thread(target=..., args=(conn,...))` — one thread
    per accepted connection. The evloop core replaced this; only the
    CFS_EVLOOP=0 shims (pragma'd) and evloop/packet themselves may spawn
    per-connection service threads."""
    if lintcore.path_matches(relpath, _EVLOOP_PATHS):
        return
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _thread_call_kind(node) == "thread"):
            continue
        for kw in node.keywords:
            if kw.arg != "args" or not isinstance(kw.value, ast.Tuple):
                continue
            names = [e.id.lower() for e in kw.value.elts
                     if isinstance(e, ast.Name)]
            if any(any(t in n for t in _CONNISH) for n in names):
                flag("thread-per-conn", node.lineno,
                     "thread-per-connection serving — a full OS thread per "
                     "accepted conn is the scale wall the evloop removed; "
                     "register the socket on rpc/evloop.py's "
                     "loop shards instead, or pragma the CFS_EVLOOP=0 shim "
                     "with its reason")
                break


def _assign_target_of(tree: ast.AST, call: ast.Call) -> ast.expr | None:
    """The single assignment target whose value IS `call`, if any."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and node.value is call \
                and len(node.targets) == 1:
            return node.targets[0]
    return None


def _scan_unjoined(tree: ast.Module, flag) -> None:
    """Rule 3, SCOPED: a `self.x` handle counts as joined only if ITS class
    joins/shuts it down; a local only if its enclosing function does. A
    same-named handle joined elsewhere in the file must not whitelist this
    one — that would silently re-open the exact leak class this rule caught
    in Access."""
    ctx_calls = _with_context_calls(tree)
    joins_cache: dict[int, tuple[set[str], set[str]]] = {}

    def joins_of(scope: ast.AST) -> tuple[set[str], set[str]]:
        got = joins_cache.get(id(scope))
        if got is None:
            got = joins_cache[id(scope)] = _joinish_targets(scope)
        return got

    def handle(call: ast.Call, cls: ast.ClassDef | None,
               func: ast.AST) -> None:
        kind = _thread_call_kind(call)
        if id(call) in ctx_calls:
            return  # `with ThreadPoolExecutor(...) as pool:` joins on exit
        if kind == "thread" and _call_has_true_kw(call, "daemon"):
            return  # daemonized: fire-and-forget by declaration
        tgt = _assign_target_of(func, call)
        if tgt is not None:
            attr = _self_attr(tgt)
            if attr is not None and cls is not None \
                    and attr in joins_of(cls)[0]:
                return
            if isinstance(tgt, ast.Name) and tgt.id in joins_of(func)[1]:
                return
        flag("unjoined-thread", call.lineno,
             ("ThreadPoolExecutor" if kind == "executor" else
              "threading.Thread") + " created with no reachable "
             "shutdown/join — leaked workers outlive their owner and turn "
             "shutdown into a hang; daemonize it, `with` it, or keep a "
             "handle you join/shutdown")

    def visit(node: ast.AST, cls, func) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Call) and _thread_call_kind(child):
                handle(child, cls, func)
            ncls, nfunc = cls, func
            if isinstance(child, ast.ClassDef):
                ncls = child
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nfunc = child
            visit(child, ncls, nfunc)

    visit(tree, None, tree)


def _shared_base(expr: ast.expr, module_globals: set[str]) -> str | None:
    """'self.x' / module-global name when expr is one, else None (locals are
    unshared by construction)."""
    attr = _self_attr(expr)
    if attr is not None:
        return f"self.{attr}"
    if isinstance(expr, ast.Name) and expr.id in module_globals:
        return expr.id
    return None


def _same_shared(a: ast.expr, b: ast.expr, module_globals: set[str]) -> bool:
    sa, sb = _shared_base(a, module_globals), _shared_base(b, module_globals)
    return sa is not None and sa == sb


def _scan_check_then_act(tree: ast.AST, module_globals: set[str],
                         flag) -> None:
    """Find `if k in d:` / `if k not in d:` followed by a mutation of the
    SAME shared d in the branch body, outside any lock `with`."""

    def scan(body: list[ast.stmt], depth: int) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # `*_locked` means "caller holds the lock" — same contract
                # rule 1 honors
                scan(stmt.body, 1 if stmt.name.endswith("_locked") else 0)
                continue
            if isinstance(stmt, ast.ClassDef):
                scan(stmt.body, 0)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                scan(stmt.body, depth + 1 if _with_is_guard(stmt) else depth)
                continue
            if isinstance(stmt, ast.If) and depth == 0:
                hit = _check_then_act_hit(stmt, module_globals)
                if hit:
                    flag("check-then-act", stmt.lineno, hit)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    scan(sub, depth)
            for handler in getattr(stmt, "handlers", ()) or ():
                scan(handler.body, depth)

    scan(tree.body if isinstance(tree, ast.Module) else [], 0)


def _check_then_act_hit(stmt: ast.If, module_globals: set[str]) -> str | None:
    test = stmt.test
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], (ast.In, ast.NotIn))):
        return None
    container = test.comparators[0]
    shared = _shared_base(container, module_globals)
    if shared is None:
        return None
    negated = isinstance(test.ops[0], ast.NotIn)
    for inner in ast.walk(stmt):
        if negated:
            # `if k not in d: d[k] = ...` — a racing writer's value is lost
            if isinstance(inner, ast.Assign):
                for tgt in inner.targets:
                    if isinstance(tgt, ast.Subscript) \
                            and _same_shared(tgt.value, container,
                                             module_globals):
                        return (f"`if k not in {shared}: {shared}[k] = ...` "
                                "outside a lock — two racers both miss the "
                                "check and the loser's insert is silently "
                                "overwritten; use setdefault under the "
                                "container's lock")
        else:
            # `if k in d: del d[k]` / `d.pop(k)` — the del can KeyError
            if isinstance(inner, ast.Delete):
                for tgt in inner.targets:
                    if isinstance(tgt, ast.Subscript) \
                            and _same_shared(tgt.value, container,
                                             module_globals):
                        return (f"`if k in {shared}: del {shared}[k]` "
                                "outside a lock — a racing deleter wins "
                                "between check and act and this del raises "
                                "KeyError; use pop(k, None) or hold the "
                                "lock")
            if isinstance(inner, ast.Call) \
                    and isinstance(inner.func, ast.Attribute) \
                    and inner.func.attr in ("pop", "remove") \
                    and len(inner.args) == 1 \
                    and _same_shared(inner.func.value, container,
                                     module_globals):
                return (f"`if k in {shared}: {shared}."
                        f"{inner.func.attr}(k)` outside a lock — the "
                        "membership test and the mutation interleave with "
                        "other threads; use pop(k, None)/discard under the "
                        "container's lock")
    return None


def run(root: str | None = None) -> list[str]:
    """Lint every .py file under the package; returns all findings."""
    return lintcore.run_package(lint_source, root)


def main(argv=None) -> int:
    return lintcore.lint_main(
        "racelint",
        "lint lock discipline: guarded-field escapes, threaded global "
        "mutation, unjoined threads, check-then-act dict races",
        run, argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
