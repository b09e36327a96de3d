"""The cases of tests/test_racelint.py, run against the port's racelint.

test_repo_is_clean lints chubaofs_tpu_torch itself (the port's default lint
root) with an empty ALLOWLIST and wants zero findings; it pins the lock
around ops/cuda_gf_pipe.py::_sm_count. The synthetic cases feed the port's
rules the reference's sources, and the check-then-act case holds the port's
findings against the JAX package's on the same source."""

import textwrap

from chubaofs_tpu.tools import racelint as ref_racelint
from chubaofs_tpu_torch.tools import lintcore, racelint


def test_repo_is_clean():
    assert lintcore.package_root().endswith("chubaofs_tpu_torch")
    assert racelint.ALLOWLIST == {}
    findings = racelint.run()
    assert findings == [], "\n".join(findings)


# -- rule 1: guarded-field escape ---------------------------------------------


def test_flags_guarded_field_escape():
    src = textwrap.dedent("""
        import threading
        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.depth = 0
            def inc(self):
                with self._lock:
                    self.depth += 1
            def reset(self):
                self.depth = 0
    """)
    findings = racelint.lint_source(src, "x.py")
    assert len(findings) == 1
    assert "guarded-field-escape" in findings[0] and "depth" in findings[0]


def test_escape_covers_container_mutators():
    src = textwrap.dedent("""
        class S:
            def add(self, k, v):
                with self._lock:
                    self.items[k] = v
            def drop_all(self):
                self.items.clear()
    """)
    findings = racelint.lint_source(src, "x.py")
    assert len(findings) == 1 and "items" in findings[0]


def test_init_and_construction_helpers_exempt():
    # __init__ and methods reachable ONLY from it are pre-publication
    src = textwrap.dedent("""
        class S:
            def __init__(self):
                self.items = {}
                self._load()
            def _load(self):
                self.items["boot"] = 1
            def add(self, k, v):
                with self._lock:
                    self.items[k] = v
    """)
    assert racelint.lint_source(src, "x.py") == []


def test_locked_suffix_declares_guard():
    src = textwrap.dedent("""
        class S:
            def put(self, k, v):
                with self._lock:
                    self.items[k] = v
                    self._evict_locked()
            def _evict_locked(self):
                self.items.pop("old", None)
    """)
    assert racelint.lint_source(src, "x.py") == []


def test_pragma_needs_a_reason():
    src = textwrap.dedent("""
        class S:
            def inc(self):
                with self._lock:
                    self.n += 1
            def reset(self):
                self.n = 0  # racelint: bench-epoch reset, callers quiesce first
    """)
    assert racelint.lint_source(src, "x.py") == []
    bare = src.replace("# racelint: bench-epoch reset, callers quiesce first",
                       "# racelint:")
    assert len(racelint.lint_source(bare, "x.py")) == 1


# -- rule 2: threaded global mutation -----------------------------------------


def test_flags_threaded_global_mutation():
    src = textwrap.dedent("""
        import threading
        _CACHE = {}
        class Daemon:
            def start(self):
                threading.Thread(target=self._run, daemon=True).start()
            def _run(self):
                _CACHE["state"] = 1
    """)
    findings = racelint.lint_source(src, "x.py")
    assert len(findings) == 1
    assert "threaded-global-mutation" in findings[0] and "_CACHE" in findings[0]


def test_global_mutation_under_lock_passes():
    src = textwrap.dedent("""
        import threading
        _CACHE = {}
        _CACHE_LOCK = threading.Lock()
        class Daemon:
            def start(self):
                threading.Thread(target=self._run, daemon=True).start()
            def _run(self):
                with _CACHE_LOCK:
                    _CACHE["state"] = 1
    """)
    assert racelint.lint_source(src, "x.py") == []


def test_unthreaded_class_may_mutate_globals():
    src = textwrap.dedent("""
        _CACHE = {}
        class Plain:
            def run(self):
                _CACHE["state"] = 1
    """)
    assert racelint.lint_source(src, "x.py") == []


# -- rule 3: unjoined thread/executor -----------------------------------------


def test_flags_unjoined_executor_and_thread():
    src = textwrap.dedent("""
        import threading
        from concurrent.futures import ThreadPoolExecutor
        class S:
            def __init__(self):
                self._pool = ThreadPoolExecutor(4)
            def spawn(self):
                threading.Thread(target=self._run).start()
    """)
    findings = racelint.lint_source(src, "x.py")
    assert len(findings) == 2
    assert all("unjoined-thread" in f for f in findings)


def test_joined_daemonized_and_context_managed_pass():
    src = textwrap.dedent("""
        import threading
        from concurrent.futures import ThreadPoolExecutor
        class S:
            def __init__(self):
                self._pool = ThreadPoolExecutor(4)
                self._thread = threading.Thread(target=self._run)
            def bg(self):
                threading.Thread(target=self._run, daemon=True).start()
            def batch(self, jobs):
                with ThreadPoolExecutor(8) as pool:
                    list(pool.map(self._run, jobs))
            def local_wait(self):
                t = threading.Thread(target=self._run)
                t.start()
                t.join()
            def close(self):
                self._pool.shutdown(wait=False)
                self._thread.join()
    """)
    assert racelint.lint_source(src, "x.py") == []


def test_join_scope_is_per_class_and_per_function():
    # a same-named handle joined in ANOTHER class/function must not
    # whitelist this one
    src = textwrap.dedent("""
        from concurrent.futures import ThreadPoolExecutor
        import threading
        class Closes:
            def __init__(self):
                self._pool = ThreadPoolExecutor(4)
            def close(self):
                self._pool.shutdown()
        class Leaks:
            def __init__(self):
                self._pool = ThreadPoolExecutor(4)
        def waits():
            t = threading.Thread(target=print)
            t.start()
            t.join()
        def leaks():
            t = threading.Thread(target=print)
            t.start()
    """)
    findings = racelint.lint_source(src, "x.py")
    assert len(findings) == 2
    assert all("unjoined-thread" in f for f in findings)
    lines = sorted(int(f.split(":")[1]) for f in findings)
    # the Leaks class ctor and the leaks() local, not their joined twins
    assert "ThreadPoolExecutor(4)" in src.splitlines()[lines[0] - 1]
    assert "threading.Thread(target=print)" in src.splitlines()[lines[1] - 1]


# -- rule 4: check-then-act ---------------------------------------------------


def test_flags_check_then_act_del_and_insert():
    src = textwrap.dedent("""
        _REGISTRY = {}
        class S:
            def forget(self, k):
                if k in self.cache:
                    del self.cache[k]
        def register(k, v):
            if k not in _REGISTRY:
                _REGISTRY[k] = v
    """)
    findings = racelint.lint_source(src, "x.py")
    assert len(findings) == 2
    assert all("check-then-act" in f for f in findings)
    assert findings == ref_racelint.lint_source(src, "x.py")
    # the shape ops/cuda_gf_pipe.py::_sm_count had before it took its lock
    unlocked = textwrap.dedent("""
        _sms = {}
        def _sm_count(idx):
            if idx not in _sms:
                _sms[idx] = probe(idx)
            return _sms[idx]
    """)
    assert len(racelint.lint_source(unlocked, "ops/cuda_gf_pipe.py")) == 1


def test_check_then_act_locked_or_local_passes():
    src = textwrap.dedent("""
        class S:
            def forget(self, k):
                with self._lock:
                    if k in self.cache:
                        del self.cache[k]
            def tally(self, keys):
                seen = {}
                for k in keys:
                    if k not in seen:
                        seen[k] = 0
                return seen
            def _evict_locked(self, k):
                # *_locked declares the caller holds the lock (rule-1 contract)
                if k in self.cache:
                    del self.cache[k]
    """)
    assert racelint.lint_source(src, "x.py") == []


# -- allowlist machinery ------------------------------------------------------


def test_allowlist_suppresses_per_rule_per_file(monkeypatch):
    src = textwrap.dedent("""
        class S:
            def forget(self, k):
                if k in self.cache:
                    del self.cache[k]
    """)
    assert len(racelint.lint_source(src, "pkg/tool.py")) == 1
    monkeypatch.setitem(
        racelint.ALLOWLIST, "pkg/tool.py",
        {"check-then-act": "single-threaded CLI, dicts never shared"})
    assert racelint.lint_source(src, "pkg/tool.py") == []
    # same file, OTHER rules still fire
    other = textwrap.dedent("""
        class S:
            def inc(self):
                with self._lock:
                    self.n += 1
            def reset(self):
                self.n = 0
    """)
    assert len(racelint.lint_source(other, "pkg/tool.py")) == 1


# -- rule 5: thread-per-connection serving ------------------------------------


def test_flags_thread_per_conn_serving():
    src = textwrap.dedent("""
        import threading
        class Srv:
            def _accept(self):
                while True:
                    conn, _ = self.listener.accept()
                    threading.Thread(target=self._serve, args=(conn,),
                                     daemon=True).start()
    """)
    findings = racelint.lint_source(src, "x.py")
    assert any("thread-per-conn" in f for f in findings)


def test_thread_per_conn_exemptions():
    src = textwrap.dedent("""
        import threading
        class Srv:
            def _accept(self):
                conn, _ = self.listener.accept()
                threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True).start()
    """)
    # the sanctioned layer is exempt by path
    assert racelint.lint_source(src, "rpc/evloop.py") == []
    # a pragma WITH a reason suppresses (the CFS_EVLOOP=0 shim contract)
    shim = textwrap.dedent("""
        import threading
        class Srv:
            def _accept(self):
                conn, _ = self.listener.accept()
                threading.Thread(  # racelint: CFS_EVLOOP=0 rollback shim
                    target=self._serve, args=(conn,), daemon=True).start()
    """)
    assert racelint.lint_source(shim, "x.py") == []
    # a non-connection worker arg doesn't trip the rule
    worker = textwrap.dedent("""
        import threading
        class Pump:
            def start(self):
                threading.Thread(target=self._run, args=(self.q,),
                                 daemon=True).start()
    """)
    assert all("thread-per-conn" not in f
               for f in racelint.lint_source(worker, "x.py"))
