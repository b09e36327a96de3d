"""The cases of tests/test_obslint.py, run against the port's obslint.

test_repo_is_clean lints chubaofs_tpu_torch itself (the port's default lint
root) and wants zero findings. The synthetic cases feed the port's rules the
reference's sources; rule 8's literal collector is held against the JAX
package's on the same sources."""

import ast
import textwrap

from chubaofs_tpu.tools import obslint as ref_obslint
from chubaofs_tpu_torch.tools import lintcore, obslint


def test_repo_is_clean():
    assert lintcore.package_root().endswith("chubaofs_tpu_torch")
    findings = obslint.run()
    assert findings == [], "\n".join(findings)


def test_flags_high_cardinality_label_key():
    src = textwrap.dedent("""
        def f(reg, ino):
            reg.counter("ops", {"ino": str(ino)}).add()
    """)
    findings = obslint.lint_source(src, "x.py")
    assert len(findings) == 1 and "ino" in findings[0]


def test_flags_fstring_label_value():
    src = textwrap.dedent("""
        def f(reg, bid):
            reg.gauge("depth", {"shard": f"blob-{bid}"}).set(1)
    """)
    findings = obslint.lint_source(src, "x.py")
    assert len(findings) == 1 and "f-string" in findings[0]


def test_flags_adhoc_stats_dict():
    src = textwrap.dedent("""
        class S:
            def __init__(self):
                self.stats = {"count": 0}
    """)
    findings = obslint.lint_source(src, "somewhere/new.py")
    assert len(findings) == 1 and "ad-hoc stats dict" in findings[0]


def test_flags_direct_httpconnection_outside_pool():
    src = textwrap.dedent("""
        import http.client
        def f(host):
            return http.client.HTTPConnection(host, timeout=5)
    """)
    findings = obslint.lint_source(src, "somewhere/client.py")
    assert len(findings) == 1 and "rpc/pool.py" in findings[0]
    # the pool itself is the one allowed constructor
    assert obslint.lint_source(src, "rpc/pool.py") == []
    # bare-name import form is caught too
    bare = ("from http.client import HTTPConnection\n"
            "def f(h):\n    return HTTPConnection(h)\n")
    assert len(obslint.lint_source(bare, "x.py")) == 1


def test_allows_legacy_views_and_bounded_labels():
    legacy = 'class A:\n    def __init__(self):\n        self.stats = {"batches": 0}\n'
    assert obslint.lint_source(legacy, "codec/service.py") == []
    bounded = 'def f(reg, op):\n    reg.counter("ops", {"op": op}).add()\n'
    assert obslint.lint_source(bounded, "x.py") == []


# -- rule 4: latency deltas must ride the monotonic clock ----------------------


def test_flags_walltime_deadline_arithmetic():
    src = textwrap.dedent("""
        import time
        def f(timeout):
            deadline = time.time() + timeout
            while time.time() < deadline:
                pass
    """)
    findings = obslint.lint_source(src, "somewhere/x.py")
    assert len(findings) == 1 and "time.monotonic()" in findings[0]


def test_flags_walltime_elapsed_subtraction_and_alias():
    src = textwrap.dedent("""
        import time as _time
        def f(t0, ttl):
            return _time.time() - t0 <= ttl
    """)
    findings = obslint.lint_source(src, "x.py")
    assert len(findings) == 1 and "wall clock" in findings[0]


def test_walltime_stamps_and_monotonic_pass():
    src = textwrap.dedent("""
        import time
        def f(sm):
            sm.apply(now=time.time())          # proposal stamp: wall by design
            deadline = time.monotonic() + 5    # delta: monotonic is correct
            return time.time() < deadline
    """)
    assert obslint.lint_source(src, "x.py") == []


def test_walltime_allowlist_and_pragma():
    src = textwrap.dedent("""
        import time
        def fresh(ts):
            return abs(time.time() - ts) > 300
    """)
    # authnode's request-freshness window is cross-process wall time
    assert obslint.lint_source(src, "authnode/server.py") == []
    assert len(obslint.lint_source(src, "elsewhere.py")) == 1
    pragma = ("import time\n"
              "def f(ttl):\n"
              "    return time.time() + ttl  # wallclock: protocol stamp\n")
    assert obslint.lint_source(pragma, "elsewhere.py") == []


# -- rule 6: no bare print( diagnostics in daemon code -------------------------


def test_flags_bare_print_in_daemon_code():
    src = "def boot(addr):\n    print('listening on', addr)\n"
    findings = obslint.lint_source(src, "master/master.py")
    assert len(findings) == 1 and "print" in findings[0]
    # stdout IS the interface for operator tools and the CLI — matched as
    # path SEGMENTS, so an installed-package relpath and a checkout-root
    # relpath agree (the lintcore path_matches contract)
    assert obslint.lint_source(src, "tools/cfsstat.py") == []
    assert obslint.lint_source(src, "cli/main.py") == []
    assert obslint.lint_source(src, "chubaofs_tpu_torch/tools/cfsstat.py") == []
    assert obslint.lint_source(src, "chubaofs_tpu_torch/cli/main.py") == []
    # ...but a FILE merely named tools.py is not an exempt directory
    assert len(obslint.lint_source(src, "blobstore/tools.py")) == 1
    # a reasoned pragma documents a protocol line (boot line, audit line)
    pragma = ("def boot(addr):\n"
              "    print('x')  # obslint: boot line IS the stdout protocol\n")
    assert obslint.lint_source(pragma, "master/master.py") == []
    # a bare tag with no reason does NOT suppress
    bare = "def boot(a):\n    print('x')  # obslint:\n"
    assert len(obslint.lint_source(bare, "master/master.py")) == 1
    # method calls named print (self.print, logger shims) are not this rule
    method = "def f(self):\n    self.printer.print('x')\n"
    assert obslint.lint_source(method, "master/master.py") == []


# -- rule 7: state-transition writes route through the event journal -----------


def test_flags_bare_stderr_write_in_daemon_code():
    src = ("import sys\n"
           "def on_broken(disk):\n"
           "    sys.stderr.write('disk %d broken\\n' % disk)\n")
    findings = obslint.lint_source(src, "blobstore/somewhere.py")
    assert len(findings) == 1 and "events.emit" in findings[0]
    # aliased sys works too
    alias = ("import sys as _sys\n"
             "def f():\n    _sys.stderr.write('x')\n")
    assert len(obslint.lint_source(alias, "blobstore/x.py")) == 1
    # utils/ owns the sanctioned writers (journal, auditlog, sanitizer);
    # tools/cli stderr is operator diagnostics
    assert obslint.lint_source(src, "utils/locks.py") == []
    assert obslint.lint_source(src, "tools/perfbench.py") == []
    assert obslint.lint_source(src, "chubaofs_tpu_torch/utils/locks.py") == []
    # a reasoned pragma documents a protocol line
    pragma = ("import sys\n"
              "def f():\n"
              "    sys.stderr.write('x')  # obslint: harness parses stderr\n")
    assert obslint.lint_source(pragma, "blobstore/x.py") == []
    # writes to other receivers (files, sockets) are not this rule
    other = "def f(fh):\n    fh.write('x')\n"
    assert obslint.lint_source(other, "blobstore/x.py") == []


def test_flags_handrolled_audit_dict():
    src = ('def f(disk):\n'
           '    rec = {"audit": "disk_broken", "disk": disk}\n'
           '    return rec\n')
    findings = obslint.lint_source(src, "blobstore/somewhere.py")
    assert len(findings) == 1 and "EventJournal" in findings[0]
    # the sanitizer's own audit line lives in utils/ and stays sanctioned
    assert obslint.lint_source(src, "utils/locks.py") == []
    pragma = ('def f(d):\n'
              '    return {"audit": "x", "d": d}  # obslint: legacy consumer\n')
    assert obslint.lint_source(pragma, "blobstore/x.py") == []
    # dicts without the audit key are untouched
    plain = 'def f():\n    return {"kind": "x"}\n'
    assert obslint.lint_source(plain, "blobstore/x.py") == []


def test_flags_sendall_of_encoded_packet():
    import textwrap

    src = textwrap.dedent("""
        def push(sock, pkt):
            sock.sendall(pkt.encode())
    """)
    findings = obslint.lint_source(src, "sdk/somewhere.py")
    assert len(findings) == 1 and "sendall" in findings[0]
    # the packet layer itself is exempt (it IS the sendmsg/sendall impl)
    assert obslint.lint_source(src, "proto/packet.py") == []
    assert obslint.lint_source(src, "rpc/evloop.py") == []
    # pragma with a reason documents an exception
    pragma = ("def push(sock, pkt):\n"
              "    sock.sendall(pkt.encode())  # obslint: tiny admin frame\n")
    assert obslint.lint_source(pragma, "sdk/somewhere.py") == []
    # sendall of a plain buffer (not .encode()) is not this rule's business
    plain = "def push(sock, buf):\n    sock.sendall(buf)\n"
    assert obslint.lint_source(plain, "sdk/somewhere.py") == []
    # text/JSON protocols encode strings, not Packets — not this rule either
    text = ("def push(sock, cmd):\n"
            "    sock.sendall(json.dumps(cmd).encode())\n"
            "    sock.sendall(line.encode())\n")
    assert obslint.lint_source(text, "sdk/somewhere.py") == []


# -- rule 9: actuator invocations in autopilot/ must emit a typed event --------


def test_flags_silent_actuator_invocation_in_autopilot():
    src = textwrap.dedent("""
        def fire(self, act, fp, report):
            return act.apply(fp, report)
    """)
    findings = obslint.lint_source(src, "autopilot/controller.py")
    assert len(findings) == 1 and "autopilot_" in findings[0]
    assert "fire" in findings[0]
    # checkout-root relpaths agree (segment match, as in rules 6/7)
    assert len(obslint.lint_source(
        src, "chubaofs_tpu_torch/autopilot/controller.py")) == 1
    # the same source outside autopilot/ is not this rule's business
    assert obslint.lint_source(src, "master/master.py") == []


def test_actuator_with_same_function_emit_passes():
    src = textwrap.dedent("""
        def fire(self, act, fp, report):
            undo = act.apply(fp, report)
            self._emit_decision("autopilot_executed", "executed", fp, report)
            return undo
    """)
    assert obslint.lint_source(src, "autopilot/controller.py") == []
    # plain events.emit() works too, and .rollback( is covered the same way
    rb = textwrap.dedent("""
        def undo(self, act, p, fp):
            act.rollback(p)
            events.emit("autopilot_rolled_back", "warning", entity=fp)
    """)
    assert obslint.lint_source(rb, "autopilot/controller.py") == []


def test_actuator_emit_in_nested_closure_does_not_count():
    # the emit must share the invocation's frame — a closure that MIGHT
    # run later can't prove the actuation was recorded
    src = textwrap.dedent("""
        def fire(self, act, fp, report):
            def later():
                events.emit("autopilot_executed", "info")
            act.apply(fp, report)
            return later
    """)
    assert len(obslint.lint_source(src, "autopilot/controller.py")) == 1


def test_actuator_pragma_and_wrong_type_emit():
    pragma = ("def fire(self, act, fp, r):\n"
              "    return act.apply(fp, r)"
              "  # obslint: probe call, caller records the decision\n")
    assert obslint.lint_source(pragma, "autopilot/controller.py") == []
    # a bare tag with no reason does NOT suppress
    bare = ("def fire(self, act, fp, r):\n"
            "    return act.apply(fp, r)  # obslint:\n")
    assert len(obslint.lint_source(bare, "autopilot/controller.py")) == 1
    # emitting a NON-autopilot type does not satisfy the audit contract
    wrong = textwrap.dedent("""
        def fire(self, act, fp, report):
            act.apply(fp, report)
            events.emit("task_finished", "info")
    """)
    assert len(obslint.lint_source(wrong, "autopilot/actuators.py")) == 1


def test_event_type_without_emit_site_is_flagged(monkeypatch):
    """Rule 8: a name in EVENT_TYPES with no emit( site anywhere in the
    package is a dead timeline contract — inject a phantom entry and the
    package-global pass must flag exactly it (everything real stays
    covered, per test_repo_is_clean)."""
    from chubaofs_tpu_torch.utils import events

    monkeypatch.setattr(events, "EVENT_TYPES",
                        tuple(events.EVENT_TYPES) + ("phantom_event",))
    findings = obslint.lint_event_types()
    assert len(findings) == 1, findings
    assert "phantom_event" in findings[0]
    assert "no emit( site" in findings[0]


def test_emit_literal_extraction_covers_the_emit_shapes():
    """Rule 8's collector must see every shape the package emits through:
    a plain emit() call, an attr-named emitter (self._emit_bp), a
    conditional type expression inside emit(), and the compute-then-emit
    `etype = ...` form — while ignoring unrelated string literals. The JAX
    package's collector gives the same set on the same source, and on every
    source file of the port."""
    src = textwrap.dedent("""
        def f(self, ev, cond):
            ev.emit("plain_type", detail={"k": 1})
            self._emit_bp("attr_type", 2)
            ev.emit("a_type" if cond else "b_type")
            etype = "assigned_type"
            ev.emit(etype)
            unrelated = "not_an_event"
            log("also_not_an_event")
    """)
    lits = obslint._emit_literals(ast.parse(src))
    assert {"plain_type", "attr_type", "a_type", "b_type",
            "assigned_type"} <= lits
    assert "not_an_event" not in lits
    assert "also_not_an_event" not in lits
    assert lits == ref_obslint._emit_literals(ast.parse(src))
    for path, rel in lintcore.iter_py_files(lintcore.package_root()):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=rel)
        assert obslint._emit_literals(tree) == ref_obslint._emit_literals(tree), rel
