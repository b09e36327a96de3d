"""lintcore — the shared mechanics of the repo's static-analysis passes.

`obslint` (observability invariants) and `racelint` (lock discipline) are
both small AST passes with identical plumbing: walk every .py file under the
package, parse it, apply per-rule checks, and suppress documented exceptions
either via a line pragma (`# <tool>: <why>`) or a per-file allowlist entry.
This module IS that plumbing, extracted so the two linters cannot drift:

  * `run_package(lint_source)` — the os.walk + parse + collect loop every
    linter shares (skips __pycache__, sorts filenames so findings are
    deterministic across filesystems);
  * `has_pragma(src_lines, lineno, tag)` — the pragma contract: the flagged
    LINE carries `# <tag>: <why>` with a NON-EMPTY reason. A bare `# tag:`
    does not suppress — every exception must say why it is one, or the next
    reader (and the next linter run) can't audit it;
  * `path_matches(relpath, suffixes)` — the per-file allowlist primitive
    (suffix match, so linting an installed package and linting a checkout
    agree);
  * `lint_main(...)` — the shared CLI shape (`cfs-obslint` / `cfs-racelint`):
    findings to stderr, a count line, exit 1 on any finding, `<name>: clean`
    on success.

Both linters are wired into tier-1 (tests/test_torch_obslint.py,
tests/test_torch_racelint.py), so a rule regression — or plumbing drift —
fails the build the day it lands. `package_root()` is chubaofs_tpu_torch's
directory: the port's linters lint the port unless given another root.
"""

from __future__ import annotations

import os
import sys
from collections.abc import Callable, Iterator

# files that ARE the sanctioned packet-serving layer — exempt from the
# serving-model rules (racelint thread-per-conn, obslint hand-framed
# sendall). ONE definition so the linters can't drift apart.
PACKET_LAYER_PATHS = ("rpc/evloop.py", "rpc/httpevloop.py",
                      "proto/packet.py")


def package_root() -> str:
    """Directory of the installed chubaofs_tpu_torch package (the default
    lint target)."""
    import chubaofs_tpu_torch

    return os.path.dirname(os.path.abspath(chubaofs_tpu_torch.__file__))


def iter_py_files(root: str) -> Iterator[tuple[str, str]]:
    """Yield (abspath, relpath) for every .py under root, deterministic
    order, __pycache__ pruned."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                yield path, os.path.relpath(path, root)


def line_at(src_lines: list[str], lineno: int) -> str:
    """The 1-indexed source line, or "" out of range (synthetic AST nodes)."""
    return src_lines[lineno - 1] if 0 < lineno <= len(src_lines) else ""


def has_pragma(src_lines: list[str], lineno: int, tag: str) -> bool:
    """True when the flagged line carries `# <tag>: <non-empty why>`.

    The reason is REQUIRED: a pragma is a claim that a human judged this
    exception safe, and the judgment must be written down where the lint
    points."""
    line = line_at(src_lines, lineno)
    marker = tag + ":"
    i = line.find(marker)
    if i < 0:
        return False
    return bool(line[i + len(marker):].strip())


def path_matches(relpath: str, suffixes) -> bool:
    """Per-file allowlist primitive: does relpath end with any entry?"""
    rel = relpath.replace(os.sep, "/")
    return any(rel.endswith(sfx) for sfx in suffixes)


def run_package(lint_source: Callable[[str, str], list[str]],
                root: str | None = None) -> list[str]:
    """Run one linter's lint_source over every file under root (default:
    the installed package); returns every finding."""
    if root is None:
        root = package_root()
    findings: list[str] = []
    for path, rel in iter_py_files(root):
        with open(path, encoding="utf-8") as f:
            findings.extend(lint_source(f.read(), rel))
    return findings


def lint_main(name: str, description: str,
              run: Callable[[str | None], list[str]], argv=None) -> int:
    """The shared CLI: findings to stderr, count, exit 1 when dirty."""
    import argparse

    p = argparse.ArgumentParser(prog=f"cfs-{name}", description=description)
    p.add_argument("root", nargs="?", default=None,
                   help="directory to lint (default: the installed package)")
    args = p.parse_args(argv)
    findings = run(args.root)
    for f in findings:
        print(f, file=sys.stderr)
    if findings:
        print(f"{name}: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print(f"{name}: clean")
    return 0
