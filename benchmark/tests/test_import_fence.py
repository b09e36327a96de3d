"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their top-level name, whole: `chubaofs_tpu_torch` begins with
`chubaofs_tpu` and is not it."""

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
JAX_NAMES = {"jax", "jaxlib", "flax", "chubaofs_tpu"}


def imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def sources():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_top_level_names_compared_whole():
    assert imports(__file__) >= {"ast", "os"}
    assert "chubaofs_tpu_torch".split(".")[0] not in JAX_NAMES


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: imports(p) & JAX_NAMES for p in sources()}
    assert not {p: n for p, n in found.items() if n}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for p in sources():
        if p.startswith(ref + os.sep):
            assert imports(p) <= {"__future__", "functools", "dataclasses", "numpy", "benchmark"}, p


def test_no_jax_after_a_rehearsal_of_every_cell():
    """Each cell's plan and checking code, run end to end on the host at a
    small size in a fresh interpreter, leaves no JAX module loaded."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark.tests.small import rehearse_all\n"
        "rehearse_all()\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'chubaofs_tpu'})\n"
        "assert 'chubaofs_tpu_torch' in sys.modules\n"
        "print('FOUND', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
