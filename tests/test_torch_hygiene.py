"""Import hygiene of the port: chubaofs_tpu_torch and chip_smoke.py never
reach JAX or the JAX package.

The check on module names is exact: "chubaofs_tpu" or "chubaofs_tpu.<sub>".
A prefix test on "chubaofs_tpu" would also match "chubaofs_tpu_torch" and
pass vacuously.
"""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "chubaofs_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import chubaofs_tpu_torch
names = ["chubaofs_tpu_torch"]
for mod in pkgutil.walk_packages(chubaofs_tpu_torch.__path__, "chubaofs_tpu_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.")
             or m == "chubaofs_tpu" or m.startswith("chubaofs_tpu."))
print(len(names))
print(",".join(bad))
"""

# an import statement naming jax/jaxlib or the JAX package (exact package
# name: chubaofs_tpu_torch does not match)
_BAD_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|chubaofs_tpu)(?:\.|\s|,|$)", re.M)


def test_port_imports_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split("\n") + [""] * (
        2 - len(proc.stdout.strip().split("\n")))
    assert int(count) >= 20, proc.stdout  # every module of the slice imported
    assert bad == "", f"port pulled in: {bad}"


def test_port_sources_name_no_jax_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for f in files:
        hits = _BAD_IMPORT.findall(f.read_text(encoding="utf-8"))
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_exact_name_check_is_not_vacuous():
    assert _BAD_IMPORT.search("from chubaofs_tpu.ops import rs")
    assert _BAD_IMPORT.search("import chubaofs_tpu")
    assert _BAD_IMPORT.search("import jax.numpy as jnp")
    assert not _BAD_IMPORT.search("from chubaofs_tpu_torch.ops import rs")
    assert not _BAD_IMPORT.search("import chubaofs_tpu_torch")


def test_kernel_source_note_and_build_target():
    from chubaofs_tpu_torch.ops import cuda_gf

    src = cuda_gf.SOURCE.read_text(encoding="utf-8")
    assert "chubaofs_tpu/ops/pallas_gf.py::_gf_kernel" in src
    assert "3.35 TB/s" in src and "__global__" in src
    assert "arch=compute_90a,code=sm_90a" in cuda_gf.NVCC_FLAGS
    assert cuda_gf.BUILD_DIR == ROOT / "build" / "kernels"
    gitignore = (ROOT / ".gitignore").read_text(encoding="utf-8").split()
    assert "build/" in gitignore
