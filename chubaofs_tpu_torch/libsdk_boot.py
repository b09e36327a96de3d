"""Bootstrap the embedded-interpreter side of libcfs.so.

Reference counterpart: libsdk/libsdk.go's newClient — parse the config,
build the SDK stack for one volume, hand back the handle the C ABI
dispatches on. The C++ shim (native/libsdk/libcfs.cc) imports exactly this
module and calls `new_mount(config_json)`.

`native/libsdk/libcfs.cc` names the JAX package's boot module. This
package's own library is built by `build_libcfs()`: the shim's sources
copied with that one module name replaced by this module's, compiled by
the same Makefile with `BUILD=` pointing at `build/libsdk_torch/`, never
at `native/libsdk/build/`.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

from chubaofs_tpu_torch.client.mount import Mount
from chubaofs_tpu_torch.sdk.cluster import RemoteCluster

_ROOT = pathlib.Path(__file__).resolve().parents[1]
NATIVE_DIR = _ROOT / "native" / "libsdk"
BUILD_ROOT = _ROOT / "build" / "libsdk_torch"
SOURCES = ("libcfs.cc", "libcfs.h", "cfs_smoke.c", "cfs_posix_soak.c")
TARGETS = ("libcfs.so", "cfs_smoke", "cfs_posix_soak")
REFERENCE_BOOT = "chubaofs_tpu.libsdk_boot"
BOOT = "chubaofs_tpu_torch.libsdk_boot"


def new_mount(config_json: str) -> Mount:
    cfg = json.loads(config_json)
    masters = cfg.get("masterAddr") or cfg.get("masterAddrs")
    if isinstance(masters, str):
        masters = [masters]
    if not masters:
        raise ValueError("config needs masterAddr")
    vol = cfg.get("volName")
    if not vol:
        raise ValueError("config needs volName")
    access = cfg.get("accessAddr") or cfg.get("accessAddrs")
    if isinstance(access, str):
        access = [access]
    cluster = RemoteCluster(masters, access_addrs=access)
    # client() builds the gateway client of a cold volume here, at boot,
    # so the first cold write does not import the codec chain
    fs = cluster.client(vol)
    return Mount(fs, volume=vol, audit_dir=cfg.get("logDir"),
                 client_id=cfg.get("clientId", ""))


def port_sources() -> dict[str, str]:
    """The shim's sources with the boot module renamed to this one."""
    srcs = {n: (NATIVE_DIR / n).read_text(encoding="utf-8") for n in SOURCES}
    quoted = f'"{REFERENCE_BOOT}"'
    if srcs["libcfs.cc"].count(quoted) != 1:
        raise RuntimeError(f"libcfs.cc does not import {REFERENCE_BOOT} once")
    srcs["libcfs.cc"] = srcs["libcfs.cc"].replace(quoted, f'"{BOOT}"')
    return srcs


def _python_var() -> list[str]:
    # the Makefile reads `$(PYTHON)-config`; build against this interpreter
    # when its -config script sits beside it
    if os.path.exists(f"{sys.executable}-config"):
        return [f"PYTHON={sys.executable}"]
    return []


def build_libcfs(timeout: float = 300.0) -> str:
    """Build libcfs.so, cfs_smoke and cfs_posix_soak for this package and
    return their directory, `build/libsdk_torch/<key>/`. The key hashes the
    sources, the Makefile and the interpreter, so a changed source or
    Python rebuilds. The build runs in a private temporary directory and
    is renamed into place whole: a process that finds the directory finds
    a finished build, and concurrent builds each discard their own."""
    srcs = port_sources()
    makefile = NATIVE_DIR / "Makefile"
    h = hashlib.sha256()
    for name in sorted(srcs):
        h.update(name.encode() + b"\0" + srcs[name].encode() + b"\0")
    h.update(makefile.read_bytes())
    h.update(f"{sys.executable}\0{sys.version}".encode())
    out = BUILD_ROOT / h.hexdigest()[:16]
    if all((out / t).exists() for t in TARGETS):
        return str(out)
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=".build-", dir=BUILD_ROOT))
    try:
        src = tmp / "src"
        src.mkdir()
        for name, text in srcs.items():
            (src / name).write_text(text, encoding="utf-8")
        built = tmp / "out"
        proc = subprocess.run(
            ["make", "-C", str(src), "-f", str(makefile), f"BUILD={built}",
             *_python_var(), *(f"{built}/{t}" for t in TARGETS)],
            capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"libcfs build failed:\n{proc.stdout}\n{proc.stderr}")
        try:
            os.rename(built, out)
        except OSError:
            # another process renamed its finished build first
            if not all((out / t).exists() for t in TARGETS):
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return str(out)
