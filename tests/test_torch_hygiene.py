"""Import hygiene of the port: chubaofs_tpu_torch and chip_smoke.py never
reach JAX or the JAX package.

The check on module names is exact: "chubaofs_tpu" or "chubaofs_tpu.<sub>".
A prefix test on "chubaofs_tpu" would also match "chubaofs_tpu_torch" and
pass vacuously.
"""

import ast
import http.server
import pathlib
import re
import subprocess
import sys
import threading

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "chubaofs_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import chubaofs_tpu_torch
names = ["chubaofs_tpu_torch"]
for mod in pkgutil.walk_packages(chubaofs_tpu_torch.__path__, "chubaofs_tpu_torch."):
    if mod.name.endswith(".__main__"):
        continue  # runs its CLI when imported; its source is checked below
    importlib.import_module(mod.name)
    names.append(mod.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.")
             or m == "chubaofs_tpu" or m.startswith("chubaofs_tpu."))
print(len(names))
print(",".join(bad))
print(",".join(names))
"""

# an import statement naming jax/jaxlib or the JAX package (exact package
# name: chubaofs_tpu_torch does not match)
_BAD_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|chubaofs_tpu)(?:\.|\s|,|$)", re.M)


def test_port_imports_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad, names = proc.stdout.rstrip("\n").split("\n")
    assert int(count) >= 123, proc.stdout  # every module of the slices imported
    assert bad == "", f"port pulled in: {bad}"
    # the daemon slice's planes, the grid slice, the file cluster, the
    # console, the client and the operator tools are on the walk
    names = set(names.split(","))
    for mod in ("proto.packet", "rpc.evloop", "rpc.httpevloop", "rpc.server",
                "rpc.client", "rpc.pool", "autopilot.controller",
                "tools.cfsstat", "cli.blobstore", "cmd", "blobstore.gateway",
                "blobstore.cmd", "utils.flightrec", "utils.shutdown",
                "parallel.mesh", "entry", "tools.cfsdoctor", "tools.cfstrace",
                "tools.cfsevents", "tools.cfstop", "tools.chaos_soak",
                "chaos.soak", "raft.server", "raft.transport",
                "storage.extent_store", "meta.metanode", "data.datanode",
                "authnode.server", "master.master", "sdk.fs", "deploy",
                "utils.logger", "meta.service", "master.gapi",
                "master.api_service", "sdk.cluster", "testing.harness",
                "cli.main", "utils.qos", "objectnode.acl",
                "objectnode.auth", "objectnode.cors", "objectnode.policy",
                "objectnode.volume", "objectnode.multipart",
                "objectnode.server", "console", "console.server", "client",
                "client.mount", "client.fuse_ll", "libsdk_boot",
                "tools.fsck", "tools.authtool", "tools.autofs",
                "tools.fdstore", "tools.preload", "tools.localcluster",
                "tools.lintcore", "tools.obslint", "tools.racelint",
                "tools.perfbench", "tools.capacity", "tools.kernel_ab"):
        assert f"chubaofs_tpu_torch.{mod}" in names, mod


def test_port_sources_name_no_jax_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 124
    for f in files:
        hits = _BAD_IMPORT.findall(f.read_text(encoding="utf-8"))
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


# the one string of the port that names a module of the JAX package: the
# boot module a libcfs built from native/libsdk loads unless the port's build
# renames it (libsdk_boot.build_libcfs rewrites the name in the sources; the
# port never imports it)
_ALLOWED_STRINGS = {("libsdk_boot.py", "REFERENCE_BOOT"): "chubaofs_tpu.libsdk_boot"}
# an import statement anywhere in a string: at a line's start or after `;`
_STRING_IMPORT = re.compile(
    r"(?:^|;)\s*(?:from|import)\s+(?:jax|jaxlib|chubaofs_tpu)(?:\.|\s|,|$)", re.M)
# run as a module: `python -m chubaofs_tpu.<module>`
_RUN_MODULE = re.compile(r"-m\s+(?:jax|jaxlib|chubaofs_tpu)(?:\.|\s|$)")
_MODULE_NAME = re.compile(r"(?:jax|jaxlib|chubaofs_tpu)(?:\.\w+)*")


def _code_strings(src: str) -> list[tuple[int, str | None, str]]:
    """(line, assigned name or None, value) of every string constant in a
    source that imports or runs JAX or a module of the JAX package as code:
    an import statement inside the string, `-m <module>`, or a bare module
    name (what importlib.import_module or `python -m` take)."""
    tree = ast.parse(src)
    names = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names[id(node.value)] = t.id
    hits = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
            continue
        v = node.value
        if (_STRING_IMPORT.search(v) or _RUN_MODULE.search(v)
                or _MODULE_NAME.fullmatch(v.strip())):
            hits.append((node.lineno, names.get(id(node)), v))
    return hits


def test_port_strings_run_no_jax_package_code():
    """No string of the port imports or runs JAX or the JAX package as code:
    the driver commands perfbench hands a child interpreter, the daemon
    configs and the build steps name chubaofs_tpu_torch. An import inside a
    string literal is invisible to the import-statement check above."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    allowed = []
    for f in files:
        for line, name, value in _code_strings(f.read_text(encoding="utf-8")):
            if _ALLOWED_STRINGS.get((f.name, name)) == value:
                allowed.append((f.name, name))
                continue
            raise AssertionError(f"{f.relative_to(ROOT)}:{line} runs {value!r}")
    assert allowed == [("libsdk_boot.py", "REFERENCE_BOOT")]
    # the check sees the shapes it exists for
    bad = [
        'CMD = "import sys\\nfrom chubaofs_tpu.tools.perfbench import _gw_driver\\n"',
        'CMD = "import chubaofs_tpu.cmd"',
        'argv = [sys.executable, "-m", "chubaofs_tpu.tools.perfbench"]',
        'argv = [sys.executable, "-c", "x = 1; import jax"]',
        'MOD = "chubaofs_tpu.tools.capacity"',
    ]
    for src in bad:
        assert _code_strings(src), src
    good = [
        'CMD = "import sys\\nfrom chubaofs_tpu_torch.tools.perfbench import _gw_driver\\n"',
        'argv = [sys.executable, "-m", "chubaofs_tpu_torch.cmd"]',
        '"""Counterpart of chubaofs_tpu/ops/pallas_gf.py; the port of chubaofs_tpu."""',
    ]
    for src in good:
        assert not _code_strings(src), src


class _OkHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"ok")

    def log_message(self, *a):
        pass


def test_perfbench_driver_child_loads_no_jax(monkeypatch, capfd):
    """A driver child that perfbench's _spawn_driver starts (the paced
    fairness driver, against a local HTTP server) imports neither JAX nor
    the JAX package: the child interpreter reports every module it imports
    (PYTHONPROFILEIMPORTTIME) on the stderr it shares with this test."""
    from chubaofs_tpu_torch.tools import perfbench

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _OkHandler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    try:
        addr = f"127.0.0.1:{srv.server_address[1]}"
        proc = perfbench._spawn_driver(perfbench._PACED_DRIVER_CMD,
                                       [addr, "/x", 20.0, 0.3])
        try:
            (out,) = perfbench._drive([proc], "probe")
        finally:
            if proc.poll() is None:
                proc.kill()
    finally:
        srv.shutdown()
        srv.server_close()
    assert out["statuses"].get("200", 0) > 0, out
    imported = {line.rsplit("|", 1)[1].strip()
                for line in capfd.readouterr().err.splitlines()
                if line.startswith("import time:") and "|" in line}
    assert "chubaofs_tpu_torch.tools.perfbench" in imported
    bad = sorted(m for m in imported
                 if m.split(".")[0] in ("jax", "jaxlib", "chubaofs_tpu"))
    assert bad == [], bad


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


def test_pipe_kernel_source_note_and_build_target():
    from chubaofs_tpu_torch.ops import cuda_gf, cuda_gf_pipe

    src = cuda_gf_pipe.SOURCE.read_text(encoding="utf-8")
    assert re.search(r"chubaofs_tpu/ops/pallas_gf_pipe\.py::_make_kernel\b(?!_)", src)
    assert "chubaofs_tpu/ops/pallas_gf_pipe.py::_make_kernel_static" in src
    assert "sm_90a" in src and "3.35 TB/s" in src and "__global__" in src
    assert "cp.async" in src and f"kPipeStages = {cuda_gf_pipe.STAGES};" in src
    assert cuda_gf_pipe.SOURCE.parent == cuda_gf.SOURCE.parent


def test_slice_modules_exist_with_reference_names():
    """Every module of the blobstore slice sits at the reference's relative
    path and exports the names the reference's callers use."""
    import importlib

    names = {
        "utils.crc32block": ["CrcError"], "utils.breaker": ["CircuitBreaker"],
        "utils.ratelimit": ["TokenBucket"], "utils.kvstore": ["open_kv", "PyKV"],
        "blockcache": ["BcacheClient", "BcacheManager", "BcacheService"],
        "blobstore.iostat": ["IOStat"], "blobstore.taskswitch": ["SwitchMgr"],
        "blobstore.recordlog": ["RecordLog"], "blobstore.resourcepool": ["MemPool", "PoolLimitError"],
        "blobstore.clustermgr": ["ClusterMgr", "DISK_BROKEN"],
        "blobstore.blobnode": ["BlobNode", "NoSuchShard"],
        "chaos": ["ChaosScheduler", "Fault", "FaultPlan", "builtin_plan",
                  "corrupt_shard_on_disk", "failpoint"],
        "blobstore.proxy": ["Proxy"], "blobstore.cache": ["BlobCache"],
        "blobstore.access": ["Access", "Location", "select_code_mode"],
        "blobstore.scheduler": ["Scheduler", "RepairWorker"],
        "blobstore.cluster": ["MiniCluster"], "ops.cuda_gf_pipe": ["gf_matmul_bytes_pipelined"],
        "proto.packet": ["PacketFramer", "advance_iov", "packet_iov", "MAX_DATA_LEN"],
        "rpc": ["HTTPError", "Router", "RPCServer", "RPCClient", "ConnectionPool"],
        "rpc.httpevloop": ["HttpEvloopCore", "MAX_BODY_BYTES"],
        "rpc.evloop": ["EvloopServer"],
        "utils.profiler": ["capture"], "utils.metrichist": ["MetricHistory"],
        "utils.slo": ["evaluate"], "utils.alerts": ["AlertManager"],
        "utils.flightrec": ["FlightRecorder"], "autopilot": ["Autopilot"],
        "tools.cfsstat": ["diff_metrics", "main"],
        "blobstore.gateway": ["AccessGateway", "AccessClient", "build_router",
                              "parse_http_range"],
        "blobstore.cmd": ["ModuleRunner", "add_admin_routes"],
        "cli.blobstore": ["BlobCli", "main"], "utils.shutdown": ["await_shutdown"],
        "cmd": ["BlobstoreDaemon", "ROLES", "start_role", "main"],
        "parallel": ["codec_mesh", "group_view", "shard_stripes", "sharded_codec_step",
                     "sharded_gf_matmul", "ungroup_stripe"],
        "tools.cfsdoctor": ["read_bundle", "summarize", "diff_bundles", "main"],
        "entry": ["entry", "dryrun_multichip"],
        "tools.cfstrace": ["build_tree", "critical_path", "stage_overlap", "waterfall",
                           "flamegraph", "aggregate", "render_top", "render_report",
                           "read_dir", "fetch", "main"],
        "tools.cfsevents": ["fetch_events", "fetch_alerts", "fetch_spans",
                            "correlate_alert_chain", "correlate", "bundle_events",
                            "bundle_alerts", "bundle_spans", "main"],
        "tools.cfstop": ["split_rollup", "compute_row", "compute_rows", "render",
                         "frame_record", "main"],
        "chaos.soak": ["SoakFailure", "run_soak", "run_kill_soak", "run_cache_soak",
                       "run_meta_split_soak"],
        "tools.chaos_soak": ["ACCEPTANCE_PLANS", "main"],
        "utils.conn_pool": ["ConnPool"], "utils.cryptoutil": ["seal", "open_sealed"],
        "raft": ["RaftCore", "MultiRaft", "StateMachine", "InProcNet", "NotLeaderError"],
        "raft.codec": ["dumps", "loads", "CodecError"],
        "raft.snapcodec": ["SnapshotWriter", "read_sections", "restore_sections"],
        "raft.server": ["run_until"], "raft.transport": ["TcpNet"],
        "storage": ["ExtentStore", "ExtentNotFound", "BLOCK_SIZE"],
        "meta": ["MetaPartitionSM", "MetaNode", "ROOT_INO"],
        "meta.wire": ["enc", "dec"], "data": ["DataNode", "ReplServer"],
        "authnode": ["AuthNode", "AuthClient", "KeystoreSM", "AUTH_GROUP"],
        "authnode.api": ["build_router"],
        "master": ["Master", "MasterSM", "VolumeView", "MetaPartitionView"],
        "sdk": ["MetaWrapper", "FsClient", "FsError"],
        "sdk.stream": ["ExtentClient", "HotBackend"],
        "deploy": ["FsCluster", "BlobstoreBackend", "DATANODE_ID_BASE"],
        "utils.logger": ["get_logger", "set_level"],
        "meta.service": ["MetaService", "RemoteMetaNode"],
        "master.gapi": ["GraphQLAPI", "GQLError"],
        "master.api_service": ["MasterAPI", "MasterClient"],
        "sdk.cluster": ["RemoteCluster", "RemoteDataBackend"],
        "testing.harness": ["ProcCluster", "free_port"],
        "cli": ["main"], "cli.main": ["main"],
        "utils.qos": ["QosPlane", "FairLimiter"],
        "objectnode": ["ObjectNode", "S3Error"],
        "objectnode.auth": ["sign_v4", "sign_v2", "presign_v4"],
        "objectnode.volume": ["OSSVolume"],
        "cmd": ["MasterDaemon", "MetaNodeDaemon", "DataNodeDaemon",
                "BlobstoreDaemon", "ObjectNodeDaemon", "AuthNodeDaemon",
                "ConsoleDaemon", "ClientDaemon", "HEARTBEAT_INTERVAL"],
        "console": ["Console"], "console.server": ["Console", "main"],
        "client": ["Mount", "MountError"],
        "client.fuse_ll": ["FuseServer", "fuse_available", "mount_volume", "main"],
        "libsdk_boot": ["new_mount", "build_libcfs"],
        "tools.fsck": ["Fsck", "FsckReport", "main"], "tools.authtool": ["main"],
        "tools.autofs": ["parse_options", "map_entry_to_config", "main"],
        "tools.fdstore": ["FdStore", "FdStoreClient"],
        "tools.preload": ["Preloader", "PreloadStats", "main"],
        "tools.localcluster": ["launch", "main"],
        "tools.lintcore": ["PACKET_LAYER_PATHS", "package_root", "iter_py_files",
                           "line_at", "has_pragma", "path_matches", "run_package", "lint_main"],
        "tools.obslint": ["BANNED_LABEL_KEYS", "ALLOWED_STATS_DICTS",
                          "ALLOWED_WALLCLOCK_FILES", "lint_source", "lint_event_types",
                          "run", "main"],
        "tools.racelint": ["ALLOWLIST", "lint_source", "run", "main"],
        "tools.perfbench": ["bench_metadata", "bench_stream", "bench_smallfile",
                            "bench_meta_scale", "bench_raft_commit", "bench_put_pipeline",
                            "bench_repair", "bench_repair_codes", "bench_concurrency",
                            "bench_gateway", "bench_qos_fairness", "bench_capacity",
                            "bench_rebalance_spread", "bench_cache_zipf", "bench_ranged",
                            "bench_events", "bench_flightrec", "run", "main"],
        "tools.capacity": ["Op", "OP_KINDS", "zipf_cdf", "ramp_factor", "plan_ops",
                           "CapacityDriver", "RemoteDriver", "LocalDriver", "S3Driver",
                           "Workload", "DataLossError", "failing_slos", "Collector",
                           "SpreadMonitor", "run_capacity", "main"],
        "tools.kernel_ab": ["log", "hbm_floor", "slope", "throughput", "sweep_tiles",
                             "best", "main"],
    }
    for mod, attrs in names.items():
        assert (PKG / (mod.replace(".", "/") + ".py")).exists() or (PKG / mod / "__init__.py").exists()
        m = importlib.import_module(f"chubaofs_tpu_torch.{mod}")
        for a in attrs:
            assert hasattr(m, a), f"{mod}.{a}"
    from chubaofs_tpu_torch import cmd

    assert sorted(cmd.ROLES) == ["authnode", "blobstore", "client", "console",
                                 "datanode", "master", "metanode", "objectnode"]


_IMPORT_QUIET = r"""
import importlib, os, threading
import torch  # its own import may open what it likes; measured after it
fds = set(os.listdir("/proc/self/fd"))
mods = ["console", "console.server", "client", "client.mount", "client.fuse_ll",
        "libsdk_boot", "tools.fsck", "tools.authtool", "tools.autofs",
        "tools.fdstore", "tools.preload", "tools.localcluster", "tools.lintcore",
        "tools.obslint", "tools.racelint", "tools.perfbench", "tools.capacity",
        "tools.kernel_ab"]
for m in mods:
    importlib.import_module("chubaofs_tpu_torch." + m)
from chubaofs_tpu_torch.client import fuse_ll
print(threading.active_count(), fuse_ll._LIBC is None,
      sorted(set(os.listdir("/proc/self/fd")) - fds))
"""


def test_slice_modules_do_no_work_at_import():
    """The console, client, libsdk_boot and tool modules (the measuring and
    checking tools too) start no thread, open no file or socket and load no
    library (libc for mount(2) is loaded at the first mount) when they are
    imported."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_QUIET], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1", "True", "[]"], proc.stdout
