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
    assert int(count) >= 105, proc.stdout  # every module of the slices imported
    assert bad == "", f"port pulled in: {bad}"
    # the daemon slice's planes, the grid slice and the file cluster are on
    # the walk
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
                "objectnode.server"):
        assert f"chubaofs_tpu_torch.{mod}" in names, mod


def test_port_sources_name_no_jax_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 106
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
                "HEARTBEAT_INTERVAL"],
    }
    for mod, attrs in names.items():
        assert (PKG / (mod.replace(".", "/") + ".py")).exists() or (PKG / mod / "__init__.py").exists()
        m = importlib.import_module(f"chubaofs_tpu_torch.{mod}")
        for a in attrs:
            assert hasattr(m, a), f"{mod}.{a}"
    from chubaofs_tpu_torch import cmd

    assert sorted(cmd.ROLES) == ["authnode", "blobstore", "datanode", "master",
                                 "metanode", "objectnode"]
