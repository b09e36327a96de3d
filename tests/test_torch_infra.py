"""The non-rpc cases of tests/test_infra.py, run against the port on the CPU.

Exporter, config, audit log, trace spans, task switches, IO stats, record
log and memory pool. The rpc cases are tests/test_torch_rpc_infra.py."""

import threading

import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.iostat import IOStat
from chubaofs_tpu_torch.blobstore.recordlog import RecordLog
from chubaofs_tpu_torch.blobstore.resourcepool import MemPool, PoolLimitError
from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_BALANCE, SwitchMgr
from chubaofs_tpu_torch.blobstore import trace
from chubaofs_tpu_torch.utils.auditlog import AuditLog
from chubaofs_tpu_torch.utils.config import Config, ConfigError
from chubaofs_tpu_torch.utils.exporter import Registry


CPU = "cpu"
# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


# -- exporter -------------------------------------------------------------------

def test_exporter_counts_and_renders():
    reg = Registry("c1", "master")
    reg.counter("ops", {"op": "put"}).add()
    reg.counter("ops", {"op": "put"}).add(2)
    reg.gauge("disks").set(7)
    with reg.tp("put_latency"):
        pass
    text = reg.render()
    assert "cfs_c1_master_ops" in text and 'op="put"' in text and "3.0" in text
    assert "cfs_c1_master_disks 7.0" in text
    assert "cfs_c1_master_put_latency_count 1" in text


def test_exporter_tp_records_errors():
    reg = Registry()
    with pytest.raises(ValueError):
        with reg.tp("op"):
            raise ValueError("x")
    assert reg.counter("op_errors").value == 1


# -- config ---------------------------------------------------------------------

def test_config_typed_getters_and_nesting():
    cfg = Config.from_string(
        '{"role": "master", "port": 17010, "ratio": 0.5, "on": "true",'
        ' "peers": [1, 2], "mod": {"sub": {"x": 9}}}')
    assert cfg.get_string("role") == "master"
    assert cfg.get_int("port") == 17010
    assert cfg.get_float("ratio") == 0.5
    assert cfg.get_bool("on") is True
    assert cfg.get_slice("peers") == [1, 2]
    assert cfg.get_int("mod.sub.x") == 9
    assert cfg.sub("mod").get_int("sub.x") == 9
    with pytest.raises(ConfigError):
        cfg.check_required("role", "missing_key")


# -- auditlog -------------------------------------------------------------------

def test_auditlog_writes_and_rotates(tmp_path):
    log = AuditLog(str(tmp_path), max_bytes=256, max_files=3)
    for i in range(40):
        log.log_fs_op("c1", "vol", "Create", f"/a/{i}", latency_us=5)
    log.close()
    files = sorted(p.name for p in tmp_path.iterdir())
    assert "audit.log" in files and len(files) > 1


# -- trace ----------------------------------------------------------------------

def test_trace_span_propagation_and_tracklog():
    root = trace.start_span("access.put")
    with root:
        child = trace.child_of(trace.current_span(), "blobnode.putshard")
        with child:
            child.append_track_log("blobnode")
        root.append_track_log("access")
    assert child.trace_id == root.trace_id
    carrier = {}
    root.inject(carrier)
    assert carrier["Trace-Id"] == root.trace_id
    # child track entries bubble up into the parent (stream_put.go:100 shape)
    assert any(e.startswith("blobnode:") for e in root.track)
    cont = trace.start_span("remote", carrier)
    assert cont.trace_id == root.trace_id


# -- taskswitch -----------------------------------------------------------------

def test_taskswitch_blocks_and_resumes():
    kv = {}
    mgr = SwitchMgr(config_get=kv.get,
                    config_set=lambda k, v: kv.__setitem__(k, v))
    mgr.set(SWITCH_BALANCE, False)
    assert not mgr.enabled(SWITCH_BALANCE)
    assert kv["task_switch/balance"] == "false"
    waited = []

    def waiter():
        waited.append(mgr.switch(SWITCH_BALANCE).wait_enable(timeout=5))

    t = threading.Thread(target=waiter)
    t.start()
    mgr.set(SWITCH_BALANCE, True)
    t.join(timeout=5)
    assert waited == [True]
    # refresh() pulls persisted state back
    kv["task_switch/balance"] = "false"
    mgr.refresh()
    assert not mgr.enabled(SWITCH_BALANCE)


# -- iostat ---------------------------------------------------------------------

def test_iostat_shared_counters(tmp_path):
    st = IOStat("t", path=str(tmp_path / "io"))
    st.write_begin()
    st.write_done(4096, 120)
    st.read_begin()
    st.read_done(1024, 80)
    view = IOStat.view(str(tmp_path / "io"))
    assert view["wcnt"] == 1 and view["wbytes"] == 4096
    assert view["rcnt"] == 1 and view["rbytes"] == 1024 and view["rpending"] == 0
    st.close()


# -- recordlog ------------------------------------------------------------------

def test_recordlog_roundtrip(tmp_path):
    rl = RecordLog(str(tmp_path), max_bytes=200, backups=3)
    for i in range(20):
        rl.encode({"task": i, "kind": "repair"})
    recs = rl.records()
    assert {"task": 19, "kind": "repair"} in recs and len(recs) > 5
    rl.close()


# -- resourcepool ---------------------------------------------------------------

def test_mempool_classes_and_limit():
    pool = MemPool(classes=(1024, 4096), capacity_bytes=8192)
    b = pool.alloc(1000)
    assert len(b) == 1024
    b[0] = 0xFF
    pool.put(b)
    b2 = pool.alloc(1024)
    assert b2[0] == 0  # zeroed on reuse
    pool.alloc(4096)
    pool.alloc(1024)  # 1024(b2) + 4096 + 1024 = 6144
    with pytest.raises(PoolLimitError):
        pool.alloc(4096)


# -- rpc ------------------------------------------------------------------------
