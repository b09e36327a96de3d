"""The cases of tests/test_bench_helpers.py, run against the port's bench
(chubaofs_tpu_torch/bench.py) on the CPU, and the port's own.

The reference file's docstring:

bench.py helper logic (no device needed): timing statistics, plausibility
floors, and the grouped staging contract the benchmark relies on.

The port keys HBM peaks by the card's name, times with CUDA events (driven
here by a fake event whose elapsed time is the reference's scripted clock),
and probes CUDA where the reference probes the TPU backend. Its own cases: a
host device refused with the staged line, the same config keys as the
reference's main(), and each staged config holding the JAX package's matrix
and giving its bytes.
"""

import ast
import itertools
import json
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from chubaofs_tpu.codec.encoder import lrc_parity_matrix as j_lrc_parity_matrix
from chubaofs_tpu.models import ARCHIVE as J_ARCHIVE
from chubaofs_tpu.ops import bitmatrix as j_bitmatrix
from chubaofs_tpu.ops import rs as j_rs
from chubaofs_tpu_torch import bench
from chubaofs_tpu_torch.ops import rs

REF = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)


def test_hbm_peak_known_and_unknown_kinds(monkeypatch):
    assert bench.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    assert bench.hbm_peak("mystery accelerator") == float("inf")
    # unknown kind -> no plausibility gate
    assert bench.hbm_floor(1 << 30, "mystery accelerator") == 0.0
    assert bench.hbm_floor(3.35e12, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
    # a device is looked up by the name CUDA gives it; a host device has none
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert bench.hbm_peak(torch.device("cuda", 0)) == 3.35e12
    assert bench.hbm_peak("cuda:0") == 3.35e12
    assert bench.hbm_peak(torch.device("cpu")) == float("inf")
    assert bench.hbm_peak("cpu") == float("inf")


class _ScriptedEvent:
    """torch.cuda.Event on the CPU: the elapsed time of each start/end pair
    is the next scripted delta."""

    script: list = []

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return _ScriptedEvent.script.pop(0) * 1e3  # milliseconds


def test_throughput_median_rejects_subfloor_passes(monkeypatch):
    """A corrupted (faster-than-physics) pass must not win: throughput() must
    discard sub-floor slopes and report the median of the plausible passes."""
    # each timed(n_iters) call consumes one delta; slope of pass p =
    # (delta(n2) - delta(n1)) / 30. Pass 2 is corrupted (near-zero slope).
    # throughput() times the n2 leg FIRST, then n1 — pairs below are
    # scripted in call order (delta_n2, delta_n1)
    deltas = list(itertools.chain(
        [0.0],  # warmup timed(2)
        [40e-3, 10e-3] * 3,  # pass 1: slope 1e-3
        [10e-3, 10e-3] * 3,  # pass 2: corrupted — slope 0 (sub-floor)
        [80e-3, 20e-3] * 3,  # pass 3: slope 2e-3
    ))
    calls = []
    monkeypatch.setattr(torch.cuda, "Event", _ScriptedEvent)
    monkeypatch.setattr(_ScriptedEvent, "script", list(deltas))
    per = bench.throughput(lambda: calls.append(1), (), n1=10, n2=40, runs=3,
                           passes=3, floor=1e-4)
    # plausible slopes {1e-3, 2e-3}; median of the sorted pair = 2e-3
    assert per == pytest.approx(2e-3)
    assert len(calls) == 2 + 3 * 3 * (40 + 10)
    # the same script through slope() directly
    script = list(deltas)
    assert bench.slope(lambda iters: script.pop(0), n1=10, n2=40, runs=3,
                       passes=3, floor=1e-4) == pytest.approx(2e-3)


def test_headline_metric_constant_used_everywhere():
    tree = ast.parse(pathlib.Path(bench.__file__).read_text(encoding="utf-8"))
    # the metric literal may appear ONLY as the constant's assignment; the
    # error path and main() must reference HEADLINE_METRIC (comments and
    # docstrings quoting the name are fine — only real string constants count)
    literal_sites = [
        n for n in ast.walk(tree)
        if isinstance(n, ast.Constant) and n.value == bench.HEADLINE_METRIC
    ]
    assert len(literal_sites) == 1, "metric literal duplicated outside constant"
    names = [n.id for n in ast.walk(tree)
             if isinstance(n, ast.Name) and n.id == "HEADLINE_METRIC"]
    assert len(names) >= 3  # definition + error path + main()


def test_stage_grouped_layout_contract(rng):
    """stage_grouped's host view must match rs.group_stack's g for the batch."""
    kernel = rs.get_kernel(6, 3, "cpu")
    host = rng.integers(0, 256, (8, 6, 256), dtype=np.uint8)
    mat_s, data = bench.stage_grouped(torch.device("cpu"), host, kernel.parity_bits)
    _, g = rs.group_stack(kernel.parity_bits, 8)
    assert data.shape == (8 // g, g * 6, 256)
    assert mat_s.shape == (g * 24, g * 48)
    # the port never stacks: the batch is the host's, on the device named
    assert g == 1 and data.device.type == "cpu" and data.is_contiguous()
    assert np.array_equal(data.numpy(), host)


def test_probe_failure_emits_staged_diagnostics(monkeypatch, capsys):
    """A dead CUDA probe must die diagnosable: the single JSON line names the
    probe phase that failed, the exact command, timing, rc and stderr tail."""

    def fake_run(cmd, capture_output=True, timeout=None, check=True):
        err = subprocess.CalledProcessError(1, cmd)
        # the child survived the import but found no device
        err.stdout = b"stage:python_up\nstage:torch_imported\n"
        err.stderr = b"RuntimeError: CUDA driver initialization failed\n"
        raise err

    monkeypatch.setattr(subprocess, "run", fake_run)
    with pytest.raises(SystemExit) as exc:
        bench._resolve_device(timeout_s=5.0)
    assert exc.value.code == 2
    line = capsys.readouterr().out.strip().splitlines()[-1]
    blob = json.loads(line)
    assert blob["error"].startswith(
        "CUDA probe failed in cuda_init_list_devices")
    probe = blob["probe"]
    assert probe["failed_in"] == "cuda_init_list_devices"
    assert probe["stages_reached"] == ["stage:python_up", "stage:torch_imported"]
    assert probe["rc"] == 1 and probe["timed_out"] is False
    assert "driver initialization failed" in probe["stderr_tail"]
    assert probe["cmd"][0] and "-c" in probe["cmd"]
    assert probe["elapsed_s"] >= 0


def test_probe_timeout_names_hung_phase(monkeypatch, capsys):
    def fake_run(cmd, capture_output=True, timeout=None, check=True):
        raise subprocess.TimeoutExpired(cmd, timeout,
                                        output=b"stage:python_up\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    with pytest.raises(SystemExit):
        bench._resolve_device(timeout_s=1.0)
    blob = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert blob["probe"]["failed_in"] == "import_torch"  # hung importing torch
    assert blob["probe"]["timed_out"] is True
    assert "timed out" in blob["error"]


# -- the port's own cases ---------------------------------------------------------


def test_host_device_refused_with_staged_line(monkeypatch, capsys):
    """--device cpu is refused before any work (no probe child, no staging)
    with the staged line and exit 2: there is no host kernel to time."""

    def no_probe(*a, **kw):
        raise AssertionError("probed a device for a host --device")

    monkeypatch.setattr(subprocess, "run", no_probe)
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu"])
    assert exc.value.code == 2
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    blob = json.loads(out[0])
    assert blob["metric"] == bench.HEADLINE_METRIC
    assert blob["value"] == 0.0 and blob["vs_baseline"] == 0.0
    assert blob["probe"]["failed_in"] == "device_check"
    assert "not a CUDA device" in blob["error"]


def _config_keys(path: pathlib.Path) -> list[str]:
    """The config keys main() measures, in source order: every string
    constant of main() that names an EC config's figure."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    consts = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Constant)
                     and isinstance(n.value, str) and n.value.startswith("ec")
                     and n.value.endswith(("_gbps", "_per_sec"))),
                    key=lambda n: (n.lineno, n.col_offset))
    return list(dict.fromkeys(n.value for n in consts))


def test_config_keys_match_reference():
    keys = _config_keys(pathlib.Path(bench.__file__))
    assert keys == _config_keys(REF)
    assert keys == [
        "ec4p2_encode_1mib_gbps", "ec6p3_encode_4mib_gbps", "ec12p4_encode_8mib_gbps",
        "ec12p4_encode_8mib_pipe_dyn_gbps", "ec12p4_encode_8mib_pipe_static_gbps",
        "ec12p4_reconstruct_1miss_gbps", "ec12p4_bulk_repair_3miss_stripes_per_sec",
        "ec12p4_bulk_repair_3miss_gbps", "ec20p4l2_encode_16mib_gbps"]


def test_staged_configs_match_jax_package(monkeypatch):
    """Each staged config at batch 2 and k = 256: the port's matrix is the
    JAX package's byte for byte, its input is what the JAX package's bench
    stages from the same seed, and one call on the CPU gives the JAX
    package's rs.gf_matmul_bytes bytes. Its floor counts the bytes the
    reference's does (a host has no HBM peak: the H100's stands in)."""
    k, batch = 256, 2
    monkeypatch.setattr(bench, "hbm_peak", lambda dev: 3.35e12)

    def ref_encode(seed, n, m):
        mat = j_rs.get_kernel(n, m).parity_bits
        host = np.random.default_rng(seed).integers(0, 256, (batch, n, k), dtype=np.uint8)
        return mat, host

    def ref_reconstruct(seed, n, m, missing):
        kernel = j_rs.get_kernel(n, m)
        mat, present, _ = kernel.repair_plan(list(missing))
        data = np.random.default_rng(seed).integers(0, 256, (batch, n, k), dtype=np.uint8)
        stripe = np.asarray(kernel.encode(data))
        return mat, stripe[:, np.asarray(present), :]

    def ref_lrc(seed):
        t = J_ARCHIVE.tactic
        mat = j_bitmatrix.expand_matrix(j_lrc_parity_matrix(t)).astype(np.int8)
        host = np.random.default_rng(seed).integers(0, 256, (batch, t.N, k), dtype=np.uint8)
        return mat, host

    cases = [
        ("ec6p3_encode",
         lambda s: bench.stage_encode(np.random.default_rng(s), "cpu", 6, 3, 6 * k, batch),
         lambda s: ref_encode(s, 6, 3), (6 + 3) * k),
        ("ec12p4_reconstruct_1miss",
         lambda s: bench.stage_reconstruct(np.random.default_rng(s), "cpu", 12, 4, 12 * k,
                                           batch, [0]),
         lambda s: ref_reconstruct(s, 12, 4, [0]), (12 + 1) * k),
        ("ec12p4_bulk_repair_3miss",
         lambda s: bench.stage_reconstruct(np.random.default_rng(s), "cpu", 12, 4, 12 * k,
                                           batch, [0, 5, 12]),
         lambda s: ref_reconstruct(s, 12, 4, [0, 5, 12]), (12 + 3) * k),
        ("ec20p4l2_encode",
         lambda s: bench.stage_lrc_encode(np.random.default_rng(s), "cpu", batch, k=k),
         ref_lrc, (20 + 4 + 2) * k),
    ]
    for seed, (name, port, ref, moved) in enumerate(cases):
        st = port(seed)
        mat, x = ref(seed)
        assert np.array_equal(np.asarray(st.mat, np.int8), np.asarray(mat, np.int8)), name
        (data,) = st.args
        assert data.dtype == torch.uint8 and data.device.type == "cpu", name
        assert np.array_equal(data.numpy(), x), name
        got = st.fn(data)
        want = np.asarray(j_rs.gf_matmul_bytes(mat, x))
        assert got.shape == want.shape and np.array_equal(got.numpy(), want), name
        n = x.shape[1]
        assert st.payload == batch * n * k, name
        assert st.floor == pytest.approx(batch * moved / 3.35e12), name
