"""The port's kernel A/B harness (tools/kernel_ab.py).

On the CPU: the CLI refuses without a card and names it, the verdict logic
agrees with the JAX package's `best` (a function nested in its main, read
from its source), every sweep tile is a multiple of TILE_QUANTUM whose
launch fits the card's shared memory, and the slope timer's floor rule,
driven by a fake clock. On the card (marked cuda; skipped elsewhere): the
whole harness, every reading at most the HBM bound.
"""

import ast
import contextlib
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch.ops import cuda_gf, cuda_gf_pipe
from chubaofs_tpu_torch.tools import kernel_ab

REF = pathlib.Path(__file__).resolve().parents[1] / "chubaofs_tpu" / "tools" / "kernel_ab.py"


def _reference_best():
    """The JAX package's verdict function, compiled from its source."""
    tree = ast.parse(REF.read_text(encoding="utf-8"))
    node = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "best")
    ns: dict = {}
    exec(compile(ast.Module(body=[node], type_ignores=[]), str(REF), "exec"), ns)
    return ns["best"]


def test_main_without_cuda_exits_nonzero_and_names_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ab.main(["--tile-sweep"]) != 0
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "card" in out.err
    assert out.out == ""
    # a host device is refused as well: there is no host version to time
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert kernel_ab.main(["--device", "cpu"]) != 0
    out = capsys.readouterr()
    assert "not a CUDA device" in out.err and out.out == ""


def test_verdict_agrees_with_reference_best():
    ref_best = _reference_best()
    rng = np.random.default_rng(12)
    rows = [{"fused_gbps": 1.0},
            {"fused_gbps": 1.0, "pipelined_gbps": 1.0},
            {"fused_gbps": 0.0, "pipelined_static_gbps": 0.5}]
    for _ in range(200):
        row = {"fused_gbps": float(rng.integers(0, 4))}
        for key in ("pipelined_gbps", "pipelined_static_gbps"):
            if rng.random() < 0.7:
                row[key] = float(rng.integers(0, 4))
        rows.append(row)
    for row in rows:
        assert kernel_ab.best(row) == ref_best(row), row
    assert kernel_ab.best({"fused_gbps": 1.0, "pipelined_gbps": 2.0,
                           "pipelined_static_gbps": 3.0}) == "pipelined_static"


@pytest.mark.parametrize("r,n", [(4, 12), (2, 4), (3, 6), (1, 1), (8, 40)])
def test_sweep_tiles_are_quanta_that_fit_shared_memory(r, n):
    tiles = kernel_ab.sweep_tiles(r, n)
    q = cuda_gf_pipe.TILE_QUANTUM
    assert q == 256 and kernel_ab.SMEM_LIMIT == 227 * 1024
    assert tiles and tiles == sorted(set(tiles))
    for kt in tiles:
        assert kt % q == 0
        assert cuda_gf_pipe.smem_bytes(r, n, kt) <= kernel_ab.SMEM_LIMIT
    # the largest fitting tile is on the sweep and one quantum more is not
    assert cuda_gf_pipe.smem_bytes(r, n, tiles[-1] + q) > kernel_ab.SMEM_LIMIT
    if (r, n) == (4, 12):  # EC(12,4): the reference's 7424+ tiles do not fit
        assert tiles[-1] < 7424


class _FakeClock:
    """timed(iters) for `slope`: pass p costs per_pass[p] seconds a call plus
    a constant; `stall` adds seconds to the n2 leg of one run of a pass."""

    def __init__(self, per_pass, runs=3, const=0.01, stall=None):
        self.per_pass, self.runs, self.const = per_pass, runs, const
        self.stall = stall or {}
        self.calls = 0

    def __call__(self, iters: int) -> float:
        call, self.calls = self.calls, self.calls + 1
        if call == 0:  # warm-up
            return iters * self.per_pass[0] + self.const
        p, within = divmod(call - 1, 2 * self.runs)
        extra = self.stall.get((p, within), 0.0)
        return iters * self.per_pass[p] + self.const + extra


def test_slope_keeps_plausible_passes_and_errors_when_none_left():
    floor = 1e-3
    # all passes plausible: the median pass
    assert kernel_ab.slope(_FakeClock([2e-3, 3e-3, 4e-3]), floor=floor) \
        == pytest.approx(3e-3)
    # sub-floor passes are discarded: of (2e-3, 1e-6, 5e-3) the kept median
    # is 5e-3 (a pass that raced a stall in both legs reads impossibly fast)
    assert kernel_ab.slope(_FakeClock([2e-3, 1e-6, 5e-3]), floor=floor) \
        == pytest.approx(5e-3)
    # one stalled run inside a pass moves nothing: the median of its runs
    clock = _FakeClock([2e-3, 2e-3, 2e-3], stall={(1, 0): 5.0})
    assert kernel_ab.slope(clock, floor=floor) == pytest.approx(2e-3)
    # nothing plausible: an error with the raw slopes, never a number
    with pytest.raises(RuntimeError, match="no plausible pass"):
        kernel_ab.slope(_FakeClock([1e-6, 1e-5, 0.0]), floor=floor)
    # a zero or negative slope is never plausible, even without a floor
    with pytest.raises(RuntimeError, match="no plausible pass"):
        kernel_ab.slope(_FakeClock([0.0, 0.0, 0.0]), floor=0.0)
    assert kernel_ab.hbm_floor(int(3.35e12)) == pytest.approx(1.0)


@pytest.mark.cuda
def test_kernel_ab_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b1, b2 = cuda_gf.LAUNCHES, dict(cuda_gf_pipe.LAUNCHES)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert kernel_ab.main(["--tile-sweep"]) == 0
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    rows = {x["config"]: x for x in lines if "config" in x and "tile_k" not in x}
    assert set(rows) == {c[0] for c in kernel_ab.CONFIGS}
    for name, n, m, _, _ in kernel_ab.CONFIGS:
        for key in ("fused_gbps", "pipelined_gbps", "pipelined_static_gbps"):
            gbps = rows[name][key]
            assert 0 < gbps * (n + m) / n <= kernel_ab.HBM_BYTES_PER_S / 1e9, (name, key)
    sweep = [x for x in lines if x.get("config") == "ec12p4_tile_sweep"]
    assert [x["tile_k"] for x in sweep] == kernel_ab.sweep_tiles(4, 12)
    assert all(x["gbps"] > 0 for x in sweep)
    assert set(lines[-1]["verdict"]) == set(rows)
    assert cuda_gf.LAUNCHES > b1
    assert all(cuda_gf_pipe.LAUNCHES[v] > b2[v] for v in b2)
