"""The readers of the preload's PUT path (the program's process-wide
counters: the trace module's stage totals, the HTTP face's time by method,
the codec's encode batches) on a small host run: each reads a number after
a preload, and nothing where the process has counted no PUT."""

import pytest

from benchmark import system
from benchmark.tests.small import rehearse
from chubaofs_tpu_torch.utils import exporter

CELL = "blob_3az.get_degraded"
SHARES = ["access.put.encode_pct", "access.put.wait_codec_pct", "access.put.codec_host_pct",
          "access.put.submit_pct", "access.put.write_pct", "http.put.face_pct"]
READERS = SHARES + ["access.put.mean_ms", "codec.jobs_per_batch.put"]


@pytest.fixture(scope="module")
def preloaded():
    """One small run of the cell in a process whose registries start empty:
    the window's spans as the run's traced context holds them, and the
    registries the run counted into."""
    from benchmark import run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(exporter, "_registries", {})
        with system.SpanRecorder() as rec:
            line = rehearse(CELL)
        assert line["correct"], line["checks"]
        regs = exporter._registries
    ctx = {"spans": rec.spans, "codec": {"batches": 0, "jobs": 0, "dispatch_s": 0.0},
           "traced_s": 1.5, "device": None, "records": []}
    return run, ctx, regs


@pytest.mark.parametrize("name", READERS)
def test_reads_the_preload(preloaded, monkeypatch, name):
    run, ctx, regs = preloaded
    monkeypatch.setattr(exporter, "_registries", regs)
    got = run.load_reader(name)(ctx)
    assert got is not None and got > 0
    if name in SHARES:
        assert got <= 100
    if name == "codec.jobs_per_batch.put":
        assert got >= 1


def test_each_preload_put_counts_once_in_the_gateway_and_the_face(preloaded, monkeypatch):
    """Every PUT of the preload came through the HTTP face and is one
    `access.put` span; no single stage takes the whole of the PUTs' time."""
    run, ctx, regs = preloaded
    monkeypatch.setattr(exporter, "_registries", regs)
    put = regs["trace"].counter("spans_total", {"op": "access.put"}).value
    assert put == regs["evloop"].counter("http_requests_total", {"method": "PUT"}).value > 0
    read = {n: run.load_reader(n)(ctx) for n in READERS}
    assert read["access.put.encode_pct"] < 100 and read["access.put.write_pct"] < 100


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_a_put(preloaded, monkeypatch, name):
    """A process that counted no PUT: the readers read nothing, though the
    context holds the window's spans."""
    run, ctx, _ = preloaded
    assert ctx["spans"]
    monkeypatch.setattr(exporter, "_registries", {})
    assert run.load_reader(name)(ctx) is None
