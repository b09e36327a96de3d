"""The port's codec layer (encoders + CodecService) held against the JAX package.

Same seeded numpy inputs go through the JAX encoder/service and the port's,
on the CPU (device="cpu"); every comparison is exact byte equality. The
CodecService cases of test_encoder.py, test_blobstore_pipeline.py,
test_ranged_reads.py and test_pm_codes.py are ported here against the port.
"""

import io
import threading
import time

import numpy as np
import pytest
import torch

from chubaofs_tpu.codec import new_encoder as j_new_encoder
from chubaofs_tpu.codec.codemode import get_tactic as j_get_tactic
from chubaofs_tpu.codec.service import CodecService as JCodecService
from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore import trace as t_trace
from chubaofs_tpu_torch.codec import CodeMode, new_encoder
from chubaofs_tpu_torch.codec import pm as t_pm
from chubaofs_tpu_torch.codec import service as t_service
from chubaofs_tpu_torch.codec.codemode import get_tactic
from chubaofs_tpu_torch.codec.encoder import InvalidShardsError
from chubaofs_tpu_torch.codec.service import CodecService
from chubaofs_tpu_torch.models import ARCHIVE, FLAGSHIP, REGISTRY
from chubaofs_tpu_torch.ops import gf256, rs
from chubaofs_tpu_torch.utils.exporter import registry

CPU = "cpu"
# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores (and their timing-sensitive tests) alone
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture
def svc():
    s = CodecService(device=CPU, max_wait_ms=0.5)
    yield s
    s.close()


@pytest.fixture(scope="module")
def jsvc():
    s = JCodecService(max_wait_ms=0.5)
    yield s
    s.close()


# -- encoder verbs against the JAX encoder --------------------------------------


@pytest.mark.parametrize("mode,kill", [
    ("EC6P3", [0, 7, 8]), ("EC12P4", [0, 5, 12, 15]), ("EC3P3", [1]),
    ("EC6P3L3", [0, 9]), ("EC16P20L2", [0, 3, 17, 36]), ("EC4P4L2", [2, 8]),
    ("RG6P6", [0, 4, 9]), ("RG4P4", [1, 6]),
])
def test_encoder_verbs_match_jax(rng, mode, kill):
    jenc, tenc = j_new_encoder(mode), new_encoder(mode, device=CPU)
    t = tenc.tactic
    data = rng.integers(0, 256, 3 * t.N * 700 + 11, dtype=np.uint8).tobytes()
    js, ts = jenc.split(data), tenc.split(data)
    assert len(ts) == t.total and all(np.array_equal(a, b) for a, b in zip(js, ts))
    jenc.encode(js)
    tenc.encode(ts)
    for i, (a, b) in enumerate(zip(js, ts)):
        assert np.array_equal(a, b), f"{mode} encode shard {i}"
    assert tenc.verify(ts) and jenc.verify(js)
    golden = [s.copy() for s in ts]
    for data_only in (True, False):
        for i in kill:
            ts[i][:] = 0
            js[i][:] = 0
        verb = "reconstruct_data" if data_only else "reconstruct"
        getattr(jenc, verb)(js, kill)
        getattr(tenc, verb)(ts, kill)
        for i, (a, b) in enumerate(zip(js, ts)):
            assert np.array_equal(a, b), f"{mode} {verb} shard {i}"
        if not data_only:
            assert all(np.array_equal(a, b) for a, b in zip(ts, golden))
    assert tenc.verify(ts)
    ts[t.total - 1][0] ^= 1
    assert not tenc.verify(ts) and not jenc.verify(
        [s if i != t.total - 1 else ts[i] for i, s in enumerate(js)])
    out = io.BytesIO()
    tenc.join(out, ts, len(data))
    assert out.getvalue() == data


def test_encoder_bookkeeping_matches_jax():
    for mode in ("EC6P3L3", "EC12P4", "RG6P6"):
        jenc, tenc = j_new_encoder(mode), new_encoder(mode, device=CPU)
        shards = list(range(tenc.tactic.total))
        assert tenc.get_data_shards(shards) == jenc.get_data_shards(shards)
        assert tenc.get_parity_shards(shards) == jenc.get_parity_shards(shards)
        assert tenc.get_local_shards(shards) == jenc.get_local_shards(shards)
        assert tenc.get_shards_in_idc(shards, 0) == jenc.get_shards_in_idc(shards, 0)
        assert type(tenc).__name__ == type(jenc).__name__


def test_encoder_rejects_bad_input():
    enc = new_encoder(CodeMode.EC6P3, device=CPU)
    shards = enc.split(b"x" * 5000)
    with pytest.raises(InvalidShardsError):
        enc.verify(shards[:-1])
    ro = [np.frombuffer(bytes(s), np.uint8) for s in shards]
    with pytest.raises(InvalidShardsError):
        enc.encode(ro)
    with pytest.raises(InvalidShardsError):
        new_encoder(CodeMode.RG6P6, device=CPU).encode(
            [np.zeros(7, np.uint8) for _ in range(12)])


def test_model_zoo_matches_jax():
    from chubaofs_tpu import models as j_models

    assert FLAGSHIP.name == "ec12p4-8mib" and ARCHIVE.name == "ec20p4l2-16mib"
    assert sorted(REGISTRY) == sorted(j_models.REGISTRY)
    for name, m in REGISTRY.items():
        jm = j_models.REGISTRY[name]
        assert (m.mode.name, m.stripe_bytes, m.shard_len) == \
            (jm.mode.name, jm.stripe_bytes, jm.shard_len)


# -- CodecService against the JAX CodecService ------------------------------------


@pytest.mark.parametrize("mode", ["EC6P3", "EC12P4", "EC6P3L3", "EC16P20L2", "RG6P6", "RG4P4"])
def test_service_encode_tactic_matches_jax(svc, jsvc, rng, mode):
    t, jt = get_tactic(mode), j_get_tactic(mode)
    k = t.sub_units * 1000 + (0 if t.is_regenerating else 7)
    data = rng.integers(0, 256, (t.N, k), dtype=np.uint8)
    want = np.asarray(jsvc.encode_tactic(jt, data).result(timeout=60))
    got = svc.encode_tactic(t, data).result(timeout=60)
    assert got.shape == (t.total, k) and np.array_equal(got, want)
    if not t.L and not t.is_regenerating:
        assert np.array_equal(svc.encode(t.N, t.M, data).result(timeout=60), want)


def test_service_repairs_match_jax(svc, jsvc, rng):
    n, m, k = 12, 4, 3000
    data = rng.integers(0, 256, (n, k), dtype=np.uint8)
    stripe = np.asarray(jsvc.encode(n, m, data).result(timeout=60))
    for bad, data_only in [([3], False), ([0, 5, 12], False), ([1, 13], True), ([14], True)]:
        broken = stripe.copy()
        broken[bad] = 0
        want = np.asarray(jsvc.reconstruct(n, m, broken, bad, data_only).result(timeout=60))
        got = svc.reconstruct(n, m, broken, bad, data_only).result(timeout=60)
        assert np.array_equal(got, want), (bad, data_only)
    present = [0, 1, 2, 4, 6, 7, 8, 9, 10, 11, 13, 14]
    want_rows = [3, 5, 12]
    sur = stripe[np.asarray(present), 100:900]
    got = svc.decode_rows(n, m, present, sur, want_rows).result(timeout=60)
    assert np.array_equal(
        got, np.asarray(jsvc.decode_rows(n, m, present, sur, want_rows).result(timeout=60)))
    assert np.array_equal(got, stripe[np.asarray(want_rows), 100:900])
    mat = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    x = rng.integers(0, 256, (7, 333), dtype=np.uint8)
    got = svc.matmul(mat, x).result(timeout=60)
    assert np.array_equal(got, np.asarray(jsvc.matmul(mat, x).result(timeout=60)))
    assert np.array_equal(got, gf256.gf_matmul(mat, x))
    with pytest.raises(ValueError):
        svc.matmul(mat, x[:6])


@pytest.mark.parametrize("mode", ["RG6P6", "RG4P4"])
def test_service_reconstruct_tactic_matches_jax(svc, jsvc, rng, mode):
    t, jt = get_tactic(mode), j_get_tactic(mode)
    data = rng.integers(0, 256, (t.N, t.sub_units * 40), dtype=np.uint8)
    stripe = svc.encode_tactic(t, data).result(timeout=60)
    for bad in ([0], [1, t.total - 1], list(range(t.M))):
        garb = stripe.copy()
        garb[bad] = 0
        for data_only in (False, True):
            want = np.asarray(jsvc.reconstruct_tactic(jt, garb, bad, data_only).result(timeout=60))
            got = svc.reconstruct_tactic(t, garb, bad, data_only).result(timeout=60)
            assert np.array_equal(got, want), (bad, data_only)
    garb = stripe.copy()
    with pytest.raises(ValueError):
        svc.reconstruct_tactic(t, garb, list(range(t.M + 1))).result(timeout=60)
    # an RS tactic goes through the RS repair path
    rt = get_tactic("EC6P3")
    st = svc.encode_tactic(rt, rng.integers(0, 256, (6, 256), dtype=np.uint8)).result(timeout=60)
    broken = st.copy()
    broken[[2, 7]] = 0
    assert np.array_equal(svc.reconstruct_tactic(rt, broken, [2, 7]).result(timeout=60), st)


# -- CodecService cases ported from the JAX package's suites -----------------------


def test_encode_tactic_service_lrc(rng):
    """(test_encoder.py) encode_tactic returns a full LRC stripe that the
    LrcEncoder verifies (globals AND local stripes)."""
    t = get_tactic(CodeMode.EC6P3L3)
    svc = CodecService(device=CPU)
    try:
        data = rng.integers(0, 256, (t.N, 4096), dtype=np.uint8)
        stripe = svc.encode_tactic(t, data).result()
        assert stripe.shape == (t.total, 4096)
        assert new_encoder(CodeMode.EC6P3L3, device=CPU).verify(list(stripe))
    finally:
        svc.close()


def test_codec_service_concurrent_mixed_load():
    """(test_encoder.py) Many threads race mixed encode/reconstruct jobs of
    different shapes through one CodecService: every future resolves to
    oracle-exact results."""
    svc = CodecService(max_batch=8, max_wait_ms=1.0, device=CPU)
    errors: list[str] = []

    def worker(seed: int):
        r = np.random.default_rng(seed)
        try:
            for i in range(6):
                n, m = (6, 3) if (seed + i) % 2 else (4, 2)
                k = int(r.choice([512, 1024, 1536]))
                data = r.integers(0, 256, (n, k), dtype=np.uint8)
                stripe = svc.encode(n, m, data).result(timeout=30)
                want = gf256.encode_numpy(rs.get_kernel(n, m, CPU).gen, data)
                if not np.array_equal(stripe, want):
                    errors.append(f"seed {seed} iter {i}: encode mismatch")
                    return
                broken = stripe.copy()
                bad = int(r.integers(0, n + m))
                broken[bad] = 0
                fixed = svc.reconstruct(n, m, broken, [bad]).result(timeout=30)
                if not np.array_equal(fixed, want):
                    errors.append(f"seed {seed} iter {i}: reconstruct mismatch")
                    return
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(f"seed {seed}: {type(e).__name__}: {e}")

    jobs0 = registry("codec").counter("jobs_total").value
    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "worker deadlocked"
        assert not errors, errors
        assert registry("codec").counter("jobs_total").value - jobs0 == 8 * 6 * 2
    finally:
        svc.close()


# every public entry of the service, each called on rows of one (12, k)
# uint8 block: the data rows, a stripe with garbage at its bad rows, or the
# survivors of a window
_ENTRIES = {
    "encode": lambda svc, x: svc.encode(6, 3, x[:6]),
    "matmul": lambda svc, x: svc.matmul(x[:2, :6], x[:6]),
    "decode_rows": lambda svc, x: svc.decode_rows(
        6, 3, [0, 2, 3, 5, 6, 8], x[:6], [1, 4]),
    "reconstruct": lambda svc, x: svc.reconstruct(6, 3, x[:9], [1, 7]),
    "encode_tactic_rs": lambda svc, x: svc.encode_tactic(
        get_tactic(CodeMode.EC6P3), x[:6]),
    "encode_tactic_lrc": lambda svc, x: svc.encode_tactic(
        get_tactic(CodeMode.EC6P3L3), x[:6]),
    "encode_tactic_pm": lambda svc, x: svc.encode_tactic(
        get_tactic(CodeMode.RG4P4), x[:4]),
    "reconstruct_tactic_rs": lambda svc, x: svc.reconstruct_tactic(
        get_tactic(CodeMode.EC6P3), x[:9], [1, 7]),
    "reconstruct_tactic_pm": lambda svc, x: svc.reconstruct_tactic(
        get_tactic(CodeMode.RG4P4), x[:8], [0, 5]),
}


@pytest.mark.parametrize("entry", list(_ENTRIES))
def test_lrc_encode_cancel_chains_and_service_survives(rng, entry):
    """(test_blobstore_pipeline.py) cancel on any entry's future chains to
    its queued codec job: the job never reaches the device, the job queued
    beside it delivers, and the service then serves the next job."""
    call = _ENTRIES[entry]
    x = rng.integers(0, 256, (12, 3000), dtype=np.uint8)
    svc = CodecService(device=CPU, max_wait_ms=200.0)
    try:
        jobs = registry("codec").counter("jobs_total")
        jobs0 = jobs.value
        keep = call(svc, x)
        drop = call(svc, x)
        assert drop.cancel()
        kept = keep.result(timeout=30)
        assert drop.cancelled()
        assert jobs.value - jobs0 == 1
        assert np.array_equal(call(svc, x).result(timeout=30), kept)
        assert jobs.value - jobs0 == 2
    finally:
        svc.close()


def test_cancelled_job_is_skipped_before_device_work():
    """A job cancelled while queued never reaches the device: the drain's
    running handshake drops it and later cancel() on a running job fails."""
    svc = CodecService(device=CPU, max_wait_ms=200.0)
    try:
        data = np.ones((4, 128), np.uint8)
        jobs0 = registry("codec").counter("jobs_total").value
        keep = svc.encode(4, 2, data)
        drop = svc.encode(4, 2, data)
        assert drop.cancel()
        assert keep.result(timeout=30).shape == (6, 128)
        assert drop.cancelled()
        assert registry("codec").counter("jobs_total").value - jobs0 == 1
        assert not keep.cancel()  # already finished
    finally:
        svc.close()


def test_decode_rows_column_sliced(rng):
    """(test_ranged_reads.py) decoding survivors restricted to a byte window
    yields exactly the same window of the wanted shards."""
    n, m, k = 6, 3, 4096
    svc = CodecService(device=CPU)
    try:
        data = rng.integers(0, 256, (n, k), dtype=np.uint8)
        stripe = np.asarray(svc.encode(n, m, data).result())
        present = [0, 2, 3, 5, 6, 8]
        want = [1, 4]
        lo, hi = 100, 900
        full = np.asarray(svc.decode_rows(
            n, m, present, stripe[np.asarray(present), :], want).result())
        assert np.array_equal(full, stripe[np.asarray(want), :])
        window = np.asarray(svc.decode_rows(
            n, m, present, stripe[np.asarray(present), lo:hi], want).result())
        assert window.shape == (len(want), hi - lo)
        assert np.array_equal(window, stripe[np.asarray(want), lo:hi])
        with pytest.raises(ValueError):
            svc.decode_rows(n, m, present, stripe[:5], want)
    finally:
        svc.close()


def test_erasure_fuzz_beta_path_and_multi_loss_fallback(rng):
    """(test_pm_codes.py) regenerating modes at the service layer: single
    loss via helper payloads + repair matmul, multi-loss via the any-k
    fallback decode — both byte-identical."""
    svc = CodecService(max_wait_ms=0.5, device=CPU)
    try:
        for mode in (CodeMode.RG6P6, CodeMode.RG4P4):
            t = get_tactic(mode)
            kern = t_pm.get_kernel(t.total, t.N)
            data = rng.integers(0, 256, (t.N, t.sub_units * 29), dtype=np.uint8)
            stripe = np.asarray(svc.encode_tactic(t, data).result(timeout=30))
            assert np.array_equal(stripe, kern.encode(data))
            for _ in range(4):
                fail = int(rng.integers(0, t.total))
                alive = [i for i in range(t.total) if i != fail]
                helpers = sorted(rng.choice(alive, size=t.helpers, replace=False).tolist())
                payloads = np.stack([
                    np.frombuffer(kern.helper_payload(fail, stripe[h]), np.uint8)
                    for h in helpers])
                mat = kern.repair_matrix(fail, helpers)
                got = np.asarray(svc.matmul(mat, payloads).result(timeout=30))
                assert np.array_equal(got.reshape(-1), stripe[fail])
            for n_bad in range(2, t.M + 1):
                bad = sorted(rng.choice(t.total, size=n_bad, replace=False).tolist())
                garb = stripe.copy()
                garb[bad] = 0
                fixed = np.asarray(svc.reconstruct_tactic(t, garb, bad).result(timeout=30))
                assert np.array_equal(fixed, stripe), (mode, bad)
    finally:
        svc.close()


# -- lifecycle, devices, observability ------------------------------------------


def test_close_semantics():
    svc = CodecService(device=CPU)
    assert svc.encode(4, 2, np.ones((4, 64), np.uint8)).result(timeout=30).shape == (6, 64)
    svc.close()
    svc.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        svc.encode(4, 2, np.ones((4, 64), np.uint8))
    never = CodecService(device=CPU)
    never.close()  # closing a service that never started is fine
    with pytest.raises(RuntimeError):
        never.matmul(np.ones((1, 4), np.uint8), np.ones((4, 8), np.uint8))


def test_service_without_cuda_raises_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CodecService()
    with pytest.raises(RuntimeError):
        new_encoder(CodeMode.EC6P3)
    monkeypatch.setattr(t_service, "_default", None)
    with pytest.raises(RuntimeError):
        t_service.default_service()
    CodecService(device=CPU).close()
    # a grid names its devices: a CPU grid runs without CUDA, and a device
    # other than the grid's first is refused
    from chubaofs_tpu_torch.parallel import codec_mesh

    CodecService(mesh=codec_mesh([torch.device(CPU)] * 2)).close()
    with pytest.raises(ValueError, match="first device"):
        CodecService(device=CPU, mesh=codec_mesh([torch.device("cuda", 0)]))


def test_service_attributes_stages_and_counts_batches(svc, rng):
    reg = registry("codec")
    before = reg.counter("kind_jobs_total", {"kind": "matmul"}).value
    batches0 = reg.counter("batches_total").value
    with t_trace.start_span("put") as span:
        f = svc.matmul(rng.integers(0, 256, (2, 3), dtype=np.uint8),
                       rng.integers(0, 256, (3, 100), dtype=np.uint8))
    f.result(timeout=30)
    names = [s[0] for s in span.stages]
    assert {"wait.codec", "codec.host", "codec.launch"} <= set(names)
    assert reg.counter("kind_jobs_total", {"kind": "matmul"}).value == before + 1
    assert reg.counter("batches_total").value - batches0 >= 1


def _at(span, prefix):
    """The span's stages whose names start with `prefix`, as sorted
    (start, end, name) on the perf_counter clock."""
    return sorted((span.start + off, span.start + off + dur, name)
                  for name, off, dur in span.stages if name.startswith(prefix))


@pytest.mark.parametrize("kind", ["encode", "decode_rows", "matmul", "reconstruct",
                                  "encode_tactic_lrc", "reconstruct_tactic_pm"])
def test_queue_wait_ends_where_the_batch_tiles_its_wall(rng, kind):
    """A job's wait.codec runs from its submission to the start of its
    batch, and the batch's codec.host and codec.launch stages then cover
    its wall end to end, one after the other."""
    x = rng.integers(0, 256, (12, 3000), dtype=np.uint8)
    svc = CodecService(device=CPU, max_wait_ms=5.0)
    try:
        with t_trace.start_span("get") as span:
            t_before = time.perf_counter()
            f = _ENTRIES[kind](svc, x)
            t_after = time.perf_counter()
            f.result(timeout=30)
            t_result = time.perf_counter()
    finally:
        svc.close()
    ((w0, w1, _),) = _at(span, "wait.codec")
    assert t_before <= w0 <= t_after and w1 >= w0
    (h0, h1, host), (l0, l1, launch) = _at(span, "codec.")
    assert (host, launch) == ("codec.host", "codec.launch")
    assert h0 == pytest.approx(w1, abs=1e-9) and h1 == pytest.approx(l0, abs=1e-9)
    assert h0 < h1 < l1 <= t_result


def test_every_rider_of_a_batch_gets_its_wall_and_its_own_wait(rng):
    """Jobs from three spans that share one batch: each span carries the
    batch's codec.host and codec.launch, the same for all, and its own
    wait.codec from its own submission."""
    svc = CodecService(device=CPU, max_wait_ms=300.0, max_batch=3)
    spans, futs = [], []
    try:
        for _ in range(3):
            with t_trace.start_span("get") as span:
                futs.append(svc.encode(4, 2, rng.integers(0, 256, (4, 1000), dtype=np.uint8)))
            spans.append(span)
            time.sleep(0.01)
        for f in futs:
            f.result(timeout=30)
    finally:
        svc.close()
    batch = _at(spans[0], "codec.")
    assert [name for _, _, name in batch] == ["codec.host", "codec.launch"]
    for sp in spans[1:]:
        assert _at(sp, "codec.") == [(pytest.approx(s, abs=1e-9), pytest.approx(e, abs=1e-9), n)
                                     for s, e, n in batch]
    waits = [_at(sp, "wait.codec")[0] for sp in spans]
    assert waits[0][0] < waits[1][0] < waits[2][0]
    assert all(w[1] == pytest.approx(batch[0][0], abs=1e-9) for w in waits)


def test_encode_failpoint_fires_in_the_port(rng):
    """rs.encode armed in the port's registry fails the port's encode and
    leaves the JAX package's encoder untouched."""
    t_chaos.arm("rs.encode", "error(disk gone)")
    enc = new_encoder(CodeMode.EC6P3, device=CPU)
    shards = enc.split(rng.integers(0, 256, 6000, dtype=np.uint8).tobytes())
    with pytest.raises(t_chaos.FailpointError):
        enc.encode(shards)
    jenc = j_new_encoder(CodeMode.EC6P3)
    js = jenc.split(bytes(6000))
    jenc.encode(js)
    assert jenc.verify(js)


@pytest.mark.parametrize("mode", ["EC6P3", "EC6P3L3", "RG4P4"])
def test_encoder_enable_verify_matches_jax(rng, mode):
    """enable_verify re-checks each encode on the device; the stripe is the
    JAX encoder's, byte for byte."""
    jenc = j_new_encoder(mode, enable_verify=True)
    tenc = new_encoder(mode, device=CPU, enable_verify=True)
    data = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    js, ts = jenc.split(data), tenc.split(data)
    jenc.encode(js)
    tenc.encode(ts)
    assert all(np.array_equal(a, b) for a, b in zip(js, ts))
