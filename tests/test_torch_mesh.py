"""The port's parallel/mesh.py on a CPU grid, held against the JAX package.

Twins of tests/test_mesh.py (every case but test_pick_group_dp_cap, which
tests the MXU's group cap, a Pallas mechanism the port does not have), run
on codec_mesh(devices=[torch.device("cpu")] * 8, ...), a grid of eight
entries of the host, as the reference runs on the 8 virtual CPU devices
tests/conftest.py forces. Where the reference asserts NamedShardings, the
twins assert each block's device, row range and column range. Then the
cross-package cases: the same seeded numpy batch through the JAX package's
sharded_codec_step / sharded_gf_matmul and the port's, byte-equal
(tolerance 0: GF(2^8) math is exact). The twins that need the card are in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.ops import gf256, rs
from chubaofs_tpu_torch.parallel import (
    codec_mesh,
    shard_stripes,
    sharded_codec_step,
    ungroup_stripe,
)
from chubaofs_tpu_torch.parallel import mesh as t_mesh

N, M = 6, 3
CPU = "cpu"
CPU8 = [torch.device(CPU)] * 8
# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


def _data(rng, b, k):
    return rng.integers(0, 256, (b, N, k), dtype=np.uint8)


def _oracle_encode(data):
    gen = rs.get_kernel(N, M, CPU).gen
    return np.stack([gf256.encode_numpy(gen, d) for d in data])


def _assert_blocks(arr, mesh, full):
    """Every block of a STRIPES ShardedArray: on its grid device, holding
    its row range (B/dp rows) and column range (the aligned split) of the
    global array `full`."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    b, _, k = full.shape
    rows = b // dp
    cols = t_mesh.col_bounds(k, sp)
    shards = arr.addressable_shards
    assert len(shards) == dp * sp
    for idx, s in enumerate(shards):
        i, j = divmod(idx, sp)
        assert s.device == mesh.devices[i, j] and s.data.device == s.device
        assert s.index == (slice(i * rows, (i + 1) * rows), slice(None), slice(*cols[j]))
        assert np.array_equal(s.data.numpy(), full[s.index])


def test_codec_mesh_default_shape():
    mesh = codec_mesh(CPU8)
    assert mesh.shape["dp"] * mesh.shape["sp"] == len(CPU8)
    assert mesh.shape["sp"] == 2  # even device count defaults to sp=2


def test_codec_mesh_without_cuda_raises(monkeypatch):
    """codec_mesh() means every CUDA device: with none it raises, it never
    lays the grid over the host on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codec_mesh()
    with pytest.raises(ValueError, match="dp\\*sp"):
        codec_mesh(CPU8, dp=3)
    with pytest.raises(ValueError, match="one type"):
        codec_mesh([torch.device("cpu"), torch.device("cuda", 0)])


def test_sharded_gf_matmul_matches_hostbatch(rng):
    """The grid-wide hostbatch drop-in is numerically the single-device
    path, including row padding and a ragged k."""
    from chubaofs_tpu_torch.parallel import codec_mesh, sharded_gf_matmul

    mesh = codec_mesh(CPU8, dp=4, sp=2)
    mm = sharded_gf_matmul(mesh)  # CPU grid -> the plain version
    ker = rs.get_kernel(N, M, CPU)
    for b, k in [(8, 256), (5, 256), (3, 300)]:  # even, ragged-b, ragged-k
        data = _data(rng, b, k)
        want = rs.gf_matmul_hostbatch(ker.parity_bits, data, CPU)
        got = mm(ker.parity_bits, data)
        assert np.array_equal(got, want), (b, k)


def test_minicluster_does_not_close_injected_codec(rng, tmp_path):
    """A shared grid-backed service outlives any one cluster using it."""
    from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
    from chubaofs_tpu_torch.codec.service import CodecService

    svc = CodecService(device=CPU)
    try:
        c = MiniCluster(str(tmp_path), n_nodes=6, disks_per_node=1, codec=svc)
        c.close()
        data = rng.integers(0, 256, (N, 1024), dtype=np.uint8)
        assert svc.encode(N, M, data).result(timeout=60).shape == (N + M, 1024)
    finally:
        svc.close()


def test_codec_service_on_mesh(rng):
    """CodecService constructed with a grid routes its drained batches
    through sharded_gf_matmul: encode + reconstruct futures come back
    identical to the single-device service."""
    from chubaofs_tpu_torch.codec.service import CodecService
    from chubaofs_tpu_torch.parallel import codec_mesh

    mesh = codec_mesh(CPU8, dp=4, sp=2)
    svc = CodecService(mesh=mesh)
    ref = CodecService(device=CPU)
    try:
        assert svc.device == torch.device(CPU) and svc._mesh_mm is not None
        data = rng.integers(0, 256, (N, 4096), dtype=np.uint8)
        got = svc.encode(N, M, data).result(timeout=60)
        want = ref.encode(N, M, data).result(timeout=60)
        assert np.array_equal(got, want)
        broken = np.array(got)
        broken[1] ^= 0xFF
        fixed = svc.reconstruct(N, M, broken, [1]).result(timeout=60)
        assert np.array_equal(fixed, want)
    finally:
        svc.close()
        ref.close()


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_step_matches_oracle(rng, dp, sp):
    mesh = codec_mesh(CPU8, dp=dp, sp=sp)
    run = sharded_codec_step(mesh, N, M)
    b, k = dp * 2, sp * 256
    data = _data(rng, b, k)
    stripe, ok, repaired = run(data)

    want = _oracle_encode(data)
    np.testing.assert_array_equal(np.asarray(stripe), want)
    assert bool(np.all(np.asarray(ok)))
    # the step repairs a (data, parity) loss pattern in place; on a clean
    # stripe the recomputed rows must round-trip exactly
    np.testing.assert_array_equal(np.asarray(repaired), want)


def test_output_shardings(rng):
    mesh = codec_mesh(CPU8, dp=4, sp=2)
    run = sharded_codec_step(mesh, N, M)
    data = _data(rng, 8, 512)
    stripe, ok, repaired = run(data)

    want = _oracle_encode(data)
    for arr in (stripe, repaired):
        assert arr.spec == ("dp", None, "sp") and arr.shape == want.shape
        _assert_blocks(arr, mesh, want)
    # ok: one block per dp row, on the row's first device (where verify's
    # AND over sp was gathered)
    assert ok.spec == ("dp",) and ok.shape == (8,)
    for i, s in enumerate(ok.addressable_shards):
        assert s.device == mesh.devices[i, 0] and s.index == (slice(2 * i, 2 * i + 2),)
        assert s.data.dtype == torch.bool and s.data.device == s.device
    # every result block lives on a grid device — nothing leaked elsewhere
    assert stripe.device_set <= set(mesh.devices.flat)


def test_shard_stripes_placement(rng):
    mesh = codec_mesh(CPU8, dp=4, sp=2)
    data = _data(rng, 4, 256)
    placed = shard_stripes(mesh, data)
    assert placed.spec == ("dp", None, "sp")
    _assert_blocks(placed, mesh, data)
    assert set(placed.device_set) == set(mesh.devices.flat)


def test_verify_catches_corruption(rng):
    mesh = codec_mesh(CPU8, dp=4, sp=2)
    kernel = rs.get_kernel(N, M, CPU)
    run = sharded_codec_step(mesh, N, M)
    data = _data(rng, 8, 512)
    stripe = np.asarray(run(data)[0])

    # corrupt one byte of a parity shard in one batch element and re-verify
    bad = stripe.copy()
    bad[3, N + 1, 17] ^= 0xFF
    ok = np.asarray(kernel.verify(shard_stripes(mesh, bad), portable=True))
    assert not ok[3] and ok[[i for i in range(8) if i != 3]].all()


def test_repair_restores_lost_shards(rng):
    """The step's repair plan (lose shard 0 and parity shard N) actually
    recovers zeroed-out shards placed on the grid."""
    mesh = codec_mesh(CPU8, dp=2, sp=4)
    kernel = rs.get_kernel(N, M, CPU)
    data = _data(rng, 4, 1024)
    stripe = _oracle_encode(data)
    lost = stripe.copy()
    lost[:, 0, :] = 0
    lost[:, N, :] = 0

    plan = kernel.repair_plan([0, N])
    fixed = kernel.apply_repair(plan, shard_stripes(mesh, lost), portable=True)
    np.testing.assert_array_equal(np.asarray(fixed), stripe)


def test_sharded_step_fused_interpret(rng):
    """interpret=True on a CPU grid: B1's plain version on every block (the
    counterpart of the reference's Pallas interpret mode)."""
    mesh = codec_mesh(CPU8, dp=4, sp=2)
    run = sharded_codec_step(mesh, N, M, interpret=True)
    data = _data(rng, 8, 512)
    stripe, ok, repaired = run(data)
    np.testing.assert_array_equal(np.asarray(stripe), _oracle_encode(data))
    assert bool(np.all(np.asarray(ok)))
    np.testing.assert_array_equal(np.asarray(repaired), np.asarray(stripe))


def test_runtime_repair_plan_no_retrace(rng):
    """Changing the missing-shard pattern is runtime data: the padded plan
    keeps every shape static, so a second pattern reuses the per-shape
    setup (asserted via the step's trace counter)."""
    mesh = codec_mesh(CPU8, dp=4, sp=2)
    run = sharded_codec_step(mesh, N, M)
    data = _data(rng, 8, 512)

    s1, _, r1 = run(data, bad_idx=(0, N))
    s2, _, r2 = run(data, bad_idx=(1, 2, N + 1))
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(s1))
    np.testing.assert_array_equal(np.asarray(r2), np.asarray(s2))
    assert run.trace_count[0] == 1, f"retraced: {run.trace_count[0]} traces"


def test_uneven_batch_remainder(rng):
    """B not divisible by dp: padded in, sliced out, numerics intact."""
    mesh = codec_mesh(CPU8, dp=4, sp=2)
    data = _data(rng, 6, 256)  # 6 % 4 != 0
    run = sharded_codec_step(mesh, N, M)
    stripe, ok, repaired = run(data)
    assert np.asarray(stripe).shape[0] == 6
    np.testing.assert_array_equal(np.asarray(stripe), _oracle_encode(data))
    assert bool(np.all(np.asarray(ok)))


def test_padded_repair_plan_is_noop_on_clean_rows():
    """repair_plan_padded's filler rows write survivor 0 back to itself."""
    kernel = rs.get_kernel(N, M, CPU)
    mat_bits, present, missing = kernel.repair_plan_padded([2])
    assert missing.shape[0] == M  # always m rows
    assert missing[0] == 2 and all(missing[1:] == present[0])
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (N, 64), np.uint8)
    stripe = gf256.encode_numpy(kernel.gen, data)
    lost = stripe.copy()
    lost[2] = 0
    fixed = np.asarray(kernel.apply_repair((mat_bits, present, missing),
                                           torch.from_numpy(lost), portable=True))
    np.testing.assert_array_equal(fixed, stripe)


def test_kernel_constants_stay_numpy():
    """The port's own contract (ROADMAP §C): the kernel's matrices stay on
    the host (parity_bits is a host tensor over numpy memory, the bytes of
    the reference's numpy constant), and RSKernel(device="cpu") puts nothing
    on a CUDA device — its repair plan's index tensors sit on the kernel's
    device, where the reference keeps numpy arrays."""
    from chubaofs_tpu.ops import rs as j_rs

    kernel = rs.RSKernel(N, M, device=CPU)
    assert isinstance(np.asarray(kernel.parity_bits), np.ndarray)
    assert kernel.parity_bits.device.type == "cpu"
    assert np.array_equal(np.asarray(kernel.parity_bits), j_rs.RSKernel(N, M).parity_bits)
    mat_bits, present, missing = kernel.repair_plan([1])
    for t in (mat_bits, present, missing):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    j_mat, j_present, j_missing = j_rs.RSKernel(N, M).repair_plan([1])
    assert np.array_equal(np.asarray(mat_bits), j_mat)
    assert np.array_equal(np.asarray(present), j_present)
    assert np.array_equal(np.asarray(missing), j_missing)


def test_graft_dryrun_entrypoint():
    """The multi-device gate, run in-process on an 8-entry CPU grid at a
    small shard length (the plain version unpacks 8 bit planes per byte)."""
    from chubaofs_tpu_torch import entry

    got = entry.dryrun_multichip(8, device=CPU, shard_len=32768)
    assert (got["dp"], got["sp"], got["batch"]) == (4, 2, 9)


# -- group-stacked sharded step (the reference's grouped layout) ---------------


def test_grouped_step_matches_ungrouped(rng):
    """group=2: grouped block layout, per-stripe results identical to the
    per-stripe step after the host-boundary ungroup view."""
    mesh = codec_mesh(CPU8, dp=4, sp=2)
    data = _data(rng, 16, 512)
    run_g = sharded_codec_step(mesh, N, M, group=2)
    stripe_g, ok_g, repaired_g = run_g(data, bad_idx=(1, N + 1))
    run_1 = sharded_codec_step(mesh, N, M)
    stripe_1, ok_1, repaired_1 = run_1(data, bad_idx=(1, N + 1))

    assert np.asarray(stripe_g).shape == (8, 2 * (N + M), 512)
    got = ungroup_stripe(np.asarray(stripe_g), 2, N, M)
    np.testing.assert_array_equal(got, np.asarray(stripe_1))
    np.testing.assert_array_equal(
        ungroup_stripe(np.asarray(repaired_g), 2, N, M), np.asarray(repaired_1))
    np.testing.assert_array_equal(np.asarray(ok_g), np.asarray(ok_1))
    assert np.asarray(ok_g).shape == (16,)


def test_grouped_step_fused_interpret(rng):
    """B1's plain version on the group-stacked per-block layout."""
    mesh = codec_mesh(CPU8, dp=4, sp=2)
    data = _data(rng, 8, 384)
    run = sharded_codec_step(mesh, N, M, interpret=True, group=2)
    stripe, ok, repaired = run(data)
    got = ungroup_stripe(np.asarray(stripe), 2, N, M)
    np.testing.assert_array_equal(got, _oracle_encode(data))
    assert bool(np.all(np.asarray(ok)))
    np.testing.assert_array_equal(np.asarray(repaired), np.asarray(stripe))


def test_grouped_step_per_stripe_ok_and_uneven_batch(rng):
    """ok granularity stays per-stripe in the grouped layout, including when
    the batch doesn't divide dp*group (padded in, sliced out)."""
    mesh = codec_mesh(CPU8, dp=4, sp=2)
    run = sharded_codec_step(mesh, N, M, group=2)
    data = _data(rng, 8, 256)
    _, ok, _ = run(data)
    assert np.asarray(ok).tolist() == [True] * 8

    data7 = _data(rng, 7, 256)  # 7 % (dp*g = 8) != 0
    _, ok7, _ = run(data7)
    assert np.asarray(ok7).shape == (7,) and bool(np.all(np.asarray(ok7)))


def test_grouped_runtime_plan_no_retrace(rng):
    mesh = codec_mesh(CPU8, dp=4, sp=2)
    run = sharded_codec_step(mesh, N, M, group=2)
    data = _data(rng, 8, 256)
    s1, _, r1 = run(data, bad_idx=(0, N))
    s2, _, r2 = run(data, bad_idx=(1, 2, N + 1))
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(s1))
    np.testing.assert_array_equal(np.asarray(r2), np.asarray(s2))
    assert run.trace_count[0] == 1, f"retraced: {run.trace_count[0]} traces"


# -- the port's own contract ---------------------------------------------------


def test_select_gf_names_what_runs():
    """fused=None: B1 on a CUDA grid, the plain version on a CPU grid;
    fused=False: the plain version anywhere; fused=True on a CPU grid and
    interpret=True on a CUDA grid raise — nothing switches quietly. (A grid
    of torch.device("cuda", 0) entries is built without touching a card.)"""
    cpu = codec_mesh(CPU8, dp=4, sp=2)
    cuda = codec_mesh([torch.device("cuda", 0)] * 4)
    assert t_mesh._select_gf(cpu, None, False)[1] is False
    assert t_mesh._select_gf(cpu, None, True)[1] is False
    assert t_mesh._select_gf(cpu, True, True)[1] is False
    assert t_mesh._select_gf(cuda, None, False)[1] is True
    assert t_mesh._select_gf(cuda, False, False)[1] is False
    with pytest.raises(ValueError, match="CUDA grid"):
        t_mesh._select_gf(cpu, True, False)
    with pytest.raises(ValueError, match="interpret"):
        t_mesh._select_gf(cuda, None, True)
    with pytest.raises(ValueError, match="interpret"):
        sharded_codec_step(cuda, N, M, interpret=True)


def test_col_bounds_keep_blocks_aligned():
    """The sp boundaries tile [0, k) in order, every boundary below k sits
    on 16 bytes (each block's rows start aligned for B1), and only the last
    non-empty block may have a ragged width."""
    for k in (0, 1, 15, 16, 20, 300, 512, 1000, 699_136, 1 << 20):
        for sp in (1, 2, 3, 4, 8):
            cols = t_mesh.col_bounds(k, sp)
            assert len(cols) == sp and cols[0][0] == 0 and cols[-1][1] == k
            assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
            assert all(c0 % 16 == 0 for c0, _ in cols if c0 < k), (k, sp)
            widths = [c1 - c0 for c0, c1 in cols if c1 > c0]
            assert all(w % 16 == 0 for w in widths[:-1]), (k, sp)


def test_sharded_array_slices_its_leading_axis(rng):
    mesh = codec_mesh(CPU8, dp=4, sp=2)
    data = _data(rng, 8, 300)
    placed = shard_stripes(mesh, data)
    for lo, hi in [(0, 7), (3, 5), (6, 8), (4, 4), (0, 8)]:
        part = placed[lo:hi]
        assert part.shape == (hi - lo, N, 300)
        assert np.array_equal(np.asarray(part), data[lo:hi])
    with pytest.raises(TypeError):
        placed[1]
    with pytest.raises(ValueError, match="do not split"):
        shard_stripes(mesh, _data(rng, 6, 256))


def test_codec_service_mesh_device_is_the_grids_first(rng):
    from chubaofs_tpu_torch.codec.service import CodecService

    mesh = codec_mesh(CPU8, dp=4, sp=2)
    with pytest.raises(ValueError, match="first device"):
        CodecService(mesh=codec_mesh([torch.device("cuda", 0)] * 2), device=CPU)
    svc = CodecService(mesh=mesh, device=CPU, mesh_interpret=True)
    try:
        data = rng.integers(0, 256, (N, 5000), dtype=np.uint8)
        assert np.array_equal(svc.encode(N, M, data).result(timeout=60),
                              _oracle_encode(data[None])[0])
    finally:
        svc.close()


def test_entry_encodes_flagship():
    from chubaofs_tpu_torch import entry

    fn, (example,) = entry.entry(device=CPU)
    out = fn(example)
    assert out.shape == (2, 16, 1024) and out.device.type == "cpu"
    gen = rs.get_kernel(12, 4, CPU).gen
    assert np.array_equal(out[1].numpy(), gf256.encode_numpy(gen, example[1]))


# -- cross-package: the JAX package's mesh on its 8 virtual CPU devices ----------


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_step_matches_jax(dp, sp, group):
    """The same seeded batch through the reference's sharded_codec_step on
    codec_mesh(dp, sp) over 8 virtual CPU devices and through the port's on
    8 CPU entries: stripe, ok and repaired byte-equal (tolerance 0) for two
    repair patterns, the grouped layout included. B = 2 dp + 1 pads a
    remainder; k = 320 leaves an empty and a ragged column block at sp=8."""
    import jax
    from chubaofs_tpu.parallel import codec_mesh as j_codec_mesh
    from chubaofs_tpu.parallel import sharded_codec_step as j_step

    data = np.random.default_rng(dp * 10 + sp + group).integers(
        0, 256, (2 * dp + 1, N, 320), dtype=np.uint8)
    j_run = j_step(j_codec_mesh(jax.devices("cpu")[:8], dp=dp, sp=sp), N, M, group=group)
    t_run = sharded_codec_step(codec_mesh(CPU8, dp=dp, sp=sp), N, M, group=group)
    for bad in [(0, N), (1, 2, N + 1)]:
        want = [np.asarray(a) for a in j_run(data, bad_idx=bad)]
        got = [np.asarray(a) for a in t_run(data, bad_idx=bad)]
        for name, w, g in zip(("stripe", "ok", "repaired"), want, got):
            assert g.shape == w.shape and g.dtype == w.dtype, (name, bad)
            assert np.array_equal(g, w), (name, bad)
    assert t_run.trace_count[0] == 1 and t_run.group == group


@pytest.mark.parametrize("b,k", [(8, 256), (5, 256), (3, 300)])
def test_sharded_gf_matmul_matches_jax(b, k):
    from chubaofs_tpu.ops import rs as j_rs
    from chubaofs_tpu.parallel import codec_mesh as j_codec_mesh
    from chubaofs_tpu.parallel import sharded_gf_matmul as j_mm

    from chubaofs_tpu_torch.parallel import sharded_gf_matmul

    data = np.random.default_rng(b * 1000 + k).integers(0, 256, (b, N, k), dtype=np.uint8)
    bits = j_rs.get_kernel(N, M).parity_bits
    want = j_mm(j_codec_mesh(dp=4, sp=2))(bits, data)
    got = sharded_gf_matmul(codec_mesh(CPU8, dp=4, sp=2))(bits, data)
    assert got.dtype == np.uint8 and np.array_equal(got, np.asarray(want))
