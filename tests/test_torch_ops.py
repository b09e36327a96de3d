"""The port's ops (chubaofs_tpu_torch.ops) held against the JAX package.

Same seeded numpy inputs go through the JAX function and its port. GF(2^8)
math has no rounding, so every comparison is exact byte equality. The JAX
side's Pallas kernel runs in interpret mode on the CPU, as tests/test_rs.py
runs it; the port's side runs its plain PyTorch version (CPU tensors).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chubaofs_tpu.codec import codemode as j_codemode
from chubaofs_tpu.codec import encoder as j_encoder
from chubaofs_tpu.codec import pm as j_pm
from chubaofs_tpu.ops import bitmatrix as j_bitmatrix
from chubaofs_tpu.ops import gf256 as j_gf256
from chubaofs_tpu.ops import pallas_gf as j_pallas_gf
from chubaofs_tpu.ops import rs as j_rs
from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.codec import codemode as t_codemode
from chubaofs_tpu_torch.codec import encoder as t_encoder
from chubaofs_tpu_torch.codec import pm as t_pm
from chubaofs_tpu_torch.ops import bitmatrix as t_bitmatrix
from chubaofs_tpu_torch.ops import cuda_gf
from chubaofs_tpu_torch.ops import gf256 as t_gf256
from chubaofs_tpu_torch.ops import rs as t_rs

CPU = "cpu"
# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores (and their timing-sensitive tests) alone
torch.set_num_threads(1)
ALL_MODES = [m.name for m in j_codemode.all_modes()]


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


def _np(x) -> np.ndarray:
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


# -- field tables and matrices -------------------------------------------------


def test_gf256_tables_identical():
    assert t_gf256.POLY == j_gf256.POLY == 0x11D
    assert np.array_equal(t_gf256.EXP_TABLE, j_gf256.EXP_TABLE)
    assert np.array_equal(t_gf256.LOG_TABLE, j_gf256.LOG_TABLE)
    assert np.array_equal(t_gf256.mul_table(), j_gf256.mul_table())
    a = np.arange(1, 256, dtype=np.uint8)
    assert np.array_equal(t_gf256.gf_inv(a), j_gf256.gf_inv(a))


@pytest.mark.parametrize("mode", ALL_MODES)
def test_generator_decode_expand_identical_per_mode(mode):
    """systematic_generator, decode_matrix and expand_matrix for every
    CodeMode, plus the port's CodeMode table itself."""
    jt = j_codemode.get_tactic(mode)
    tt = t_codemode.get_tactic(mode)
    assert (jt.N, jt.M, jt.L, jt.az_count, jt.put_quorum, jt.sub_units) == \
        (tt.N, tt.M, tt.L, tt.az_count, tt.put_quorum, tt.sub_units)
    assert jt.local_stripes() == tt.local_stripes()
    jg = j_gf256.systematic_generator(jt.N, jt.M)
    tg = t_gf256.systematic_generator(tt.N, tt.M)
    assert np.array_equal(jg, tg)
    # survivors: drop the first min(M, 3) shards
    present = list(range(min(jt.M, 3), jt.N + jt.M))
    assert np.array_equal(j_gf256.decode_matrix(jg, present),
                          t_gf256.decode_matrix(tg, present))
    assert np.array_equal(j_bitmatrix.expand_matrix(jg[jt.N:]),
                          t_bitmatrix.expand_matrix(tg[tt.N:]))


def test_bitmatrix_helpers_identical(rng):
    for c in [0, 1, 2, 0x1D, 0x80, 0xFF] + list(rng.integers(0, 256, 8)):
        assert np.array_equal(t_bitmatrix.mul_bit_matrix(int(c)),
                              j_bitmatrix.mul_bit_matrix(int(c)))
    x = rng.integers(0, 256, (3, 5, 33), dtype=np.uint8)
    bits = j_bitmatrix.unpack_bits_np(x)
    assert np.array_equal(t_bitmatrix.unpack_bits_np(x), bits)
    assert np.array_equal(t_bitmatrix.pack_bits_np(bits), j_bitmatrix.pack_bits_np(bits))


def test_unpack_pack_and_xor_reduce_identical(rng):
    x = rng.integers(0, 256, (2, 5, 33), dtype=np.uint8)
    tx = torch.from_numpy(x)
    assert np.array_equal(_np(t_rs.unpack_bits(tx)), np.asarray(j_rs.unpack_bits(x)))
    assert np.array_equal(_np(t_rs.pack_bits(t_rs.unpack_bits(tx))), x)
    assert np.array_equal(_np(t_rs.xor_reduce(tx)), np.asarray(j_rs.xor_reduce(x)))


# -- the GF matmul: plain port vs JAX einsum vs Pallas (interpret) ------------


def _matrices():
    """name -> GF(2^8) matrix (host numpy) made by the JAX package: every
    kind the main path multiplies by."""
    k12 = j_rs.get_kernel(12, 4)
    k63 = j_rs.get_kernel(6, 3)
    lrc = j_encoder.lrc_parity_matrix(j_codemode.get_tactic("EC16P20L2"))
    pmk = j_pm.get_kernel(12, 6)
    rep1, _, _ = k12.repair_matrix([5])
    rep3, _, _ = k12.repair_matrix([0, 5, 12])
    pad_bits, _, _ = k63.repair_plan_padded([4])
    return {
        "ec4p2_parity": j_rs.get_kernel(4, 2).gen[4:],
        "ec6p3_parity": k63.gen[6:],
        "ec12p4_parity": k12.gen[12:],
        "ec12p4_repair1": rep1,
        "ec12p4_repair3": rep3,
        # coefficients() raises unless expand_matrix gives pad_bits back
        "ec6p3_repair_padded": cuda_gf.coefficients(pad_bits),
        "ec12p4_window": k12.window_matrix([0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 11, 13], [5, 12]),
        "ec16p20l2_lrc": lrc,
        "rg6p6_parity": pmk.parity_mat,
        "rg6p6_decode": pmk.decode_matrix([1, 2, 4, 6, 8, 11], [0, 3, 5]),
        "rg6p6_repair": pmk.repair_matrix(0, list(range(1, 11))),
        "empty_r0": np.zeros((0, 6), np.uint8),
    }


MATRIX_NAMES = list(_matrices())


@pytest.mark.parametrize("name", MATRIX_NAMES)
@pytest.mark.parametrize("lead,k", [((), 257), ((2, 3), 128)])
def test_gf_matmul_port_vs_jax_and_pallas(name, lead, k):
    """The port's plain version on the JAX package's own matrices, against
    the JAX einsum lowering and the Pallas kernel in interpret mode:
    unaligned k, leading batch dims, and the r = 0 matrix."""
    mat = _matrices()[name]
    bits = j_bitmatrix.expand_matrix(mat).astype(np.int8)
    r, n = mat.shape
    data = np.random.default_rng(zlib.crc32(name.encode())).integers(
        0, 256, (*lead, n, k), dtype=np.uint8)
    want = np.asarray(j_rs.gf_matmul_bytes(bits, data))
    got = _np(t_rs.gf_matmul_bytes(t_rs.plan_from_numpy(bits), torch.from_numpy(data)))
    assert got.shape == (*lead, r, k)
    assert np.array_equal(got, want)
    assert np.array_equal(_np(t_rs.gf_matmul_dispatch(bits, torch.from_numpy(data))), want)
    pallas = np.asarray(j_pallas_gf.gf_matmul_bytes_fused(
        bits, data, tile_k=128, interpret=True))
    assert np.array_equal(got, pallas)
    if r:
        flat = data.reshape(-1, n, k)[0]
        assert np.array_equal(got.reshape(-1, r, k)[0], j_gf256.gf_matmul(mat, flat))


def test_hostbatch_matches_jax(rng):
    jk = j_rs.get_kernel(12, 4)
    host = rng.integers(0, 256, (6, 12, 200), dtype=np.uint8)
    want = j_rs.gf_matmul_hostbatch(jk.parity_bits, host)
    got = t_rs.gf_matmul_hostbatch(jk.parity_bits, host, CPU)
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    mat_bits, present, missing = jk.repair_plan([0, 5])
    stripes = np.asarray(jk.encode(host))
    got = t_rs.gf_matmul_hostbatch(mat_bits, stripes[:, present, :], CPU)
    assert np.array_equal(got, stripes[:, missing, :])
    assert t_rs.gf_matmul_hostbatch(mat_bits[:0], stripes[:, present, :], CPU).shape == (6, 0, 200)
    assert t_rs.group_stack(jk.parity_bits, 16)[1] == 1


# -- the port builds byte-identical matrices itself ----------------------------


@pytest.mark.parametrize("n,m", [(4, 2), (6, 3), (12, 4), (20, 4)])
def test_port_plans_identical(n, m):
    jk = j_rs.get_kernel(n, m)
    tk = t_rs.get_kernel(n, m, CPU)
    assert np.array_equal(_np(tk.parity_bits), jk.parity_bits)
    for bad, data_only in [([0], False), ([1, n, n + m - 1][:m], False), ([n], True)]:
        for mk in ("repair_plan", "repair_plan_padded"):
            jp = getattr(jk, mk)(bad, data_only)
            tp = getattr(tk, mk)(bad, data_only)
            for a, b in zip(jp, tp):
                assert np.array_equal(_np(b), np.asarray(a)), (mk, bad)
    present = [i for i in range(n + m) if i != 1][:n]
    assert np.array_equal(tk.window_matrix(present, [1, n]), jk.window_matrix(present, [1, n]))


@pytest.mark.parametrize("mode", ["EC6P3L3", "EC16P20L2", "EC20P4L2", "EC4P4L2"])
def test_lrc_parity_matrix_identical(mode):
    assert np.array_equal(
        t_encoder.lrc_parity_matrix(t_codemode.get_tactic(mode)),
        j_encoder.lrc_parity_matrix(j_codemode.get_tactic(mode)))


@pytest.mark.parametrize("n,k", [(12, 6), (8, 4)])
def test_pm_matrices_identical(n, k):
    jk, tk = j_pm.get_kernel(n, k), t_pm.get_kernel(n, k)
    assert np.array_equal(tk.parity_mat, jk.parity_mat)
    assert np.array_equal(tk.G, jk.G)
    helpers = list(range(1, 1 + jk.d))
    assert np.array_equal(tk.repair_matrix(0, helpers), jk.repair_matrix(0, helpers))
    srv = list(range(n - k, n))
    assert np.array_equal(tk.decode_matrix(srv, [0, 1]), jk.decode_matrix(srv, [0, 1]))


def test_plan_from_numpy_carries_jax_plans():
    jk = j_rs.get_kernel(6, 3)
    jplan = jk.repair_plan_padded([2])
    mat, present, missing = t_rs.plan_from_numpy(*jplan, device=CPU)
    assert mat.dtype == torch.int8 and mat.device.type == "cpu"
    assert present.dtype == torch.int64 and missing.shape == (3,)
    assert np.array_equal(_np(mat), jplan[0])
    assert np.array_equal(_np(missing), jplan[2])
    only = t_rs.plan_from_numpy(jk.parity_bits)
    assert isinstance(only, torch.Tensor) and np.array_equal(_np(only), jk.parity_bits)


# -- RSKernel against the JAX RSKernel ------------------------------------------


@pytest.mark.parametrize("n,m", [(3, 3), (6, 3), (12, 4), (15, 12)])
def test_rskernel_encode_matches_jax(rng, n, m):
    data = rng.integers(0, 256, (2, n, 257), dtype=np.uint8)
    want = np.asarray(j_rs.get_kernel(n, m).encode(data))
    tk = t_rs.get_kernel(n, m, CPU)
    assert np.array_equal(_np(tk.encode(data)), want)
    assert np.array_equal(_np(tk.encode_parity(torch.from_numpy(data))), want[:, n:])


@pytest.mark.parametrize(
    "bad", [[0], [11], [15], [0, 1, 2, 3], [12, 13, 14, 15], [5, 11, 13, 15]])
def test_rskernel_reconstruct_matches_jax(rng, bad):
    jk, tk = j_rs.get_kernel(12, 4), t_rs.get_kernel(12, 4, CPU)
    stripes = np.asarray(jk.encode(rng.integers(0, 256, (3, 12, 200), dtype=np.uint8)))
    broken = stripes.copy()
    broken[:, bad, :] = 0
    for data_only in (False, True):
        want = np.asarray(jk.reconstruct(broken, bad, data_only=data_only))
        got = _np(tk.reconstruct(broken, bad, data_only=data_only))
        assert np.array_equal(got, want), (bad, data_only)
    assert np.array_equal(_np(tk.reconstruct(broken, bad)), stripes)


def test_rskernel_verify_and_apply_repair_match_jax(rng):
    jk, tk = j_rs.get_kernel(4, 2), t_rs.get_kernel(4, 2, CPU)
    shards = np.array(jk.encode(rng.integers(0, 256, (3, 4, 32), dtype=np.uint8)))
    shards[1, 5, 0] ^= 1
    assert _np(tk.verify(shards)).tolist() == np.asarray(jk.verify(shards)).tolist() \
        == [True, False, True]
    stripe = np.asarray(jk.encode(rng.integers(0, 256, (4, 64), dtype=np.uint8)))
    broken = stripe.copy()
    broken[[1, 4]] = 0
    for plan_fn in ("repair_plan", "repair_plan_padded"):
        jplan = getattr(jk, plan_fn)([1, 4])
        want = np.asarray(jk.apply_repair(jplan, jnp.asarray(broken)))
        assert np.array_equal(want, stripe)
        # the port's own plan, and the JAX plan carried across
        assert np.array_equal(_np(tk.apply_repair(getattr(tk, plan_fn)([1, 4]), broken)), want)
        assert np.array_equal(
            _np(tk.apply_repair(t_rs.plan_from_numpy(*jplan, device=CPU), broken)), want)
    # the r = 0 plan: a lost parity shard with data_only=True is a no-op
    plan = tk.repair_plan([5], data_only=True)
    assert np.array_equal(_np(tk.apply_repair(plan, stripe)), stripe)
    with pytest.raises(ValueError):
        tk.repair_matrix([0, 1, 2])


def test_rskernel_failpoint_is_the_ports_own():
    """`rs.encode` arms in the port's registry, not the JAX package's."""
    from chubaofs_tpu import chaos as j_chaos

    tk = t_rs.get_kernel(4, 2, CPU)
    t_chaos.arm("rs.encode", "error(boom)")
    with pytest.raises(t_chaos.FailpointError):
        tk.encode_parity(np.zeros((4, 16), np.uint8))
    assert t_chaos.fired("rs.encode") == 1 and j_chaos.fired("rs.encode") == 0
    np.asarray(j_rs.get_kernel(4, 2).encode_parity(np.zeros((4, 16), np.uint8)))


# -- the CUDA wrapper's host side (runs here; the launch needs the card) --------


def _split_lookup(tab: np.ndarray, x: np.ndarray) -> np.ndarray:
    """One block's byte map applied through its split tables, as the kernel
    looks them up: T0[x & 7] ^ T1[(x >> 3) & 7] ^ T2[x >> 6]."""
    return tab[x & 7] ^ tab[8 + ((x >> 3) & 7)] ^ tab[16 + (x >> 6)]


@pytest.mark.parametrize("name", MATRIX_NAMES)
def test_kernel_tables_compute_the_product(name, rng):
    """What the kernel reads: the split tables the wrapper builds from the
    bit matrix, per launch block. Emulating the kernel's lookups in numpy on
    those tables must give the GF(2^8) product (tests/test_torch_gf_tables.py
    walks the kernel itself)."""
    mat = _matrices()[name]
    bits = j_bitmatrix.expand_matrix(mat).astype(np.int8)
    assert np.array_equal(cuda_gf.coefficients(bits), mat)
    tables = cuda_gf.split_tables(bits)
    r, n = mat.shape
    assert tables.shape == (r, n, cuda_gf.TAB_BYTES) and not tables[..., 20:].any()
    x = rng.integers(0, 256, (n, 300), dtype=np.uint8)
    out = np.zeros((r, 300), np.uint8)
    for r0, r1, j0, j1 in cuda_gf.blocks(r, n):
        tab = tables[r0:r1, j0:j1]
        assert tab.nbytes <= cuda_gf.SMEM_BUDGET
        for i in range(r1 - r0):
            for j in range(j1 - j0):
                out[r0 + i] ^= _split_lookup(tab[i, j], x[j0 + j])
    assert np.array_equal(out, j_gf256.gf_matmul(mat, x))


@pytest.mark.parametrize("r,n", [(4, 12), (30, 30), (100, 100), (3, 2000), (0, 6)])
def test_kernel_blocks_cover_matrix_once(r, n):
    cover = np.zeros((r, n), np.int64)
    for r0, r1, j0, j1 in cuda_gf.blocks(r, n):
        assert (r1 - r0) * (j1 - j0) <= cuda_gf.MAX_COEFFS
        cover[r0:r1, j0:j1] += 1
    assert np.all(cover == 1)


def test_kernel_wrapper_rejects_what_it_cannot_run(rng):
    bits = j_rs.get_kernel(4, 2).parity_bits
    with pytest.raises(ValueError):  # a CPU tensor never reaches the kernel
        cuda_gf.gf_matmul(bits, torch.zeros((4, 16), dtype=torch.uint8))
    with pytest.raises(ValueError):  # not the expansion of a GF(2^8) matrix
        cuda_gf.coefficients(np.eye(16, dtype=np.int8)[::-1].copy())
    for bad in (np.zeros((9, 16), np.int8), np.zeros((16, 12), np.int8)):
        with pytest.raises(ValueError):
            cuda_gf.coefficients(bad)
        with pytest.raises(ValueError):
            cuda_gf.split_tables(bad)
    # B1's plan takes a matrix that is no GF(2^8) expansion, as the JAX kernel does
    swap = np.eye(16, dtype=np.int8)[::-1].copy()
    plan = cuda_gf._plan(swap, torch.device("cpu"))
    assert [p[:4] for p in plan] == [(0, 2, 0, 2)]
    x = rng.integers(0, 256, (2, 64), dtype=np.uint8)
    got = np.stack([_split_lookup(plan[0][4].numpy()[i, 0], x[0])
                    ^ _split_lookup(plan[0][4].numpy()[i, 1], x[1]) for i in range(2)])
    want = np.asarray(j_pallas_gf.gf_matmul_bytes_fused(swap, x, tile_k=128, interpret=True))
    assert np.array_equal(got, want)


def test_entry_points_refuse_cpu_without_being_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_rs.RSKernel(6, 3)
    with pytest.raises(RuntimeError):
        t_rs.get_kernel(6, 3)
    assert t_rs.resolve_device("cpu") == torch.device("cpu")


def test_kernel_plan_cache_under_threads(monkeypatch):
    """The wrapper's per-matrix plan cache is shared by every submitter
    thread: hammer it with more threads than cores and a tiny LRU bound,
    and every plan handed out must still hold the right tables."""
    import sys
    import threading

    monkeypatch.setattr(cuda_gf, "_PLAN_CACHE_MAX", 3)
    monkeypatch.setattr(cuda_gf, "_plans", type(cuda_gf._plans)())
    mats = [np.random.default_rng(s).integers(0, 256, (1 + s % 5, 2 + s % 7), dtype=np.uint8)
            for s in range(12)]
    bits = [j_bitmatrix.expand_matrix(m).astype(np.int8) for m in mats]
    errors: list[str] = []

    def worker(seed: int):
        order = np.random.default_rng(seed).permutation(len(mats) * 4) % len(mats)
        for i in order:
            plan = cuda_gf._plan(bits[i], torch.device("cpu"))
            r0, r1, j0, j1, tab = plan[0]
            if (r1, j1) != mats[i].shape or not np.array_equal(
                    tab.numpy(), cuda_gf.split_tables(bits[i])):
                errors.append(f"thread {seed}: wrong plan for matrix {i}")
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(cuda_gf._plans) <= 3
