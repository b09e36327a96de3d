"""The cases of tests/test_gf256.py, run against the port's ops/gf256.py.

GF(2^8) field math: axioms, matrix algebra, numpy codec oracle. One more
case holds the port's tables and generators against the JAX package's."""

import numpy as np
import pytest

from chubaofs_tpu_torch.ops import gf256


def test_exp_log_roundtrip():
    for a in range(1, 256):
        assert gf256.EXP_TABLE[gf256.LOG_TABLE[a]] == a


def test_mul_axioms(rng):
    a = rng.integers(0, 256, 200, dtype=np.uint8)
    b = rng.integers(0, 256, 200, dtype=np.uint8)
    c = rng.integers(0, 256, 200, dtype=np.uint8)
    assert np.array_equal(gf256.gf_mul(a, b), gf256.gf_mul(b, a))
    assert np.array_equal(
        gf256.gf_mul(a, gf256.gf_mul(b, c)), gf256.gf_mul(gf256.gf_mul(a, b), c)
    )
    # distributivity over XOR (field addition)
    assert np.array_equal(
        gf256.gf_mul(a, b ^ c), gf256.gf_mul(a, b) ^ gf256.gf_mul(a, c)
    )
    assert np.array_equal(gf256.gf_mul(a, np.uint8(1)), a)
    assert np.all(gf256.gf_mul(a, np.uint8(0)) == 0)


def _peasant_mul(a: int, b: int) -> int:
    """Independent GF(2^8) multiplier: shift-and-reduce, no tables."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= gf256.POLY
        b >>= 1
    return r


def test_products_match_peasant_oracle(rng):
    assert gf256.gf_mul(2, 128) == 0x1D  # x * x^7 = x^8 = 0x11d mod x^8
    pairs = rng.integers(0, 256, (300, 2))
    for a, b in pairs:
        assert gf256.gf_mul(a, b) == _peasant_mul(int(a), int(b)), (a, b)


def test_inverse(rng):
    a = rng.integers(1, 256, 255, dtype=np.uint8)
    assert np.all(gf256.gf_mul(a, gf256.gf_inv(a)) == 1)
    with pytest.raises(ZeroDivisionError):
        gf256.gf_inv(0)


def test_matrix_inverse(rng):
    for n in (1, 3, 8, 12):
        m = gf256.cauchy_parity_matrix(n, n)  # square Cauchy: invertible
        inv = gf256.gf_inv_matrix(m)
        assert np.array_equal(gf256.gf_matmul(m, inv), np.eye(n, dtype=np.uint8))


def test_singular_matrix_raises():
    m = np.array([[1, 2], [1, 2]], dtype=np.uint8)
    with pytest.raises(np.linalg.LinAlgError):
        gf256.gf_inv_matrix(m)


def test_cauchy_mds_property(rng):
    """Any n rows of the systematic generator must be invertible (MDS)."""
    n, m = 6, 3
    gen = gf256.systematic_generator(n, m)
    for _ in range(20):
        rows = rng.choice(n + m, size=n, replace=False)
        gf256.gf_inv_matrix(gen[np.sort(rows), :])  # must not raise


def test_numpy_codec_roundtrip(rng):
    n, m, k = 6, 3, 512
    gen = gf256.systematic_generator(n, m)
    data = rng.integers(0, 256, (n, k), dtype=np.uint8)
    shards = gf256.encode_numpy(gen, data)
    assert shards.shape == (n + m, k)
    assert np.array_equal(shards[:n], data)

    # kill up to m shards in various patterns, reconstruct
    for bad in ([0], [8], [0, 4, 7], [1, 2, 3], [6, 7, 8]):
        broken = shards.copy()
        broken[np.asarray(bad), :] = 0
        fixed = gf256.reconstruct_numpy(gen, broken, bad)
        assert np.array_equal(fixed, shards), f"pattern {bad}"


def test_numpy_reconstruct_data_only(rng):
    n, m, k = 4, 2, 64
    gen = gf256.systematic_generator(n, m)
    data = rng.integers(0, 256, (n, k), dtype=np.uint8)
    shards = gf256.encode_numpy(gen, data)
    broken = shards.copy()
    broken[1, :] = 0
    broken[5, :] = 0
    fixed = gf256.reconstruct_numpy(gen, broken, [1, 5], data_only=True)
    assert np.array_equal(fixed[:n], data)
    assert np.all(fixed[5] == 0)  # parity intentionally left broken


def test_tables_and_generators_match_jax():
    from chubaofs_tpu.ops import gf256 as j_gf256

    assert gf256.POLY == j_gf256.POLY
    assert np.array_equal(gf256.EXP_TABLE, j_gf256.EXP_TABLE)
    assert np.array_equal(gf256.LOG_TABLE, j_gf256.LOG_TABLE)
    for n, m in ((4, 2), (6, 3), (12, 4), (20, 4)):
        assert np.array_equal(gf256.systematic_generator(n, m),
                              j_gf256.systematic_generator(n, m)), (n, m)
