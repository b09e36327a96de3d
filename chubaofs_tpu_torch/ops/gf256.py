"""GF(2^8) arithmetic: tables, matrices, and a numpy reference codec.

This is the scalar/CPU foundation of the erasure-coding core. The reference
implementation (CubeFS) delegates GF(2^8) math to klauspost/reedsolomon's SIMD
assembly (reference blobstore/common/ec/encoder.go:21,86). Here the field math is
built from first principles:

  * log/exp tables over GF(2^8) with the 0x11d primitive polynomial (the same field
    used by klauspost/reedsolomon and virtually every storage RS codec),
  * a systematic Cauchy generator matrix (every square submatrix of a Cauchy matrix
    is invertible, so any N of the N+M shards can recover the data — the MDS
    property; Vandermonde-derived constructions need the extra inversion step to
    guarantee this),
  * Gauss-Jordan inversion over the field for decode matrices,
  * a pure-numpy encode/reconstruct used as the correctness oracle for the GPU
    kernel and the plain PyTorch lowering.

These tables are setup-time data: the generator/decode matrices are built from
them on the host and expanded to GF(2) bit matrices (ops/bitmatrix.py), which
the plain PyTorch path and both CUDA kernels multiply by (ops/rs.py).
"""

from __future__ import annotations

import functools

import numpy as np

# x^8 + x^4 + x^3 + x^2 + 1 — primitive polynomial of the storage-RS field.
POLY = 0x11D
FIELD = 256
ORDER = FIELD - 1  # multiplicative group order


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables; exp is doubled to ORDER*2 so mul never needs a mod."""
    exp = np.zeros(ORDER * 2, dtype=np.uint8)
    log = np.zeros(FIELD, dtype=np.int32)
    x = 1
    for i in range(ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[ORDER : ORDER * 2] = exp[:ORDER]
    log[0] = -1  # sentinel: log(0) undefined
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()


@functools.lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """Full 256x256 GF(2^8) product table (uint8)."""
    a = np.arange(256, dtype=np.int32)
    la = LOG_TABLE[a]
    t = EXP_TABLE[(la[:, None] + la[None, :]) % ORDER].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


def gf_mul(a, b):
    """Element-wise GF(2^8) product of uint8 arrays/scalars."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return mul_table()[a, b]


def gf_inv(a):
    """Multiplicative inverse; a must be nonzero."""
    a = np.asarray(a, dtype=np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("gf_inv(0)")
    return EXP_TABLE[ORDER - LOG_TABLE[a]]


def gf_div(a, b):
    return gf_mul(a, gf_inv(b))


def gf_pow(a: int, n: int) -> int:
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) * n) % ORDER])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8): XOR-accumulated gf_mul. Oracle-grade, O(n^3)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    assert a.ndim == 2 and b.ndim == 2 and a.shape[1] == b.shape[0]
    t = mul_table()
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for k in range(a.shape[1]):
        out ^= t[a[:, k][:, None], b[k, :][None, :]]
    return out


def gf_inv_matrix(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^8). Raises if singular."""
    m = np.array(m, dtype=np.uint8)
    n = m.shape[0]
    assert m.shape == (n, n)
    aug = np.concatenate([m, np.eye(n, dtype=np.uint8)], axis=1)
    t = mul_table()
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise np.linalg.LinAlgError("singular matrix over GF(2^8)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = gf_inv(aug[col, col])
        aug[col] = t[aug[col], inv_p]
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] ^= t[aug[row, col], aug[col]]
    return aug[:, n:].copy()


def cauchy_parity_matrix(n: int, m: int) -> np.ndarray:
    """m x n Cauchy block C[i,j] = 1/(x_i + y_j), x_i = n+i, y_j = j.

    Distinctness of {x_i} ∪ {y_j} over GF(2^8) requires n + m <= 256. Every square
    submatrix of a Cauchy matrix is invertible, which makes the systematic generator
    [I ; C] MDS: any n surviving rows form an invertible matrix.
    """
    if n + m > FIELD:
        raise ValueError(f"n+m = {n + m} exceeds field size {FIELD}")
    x = np.arange(n, n + m, dtype=np.uint8)
    y = np.arange(n, dtype=np.uint8)
    return gf_inv(x[:, None] ^ y[None, :])


def systematic_generator(n: int, m: int) -> np.ndarray:
    """(n+m) x n systematic generator: identity on top, Cauchy parity below."""
    return np.concatenate([np.eye(n, dtype=np.uint8), cauchy_parity_matrix(n, m)], axis=0)


def decode_matrix(gen: np.ndarray, present_rows: list[int] | np.ndarray) -> np.ndarray:
    """n x n matrix mapping shards at `present_rows` (first n of them) back to data.

    gen is the (n+m) x n systematic generator; present_rows are indices of surviving
    shards. Uses the first n surviving rows. data = decode @ survivors.
    """
    n = gen.shape[1]
    rows = np.asarray(present_rows)[:n]
    if rows.shape[0] < n:
        raise ValueError(f"need {n} surviving shards, have {rows.shape[0]}")
    sub = gen[rows, :]
    return gf_inv_matrix(sub)


# ---------------------------------------------------------------------------
# numpy reference codec (the oracle / host fallback)
# ---------------------------------------------------------------------------


def encode_numpy(gen: np.ndarray, data: np.ndarray) -> np.ndarray:
    """data: (n, k) uint8 -> all shards (n+m, k): parity rows = C @ data."""
    n = gen.shape[1]
    assert data.shape[0] == n
    parity = gf_matmul(gen[n:, :], data)
    return np.concatenate([data, parity], axis=0)


def reconstruct_numpy(
    gen: np.ndarray, shards: np.ndarray, bad_idx: list[int], data_only: bool = False
) -> np.ndarray:
    """Fill the rows of `shards` listed in bad_idx from the surviving rows.

    shards: (n+m, k) uint8 with garbage in bad rows. Returns a new array.
    """
    total, n = gen.shape
    bad = set(int(i) for i in bad_idx)
    present = [i for i in range(total) if i not in bad]
    dec = decode_matrix(gen, present)
    survivors = shards[np.asarray(present[:n]), :]
    out = np.array(shards, copy=True)
    bad_data = sorted(i for i in bad if i < n)
    bad_parity = sorted(i for i in bad if i >= n)
    if bad_data:
        rows = gf_matmul(dec[np.asarray(bad_data), :], survivors)
        out[np.asarray(bad_data), :] = rows
    if bad_parity and not data_only:
        # parity row i = gen[i] @ data (data rows already repaired above)
        data = out[:n, :]
        rows = gf_matmul(gen[np.asarray(bad_parity), :], data)
        out[np.asarray(bad_parity), :] = rows
    return out
