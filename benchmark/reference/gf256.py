"""Plain NumPy GF(2^8) erasure-code reference: the yardstick for `correct`.

Written from the code's definition, not from the program: the field is
GF(2^8) over the polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11d); a systematic
Reed-Solomon stripe of N data rows carries M parity rows P = C @ D with the
Cauchy block C[i, j] = 1 / ((N + i) xor j); an LRC stripe then gives each of
its AZs L / AZ local parity rows, the same Cauchy construction over that AZ's
data and global-parity rows (taken in stripe order). Shards are laid out
data, global parity, local parity. Rows are multiplied byte by byte through
a 256 x 256 product table: slow, plain and independent of any kernel.

Imports numpy only: nothing of the program, nothing of JAX.
"""

from __future__ import annotations

import functools

import numpy as np

POLY = 0x11D


@functools.lru_cache(maxsize=1)
def _exp_log() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(510, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i] = exp[i + 255] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    return exp, log


@functools.lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """MUL[a, b] = a * b in GF(2^8), uint8."""
    exp, log = _exp_log()
    t = exp[(log[:, None] + log[None, :]) % 255].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in GF(2^8)")
    exp, log = _exp_log()
    return int(exp[(255 - log[a]) % 255])


def cauchy(n: int, m: int) -> np.ndarray:
    """(m, n) Cauchy block C[i, j] = 1 / ((n + i) xor j)."""
    if n + m > 256:
        raise ValueError(f"n + m = {n + m} > 256")
    return np.array([[inv((n + i) ^ j) for j in range(n)] for i in range(m)],
                    np.uint8)


def matmul(mat: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """GF(2^8) product (r, n) @ (n, k) -> (r, k), one table lookup per byte
    and coefficient."""
    mul = mul_table()
    mat = np.asarray(mat, np.uint8)
    rows = np.asarray(rows, np.uint8)
    if mat.shape[1] != rows.shape[0]:
        raise ValueError(f"shape mismatch {mat.shape} @ {rows.shape}")
    out = np.zeros((mat.shape[0], rows.shape[1]), np.uint8)
    for i in range(mat.shape[0]):
        for j in range(mat.shape[1]):
            c = int(mat[i, j])
            if c == 1:
                out[i] ^= rows[j]
            elif c:
                out[i] ^= mul[c][rows[j]]
    return out
