"""GF(2^8) -> GF(2) bit-matrix lowering.

Multiplication by a *constant* c in GF(2^8) is a linear map over GF(2)^8, so a
whole GF(2^8) matrix product lowers to a GF(2) matrix product 8x larger per side:

    parity_bits = (G_bits @ data_bits) mod 2

where data bytes are unpacked to bits (LSB-first) along the contraction axis. The
mod-2 sum is computed with an ordinary matrix product (exact: row sums <= 8n)
followed by a parity mask. The byte-major (8r, 8n) bit matrix is the public
matrix format of ops/rs.py: the plain PyTorch lowering multiplies by it directly,
and the CUDA kernels' wrappers build their operands from it (ops/cuda_gf.py:
split tables of each 8x8 block; ops/cuda_gf_pipe.py: MMA fragments).
"""

from __future__ import annotations

import numpy as np

from chubaofs_tpu_torch.ops import gf256

BITS = 8
# LSB-first bit order everywhere: bit b of byte d is (d >> b) & 1.
_BIT_POS = np.arange(BITS, dtype=np.uint8)


def mul_bit_matrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix M_c with bits(c * d) = M_c @ bits(d) mod 2.

    Column b is bits(c * x^b) since d = sum_b d_b x^b over the field.
    """
    cols = gf256.gf_mul(np.uint8(c), (np.uint8(1) << _BIT_POS))  # c * x^b, shape (8,)
    return ((cols[None, :] >> _BIT_POS[:, None]) & 1).astype(np.uint8)


def expand_matrix(m: np.ndarray) -> np.ndarray:
    """Lift a (r, c) GF(2^8) matrix to its (8r, 8c) GF(2) bit matrix.

    Block (i, j) is mul_bit_matrix(m[i, j]); row index 8*i+b selects output bit b of
    GF-row i, column index 8*j+b selects input bit b of GF-column j — matching the
    (shard, bit) -> shard*8+bit flattening used by unpack_bits.
    """
    m = np.asarray(m, dtype=np.uint8)
    r, c = m.shape
    # bits(m[i,j] * x^b) for all i,j,b at once
    basis = (np.uint8(1) << _BIT_POS)  # (8,)
    prod = gf256.gf_mul(m[:, :, None], basis[None, None, :])  # (r, c, 8): m_ij * x^b
    bits = (prod[:, :, None, :] >> _BIT_POS[None, None, :, None]) & 1  # (r, c, 8out, 8in)
    return bits.transpose(0, 2, 1, 3).reshape(r * BITS, c * BITS).astype(np.uint8)


def unpack_bits_np(data: np.ndarray) -> np.ndarray:
    """(..., n, k) uint8 -> (..., 8n, k) {0,1} uint8, row n*8+b = bit b (LSB-first)."""
    data = np.asarray(data, dtype=np.uint8)
    bits = (data[..., :, None, :] >> _BIT_POS[:, None]) & 1
    shape = data.shape[:-2] + (data.shape[-2] * BITS, data.shape[-1])
    return bits.reshape(shape)


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """Inverse of unpack_bits_np: (..., 8m, k) {0,1} -> (..., m, k) uint8."""
    bits = np.asarray(bits, dtype=np.uint8)
    m = bits.shape[-2] // BITS
    b = bits.reshape(bits.shape[:-2] + (m, BITS, bits.shape[-1]))
    return (b << _BIT_POS[:, None]).sum(axis=-2).astype(np.uint8)
