"""The host side of B2, the double-buffered GF(2^8) kernel, held against the
JAX package's pipelined Pallas kernel.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py). What
runs here is everything around it: the tile choice, the span split, the
alignment choice and the row/column block plan of ops/cuda_gf_pipe.py, walked
CTA by CTA and tile by tile through a two-slot ring by a numpy emulation of
the kernel (the same ring order: tile t+1 is copied into the other slot
before tile t is computed). Its output must equal
chubaofs_tpu.ops.pallas_gf_pipe.gf_matmul_bytes_pipelined in interpret mode
for both slot variants, as the JAX package's own tests run it. Tolerance 0:
GF(2^8) math is exact.
"""

import numpy as np
import pytest
import torch

from chubaofs_tpu.ops import pallas_gf_pipe
from chubaofs_tpu.ops import rs as j_rs
from chubaofs_tpu_torch.ops import bitmatrix, cuda_gf, cuda_gf_pipe, gf256, rs

torch.set_num_threads(1)
H100_SMS = 132
H100_SMEM_OPTIN = 227 * 1024


def emulate(mat_bits, shards: np.ndarray, tile_k=None, sms=H100_SMS, static_slots=False,
            base_in=0, base_out=0) -> np.ndarray:
    """What the launches of gf_matmul_bytes_pipelined compute, in numpy: one
    launch per block of cuda_gf.blocks, one CTA per (stripe, span), each
    walking its span through the ring as the kernel does. base_in/base_out
    stand for the tensors' device addresses (they only pick the alignment)."""
    coef = cuda_gf.coefficients(mat_bits)
    r, n = coef.shape
    lead, k = shards.shape[:-2], shards.shape[-1]
    b = int(np.prod(lead, dtype=np.int64))
    data = shards.reshape(b, n, k)
    out = np.full((b, r, k), 0xA5, np.uint8)  # garbage: a column no CTA writes shows
    mt = gf256.mul_table()
    for r0, r1, j0, j1 in cuda_gf.blocks(r, n):
        nb = j1 - j0
        tab = cuda_gf.nibble_tables(coef[r0:r1, j0:j1])  # (rb, nb, 32)
        np.testing.assert_array_equal(tab[..., 1], mt[coef[r0:r1, j0:j1], 1])
        kt = cuda_gf_pipe.pick_tile(nb, k, tile_k)
        span = cuda_gf_pipe.span_tiles(b, k, kt, sms) * kt
        align = cuda_gf_pipe.align_of(k, base_in + j0 * k, base_out + r0 * k)
        assert kt % 16 == 0 and span % kt == 0
        assert cuda_gf_pipe.smem_bytes(r1 - r0, nb, kt) <= H100_SMEM_OPTIN
        for s in range(b):
            for col0 in range(0, k, span):
                end = min(k, col0 + span)
                tiles = -(-(end - col0) // kt)
                ring = np.zeros((cuda_gf_pipe.STAGES, nb, kt), np.uint8)

                def load(t, slot):
                    c0 = col0 + t * kt
                    ln = min(kt, end - c0)
                    if align > 1:  # whole vectors only: a span never splits one
                        assert c0 % 16 == 0 and ln % align == 0
                    ring[slot, :, :ln] = data[s, j0:j1, c0:c0 + ln]

                def step(t, slot, nxt):
                    if t + 1 < tiles:
                        load(t + 1, nxt)
                    c0 = col0 + t * kt
                    ln = min(kt, end - c0)
                    x = ring[slot]
                    acc = np.zeros((r1 - r0, kt), np.uint8)
                    for j in range(nb):
                        acc ^= tab[:, j, x[j] & 15] ^ tab[:, j, 16 + (x[j] >> 4)]
                    if j0 > 0:  # column blocks after the first accumulate
                        acc[:, :ln] ^= out[s, r0:r1, c0:c0 + ln]
                    out[s, r0:r1, c0:c0 + ln] = acc[:, :ln]

                load(0, 0)
                if static_slots:
                    for t in range(0, tiles, 2):
                        step(t, 0, 1)
                        if t + 1 < tiles:
                            step(t + 1, 1, 0)
                else:
                    for t in range(tiles):
                        step(t, t % 2, (t + 1) % 2)
    return out.reshape(*lead, r, k)


def jax_pipe(mat_bits, data, static):
    return np.asarray(pallas_gf_pipe.gf_matmul_bytes_pipelined(
        np.asarray(mat_bits, np.int8), data, tile_k=128, interpret=True, static_slots=static))


# -- the emulated kernel against the JAX interpret-mode kernel --------------------


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("k", [128, 256, 384, 640, 300, 1, 15, 17, 511, 512, 513])
def test_tile_walk_matches_jax_pipelined_kernel(rng, k, static):
    """tile_k=128 with the grid sized for one SM: 1, 2, 3 and 5 tiles per CTA,
    k under one tile, unaligned k, and span boundaries at 512 +- 1."""
    ker = rs.get_kernel(6, 3, "cpu")
    data = rng.integers(0, 256, (2, 6, k), dtype=np.uint8)
    want = jax_pipe(ker.parity_bits, data, static)
    for sms in (1, H100_SMS):
        got = emulate(ker.parity_bits, data, tile_k=128, sms=sms, static_slots=static)
        np.testing.assert_array_equal(got, want, err_msg=f"k={k} sms={sms}")


@pytest.mark.parametrize("static", [False, True])
def test_tile_walk_group_stacked_matrix(rng, static):
    """A block-diagonal kron(I_g, M) matrix runs through unchanged."""
    ker = rs.get_kernel(4, 2, "cpu")
    b, g, n, k = 4, 2, 4, 384
    host = rng.integers(0, 256, (b, n, k), dtype=np.uint8)
    mat_s = np.kron(np.eye(g, dtype=np.int8), rs.to_numpy(ker.parity_bits))
    stacked = host.reshape(b // g, g * n, k)
    want = jax_pipe(mat_s, stacked, static)
    got = emulate(mat_s, stacked, tile_k=128, sms=1, static_slots=static)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got.reshape(b, 2, k), rs.gf_matmul_bytes(ker.parity_bits, torch.from_numpy(host)).numpy())


@pytest.mark.parametrize("base_in,base_out", [(0, 0), (4, 0), (1, 3), (0, 12)])
def test_tile_walk_alignment_choice(rng, base_in, base_out):
    """Row bases off 16 bytes take 4-byte copies or byte loads; the result
    does not change."""
    ker = rs.get_kernel(3, 2, "cpu")
    data = rng.integers(0, 256, (1, 3, 1024), dtype=np.uint8)
    want = jax_pipe(ker.parity_bits, data, False)
    got = emulate(ker.parity_bits, data, tile_k=128, sms=1, base_in=base_in, base_out=base_out)
    np.testing.assert_array_equal(got, want)


def test_tile_walk_column_blocks_accumulate(rng):
    """Past 1,536 coefficients the plan splits into column blocks that
    XOR-accumulate into the output (the kernel's accumulate flag)."""
    coef = rng.integers(0, 256, (2, 1600), dtype=np.uint8)
    bits = bitmatrix.expand_matrix(coef).astype(np.int8)
    data = rng.integers(0, 256, (1, 1600, 200), dtype=np.uint8)
    assert [(j0, j1) for _, _, j0, j1 in cuda_gf.blocks(2, 1600)] == [(0, 1536)] * 2 + [(1536, 1600)] * 2
    got = emulate(bits, data, sms=1)
    np.testing.assert_array_equal(got, np.asarray(j_rs.gf_matmul_bytes(bits, data)))
    np.testing.assert_array_equal(got[0], gf256.gf_matmul(coef, data[0]))


# -- the plan on the main path's shapes -----------------------------------------------


@pytest.mark.parametrize("b,n,r,k", [
    (16, 12, 4, 1 << 20),      # EC(12,4) 8 MiB stripes at the service's 1 MiB bucket
    (16, 12, 4, 699_136),      # the same stripes unbucketed
    (8, 6, 3, 699_051),        # EC(6,3) 4 MiB: k not a multiple of 4
    (4, 30, 30, 279_621),      # RG6P6 sub-unit rows
    (2, 20, 6, 1 << 20),       # EC(20,4)+L2 composed LRC matrix
    (1, 12, 2, 200_000),       # a ranged-read window decode
    (1, 3, 3, 16_384),         # EC(3,3) small-object bucket
])
def test_plan_fills_the_card_within_shared_memory(b, n, r, k):
    kt = cuda_gf_pipe.pick_tile(n, k)
    assert kt % 16 == 0 and 16 <= kt <= cuda_gf_pipe.MAX_TILE
    assert cuda_gf_pipe.STAGES * n * kt <= cuda_gf_pipe.STAGE_SMEM_TARGET
    assert cuda_gf_pipe.smem_bytes(r, n, kt) <= H100_SMEM_OPTIN
    span = cuda_gf_pipe.span_tiles(b, k, kt, H100_SMS) * kt
    ctas = b * -(-k // span)
    tiles = -(-k // kt)
    if b * tiles >= 2 * H100_SMS:  # enough work: the grid covers the SMs twice
        assert ctas >= 2 * H100_SMS
    else:  # too little: one tile per CTA, as many CTAs as tiles
        assert span == kt and ctas == b * tiles


def test_align_and_tile_choice():
    assert cuda_gf_pipe.align_of(1 << 20, 0, 256) == 16
    assert cuda_gf_pipe.align_of(1 << 20, 4, 256) == 4
    assert cuda_gf_pipe.align_of(699_051, 0, 0) == 1
    assert cuda_gf_pipe.align_of(279_620, 0, 0) == 4
    assert cuda_gf_pipe.pick_tile(6, 1) == 16
    assert cuda_gf_pipe.pick_tile(6, 100_000, tile_k=128) == 128
    for bad in (0, 100, -16):
        with pytest.raises(ValueError):
            cuda_gf_pipe.pick_tile(6, 1000, tile_k=bad)


# -- the dispatcher and the wrapper on the CPU --------------------------------------


@pytest.mark.parametrize("env", ["1", "static", "", "0"])
def test_dispatch_sends_cpu_tensors_to_the_plain_version(rng, monkeypatch, env):
    monkeypatch.setenv("CFS_GF_PIPELINED", env)
    ker = rs.get_kernel(12, 4, "cpu")
    data = rng.integers(0, 256, (3, 12, 1000), dtype=np.uint8)
    before = dict(cuda_gf_pipe.LAUNCHES), cuda_gf.LAUNCHES
    got = rs.gf_matmul_dispatch(ker.parity_bits, torch.from_numpy(data))
    want = np.asarray(j_rs.gf_matmul_bytes(rs.to_numpy(ker.parity_bits), data))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rs.gf_matmul_hostbatch(ker.parity_bits, data, "cpu"), got.numpy())
    assert (dict(cuda_gf_pipe.LAUNCHES), cuda_gf.LAUNCHES) == before


def test_pipe_wrapper_rejects_cpu_tensors():
    bits = rs.get_kernel(4, 2, "cpu").parity_bits
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_gf_pipe.gf_matmul_bytes_pipelined(bits, torch.zeros((2, 4, 64), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_gf_pipe.gf_matmul_bytes_pipelined(bits, np.zeros((2, 4, 64), np.uint8))
