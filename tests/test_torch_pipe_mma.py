"""The tensor-core core of B2 (ops/csrc/gf_bitmma.cuh), lane by lane in numpy.

Each function below does what its namesake in gf_bitmma.cuh does, on arrays
of the 32 lanes' registers: the byte transposes (__byte_perm with the
header's selectors), the A fragments, mma.m16n8k32 on the documented
fragment indices (PTX ISA; CUTLASS SM80_16x8x32_S32S8S8S32_TN), and the pack
by bit selects. The B fragments are the wrapper's own buffer,
ops/cuda_gf_pipe.py::operand. The tests hold one MMA tile and one whole
group against (M_bits . bits(data)) & 1, tolerance 0: GF(2) math is exact.
tests/test_torch_pipe.py walks the whole kernel with these functions.
"""

import re

import numpy as np
import pytest

from chubaofs_tpu_torch.ops import bitmatrix, cuda_gf_pipe, gf256

LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3  # groupID and thread-in-group of each lane
SELECTORS = (0x5140, 0x7362, 0x5410, 0x7632)  # the transposes' __byte_perm selectors

# fragment indices, from the PTX ISA's m16n8k32 .s8 tables: [lane, reg, byte q]
A_ROW = np.stack([G, G + 8, G, G + 8], axis=1)[:, :, None].repeat(4, axis=2)
A_COL = (np.array([0, 0, 16, 16])[None, :, None] + 4 * T[:, None, None] + np.arange(4)[None, None, :])
B_ROW = (np.array([0, 16])[None, :, None] + 4 * T[:, None, None] + np.arange(4)[None, None, :])  # k
B_COL = np.broadcast_to(G[:, None, None], (32, 2, 4))  # n
C_ROW = np.stack([G, G, G + 8, G + 8], axis=1)  # [lane, reg]
C_COL = np.stack([2 * T, 2 * T + 1, 2 * T, 2 * T + 1], axis=1)


def u32(x):
    return np.asarray(x).astype(np.uint32)


def byte_perm(x, y, sel: int):
    """__byte_perm(x, y, sel) for selectors without the sign-replicate bit."""
    v = u32(x).astype(np.uint64) | (u32(y).astype(np.uint64) << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        s = (sel >> (4 * i)) & 0xF
        assert s < 8
        out |= ((v >> np.uint64(8 * s)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def transpose4(r):
    t0 = byte_perm(r[0], r[1], 0x5140)
    t1 = byte_perm(r[2], r[3], 0x5140)
    t2 = byte_perm(r[0], r[1], 0x7362)
    t3 = byte_perm(r[2], r[3], 0x7362)
    return [byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632),
            byte_perm(t2, t3, 0x5410), byte_perm(t2, t3, 0x7632)]


def a_frags(r):
    """r[q]: (..., 32) words of input row q at each lane's columns ->
    (..., 2 M tiles, 32, 4 regs)."""
    w = transpose4(r)
    t = T.astype(np.uint32)
    return np.stack([np.stack([w[m] >> t, w[m + 2] >> t, w[m] >> (t + 4), w[m + 2] >> (t + 4)],
                              axis=-1) for m in range(2)], axis=-3)


def s8_bytes(regs):
    """(..., n) uint32 registers -> (..., n, 4) signed bytes, byte q of each."""
    b = (u32(regs)[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & np.uint32(0xFF)
    return b.astype(np.uint8).view(np.int8).astype(np.int64)


def mma(acc, a, b):
    """acc (..., 32, 4) += the m16n8k32 product of the lanes' A (..., 32, 4)
    and B (..., 32, 2) registers, s32 wrapping."""
    lead = a.shape[:-2]
    am = np.zeros(lead + (16, 32), np.int64)
    am[..., A_ROW, A_COL] = s8_bytes(a)
    bm = np.zeros(lead + (32, 8), np.int64)
    bm[..., B_ROW, B_COL] = s8_bytes(b)
    c = am @ bm
    out = acc.astype(np.int64) + c[..., C_ROW, C_COL]
    return ((out + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int64)


def select_low(x, y, b: int):
    mask = np.uint32((1 << b) - 1)
    return (u32(x) & mask) | (u32(y) & ~mask)


def merge_byte(acc_m, e0: int):
    """acc_m: (..., R MMAs, 32, 4) of one M tile -> (..., 32) bytes in bits
    0..7, each lane's own bits right: bit p * 8/R + base + e from acc_m[p][e0 + e]."""
    rows = acc_m.shape[-3]
    per = 8 // rows
    base = (2 * T) % per
    x = u32(acc_m[..., 0, :, e0] & 0xFFFFFFFF)
    for i in range(1, 2 * rows):
        p, e = i >> 1, i & 1
        mask = ((np.uint32(1) << u32(p * per + base + e)) - np.uint32(1)).astype(np.uint32)
        x = (x & mask) | (u32(acc_m[..., p, :, e0 + e] & 0xFFFFFFFF) & ~mask)
    return x


def shfl_xor(v, s: int):
    """__shfl_xor_sync over the lane axis (the last)."""
    return v[..., LANE ^ s]


def pack_word(acc):
    """acc: (..., 2 M tiles, R MMAs, 32, 4) -> (..., 32) words: lane (g, t)'s
    bytes of columns 4g .. 4g + 3, output row t * R / 4 of the pass (complete
    in the lanes with t % (4/R) == 0, and in their quad partners)."""
    rows = acc.shape[-3]
    c0, c1 = merge_byte(acc[..., 0, :, :, :], 0), merge_byte(acc[..., 1, :, :, :], 0)
    c2, c3 = merge_byte(acc[..., 0, :, :, :], 2), merge_byte(acc[..., 1, :, :, :], 2)
    w = byte_perm(byte_perm(c0, c1, 0x0040), byte_perm(c2, c3, 0x0040), 0x5410)
    if rows < 4:
        per = 8 // rows
        base = (2 * T) % per
        own = sum(np.uint32(3) << u32(p * per + base) for p in range(rows)).astype(np.uint32)
        w = w & (own * np.uint32(0x01010101))
        s = 1
        while s < 4 // rows:
            w = w | shfl_xor(w, s)
            s <<= 1
    return w


def words(block, cols):
    """block (..., rows, cols) uint8 -> (..., rows, 32) the LE word of each
    lane's 4 columns 4g .. 4g + 3 (lanes of one quad share it)."""
    w = np.ascontiguousarray(block[..., :cols]).view("<u4")  # (..., rows, cols / 4)
    return w[..., G]


def group_pass(acc, r_words, op, pass_, jg):
    """One input group of one pass: 2 M tiles x R MMAs. r_words: (..., 4, 32)."""
    rows = op.shape[2]
    a = a_frags([r_words[..., q, :] for q in range(4)])  # (..., 2, 32, 4)
    bregs = op[pass_, jg].reshape(rows, 32, 8).view("<u4")  # (R MMAs, 32, 2)
    for p in range(rows):
        for m in range(2):
            acc[..., m, p, :, :] = mma(acc[..., m, p, :, :], a[..., m, :, :], bregs[p])
    return acc


def chunk_words(mat_bits, data32):
    """The kernel's arithmetic on one 32-column chunk: data32 (n, 32) ->
    (P, 32) packed words, lane (g, t) of pass P holding row RP + t * R / 4."""
    op = cuda_gf_pipe.operand(mat_bits)
    passes, groups, rows = op.shape[:3]
    n = data32.shape[0]
    data = np.zeros((4 * groups, 32), np.uint8)
    data[:n] = data32
    out = []
    for p_ in range(passes):
        acc = np.zeros((2, rows, 32, 4), np.int64)
        for jg in range(groups):
            acc = group_pass(acc, words(data[4 * jg:4 * jg + 4], 32), op, p_, jg)
        out.append(pack_word(acc))
    return np.stack(out)


def unpack_chunk(packed, r):
    """(P, 32) lane words -> (r, 32) output bytes, from the storing lanes
    (t % (4/R) == 0) of each pass."""
    rows = cuda_gf_pipe.rows_per_pass(r)
    out = np.zeros((rows * packed.shape[0], 32), np.uint8)
    for p_ in range(packed.shape[0]):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            if t % (4 // rows) == 0:
                out[rows * p_ + t * rows // 4, 4 * g:4 * g + 4] = np.array([packed[p_, lane]], "<u4").view(np.uint8)
    return out[:r]


# -- tests -------------------------------------------------------------------------


def test_header_carries_the_emulated_layout():
    """The constants emulated here are the ones the CUDA header uses."""
    src = (cuda_gf_pipe.SOURCE.parent / "gf_bitmma.cuh").read_text(encoding="utf-8")
    for sel in SELECTORS:
        assert f"0x{sel:04x}" in src
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    assert "__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040), 0x5410" in src
    assert re.search(r"kColsPerWarp = 32;", src) and re.search(r"kMaxRowsPerPass = 4;", src)


def test_byte_transpose():
    r = [np.uint32(0x03020100 + 0x10101010 * q) for q in range(4)]
    w = transpose4(r)
    for c in range(4):
        assert [(int(w[c]) >> (8 * q)) & 0xFF for q in range(4)] == [c + 0x10 * q for q in range(4)]


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("r", [4, 2, 1])
def test_one_mma_tile_lane_by_lane(r, seed):
    """One m16n8k32 tile (M tile 0 of a chunk, MMA p of pass 0, group 0),
    lane by lane from the wrapper's operand buffer: C's bit b is the GF(2)
    product's bit, with zeros below it, for R = r rows per pass."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (8 * r, 32), dtype=np.int8)  # r outputs x 4 inputs, any GF(2) matrix
    data = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    op = cuda_gf_pipe.operand(bits)
    assert op.shape == (1, 1, r, 32, 2, 4) and op.dtype == np.uint8
    want = (bits.astype(np.int64) @ bitmatrix.unpack_bits_np(data).astype(np.int64)) & 1  # (8r, 32)
    a = a_frags([words(data[q:q + 1], 32)[0] for q in range(4)])[0]  # M tile 0: (32, 4)
    bregs = op[0, 0].reshape(r, 32, 8).view("<u4")
    per = 8 // r  # bits of a row per MMA
    for p in range(r):
        c = mma(np.zeros((32, 4), np.int64), a, bregs[p])
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for reg in range(4):
                col = 4 * g + (2 if reg >= 2 else 0)  # M tile 0: row g -> 4g, row g + 8 -> 4g + 2
                n = 2 * t + (reg & 1)                 # C column: output row n // per, bit p * per + n % per
                row, b = n // per, p * per + n % per
                v = int(c[lane, reg]) & 0xFFFFFFFF
                assert v & ((1 << b) - 1) == 0
                assert (v >> b) & 1 == want[8 * row + b, col], (p, lane, reg)


@pytest.mark.parametrize("r,n", [(4, 4), (3, 6), (4, 12), (1, 12), (2, 7), (6, 5), (8, 16), (1, 3)])
def test_chunk_equals_gf_product(rng, r, n):
    """Every group and pass of one 32-column chunk, packed: the GF(2^8)
    product of the expansion matrix, and the GF(2) product of a random one."""
    data = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    coef = rng.integers(0, 256, (r, n), dtype=np.uint8)
    got = unpack_chunk(chunk_words(bitmatrix.expand_matrix(coef), data), r)
    np.testing.assert_array_equal(got, gf256.gf_matmul(coef, data))
    bits = rng.integers(0, 2, (8 * r, 8 * n), dtype=np.int8)
    want = bitmatrix.pack_bits_np((bits.astype(np.int64) @ bitmatrix.unpack_bits_np(data)) & 1)
    np.testing.assert_array_equal(unpack_chunk(chunk_words(bits, data), r), want)


def test_operand_layout_and_scaling():
    """64 bytes per coefficient; bit b scaled by 2^b (bit 7 is -128 as s8);
    zero past r and n."""
    bits = np.ones((8 * 5, 8 * 6), np.int8)
    op = cuda_gf_pipe.operand(bits)
    assert op.shape == (2, 2, 4, 32, 2, 4) and op.nbytes == 2 * 4 * 2 * 4 * 64
    g = np.arange(32) >> 2
    for p in range(4):
        scale = 1 << (2 * p + (g & 1))
        np.testing.assert_array_equal(op[0, 0, p, :, 0, 0], scale)
    assert op[1, :, :, g >= 2].max() == 0  # pass 1 rows 5..7 do not exist
    assert op[:, 1, :, :, :, 2:].max() == 0  # group 1 inputs 6, 7 do not exist
    assert set(np.unique(op)) == {0, 1, 2, 4, 8, 16, 32, 64, 128}
    for r in (1, 2):  # R = r rows per pass: one pass of r MMAs, 8/r bits of each row per MMA
        op = cuda_gf_pipe.operand(np.ones((8 * r, 8 * 6), np.int8))
        assert op.shape == (1, 2, r, 32, 2, 4) and op.nbytes == r * 6 * 64 + r * 2 * 64
        for p in range(r):
            np.testing.assert_array_equal(op[0, 0, p, :, 0, 0], 1 << (p * (8 // r) + g % (8 // r)))
