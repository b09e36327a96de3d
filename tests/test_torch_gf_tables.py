"""B1, the default GF(2^8) kernel, emulated lane by lane on the CPU and held
against the JAX package's kernel.

The CUDA kernel (chubaofs_tpu_torch/ops/csrc/gf_matmul.cu) runs only on the
card (tests/test_torch_cuda.py). What runs here is a numpy walk of it, from
the wrapper's own table buffers and launch plan (ops/cuda_gf.py: _plan,
blocks, row_tile, aligned): `prmt` bit for bit (sign-replicate bit
included), the three selectors per input word pair with the kernel's
constants, the un-permute, output rows in tiles of row_tile, column blocks
that XOR-accumulate, the persistent warps' walk over (stripe, 1 KiB) items,
and the memory side of unaligned rows: three aligned 16-byte loads from
column c - o and a funnel shift, bytewise ragged ends, aligned 16-byte
stores fed by the left lane's words (__shfl_up_sync), work items that
overlap by one lane so that only a row's two ends are stored bytewise. Every load must stay inside its row and every output byte
must be written exactly once per launch. The result must equal
chubaofs_tpu.ops.pallas_gf.gf_matmul_bytes_fused in interpret mode, as the
JAX package's own tests run it, and the port's plain version. Tolerance 0:
GF(2^8) math is exact.
"""

import re

import numpy as np
import pytest
import torch

from chubaofs_tpu.codec import codemode as j_codemode
from chubaofs_tpu.codec import encoder as j_encoder
from chubaofs_tpu.codec import pm as j_pm
from chubaofs_tpu.ops import bitmatrix as j_bitmatrix
from chubaofs_tpu.ops import pallas_gf as j_pallas_gf
from chubaofs_tpu.ops import rs as j_rs
from chubaofs_tpu_torch.ops import cuda_gf, gf256, rs

torch.set_num_threads(1)

# the kernel's constants (gf_matmul.cu; test_kernel_source_has_the_constants)
FIELDS = ((0, 0x07070707), (3, 0x07070707), (6, 0x03030303))  # (shift, mask) per field
UNPERMUTE = (0x6420, 0x7531)  # x's word, y's word
CHUNK = 32  # bytes of a row per lane
WARP_COLS = 32 * CHUNK


def item_stride(aligned):
    """Columns between work items: unaligned items overlap by one lane."""
    return WARP_COLS if aligned else WARP_COLS - CHUNK


def items_per_stripe(k, aligned):
    if aligned or k <= WARP_COLS:
        return -(-k // WARP_COLS)
    return -(-(k - CHUNK) // item_stride(aligned))
U32 = np.uint64(0xFFFFFFFF)


def prmt(a, b, c):
    """PTX prmt.b32 in its default mode: byte i of the result is byte
    (nibble i of c) & 7 of {b, a}, or that byte's sign bit replicated when
    the nibble's bit 3 is set. Only c[15:0] is read."""
    c = np.asarray(c, np.uint64)
    pool = np.asarray(a, np.uint64) | np.asarray(b, np.uint64) << np.uint64(32)
    out = np.zeros(np.broadcast(pool, c).shape, np.uint64)
    for i in range(4):
        nib = c >> np.uint64(4 * i) & np.uint64(15)
        byte = pool >> (np.uint64(8) * (nib & np.uint64(7))) & np.uint64(0xFF)
        sign = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        out |= np.where(nib & np.uint64(8), sign, byte) << np.uint64(8 * i)
    return out


def selectors(x, y):
    """The six selectors of a word pair: per field, (t, t >> 16)."""
    sel = []
    for s, m in FIELDS:
        t = (x >> np.uint64(s) & np.uint64(m)) | (y >> np.uint64(s) & np.uint64(m)) << np.uint64(4)
        sel += [t, t >> np.uint64(16)]
    return sel


def table_words(tab):
    """One block's 32 table bytes as the kernel reads them: T0 = (Ta0, Tb0),
    T1 = (Ta1, Tb1), T2 = Ta2 (one uint4 and one uint32 load)."""
    w = np.frombuffer(tab.tobytes(), "<u4").astype(np.uint64)
    return w[0], w[1], w[2], w[3], w[4]


def shift_bytes(u, o):
    """Bytes [o, o + 32) of the 12 words u as 8 words: whole-word offset
    o >> 2, then a funnel shift by 8 * (o & 3) bits."""
    d, sh = o >> 2, np.uint64(8 * (o & 3))
    return np.stack([(u[:, d + q] | u[:, d + q + 1] << np.uint64(32)) >> sh & U32
                     for q in range(8)], axis=1)


class Memory:
    """A flat buffer at a device address `base`, with reads bounded to one
    row and writes counted per byte."""

    def __init__(self, buf, base):
        self.buf, self.base = buf, base
        self.count = np.zeros(buf.shape, np.int64)

    def words(self, addr, n_words):
        idx = (addr - self.base)[:, None] + np.arange(4 * n_words)
        b = self.buf[idx].astype(np.uint64).reshape(len(addr), n_words, 4)
        return b[..., 0] | b[..., 1] << np.uint64(8) | b[..., 2] << np.uint64(16) | b[..., 3] << np.uint64(24)

    def vector_load(self, row, k, addr):
        """128-bit loads: 16-byte aligned and inside the row [row, row + k)."""
        assert np.all(addr % 16 == 0) and np.all(addr >= row) and np.all(addr + 16 <= row + k)
        return self.words(addr, 4)

    def load_row(self, row, k, c, aligned):
        """RowChunk.issue + finish: 8 words of columns [c, c + 32) per lane."""
        o = row % 16
        w = np.zeros((len(c), 8), np.uint64)
        if aligned:
            assert o == 0 and k % 16 == 0
            for m in range(2):
                ok = c + 16 * m < k
                w[ok, 4 * m:4 * m + 4] = self.vector_load(row, k, row + c[ok] + 16 * m)
            return w
        vec = (c + CHUNK <= k) if o == 0 else ((c >= CHUNK) & (c - o + CHUNK + 16 <= k))
        u = np.zeros((int(vec.sum()), 12), np.uint64)
        for m in range(3 if o else 2):
            u[:, 4 * m:4 * m + 4] = self.vector_load(row, k, row + c[vec] - o + 16 * m)
        w[vec] = shift_bytes(u, o)
        for e in range(CHUNK):  # the ragged ends, bytewise
            col = c + e
            ok = ~vec & (col < k)
            w[ok, e // 4] |= self.buf[row - self.base + col[ok]].astype(np.uint64) << np.uint64(8 * (e % 4))
        return w

    def store(self, row, start, words, mask, lo, hi, vector):
        """Bytes of `words` (4 per lane) at columns start.. that lie in
        [lo, hi): a 16-byte aligned vector store (which must be whole) or
        byte stores."""
        b = (words[:, :, None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64)) & np.uint64(0xFF))
        b = b.reshape(len(start), 16).astype(np.uint8)
        cols = start[:, None] + np.arange(16)
        lo = np.broadcast_to(lo, start.shape)[:, None]
        ok = mask[:, None] & (cols >= lo) & (cols < hi)
        if vector:
            assert np.all(ok[mask]) and np.all((row + start[mask]) % 16 == 0)
        idx = row - self.base + cols[ok]
        self.buf[idx] = b[ok]
        np.add.at(self.count, idx, 1)


def store_chunk(mem, row, k, c, lane, first, last, w, aligned):
    """store_chunk of the kernel, for every lane of a stripe at once (first,
    last: the lane's item is the stripe's first, last)."""
    if aligned:
        for m in range(2):
            mem.store(row, c + 16 * m, w[:, 4 * m:4 * m + 4], c + 16 * m < k, 0, k, vector=True)
        return
    left = np.where((lane == 0)[:, None], w[:, 4:8], np.roll(w[:, 4:8], 1, axis=0))  # __shfl_up_sync
    owner = first | (lane != 0)  # a later item's lane 0 repeats the lane before it: no stores
    oo = row % 16
    if oo == 0:
        for m in range(2):
            start = c + 16 * m
            full = start + 16 <= k
            mem.store(row, start, w[:, 4 * m:4 * m + 4], owner & full, 0, k, vector=True)
            mem.store(row, start, w[:, 4 * m:4 * m + 4], owner & ~full, 0, k, vector=False)
        return
    blk = shift_bytes(np.concatenate([left, w], axis=1), 16 - oo)
    for m in range(2):
        start = c - oo + 16 * m
        words = blk[:, 4 * m:4 * m + 4]
        if m == 0:  # the row's first block: no left neighbour, own bytes only
            mem.store(row, start, words, owner & (lane == 0), c, k, vector=False)
        rest = owner if m else owner & (lane != 0)
        full = rest & (start >= 0) & (start + 16 <= k)
        mem.store(row, start, words, full, 0, k, vector=True)
        mem.store(row, start, words, rest & ~full, 0, k, vector=False)
    mem.store(row, c + 16, w[:, 4:8], last & (lane == 31), c + CHUNK - oo, k, vector=False)


def warp_walk(items, warps):
    """The items each persistent warp takes: it = warp, warp + warps, ..."""
    return [list(range(w, items, warps)) for w in range(warps)]


def emulate(mat_bits, shards, base_in=0, base_out=0, warps=264 * 8):
    """What the launches of cuda_gf.gf_matmul compute, in numpy. base_in and
    base_out stand for the tensors' device addresses (they set the
    alignment and each row's offset mod 16)."""
    bits = np.asarray(mat_bits, np.int8)
    r, n = bits.shape[0] // 8, bits.shape[1] // 8
    lead, k = shards.shape[:-2], shards.shape[-1]
    b = int(np.prod(lead, dtype=np.int64))
    src = Memory(np.ascontiguousarray(shards).reshape(-1).copy(), base_in)
    dst = Memory(np.full(b * r * k, 0xA5, np.uint8), base_out)  # garbage where nothing is written
    aligned = cuda_gf.aligned(k, base_in, base_out)
    per_stripe = items_per_stripe(k, aligned)
    walk = warp_walk(b * per_stripe, min(warps, -(-b * per_stripe // 8) * 8))
    assert sorted(i for w in walk for i in w) == list(range(b * per_stripe))
    item = np.repeat(np.arange(per_stripe), 32)
    lane = np.arange(per_stripe * 32) % 32
    c = item * item_stride(aligned) + CHUNK * lane
    first, last = item == 0, item == per_stripe - 1
    for r0, r1, j0, j1, tab in cuda_gf._plan(bits, torch.device("cpu")):
        tab = tab.numpy()
        rb, nb = r1 - r0, j1 - j0
        assert tab.shape == (rb, nb, cuda_gf.TAB_BYTES) and tab.nbytes <= cuda_gf.SMEM_BUDGET
        rt = cuda_gf.row_tile(rb)
        dst.count[:] = 0
        for s in range(b):
            src_s = base_in + (s * n + j0) * k
            dst_s = base_out + (s * r + r0) * k
            for p0 in range(0, rb, rt):
                acc = np.zeros((rt, len(c), 8), np.uint64)
                for j in range(nb):
                    w = src.load_row(src_s + j * k, k, c, aligned)
                    sel = [selectors(w[:, 2 * p], w[:, 2 * p + 1]) for p in range(4)]
                    for rr in range(min(rt, rb - p0)):
                        ta0, tb0, ta1, tb1, ta2 = table_words(tab[p0 + rr, j])
                        for p, (s0, s0h, s1, s1h, s2, s2h) in enumerate(sel):
                            acc[rr, :, 2 * p] ^= prmt(ta0, tb0, s0) ^ prmt(ta1, tb1, s1) ^ prmt(ta2, 0, s2)
                            acc[rr, :, 2 * p + 1] ^= prmt(ta0, tb0, s0h) ^ prmt(ta1, tb1, s1h) ^ prmt(ta2, 0, s2h)
                for rr in range(min(rt, rb - p0)):
                    res = np.zeros((len(c), 8), np.uint64)
                    for p in range(4):
                        for half, sel_un in enumerate(UNPERMUTE):
                            res[:, 2 * p + half] = prmt(acc[rr, :, 2 * p], acc[rr, :, 2 * p + 1], sel_un)
                    row = dst_s + (p0 + rr) * k
                    if j0 > 0:  # column blocks after the first accumulate
                        res ^= dst.load_row(row, k, c, aligned)
                    store_chunk(dst, row, k, c, lane, first, last, res, aligned)
        # every byte of this block's output rows written once, nothing else
        cnt = dst.count.reshape(b, r, k)
        assert np.all(cnt[:, r0:r1] == 1) and cnt.sum() == b * rb * k
    return dst.buf.reshape(*lead, r, k)


# -- matrices of the main path ------------------------------------------------------


def _matrices():
    """name -> (8r, 8n) bit matrix: every kind the main path multiplies by,
    made by the JAX package, and two that test the plan's edges."""
    k12, k63 = j_rs.get_kernel(12, 4), j_rs.get_kernel(6, 3)
    pmk = j_pm.get_kernel(12, 6)
    lrc = lambda mode: j_encoder.lrc_parity_matrix(j_codemode.get_tactic(mode))  # noqa: E731
    rng = np.random.default_rng(44)
    gf = {
        "ec6p3_parity": k63.gen[6:],
        "ec12p4_parity": k12.gen[12:],
        "ec12p4_repair1": k12.repair_matrix([5])[0],
        "ec12p4_repair3": k12.repair_matrix([0, 5, 12])[0],
        "ec12p4_window": k12.window_matrix([0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 11, 13], [5, 12]),
        "ec16p20l2_lrc": lrc("EC16P20L2"),
        "ec20p4l2_lrc": lrc("EC20P4L2"),
        "rg6p6_parity": pmk.parity_mat,
        "rg6p6_decode": pmk.decode_matrix([1, 2, 4, 6, 8, 11], [0, 3, 5]),
        "rows_past_the_tile": rng.integers(0, 256, (9, 5), dtype=np.uint8),
    }
    mats = {name: j_bitmatrix.expand_matrix(m).astype(np.int8) for name, m in gf.items()}
    mats["gf2_nonexpansion"] = rng.integers(0, 2, (8 * 5, 8 * 7), dtype=np.int8)
    return mats


MATRICES = _matrices()


def jax_kernel(bits, data):
    k = data.shape[-1]
    return np.asarray(j_pallas_gf.gf_matmul_bytes_fused(
        bits, data, tile_k=128 if k <= 4096 else None, interpret=True))


def check(bits, data, **kw):
    want = jax_kernel(bits, data)
    got = emulate(bits, data, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rs.gf_matmul_bytes(bits, torch.from_numpy(data)).numpy())


@pytest.mark.parametrize("k", [1, 15, 17, 1000])
@pytest.mark.parametrize("name", list(MATRICES))
def test_emulated_kernel_matches_jax_kernel(name, k):
    """Every matrix kind at k under one chunk, odd, and over one warp's
    columns; two stripes, the second at another offset mod 16."""
    bits = MATRICES[name]
    n = bits.shape[1] // 8
    data = np.random.default_rng(k).integers(0, 256, (2, n, k), dtype=np.uint8)
    check(bits, data)


def test_emulated_kernel_byte_path_at_full_width():
    """EC(6,3) 4 MiB (k = 699,051): every row at its own offset mod 16,
    hundreds of items per stripe; only the ragged pieces go bytewise."""
    bits = MATRICES["ec6p3_parity"]
    data = np.random.default_rng(6).integers(0, 256, (1, 6, 699_051), dtype=np.uint8)
    check(bits, data, warps=2 * 132 * 8)


@pytest.mark.parametrize("base_in,base_out", [(0, 0), (1, 3), (4, 0), (0, 12), (15, 9)])
@pytest.mark.parametrize("k", [1024, 2048 + 16, 1001])
def test_emulated_kernel_alignment(base_in, base_out, k):
    """Row bases off 16 bytes (a slice of a larger tensor) take the
    unaligned kernel even where k is a multiple of 16; the bytes do not
    change."""
    bits = MATRICES["ec12p4_parity"]
    data = np.random.default_rng(k + base_in).integers(0, 256, (2, 12, k), dtype=np.uint8)
    assert cuda_gf.aligned(k, base_in, base_out) == (k % 16 == 0 and base_in % 16 == base_out % 16 == 0)
    check(bits, data, base_in=base_in, base_out=base_out)


@pytest.mark.parametrize("r,n,k", [(3, 1600, 100), (60, 30, 50)])
def test_emulated_kernel_past_the_shared_memory_budget(r, n, k):
    """Past SMEM_BUDGET the plan splits into column blocks that accumulate
    into the output, or into row blocks."""
    bits = np.random.default_rng(r).integers(0, 2, (8 * r, 8 * n), dtype=np.int8)
    assert len(cuda_gf.blocks(r, n)) > 1
    data = np.random.default_rng(n).integers(0, 256, (1, n, k), dtype=np.uint8)
    got = emulate(bits, data, base_in=1)
    np.testing.assert_array_equal(got, np.asarray(j_rs.gf_matmul_bytes(bits, data)))


def test_emulated_kernel_few_warps():
    """One block's worth of persistent warps walks all items of three
    stripes."""
    bits = MATRICES["rg6p6_decode"]
    data = np.random.default_rng(3).integers(0, 256, (3, 30, 5000), dtype=np.uint8)
    check(bits, data, warps=8)


# -- the pieces --------------------------------------------------------------------


def test_prmt_semantics():
    a, b = 0x83828180, 0x07060504
    assert int(prmt(a, b, 0x3210)) == a and int(prmt(a, b, 0x7654)) == b
    assert int(prmt(a, b, 0x0123)) == 0x80818283
    assert int(prmt(0x83028180, b, 0x89AB)) == 0xFFFF00FF  # bit 3: sign of bytes 3, 2, 1, 0
    assert int(prmt(a, b, 0xFFFF_0000)) == 0x80808080  # c[31:16] is not read


def test_split_lookup_identity():
    """For any 8x8 block, T0[x & 7] ^ T1[(x >> 3) & 7] ^ T2[x >> 6] is the
    block's byte map, and the interleaved prmt lookups plus the un-permute
    give it four bytes at a time."""
    rng = np.random.default_rng(9)
    x = np.arange(256)
    for _ in range(50):
        blk = rng.integers(0, 2, (8, 8), dtype=np.int8)
        t = cuda_gf.split_tables(blk)[0, 0]
        want = ((blk.astype(np.int64) @ ((x[None, :] >> np.arange(8)[:, None]) & 1)) & 1).T @ (1 << np.arange(8))
        np.testing.assert_array_equal(t[x & 7] ^ t[8 + ((x >> 3) & 7)] ^ t[16 + (x >> 6)], want)
        xs, ys = (rng.integers(0, 2**32, 64, dtype=np.uint64) for _ in range(2))
        ta0, tb0, ta1, tb1, ta2 = table_words(t)
        s0, s0h, s1, s1h, s2, s2h = selectors(xs, ys)
        lo = prmt(ta0, tb0, s0) ^ prmt(ta1, tb1, s1) ^ prmt(ta2, 0, s2)
        hi = prmt(ta0, tb0, s0h) ^ prmt(ta1, tb1, s1h) ^ prmt(ta2, 0, s2h)
        for word, sel_un in zip((xs, ys), UNPERMUTE):
            got = prmt(lo, hi, sel_un)
            wb = [(word >> np.uint64(8 * e) & np.uint64(0xFF)).astype(np.int64) for e in range(4)]
            exp = sum(want[v].astype(np.uint64) << np.uint64(8 * e) for e, v in enumerate(wb))
            np.testing.assert_array_equal(got, exp)


def test_kernel_source_has_the_constants():
    """The emulation's constants are the kernel's."""
    src = cuda_gf.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr (?:uint32_t|int) (k\w+) = ([^;]+?)u?;", src))
    assert int(consts["kMask3"], 16) == FIELDS[0][1] == FIELDS[1][1]
    assert int(consts["kMask2"], 16) == FIELDS[2][1]
    assert (int(consts["kUnpermX"], 16), int(consts["kUnpermY"], 16)) == UNPERMUTE
    assert int(consts["kChunk"]) == CHUNK and int(consts["kTabBytes"]) == cuda_gf.TAB_BYTES
    assert consts["kMaxSmem"] == "48 * 1024" and cuda_gf.SMEM_BUDGET == 48 * 1024
    for s, m in FIELDS[1:]:
        assert re.search(rf"\(x >> {s}\) & kMask{'3' if m == FIELDS[0][1] else '2'}", src)
    assert "(x & kMask3) | ((y & kMask3) << 4)" in src


def test_row_tile_and_alignment_choice():
    assert [cuda_gf.row_tile(r) for r in (1, 3, 4, 5, 8, 30)] == [4, 4, 4, 8, 8, 8]
    assert cuda_gf.aligned(1 << 20, 0, 256)
    assert not cuda_gf.aligned(1 << 20, 4, 256)
    assert not cuda_gf.aligned(699_051, 0, 0)
    # the non-expansion matrix has no GF(2^8) coefficients, and B1 takes it
    with pytest.raises(ValueError):
        cuda_gf.coefficients(MATRICES["gf2_nonexpansion"])
    plan = cuda_gf._plan(MATRICES["gf2_nonexpansion"], torch.device("cpu"))
    np.testing.assert_array_equal(plan[0][4].numpy(), cuda_gf.split_tables(MATRICES["gf2_nonexpansion"]))
    np.testing.assert_array_equal(
        cuda_gf.split_tables(MATRICES["ec6p3_parity"])[:, :, :8],
        gf256.mul_table()[j_rs.get_kernel(6, 3).gen[6:, :, None], np.arange(8)])
