"""The host side of B2, the pipelined GF(2^8) kernel, held against the JAX
package's pipelined Pallas kernel.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py). What
runs here is everything around it, walked by a numpy emulation of the
kernel: the B operand the wrapper builds (ops/cuda_gf_pipe.py::operand), the
block plan, tile choice and alignment choice, the persistent CTAs and the
items each walks, the three-stage ring (each input row at its global
offset mod 16, its ragged ends and its 16-byte aligned interior), the MMAs
on the documented fragment indices with the pack by bit selects
(tests/test_torch_pipe_mma.py), and the two output slots with their bulk
stores. Its output must equal
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
from test_torch_pipe_mma import G as LANE_G, T as LANE_T, group_pass, pack_word

torch.set_num_threads(1)
H100_SMS = 132
H100_SMEM_OPTIN = 227 * 1024
RESIDENT = 2 * H100_SMS  # CTAs that fit the H100 at once (2 per SM at these shared-memory sizes)
WARP_COLS = cuda_gf_pipe.TILE_QUANTUM // cuda_gf_pipe.CONSUMER_WARPS


def stage_words(row: np.ndarray, o: int, cols: np.ndarray) -> np.ndarray:
    """load4 of the kernel: the word at column c of a stage row whose column
    0 sits at offset o, from two aligned words and a funnel shift."""
    base = (o & ~3) + cols
    w = row.astype(np.uint64)
    w0 = w[base] | w[base + 1] << 8 | w[base + 2] << 16 | w[base + 3] << 24
    w1 = w[base + 4] | w[base + 5] << 8 | w[base + 6] << 16 | w[base + 7] << 24
    return ((w0 | w1 << np.uint64(32)) >> np.uint64(8 * (o & 3)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def emulate(mat_bits, shards: np.ndarray, tile_k=None, ctas=RESIDENT, static_slots=False,
            base_in=0, base_out=0) -> np.ndarray:
    """What the launches of gf_matmul_bytes_pipelined compute, in numpy: one
    launch per block of cuda_gf_pipe.blocks, min(items, ctas) persistent
    CTAs, each walking its items through the ring as the kernel does.
    base_in/base_out stand for the tensors' device addresses (they pick the
    alignment and each row's offset mod 16)."""
    bits = np.asarray(mat_bits, np.int8)
    r, n = bits.shape[0] // 8, bits.shape[1] // 8
    lead, k = shards.shape[:-2], shards.shape[-1]
    b = int(np.prod(lead, dtype=np.int64))
    data = shards.reshape(b, n, k)
    out = np.full((b, r, k), 0xA5, np.uint8)  # garbage: a column no CTA writes shows
    stages = cuda_gf_pipe.STAGES
    for r0, r1, j0, j1 in cuda_gf_pipe.blocks(r, n):
        rb, nb = r1 - r0, j1 - j0
        op = cuda_gf_pipe.operand(bits[8 * r0:8 * r1, 8 * j0:8 * j1])
        passes, groups, rows = op.shape[:3]
        kt = cuda_gf_pipe.pick_tile(rb, nb, k, tile_k)
        assert kt % cuda_gf_pipe.TILE_QUANTUM == 0
        assert cuda_gf_pipe.smem_bytes(rb, nb, kt) <= H100_SMEM_OPTIN
        src0, dst0 = base_in + j0 * k, base_out + r0 * k
        aligned = cuda_gf_pipe.align_of(k, src0, dst0) == 16
        nctas = min(cuda_gf_pipe.items(b, k, kt), ctas)
        for x in range(nctas):
            walk = cuda_gf_pipe.cta_items(b, k, kt, nctas, x)
            ring = np.full((stages, 4 * groups, kt + cuda_gf_pipe.ROW_PAD + 8), 0xEE, np.uint8)
            oslots = np.full((2, rb, kt + cuda_gf_pipe.OUT_ROW_PAD), 0x5A, np.uint8)

            def offset(s, j):  # row j's global address mod 16 (columns start at multiples of 16)
                return (src0 + s * n * k + j * k) % 16

            def produce(it, slot):
                s, c0, ln = walk[it]
                for j in range(nb):
                    pa = src0 + s * n * k + j * k + c0
                    o = pa % 16
                    assert o == offset(s, j) and (o == 0 or not aligned)
                    a = min(-(-pa // 16) * 16, pa + ln)
                    z = max(a, (pa + ln) // 16 * 16)
                    assert a - pa < 16 and pa + ln - z < 16 and (a % 16 == 0 or a == pa + ln)
                    if z > a:  # the bulk copy's rules: 16-byte aligned at both ends
                        assert a % 16 == 0 and (z - a) % 16 == 0 and (o + (a - pa)) % 16 == 0
                    ring[slot, j, o:o + ln] = data[s, j0 + j, c0:c0 + ln]

            def consume(it, slot):
                s, c0, ln = walk[it]
                osl = oslots[it & 1]
                for cc in range(0, ln, WARP_COLS):  # every warp's 32-column chunks of the tile
                    cols = cc + 4 * LANE_G
                    for p_ in range(passes):
                        acc = np.zeros((2, rows, 32, 4), np.int64)
                        for jg in range(groups):
                            rw = np.stack([stage_words(ring[slot, 4 * jg + q], offset(s, 4 * jg + q), cols)
                                           for q in range(4)])
                            acc = group_pass(acc, rw, op, p_, jg)
                        packed = pack_word(acc)
                        for lane in range(32):  # the storing lanes: t % (4/R) == 0
                            row, c = rows * p_ + LANE_T[lane] * rows // 4, int(cols[lane])
                            if LANE_T[lane] % (4 // rows) or row >= rb:
                                continue
                            m = min(4, ln - c)  # the lane's bytes inside the tile
                            if m <= 0:
                                continue
                            v = np.array([packed[lane]], "<u4").view(np.uint8)[:m]
                            if j0 > 0:  # column blocks after the first accumulate
                                v = v ^ out[s, r0 + row, c0 + c:c0 + c + m]
                            if aligned:
                                osl[row, c:c + m] = v
                            else:
                                out[s, r0 + row, c0 + c:c0 + c + m] = v
                if aligned:  # each warp's bulk stores of its columns, row by row
                    for w in range(cuda_gf_pipe.CONSUMER_WARPS):
                        cb = w * kt // cuda_gf_pipe.CONSUMER_WARPS
                        ce = min(cb + kt // cuda_gf_pipe.CONSUMER_WARPS, ln)
                        if ce > cb:
                            assert (ce - cb) % 16 == 0 and (dst0 + s * r * k + c0 + cb) % 16 == 0
                            out[s, r0:r1, c0 + cb:c0 + ce] = osl[:, cb:ce]

            total = len(walk)
            for it in range(min(stages, total)):  # the producer runs ahead by the ring's depth
                produce(it, it % stages)
            if static_slots:  # the loop unrolled over the ring: slot u of each round
                for base in range(0, total, stages):
                    for u in range(stages):
                        if base + u < total:
                            consume(base + u, u)
                            if base + u + stages < total:
                                produce(base + u + stages, u)
            else:
                for it in range(total):
                    consume(it, it % stages)
                    if it + stages < total:
                        produce(it + stages, it % stages)
    return out.reshape(*lead, r, k)


def jax_pipe(mat_bits, data, static):
    return np.asarray(pallas_gf_pipe.gf_matmul_bytes_pipelined(
        np.asarray(mat_bits, np.int8), data, tile_k=128, interpret=True, static_slots=static))


# -- the emulated kernel against the JAX interpret-mode kernel --------------------


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("k", [128, 256, 384, 511, 512, 513, 640, 768, 1280, 300, 1, 15, 17,
                               1023, 1024, 1025])
def test_tile_walk_matches_jax_pipelined_kernel(rng, k, static):
    """tile_k=256: 1, 2, 3 and 5 tiles per stripe, k under one tile and
    unaligned k; one CTA walking every item through the ring (it wraps
    around the three stages) and the H100's full persistent grid."""
    ker = rs.get_kernel(6, 3, "cpu")
    data = rng.integers(0, 256, (2, 6, k), dtype=np.uint8)
    want = jax_pipe(ker.parity_bits, data, static)
    for ctas in (1, RESIDENT):
        got = emulate(ker.parity_bits, data, tile_k=256, ctas=ctas, static_slots=static)
        np.testing.assert_array_equal(got, want, err_msg=f"k={k} ctas={ctas}")


@pytest.mark.parametrize("static", [False, True])
def test_tile_walk_group_stacked_matrix(rng, static):
    """A block-diagonal kron(I_g, M) matrix runs through unchanged."""
    ker = rs.get_kernel(4, 2, "cpu")
    b, g, n, k = 4, 2, 4, 384
    host = rng.integers(0, 256, (b, n, k), dtype=np.uint8)
    mat_s = np.kron(np.eye(g, dtype=np.int8), rs.to_numpy(ker.parity_bits))
    stacked = host.reshape(b // g, g * n, k)
    want = jax_pipe(mat_s, stacked, static)
    got = emulate(mat_s, stacked, tile_k=256, ctas=1, static_slots=static)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got.reshape(b, 2, k), rs.gf_matmul_bytes(ker.parity_bits, torch.from_numpy(host)).numpy())


@pytest.mark.parametrize("base_in,base_out", [(0, 0), (4, 0), (1, 3), (0, 12)])
def test_tile_walk_alignment_choice(rng, base_in, base_out):
    """Row bases off 16 bytes put each row at its own offset in the stage
    (ragged ends bytewise, the interior by bulk copy) and store from
    registers; the result does not change."""
    ker = rs.get_kernel(3, 2, "cpu")
    data = rng.integers(0, 256, (1, 3, 1024), dtype=np.uint8)
    want = jax_pipe(ker.parity_bits, data, False)
    got = emulate(ker.parity_bits, data, tile_k=256, ctas=1, base_in=base_in, base_out=base_out)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("static", [False, True])
def test_tile_walk_non_expansion_matrix(rng, static):
    """Like the TPU kernel, B2 takes any GF(2) matrix, not only the expansion
    of a GF(2^8) one (so does B1: tests/test_torch_gf_tables.py)."""
    bits = rng.integers(0, 2, (8 * 5, 8 * 7), dtype=np.int8)
    with pytest.raises(ValueError):
        cuda_gf.coefficients(bits)
    data = rng.integers(0, 256, (2, 7, 700), dtype=np.uint8)
    want = jax_pipe(bits, data, static)
    np.testing.assert_array_equal(emulate(bits, data, tile_k=256, ctas=3, static_slots=static), want)
    np.testing.assert_array_equal(
        want, rs.gf_matmul_bytes(bits, torch.from_numpy(data)).numpy())


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("r", [1, 2])
def test_tile_walk_few_outputs(rng, r, static):
    """Repairs and degraded windows (r = 1, 2): R = r rows per pass, the
    lanes of a quad completing each byte with xor-shuffles."""
    coef = rng.integers(0, 256, (r, 12), dtype=np.uint8)
    bits = bitmatrix.expand_matrix(coef).astype(np.int8)
    data = rng.integers(0, 256, (3, 12, 700), dtype=np.uint8)
    want = jax_pipe(bits, data, static)
    np.testing.assert_array_equal(emulate(bits, data, tile_k=256, ctas=4, static_slots=static,
                                          base_in=1), want)
    np.testing.assert_array_equal(want[2], gf256.gf_matmul(coef, data[2]))


@pytest.mark.parametrize("r,n,k", [(30, 30, 300), (22, 16, 600), (15, 30, 257)])
def test_tile_walk_wide_matrices(rng, r, n, k):
    """The RG6P6 (30 x 30, decode 15 x 30) and LRC (22 x 16) shapes: several
    passes of 4 output rows, B read from shared memory per group."""
    coef = rng.integers(0, 256, (r, n), dtype=np.uint8)
    bits = bitmatrix.expand_matrix(coef).astype(np.int8)
    data = rng.integers(0, 256, (2, n, k), dtype=np.uint8)
    want = jax_pipe(bits, data, False)
    np.testing.assert_array_equal(emulate(bits, data, ctas=5), want)
    np.testing.assert_array_equal(want[1], gf256.gf_matmul(coef, data[1]))


def test_tile_walk_column_blocks_accumulate(rng):
    """Past MAX_INPUTS inputs B2's plan splits into column blocks that
    XOR-accumulate into the output (the kernel's accumulate flag)."""
    coef = rng.integers(0, 256, (2, 1600), dtype=np.uint8)
    bits = bitmatrix.expand_matrix(coef).astype(np.int8)
    data = rng.integers(0, 256, (1, 1600, 200), dtype=np.uint8)
    step = cuda_gf_pipe.MAX_INPUTS
    assert [(j0, j1) for _, _, j0, j1 in cuda_gf_pipe.blocks(2, 1600)] == [
        (j, min(1600, j + step)) for j in range(0, 1600, step)]
    got = emulate(bits, data, ctas=1)
    np.testing.assert_array_equal(got, np.asarray(j_rs.gf_matmul_bytes(bits, data)))
    np.testing.assert_array_equal(got[0], gf256.gf_matmul(coef, data[0]))


def test_tile_walk_row_blocks_past_the_operand_budget(rng):
    """Past OPERAND_BUDGET bytes of B fragments the plan splits the rows into
    blocks of a multiple of 4 rows; each block writes its own rows."""
    r, n = 70, 20
    blocks = cuda_gf_pipe.blocks(r, n)
    rb = blocks[0][1] - blocks[0][0]
    assert len(blocks) > 1 and rb % 4 == 0
    assert all((j0, j1) == (0, n) for _, _, j0, j1 in blocks)
    assert rb * -(-n // 4) * cuda_gf_pipe.FRAG_BYTES <= cuda_gf_pipe.OPERAND_BUDGET
    coef = rng.integers(0, 256, (r, n), dtype=np.uint8)
    data = rng.integers(0, 256, (1, n, 100), dtype=np.uint8)
    got = emulate(bitmatrix.expand_matrix(coef), data, ctas=2, base_in=4)
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
    """Every block fits the H100's shared memory; the persistent grid takes
    min(items, resident CTAs) and deals the items out within one of each
    other, every item once."""
    for r0, r1, j0, j1 in cuda_gf_pipe.blocks(r, n):
        kt = cuda_gf_pipe.pick_tile(r1 - r0, j1 - j0, k)
        assert kt % cuda_gf_pipe.TILE_QUANTUM == 0 and kt <= cuda_gf_pipe.MAX_TILE
        smem = cuda_gf_pipe.smem_bytes(r1 - r0, j1 - j0, kt)
        assert smem <= H100_SMEM_OPTIN
        assert smem <= cuda_gf_pipe.SMEM_TARGET or kt == cuda_gf_pipe.TILE_QUANTUM
        n_items = cuda_gf_pipe.items(b, k, kt)
        ctas = min(n_items, RESIDENT)
        walks = [cuda_gf_pipe.cta_items(b, k, kt, ctas, x) for x in range(ctas)]
        lens = [len(w) for w in walks]
        assert max(lens) - min(lens) <= 1 and sum(lens) == n_items
        assert sum(ln for w in walks for _, _, ln in w) == b * k


def test_align_and_tile_choice():
    assert cuda_gf_pipe.align_of(1 << 20, 0, 256) == 16
    assert cuda_gf_pipe.align_of(1 << 20, 4, 256) == 1
    assert cuda_gf_pipe.align_of(699_051, 0, 0) == 1
    assert cuda_gf_pipe.align_of(279_620, 0, 0) == 1
    assert cuda_gf_pipe.pick_tile(3, 6, 1) == cuda_gf_pipe.TILE_QUANTUM
    assert cuda_gf_pipe.pick_tile(4, 12, 1 << 20) == 2048
    assert cuda_gf_pipe.pick_tile(3, 6, 100_000, tile_k=512) == 512
    for bad in (0, 100, -256, 128):
        with pytest.raises(ValueError):
            cuda_gf_pipe.pick_tile(3, 6, 1000, tile_k=bad)


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
