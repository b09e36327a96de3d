// GF(2) bit-matrix products on Hopper's tensor cores: the arithmetic core of
// the port's GF(2^8) kernels.
//
// A GF(2^8) matrix product is the GF(2) product of its byte-major (8r, 8n) bit
// matrix with the data's bit planes (ops/bitmatrix.py):
//
//     out bit b of row i = XOR over (j, p) of M_bits[8i + b, 8j + p] & bit p of data[j]
//
// The sum runs here as an int8 MMA with s32 accumulators, and its parity is
// the bit, as the TPU kernels run it on their matrix unit. One
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 covers
//
//     M = 16 data columns (bytes x),
//     K = 32 = 8 bit planes x a group of 4 input rows, k = 4 * plane + row_in_group,
//     N = 8 = 8/R bits of each of the R output rows of a pass (R = 4, 2 or 1
//         rows per pass, R MMAs per pass): MMA p takes bits p * 8/R ..
//         (p + 1) * 8/R - 1, n = (8/R) * row_in_pass + bit % (8/R).
//
// Fragment layouts of that instruction (PTX ISA, "Matrix Fragments for
// mma.m16n8k32" with .s8; CUTLASS SM80_16x8x32_S32S8S8S32_TN: ALayout
// ((4,8),(4,2,2)):((64,1),(16,8,256)), BLayout ((4,8),(4,2)):((32,1),(8,128)),
// CLayout SM80_16x8_Row ((4,8),(2,2)):((32,1),(16,8))). Lane = 4 * g + t
// (g = lane >> 2, t = lane & 3); byte q of a 32-bit register holds k = 4t + q:
//
//     A (16 x 32, row): a0 = row g,     k = 4t + q        a1 = row g + 8, k = 4t + q
//                       a2 = row g,     k = 16 + 4t + q   a3 = row g + 8, k = 16 + 4t + q
//     B (32 x 8, col):  b0 = col g,     k = 4t + q        b1 = col g,     k = 16 + 4t + q
//     C (16 x 8):       c0, c1 = row g, cols 2t, 2t + 1   c2, c3 = row g + 8, cols 2t, 2t + 1
//
// So with k = 4 * plane + row: a0 holds plane t of the 4 input rows, a2 plane
// t + 4. Given W = the 4 rows' bytes at one column (byte q = row q), the low
// bit of byte q of W >> t is bit t of row q: a0 = W >> t and a2 = W >> (t + 4),
// with no mask (only the low bit of an A byte matters; see the B operand
// below). Lane (g, t) receives in c0..c3 the columns n = 2t, 2t + 1: row
// t * R / 4 of the pass. With R = 4 it holds, over the pass's four MMAs,
// whole bytes of output row t, and the pack needs no shuffles; with R = 2
// (1) two (four) lanes of a quad share a row and complete its bytes with one
// (two) xor-shuffles. R = r for r <= 2 and 4 otherwise: a pass never
// computes more than 4 - r idle rows.
//
// Columns. A warp works on 32 columns at a time, two M tiles. Lane (g, t)
// owns columns 4g .. 4g + 3 of the 32: it reads 4 bytes of each input row
// and, if t % (4/R) == 0, writes 4 bytes of output row t * R / 4 of each
// pass. M tile m maps its row g to column 4g + m and its row g + 8 to column
// 4g + 2 + m.
//
// B operand ("fragment order", built by ops/cuda_gf_pipe.py::operand): per
// (pass P of R output rows, input group jg, MMA p), 32 lanes x (b0, b1), 256
// bytes; 64 bytes per coefficient, rows padded to a multiple of R and inputs
// to a multiple of 4 with zeros. Lane (g, t) holds column n = g: output row
// RP + g / (8/R), output bit b = p * 8/R + g % (8/R), scaled by 2^b:
//
//     op[P][jg][p][lane][h][q] = M_bits[8(RP + g / (8/R)) + b, 8(4jg + q) + t + 4h] << b
//
// (as an s8, 1 << 7 is -128). The accumulator of output bit b is then 2^b
// times sum_k A_k B'_k, modulo 2^32, where B' is the unscaled bit: zeros below
// bit b, and at bit b the parity of sum_k (A_k mod 2) B'_k. So only the low
// bit of each A byte counts (the bits above it land above bit b), and the 8
// accumulators of a byte merge with 7 bit selects and no shifts.
//
// Any (8r, 8n) GF(2) matrix works, not only the expansion of a GF(2^8) one.

#pragma once

#include <cstdint>

namespace gfmma {

constexpr int kColsPerWarp = 32;  // 2 M tiles of 16 columns
constexpr int kMaxRowsPerPass = 4;  // R: output rows of the R MMAs of a pass
constexpr int kFragBytes = 256;   // B fragments of one MMA: 32 lanes x 8 bytes

// acc += A * B on the tensor cores (s8 x s8 -> s32, wrapping).
__device__ __forceinline__ void mma_s8(int acc[4], const uint32_t a[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// 4 x 4 byte transpose: w[c] byte q = byte c of r[q]. Six byte permutes.
__device__ __forceinline__ void transpose4(const uint32_t r[4], uint32_t w[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);  // r2.b0 r3.b0 r2.b1 r3.b1
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);  // r2.b2 r3.b2 r2.b3 r3.b3
  w[0] = __byte_perm(t0, t1, 0x5410);
  w[1] = __byte_perm(t0, t1, 0x7632);
  w[2] = __byte_perm(t2, t3, 0x5410);
  w[3] = __byte_perm(t2, t3, 0x7632);
}

// The A fragments of the two M tiles of one input group, from the lane's
// words: r[q] = bytes of input row q of the group at columns 4g .. 4g + 3.
__device__ __forceinline__ void a_frags(const uint32_t r[4], int t, uint32_t a[2][4]) {
  uint32_t w[4];
  transpose4(r, w);
#pragma unroll
  for (int m = 0; m < 2; ++m) {  // low bit of each byte: planes t and t + 4
    a[m][0] = w[m] >> t;
    a[m][1] = w[m + 2] >> t;
    a[m][2] = w[m] >> (t + 4);
    a[m][3] = w[m + 2] >> (t + 4);
  }
}

// bits [0, b) of x, the rest of y
__device__ __forceinline__ uint32_t select_low(uint32_t x, uint32_t y, int b) {
  const uint32_t mask = (1u << b) - 1u;
  return (x & mask) | (y & ~mask);
}

// One output byte in bits 0..7 (garbage above; with R < 4 only the lane's
// own bits are right) from the accumulators of its bits: acc[p][e0 + e] holds
// bit p * 8/R + base + e at that bit, base = 2t % (8/R).
template <int kR>
__device__ __forceinline__ uint32_t merge_byte(const int acc[kR][4], int e0, int base) {
  constexpr int kBits = 8 / kR;  // bits of a row per MMA
  uint32_t x = static_cast<uint32_t>(acc[0][e0]);
#pragma unroll
  for (int i = 1; i < 2 * kR; ++i) {
    const int p = i >> 1, e = i & 1;
    x = select_low(x, static_cast<uint32_t>(acc[p][e0 + e]), p * kBits + base + e);
  }
  return x;
}

// The 4 output bytes of columns 4g .. 4g + 3 of output row t * R / 4 of the
// pass, from the accumulators acc[m][p][0..3] of the two M tiles and R MMAs.
// Every lane must call it (the quad's shuffles); lanes with t % (4/R) == 0
// store the word.
template <int kR>
__device__ __forceinline__ uint32_t pack_word(const int acc[2][kR][4], int t) {
  constexpr int kBits = 8 / kR;
  const int base = (2 * t) % kBits;  // 0 for R = 4
  const uint32_t c0 = merge_byte<kR>(acc[0], 0, base);  // column 4g     (M tile 0, row g)
  const uint32_t c1 = merge_byte<kR>(acc[1], 0, base);  // column 4g + 1 (M tile 1, row g)
  const uint32_t c2 = merge_byte<kR>(acc[0], 2, base);  // column 4g + 2 (M tile 0, row g + 8)
  const uint32_t c3 = merge_byte<kR>(acc[1], 2, base);  // column 4g + 3 (M tile 1, row g + 8)
  uint32_t w = __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040), 0x5410);
  if constexpr (kR < kMaxRowsPerPass) {
    uint32_t own = 0u;  // this lane's bits of each byte: bits p * 8/R + base + {0, 1}
#pragma unroll
    for (int p = 0; p < kR; ++p) own |= 3u << (p * kBits + base);
    w &= own * 0x01010101u;
#pragma unroll
    for (int s = 1; s < kMaxRowsPerPass / kR; s <<= 1) w |= __shfl_xor_sync(0xffffffffu, w, s);
  }
  return w;
}

}  // namespace gfmma
