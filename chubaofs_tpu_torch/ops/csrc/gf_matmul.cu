// GF(2^8) matrix product for Hopper (sm_90a): out[s] = M (x) data[s] per stripe s,
// for any byte-major (8r, 8n) GF(2) bit matrix M.
//
// Replaces the TPU kernel chubaofs_tpu/ops/pallas_gf.py::_gf_kernel (driven by
// gf_matmul_bytes_fused). That kernel unpacks each byte tile into 8 bit-planes
// in VMEM, multiplies them by the (8r, 8n) GF(2) bit matrix on the MXU in int8
// and packs the parity bits back to bytes. This kernel computes the same
// function, out[s, i, x] = XOR_j L_ij(data[s, j, x]) with L_ij the GF(2)-linear
// byte map of the bit matrix's 8x8 block (i, j), without bit planes: the
// vpshufb scheme of klauspost/reedsolomon and ISA-L, with the tables in
// registers and the lookups done by `prmt`, four bytes per instruction.
//
// The arithmetic. L is linear over GF(2), so a byte x = x[0:3) ^ x[3:6) ^ x[6:8)
// maps to L(x) = T0[x & 7] ^ T1[(x >> 3) & 7] ^ T2[x >> 6], with
// T0[v] = L(v), T1[v] = L(v << 3) (v < 8) and T2[v] = L(v << 6) (v < 4). The
// host builds the three tables of every block (ops/cuda_gf.py::split_tables):
// T0 and T1 are 8 bytes, two registers each, T2 4 bytes. prmt.b32 d, a, b, c
// picks, for each byte of d, one of the 8 bytes {a, b} by a 3-bit index in a
// nibble of c (bit 3 of the nibble would replicate the picked byte's sign
// bit, so every field is masked to its width before it is placed). For two
// input words x and y the selector t = f(x) | f(y) << 4, with f(w) =
// (w >> s) & m per field, holds the fields of bytes (x0, y0, x1, y1) in its
// low 16 bits and of (x2, y2, x3, y3) in its high 16 bits, so
// prmt(Ta, Tb, t) and prmt(Ta, Tb, t >> 16) look up 8 bytes. Per output row
// the two words are XOR-accumulated over the n inputs in an interleaved
// order; after the last input prmt(A, B, 0x6420) and prmt(A, B, 0x7531) give
// x's and y's output words back. The selectors depend only on the input, so
// they are built once per input row and serve every output row of the pass;
// the tables come from shared memory once per (output row, input row) per
// lane chunk, a broadcast read (all lanes read one address).
//
// Bound on this card (H100 SXM, 3.35 TB/s HBM): each input byte read once and
// each output byte written once, (n + r) * k bytes per stripe: 16 EC(12,4)
// 8 MiB stripes padded to the 1 MiB bucket move 268 MB, 80 us. The integer
// floor of this design: per 8 bytes of one input row about 15 ops for the six
// selectors, and per output row 6 prmt and 4 lop3; at r = 4 that is about
// 1.6 ops per (output row, input row, byte) product, 1.3 G ops for the main
// path, about 90 us at 64 integer lanes per SM per clock (132 SMs, 1.755 GHz).
// So the two floors are close, and the design keeps both lean:
//   * one pass over HBM: a lane owns a 32-byte column chunk (two 128-bit loads
//     per input row), keeps up to kRowTile output rows of it in registers
//     while it walks the n inputs, and loads input row j+1 before it computes
//     row j. Matrices with more than kRowTile rows re-walk the inputs per row
//     tile; those re-reads hit L1/L2.
//   * no shared-memory load per product and no bit-plane tensor anywhere.
//   * the matrix is runtime data: tables (r * n * 32 bytes) are staged into
//     shared memory once per block, so one compiled kernel serves every
//     encode, repair, window, LRC and product-matrix matrix, and any GF(2)
//     matrix the TPU kernel takes.
//   * persistent warps: the grid is what the occupancy query says fits, and
//     each warp walks (stripe, 1 KiB column range) items in a grid stride.
//   * unaligned rows (k not a multiple of 16, or a base off 16 bytes; every
//     row then sits at its own offset o mod 16, uniform across the warp):
//     a lane reads its chunk as three aligned 16-byte vectors from column
//     c - o and funnel-shifts the bytes into place; it stores aligned
//     16-byte blocks of the output row, taking the block's first bytes from
//     its left neighbour with __shfl_up_sync. Work items overlap by one lane
//     (its chunk is computed twice, 1/32 more work), so no block straddles
//     two warps, and only a row's two ragged ends (< 16 bytes) go bytewise.
//     Nothing is padded or sliced, and nothing outside the tensors is read.
//
// Interface: plain C, loaded with ctypes. The launch runs on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;              // bytes of one row per lane
constexpr int kWords = kChunk / 4;      // 8: four (x, y) word pairs
constexpr int kWarpCols = 32 * kChunk;  // columns of one work item
// items start every kWarpCols columns in the aligned kernel; in the unaligned
// one they overlap by one lane, whose chunk the next item recomputes only to
// hand its words to its lane 1, so no 16-byte block straddles two items
template <bool kAligned>
constexpr int kItemStride = kAligned ? kWarpCols : kWarpCols - kChunk;
constexpr int kTabBytes = 32;  // per block: T0 8 B, T1 8 B, T2 4 B, 12 B padding
constexpr int kMaxSmem = 48 * 1024;  // tables per launch; the wrapper splits larger matrices

// the three fields of a byte, bits [0, 3), [3, 6), [6, 8), as (shift, mask)
constexpr uint32_t kMask3 = 0x07070707u;
constexpr uint32_t kMask2 = 0x03030303u;
// bytes (x0, y0, x1, y1 | x2, y2, x3, y3) of the accumulators back to x, y
constexpr uint32_t kUnpermX = 0x6420u;
constexpr uint32_t kUnpermY = 0x7531u;

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint4 ldg16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void put4(uint32_t* w, const uint4 v) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// out[q] = bytes [o + 4q, o + 4q + 4) of the 12 words u, for a byte offset o
// in [0, 16): two word selects by the bits of o >> 2, then a funnel shift.
// No branch, so the loop stays one straight body whatever each row's offset.
__device__ __forceinline__ void shift_bytes(const uint32_t u[12], uint32_t o, uint32_t out[kWords]) {
  const bool two = o & 8u, one = o & 4u;
  uint32_t a[10], b[9];
#pragma unroll
  for (int q = 0; q < 10; ++q) a[q] = two ? u[q + 2] : u[q];
#pragma unroll
  for (int q = 0; q < 9; ++q) b[q] = one ? a[q + 1] : a[q];
  const uint32_t sh = 8u * (o & 3u);
#pragma unroll
  for (int q = 0; q < kWords; ++q) out[q] = __funnelshift_r(b[q], b[q + 1], sh);
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
}

// One lane's 32-byte chunk of one row: the loads are issued (issue) one row
// ahead of their use (finish). Aligned kernels read two vectors at column c;
// unaligned ones three from column c - o, or, at a row's ragged ends, bytes.
template <bool kAligned>
struct RowChunk {
  uint4 v[kAligned ? 2 : 3];

  // whether this lane reads the row through aligned vectors
  __device__ __forceinline__ static bool vectors(long long c, uint32_t o, long long k) {
    if constexpr (kAligned) return true;
    return o == 0 ? c + kChunk <= k : (c >= kChunk && c - o + kChunk + 16 <= k);
  }

  __device__ __forceinline__ void issue(const uint8_t* row, long long c, uint32_t o, long long k) {
    if constexpr (kAligned) {  // k % 16 == 0: a vector is wholly inside the row or wholly past it
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        v[m] = c + 16 * m < k ? ldg16(row + c + 16 * m) : make_uint4(0, 0, 0, 0);
      }
    } else if (vectors(c, o, k)) {
      const uint8_t* p = row + c - o;
      v[0] = ldg16(p);
      v[1] = ldg16(p + 16);
      v[2] = o ? ldg16(p + 32) : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void finish(const uint8_t* row, long long c, uint32_t o, long long k,
                                         uint32_t w[kWords]) const {
    if constexpr (kAligned) {
      put4(w, v[0]);
      put4(w + 4, v[1]);
    } else if (vectors(c, o, k)) {
      uint32_t u[12];
      put4(u, v[0]);
      put4(u + 4, v[1]);
      put4(u + 8, v[2]);
      shift_bytes(u, o, w);
    } else {
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        uint32_t x = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long col = c + 4 * q + e;
          if (col < k) x |= static_cast<uint32_t>(row[col]) << (8 * e);
        }
        w[q] = x;
      }
    }
  }
};

// bytes [lo, hi) of the 16 bytes w that belong at row[start ...]
__device__ __forceinline__ void store_bytes(uint8_t* row, long long start, const uint32_t* w,
                                            long long lo, long long hi) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const long long col = start + i;
    if (col >= lo && col < hi) row[col] = static_cast<uint8_t>(byte_of(w, i));
  }
}

__device__ __forceinline__ void store16(uint8_t* p, const uint32_t* w) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Store one lane's 32 output bytes w (columns c..c+31) into a row at offset oo
// mod 16. Every lane of the warp calls it (the unaligned kernel shuffles).
// first / last: the item is its stripe's first / last.
template <bool kAligned>
__device__ __forceinline__ void store_chunk(uint8_t* row, long long c, uint32_t oo, long long k,
                                            int lane, bool first, bool last,
                                            const uint32_t w[kWords]) {
  if constexpr (kAligned) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (c + 16 * m < k) store16(row + c + 16 * m, w + 4 * m);
    }
    return;
  } else {
    // the left neighbour's last 16 bytes (lane 0 gets its own, and ignores them)
    uint32_t u[12];
#pragma unroll
    for (int q = 0; q < 4; ++q) u[q] = __shfl_up_sync(0xFFFFFFFFu, w[4 + q], 1);
#pragma unroll
    for (int q = 0; q < kWords; ++q) u[4 + q] = w[q];
    // lane 0 of a later item repeats the last lane of the item before, which
    // stores those columns
    if (lane == 0 && !first) return;
    if (oo == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const long long start = c + 16 * m;
        if (start + 16 <= k) {
          store16(row + start, w + 4 * m);
        } else {
          store_bytes(row, start, w + 4 * m, 0, k);
        }
      }
      return;
    }
    // the aligned blocks at columns c - oo and c - oo + 16: bytes 16 - oo ... of u
    uint32_t blk[kWords];
    shift_bytes(u, 16u - oo, blk);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const long long start = c - oo + 16 * m;
      if (m == 0 && lane == 0) {  // the row's first block: no left neighbour, own bytes only
        store_bytes(row, start, blk, c, k);
      } else if (start >= 0 && start + 16 <= k) {
        store16(row + start, blk + 4 * m);
      } else {
        store_bytes(row, start, blk + 4 * m, 0, k);
      }
    }
    if (lane == 31 && last) {  // the row's last piece, past the last block
      store_bytes(row, c + 16, w + 4, c + kChunk - oo, k);
    }
  }
}

__device__ __forceinline__ uint32_t offset16(const uint8_t* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p) & 15u);
}

// One work item: the lane's 32 columns from column c of every output row of
// one stripe (src: its n input rows, dst: its r output rows).
template <bool kAligned, int kRowTile>
__device__ __forceinline__ void run_item(const uint8_t* src, uint8_t* dst, const uint8_t* s_tab,
                                         int n, int r, long long k, long long c, int lane,
                                         bool first, bool last, int accumulate) {
  using Chunk = RowChunk<kAligned>;
  for (int r0 = 0; r0 < r; r0 += kRowTile) {
    uint32_t acc[kRowTile][kWords];
#pragma unroll
    for (int rr = 0; rr < kRowTile; ++rr) {
#pragma unroll
      for (int q = 0; q < kWords; ++q) acc[rr][q] = 0u;
    }
    Chunk cur;
    cur.issue(src, c, offset16(src), k);
    for (int j = 0; j < n; ++j) {
      const uint8_t* row = src + static_cast<long long>(j) * k;
      const uint32_t o = offset16(row);
      uint32_t w[kWords];
      cur.finish(row, c, o, k, w);
      if (j + 1 < n) cur.issue(row + k, c, offset16(row + k), k);
      // the six selectors of each (x, y) pair: fields 0, 1, 2, low and high halves
      uint32_t sel[kWords / 2][6];
#pragma unroll
      for (int p = 0; p < kWords / 2; ++p) {
        const uint32_t x = w[2 * p], y = w[2 * p + 1];
        const uint32_t t0 = (x & kMask3) | ((y & kMask3) << 4);
        const uint32_t t1 = ((x >> 3) & kMask3) | (((y >> 3) & kMask3) << 4);
        const uint32_t t2 = ((x >> 6) & kMask2) | (((y >> 6) & kMask2) << 4);
        sel[p][0] = t0;
        sel[p][1] = t0 >> 16;
        sel[p][2] = t1;
        sel[p][3] = t1 >> 16;
        sel[p][4] = t2;
        sel[p][5] = t2 >> 16;
      }
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) {
        if (r0 + rr < r) {  // uniform across the block
          const uint8_t* t = s_tab + ((r0 + rr) * n + j) * kTabBytes;
          const uint4 t01 = *reinterpret_cast<const uint4*>(t);
          const uint32_t t2 = *reinterpret_cast<const uint32_t*>(t + 16);
#pragma unroll
          for (int p = 0; p < kWords / 2; ++p) {  // ptxas folds each line into two lop3
            acc[rr][2 * p] ^= prmt(t01.x, t01.y, sel[p][0]) ^ prmt(t01.z, t01.w, sel[p][2]) ^
                              prmt(t2, 0u, sel[p][4]);
            acc[rr][2 * p + 1] ^= prmt(t01.x, t01.y, sel[p][1]) ^ prmt(t01.z, t01.w, sel[p][3]) ^
                                  prmt(t2, 0u, sel[p][5]);
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowTile; ++rr) {
      if (r0 + rr < r) {
        uint32_t res[kWords];
#pragma unroll
        for (int p = 0; p < kWords / 2; ++p) {
          res[2 * p] = prmt(acc[rr][2 * p], acc[rr][2 * p + 1], kUnpermX);
          res[2 * p + 1] = prmt(acc[rr][2 * p], acc[rr][2 * p + 1], kUnpermY);
        }
        uint8_t* o_row = dst + static_cast<long long>(r0 + rr) * k;
        const uint32_t oo = offset16(o_row);
        if (accumulate) {
          Chunk prev;
          uint32_t pw[kWords];
          prev.issue(o_row, c, oo, k);
          prev.finish(o_row, c, oo, k, pw);
#pragma unroll
          for (int q = 0; q < kWords; ++q) res[q] ^= pw[q];
        }
        store_chunk<kAligned>(o_row, c, oo, k, lane, first, last, res);
      }
    }
  }
}

// work items per stripe: enough that their stores cover [0, k)
template <bool kAligned>
__host__ __device__ __forceinline__ long long items_per_stripe(long long k) {
  if (kAligned || k <= kWarpCols) return (k + kWarpCols - 1) / kWarpCols;
  return (k - kChunk + kItemStride<kAligned> - 1) / kItemStride<kAligned>;
}

// data: (batch, n, k) rows at data + s * data_bstride + j * k
// out:  (batch, r, k) rows at out + s * out_bstride + i * k
// tables: (r, n, 32) split tables of the (r, n) blocks of the bit matrix
// accumulate: out ^= product (column blocks after the first, see cuda_gf.py)
template <bool kAligned, int kRowTile>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                 const uint8_t* __restrict__ tables, long long batch, int n, int r,
                 long long k, long long data_bstride, long long out_bstride,
                 int accumulate) {
  extern __shared__ __align__(16) uint8_t s_tab[];
  const int tab_bytes = r * n * kTabBytes;  // a multiple of 32
  for (int i = threadIdx.x * 16; i < tab_bytes; i += kThreads * 16) {
    *reinterpret_cast<uint4*>(s_tab + i) = ldg16(tables + i);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long per_stripe = items_per_stripe<kAligned>(k);
  const long long items = batch * per_stripe;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long it = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       it < items; it += nwarps) {  // uniform across the warp
    const long long s = it / per_stripe;
    const long long item = it - s * per_stripe;
    const long long base = item * kItemStride<kAligned>;
    const long long c = base + lane * kChunk;
    const uint8_t* src = data + s * data_bstride;
    uint8_t* dst = out + s * out_bstride;
    run_item<kAligned, kRowTile>(src, dst, s_tab, n, r, k, c, lane, item == 0,
                                 item == per_stripe - 1, accumulate);
  }
}

template <bool kAligned, int kRowTile>
cudaError_t launch(const uint8_t* d, uint8_t* o, const uint8_t* t, long long batch, int n, int r,
                   long long k, long long data_bstride, long long out_bstride, int accumulate,
                   size_t smem, cudaStream_t st) {
  auto kernel = gf_matmul_kernel<kAligned, kRowTile>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  // persistent blocks: as many as fit at once, fewer if there are fewer items
  const long long items = batch * items_per_stripe<kAligned>(k);
  long long grid = (items + kWarps - 1) / kWarps;
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > resident) grid = resident;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, st>>>(d, o, t, batch, n, r, k, data_bstride,
                                                              out_bstride, accumulate);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gf_matmul_launch(const void* data, void* out, const void* tables,
                                long long batch, int n, int r, long long k,
                                long long data_bstride, long long out_bstride,
                                int accumulate, int aligned, int row_tile, void* stream) {
  if (batch <= 0 || n <= 0 || r <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  const long long smem = static_cast<long long>(r) * n * kTabBytes;
  if (smem > kMaxSmem || (row_tile != 4 && row_tile != 8)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  const uint8_t* t = static_cast<const uint8_t*>(tables);
  const size_t sm = static_cast<size_t>(smem);
  cudaError_t err;
  if (aligned) {
    err = row_tile == 4 ? launch<true, 4>(d, o, t, batch, n, r, k, data_bstride, out_bstride, accumulate, sm, st)
                        : launch<true, 8>(d, o, t, batch, n, r, k, data_bstride, out_bstride, accumulate, sm, st);
  } else {
    err = row_tile == 4 ? launch<false, 4>(d, o, t, batch, n, r, k, data_bstride, out_bstride, accumulate, sm, st)
                        : launch<false, 8>(d, o, t, batch, n, r, k, data_bstride, out_bstride, accumulate, sm, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* gf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
