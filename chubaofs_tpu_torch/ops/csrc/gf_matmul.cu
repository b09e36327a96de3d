// GF(2^8) matrix product for Hopper (sm_90a): out[s] = M (x) data[s] per stripe s.
//
// Replaces the TPU kernel chubaofs_tpu/ops/pallas_gf.py::_gf_kernel (driven by
// gf_matmul_bytes_fused). That kernel unpacks each byte tile into 8 bit-planes
// in VMEM, multiplies them by the (8r, 8n) GF(2) bit matrix on the MXU in int8
// and packs the parity bits back to bytes. This kernel computes the same
// function, out[s, i, x] = XOR_j M[i, j] * data[s, j, x] over GF(2^8) (POLY
// 0x11D), without any bit planes: each product is two lookups in per-
// coefficient split-nibble tables (the klauspost/reedsolomon scheme),
//
//     c * x = lo_c[x & 15] ^ hi_c[x >> 4],  lo_c[v] = c * v,  hi_c[v] = c * (v << 4),
//
// XOR-accumulated over the n inputs in registers.
//
// Bound on this card (H100 SXM, 3.35 TB/s HBM): the function is memory-bound.
// It must read every input byte once and write every output byte once,
// (n + r) * k bytes per stripe: 16 EC(12,4) 8 MiB stripes (k = 699,136) move
// 179 MB, about 53 us. The arithmetic, one table multiply-accumulate per
// (output row, input row, byte), sits far below the CUDA cores' rate.
//
// How the design meets that bound:
//   * one pass over HBM: a thread owns a 16-byte column chunk (one 128-bit
//     load per input row) and keeps up to kRowTile output rows of that chunk
//     in registers while it walks the n inputs, so an input byte is fetched
//     from HBM once and an output byte is stored once. Matrices with more
//     than kRowTile rows re-walk the inputs per row tile; those re-reads are
//     of the same chunk and hit L1/L2.
//   * no bit-plane tensor ever exists, in device memory or on chip: the
//     8x expansion the TPU's matmul needed is replaced by table lookups.
//   * the matrix is runtime data: the tables (r * n * 32 bytes) are built by
//     the host wrapper (ops/cuda_gf.py) and staged into shared memory once per
//     block, so one compiled kernel serves every encode, repair, window, LRC
//     and product-matrix matrix. All lanes of a warp read the same 32-byte
//     table (the coefficient is uniform across the warp), 8 words in 8
//     distinct banks, so the lookups are free of bank conflicts.
//   * the k tail is masked in the kernel (byte loads/stores when k is not a
//     multiple of 16 or a base pointer is not 16-byte aligned); nothing is
//     padded and sliced.
//
// Interface: plain C, loaded with ctypes. The launch runs on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 8;     // output rows held in registers per pass
constexpr int kTabBytes = 32;   // per coefficient: 16 low-nibble + 16 high-nibble products
constexpr int kMaxSmem = 48 * 1024;  // tables per launch; the wrapper splits larger matrices

template <bool kAligned>
__device__ __forceinline__ void load16(const uint8_t* p, long long avail, uint32_t w[4]) {
  if (kAligned) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t x = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = q * 4 + e;
        if (i < avail) x |= static_cast<uint32_t>(p[i]) << (8 * e);
      }
      w[q] = x;
    }
  }
}

template <bool kAligned>
__device__ __forceinline__ void store16(uint8_t* p, long long avail, const uint32_t w[4]) {
  if (kAligned) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = q * 4 + e;
        if (i < avail) p[i] = static_cast<uint8_t>(w[q] >> (8 * e));
      }
    }
  }
}

// data: (batch, n, k) rows at data + s * data_bstride + j * k
// out:  (batch, r, k) rows at out + s * out_bstride + i * k
// tables: (r, n, 32) split-nibble products of the (r, n) coefficient block
// accumulate: out ^= product (column blocks after the first, see cuda_gf.py)
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                 const uint8_t* __restrict__ tables, long long batch, int n, int r,
                 long long k, long long data_bstride, long long out_bstride,
                 int accumulate) {
  extern __shared__ __align__(16) uint8_t s_tab[];
  const int tab_bytes = r * n * kTabBytes;  // a multiple of 32
  for (int i = threadIdx.x * 16; i < tab_bytes; i += kThreads * 16) {
    *reinterpret_cast<uint4*>(s_tab + i) = *reinterpret_cast<const uint4*>(tables + i);
  }
  __syncthreads();

  const long long chunks = (k + 15) / 16;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long s = blockIdx.y; s < batch; s += gridDim.y) {
    const uint8_t* src = data + s * data_bstride;
    uint8_t* dst = out + s * out_bstride;
    for (long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
         c < chunks; c += stride) {
      const long long col = c * 16;
      const long long avail = k - col;
      for (int r0 = 0; r0 < r; r0 += kRowTile) {
        uint32_t acc[kRowTile][4];
#pragma unroll
        for (int rr = 0; rr < kRowTile; ++rr) {
          acc[rr][0] = acc[rr][1] = acc[rr][2] = acc[rr][3] = 0u;
        }
        for (int j = 0; j < n; ++j) {
          uint32_t w[4];
          load16<kAligned>(src + static_cast<long long>(j) * k + col, avail, w);
#pragma unroll
          for (int rr = 0; rr < kRowTile; ++rr) {
            if (r0 + rr < r) {  // uniform across the block
              const uint8_t* t = s_tab + ((r0 + rr) * n + j) * kTabBytes;
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const uint32_t x = w[q];
                uint32_t p = 0u;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const uint32_t lo = (x >> (8 * e)) & 0xFu;
                  const uint32_t hi = (x >> (8 * e + 4)) & 0xFu;
                  p |= static_cast<uint32_t>(t[lo] ^ t[16 + hi]) << (8 * e);
                }
                acc[rr][q] ^= p;
              }
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < kRowTile; ++rr) {
          if (r0 + rr < r) {
            uint8_t* o = dst + static_cast<long long>(r0 + rr) * k + col;
            if (accumulate) {
              uint32_t prev[4];
              load16<kAligned>(o, avail, prev);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[rr][q] ^= prev[q];
            }
            store16<kAligned>(o, avail, acc[rr]);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int gf_matmul_launch(const void* data, void* out, const void* tables,
                                long long batch, int n, int r, long long k,
                                long long data_bstride, long long out_bstride,
                                int accumulate, int aligned, void* stream) {
  if (batch <= 0 || n <= 0 || r <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  const long long smem = static_cast<long long>(r) * n * kTabBytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);

  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  // one block per (stripe, column range); a block loops over further ranges
  // once the grid holds about 16 blocks per SM
  const int gy = batch < 65535 ? static_cast<int>(batch) : 65535;
  const long long chunks = (k + 15) / 16;
  long long gx = (chunks + kThreads - 1) / kThreads;
  long long cap = (16LL * sms + gy - 1) / gy;
  if (cap < 1) cap = 1;
  if (gx > cap) gx = cap;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  const uint8_t* t = static_cast<const uint8_t*>(tables);
  if (aligned) {
    gf_matmul_kernel<true><<<grid, block, static_cast<size_t>(smem), st>>>(
        d, o, t, batch, n, r, k, data_bstride, out_bstride, accumulate);
  } else {
    gf_matmul_kernel<false><<<grid, block, static_cast<size_t>(smem), st>>>(
        d, o, t, batch, n, r, k, data_bstride, out_bstride, accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
