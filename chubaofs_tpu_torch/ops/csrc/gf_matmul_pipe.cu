// GF(2^8) matrix product for Hopper (sm_90a) as a software pipeline:
// out[s] = M (x) data[s] per stripe s, streamed through a shared-memory stage ring.
//
// Replaces the TPU kernels chubaofs_tpu/ops/pallas_gf_pipe.py::_make_kernel
// (dynamic buffer slot) and chubaofs_tpu/ops/pallas_gf_pipe.py::_make_kernel_static
// (static slots, the loop unrolled over tile pairs), both driven by
// gf_matmul_bytes_pipelined. On the TPU one program per stripe owns all of k
// and runs a skewed manual double buffer: the DMA of tile t+1 is in flight
// while tile t is unpacked into bit planes and multiplied on the MXU. This
// kernel computes the same function, out[s, i, x] = XOR_j M[i, j] * data[s, j, x]
// over GF(2^8) (POLY 0x11D), with the same contract as gf_matmul.cu (B1).
//
// Bound on this card (H100 SXM, 3.35 TB/s HBM): memory. Every input byte is
// read once and every output byte written once, (n + r) * k bytes per
// stripe: 16 EC(12,4) stripes at the 1 MiB bucket move 268 MB, about 80 us.
// The arithmetic, one table multiply-accumulate per (output row, input row,
// byte), is far below the CUDA cores' rate.
//
// Design (what the TPU pipeline becomes here):
//   * grid: a CTA owns one (stripe, column span). The TPU's grid=(b,) would
//     leave most of the 132 SMs idle at b = 16, so the host (ops/cuda_gf_pipe.py)
//     sizes the spans for at least two CTAs per SM where the work allows.
//     Spans are multiples of the tile kt (a multiple of 16), so a span
//     boundary never splits a 16-byte vector.
//   * stage ring in dynamic shared memory: the split-nibble tables first
//     (r * n * 32 bytes <= 48 KiB, a multiple of 32, so the stages after them
//     stay 16-byte aligned), then kStages buffers of n * kt bytes. Tiles are
//     filled with cp.async (16-byte .cg when the rows are 16-byte aligned,
//     4-byte .ca when 4-aligned, plain byte loads otherwise), one commit group
//     per tile. Iteration t waits for tile t (wait_group kStages-2; wait_all
//     before the last tile, the counterpart of _drain), synchronises, issues
//     the copy of tile t+kStages-1 into the slot tile t-1 just freed, and
//     computes tile t while that copy is in flight.
//   * compute: B1's split-nibble lookups, c * x = lo_c[x & 15] ^ hi_c[x >> 4],
//     reading the data from the stage buffer instead of global memory, up to
//     kRowTile output rows XOR-accumulated in registers per 16-byte chunk.
//     Results go straight from registers to global memory (16-byte stores when
//     aligned); no bit planes exist anywhere.
//   * the stage count kStages is a template parameter; the launcher
//     instantiates kPipeStages = 2, and a deeper ring is a one-constant change.
//   * slots: kStaticSlots = false computes slot = t % kStages at run time;
//     kStaticSlots = true unrolls the tile loop by two with slots 0 and 1 as
//     compile-time constants (the TPU's plan-B variant). Both are built.
//   * the k tail is masked in the kernel; nothing is padded or sliced.
//     Column blocks of matrices with more than 1,536 coefficients
//     XOR-accumulate into the output (accumulate = 1), as in B1.
//
// Interface: plain C, loaded with ctypes. The launch runs on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPipeStages = 2;  // the stage count the launcher instantiates (the TPU kernel's
                                // double buffer); must match STAGES in cuda_gf_pipe.py
constexpr int kRowTile = 8;     // output rows held in registers per chunk
constexpr int kTabBytes = 32;   // per coefficient: 16 low-nibble + 16 high-nibble products
constexpr int kMaxTab = 48 * 1024;  // tables per launch; the wrapper splits larger matrices

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(s)), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(s)), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy `len` valid bytes of each of the n rows, starting at column col0, into
// stage (n rows of kt bytes). kAlign is 16, 4 or 1: the alignment of every
// row base and of k, chosen by the host.
template <int kAlign>
__device__ __forceinline__ void load_tile(uint8_t* stage, const uint8_t* src, int n, long long k,
                                          long long col0, int len, int kt) {
  if (kAlign == 16) {
    const int per_row = len >> 4;  // len is a multiple of 16 here
    for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
      const int j = i / per_row;
      const int c = (i - j * per_row) << 4;
      cp_async16(stage + j * kt + c, src + j * k + col0 + c);
    }
  } else if (kAlign == 4) {
    const int per_row = len >> 2;  // len is a multiple of 4 here
    for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
      const int j = i / per_row;
      const int c = (i - j * per_row) << 2;
      cp_async4(stage + j * kt + c, src + j * k + col0 + c);
    }
  } else {
    for (int i = threadIdx.x; i < n * len; i += kThreads) {
      const int j = i / len;
      const int c = i - j * len;
      stage[j * kt + c] = src[j * k + col0 + c];
    }
  }
}

template <int kAlign>
__device__ __forceinline__ void load_out(const uint8_t* p, int avail, uint32_t w[4]) {
  if (kAlign == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if (kAlign == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = 4 * q < avail ? reinterpret_cast<const uint32_t*>(p)[q] : 0u;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t x = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (q * 4 + e < avail) x |= static_cast<uint32_t>(p[q * 4 + e]) << (8 * e);
      }
      w[q] = x;
    }
  }
}

template <int kAlign>
__device__ __forceinline__ void store_out(uint8_t* p, int avail, const uint32_t w[4]) {
  if (kAlign == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (kAlign == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (4 * q < avail) reinterpret_cast<uint32_t*>(p)[q] = w[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (q * 4 + e < avail) p[q * 4 + e] = static_cast<uint8_t>(w[q] >> (8 * e));
      }
    }
  }
}

// out rows [0, r) over columns [col0, col0 + len) from the staged tile.
// Work items are (row tile, 16-byte chunk) pairs, so a narrow tile with many
// output rows still spreads over the block.
template <int kAlign>
__device__ __forceinline__ void compute_tile(const uint8_t* s_tab, const uint8_t* stage, uint8_t* dst,
                                             int n, int r, long long k, long long col0, int len,
                                             int kt, int accumulate) {
  const int chunks = (len + 15) >> 4;
  const int row_tiles = (r + kRowTile - 1) / kRowTile;
  for (int w = threadIdx.x; w < row_tiles * chunks; w += kThreads) {
    const int rt = w / chunks;
    const int c = (w - rt * chunks) << 4;
    const int r0 = rt * kRowTile;
    const int avail = len - c;
    uint32_t acc[kRowTile][4];
#pragma unroll
    for (int rr = 0; rr < kRowTile; ++rr) acc[rr][0] = acc[rr][1] = acc[rr][2] = acc[rr][3] = 0u;
    for (int j = 0; j < n; ++j) {
      const uint4 v = *reinterpret_cast<const uint4*>(stage + j * kt + c);
      const uint32_t x4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) {
        if (r0 + rr < r) {
          const uint8_t* t = s_tab + ((r0 + rr) * n + j) * kTabBytes;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t x = x4[q];
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
        uint8_t* o = dst + static_cast<long long>(r0 + rr) * k + col0 + c;
        if (accumulate) {
          uint32_t prev[4];
          load_out<kAlign>(o, avail, prev);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[rr][q] ^= prev[q];
        }
        store_out<kAlign>(o, avail, acc[rr]);
      }
    }
  }
}

// Everything one pipeline step needs, fixed for a (stripe, span).
struct Span {
  const uint8_t* s_tab;
  uint8_t* stages;
  long long stage_bytes;
  const uint8_t* src;
  uint8_t* dst;
  int n, r, kt, tiles, accumulate;
  long long k, col0, end;

  __device__ __forceinline__ int len(int t) const {
    const long long rest = end - (col0 + static_cast<long long>(t) * kt);
    return rest < kt ? static_cast<int>(rest) : kt;
  }
  __device__ __forceinline__ uint8_t* stage(int slot) const { return stages + slot * stage_bytes; }
};

// Iteration t of the ring: tile t is in `slot`, tile t + kStages - 1 goes to `next`.
template <int kStages, int kAlign>
__device__ __forceinline__ void pipe_step(const Span& sp, int t, int slot, int next) {
  if (t + 1 < sp.tiles) {
    cp_async_wait_group<kStages - 2>();
  } else {
    cp_async_wait_all();  // the drain: nothing may stay in flight past the last tile
  }
  __syncthreads();  // tile t visible to all; every thread is done with tile t-1's slot
  const int nt = t + kStages - 1;
  if (nt < sp.tiles) {
    load_tile<kAlign>(sp.stage(next), sp.src, sp.n, sp.k, sp.col0 + static_cast<long long>(nt) * sp.kt,
                      sp.len(nt), sp.kt);
  }
  cp_async_commit();  // one group per iteration, empty past the end, so the counts stay uniform
  compute_tile<kAlign>(sp.s_tab, sp.stage(slot), sp.dst, sp.n, sp.r, sp.k,
                       sp.col0 + static_cast<long long>(t) * sp.kt, sp.len(t), sp.kt, sp.accumulate);
}

// data: (batch, n, k) rows at data + s * data_bstride + j * k
// out:  (batch, r, k) rows at out + s * out_bstride + i * k
// tables: (r, n, 32) split-nibble products of the (r, n) coefficient block
// CTA (x, y) walks columns [x * span, min(k, (x + 1) * span)) of stripes y, y + gridDim.y, ...
template <int kStages, bool kStaticSlots, int kAlign>
__global__ void __launch_bounds__(kThreads)
gf_pipe_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
               const uint8_t* __restrict__ tables, long long batch, int n, int r, long long k,
               long long data_bstride, long long out_bstride, int accumulate, int kt, long long span) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tab_bytes = r * n * kTabBytes;  // a multiple of 32: the stages stay 16-byte aligned
  for (int i = threadIdx.x * 16; i < tab_bytes; i += kThreads * 16) {
    *reinterpret_cast<uint4*>(smem + i) = *reinterpret_cast<const uint4*>(tables + i);
  }

  Span sp;
  sp.s_tab = smem;
  sp.stages = smem + tab_bytes;
  sp.stage_bytes = static_cast<long long>(n) * kt;
  sp.n = n;
  sp.r = r;
  sp.kt = kt;
  sp.k = k;
  sp.accumulate = accumulate;
  sp.col0 = static_cast<long long>(blockIdx.x) * span;
  sp.end = sp.col0 + span < k ? sp.col0 + span : k;
  sp.tiles = static_cast<int>((sp.end - sp.col0 + kt - 1) / kt);

  for (long long s = blockIdx.y; s < batch; s += gridDim.y) {
    sp.src = data + s * data_bstride;
    sp.dst = out + s * out_bstride;
    __syncthreads();  // tables staged; the previous stripe's last tile is consumed
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {  // prologue: the first kStages-1 tiles in flight
      if (p < sp.tiles) load_tile<kAlign>(sp.stage(p), sp.src, n, k, sp.col0 + static_cast<long long>(p) * kt,
                                          sp.len(p), kt);
      cp_async_commit();
    }
    if (kStaticSlots) {
      static_assert(!kStaticSlots || kStages == 2, "static slots unroll a double buffer");
      for (int t = 0; t < sp.tiles; t += 2) {
        pipe_step<kStages, kAlign>(sp, t, 0, 1);
        if (t + 1 < sp.tiles) pipe_step<kStages, kAlign>(sp, t + 1, 1, 0);
      }
    } else {
      for (int t = 0; t < sp.tiles; ++t) {
        pipe_step<kStages, kAlign>(sp, t, t % kStages, (t + kStages - 1) % kStages);
      }
    }
  }
}

typedef void (*PipeKernel)(const uint8_t*, uint8_t*, const uint8_t*, long long, int, int, long long,
                           long long, long long, int, int, long long);

template <bool kStaticSlots>
PipeKernel pick(int align) {
  if (align == 16) return gf_pipe_kernel<kPipeStages, kStaticSlots, 16>;
  if (align == 4) return gf_pipe_kernel<kPipeStages, kStaticSlots, 4>;
  return gf_pipe_kernel<kPipeStages, kStaticSlots, 1>;
}

}  // namespace

// kt: tile bytes (a positive multiple of 16); span: columns per CTA (a
// positive multiple of kt); align: 16, 4 or 1 (see load_tile).
extern "C" int gf_pipe_launch(const void* data, void* out, const void* tables, long long batch, int n,
                              int r, long long k, long long data_bstride, long long out_bstride,
                              int accumulate, int kt, long long span, int align, int static_slots,
                              void* stream) {
  if (batch <= 0 || n <= 0 || r <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  if (kt <= 0 || kt % 16 || span <= 0 || span % kt) return static_cast<int>(cudaErrorInvalidValue);
  if (align != 16 && align != 4 && align != 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long tab = static_cast<long long>(r) * n * kTabBytes;
  if (tab > kMaxTab) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = tab + static_cast<long long>(kPipeStages) * n * kt;

  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);

  const long long gx = (k + span - 1) / span;
  if (gx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int gy = batch < 65535 ? static_cast<int>(batch) : 65535;
  PipeKernel kern = static_slots ? pick<true>(align) : pick<false>(align);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), dim3(kThreads), static_cast<size_t>(smem),
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), static_cast<const uint8_t*>(tables), batch,
      n, r, k, data_bstride, out_bstride, accumulate, kt, span);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gf_pipe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
