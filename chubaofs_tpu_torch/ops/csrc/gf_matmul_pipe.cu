// GF(2^8) matrix product for Hopper (sm_90a) as a warp-specialised pipeline:
// out[s] = M (x) data[s] per stripe s, the bit-matrix product on the tensor
// cores, fed by a TMA bulk-copy ring under mbarriers.
//
// Replaces the TPU kernels chubaofs_tpu/ops/pallas_gf_pipe.py::_make_kernel
// (dynamic buffer slot) and chubaofs_tpu/ops/pallas_gf_pipe.py::_make_kernel_static
// (static slots, the loop unrolled over the ring), both driven by
// gf_matmul_bytes_pipelined. On the TPU one program per stripe runs a skewed
// manual double buffer: the DMA of tile t+1 is in flight while tile t is
// unpacked into bit planes, the (8r, 8n) bit matrix multiplies them on the
// MXU, & 1 and a pack give the bytes, and the output DMA runs asynchronously.
// This kernel computes the same function, out_bits = (M_bits . bits(data))
// mod 2, for any (8r, 8n) GF(2) matrix given as runtime data.
//
// Bound on this card (H100 SXM, 3.35 TB/s HBM, 1,979 int8 TOP/s dense): memory.
// Every input byte is read once and every output byte written once, (n + r) * k
// bytes per stripe: 16 EC(12,4) stripes at the 1 MiB bucket move 268 MB, about
// 80 us. The tensor-core work is 2 * 8r' * 8n' ops per column (r' and n' padded
// to multiples of 4): 51.5 G MACs there, about 52 us at the int8 peak. But
// mma.sync runs below that peak, and building the A fragments and packing
// the bytes costs CUDA-core instructions per byte, so in practice the kernel
// is bound by instruction issue, not by HBM (PERF.md).
//
// Design (what the TPU pipeline becomes here):
//   * arithmetic (gf_bitmma.cuh): mma.sync.m16n8k32 s8 with s32
//     accumulators. Per 16 columns, group of 4 input rows and pass of 4
//     output rows, four MMAs, each for 2 bits of the 4 rows. A fragments come
//     from 32-bit shared loads, a byte transpose (__byte_perm) and one shift
//     per bit plane: ALU work per input byte, not per product. The
//     B operand is the bit matrix in fragment order, each output bit b scaled
//     by 2^b (64 bytes per coefficient, built and cached by the host), so an
//     accumulator's parity sits at its own bit and a lane packs whole output
//     bytes with bit selects: no shuffles, no lookup tables. B is staged in
//     shared memory once per CTA; a single pass (r <= 4) over at most
//     kRegGroups input groups (every RS encode and repair of the main path)
//     holds it in registers for the whole walk, with the group loop unrolled
//     (template kG); other shapes read it per group from shared memory.
//   * warp roles: kConsumerWarps consumer warps and one producer warp. A
//     consumer warp owns kt / kConsumerWarps contiguous columns of each tile,
//     32 at a time (two M tiles); lane (g, t) owns 4 of them and writes output
//     row t of each pass.
//   * input ring: kStages stages of 4G rows x (kt + 16) bytes (G = ceil(n/4);
//     the padding rows are never written and meet zero B fragments). Each
//     stage has a full and an empty mbarrier. Producer lane l takes the rows
//     j = l, l + 32, ...: it waits on the empty barrier, stores the ragged
//     head and tail of each row (fewer than 16 bytes each, only where the row
//     is not 16-byte aligned) with plain byte copies, arrives on the full
//     barrier with the bytes it will copy (mbarrier.arrive.expect_tx), and
//     issues one cp.async.bulk per row for the 16-byte aligned interior. Row j
//     sits in its stage at its global address's offset mod 16, so the
//     interior copy is legal for any base and any k, and nothing outside the
//     tensor is read. Consumers wait with mbarrier.try_wait.parity and release
//     the stage with one arrive per warp.
//   * output: when every row is 16-byte aligned (the host's align = 16), a
//     warp packs its bytes into one of two output slots in shared memory,
//     fences (fence.proxy.async.shared::cta), and lane 0 writes each row of
//     its columns with cp.async.bulk.global.shared::cta.bulk_group. Before a
//     slot is reused, cp.async.bulk.wait_group.read 1 (the TPU's
//     out_dma(prev, tc-2).wait()); before exit, wait_group 0 (the TPU's
//     _drain). Otherwise (align = 1) the packed bytes go from registers to
//     global memory.
//   * slots: kStaticSlots = false computes slot = it % kStages and the phase
//     at run time; kStaticSlots = true unrolls the loop over the ring so every
//     slot index is a compile-time constant. Both are built.
//   * grid: persistent CTAs, as many as fit on the SMs at once (occupancy
//     query in the launcher), never more than there are (stripe, tile) items.
//     CTA x walks items x, x + gridDim.x, ... through its ring, so every CTA
//     gets within one tile of the same work and there is no tail wave.
//   * the k tail is masked in the kernel; nothing is padded or sliced. The
//     accumulate flag (column blocks after the first) XORs the old output in.
//
// Interface: plain C, loaded with ctypes. The launch runs on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "gf_bitmma.cuh"

namespace {

constexpr int kPipeStages = 3;  // the ring depth; must match STAGES in cuda_gf_pipe.py
constexpr int kRegGroups = 3;   // input groups whose B fragments a single pass keeps in registers
                                // (a fourth spills under the two-CTA register budget)
constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr int kTileQuantum = kConsumerWarps * gfmma::kColsPerWarp;  // kt is a multiple of this
constexpr int kRowPad = 16;     // a stage row holds kt + 16 bytes: room for its offset mod 16
constexpr int kOutRowPad = 32;  // an output slot row holds kt + 32 bytes: the 4 rows of a pass
                                // land in different banks
constexpr int kBarBytes = 128;  // the barriers, at the front of shared memory
constexpr uint64_t kMaxWaitNs = 10000000000ull;  // 10 s: a barrier wait past this traps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of the given parity to complete. A wait that outlasts
// kMaxWaitNs is a fault in the protocol: trap, so the launch fails instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint64_t t0 = 0;
  for (uint32_t spin = 1;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023u) == 0u) {
      const uint64_t now = global_ns();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > kMaxWaitNs) {
        __trap();
      }
    }
  }
}

__device__ __forceinline__ void bulk_load(void* dst_smem, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst_smem)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src_smem, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_addr(src_smem)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void bulk_wait_read1() { asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory"); }

__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// [a, b): the 16-byte aligned interior of the row bytes [pa, e); [pa, a) is
// the ragged head and [b, e) the ragged tail.
__device__ __forceinline__ void interior(uintptr_t pa, uintptr_t e, uintptr_t& a, uintptr_t& b) {
  const uintptr_t up = (pa + 15u) & ~uintptr_t(15);
  const uintptr_t dn = e & ~uintptr_t(15);
  a = up < e ? up : e;
  b = dn > a ? dn : a;
}

// Everything a CTA's walk needs, fixed for the launch.
struct Walk {
  const uint8_t* data;
  uint8_t* out;
  const uint8_t* op;  // B fragments in shared memory
  uint8_t* ring;
  uint8_t* oslots;
  uint64_t* full;
  uint64_t* empty;
  long long k, data_bstride, out_bstride;
  int n, r, groups, passes, kt, tiles, accumulate;

  __device__ __forceinline__ int row_bytes() const { return kt + kRowPad; }
  __device__ __forceinline__ int out_row_bytes() const { return kt + kOutRowPad; }
  __device__ __forceinline__ uint8_t* stage(int slot) const { return ring + slot * 4 * groups * row_bytes(); }
  // the stripe, first column and valid columns of this CTA's item it: the
  // launch's (stripe, tile) item blockIdx.x + it * gridDim.x
  __device__ __forceinline__ void item(long long it, long long& s, long long& c0, int& len) const {
    const long long gi = blockIdx.x + it * gridDim.x;
    s = gi / tiles;
    c0 = (gi - s * tiles) * kt;
    const long long rest = k - c0;
    len = rest < kt ? static_cast<int>(rest) : kt;
  }
};

// Producer lane: fill `slot` with item it once the consumers have released it.
template <bool kAligned>
__device__ __forceinline__ void produce(const Walk& w, long long it, int slot, uint32_t phase, int lane) {
  mbar_wait(&w.empty[slot], phase ^ 1u);
  long long s, c0;
  int len;
  w.item(it, s, c0, len);
  const uint8_t* src = w.data + s * w.data_bstride + c0;
  uint8_t* st = w.stage(slot);
  uint32_t tx = 0;
  for (int j = lane; j < w.n; j += 32) {
    const uint8_t* p = src + j * w.k;
    if (kAligned) {
      tx += static_cast<uint32_t>(len);
    } else {
      const uintptr_t pa = reinterpret_cast<uintptr_t>(p);
      uint8_t* d = st + j * w.row_bytes() + (pa & 15u);  // column 0 of row j
      uintptr_t a, b;
      interior(pa, pa + len, a, b);
      for (uintptr_t x = pa; x < a; ++x) d[x - pa] = p[x - pa];        // ragged head
      for (uintptr_t x = b; x < pa + len; ++x) d[x - pa] = p[x - pa];  // ragged tail
      tx += static_cast<uint32_t>(b - a);
    }
  }
  mbar_arrive_expect_tx(&w.full[slot], tx);  // also releases this lane's head/tail stores
  for (int j = lane; j < w.n; j += 32) {
    const uint8_t* p = src + j * w.k;
    if (kAligned) {
      bulk_load(st + j * w.row_bytes(), p, static_cast<uint32_t>(len), &w.full[slot]);
    } else {
      const uintptr_t pa = reinterpret_cast<uintptr_t>(p);
      uintptr_t a, b;
      interior(pa, pa + len, a, b);
      if (b > a) {  // 16-byte aligned at both ends: row j's column x sits at (pa & 15) + x
        bulk_load(st + j * w.row_bytes() + (pa & 15u) + (a - pa), p + (a - pa), static_cast<uint32_t>(b - a),
                  &w.full[slot]);
      }
    }
  }
}

// 4 bytes of a stage row at column c (a multiple of 4). The row's column 0
// sits at offset o (its global address mod 16) in its stage row.
template <bool kAligned>
__device__ __forceinline__ uint32_t load4(const uint8_t* row, uint32_t o, int c) {
  if (kAligned) return *reinterpret_cast<const uint32_t*>(row + c);
  const uint32_t* p = reinterpret_cast<const uint32_t*>(row + (o & ~3u) + c);
  return __funnelshift_r(p[0], p[1], 8u * (o & 3u));
}

// The lane's words of input group jg: rows 4jg .. 4jg + 3 at its 4 columns c.
template <bool kAligned>
__device__ __forceinline__ void load_words(const Walk& w, const uint8_t* st, const uint8_t* src, int jg, int c,
                                           uint32_t r[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 4 * jg + q;
    const uint32_t o = kAligned ? 0u : static_cast<uint32_t>(reinterpret_cast<uintptr_t>(src + j * w.k) & 15u);
    r[q] = load4<kAligned>(st + j * w.row_bytes(), o, c);
  }
}

// The lane's B fragments of the kR MMAs of (pass, group jg), from shared memory.
template <int kR>
__device__ __forceinline__ void load_b(const Walk& w, int pass, int jg, int lane, uint2 b[kR]) {
  const uint2* bf = reinterpret_cast<const uint2*>(w.op) + ((pass * w.groups + jg) * kR) * 32 + lane;
#pragma unroll
  for (int p = 0; p < kR; ++p) b[p] = bf[p * 32];
}

// The MMAs of one input group: 2 M tiles x kR MMAs of the pass.
template <int kR>
__device__ __forceinline__ void group_mma(int acc[2][kR][4], const uint32_t r[4], const uint2 b[kR], int t) {
  uint32_t a[2][4];
  gfmma::a_frags(r, t, a);
#pragma unroll
  for (int p = 0; p < kR; ++p) {
#pragma unroll
    for (int m = 0; m < 2; ++m) gfmma::mma_s8(acc[m][p], a[m], b[p]);
  }
}

template <int kR>
__device__ __forceinline__ void zero(int acc[2][kR][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int p = 0; p < kR; ++p) acc[m][p][0] = acc[m][p][1] = acc[m][p][2] = acc[m][p][3] = 0;
}

// Pack the pass's bytes; lane (g, t) with t % (4/kR) == 0 writes its 4 bytes
// of output row pass * kR + t * kR / 4 at tile columns c .. c + 3: into the
// output slot (aligned) or straight to global memory, masked by len.
template <bool kAligned, int kR>
__device__ __forceinline__ void store_pass(const Walk& w, const int acc[2][kR][4], uint8_t* dst, uint8_t* oslot,
                                          int pass, int t, int c, int len) {
  uint32_t v = gfmma::pack_word<kR>(acc, t);  // every lane: the quad's shuffles
  const int row = pass * kR + t * kR / gfmma::kMaxRowsPerPass;
  if (t % (gfmma::kMaxRowsPerPass / kR) != 0 || row >= w.r) return;
  if (kAligned) {
    if (w.accumulate && c < len) v ^= *reinterpret_cast<const uint32_t*>(dst + row * w.k + c);
    *reinterpret_cast<uint32_t*>(oslot + row * w.out_row_bytes() + c) = v;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e < len) {
        uint8_t* p = dst + row * w.k + c + e;
        uint8_t byte = static_cast<uint8_t>(v >> (8 * e));
        if (w.accumulate) byte ^= *p;
        *p = byte;
      }
    }
  }
}

// Consumer warp: compute item it from `slot`, release the slot, write the
// output. kR: output rows per pass. kG > 0: one pass (r <= kR) over kG
// groups, the B fragments in registers (breg) and the group loop unrolled;
// kG = 0: any shape, the B fragments read from shared memory per group.
template <bool kAligned, int kG, int kR>
__device__ __forceinline__ void consume(const Walk& w, long long it, int slot, uint32_t phase, int warp, int lane,
                                        const uint2 (&breg)[kG > 0 ? kG : 1][kR]) {
  const int g = lane >> 2, t = lane & 3;
  long long s, c0;
  int len;
  w.item(it, s, c0, len);
  const uint8_t* src = w.data + s * w.data_bstride;  // a row's offset mod 16 is the same in every tile
  uint8_t* dst = w.out + s * w.out_bstride + c0;
  const int wcols = w.kt / kConsumerWarps;
  const int cb = warp * wcols;
  const int ce = cb + wcols < len ? cb + wcols : len;
  uint8_t* oslot = w.oslots + (it & 1) * w.r * w.out_row_bytes();
  if (kAligned) {  // the bulk stores of item it - 2 have finished reading this output slot
    if (lane == 0) bulk_wait_read1();
    __syncwarp();
  }
  mbar_wait(&w.full[slot], phase);
  const uint8_t* st = w.stage(slot);

  for (int cc = cb; cc < ce; cc += gfmma::kColsPerWarp) {
    const int c = cc + 4 * g;  // this lane's 4 columns of the tile
    int acc[2][kR][4];
    if constexpr (kG > 0) {
      zero<kR>(acc);
#pragma unroll
      for (int jg = 0; jg < kG; ++jg) {
        uint32_t r[4];
        load_words<kAligned>(w, st, src, jg, c, r);
        group_mma<kR>(acc, r, breg[jg], t);
      }
      store_pass<kAligned, kR>(w, acc, dst, oslot, 0, t, c, len);
    } else {
      for (int pass = 0; pass < w.passes; ++pass) {
        zero<kR>(acc);
        for (int jg = 0; jg < w.groups; ++jg) {
          uint32_t r[4];
          uint2 b[kR];
          load_words<kAligned>(w, st, src, jg, c, r);
          load_b<kR>(w, pass, jg, lane, b);
          group_mma<kR>(acc, r, b, t);
        }
        store_pass<kAligned, kR>(w, acc, dst, oslot, pass, t, c, len);
      }
    }
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(&w.empty[slot]);  // the warp is done with the stage
  if (kAligned) {
    fence_async_shared();  // the output slot's stores, visible to the bulk copy
    __syncwarp();
    if (lane == 0) {
      if (ce > cb) {
        for (int row = 0; row < w.r; ++row) {
          bulk_store(dst + row * w.k + cb, oslot + row * w.out_row_bytes() + cb, static_cast<uint32_t>(ce - cb));
        }
      }
      bulk_commit();
    }
  }
}

// data: (batch, n, k) rows at data + s * data_bstride + j * k
// out:  (batch, r, k) rows at out + s * out_bstride + i * k
// op:   (passes, G, 4, 32 lanes, 2, 4) B fragments of the block's bit matrix (gf_bitmma.cuh)
template <int kStages, bool kStaticSlots, bool kAligned, int kG, int kR>
__global__ void __launch_bounds__(kThreads, 2)
gf_pipe_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out, const uint8_t* __restrict__ op,
               long long batch, int n, int r, long long k, long long data_bstride, long long out_bstride,
               int accumulate, int kt) {
  extern __shared__ __align__(128) uint8_t smem[];
  Walk w;
  w.groups = (n + 3) / 4;
  w.passes = (r + kR - 1) / kR;
  w.full = reinterpret_cast<uint64_t*>(smem);
  w.empty = w.full + kStages;
  uint8_t* s_op = smem + kBarBytes;
  const int op_bytes = w.passes * w.groups * kR * gfmma::kFragBytes;
  w.op = s_op;
  w.ring = s_op + op_bytes;
  w.kt = kt;
  w.oslots = w.ring + kStages * 4 * w.groups * w.row_bytes();
  w.data = data;
  w.out = out;
  w.k = k;
  w.data_bstride = data_bstride;
  w.out_bstride = out_bstride;
  w.n = n;
  w.r = r;
  w.accumulate = accumulate;
  w.tiles = static_cast<int>((k + kt - 1) / kt);
  const long long items = batch * w.tiles;
  const long long total = (items - blockIdx.x + gridDim.x - 1) / gridDim.x;  // this CTA's items

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&w.full[i], 32);              // every producer lane arrives once per fill
      mbar_init(&w.empty[i], kConsumerWarps);  // lane 0 of every consumer warp once per use
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x * 16; i < op_bytes; i += kThreads * 16) {
    *reinterpret_cast<uint4*>(s_op + i) = *reinterpret_cast<const uint4*>(op + i);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint2 breg[kG > 0 ? kG : 1][kR];  // kG > 0: the single pass's B fragments, for the whole walk
  if constexpr (kG > 0) {
#pragma unroll
    for (int jg = 0; jg < kG; ++jg) load_b<kR>(w, 0, jg, lane, breg[jg]);
  } else {
#pragma unroll
    for (int p = 0; p < kR; ++p) breg[0][p] = make_uint2(0u, 0u);
  }
  if (warp == kConsumerWarps) {
    if (kStaticSlots) {
      for (long long base = 0; base < total; base += kStages) {
        const uint32_t phase = static_cast<uint32_t>(base / kStages) & 1u;
#pragma unroll
        for (int u = 0; u < kStages; ++u) {
          if (base + u < total) produce<kAligned>(w, base + u, u, phase, lane);
        }
      }
    } else {
      for (long long it = 0; it < total; ++it) {
        produce<kAligned>(w, it, static_cast<int>(it % kStages), static_cast<uint32_t>(it / kStages) & 1u, lane);
      }
    }
  } else {
    if (kStaticSlots) {
      for (long long base = 0; base < total; base += kStages) {
        const uint32_t phase = static_cast<uint32_t>(base / kStages) & 1u;
#pragma unroll
        for (int u = 0; u < kStages; ++u) {
          if (base + u < total) consume<kAligned, kG, kR>(w, base + u, u, phase, warp, lane, breg);
        }
      }
    } else {
      for (long long it = 0; it < total; ++it) {
        consume<kAligned, kG, kR>(w, it, static_cast<int>(it % kStages), static_cast<uint32_t>(it / kStages) & 1u,
                                  warp, lane, breg);
      }
    }
    if (kAligned && lane == 0) bulk_wait_all();  // the drain: every output row is written
  }
}

typedef void (*PipeKernel)(const uint8_t*, uint8_t*, const uint8_t*, long long, int, int, long long, long long,
                           long long, int, int);

// Output rows per pass: r itself below 4, so a pass computes no idle rows
// there; must match rows_per_pass in cuda_gf_pipe.py.
int rows_per_pass(int r) { return r < 3 ? r : gfmma::kMaxRowsPerPass; }

template <int kG, int kR>
PipeKernel pick_slots(bool static_slots, bool aligned) {
  if (static_slots) {
    return aligned ? gf_pipe_kernel<kPipeStages, true, true, kG, kR>
                   : gf_pipe_kernel<kPipeStages, true, false, kG, kR>;
  }
  return aligned ? gf_pipe_kernel<kPipeStages, false, true, kG, kR>
                 : gf_pipe_kernel<kPipeStages, false, false, kG, kR>;
}

template <int kR>
PipeKernel pick_groups(int groups, bool static_slots, bool aligned) {
  switch (groups) {
    case 1: return pick_slots<1, kR>(static_slots, aligned);
    case 2: return pick_slots<2, kR>(static_slots, aligned);
    case 3: return pick_slots<3, kR>(static_slots, aligned);
    default: return pick_slots<0, kR>(static_slots, aligned);
  }
}

// One pass (r <= 4) over at most kRegGroups input groups keeps its B
// fragments in registers; everything else reads them from shared memory.
PipeKernel pick(int n, int r, bool static_slots, bool aligned) {
  const int groups = (n + 3) / 4;
  const int reg_groups = r <= gfmma::kMaxRowsPerPass && groups <= kRegGroups ? groups : 0;
  switch (rows_per_pass(r)) {
    case 1: return pick_groups<1>(reg_groups, static_slots, aligned);
    case 2: return pick_groups<2>(reg_groups, static_slots, aligned);
    default: return pick_groups<4>(reg_groups, static_slots, aligned);
  }
}

long long smem_bytes(int n, int r, int kt) {
  const long long groups = (n + 3) / 4;
  const long long rows = rows_per_pass(r);
  const long long passes = (r + rows - 1) / rows;
  return kBarBytes + passes * groups * rows * gfmma::kFragBytes + kPipeStages * 4 * groups * (kt + kRowPad) +
         2LL * r * (kt + kOutRowPad);
}

}  // namespace

// kt: tile columns (a positive multiple of kTileQuantum, 256); sms: the SMs
// the grid is sized for (as many CTAs as fit on them at once, no more than
// there are items); align: 16 (every row base and k 16-byte aligned) or 1.
extern "C" int gf_pipe_launch(const void* data, void* out, const void* op, long long batch, int n, int r,
                              long long k, long long data_bstride, long long out_bstride, int accumulate, int kt,
                              int sms, int align, int static_slots, void* stream) {
  if (batch <= 0 || n <= 0 || r <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  if (kt <= 0 || kt % kTileQuantum || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (align != 16 && align != 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(n, r, kt);

  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);

  const bool aligned = align == 16;
  PipeKernel kern = pick(n, r, static_slots, aligned);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, static_cast<size_t>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long items = batch * ((k + kt - 1) / kt);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long grid = items < resident ? items : resident;
  kern<<<dim3(static_cast<unsigned>(grid)), dim3(kThreads), static_cast<size_t>(smem),
         static_cast<cudaStream_t>(stream)>>>(static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out),
                                              static_cast<const uint8_t*>(op), batch, n, r, k, data_bstride,
                                              out_bstride, accumulate, kt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long gf_pipe_smem_bytes(int n, int r, int kt) { return smem_bytes(n, r, kt); }

extern "C" const char* gf_pipe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
