// The Hopper GEMM core of K1 (swin_block.cu) and K3a/K3b (perceive_stack.cu):
//
//   C = epilogue(A B),  A (M x K), B (K x N), bf16 operands, f32 accumulation
//
// on wgmma (m64n128k16, accumulators in registers). One persistent CTA per SM
// walks the output tiles (128 x 128, n fastest, so that neighbouring CTAs
// share A's rows in L2); tiles may also be split over K, each split writing
// its raw sums to its own slice of a partial buffer that the caller reduces
// in a fixed order (deterministic; no atomics). Per CTA:
//
//   the producer (one warpgroup, or two when converting) fills a ring of
//     STAGES shared-memory stages, each one 128 x 64 tile of A and of B,
//     128-byte swizzled as wgmma's descriptors read them, and signals a full
//     barrier per stage;
//   two consumer warpgroups own 64 rows of the tile each, run four
//     wgmma k16 steps per stage with one stage's products kept in flight,
//     release the stage on its empty barrier, and apply the epilogue to the
//     accumulator registers directly (no staging tile), its loads for
//     several output pairs in flight at once. The producer runs ahead into
//     the next tile, so one tile's epilogue overlaps the next one's loads.
//
// Two producers feed the one mainloop:
//   TMA:        bf16 operands that are K-contiguous (K1: x, attn, x1, y and
//               the (out, in) weights): one thread issues two tensor-map copies
//               per stage (maps built through the driver entry point and cached
//               by pointer and shape, tensor_map below); zeros past the edges.
//   converting: f32 operands of any of the two layouts (K3): one producer
//               warpgroup per operand loads 16 bytes per lane along the
//               contiguous index (scalar loads where rows are not 16-byte
//               aligned), rounds to bf16 (the TPU kernel's point: operands
//               "rounded to the compute type as they are staged") and stores
//               into the swizzled layout. A may also be bf16 already (K3b's
//               att^T and a1^T, stored rounded by the forward): its values
//               pass through unchanged. A K-contiguous tile is 128 rows of 64 k; an
//               M- or N-contiguous tile is 64 k-rows of two 64-wide panels,
//               which wgmma reads through its transpose bit, so X^T dY needs
//               no transposed copy. For an N-contiguous f32 B it can also sum
//               B's columns over the split's rows (the bias gradient of
//               X^T dY), in a fixed order.
//
// The epilogue either finishes each output pair on its own (Epi::fetch and
// Epi::store), or, for an Epi with ROW_NORM (K3's LayerNorm after the
// out-projection and FFN2: N = 128, one tile's width), normalises whole
// rows: it finishes every pair into the accumulator registers (the next
// tile's first k-step overwrites them), sums each row's values and their
// squares over the quad that holds it, and stores the row normalised
// (Epi::value, Epi::store_norm).
//
// Shared memory layout of a stage (1024-byte aligned):
//   K-major tile:  row r (m or n) at r * 128 bytes; 16-byte chunk c (k 8c..8c+7)
//                  at ((c ^ (r % 8)) * 16). Descriptor: SBO 1024 (8 rows),
//                  a k16 step advances the start by 32 bytes.
//   MN-major tile: panel p (m or n 64p..64p+63) at p * 8192; k-row r at r * 128,
//                  chunk c at ((c ^ (r % 8)) * 16). Descriptor: LBO 8192 (the
//                  next panel), SBO 1024 (8 k-rows); a k16 step advances 2048.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace gemm90 {

typedef __nv_bfloat16 bf16;
typedef long long ll;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 5;
constexpr int TILE_BYTES = 128 * 64 * 2;  // one operand tile, either layout
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
// Producer warpgroups, then two consumer warpgroups: the TMA producer
// needs one thread; the converting one stages A in one warpgroup and B in
// another, so that both operands' loads are in flight together.
template <bool TMA>
__host__ __device__ constexpr int producers() { return TMA ? 1 : 2; }
template <bool TMA>
__host__ __device__ constexpr int threads() { return 128 * (producers<TMA>() + 2); }
constexpr int SCRATCH_FLOATS = 8 * BN;  // the column sums' fixed-order reduction
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8 + SCRATCH_FLOATS * 4;

struct Operand {
  const void* ptr;  // f32 (converting producer); unused by the TMA producer
  ll ld;            // elements between consecutive rows of the contiguous index
};

struct Problem {
  int M, N, K;
  int k_chunk;     // K per split, a multiple of BK (K when splits == 1)
  int splits;
  int m_tiles, n_tiles;
  float* partial;  // splits > 1: raw sums, [split][M][N]; the epilogue does not run
  float* colsum;   // null, or [split][N]: column sums of an N-contiguous f32 B
};

// ------------------------------------------------------------- primitives --- //

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int inner,
                                            int outer, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(inner), "r"(outer)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 128-byte-swizzle shared-memory matrix descriptor (layout type 1).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a wgmma.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A B (accumulate 0) or d += A B: m64n128k16, both operands in shared
// memory; TA / TB set for an M- / N-contiguous (transposed) operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ------------------------------------------------------ converting producer --- //

// One 8192-element f32 tile for its swizzled bf16 stage, by the 128 threads
// of a producer warpgroup: load into registers, then store as bf16.
// Element (o, i) is src[o * ld + i], o the outer (strided) index, i the
// contiguous one: KMAJOR = 128 outer rows (m or n) of 64 k; otherwise 64
// outer k-rows of 128 (m or n) in two panels. Elements past o_end or i_end
// are zeros. Thread t always takes the 8 contiguous elements of chunk
// column t % (IN / 8), with 16-byte loads where its rows start on 16 bytes.
template <bool KMAJOR>
struct Staged {
  static constexpr int IN = KMAJOR ? 64 : 128, OUT = KMAJOR ? 128 : 64;
  static constexpr int CPR = IN / 8, ROWS_PER_PASS = 128 / CPR;
  float v[8][8];

  // bf16 source: 8 values (16 bytes) a lane, exact in f32, so the store
  // rounds nothing.
  __device__ __forceinline__ void load(const bf16* __restrict__ src, ll ld, int o0, int o_end,
                                       int i0, int i_end) {
    const int t = threadIdx.x % 128;
    const int i = i0 + 8 * (t % CPR);
    const bool full_chunk =
        i + 8 <= i_end && ld % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int o = o0 + t / CPR + ROWS_PER_PASS * q;
      const bf16* p = src + (ll)o * ld + i;
      if (o < o_end && full_chunk) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
        const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[q][2 * e] = __uint_as_float(w[e] << 16);
          v[q][2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[q][e] = (o < o_end && i + e < i_end) ? __bfloat162float(p[e]) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void load(const float* __restrict__ src, ll ld, int o0, int o_end,
                                       int i0, int i_end) {
    const int t = threadIdx.x % 128;
    const int i = i0 + 8 * (t % CPR);
    const bool full_chunk =
        i + 8 <= i_end && ld % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int o = o0 + t / CPR + ROWS_PER_PASS * q;
      const float* p = src + (ll)o * ld + i;
      if (o < o_end && full_chunk) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p));
        const float4 y = __ldg(reinterpret_cast<const float4*>(p + 4));
        v[q][0] = x.x; v[q][1] = x.y; v[q][2] = x.z; v[q][3] = x.w;
        v[q][4] = y.x; v[q][5] = y.y; v[q][6] = y.z; v[q][7] = y.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[q][e] = (o < o_end && i + e < i_end) ? __ldg(p + e) : 0.f;
      }
    }
  }

  // With `sum_cols`, also add the (unrounded) values to the thread's 8
  // running column sums.
  __device__ __forceinline__ void store(unsigned char* tile, bool sum_cols,
                                        float (&cols)[8]) const {
    const int t = threadIdx.x % 128;
    const int c = t % CPR;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = t / CPR + ROWS_PER_PASS * q;
      if (sum_cols) {
#pragma unroll
        for (int e = 0; e < 8; ++e) cols[e] += v[q][e];
      }
      const uint4 packed = make_uint4(pack2(v[q][0], v[q][1]), pack2(v[q][2], v[q][3]),
                                      pack2(v[q][4], v[q][5]), pack2(v[q][6], v[q][7]));
      const int panel = c / 8, cc = c % 8;
      *reinterpret_cast<uint4*>(tile + panel * OUT * 128 + r * 128 + ((cc ^ (r & 7)) << 4)) =
          packed;
    }
  }
};

// ------------------------------------------------------------------ kernel --- //

struct TileCoord {
  int m, n, split, k_begin, k_end;
};

__device__ __forceinline__ TileCoord tile_coord(const Problem& p, int t) {
  TileCoord c;
  c.n = t % p.n_tiles;
  c.m = (t / p.n_tiles) % p.m_tiles;
  c.split = t / (p.n_tiles * p.m_tiles);
  c.k_begin = c.split * p.k_chunk;
  c.k_end = min(p.K, c.k_begin + p.k_chunk);
  return c;
}

// Whether an epilogue normalises whole rows (Epi::ROW_NORM, absent: no).
template <class E, class = void>
struct row_norm : std::false_type {};
template <class E>
struct row_norm<E, std::void_t<decltype(E::ROW_NORM)>> : std::bool_constant<E::ROW_NORM> {};

// The sum over the four lanes of a quad: one accumulator row.
__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Epi finishes and stores the pair (row, col), (row, col + 1) of the
// accumulated product (N is even) in two steps: `In in = epi.fetch(row,
// col)` loads what the pair needs from memory (bias, residual, ...), then
// `epi.store(row, col, v0, v1, in)`. The epilogue fetches for Epi::GROUP
// pairs (a divisor of 16) before it stores any, so their loads overlap
// instead of each waiting behind the previous pair's store. A row-norm Epi
// gives `float2 epi.value(row, col, v0, v1, in)`, the finished pair, and
// `epi.store_norm(row, col, v0, v1, mean, inv_std)`. TA is the element type
// of the converting producer's A (float or bf16).
template <class Epi, bool TMA, bool A_K, bool B_K, class TA = float>
__global__ void __launch_bounds__(threads<TMA>(), 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            Operand a, Operand b, Problem p, Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  float* scratch = reinterpret_cast<float*>(empty + STAGES);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], TMA ? 1 : 256);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = p.m_tiles * p.n_tiles * p.splits;

  if (wg < producers<TMA>()) {  // ---------------------------------- producers
    if (TMA && threadIdx.x != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileCoord tc = tile_coord(p, t);
      const bool sums = !TMA && !B_K && wg == 1 && p.colsum && tc.m == 0;
      float cols[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int k0 = tc.k_begin; k0 < tc.k_end; k0 += BK, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* ta = base + s * STAGE_BYTES;
        unsigned char* tb = ta + TILE_BYTES;
        if constexpr (TMA) {
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(ta, &map_a, k0, tc.m * BM, &full[s]);
          tma_load_2d(tb, &map_b, k0, tc.n * BN, &full[s]);
        } else {
          if (wg == 0) {  // A
            Staged<A_K> sa;
            if constexpr (A_K)
              sa.load(static_cast<const TA*>(a.ptr), a.ld, tc.m * BM, p.M, k0, tc.k_end);
            else
              sa.load(static_cast<const TA*>(a.ptr), a.ld, k0, tc.k_end, tc.m * BM, p.M);
            sa.store(ta, false, cols);
          } else {  // B
            Staged<B_K> sb;
            if constexpr (B_K)
              sb.load(static_cast<const float*>(b.ptr), b.ld, tc.n * BN, p.N, k0, tc.k_end);
            else
              sb.load(static_cast<const float*>(b.ptr), b.ld, k0, tc.k_end, tc.n * BN, p.N);
            sb.store(tb, sums, cols);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(&full[s]);
        }
      }
      if (sums) {  // this split's column sums of B, 8 partial rows summed in order
        const int tid = threadIdx.x % 128;
#pragma unroll
        for (int e = 0; e < 8; ++e) scratch[(tid / 16) * BN + 8 * (tid % 16) + e] = cols[e];
        named_bar_sync(1, 128);
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < 8; ++g) s += scratch[g * BN + tid];
        const int col = tc.n * BN + tid;
        if (col < p.N) p.colsum[(ll)tc.split * p.N + col] = s;
        named_bar_sync(1, 128);
      }
    }
    return;
  }

  // --------------------------------------------------------------- consumers
  const int cw = wg - producers<TMA>();  // rows 64 cw .. 64 cw + 63 of the tile
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // The first k16 step of a tile overwrites the accumulators (scale-d 0),
  // so no other instruction writes them inside the mainloop and ptxas
  // keeps the wgmma pipeline unserialized.
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileCoord tc = tile_coord(p, t);
    int prev = -1;
    for (int k0 = tc.k_begin; k0 < tc.k_end; k0 += BK, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* ta = base + s * STAGE_BYTES;
      const unsigned char* tb = ta + TILE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = A_K ? desc_sw128(ta + cw * 64 * 128 + kk * 32, 16, 1024)
                                : desc_sw128(ta + cw * 8192 + kk * 2048, 8192, 1024);
        const uint64_t db = B_K ? desc_sw128(tb + kk * 32, 16, 1024)
                                : desc_sw128(tb + kk * 2048, 8192, 1024);
        wgmma_128<A_K ? 0 : 1, B_K ? 0 : 1>(acc, da, db, k0 > tc.k_begin || kk > 0);
      }
      wgmma_commit();
      if (prev >= 0) {  // the previous stage's products are done: release it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

    // Accumulator layout (per warp, as mma.m16n8): acc[4j + 2h + e] is row
    // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e.
    const int row0 = tc.m * BM + 64 * cw + 16 * warp + lane / 4;
    const int col0 = tc.n * BN + 2 * (lane % 4);
    if constexpr (row_norm<Epi>::value) {  // whole rows: N == BN (the launch checks)
      float s[2] = {0.f, 0.f}, ss[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= p.M) continue;
#pragma unroll
        for (int j0 = 0; j0 < BN / 8; j0 += Epi::GROUP) {
          typename Epi::In in[Epi::GROUP];
#pragma unroll
          for (int j = 0; j < Epi::GROUP; ++j) in[j] = epi.fetch(row, col0 + 8 * (j0 + j));
#pragma unroll
          for (int j = 0; j < Epi::GROUP; ++j) {
            const int col = col0 + 8 * (j0 + j);
            const float2 v = epi.value(row, col, acc[4 * (j0 + j) + 2 * h],
                                       acc[4 * (j0 + j) + 2 * h + 1], in[j]);
            acc[4 * (j0 + j) + 2 * h] = v.x;
            acc[4 * (j0 + j) + 2 * h + 1] = v.y;
            s[h] += v.x + v.y;
            ss[h] += v.x * v.x + v.y * v.y;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h] = row_sum4(s[h]);
        ss[h] = row_sum4(ss[h]);
        const float mean = s[h] / p.N;
        const float inv = rsqrtf(fmaxf(ss[h] / p.N - mean * mean, 0.f) + epi.eps);
        const int row = row0 + 8 * h;
        if (row >= p.M) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          epi.store_norm(row, col0 + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], mean, inv);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= p.M) continue;
        if (p.partial) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = col0 + 8 * j;
            if (col < p.N)
              *reinterpret_cast<float2*>(p.partial + ((ll)tc.split * p.M + row) * p.N + col) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
          continue;
        }
#pragma unroll
        for (int j0 = 0; j0 < BN / 8; j0 += Epi::GROUP) {
          typename Epi::In in[Epi::GROUP];
#pragma unroll
          for (int j = 0; j < Epi::GROUP; ++j)
            if (col0 + 8 * (j0 + j) < p.N) in[j] = epi.fetch(row, col0 + 8 * (j0 + j));
#pragma unroll
          for (int j = 0; j < Epi::GROUP; ++j) {
            const int col = col0 + 8 * (j0 + j);
            if (col < p.N)
              epi.store(row, col, acc[4 * (j0 + j) + 2 * h], acc[4 * (j0 + j) + 2 * h + 1], in[j]);
          }
        }
      }
    }
  }
}

// --------------------------------------------------------------------- host --- //

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no link
// against libcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  });
  return fn;
}

// The tensor map of a row-major bf16 matrix (outer rows of `inner` elements,
// `ld` elements apart) read in 128-byte-swizzled boxes of 64 x 128, cached by
// pointer and shape.
inline cudaError_t tensor_map(CUtensorMap* out, const void* ptr, ll inner, ll outer, ll ld) {
  typedef std::tuple<uintptr_t, ll, ll, ll> Key;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  const Key key(reinterpret_cast<uintptr_t>(ptr), inner, outer, ld);
  std::lock_guard<std::mutex> lock(mu);
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
         elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *out);
  return cudaSuccess;
}

inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n < 1) n = 1;
  }
  return n;
}

inline Problem problem(int M, int N, int K, int k_chunk, float* partial, float* colsum) {
  Problem p;
  p.M = M;
  p.N = N;
  p.K = K;
  p.k_chunk = k_chunk > 0 ? k_chunk : K;
  p.splits = (K + p.k_chunk - 1) / p.k_chunk;
  p.m_tiles = (M + BM - 1) / BM;
  p.n_tiles = (N + BN - 1) / BN;
  p.partial = partial;
  p.colsum = colsum;
  return p;
}

// Launch on `st`: persistent, min(tiles, SMs) CTAs. With TMA, ma / mb are A's
// (K x M, K contiguous) and B's (K x N, K contiguous) maps.
template <class Epi, bool TMA, bool A_K, bool B_K, class TA = float>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, Operand a, Operand b,
                   const Problem& p, Epi epi, cudaStream_t st) {
  if (p.M < 1 || p.N < 1 || p.K < 1 || p.N % 2 || (p.splits > 1 && p.k_chunk % BK))
    return cudaErrorInvalidValue;
  if (row_norm<Epi>::value && (p.N != BN || p.splits > 1 || p.partial))
    return cudaErrorInvalidValue;
  const ll tiles = (ll)p.m_tiles * p.n_tiles * p.splits;
  if (tiles > (1ll << 30)) return cudaErrorInvalidValue;
  auto kernel = gemm_kernel<Epi, TMA, A_K, B_K, TA>;
  static bool ready = false;  // the shared-memory opt-in, once per instantiation
  if (!ready) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  kernel<<<grid, threads<TMA>(), SMEM_BYTES, st>>>(ma, mb, a, b, p, epi);
  return cudaGetLastError();
}

}  // namespace gemm90
