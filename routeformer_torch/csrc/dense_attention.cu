// K4: dense softmax attention for Hopper (sm_90a).
//
// Replaces routeformer_tpu/ops/flash_attention.py::flash_attention_bhle
// (Pallas kernel _flash_kernel, pallas_call in _flash_forward).
//
// Computes, for each batch row b and head h,
//   out[b, h] = softmax(q[b, h] k[b, h]^T * scale) v[b, h]
// on q (Lq, E), k (Lk, E), v (Lk, Ev) reached through (batch, head, token)
// element strides with unit stride along E, so the ViT's strided views of its
// qkv rows are read in place and the output is written into a (B, L, H, Ev)
// buffer. Scores, softmax and the p.v sum are f32; keys with col > row are
// excluded when causal (row is the query's own index, top-left aligned when
// Lq != Lk); the ragged Lq and Lk edges are masked here; the output has the
// inputs' type.
//
// What bounds it on the H100: at the DinoV2 shape (BH 288, L 1369, E 64,
// bf16) one call does 4 BH L^2 E = 138.2 GFLOP on 201.9 MB of q, k, v and
// the output, 684 FLOP per byte, above the ~295 at which the bf16 tensor
// cores and not HBM set the pace: operations bound it, 0.140 ms at 989
// TFLOP/s. p.v keeps p at f32 precision as the TPU does: p = p_hi + p_lo in
// bf16 (2^-17 of p), both against v, which is exactly bf16; products of bf16
// values are exact in f32. So the tensor cores do 207 GFLOP, a floor of
// 0.210 ms, and the 540 M exponentials take ~0.15 ms on the special function
// units (16 per SM per clock): they must overlap the products.
//
// The design: one CTA of two consumer warpgroups (256 threads) owns 128
// query rows, 64 per warpgroup. K and V stream through a two-stage ring of
// 64-key tiles in shared memory (cp.async; the next tile's copy overlaps this
// tile's products), stored 128-byte swizzled as wgmma's descriptors read
// them (a row of 64 bf16 is one 128-byte swizzle row; E or Ev up to 128 take
// two panels). Per tile and warpgroup:
//   S = Q K^T   wgmma m64n64k16, Q and K K-major from shared memory;
//   the online softmax on S in registers: each thread holds 2 rows of the
//   accumulator (the mma C layout), a row max is 2 quad shuffles, the row sum
//   stays per thread until the end; exp(m - m') rescales O in place;
//   O += P_hi V + P_lo V   wgmma m64n64k16 with A in registers (P packed
//   from the S registers) and V as the MN-major B operand.
// S, P and O never leave registers; the output is O / l. Causal tiles past a
// warpgroup's last row are skipped. What it does not do yet: warp
// specialisation with a TMA producer, and overlapping one warpgroup's
// softmax with its own next products (the two warpgroups and the second CTA
// on an SM overlap each other's).
//
// f32 inputs take a scalar f32 FMA kernel (one key per lane, online softmax):
// no path runs it at speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_frag.cuh"

using namespace attn;

namespace {

constexpr int BQ = 128;  // query rows per CTA (bf16 kernel): two warpgroups of 64
constexpr int BK = 64;   // keys per K/V tile (bf16 kernel)
constexpr int NTHREADS = 256;
constexpr int ROW_BYTES = 128;  // one swizzled row of a 64-wide bf16 panel
constexpr int FQ = 64;          // query rows per CTA (f32 kernel)
constexpr int FK = 32;          // keys per tile (f32 kernel): one per lane
constexpr int F_THREADS = 128;
constexpr int MAX_E = 128;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {  // elements between batch rows, heads and tokens
  long long b, h, t;
};

// ---------------------------------------------------------------- wgmma --- //

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
// K-major operands: LBO unused (1), SBO = 1024 bytes between 8-row groups.
// MN-major operands: LBO = bytes between 64-wide panels, SBO = 1024 bytes
// between groups of 8 rows along K.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a wgmma.
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define RF_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define RF_D32_OPS(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d = A B (accumulate = 0) or d += A B: m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RF_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RF_D32_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B: m64n64k16, A (this warp's 16 rows) in registers, B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RF_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RF_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------ bf16 kernel --- //

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Rows [row0, row0 + ROWS) of a bf16 matrix (row stride `stride`, `width`
// real columns, width % 8 == 0) into P swizzled 64-column panels of ROWS
// rows each: 16-byte chunk c of row r lands at chunk (c % 8) ^ (r % 8) of
// the row in panel c / 8. Rows past n_rows and columns past width are zeros.
template <int P, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src, long long stride,
                                          int row0, int n_rows, int width) {
  constexpr int CH = P * 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool valid = row0 + r < n_rows && c * 8 < width;
    const bf16* g = valid ? src + (long long)(row0 + r) * stride + c * 8 : src;
    cp_async16(dst + (c / 8) * ROWS * ROW_BYTES + r * ROW_BYTES + (((c & 7) ^ (r & 7)) << 4), g,
               valid);
  }
}

template <int EP, int EVP>
__global__ void __launch_bounds__(NTHREADS, EVP == 64 ? 2 : 1)
dense_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, Strides sq, Strides sk,
                     Strides sv, Strides so, int lq, int lk, int e, int ev, float scale_log2,
                     int causal) {
  constexpr int QP = EP / 64, VP = EVP / 64;  // 64-column panels
  constexpr int Q_BYTES = BQ * EP * 2, K_BYTES = BK * EP * 2, V_BYTES = BK * EVP * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);  // swizzle atoms sit on 1024-byte lines
  unsigned char* ks = qs + Q_BYTES;         // two stages
  unsigned char* vs = ks + 2 * K_BYTES;     // two stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int warp_row0 = q0 + 64 * wg + 16 * (warp % 4);  // this warp's first row
  const int wg_last_row = q0 + 64 * wg + 63;

  // With causal, this tile's last row sees keys up to q0 + BQ - 1 only.
  const int n_keys = causal ? min(lk, q0 + BQ) : lk;
  const int n_tiles = (n_keys + BK - 1) / BK;

  load_tile<QP, BQ>(qs, qb, sq.t, q0, lq, e);
  load_tile<QP, BK>(ks, kb, sk.t, 0, lk, e);
  load_tile<VP, BK>(vs, vb, sv.t, 0, lk, ev);
  cp_async_commit();

  float o[VP][32];
#pragma unroll
  for (int p = 0; p < VP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // row max of the log2-scaled scores
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sum

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // the next tile streams in while this one computes
      load_tile<QP, BK>(ks + (buf ^ 1) * K_BYTES, kb, sk.t, (t + 1) * BK, lk, e);
      load_tile<VP, BK>(vs + (buf ^ 1) * V_BYTES, vb, sv.t, (t + 1) * BK, lk, ev);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();  // the copies are visible to wgmma
    __syncthreads();
    const int k0 = t * BK;
    if (!causal || k0 <= wg_last_row) {  // uniform over the warpgroup
      const unsigned char* kt = ks + buf * K_BYTES;
      const unsigned char* vt = vs + buf * V_BYTES;

      // S = Q K^T for this warpgroup's 64 rows and the tile's 64 keys.
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < EP / 16; ++kk) {
        const int off = (kk / 4) * BQ * ROW_BYTES + (kk % 4) * 32;
        const uint64_t da = desc_sw128(qs + off + wg * 64 * ROW_BYTES, 16, 1024);
        const uint64_t db =
            desc_sw128(kt + (kk / 4) * BK * ROW_BYTES + (kk % 4) * 32, 16, 1024);
        wgmma_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // Online softmax in the log2 domain; masks only on edge tiles.
      const bool edge = k0 + BK > lk || (causal && k0 + BK - 1 > warp_row0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float x = s[i] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          const int row = warp_row0 + g + 8 * r;
          if (col >= lk || (causal && col > row)) x = -INFINITY;
        }
        s[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no key of the row seen yet
        alpha[r] = exp2_approx(m_run[r] - m_use[r]);
        m_run[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2_approx(s[i] - m_use[r]);
        rs[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
      for (int p = 0; p < VP; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[p][i] *= alpha[(i >> 1) & 1];

      // O += P_hi V + P_lo V, P from the S registers.
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a_split(s, kk, ph[kk], pl[kk]);
#pragma unroll
      for (int p = 0; p < VP; ++p) fence_regs(o[p]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < VP; ++p) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = desc_sw128(vt + p * BK * ROW_BYTES + kk * 16 * ROW_BYTES,
                                         BK * ROW_BYTES, 1024);
          wgmma_rs(o[p], ph[kk], db);
          wgmma_rs(o[p], pl[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < VP; ++p) fence_regs(o[p]);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  bf16* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp_row0 + g + 8 * r;
    const float inv = 1.f / quad_sum(l_run[r]);
    if (row >= lq) continue;
#pragma unroll
    for (int p = 0; p < VP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * p + 8 * j + 2 * t4;
        if (col < ev)
          *reinterpret_cast<__nv_bfloat162*>(ob + row * so.t + col) =
              __floats2bfloat162_rn(o[p][4 * j + 2 * r] * inv, o[p][4 * j + 2 * r + 1] * inv);
      }
  }
}

// ------------------------------------------------------------- f32 kernel --- //

// f32 inputs: the same online softmax with scalar FMA. Each warp owns 16
// query rows; for a tile of 32 keys, lane j scores key j, and the p.v sum
// runs over the tile with p broadcast from its lane.
template <int EVC>  // 32-column chunks of Ev
__global__ void __launch_bounds__(F_THREADS)
dense_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, Strides sq,
                    Strides sk, Strides sv, Strides so, int lq, int lk, int e, int ev,
                    float scale, int causal) {
  constexpr int W = 32 * EVC;
  extern __shared__ __align__(16) float smf[];
  const int ldk = e + 1;
  float* qs = smf;            // FQ x e
  float* ks = qs + FQ * e;    // FK x ldk
  float* vs = ks + FK * ldk;  // FK x W

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * FQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int row0 = warp * 16;

  for (int idx = threadIdx.x; idx < FQ * e; idx += F_THREADS) {
    const int r = idx / e;
    qs[idx] = q0 + r < lq ? qb[(long long)(q0 + r) * sq.t + idx % e] : 0.f;
  }
  float o[16][EVC], m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < EVC; ++c) o[r][c] = 0.f;
  }

  const int n_keys = causal ? min(lk, q0 + FQ) : lk;
  for (int k0 = 0; k0 < n_keys; k0 += FK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < FK * e; idx += F_THREADS) {
      const int j = idx / e, c = idx % e;
      ks[j * ldk + c] = k0 + j < lk ? kb[(long long)(k0 + j) * sk.t + c] : 0.f;
    }
    for (int idx = threadIdx.x; idx < FK * W; idx += F_THREADS) {
      const int j = idx / W, c = idx % W;
      vs[idx] = (k0 + j < lk && c < ev) ? vb[(long long)(k0 + j) * sv.t + c] : 0.f;
    }
    __syncthreads();
    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = q0 + row0 + r;
      const float* qr = qs + (row0 + r) * e;
      float s = 0.f;
      for (int c = 0; c < e; ++c) s = fmaf(qr[c], ks[lane * ldk + c], s);
      s *= scale;
      const bool ok = col < lk && !(causal && col > i);
      float mx = ok ? s : -INFINITY;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
      const float m_new = fmaxf(m[r], mx);
      const bool any = m_new > -INFINITY;
      const float alpha = any ? expf(m[r] - m_new) : 1.f;
      const float p = (ok && any) ? expf(s - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, d);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < EVC; ++c) o[r][c] *= alpha;
      for (int j = 0; j < FK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < EVC; ++c) o[r][c] = fmaf(pj, vs[j * W + lane + 32 * c], o[r][c]);
      }
    }
  }

  float* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int i = q0 + row0 + r;
    if (i < lq) {
#pragma unroll
      for (int c = 0; c < EVC; ++c) {
        const int cc = lane + 32 * c;
        if (cc < ev) ob[(long long)i * so.t + cc] = o[r][c] / l[r];
      }
    }
  }
}

// ---------------------------------------------------------------- launch --- //

struct Args {
  const void *q, *k, *v;
  void* out;
  Strides sq, sk, sv, so;
  int batch, heads, lq, lk, e, ev;
  float scale;
  int causal;
};

template <int EP, int EVP>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const size_t smem = 1024 + (size_t)BQ * EP * 2 + (size_t)2 * BK * EP * 2 +
                      (size_t)2 * BK * EVP * 2;
  auto kernel = dense_attention_bf16<EP, EVP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lq + BQ - 1) / BQ, a.heads, a.batch);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.sq, a.sk, a.sv, a.so, a.lq,
      a.lk, a.e, a.ev, a.scale * LOG2E, a.causal);
  return cudaGetLastError();
}

template <int EVC>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)FQ * a.e + (size_t)FK * (a.e + 1) + (size_t)FK * 32 * EVC);
  auto kernel = dense_attention_f32<EVC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lq + FQ - 1) / FQ, a.heads, a.batch);
  kernel<<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.sq, a.sk, a.sv, a.so, a.lq,
      a.lk, a.e, a.ev, a.scale, a.causal);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// q (batch, heads, lq, e), k (.., lk, e), v (.., lk, ev) and out (.., lq, ev),
// each given by its (batch, head, token) element strides with unit stride
// along the last dimension; all bf16 (in_bf16 = 1) or all f32. bf16 needs e
// and ev multiples of 8, q/k/v rows on 16-byte boundaries and out rows on
// 4-byte ones. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rf_dense_attention(const void* q, const void* k, const void* v, void* out,
                                  int in_bf16, int batch, int heads, int lq, int lk, int e,
                                  int ev, long long q_b, long long q_h, long long q_t,
                                  long long k_b, long long k_h, long long k_t, long long v_b,
                                  long long v_h, long long v_t, long long o_b, long long o_h,
                                  long long o_t, float scale, int causal, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || lq < 1 || lk < 1 || e < 1 ||
      e > MAX_E || ev < 1 || ev > MAX_E)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, {q_b, q_h, q_t}, {k_b, k_h, k_t}, {v_b, v_h, v_t},
               {o_b, o_h, o_t}, batch, heads, lq, lk, e, ev, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!in_bf16) {
    switch ((ev + 31) / 32) {
      case 1: return (int)launch_f32<1>(a, st);
      case 2: return (int)launch_f32<2>(a, st);
      case 3: return (int)launch_f32<3>(a, st);
      default: return (int)launch_f32<4>(a, st);
    }
  }
  const long long in_strides[9] = {q_b, q_h, q_t, k_b, k_h, k_t, v_b, v_h, v_t};
  for (long long s : in_strides)
    if (s % 8) return (int)cudaErrorInvalidValue;
  if (e % 8 || ev % 8 || !aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16) ||
      !aligned(out, 4) || o_b % 2 || o_h % 2 || o_t % 2)
    return (int)cudaErrorInvalidValue;
  if (e <= 64) return (int)(ev <= 64 ? launch_bf16<64, 64>(a, st) : launch_bf16<64, 128>(a, st));
  return (int)(ev <= 64 ? launch_bf16<128, 64>(a, st) : launch_bf16<128, 128>(a, st));
}
