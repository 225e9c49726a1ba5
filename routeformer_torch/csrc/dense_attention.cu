// K4: dense softmax attention for Hopper (sm_90a).
//
// Replaces routeformer_tpu/ops/flash_attention.py::flash_attention_bhle
// (Pallas kernel _flash_kernel, pallas_call in _flash_forward).
//
// Computes, for each of BH head-flattened rows b,
//   out[b] = softmax(q[b] k[b]^T * scale) v[b]
// on q (BH, Lq, E), k (BH, Lk, E), v (BH, Lk, Ev): scores, softmax and the
// p.v sum in f32, keys with col > row excluded when causal (row is the
// query's own index, top-left aligned when Lq != Lk), the output cast to
// the input type. E and Ev arrive padded with zeros to a multiple of 16
// (at most 128); the ragged Lq and Lk edges are masked here.
//
// Why the TPU design does not carry over: the TPU program keeps all of K and
// V of one row b in VMEM and makes one pass per 128-row query block. At the
// DinoV2 shape (L = 1369, E = 64, bf16) K and V take 350 KB, more than the
// 227 KB of shared memory a block can have. So K and V stream through shared
// memory in tiles of 64 keys (cp.async, double-buffered) and the softmax is
// online: a running row max m and sum l in f32; each tile's p = exp(s - m')
// adds into an f32 accumulator that is first rescaled by exp(m - m'); the
// output is acc / l. The TPU kernel normalises p before p.v; dividing after
// the sum changes the result by f32 roundings only (a few f32 ulps), far
// below one bf16 ulp of the output.
//
// bf16 inputs: q.k^T runs on the tensor cores (WMMA bf16 16x16x16, f32
// accumulate). Products of bf16 values are exact in f32, so this equals the
// TPU's f32 product of the same values up to summation order. p.v keeps p at
// f32 precision: p is split into a bf16 high part and a bf16 low part
// (p - high), and both go through the tensor cores against v, which is
// exactly bf16; the split represents p to 2^-17 of its value. f32 inputs take
// a scalar f32 FMA kernel (one key per lane).
//
// What bounds it on the H100: at the DinoV2 shape (BH 288, L 1369, E 64)
// one call does 4 BH L^2 E = 138.2 GFLOP on 201.9 MB of q, k, v and the
// output, 684 FLOP per byte, above the ~295 at which the bf16 tensor cores
// and not HBM set the pace: operations bound it, 0.140 ms at 989 TFLOP/s.
// (The hi/lo split doubles p.v's tensor-core work: this design's own floor
// is 0.210 ms.) This first version is simple, not fast: one CTA of four warps
// per (64-query tile, b), 16 query rows per warp, and S, P and the
// accumulator make a round trip through shared memory on every key tile
// (WMMA fragments have no row map for the rescale); no wgmma, TMA or warp
// specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // keys per K/V tile (bf16 kernel)
constexpr int FK = 32;  // keys per K/V tile (f32 kernel): one per lane
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_E = 128;
constexpr int LDS = BK + 4;  // f32 row stride of the score tile
constexpr int LDP = BK + 8;  // bf16 row stride of the P tiles

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes global -> shared; zeros when !valid (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + 64) of a (rows, width) bf16 matrix into shared memory
// with row stride ld; rows at or past n_rows are zeros. width % 8 == 0.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, int row0,
                                          int n_rows, int width) {
  const int chunks = width / 8;
  for (int idx = threadIdx.x; idx < 64 * chunks; idx += NTHREADS) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    const bool valid = row0 + r < n_rows;
    const bf16* g = valid ? src + (long long)(row0 + r) * width + c : src;
    cp_async16(dst + r * ld + c, g, valid);
  }
}

// Online-softmax update of one 16-row strip: takes the raw scores of a key
// tile, writes p = exp(s - m') as bf16 high and low parts, rescales the
// strip's accumulator rows by exp(m - m') and updates m and l.
template <int EV>
__device__ __forceinline__ void softmax_strip(const float* sw, bf16* phw, bf16* plw,
                                              float* ow, float* ms, float* ls, int lane,
                                              int q_row0, int k0, int lk, float scale,
                                              int causal) {
  constexpr int LDO = EV + 4;
  for (int r = 0; r < 16; ++r) {
    const int i = q_row0 + r;
    float s[2];
    bool ok[2];
    float mx = -INFINITY;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      const int col = k0 + c;
      ok[h] = col < lk && !(causal && col > i);
      s[h] = sw[r * LDS + c] * scale;
      if (ok[h]) mx = fmaxf(mx, s[h]);
    }
    mx = warp_max(mx);
    const float m_old = ms[r];
    const float m_new = fmaxf(m_old, mx);
    const bool any = m_new > -INFINITY;  // a key of this row seen so far
    const float alpha = any ? expf(m_old - m_new) : 1.f;
    float sum = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      const float p = (ok[h] && any) ? expf(s[h] - m_new) : 0.f;
      sum += p;
      const bf16 hi = __float2bfloat16(p);
      phw[r * LDP + c] = hi;
      plw[r * LDP + c] = __float2bfloat16(p - __bfloat162float(hi));
    }
    sum = warp_sum(sum);
    for (int c = lane; c < EV; c += 32) ow[r * LDO + c] *= alpha;
    __syncwarp();
    if (lane == 0) {
      ms[r] = m_new;
      ls[r] = ls[r] * alpha + sum;
    }
    __syncwarp();
  }
}

template <int EV>
__global__ void __launch_bounds__(NTHREADS)
dense_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int lq, int lk,
                     int e, int ev, float scale, int causal) {
  const int ldq = e + 8;  // bf16 row stride of the Q and K tiles
  constexpr int LDV = EV + 8;
  constexpr int LDO = EV + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // BQ x ldq
  bf16* ks = qs + BQ * ldq;                  // 2 x BK x ldq
  bf16* vs = ks + 2 * BK * ldq;              // 2 x BK x LDV
  float* ss = reinterpret_cast<float*>(vs + 2 * BK * LDV);  // BQ x LDS
  bf16* ph = reinterpret_cast<bf16*>(ss + BQ * LDS);        // BQ x LDP
  bf16* pl = ph + BQ * LDP;                                 // BQ x LDP
  float* os = reinterpret_cast<float*>(pl + BQ * LDP);      // BQ x LDO
  float* ms = os + BQ * LDO;                                // BQ
  float* ls = ms + BQ;                                      // BQ

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const long long b = blockIdx.y;
  const bf16* qb = q + b * lq * e;
  const bf16* kb = k + b * lk * e;
  const bf16* vb = v + b * lk * EV;
  const int row0 = warp * 16;

  // With causal, this tile's last row sees keys up to q0 + BQ - 1 only.
  const int n_keys = causal ? min(lk, q0 + BQ) : lk;
  const int n_tiles = (n_keys + BK - 1) / BK;

  load_tile(qs, ldq, qb, q0, lq, e);
  load_tile(ks, ldq, kb, 0, lk, e);
  load_tile(vs, LDV, vb, 0, lk, EV);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < BQ * LDO; idx += NTHREADS) os[idx] = 0.f;
  for (int idx = threadIdx.x; idx < BQ; idx += NTHREADS) {
    ms[idx] = -INFINITY;
    ls[idx] = 0.f;
  }

  float* sw = ss + row0 * LDS;
  bf16* phw = ph + row0 * LDP;
  bf16* plw = pl + row0 * LDP;
  float* ow = os + row0 * LDO;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // the next tile streams in while this one computes
      load_tile(ks + (buf ^ 1) * BK * ldq, ldq, kb, (t + 1) * BK, lk, e);
      load_tile(vs + (buf ^ 1) * BK * LDV, LDV, vb, (t + 1) * BK, lk, EV);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + buf * BK * ldq;
    const bf16* vt = vs + buf * BK * LDV;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < e / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + row0 * ldq + kk * 16, ldq);
        wmma::load_matrix_sync(fb, kt + (j * 16) * ldq + kk * 16, ldq);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sw + j * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    softmax_strip<EV>(sw, phw, plw, ow, ms + row0, ls + row0, lane, q0 + row0, t * BK, lk,
                      scale, causal);

    // acc += P_hi V + P_lo V.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[EV / 16];
#pragma unroll
    for (int c = 0; c < EV / 16; ++c)
      wmma::load_matrix_sync(oacc[c], ow + c * 16, LDO, wmma::mem_row_major);
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fh, fl;
      wmma::load_matrix_sync(fh, phw + kk * 16, LDP);
      wmma::load_matrix_sync(fl, plw + kk * 16, LDP);
#pragma unroll
      for (int c = 0; c < EV / 16; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, vt + (kk * 16) * LDV + c * 16, LDV);
        wmma::mma_sync(oacc[c], fh, fv, oacc[c]);
        wmma::mma_sync(oacc[c], fl, fv, oacc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < EV / 16; ++c)
      wmma::store_matrix_sync(ow + c * 16, oacc[c], LDO, wmma::mem_row_major);
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  for (int r = 0; r < 16; ++r) {
    const int i = q0 + row0 + r;
    if (i >= lq) break;
    const float l = ls[row0 + r];
    for (int c = lane; c < ev; c += 32)
      out[(b * lq + i) * ev + c] = __float2bfloat16(ow[r * LDO + c] / l);
  }
}

// f32 inputs: the same online softmax with scalar FMA. Each warp owns 16
// query rows; for a tile of 32 keys, lane j scores key j, and the p.v sum
// runs over the tile with p broadcast from its lane.
template <int EVC>  // 32-column chunks of Ev
__global__ void __launch_bounds__(NTHREADS)
dense_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, int lq, int lk,
                    int e, int ev_in, int ev, float scale, int causal) {
  constexpr int W = 32 * EVC;
  extern __shared__ __align__(16) float smf[];
  const int ldk = e + 1;
  float* qs = smf;              // BQ x e
  float* ks = qs + BQ * e;      // FK x ldk
  float* vs = ks + FK * ldk;    // FK x W

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const long long b = blockIdx.y;
  const float* qb = q + b * lq * e;
  const float* kb = k + b * lk * e;
  const float* vb = v + b * lk * ev_in;
  const int row0 = warp * 16;

  for (int idx = threadIdx.x; idx < BQ * e; idx += NTHREADS) {
    const int r = idx / e;
    qs[idx] = q0 + r < lq ? qb[(long long)(q0 + r) * e + idx % e] : 0.f;
  }
  float o[16][EVC], m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < EVC; ++c) o[r][c] = 0.f;
  }

  const int n_keys = causal ? min(lk, q0 + BQ) : lk;
  for (int k0 = 0; k0 < n_keys; k0 += FK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < FK * e; idx += NTHREADS) {
      const int j = idx / e, c = idx % e;
      ks[j * ldk + c] = k0 + j < lk ? kb[(long long)(k0 + j) * e + c] : 0.f;
    }
    for (int idx = threadIdx.x; idx < FK * W; idx += NTHREADS) {
      const int j = idx / W, c = idx % W;
      vs[idx] = (k0 + j < lk && c < ev_in) ? vb[(long long)(k0 + j) * ev_in + c] : 0.f;
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
      const float m_new = fmaxf(m[r], warp_max(ok ? s : -INFINITY));
      const bool any = m_new > -INFINITY;
      const float alpha = any ? expf(m[r] - m_new) : 1.f;
      const float p = (ok && any) ? expf(s - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
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

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int i = q0 + row0 + r;
    if (i < lq) {
#pragma unroll
      for (int c = 0; c < EVC; ++c) {
        const int cc = lane + 32 * c;
        if (cc < ev) out[(b * lq + i) * ev + cc] = o[r][c] / l[r];
      }
    }
  }
}

template <int EV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int bh,
                        int lq, int lk, int e, int ev, float scale, int causal,
                        cudaStream_t stream) {
  const size_t smem = (size_t)3 * BK * (e + 8) * sizeof(bf16) +
                      (size_t)2 * BK * (EV + 8) * sizeof(bf16) +
                      (size_t)BQ * LDS * sizeof(float) + (size_t)2 * BQ * LDP * sizeof(bf16) +
                      (size_t)BQ * (EV + 4) * sizeof(float) + (size_t)2 * BQ * sizeof(float);
  auto kernel = dense_attention_bf16<EV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + BQ - 1) / BQ, bh);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lq, lk, e, ev, scale, causal);
  return cudaGetLastError();
}

template <int EVC>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int bh,
                       int lq, int lk, int e, int ev_in, int ev, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BQ * e + (size_t)FK * (e + 1) + (size_t)FK * 32 * EVC);
  auto kernel = dense_attention_f32<EVC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + BQ - 1) / BQ, bh);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lq, lk, e, ev_in, ev, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// q (bh, lq, e), k (bh, lk, e), v (bh, lk, ev_pad) contiguous, all bf16
// (in_bf16 = 1) or all f32; e and ev_pad multiples of 16, at most 128, with
// zeros past the real widths. out: (bh, lq, ev) contiguous, the inputs' type.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rf_dense_attention(const void* q, const void* k, const void* v, void* out,
                                  int in_bf16, int bh, int lq, int lk, int e, int ev_pad,
                                  int ev, float scale, int causal, void* stream) {
  if (bh < 1 || bh > 65535 || lq < 1 || lk < 1 || e < 16 || e > MAX_E || e % 16 ||
      ev_pad < 16 || ev_pad > MAX_E || ev_pad % 16 || ev < 1 || ev > ev_pad)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!in_bf16) {
    switch ((ev_pad + 31) / 32) {
      case 1: return (int)launch_f32<1>(q, k, v, out, bh, lq, lk, e, ev_pad, ev, scale, causal, st);
      case 2: return (int)launch_f32<2>(q, k, v, out, bh, lq, lk, e, ev_pad, ev, scale, causal, st);
      case 3: return (int)launch_f32<3>(q, k, v, out, bh, lq, lk, e, ev_pad, ev, scale, causal, st);
      default: return (int)launch_f32<4>(q, k, v, out, bh, lq, lk, e, ev_pad, ev, scale, causal, st);
    }
  }
  switch (ev_pad) {
    case 16: return (int)launch_bf16<16>(q, k, v, out, bh, lq, lk, e, ev, scale, causal, st);
    case 32: return (int)launch_bf16<32>(q, k, v, out, bh, lq, lk, e, ev, scale, causal, st);
    case 48: return (int)launch_bf16<48>(q, k, v, out, bh, lq, lk, e, ev, scale, causal, st);
    case 64: return (int)launch_bf16<64>(q, k, v, out, bh, lq, lk, e, ev, scale, causal, st);
    case 80: return (int)launch_bf16<80>(q, k, v, out, bh, lq, lk, e, ev, scale, causal, st);
    case 96: return (int)launch_bf16<96>(q, k, v, out, bh, lq, lk, e, ev, scale, causal, st);
    case 112: return (int)launch_bf16<112>(q, k, v, out, bh, lq, lk, e, ev, scale, causal, st);
    default: return (int)launch_bf16<128>(q, k, v, out, bh, lq, lk, e, ev, scale, causal, st);
  }
}
