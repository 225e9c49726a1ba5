// K3a / K3b: one Perceive encoder layer, forward and backward, for Hopper
// (sm_90a).
//
// Replaces routeformer_tpu/ops/fusion_stack.py: K3a the forward kernel
// _fwd_kernel (eval call: all N layers in one pallas_call; train: one call
// per layer), K3b the per-layer backward _bwd_layer_kernel. The TPU kernels
// keep a chunk of rows, the whole layer's weights and the (C, H, L, L) score
// tensors in VMEM, which holds many megabytes. An H100 block has 227 KB of
// shared memory, so here a layer is a short pipeline over all rows at once:
//
//   forward (rf_perceive_layer_fwd, also the backward's recompute)
//     qkv = x Wq|Wk|Wv + b                       gemm (3 launches)
//     att = ProbSparse attention per (row, head) attn_fwd_kernel
//     x1  = x + drop(att Wout + bout)             gemm, residual epilogue
//     xn1 = LN1(x1)                               layernorm_kernel
//     a1  = drop(gelu(xn1 Wff1 + bff1)), f1 kept  gemm, act epilogue
//     z   = xn1 + drop(a1 Wff2 + bff2)            gemm
//     y   = LN2(z)                                layernorm_kernel
//   backward (rf_perceive_layer_bwd): the _layer_bwd chain; the weight grads
//     are X^T dY products split over row chunks and summed with f32 atomics,
//     the bias and norm grads are column sums over all rows.
//
// The attention core runs one block per (row, head): q, k, v of the head and
// the L x L score tile sit in shared memory (L = 160 takes 137 KB forward and
// 148 KB backward). The sparsity measure needs no gathers: the sampled sum
// is the row sum of cnt * qk and the sampled max the max over cnt > 0; the
// top-u selection is the rank test #{j : M_j > M_i} < u, ties kept.
//
// Numerics are the TPU kernel's: matmul operands rounded to bf16 (or f32
// when bf16 == 0) with f32 accumulation; p.v and the mean-V context in f32;
// residual stream, LayerNorms (fast variance, eps 1e-6) and softmax in f32;
// gelu through XLA's rational erf.
//
// What bounds it: the layer's GEMMs carry 2 M (4 D^2 + 2 D F) FLOPs, the
// attention 4 M L D; the bytes are the rows in and out. At the flagship
// shapes it is bound by operations. This first version is simple, not fast:
// the GEMM stages its tiles with plain loads from any strides (one kernel
// serves X W, dY W^T and X^T dY), computes on bf16 tensor cores with WMMA
// 16x16x16 (or f32 FMA), and every intermediate makes a round trip through
// device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef long long ll;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN_EPS = 1e-6f;
constexpr int BM = 64, BN = 64, BK = 32, GEMM_THREADS = 128;
constexpr int LDA_H = BK + 8;  // bf16 tiles
constexpr int LDB_H = BN + 8;
constexpr int LDA_F = BK + 1;  // f32 tiles
constexpr int LDB_F = BN + 4;
constexpr int LDC_S = BN + 4;
constexpr int GEMM_SMEM = BM * LDC_S * 4;  // the largest of the three layouts
constexpr int SPLIT_K = 1024;              // rows per block of an X^T dY product
constexpr int ATT_THREADS = 256;

// ------------------------------------------------------------ elementwise

__device__ __forceinline__ float erf_rational(float x) {
  x = fminf(fmaxf(x, -4.f), 4.f);
  const float x2 = x * x;
  float p = 0.00022905065861350646f;
  p = p * x2 + 0.0034082910107109506f;
  p = p * x2 + 0.050955695062380861f;
  p = p * x2 + 0.18520832239976145f;
  p = p * x2 + 1.128379143519084f;
  float q = -1.1791602954361697e-7f;
  q = q * x2 + 0.000023547966471313185f;
  q = q * x2 + 0.0010179625278914885f;
  q = q * x2 + 0.014070470171167667f;
  q = q * x2 + 0.11098505178285362f;
  q = q * x2 + 0.49746925110067538f;
  q = q * x2 + 1.0f;
  return x * p / q;
}

constexpr float SQRT2 = 1.41421356237309515f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;

__device__ __forceinline__ float act_fwd(float x, int act) {
  if (act == 2) return fmaxf(x, 0.f);
  return x * 0.5f * (1.f + erf_rational(x / SQRT2));
}

__device__ __forceinline__ float act_grad(float x, int act) {
  if (act == 2) return x > 0.f ? 1.f : 0.f;
  const float phi = expf(-0.5f * x * x) * INV_SQRT_2PI;
  const float cdf = 0.5f * (1.f + erf_rational(x / SQRT2));
  return cdf + x * phi;
}

__device__ __forceinline__ float round_to(float v, int bf16_mode) {
  return bf16_mode ? __bfloat162float(__float2bfloat16(v)) : v;
}

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

// ------------------------------------------------------------------ GEMM
//
// C[m, n] = epilogue(sum_k A(m, k) B(k, n)), A(m, k) = A[m sam + k sak],
// B(k, n) = B[k sbk + n sbn], both f32 in memory and rounded to the compute
// type as they are staged. Epilogue, in this order: + bias[n]; pre[m, n] =
// v; v = act(v); v = v * mask[m, n] * keep; v = v * act'(aux[m, n]);
// v = res[m, n] + v. mask, aux, res and pre share C's row stride. With
// accumulate, the block's partial sum over its k range is atomically added
// to C and no epilogue runs (split-K over the rows of an X^T dY product).

struct Epi {
  const float* bias;
  float* pre;
  int act;
  const int8_t* mask;
  float keep;
  const float* aux;
  int aux_act;
  const float* res;
  int accumulate;
};

template <bool BF16>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const float* __restrict__ A, ll sam, ll sak,
            const float* __restrict__ B, ll sbk, ll sbn, float* C, ll ldc,
            int M, int N, int K, int k_chunk, Epi e) {
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const bool a_kfast = sak == 1;
  const bool b_nfast = sbn == 1;

  // BF16: 4 warps in 2 x 2, each 32 x 32 of WMMA fragments.
  // F32:  16 x 8 threads, each 8 rows x 4 columns.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  float facc[8][4];
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int ty = tid / 16, tx = tid % 16;
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += GEMM_THREADS) {
      int r, c;
      if (a_kfast) { r = idx / BK; c = idx % BK; } else { r = idx % BM; c = idx / BM; }
      const int gm = m0 + r, gk = k0 + c;
      const float v = (gm < M && gk < kend) ? A[gm * sam + (ll)gk * sak] : 0.f;
      if constexpr (BF16)
        reinterpret_cast<bf16*>(smem)[r * LDA_H + c] = __float2bfloat16(v);
      else
        reinterpret_cast<float*>(smem)[r * LDA_F + c] = v;
    }
    for (int idx = tid; idx < BK * BN; idx += GEMM_THREADS) {
      int r, c;
      if (b_nfast) { r = idx / BN; c = idx % BN; } else { r = idx % BK; c = idx / BK; }
      const int gk = k0 + r, gn = n0 + c;
      const float v = (gk < kend && gn < N) ? B[(ll)gk * sbk + gn * sbn] : 0.f;
      if constexpr (BF16)
        reinterpret_cast<bf16*>(smem)[BM * LDA_H + r * LDB_H + c] = __float2bfloat16(v);
      else
        reinterpret_cast<float*>(smem)[BM * LDA_F + r * LDB_F + c] = v;
    }
    __syncthreads();
    if constexpr (BF16) {
      const bf16* as = reinterpret_cast<const bf16*>(smem);
      const bf16* bs = as + BM * LDA_H;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], as + (wm + 16 * i) * LDA_H + kk, LDA_H);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], bs + kk * LDB_H + wn + 16 * j, LDB_H);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    } else {
      const float* as = reinterpret_cast<const float*>(smem);
      const float* bs = as + BM * LDA_F;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = as[(ty * 8 + i) * LDA_F + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[kk * LDB_F + tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
      }
    }
    __syncthreads();
  }

  float* cs = reinterpret_cast<float*>(smem);
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wm + 16 * i) * LDC_S + wn + 16 * j,
                                acc[i][j], LDC_S, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[(ty * 8 + i) * LDC_S + tx * 4 + j] = facc[i][j];
  }
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const ll o = gm * ldc + gn;
    float v = cs[r * LDC_S + c];
    if (e.accumulate) {
      atomicAdd(C + o, v);
      continue;
    }
    if (e.bias) v += e.bias[gn];
    if (e.pre) e.pre[o] = v;
    if (e.act) v = act_fwd(v, e.act);
    if (e.mask) v = v * (float)e.mask[o] * e.keep;
    if (e.aux) v = v * act_grad(e.aux[o], e.aux_act);
    if (e.res) v = e.res[o] + v;
    C[o] = v;
  }
}

// ------------------------------------------------------------- row passes

// out = LN(x) per row, one warp per row.
__global__ void layernorm_kernel(const float* __restrict__ x,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out, int M, int D) {
  const int lane = threadIdx.x % 32;
  const ll row = (ll)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const float* xr = x + row * D;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = xr[c];
    s += v;
    ss += v * v;
  }
  const float mu = warp_sum(s) / D;
  const float var = fmaxf(warp_sum(ss) / D - mu * mu, 0.f);
  const float inv = rsqrtf(var + LN_EPS);
  for (int c = lane; c < D; c += 32)
    out[row * D + c] = (xr[c] - mu) * inv * scale[c] + bias[c];
}

// Backward of LN at input x with upstream g: dx per row, and optionally
// dxm = dx * mask * keep; dscale += sum g * xhat, dbias += sum g over rows
// (block partial sums in shared memory, then one atomic per column).
__global__ void layernorm_bwd_kernel(const float* __restrict__ x,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ g,
                                     float* __restrict__ dx, float* __restrict__ dxm,
                                     const int8_t* __restrict__ mask, float keep,
                                     float* __restrict__ dscale,
                                     float* __restrict__ dbias, int M, int D) {
  extern __shared__ float part[];  // 2 D
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) part[c] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  for (ll row = (ll)blockIdx.x * nwarps + warp; row < M; row += (ll)gridDim.x * nwarps) {
    const float* xr = x + row * D;
    const float* gr = g + row * D;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = xr[c];
      s += v;
      ss += v * v;
    }
    const float mu = warp_sum(s) / D;
    const float var = fmaxf(warp_sum(ss) / D - mu * mu, 0.f);
    const float inv = rsqrtf(var + LN_EPS);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float xhat = (xr[c] - mu) * inv;
      const float gs = gr[c] * scale[c];
      s1 += gs;
      s2 += gs * xhat;
      atomicAdd(part + c, gr[c] * xhat);
      atomicAdd(part + D + c, gr[c]);
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    for (int c = lane; c < D; c += 32) {
      const float xhat = (xr[c] - mu) * inv;
      const float gs = gr[c] * scale[c];
      const float v = (gs - m1 - xhat * m2) * inv;
      dx[row * D + c] = v;
      if (dxm) dxm[row * D + c] = mask ? v * (float)mask[row * D + c] * keep : v;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    atomicAdd(dscale + c, part[c]);
    atomicAdd(dbias + c, part[D + c]);
  }
}

// out[c] += sum over rows of in[r * ld + c], c < N.
__global__ void colsum_kernel(const float* __restrict__ in, ll ld,
                              float* __restrict__ out, int M, int N, int rows) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  const ll r0 = (ll)blockIdx.y * rows;
  const ll r1 = min((ll)M, r0 + rows);
  float s = 0.f;
  for (ll r = r0; r < r1; ++r) s += in[r * ld + c];
  atomicAdd(out + c, s);
}

// --------------------------------------------------------- attention core
//
// One block per (row, head). Shared memory: q, k (rounded to the compute
// type), v (f32) and, backward only, g, each L x (dh + 1); the score tile
// L x (L + 1); the measure and the selection, L each.

struct AttnSmem {
  float *q, *k, *v, *g, *s, *meas, *sel;
  int dhp, lp;
};

__device__ __forceinline__ AttnSmem attn_layout(float* base, int L, int dh, bool with_g) {
  AttnSmem a;
  a.dhp = dh + 1;
  a.lp = L + 1;
  a.q = base;
  a.k = a.q + L * a.dhp;
  a.v = a.k + L * a.dhp;
  a.g = a.v + L * a.dhp;
  a.s = a.g + (with_g ? L * a.dhp : 0);
  a.meas = a.s + L * a.lp;
  a.sel = a.meas + L;
  return a;
}

__device__ void attn_load(const AttnSmem& a, const float* __restrict__ qkv,
                          const float* __restrict__ gin, int row, int h, int L,
                          int D, int dh, int bf16_mode) {
  for (int idx = threadIdx.x; idx < L * dh; idx += blockDim.x) {
    const int i = idx / dh, e = idx % dh;
    const ll base = ((ll)row * L + i) * 3 * D + h * dh + e;
    a.q[i * a.dhp + e] = round_to(qkv[base], bf16_mode);
    a.k[i * a.dhp + e] = round_to(qkv[base + D], bf16_mode);
    a.v[i * a.dhp + e] = qkv[base + 2 * D];
    if (gin) a.g[i * a.dhp + e] = gin[((ll)row * L + i) * D + h * dh + e];
  }
  __syncthreads();
}

// Scores, the sparsity measure, the rank-test selection and the f32
// softmax (left in a.s).
__device__ void attn_probs(const AttnSmem& a, const float* __restrict__ cnt,
                           int L, int dh, int u, float scale) {
  for (int idx = threadIdx.x; idx < L * L; idx += blockDim.x) {
    const int i = idx / L, j = idx % L;
    float acc = 0.f;
    for (int e = 0; e < dh; ++e) acc = fmaf(a.q[i * a.dhp + e], a.k[j * a.dhp + e], acc);
    a.s[i * a.lp + j] = acc;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  for (int i = warp; i < L; i += nwarps) {
    float sum = 0.f, mx = NEG_INF;
    for (int j = lane; j < L; j += 32) {
      const float c = cnt[(ll)i * L + j];
      const float qk = a.s[i * a.lp + j];
      sum += qk * c;
      if (c > 0.f) mx = fmaxf(mx, qk);
    }
    sum = warp_sum(sum);
    mx = warp_max(mx);
    if (lane == 0) a.meas[i] = mx - sum / (float)L;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const float mi = a.meas[i];
    int rank = 0;
    for (int j = 0; j < L; ++j) rank += mi < a.meas[j];
    a.sel[i] = rank < u ? 1.f : 0.f;
  }
  for (int i = warp; i < L; i += nwarps) {
    float mx = NEG_INF;
    for (int j = lane; j < L; j += 32) mx = fmaxf(mx, a.s[i * a.lp + j] * scale);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(a.s[i * a.lp + j] * scale - mx);
      a.s[i * a.lp + j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) a.s[i * a.lp + j] = a.s[i * a.lp + j] / sum;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(ATT_THREADS)
attn_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ cnt,
                float* __restrict__ att, int8_t* __restrict__ sel_out, int L, int D,
                int H, int u, float scale, int bf16_mode) {
  extern __shared__ float smem_f[];
  const int row = blockIdx.x, h = blockIdx.y, dh = D / H;
  const AttnSmem a = attn_layout(smem_f, L, dh, false);
  attn_load(a, qkv, nullptr, row, h, L, D, dh, bf16_mode);
  attn_probs(a, cnt, L, dh, u, scale);
  if (sel_out)
    for (int i = threadIdx.x; i < L; i += blockDim.x)
      sel_out[((ll)row * H + h) * L + i] = a.sel[i] != 0.f;
  for (int idx = threadIdx.x; idx < L * dh; idx += blockDim.x) {
    const int i = idx / dh, e = idx % dh;
    float acc = 0.f;
    if (a.sel[i] != 0.f) {
      for (int j = 0; j < L; ++j) acc = fmaf(a.s[i * a.lp + j], a.v[j * a.dhp + e], acc);
    } else {
      for (int j = 0; j < L; ++j) acc += a.v[j * a.dhp + e];
      acc = acc / (float)L;
    }
    att[((ll)row * L + i) * D + h * dh + e] = acc;
  }
}

// dq, dk, dv of one (row, head) into dqkv (M, 3D) from datt (M, D).
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ datt,
                const float* __restrict__ cnt, float* __restrict__ dqkv, int L,
                int D, int H, int u, float scale, int bf16_mode) {
  extern __shared__ float smem_f[];
  const int row = blockIdx.x, h = blockIdx.y, dh = D / H;
  const AttnSmem a = attn_layout(smem_f, L, dh, true);
  attn_load(a, qkv, datt, row, h, L, D, dh, bf16_mode);
  attn_probs(a, cnt, L, dh, u, scale);
  const ll col = h * dh;
  // dv[j] = sum_i p[i, j] g_upd[i] + (1 / L) sum_i g_ctx[i]
  for (int idx = threadIdx.x; idx < L * dh; idx += blockDim.x) {
    const int j = idx / dh, e = idx % dh;
    float upd = 0.f, ctx = 0.f;
    for (int i = 0; i < L; ++i) {
      const float gi = a.g[i * a.dhp + e];
      if (a.sel[i] != 0.f) upd = fmaf(a.s[i * a.lp + j], gi, upd);
      else ctx += gi;
    }
    dqkv[((ll)row * L + j) * 3 * D + 2 * D + col + e] = upd + ctx / (float)L;
  }
  __syncthreads();
  // ds = p (dp - sum_j dp p), dp = g_upd v^T; dqk = ds * scale, rounded.
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  for (int i = warp; i < L; i += nwarps) {
    const bool sel = a.sel[i] != 0.f;
    float rs = 0.f;
    if (sel) {
      for (int j = lane; j < L; j += 32) {
        float dp = 0.f;
        for (int e = 0; e < dh; ++e) dp = fmaf(a.g[i * a.dhp + e], a.v[j * a.dhp + e], dp);
        rs += dp * a.s[i * a.lp + j];
      }
    }
    rs = warp_sum(rs);
    for (int j = lane; j < L; j += 32) {
      float dp = 0.f;
      if (sel)
        for (int e = 0; e < dh; ++e) dp = fmaf(a.g[i * a.dhp + e], a.v[j * a.dhp + e], dp);
      const float ds = a.s[i * a.lp + j] * (dp - rs);
      a.s[i * a.lp + j] = round_to(ds * scale, bf16_mode);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < L * dh; idx += blockDim.x) {
    const int i = idx / dh, e = idx % dh;
    float dq = 0.f, dk = 0.f;
    for (int j = 0; j < L; ++j) {
      dq = fmaf(a.s[i * a.lp + j], a.k[j * a.dhp + e], dq);
      dk = fmaf(a.s[j * a.lp + i], a.q[j * a.dhp + e], dk);
    }
    const ll o = ((ll)row * L + i) * 3 * D + col + e;
    dqkv[o] = dq;
    dqkv[o + D] = dk;
  }
}

size_t attn_smem_bytes(int L, int dh, bool with_g) {
  return sizeof(float) * ((size_t)(with_g ? 4 : 3) * L * (dh + 1) +
                          (size_t)L * (L + 1) + 2 * (size_t)L);
}

// ------------------------------------------------------------- the layer

struct Layer {
  const float* const* w;  // wq bq wk bk wv bv wout bout g1 b1 wff1 bff1 wff2 bff2 g2 b2
  const float* cnt;
  const int8_t *m1, *m2, *m3;
  float keep;
  int R, L, D, F, H, u, act, bf16;
  cudaStream_t st;
  ll M() const { return (ll)R * L; }
};

struct Work {  // offsets into the float workspace
  float *qkv, *att, *x1, *xn1, *f1, *a1, *z;
  float *dz, *df2, *df1, *dxn1, *dx1, *dnew, *datt, *dqkv;
};

Work carve(float* ws, ll M, ll D, ll F) {
  Work w;
  w.qkv = ws;
  w.att = w.qkv + 3 * M * D;
  w.x1 = w.att + M * D;
  w.xn1 = w.x1 + M * D;
  w.f1 = w.xn1 + M * D;
  w.a1 = w.f1 + M * F;
  w.z = w.a1 + M * F;
  w.dz = w.z + M * D;
  w.df2 = w.dz + M * D;
  w.df1 = w.df2 + M * D;
  w.dxn1 = w.df1 + M * F;
  w.dx1 = w.dxn1 + M * D;
  w.dnew = w.dx1 + M * D;
  w.datt = w.dnew + M * D;
  w.dqkv = w.datt + M * D;
  return w;
}

Epi epi() {
  Epi e;
  e.bias = nullptr;
  e.pre = nullptr;
  e.act = 0;
  e.mask = nullptr;
  e.keep = 1.f;
  e.aux = nullptr;
  e.aux_act = 0;
  e.res = nullptr;
  e.accumulate = 0;
  return e;
}

// C (M x N, row stride ldc) = epilogue(A B); split-K with atomics when
// e.accumulate (C must hold the running sum).
void gemm(const Layer& P, const float* A, ll sam, ll sak, const float* B,
          ll sbk, ll sbn, float* C, ll ldc, ll M, int N, int K, Epi e) {
  const int chunk = e.accumulate ? SPLIT_K : K;
  dim3 grid((N + BN - 1) / BN, (unsigned)((M + BM - 1) / BM), (K + chunk - 1) / chunk);
  if (P.bf16)
    gemm_kernel<true><<<grid, GEMM_THREADS, 0, P.st>>>(A, sam, sak, B, sbk, sbn,
                                                        C, ldc, (int)M, N, K, chunk, e);
  else
    gemm_kernel<false><<<grid, GEMM_THREADS, 0, P.st>>>(A, sam, sak, B, sbk, sbn,
                                                         C, ldc, (int)M, N, K, chunk, e);
}

void layernorm(const Layer& P, const float* x, const float* s, const float* b,
               float* out) {
  constexpr int ROWS = 8;
  layernorm_kernel<<<(unsigned)((P.M() + ROWS - 1) / ROWS), ROWS * 32, 0, P.st>>>(
      x, s, b, out, (int)P.M(), P.D);
}

void layernorm_bwd(const Layer& P, const float* x, const float* s, const float* g,
                   float* dx, float* dxm, const int8_t* mask, float* ds, float* db) {
  constexpr int WARPS = 8;
  const ll blocks = (P.M() + WARPS - 1) / WARPS;
  layernorm_bwd_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), WARPS * 32,
                         2 * P.D * sizeof(float), P.st>>>(
      x, s, g, dx, dxm, mask, P.keep, ds, db, (int)P.M(), P.D);
}

void colsum(const Layer& P, const float* in, ll ld, float* out, int N) {
  constexpr int ROWS = 256;
  dim3 grid((N + 127) / 128, (unsigned)((P.M() + ROWS - 1) / ROWS));
  colsum_kernel<<<grid, 128, 0, P.st>>>(in, ld, out, (int)P.M(), N, ROWS);
}

float attn_scale(const Layer& P) { return 1.0f / sqrtf((float)(P.D / P.H)); }

cudaError_t forward(const Layer& P, const float* x, float* y, int8_t* sel,
                    const Work& W) {
  const ll M = P.M(), D = P.D, F = P.F;
  const float* const* w = P.w;
  for (int p = 0; p < 3; ++p) {  // q, k, v into the column blocks of qkv
    Epi e = epi();
    e.bias = w[2 * p + 1];
    gemm(P, x, D, 1, w[2 * p], D, 1, W.qkv + p * D, 3 * D, M, P.D, P.D, e);
  }
  const int dh = P.D / P.H;
  const size_t smem = attn_smem_bytes(P.L, dh, false);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<<<dim3(P.R, P.H), ATT_THREADS, smem, P.st>>>(
      W.qkv, P.cnt, W.att, sel, P.L, P.D, P.H, P.u, attn_scale(P), P.bf16);
  Epi e = epi();  // x1 = x + drop(att Wout + bout)
  e.bias = w[7];
  e.mask = P.m1;
  e.keep = P.keep;
  e.res = x;
  gemm(P, W.att, D, 1, w[6], D, 1, W.x1, D, M, P.D, P.D, e);
  layernorm(P, W.x1, w[8], w[9], W.xn1);
  e = epi();  // a1 = drop(act(xn1 Wff1 + bff1)), f1 = the pre-activation
  e.bias = w[11];
  e.pre = W.f1;
  e.act = P.act;
  e.mask = P.m2;
  e.keep = P.keep;
  gemm(P, W.xn1, D, 1, w[10], F, 1, W.a1, F, M, P.F, P.D, e);
  e = epi();  // z = xn1 + drop(a1 Wff2 + bff2)
  e.bias = w[13];
  e.mask = P.m3;
  e.keep = P.keep;
  e.res = W.xn1;
  gemm(P, W.a1, F, 1, w[12], D, 1, W.z, D, M, P.D, P.F, e);
  if (y) layernorm(P, W.z, w[14], w[15], y);
  return cudaGetLastError();
}

cudaError_t backward(const Layer& P, const float* x0, const float* g, float* dx,
                     float* const* dw, const Work& W) {
  const ll M = P.M(), D = P.D, F = P.F;
  const float* const* w = P.w;
  cudaError_t err = forward(P, x0, nullptr, nullptr, W);  // recompute
  if (err != cudaSuccess) return err;
  const ll sizes[16] = {D * D, D, D * D, D, D * D, D, D * D, D, D, D,
                        D * F, F, F * D, D, D, D};
  for (int i = 0; i < 16; ++i) {
    err = cudaMemsetAsync(dw[i], 0, sizes[i] * sizeof(float), P.st);
    if (err != cudaSuccess) return err;
  }
  // norm2 and the FFN
  layernorm_bwd(P, W.z, w[14], g, W.dz, W.df2, P.m3, dw[14], dw[15]);
  colsum(P, W.df2, D, dw[13], P.D);
  Epi acc = epi();
  acc.accumulate = 1;
  // dWff2 (F, D) = a1^T df2
  gemm(P, W.a1, 1, F, W.df2, D, 1, dw[12], D, F, P.D, (int)M, acc);
  Epi e = epi();  // df1 = drop(df2 Wff2^T) * act'(f1)
  e.mask = P.m2;
  e.keep = P.keep;
  e.aux = W.f1;
  e.aux_act = P.act;
  gemm(P, W.df2, D, 1, w[12], 1, D, W.df1, F, M, P.F, P.D, e);
  colsum(P, W.df1, F, dw[11], P.F);
  gemm(P, W.xn1, 1, D, W.df1, F, 1, dw[10], F, D, P.F, (int)M, acc);  // dWff1 (D, F)
  e = epi();  // dxn1 = dz + df1 Wff1^T
  e.res = W.dz;
  gemm(P, W.df1, F, 1, w[10], 1, F, W.dxn1, D, M, P.D, P.F, e);
  // norm1 and the out-projection
  layernorm_bwd(P, W.x1, w[8], W.dxn1, W.dx1, W.dnew, P.m1, dw[8], dw[9]);
  colsum(P, W.dnew, D, dw[7], P.D);
  gemm(P, W.att, 1, D, W.dnew, D, 1, dw[6], D, D, P.D, (int)M, acc);  // dWout
  e = epi();  // datt = dnew Wout^T
  gemm(P, W.dnew, D, 1, w[6], 1, D, W.datt, D, M, P.D, P.D, e);
  // attention
  const int dh = P.D / P.H;
  const size_t smem = attn_smem_bytes(P.L, dh, true);
  err = cudaFuncSetAttribute(attn_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_bwd_kernel<<<dim3(P.R, P.H), ATT_THREADS, smem, P.st>>>(
      W.qkv, W.datt, P.cnt, W.dqkv, P.L, P.D, P.H, P.u, attn_scale(P), P.bf16);
  // q, k, v projections: weight and bias grads, then dx0 = dx1 + sum dp W^T
  for (int p = 0; p < 3; ++p) {
    const float* dp = W.dqkv + p * D;
    colsum(P, dp, 3 * D, dw[2 * p + 1], P.D);
    gemm(P, x0, 1, D, dp, 3 * D, 1, dw[2 * p], D, D, P.D, (int)M, acc);
    e = epi();
    e.res = p == 0 ? W.dx1 : dx;
    gemm(P, dp, 3 * D, 1, w[2 * p], 1, D, dx, D, M, P.D, P.D, e);
  }
  return cudaGetLastError();
}

cudaError_t check_layer(const Layer& P) {
  if (P.R < 1 || P.L < 1 || P.D < 1 || P.F < 1 || P.H < 1 || P.D % P.H ||
      P.D / P.H > 64 || P.act < 1 || P.act > 2 || (P.M() + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  if (attn_smem_bytes(P.L, P.D / P.H, true) > 232448) return cudaErrorInvalidValue;
  return cudaSuccess;
}

Layer make_layer(const float* const* w, const float* cnt, const int8_t* m1,
                 const int8_t* m2, const int8_t* m3, float keep, int R, int L,
                 int D, int F, int H, int u, int act, int bf16, void* stream) {
  Layer P;
  P.w = w;
  P.cnt = cnt;
  P.m1 = m1;
  P.m2 = m2;
  P.m3 = m3;
  P.keep = keep;
  P.R = R;
  P.L = L;
  P.D = D;
  P.F = F;
  P.H = H;
  P.u = u;
  P.act = act;
  P.bf16 = bf16;
  P.st = static_cast<cudaStream_t>(stream);
  return P;
}

}  // namespace

// Floats of workspace one layer call needs for M = R L rows.
extern "C" long long rf_perceive_workspace_floats(long long M, int D, int F) {
  return M * (16LL * D + 3LL * F);
}

// K3a: y = layer(x) over R rows of L tokens. x, y: (R, L, D) f32. w: the 16
// f32 weights of the layer in (in, out) layout. cnt: (L, L) f32. m1, m2, m3:
// (R, L, D|F|D) int8 keep-masks or all null (eval). act: 1 gelu, 2 relu.
// sel: null, or (R, H, L) int8 that receives the top-u selection.
// ws: rf_perceive_workspace_floats floats. Returns cudaGetLastError().
extern "C" int rf_perceive_layer_fwd(const float* x, float* y, int8_t* sel,
                                     const float* const* w,
                                     const float* cnt, const int8_t* m1,
                                     const int8_t* m2, const int8_t* m3, float keep,
                                     int R, int L, int D, int F, int H, int u,
                                     int act, int bf16, float* ws, void* stream) {
  const Layer P = make_layer(w, cnt, m1, m2, m3, keep, R, L, D, F, H, u, act, bf16, stream);
  cudaError_t err = check_layer(P);
  if (err != cudaSuccess) return (int)err;
  return (int)forward(P, x, y, sel, carve(ws, P.M(), D, F));
}

// K3b: dx and the 16 weight grads (dw, same shapes as w, overwritten) of one
// layer at input x0 with upstream g (R, L, D) f32; other arguments as K3a.
extern "C" int rf_perceive_layer_bwd(const float* x0, const float* g, float* dx,
                                     const float* const* w, float* const* dw,
                                     const float* cnt, const int8_t* m1,
                                     const int8_t* m2, const int8_t* m3, float keep,
                                     int R, int L, int D, int F, int H, int u,
                                     int act, int bf16, float* ws, void* stream) {
  const Layer P = make_layer(w, cnt, m1, m2, m3, keep, R, L, D, F, H, u, act, bf16, stream);
  cudaError_t err = check_layer(P);
  if (err != cudaSuccess) return (int)err;
  return (int)backward(P, x0, g, dx, dw, carve(ws, P.M(), D, F));
}
