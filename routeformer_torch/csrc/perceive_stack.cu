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
//   backward (rf_perceive_layer_bwd): the _layer_bwd chain. The weight
//     grads are X^T dY products split over row chunks, each split writing
//     its own partial sums (the bias grads, B's column sums, come with them
//     from the GEMM's producer); the LayerNorm backward writes per-block
//     partial sums; one reduce_kernel adds every partial in a fixed order.
//     No atomics: two runs give the same bits.
//
// The GEMMs run on the Hopper core of gemm_sm90.cuh with its converting
// producer: the f32 operands are loaded 16 bytes a lane along whichever
// index is contiguous (X W, dY W^T and X^T dY alike), rounded to bf16 as
// they are staged, and multiplied on wgmma; the epilogue (Epi below) works
// on the accumulator registers. With bf16 == 0 (an f32 check path) a scalar
// FMA GEMM runs instead.
//
// The attention core runs one block per (row, head): q, k, v of the head and
// the L x L score tile sit in shared memory (L = 160 takes 137 KB forward and
// 148 KB backward). The sparsity measure needs no gathers: the sampled sum
// is the row sum of cnt * qk and the sampled max the max over cnt > 0; the
// top-u selection is the rank test #{j : M_j > M_i} < u, ties kept. In the
// backward with bf16 operands and 16-wide heads, the products whose operands
// the TPU kernel rounds to bf16 (q k^T, ds k, ds^T q) run on mma.sync
// m16n8k16 (attention_frag.cuh); g v^T and p^T g stay f32 FMA.
//
// Numerics are the TPU kernel's: matmul operands rounded to bf16 (or f32
// when bf16 == 0) with f32 accumulation; p.v and the mean-V context in f32;
// residual stream, LayerNorms (fast variance, eps 1e-6) and softmax in f32;
// gelu through XLA's rational erf.
//
// What bounds it: the layer's GEMMs carry 2 M (4 D^2 + 2 D F) FLOPs, the
// attention 4 M L D; the bytes are the rows in and out. Every intermediate
// still makes a round trip through device memory: at D = 128 those f32
// round trips, not the tensor cores, set the GEMMs' pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_frag.cuh"
#include "gemm_sm90.cuh"

typedef __nv_bfloat16 bf16;
typedef long long ll;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN_EPS = 1e-6f;
constexpr int BM = 64, BN = 64, BK = 32, GEMM_THREADS = 128;  // the f32 FMA GEMM
constexpr int LDA_F = BK + 1;
constexpr int LDB_F = BN + 4;
constexpr int LDC_S = BN + 4;
constexpr int GEMM_SMEM = BM * LDC_S * 4;  // the larger of its tiles and its epilogue tile
constexpr int ATT_THREADS = 256;
constexpr int MAX_KEYS = 256;   // tokens the attention block takes (its smem allows fewer)
constexpr int LN_BLOCKS = 128;  // blocks (and partial sums) of the LayerNorm backward
constexpr int LN_WARPS = 8;
constexpr int MAX_JOBS = 16;    // reductions of one backward: its 16 weight grads

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
// v = res[m, n] + v. mask, aux, res and pre share C's row stride. A product
// split over K (the rows of X^T dY) skips the epilogue: each split writes
// its raw sums to its slice of a partial buffer, and, if asked, B's column
// sums over its rows to its slice of a column-sum buffer.

struct Epi {
  float* c;
  ll ldc;
  const float* bias;
  float* pre;
  int act;
  const int8_t* mask;
  float keep;
  const float* aux;
  int aux_act;
  const float* res;

  static constexpr int GROUP = 4;  // pairs whose reads are in flight together
  // What the pair (row, col..col+1) reads: bias, mask, aux and residual.
  struct In {
    float2 bias, aux, res;
    float m0, m1;
  };

  // One 8-byte (2-byte for the mask) load each: col and ldc are even.
  __device__ __forceinline__ In fetch(int row, int col) const {
    const ll o = (ll)row * ldc + col;
    const float2 zero = make_float2(0.f, 0.f);
    In in;
    in.bias = bias ? *reinterpret_cast<const float2*>(bias + col) : zero;
    in.aux = aux ? *reinterpret_cast<const float2*>(aux + o) : zero;
    in.res = res ? *reinterpret_cast<const float2*>(res + o) : zero;
    const char2 m = mask ? *reinterpret_cast<const char2*>(mask + o) : make_char2(1, 1);
    in.m0 = m.x;
    in.m1 = m.y;
    return in;
  }

  __device__ __forceinline__ float finish(float v, ll o, float b, float m, float x,
                                          float r) const {
    v += b;
    if (pre) pre[o] = v;
    if (act) v = act_fwd(v, act);
    if (mask) v = v * m * keep;
    if (aux) v = v * act_grad(x, aux_act);
    if (res) v = r + v;
    return v;
  }

  __device__ __forceinline__ void store(int row, int col, float v0, float v1, const In& in) const {
    const ll o = (ll)row * ldc + col;
    *reinterpret_cast<float2*>(c + o) =
        make_float2(finish(v0, o, in.bias.x, in.m0, in.aux.x, in.res.x),
                    finish(v1, o + 1, in.bias.y, in.m1, in.aux.y, in.res.y));
  }
};

// The f32 check path: 16 x 8 threads, each 8 rows x 4 columns, scalar FMA.
// Thread t stages B's column t % 64 of every k-row (b_nfast), so with
// p.colsum it sums that column over its rows; two threads per column.
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_f32_kernel(const float* __restrict__ A, ll sam, ll sak, const float* __restrict__ B,
                ll sbk, ll sbn, gemm90::Problem p, Epi e) {
  __shared__ __align__(16) float smem[GEMM_SMEM / 4];
  __shared__ float col_part[2][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, split = blockIdx.z;
  const int kbeg = split * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);
  const bool a_kfast = sak == 1;
  const bool b_nfast = sbn == 1;
  const bool sums = p.colsum && b_nfast && blockIdx.y == 0;
  const int ty = tid / 16, tx = tid % 16;
  float facc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;
  float csum = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += GEMM_THREADS) {
      int r, c;
      if (a_kfast) { r = idx / BK; c = idx % BK; } else { r = idx % BM; c = idx / BM; }
      const int gm = m0 + r, gk = k0 + c;
      smem[r * LDA_F + c] = (gm < p.M && gk < kend) ? A[gm * sam + (ll)gk * sak] : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += GEMM_THREADS) {
      int r, c;
      if (b_nfast) { r = idx / BN; c = idx % BN; } else { r = idx % BK; c = idx / BK; }
      const int gk = k0 + r, gn = n0 + c;
      const float v = (gk < kend && gn < p.N) ? B[(ll)gk * sbk + gn * sbn] : 0.f;
      smem[BM * LDA_F + r * LDB_F + c] = v;
      csum += v;
    }
    __syncthreads();
    const float* as = smem;
    const float* bs = smem + BM * LDA_F;
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
    __syncthreads();
  }
  if (sums) {
    col_part[tid / BN][tid % BN] = csum;
    __syncthreads();
    if (tid < BN && n0 + tid < p.N)
      p.colsum[(ll)split * p.N + n0 + tid] = col_part[0][tid] + col_part[1][tid];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; j += 2) {  // column pairs (N is even)
      const int gm = m0 + ty * 8 + i, gn = n0 + tx * 4 + j;
      if (gm >= p.M || gn >= p.N) continue;
      if (p.partial)
        *reinterpret_cast<float2*>(p.partial + ((ll)split * p.M + gm) * p.N + gn) =
            make_float2(facc[i][j], facc[i][j + 1]);
      else
        e.store(gm, gn, facc[i][j], facc[i][j + 1], e.fetch(gm, gn));
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
// dxm = dx * mask * keep; the weight grads as this block's partial sums,
// part[block] = (sum g * xhat, sum g) over its rows (2 D floats). Lane l of a
// warp owns columns l, l + 32, ..., so the warp's running sums in shared
// memory need no atomics; the block's warps are summed in order.
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ g, float* __restrict__ dx,
                     float* __restrict__ dxm, const int8_t* __restrict__ mask, float keep,
                     float* __restrict__ part, int M, int D) {
  extern __shared__ float wsum[];  // LN_WARPS x 2 D
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* mine = wsum + warp * 2 * D;
  for (int c = lane; c < 2 * D; c += 32) mine[c] = 0.f;
  __syncwarp();
  for (ll row = (ll)blockIdx.x * LN_WARPS + warp; row < M; row += (ll)gridDim.x * LN_WARPS) {
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
      mine[c] += gr[c] * xhat;
      mine[D + c] += gr[c];
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
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < LN_WARPS; ++w) t += wsum[w * 2 * D + c];
    part[(ll)blockIdx.x * 2 * D + c] = t;
  }
}

// dst[r, c] = sum over s < splits, in order, of src[s * split_stride + r * ld + c].
struct ReduceJob {
  float* dst;
  const float* src;
  int rows, cols;
  ll ld, split_stride;
  int splits;
};

struct ReduceJobs {
  ReduceJob job[MAX_JOBS];
};

__global__ void reduce_kernel(ReduceJobs jobs) {
  const ReduceJob& r = jobs.job[blockIdx.y];
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= r.rows * r.cols) return;
  const float* src = r.src + (ll)(idx / r.cols) * r.ld + idx % r.cols;
  float t = 0.f;
  for (int s = 0; s < r.splits; ++s) t += src[s * r.split_stride];
  r.dst[idx] = t;
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

// Two shared-memory values (bf16 already, held as f32) as one bf16 pair.
__device__ __forceinline__ uint32_t pair(const float* p, int i, int ld, int e, int L) {
  return i < L ? attn::pack_bf16(p[i * ld + e], p[i * ld + e + 1]) : 0u;
}

// s = q k^T with 16-wide heads on mma.sync m16n8k16 (one k-step): each warp
// takes 16-row strips of q and runs them against every 8-key tile of k.
// q and k hold bf16 values, so their products are exact and the sums f32.
__device__ void scores_mma(const AttnSmem& a, int L) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nwarps = blockDim.x / 32;
  for (int i0 = 16 * warp; i0 < L; i0 += 16 * nwarps) {
    uint32_t af[4];
    af[0] = pair(a.q, i0 + g, a.dhp, 2 * t, L);
    af[1] = pair(a.q, i0 + g + 8, a.dhp, 2 * t, L);
    af[2] = pair(a.q, i0 + g, a.dhp, 2 * t + 8, L);
    af[3] = pair(a.q, i0 + g + 8, a.dhp, 2 * t + 8, L);
    for (int j0 = 0; j0 < L; j0 += 8) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      attn::mma_bf16(c, af, pair(a.k, j0 + g, a.dhp, 2 * t, L),
                     pair(a.k, j0 + g, a.dhp, 2 * t + 8, L));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + g + 8 * (r >> 1), j = j0 + 2 * t + (r & 1);
        if (i < L && j < L) a.s[i * a.lp + j] = c[r];
      }
    }
  }
}

// Scores (on mma.sync with `mma`, else FMA), the sparsity measure, the
// rank-test selection and the f32 softmax (left in a.s).
__device__ void attn_probs(const AttnSmem& a, const float* __restrict__ cnt,
                           int L, int dh, int u, float scale, bool mma) {
  if (mma) {
    scores_mma(a, L);
  } else {
    for (int idx = threadIdx.x; idx < L * L; idx += blockDim.x) {
      const int i = idx / L, j = idx % L;
      float acc = 0.f;
      for (int e = 0; e < dh; ++e) acc = fmaf(a.q[i * a.dhp + e], a.k[j * a.dhp + e], acc);
      a.s[i * a.lp + j] = acc;
    }
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
  attn_probs(a, cnt, L, dh, u, scale, false);
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

// dq = ds k and dk = ds^T q with 16-wide heads on mma.sync m16n8k16: a
// warp takes a 16-row strip of dq (or of dk) and walks the keys 16 at a
// time; ds, q and k hold bf16 values. out points at the head's first
// column of the row's q block in dqkv (row stride ld; dk sits d_off on).
__device__ void dqk_mma(const AttnSmem& a, int L, float* __restrict__ out, int ld, int d_off) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nwarps = blockDim.x / 32;
  const int strips = (L + 15) / 16;
  for (int task = warp; task < 2 * strips; task += nwarps) {
    const bool dk = task >= strips;
    const int i0 = 16 * (task % strips);
    const float* b = dk ? a.q : a.k;
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int j0 = 0; j0 < L; j0 += 16) {
      // A(i, j) = ds[i, j] for dq, ds[j, i] for dk; zero past L.
      auto ds = [&](int i, int j) {
        if (i >= L || j >= L) return 0.f;
        return dk ? a.s[j * a.lp + i] : a.s[i * a.lp + j];
      };
      uint32_t af[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + g + 8 * (r & 1), j = j0 + 2 * t + 8 * (r >> 1);
        af[r] = attn::pack_bf16(ds(i, j), ds(i, j + 1));
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {  // B(j, e) = k[j, e] (dq) or q[j, e] (dk)
        auto bv = [&](int j) { return j < L ? b[j * a.dhp + 8 * nt + g] : 0.f; };
        const int j = j0 + 2 * t;
        attn::mma_bf16(c[nt], af, attn::pack_bf16(bv(j), bv(j + 1)),
                       attn::pack_bf16(bv(j + 8), bv(j + 9)));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + g + 8 * (r >> 1), e = 8 * nt + 2 * t + (r & 1);
        if (i < L) out[(ll)i * ld + (dk ? d_off : 0) + e] = c[nt][r];
      }
  }
}

// dq, dk, dv of one (row, head) into dqkv (M, 3D) from datt (M, D).
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ datt,
                const float* __restrict__ cnt, float* __restrict__ dqkv, int L,
                int D, int H, int u, float scale, int bf16_mode) {
  extern __shared__ float smem_f[];
  const int row = blockIdx.x, h = blockIdx.y, dh = D / H;
  const bool mma = bf16_mode && dh == 16;  // the products of bf16 operands on tensor cores
  const AttnSmem a = attn_layout(smem_f, L, dh, true);
  attn_load(a, qkv, datt, row, h, L, D, dh, bf16_mode);
  attn_probs(a, cnt, L, dh, u, scale, mma);
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
  // Lane l keeps dp of its keys l, l + 32, ... in registers (L <= 256).
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  for (int i = warp; i < L; i += nwarps) {
    const bool sel = a.sel[i] != 0.f;
    float dp[MAX_KEYS / 32];
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < MAX_KEYS / 32; ++jj) {
      const int j = lane + 32 * jj;
      float d = 0.f;
      if (sel && j < L)
        for (int e = 0; e < dh; ++e) d = fmaf(a.g[i * a.dhp + e], a.v[j * a.dhp + e], d);
      dp[jj] = d;
      if (sel && j < L) rs += d * a.s[i * a.lp + j];
    }
    rs = warp_sum(rs);
#pragma unroll
    for (int jj = 0; jj < MAX_KEYS / 32; ++jj) {
      const int j = lane + 32 * jj;
      if (j < L) {
        const float ds = a.s[i * a.lp + j] * (dp[jj] - rs);
        a.s[i * a.lp + j] = round_to(ds * scale, bf16_mode);
      }
    }
  }
  __syncthreads();
  if (mma) {
    dqk_mma(a, L, dqkv + (ll)row * L * 3 * D + col, 3 * D, D);
    return;
  }
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
  // backward: per-split partial products and column sums, LayerNorm partials
  float *pqkv, *pout, *pff1, *pff2, *cqkv, *cout, *cff1, *cff2, *ln1, *ln2, *end;
};

// The workspace of one layer call over M rows; S splits of the weight-grad
// products (0: the forward, which needs no partials).
Work carve(float* ws, ll M, ll D, ll F, ll S) {
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
  w.pqkv = w.dqkv + 3 * M * D;
  w.pout = w.pqkv + S * D * 3 * D;
  w.pff1 = w.pout + S * D * D;
  w.pff2 = w.pff1 + S * D * F;
  w.cqkv = w.pff2 + S * F * D;
  w.cout = w.cqkv + S * 3 * D;
  w.cff1 = w.cout + S * D;
  w.cff2 = w.cff1 + S * F;
  w.ln1 = w.cff2 + S * D;
  w.ln2 = w.ln1 + (S ? LN_BLOCKS * 2 * D : 0);
  w.end = w.ln2 + (S ? LN_BLOCKS * 2 * D : 0);
  return w;
}

Epi epi(float* c, ll ldc) {
  Epi e;
  e.c = c;
  e.ldc = ldc;
  e.bias = nullptr;
  e.pre = nullptr;
  e.act = 0;
  e.mask = nullptr;
  e.keep = 1.f;
  e.aux = nullptr;
  e.aux_act = 0;
  e.res = nullptr;
  return e;
}

// C (M x N, e.c with row stride e.ldc) = epilogue(A B). With `partial`, the
// product is split over K in chunks of k_chunk rows: split s writes its raw
// sums to partial[s] (M x N) and, with `colsum`, B's column sums over its
// rows to colsum[s] (N); no epilogue runs.
cudaError_t gemm(const Layer& P, const float* A, ll sam, ll sak, const float* B, ll sbk,
                 ll sbn, ll M, int N, int K, const Epi& e, float* partial = nullptr,
                 float* colsum = nullptr, int k_chunk = 0) {
  const gemm90::Problem pr =
      gemm90::problem((int)M, N, K, partial ? k_chunk : 0, partial, colsum);
  auto off = [](const void* q, int bytes) { return reinterpret_cast<uintptr_t>(q) % bytes; };
  if (N % 2 || e.ldc % 2 || off(e.c, 8) || off(e.bias, 8) || off(e.aux, 8) || off(e.res, 8) ||
      off(e.mask, 2) || off(partial, 8))  // the epilogue's pair loads and stores
    return cudaErrorInvalidValue;
  if (!P.bf16) {
    dim3 grid((N + BN - 1) / BN, (unsigned)((M + BM - 1) / BM), pr.splits);
    gemm_f32_kernel<<<grid, GEMM_THREADS, 0, P.st>>>(A, sam, sak, B, sbk, sbn, pr, e);
    return cudaGetLastError();
  }
  const bool a_k = sak == 1, b_k = sbk == 1;
  const ll lda = a_k ? sam : sak, ldb = b_k ? sbn : sbk;
  if ((!a_k && sam != 1) || (!b_k && sbn != 1)) return cudaErrorInvalidValue;
  static const CUtensorMap none{};
  const gemm90::Operand oa{A, lda}, ob{B, ldb};
  if (a_k && b_k) return gemm90::launch<Epi, false, true, true>(none, none, oa, ob, pr, e, P.st);
  if (a_k) return gemm90::launch<Epi, false, true, false>(none, none, oa, ob, pr, e, P.st);
  if (!b_k) return gemm90::launch<Epi, false, false, false>(none, none, oa, ob, pr, e, P.st);
  return cudaErrorInvalidValue;
}

void layernorm(const Layer& P, const float* x, const float* s, const float* b,
               float* out) {
  constexpr int ROWS = 8;
  layernorm_kernel<<<(unsigned)((P.M() + ROWS - 1) / ROWS), ROWS * 32, 0, P.st>>>(
      x, s, b, out, (int)P.M(), P.D);
}

void layernorm_bwd(const Layer& P, const float* x, const float* s, const float* g,
                   float* dx, float* dxm, const int8_t* mask, float* part) {
  layernorm_bwd_kernel<<<LN_BLOCKS, LN_WARPS * 32, LN_WARPS * 2 * P.D * sizeof(float),
                         P.st>>>(x, s, g, dx, dxm, mask, P.keep, part, (int)P.M(), P.D);
}

ReduceJob job(float* dst, const float* src, int rows, int cols, ll ld, ll split_stride,
              int splits) {
  return ReduceJob{dst, src, rows, cols, ld, split_stride, splits};
}

float attn_scale(const Layer& P) { return 1.0f / sqrtf((float)(P.D / P.H)); }

cudaError_t forward(const Layer& P, const float* x, float* y, int8_t* sel,
                    const Work& W) {
  const ll M = P.M(), D = P.D, F = P.F;
  const float* const* w = P.w;
  cudaError_t err = cudaSuccess;
  for (int p = 0; p < 3 && err == cudaSuccess; ++p) {  // q, k, v into the column blocks of qkv
    Epi e = epi(W.qkv + p * D, 3 * D);
    e.bias = w[2 * p + 1];
    err = gemm(P, x, D, 1, w[2 * p], D, 1, M, P.D, P.D, e);
  }
  if (err != cudaSuccess) return err;
  const int dh = P.D / P.H;
  const size_t smem = attn_smem_bytes(P.L, dh, false);
  err = cudaFuncSetAttribute(attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<<<dim3(P.R, P.H), ATT_THREADS, smem, P.st>>>(
      W.qkv, P.cnt, W.att, sel, P.L, P.D, P.H, P.u, attn_scale(P), P.bf16);
  Epi e = epi(W.x1, D);  // x1 = x + drop(att Wout + bout)
  e.bias = w[7];
  e.mask = P.m1;
  e.keep = P.keep;
  e.res = x;
  if ((err = gemm(P, W.att, D, 1, w[6], D, 1, M, P.D, P.D, e)) != cudaSuccess) return err;
  layernorm(P, W.x1, w[8], w[9], W.xn1);
  e = epi(W.a1, F);  // a1 = drop(act(xn1 Wff1 + bff1)), f1 = the pre-activation
  e.bias = w[11];
  e.pre = W.f1;
  e.act = P.act;
  e.mask = P.m2;
  e.keep = P.keep;
  if ((err = gemm(P, W.xn1, D, 1, w[10], F, 1, M, P.F, P.D, e)) != cudaSuccess) return err;
  e = epi(W.z, D);  // z = xn1 + drop(a1 Wff2 + bff2)
  e.bias = w[13];
  e.mask = P.m3;
  e.keep = P.keep;
  e.res = W.xn1;
  if ((err = gemm(P, W.a1, F, 1, w[12], D, 1, M, P.D, P.F, e)) != cudaSuccess) return err;
  if (y) layernorm(P, W.z, w[14], w[15], y);
  return cudaGetLastError();
}

cudaError_t backward(const Layer& P, const float* x0, const float* g, float* dx,
                     float* const* dw, const Work& W, int split_rows) {
  const ll M = P.M(), D = P.D, F = P.F;
  const int S = (int)((M + split_rows - 1) / split_rows);
  const float* const* w = P.w;
  const Epi none = epi(nullptr, 0);
  cudaError_t err = forward(P, x0, nullptr, nullptr, W);  // recompute
  if (err != cudaSuccess) return err;
#define RF_TRY(call) \
  if ((err = (call)) != cudaSuccess) return err
  // norm2 and the FFN
  layernorm_bwd(P, W.z, w[14], g, W.dz, W.df2, P.m3, W.ln2);
  // dWff2 (F, D) = a1^T df2 and dbff2, split over the rows
  RF_TRY(gemm(P, W.a1, 1, F, W.df2, D, 1, P.F, P.D, (int)M, none, W.pff2, W.cff2, split_rows));
  Epi e = epi(W.df1, F);  // df1 = drop(df2 Wff2^T) * act'(f1)
  e.mask = P.m2;
  e.keep = P.keep;
  e.aux = W.f1;
  e.aux_act = P.act;
  RF_TRY(gemm(P, W.df2, D, 1, w[12], 1, D, M, P.F, P.D, e));
  // dWff1 (D, F) = xn1^T df1 and dbff1
  RF_TRY(gemm(P, W.xn1, 1, D, W.df1, F, 1, P.D, P.F, (int)M, none, W.pff1, W.cff1, split_rows));
  e = epi(W.dxn1, D);  // dxn1 = dz + df1 Wff1^T
  e.res = W.dz;
  RF_TRY(gemm(P, W.df1, F, 1, w[10], 1, F, M, P.D, P.F, e));
  // norm1 and the out-projection
  layernorm_bwd(P, W.x1, w[8], W.dxn1, W.dx1, W.dnew, P.m1, W.ln1);
  RF_TRY(gemm(P, W.att, 1, D, W.dnew, D, 1, P.D, P.D, (int)M, none, W.pout, W.cout, split_rows));
  RF_TRY(gemm(P, W.dnew, D, 1, w[6], 1, D, M, P.D, P.D, epi(W.datt, D)));  // datt = dnew Wout^T
  // attention
  const int dh = P.D / P.H;
  const size_t smem = attn_smem_bytes(P.L, dh, true);
  RF_TRY(cudaFuncSetAttribute(attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem));
  attn_bwd_kernel<<<dim3(P.R, P.H), ATT_THREADS, smem, P.st>>>(
      W.qkv, W.datt, P.cnt, W.dqkv, P.L, P.D, P.H, P.u, attn_scale(P), P.bf16);
  // dWq|dWk|dWv (D, 3D) = x0^T dqkv and their bias grads, then
  // dx0 = dx1 + dq Wq^T + dk Wk^T + dv Wv^T
  RF_TRY(gemm(P, x0, 1, D, W.dqkv, 3 * D, 1, P.D, 3 * P.D, (int)M, none, W.pqkv, W.cqkv,
              split_rows));
  for (int p = 0; p < 3; ++p) {
    e = epi(dx, D);
    e.res = p == 0 ? W.dx1 : dx;
    RF_TRY(gemm(P, W.dqkv + p * D, 3 * D, 1, w[2 * p], 1, D, M, P.D, P.D, e));
  }
#undef RF_TRY
  // The 16 weight grads: every partial summed in a fixed order.
  const int d = P.D, f = P.F;
  ReduceJobs jobs;
  for (int p = 0; p < 3; ++p) {
    jobs.job[2 * p] = job(dw[2 * p], W.pqkv + p * D, d, d, 3 * D, D * 3 * D, S);
    jobs.job[2 * p + 1] = job(dw[2 * p + 1], W.cqkv + p * D, 1, d, 0, 3 * D, S);
  }
  jobs.job[6] = job(dw[6], W.pout, d, d, D, D * D, S);
  jobs.job[7] = job(dw[7], W.cout, 1, d, 0, D, S);
  jobs.job[8] = job(dw[8], W.ln1, 1, d, 0, 2 * D, LN_BLOCKS);
  jobs.job[9] = job(dw[9], W.ln1 + D, 1, d, 0, 2 * D, LN_BLOCKS);
  jobs.job[10] = job(dw[10], W.pff1, d, f, F, D * F, S);
  jobs.job[11] = job(dw[11], W.cff1, 1, f, 0, F, S);
  jobs.job[12] = job(dw[12], W.pff2, f, d, D, F * D, S);
  jobs.job[13] = job(dw[13], W.cff2, 1, d, 0, D, S);
  jobs.job[14] = job(dw[14], W.ln2, 1, d, 0, 2 * D, LN_BLOCKS);
  jobs.job[15] = job(dw[15], W.ln2 + D, 1, d, 0, 2 * D, LN_BLOCKS);
  reduce_kernel<<<dim3((unsigned)((D * F + 255) / 256), MAX_JOBS), 256, 0, P.st>>>(jobs);
  return cudaGetLastError();
}

cudaError_t check_layer(const Layer& P) {
  if (P.R < 1 || P.L < 1 || P.D < 1 || P.F < 1 || P.H < 1 || P.D % P.H ||
      P.D / P.H > 64 || P.act < 1 || P.act > 2 || (P.M() + BM - 1) / BM > 65535 ||
      P.D % 4 || P.F % 4)
    return cudaErrorInvalidValue;
  if (attn_smem_bytes(P.L, P.D / P.H, true) > 232448 || P.L > MAX_KEYS)
    return cudaErrorInvalidValue;
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

// K3a: y = layer(x) over R rows of L tokens. x, y: (R, L, D) f32. w: the 16
// f32 weights of the layer in (in, out) layout. cnt: (L, L) f32. m1, m2, m3:
// (R, L, D|F|D) int8 keep-masks or all null (eval). act: 1 gelu, 2 relu.
// sel: null, or (R, H, L) int8 that receives the top-u selection. ws:
// ws_floats floats, at least M (16 D + 3 F) for M = R L. Returns
// cudaGetLastError() after the last launch (0 on success).
extern "C" int rf_perceive_layer_fwd(const float* x, float* y, int8_t* sel,
                                     const float* const* w,
                                     const float* cnt, const int8_t* m1,
                                     const int8_t* m2, const int8_t* m3, float keep,
                                     int R, int L, int D, int F, int H, int u,
                                     int act, int bf16, float* ws, long long ws_floats,
                                     void* stream) {
  const Layer P = make_layer(w, cnt, m1, m2, m3, keep, R, L, D, F, H, u, act, bf16, stream);
  cudaError_t err = check_layer(P);
  if (err != cudaSuccess) return (int)err;
  const Work W = carve(ws, P.M(), D, F, 0);
  if (W.end - ws > ws_floats) return (int)cudaErrorInvalidValue;
  return (int)forward(P, x, y, sel, W);
}

// K3b: dx and the 16 weight grads (dw, same shapes as w, overwritten) of one
// layer at input x0 with upstream g (R, L, D) f32; other arguments as K3a.
// The weight-grad products are split over chunks of split_rows rows (a
// multiple of 64), S = ceil(M / split_rows); ws holds M (16 D + 3 F) +
// S (4 D^2 + 2 D F + 5 D + F) + 512 D floats (ws_floats, checked).
extern "C" int rf_perceive_layer_bwd(const float* x0, const float* g, float* dx,
                                     const float* const* w, float* const* dw,
                                     const float* cnt, const int8_t* m1,
                                     const int8_t* m2, const int8_t* m3, float keep,
                                     int R, int L, int D, int F, int H, int u,
                                     int act, int bf16, int split_rows, float* ws,
                                     long long ws_floats, void* stream) {
  const Layer P = make_layer(w, cnt, m1, m2, m3, keep, R, L, D, F, H, u, act, bf16, stream);
  cudaError_t err = check_layer(P);
  if (err != cudaSuccess) return (int)err;
  if (split_rows < 64 || split_rows % 64) return (int)cudaErrorInvalidValue;
  const ll S = (P.M() + split_rows - 1) / split_rows;
  const Work W = carve(ws, P.M(), D, F, S);
  if (W.end - ws > ws_floats) return (int)cudaErrorInvalidValue;
  return (int)backward(P, x0, g, dx, dw, W, split_rows);
}

// The layer's GEMM on its own: C (M, N) = epilogue(A B) with A(m, k) =
// A[m sam + k sak], B(k, n) = B[k sbk + n sbn], all f32, on the GEMM core
// (bf16 = 1) or the FMA path. Epilogue arguments as the layer's (each may
// be null; act 0 none, 1 gelu, 2 relu). With split_rows > 0 the product is
// split over K as the weight grads are, and the partials (ws: S (M N + N)
// floats) are reduced in order into C and into colsum (N), B's column sums.
extern "C" int rf_perceive_gemm(const float* A, long long sam, long long sak, const float* B,
                                long long sbk, long long sbn, float* C, int M, int N, int K,
                                const float* bias, float* pre, int act, const int8_t* mask,
                                float keep, const float* aux, int aux_act, const float* res,
                                int split_rows, float* ws, float* colsum, int bf16,
                                void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 2 || act < 0 || act > 2 || aux_act < 0 || aux_act > 2 ||
      (split_rows && (split_rows < 64 || split_rows % 64)))
    return (int)cudaErrorInvalidValue;
  Layer P = make_layer(nullptr, nullptr, nullptr, nullptr, nullptr, 1.f, 1, 1, 1, 1, 1, 0, 1,
                       bf16, stream);
  Epi e = epi(C, N);
  e.bias = bias;
  e.pre = pre;
  e.act = act;
  e.mask = mask;
  e.keep = keep;
  e.aux = aux;
  e.aux_act = aux_act;
  e.res = res;
  if (!split_rows) return (int)gemm(P, A, sam, sak, B, sbk, sbn, M, N, K, e);
  const int S = (K + split_rows - 1) / split_rows;
  float* sums = ws + (ll)S * M * N;
  cudaError_t err = gemm(P, A, sam, sak, B, sbk, sbn, M, N, K, e, ws, colsum ? sums : nullptr,
                         split_rows);
  if (err != cudaSuccess) return (int)err;
  ReduceJobs jobs;
  jobs.job[0] = job(C, ws, M, N, N, (ll)M * N, S);
  jobs.job[1] = job(colsum ? colsum : C, sums, colsum ? 1 : 0, N, 0, N, S);
  reduce_kernel<<<dim3((unsigned)(((ll)M * N + 255) / 256), 2), 256, 0, P.st>>>(jobs);
  return (int)cudaGetLastError();
}
