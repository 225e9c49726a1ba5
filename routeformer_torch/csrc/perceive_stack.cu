// K3a / K3b: the Perceive encoder stack forward and one layer's backward,
// for Hopper (sm_90a).
//
// Replaces routeformer_tpu/ops/fusion_stack.py: K3a the forward kernel
// _fwd_kernel (eval call: all N layers in one pallas_call; train: one call
// per layer), K3b the per-layer backward _bwd_layer_kernel. The TPU kernels
// keep a chunk of rows, the whole layer's weights and the (C, H, L, L) score
// tensors in VMEM, which holds many megabytes. An H100 block has 227 KB of
// shared memory, so here a layer is a short pipeline over all rows at once,
// and K3a runs every layer of the stack in one call:
//
//   forward (rf_perceive_stack_fwd; rf_perceive_layer_bwd's recompute)
//     q|k|v = x Wqkv + bqkv                      one GEMM (N = 3D); q, k bf16
//     measure per (row, query tile), all heads    measure_mma_kernel
//     top-u, softmax p.v, mean-V per (row, head)  select_kernel
//     xn1 = LN1(x + drop(att Wout + bout))        GEMM, LayerNorm epilogue
//     a1  = drop(act(xn1 Wff1 + bff1))            GEMM; a1 bf16
//     y   = LN2(xn1 + drop(a1 Wff2 + bff2))       GEMM, LayerNorm epilogue
//   Six launches a layer (and one f32 -> bf16 copy of the stack's input).
//   The recompute also keeps x1, z and f1 (the pre-activation) for the
//   backward; the forward writes none of them.
//   backward (rf_perceive_layer_bwd): the _layer_bwd chain. The weight
//     grads are X^T dY products split over row chunks, each split writing
//     its own partial sums (the bias grads, B's column sums, come with them
//     from the GEMM's producer); the LayerNorm backward writes per-block
//     partial sums; one reduce_kernel adds every partial in a fixed order.
//     No atomics: two runs give the same bits.
//
// The GEMMs run on the Hopper core of gemm_sm90.cuh. In the forward every
// operand is bf16 and read by its TMA producer: the cached bf16 (out, in)
// weights, and x, xn1, q, k, att and a1, which every consumer rounds to
// bf16 and which the epilogue that makes them stores rounded (the same bits
// as rounding them at staging); x and xn1 also stay f32, as residuals. The
// backward's products of f32 gradients use the converting producer, which
// rounds as it stages (A may be bf16 already: att and a1). With bf16 == 0
// (an f32 check path) a scalar FMA GEMM and separate LayerNorm rows run.
//
// K3a's attention core keeps no L x L tile, so it takes any L whose
// measures fit shared memory (select_smem_bytes: ~20,000 tokens at 16-wide
// heads):
//   measure: one block per (row, 64 queries) walks 64-key tiles of k and of
//     the (L, L) counts (cp.async, two stages), scores q k^T on mma.sync
//     m16n8k16 for every head in turn (16-wide heads are one k-step) and
//     accumulates max_{cnt > 0} qk and sum cnt qk per query in registers,
//     so the counts are read once per row for all heads;
//   select: one block per (row, head) runs the rank test #{j : M_j > M_i}
//     < u (ties kept) over the L measures in shared memory, writes the
//     int8 selection, the mean of V to the other queries, and for the
//     selected ones only recomputes the scores (FMA, f32) and takes the f32
//     softmax (online, per lane) and p.v with v in f32 over tiles of k and
//     v (all of them at once up to 256 keys at 16-wide heads).
// K3b's recompute runs the same two kernels, and its attention block reads
// the selection they wrote, so the backward differentiates the selection
// the forward made. That block still holds the L x L score tile (at most
// 208 tokens at 16-wide heads): one block per (row, head), q k^T, ds k and
// ds^T q on mma.sync with bf16 operands and 16-wide heads, g v^T and p^T g
// f32 FMA.
//
// Numerics are the TPU kernel's: matmul operands rounded to bf16 (or f32
// when bf16 == 0) with f32 accumulation; p.v and the mean-V context in f32;
// residual stream, LayerNorms (fast variance, eps 1e-6) and softmax in f32;
// gelu through XLA's rational erf.
//
// What bounds it: the layer's GEMMs carry 2 M (4 D^2 + 2 D F) FLOPs, the
// scores 2 M L D; the bytes are the rows in and out and the counts. At
// D = 128 neither sets the pace: the GEMMs' epilogues (loads of residuals
// and masks, eight consumer warps an SM) and the select block's latency
// do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_frag.cuh"
#include "gemm_sm90.cuh"

typedef __nv_bfloat16 bf16;
typedef long long ll;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN_EPS = 1e-6f;
constexpr int SMEM_MAX = 232448;  // shared memory one H100 block can have
constexpr int BM = 64, BN = 64, BK = 32, GEMM_THREADS = 128;  // the f32 FMA GEMM
constexpr int LDA_F = BK + 1;
constexpr int LDB_F = BN + 4;
constexpr int LDC_S = BN + 4;
constexpr int GEMM_SMEM = BM * LDC_S * 4;  // the larger of its tiles and its epilogue tile
constexpr int ATT_THREADS = 256;
constexpr int MAX_KEYS = 256;   // tokens K3b's attention block takes (its smem allows fewer)
constexpr int LN_BLOCKS = 128;  // blocks (and partial sums) of the LayerNorm backward
constexpr int LN_WARPS = 8;
constexpr int MAX_JOBS = 16;    // reductions of one backward: its 16 weight grads
// K3a's attention core
constexpr int QT = 64, KT = 64;  // queries and keys per tile of the measure
constexpr int MEAS_THREADS = 128;  // four warps of 16 queries (tensor cores); FMA: 256
constexpr int LDCNT = KT + 8;    // floats per staged count row
constexpr int MAX_MMA_D = 128;   // the tensor-core measure keeps each head's sums in registers
constexpr int MAX_HEADS = 8;     // (D <= 128 with 16-wide heads)
constexpr int SEL_THREADS = 128, SEL_WARPS = 4;  // the select block

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
// B(k, n) = B[k sbk + n sbn], rounded to the compute type as they are
// staged (A f32 or already bf16, B f32). Epilogue, in this order: + bias[n];
// pre[m, n] = v; v = act(v); v = v * mask[m, n] * keep; v = v * act'(aux[m,
// n]); v = res[m, n] + v. mask, aux, res and pre share C's row stride. A
// product split over K (the rows of X^T dY) skips the epilogue: each split
// writes its raw sums to its slice of a partial buffer, and, if asked, B's
// column sums over its rows to its slice of a column-sum buffer.

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

// K3a's forward epilogues on the GEMM core (its TMA producer), each loading
// only what its step needs: FwdEpi<ACT> for the QKV and FFN1 GEMMs, NormEpi
// for the out-projection and FFN2.
//
// FwdEpi: v = act(acc + bias[n]) (ACT 0 none, 1 gelu, 2 relu; pre[m, n] =
// the pre-activation if asked), v = v * mask[m, n] * keep if masked; columns
// n < split stored rounded to bf16 at cb[m ldcb + n], the others f32 at
// c[m ldc + n - split]. pre and mask are at m ldm + n.
template <int ACT>
struct FwdEpi {
  float* c;
  ll ldc;
  bf16* cb;
  ll ldcb;
  int split;
  const float* bias;
  float* pre;
  const int8_t* mask;
  ll ldm;
  float keep;

  static constexpr int GROUP = 8;
  struct In {
    float2 bias;
    char2 m;
  };

  __device__ __forceinline__ In fetch(int row, int col) const {
    In in;
    in.bias = *reinterpret_cast<const float2*>(bias + col);
    in.m = mask ? *reinterpret_cast<const char2*>(mask + (ll)row * ldm + col) : make_char2(1, 1);
    return in;
  }

  __device__ __forceinline__ void store(int row, int col, float v0, float v1, const In& in) const {
    v0 += in.bias.x;
    v1 += in.bias.y;
    if (ACT) {
      if (pre) *reinterpret_cast<float2*>(pre + (ll)row * ldm + col) = make_float2(v0, v1);
      v0 = act_fwd(v0, ACT);
      v1 = act_fwd(v1, ACT);
    }
    if (mask) {
      v0 = v0 * (float)in.m.x * keep;
      v1 = v1 * (float)in.m.y * keep;
    }
    if (col < split)
      *reinterpret_cast<__nv_bfloat162*>(cb + (ll)row * ldcb + col) = __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(c + (ll)row * ldc + col - split) = make_float2(v0, v1);
  }
};

// NormEpi: v = res[m, n] + drop(acc + bias[n]), then C = LN(v) over the
// whole row (N = D, one tile's width) in f32 at c and rounded at cb (if
// asked), and raw = v, the value before the norm (x1 or z), if asked. mask,
// res, raw and c share the row stride ldc.
struct NormEpi {
  static constexpr bool ROW_NORM = true;
  static constexpr int GROUP = 8;
  float* c;
  ll ldc;
  bf16* cb;
  const float* bias;
  const int8_t* mask;
  float keep;
  const float* res;
  const float *ln_scale, *ln_bias;
  float* raw;
  float eps;

  struct In {
    float2 bias, res;
    char2 m;
  };

  __device__ __forceinline__ In fetch(int row, int col) const {
    const ll o = (ll)row * ldc + col;
    In in;
    in.bias = *reinterpret_cast<const float2*>(bias + col);
    in.res = *reinterpret_cast<const float2*>(res + o);
    in.m = mask ? *reinterpret_cast<const char2*>(mask + o) : make_char2(1, 1);
    return in;
  }

  __device__ __forceinline__ float2 value(int, int, float v0, float v1, const In& in) const {
    v0 += in.bias.x;
    v1 += in.bias.y;
    if (mask) {
      v0 = v0 * (float)in.m.x * keep;
      v1 = v1 * (float)in.m.y * keep;
    }
    return make_float2(in.res.x + v0, in.res.y + v1);
  }

  __device__ __forceinline__ void store_norm(int row, int col, float v0, float v1, float mean,
                                             float inv) const {
    const ll o = (ll)row * ldc + col;
    if (raw) *reinterpret_cast<float2*>(raw + o) = make_float2(v0, v1);
    const float2 g = *reinterpret_cast<const float2*>(ln_scale + col);
    const float2 b = *reinterpret_cast<const float2*>(ln_bias + col);
    const float y0 = (v0 - mean) * inv * g.x + b.x, y1 = (v1 - mean) * inv * g.y + b.y;
    *reinterpret_cast<float2*>(c + o) = make_float2(y0, y1);
    if (cb)
      *reinterpret_cast<__nv_bfloat162*>(cb + (ll)row * ldc + col) = __floats2bfloat162_rn(y0, y1);
  }
};

// dst = src rounded to bf16, n elements.
__global__ void to_bf16_kernel(const float* __restrict__ src, bf16* __restrict__ dst, ll n) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (ll)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

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

// ------------------------------------------------- K3a's attention core
//
// q and k of query i of row r are at qk[(r L + i) ld + h dh + e] and
// qk[(r L + i) ld + D + h dh + e] (bf16 in bf16 mode, f32 otherwise), v at
// v[(r L + i) ldv + h dh + e] (f32); the measures and the selection are
// (R, H, L).

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16* p, float v) { *p = __float2bfloat16(v); }

// The measure on tensor cores (bf16 q, k; dh a multiple of 16; D <= 128).
// Warp w owns queries 16 w .. 16 w + 15 of the block's tile; per 64-key
// tile it keeps the counts of its accumulator positions in registers and
// runs every head's q k^T through mma.sync, adding cnt * qk and the max
// over cnt > 0 into each head's running sums. Keys and queries past L are
// zeros with count 0.
__global__ void __launch_bounds__(MEAS_THREADS)
measure_mma_kernel(const bf16* __restrict__ qk, ll ld, const float* __restrict__ cnt,
                   float* __restrict__ meas, int L, int D, int H) {
  extern __shared__ __align__(16) unsigned char smem_u8[];
  const int ldq = D + 8;  // bf16 per staged row: fragment loads free of bank conflicts
  bf16* qs = reinterpret_cast<bf16*>(smem_u8);
  bf16* ks = qs + QT * ldq;                                    // two stages
  float* cs = reinterpret_cast<float*>(ks + 2 * KT * ldq);     // two stages
  const int row = blockIdx.x, i0 = blockIdx.y * QT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int dh = D / H, chunks = D / 8;
  const bf16* rows = qk + (ll)row * L * ld;

  for (int c = tid; c < QT * chunks; c += MEAS_THREADS) {
    const int r = c / chunks, cc = c % chunks, i = i0 + r;
    attn::cp_async16(qs + r * ldq + cc * 8, rows + (ll)min(i, L - 1) * ld + cc * 8, i < L);
  }
  auto load_tile = [&](int tile) {
    const int j0 = tile * KT;
    bf16* kd = ks + (tile & 1) * KT * ldq;
    for (int c = tid; c < KT * chunks; c += MEAS_THREADS) {
      const int r = c / chunks, cc = c % chunks, j = j0 + r;
      attn::cp_async16(kd + r * ldq + cc * 8, rows + (ll)min(j, L - 1) * ld + D + cc * 8, j < L);
    }
    float* cd = cs + (tile & 1) * QT * LDCNT;
    for (int c = tid; c < QT * KT; c += MEAS_THREADS) {
      const int r = c / KT, cc = c % KT, i = i0 + r, j = j0 + cc;
      const bool ok = i < L && j < L;
      attn::cp_async4(cd + r * LDCNT + cc, cnt + (ok ? (ll)i * L + j : 0), ok);
    }
    attn::cp_async_commit();
  };

  float sum[MAX_HEADS][2], mx[MAX_HEADS][2];
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[h][r] = 0.f;
      mx[h][r] = NEG_INF;
    }
  const int tiles = (L + KT - 1) / KT;
  load_tile(0);  // the q tile's copies complete with the first group
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      load_tile(tile + 1);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kb = ks + (tile & 1) * KT * ldq;
    const float* cb = cs + (tile & 1) * QT * LDCNT + 16 * warp * LDCNT;
    // counts at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of key tile n
    float cr[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      const float2 lo = *reinterpret_cast<const float2*>(cb + g * LDCNT + 8 * n + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(cb + (g + 8) * LDCNT + 8 * n + 2 * t);
      cr[n][0] = lo.x;
      cr[n][1] = lo.y;
      cr[n][2] = hi.x;
      cr[n][3] = hi.y;
    }
    const bf16* qw = qs + 16 * warp * ldq;
#pragma unroll
    for (int h = 0; h < MAX_HEADS; ++h) {
      if (h < H) {
        float c[KT / 8][4];
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
        for (int col = h * dh; col < (h + 1) * dh; col += 16) {
          uint32_t af[4];
          af[0] = *reinterpret_cast<const uint32_t*>(qw + g * ldq + col + 2 * t);
          af[1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * ldq + col + 2 * t);
          af[2] = *reinterpret_cast<const uint32_t*>(qw + g * ldq + col + 2 * t + 8);
          af[3] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * ldq + col + 2 * t + 8);
#pragma unroll
          for (int n = 0; n < KT / 8; ++n) {
            const bf16* kr = kb + (8 * n + g) * ldq + col + 2 * t;
            attn::mma_bf16(c[n], af, *reinterpret_cast<const uint32_t*>(kr),
                           *reinterpret_cast<const uint32_t*>(kr + 8));
          }
        }
#pragma unroll
        for (int n = 0; n < KT / 8; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            sum[h][r >> 1] += c[n][r] * cr[n][r];
            if (cr[n][r] > 0.f) mx[h][r >> 1] = fmaxf(mx[h][r >> 1], c[n][r]);
          }
      }
    }
    __syncthreads();  // the stage is refilled next
  }
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h) {
    if (h < H) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float s = attn::quad_sum(sum[h][r]), m = attn::quad_max(mx[h][r]);
        const int i = i0 + 16 * warp + g + 8 * r;
        if (t == 0 && i < L) meas[((ll)row * H + h) * L + i] = m - s / (float)L;
      }
    }
  }
}

// The measure by FMA (the f32 check path, and heads the tensor-core kernel
// does not take): one block per (row, 64 queries, head); thread 4 q + p
// scores query q against keys p, p + 4, ... of each 64-key tile.
template <typename T>
__global__ void __launch_bounds__(256)
measure_fma_kernel(const T* __restrict__ qk, ll ld, const float* __restrict__ cnt,
                   float* __restrict__ meas, int L, int D, int H) {
  extern __shared__ float smem_f[];
  const int row = blockIdx.x, i0 = blockIdx.y * QT, h = blockIdx.z, dh = D / H;
  const int dp = dh + 1;
  float* qs = smem_f;
  float* ks = qs + QT * dp;
  float* cs = ks + KT * dp;  // QT x (KT + 1)
  const T* base = qk + (ll)row * L * ld + h * dh;
  for (int x = threadIdx.x; x < QT * dh; x += blockDim.x) {
    const int r = x / dh, e = x % dh, i = i0 + r;
    qs[r * dp + e] = i < L ? ldf(base + (ll)i * ld + e) : 0.f;
  }
  const int qi = threadIdx.x / 4, part = threadIdx.x % 4, i = i0 + qi;
  float sum = 0.f, mx = NEG_INF;
  for (int j0 = 0; j0 < L; j0 += KT) {
    __syncthreads();
    for (int x = threadIdx.x; x < KT * dh; x += blockDim.x) {
      const int r = x / dh, e = x % dh, j = j0 + r;
      ks[r * dp + e] = j < L ? ldf(base + (ll)j * ld + D + e) : 0.f;
    }
    for (int x = threadIdx.x; x < QT * KT; x += blockDim.x) {
      const int r = x / KT, c = x % KT, ii = i0 + r, j = j0 + c;
      cs[r * (KT + 1) + c] = (ii < L && j < L) ? cnt[(ll)ii * L + j] : 0.f;
    }
    __syncthreads();
    for (int jj = part; jj < KT; jj += 4) {
      float s = 0.f;
      for (int e = 0; e < dh; ++e) s = fmaf(qs[qi * dp + e], ks[jj * dp + e], s);
      const float c = cs[qi * (KT + 1) + jj];
      sum += s * c;
      if (c > 0.f) mx = fmaxf(mx, s);
    }
  }
  sum = attn::quad_sum(sum);
  mx = attn::quad_max(mx);
  if (part == 0 && i < L) meas[((ll)row * H + h) * L + i] = mx - sum / (float)L;
}

// One block per (row, head): the rank-test selection, the mean of V for the
// other queries, and for the selected ones the f32 softmax of their
// recomputed scores and p.v, in one pass over VT-key tiles of k and v in
// shared memory. When all L keys fit one tile (the flagship's stacks), k, v
// and every query are loaded with the measures, in one round trip. Warp w
// owns 64 / DH selected queries at a time; lane l takes keys l, l + 32, ...
// of each tile and keeps, per query, a running max, the sum of exponentials
// and p.v over its keys (an online softmax); the lanes' partials are
// combined once per query at the end. DH (16, 32 or 64) bounds the head
// width dh.
template <int DH>
struct Sel {
  static constexpr int ROWS_PER_WARP = 64 / DH;
  static constexpr int ROWS = SEL_WARPS * ROWS_PER_WARP;  // selected queries per pass
  static constexpr int VT = 4096 / DH;                    // keys per tile
  static constexpr int DP = DH + 1;
};

template <typename T, int DH>
__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(const T* __restrict__ qk, ll ld, const float* __restrict__ v, ll ldv,
              const float* __restrict__ meas, int8_t* __restrict__ sel, T* __restrict__ att,
              int L, int D, int H, int u, float scale) {
  typedef Sel<DH> S;
  extern __shared__ float smem_f[];
  const int row = blockIdx.x, h = blockIdx.y, dh = D / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* m_s = smem_f;                                  // L measures
  int* idx = reinterpret_cast<int*>(m_s + L);           // the selected queries, in order
  float* q_s = reinterpret_cast<float*>(idx + L);       // ROWS x DH (zeros past dh)
  float* k_s = q_s + S::ROWS * DH;                      // VT x DP
  float* v_s = k_s + S::VT * S::DP;                     // VT x DP
  float* q_all = v_s + S::VT * S::DP;                   // VT x DH: every query, when whole
  float* parts = q_all + S::VT * DH;                    // SEL_THREADS partial column sums
  float* mean_v = parts + SEL_THREADS;                  // 64
  int& n_sel = *reinterpret_cast<int*>(mean_v + 64);    // 4 floats' room
  uint8_t* flag = reinterpret_cast<uint8_t*>(mean_v + 68);  // L
  const ll head = (ll)row * H + h;
  const T* qrow = qk + (ll)row * L * ld + h * dh;
  const float* vrow = v + (ll)row * L * ldv + h * dh;
  const bool whole = L <= S::VT;
  auto load_keys = [&](int j0) {  // keys j0 .. j0 + VT - 1 of k and v, zeros past L
    for (int x = tid; x < S::VT * dh; x += SEL_THREADS) {
      const int r = x / dh, e = x % dh, j = j0 + r;
      k_s[r * S::DP + e] = j < L ? ldf(qrow + (ll)j * ld + D + e) : 0.f;
      v_s[r * S::DP + e] = j < L ? vrow[(ll)j * ldv + e] : 0.f;
    }
  };
  for (int i = tid; i < L; i += SEL_THREADS) m_s[i] = meas[head * L + i];
  if (whole) {
    load_keys(0);
    for (int x = tid; x < L * DH; x += SEL_THREADS) {
      const int i = x / DH, e = x % DH;
      q_all[x] = e < dh ? ldf(qrow + (ll)i * ld + e) : 0.f;
    }
  }
  __syncthreads();
  for (int i = tid; i < L; i += SEL_THREADS) {
    const float mi = m_s[i];
    int rank = 0;
    for (int j = 0; j < L; ++j) rank += mi < m_s[j];
    flag[i] = rank < u;
    sel[head * L + i] = rank < u;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int b = 0; b < L; b += 32) {
      const bool f = b + lane < L && flag[b + lane];
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) idx[n + __popc(bal & ((1u << lane) - 1u))] = b + lane;
      n += __popc(bal);
    }
    if (lane == 0) n_sel = n;
  }
  // mean of V: thread t sums column t % dh over keys t / dh, t / dh + n, ...
  const int n_parts = SEL_THREADS / dh;
  if (tid < n_parts * dh) {
    float s = 0.f;
    if (whole) {
      for (int j = tid / dh; j < L; j += n_parts) s += v_s[j * S::DP + tid % dh];
    } else {
#pragma unroll 8
      for (int j = tid / dh; j < L; j += n_parts) s += vrow[(ll)j * ldv + tid % dh];
    }
    parts[tid] = s;
  }
  __syncthreads();
  if (tid < dh) {
    float s = 0.f;
    for (int p = 0; p < n_parts; ++p) s += parts[p * dh + tid];
    mean_v[tid] = s / (float)L;
  }
  __syncthreads();
  T* orow = att + (ll)row * L * D + h * dh;
  for (int x = tid; x < L * dh; x += SEL_THREADS) {
    const int i = x / dh, e = x % dh;
    if (!flag[i]) stf(orow + (ll)i * D + e, mean_v[e]);
  }
  const int ns = n_sel;
  for (int c0 = 0; c0 < ns; c0 += S::ROWS) {
    __syncthreads();
    for (int x = tid; x < S::ROWS * DH; x += SEL_THREADS) {
      const int r = x / DH, e = x % DH;
      if (c0 + r >= ns || e >= dh) q_s[x] = 0.f;
      else q_s[x] = whole ? q_all[idx[c0 + r] * DH + e] : ldf(qrow + (ll)idx[c0 + r] * ld + e);
    }
    float mx[S::ROWS_PER_WARP], sum[S::ROWS_PER_WARP], acc[S::ROWS_PER_WARP][DH];
#pragma unroll
    for (int r = 0; r < S::ROWS_PER_WARP; ++r) {
      mx[r] = NEG_INF;
      sum[r] = 0.f;
#pragma unroll
      for (int e = 0; e < DH; ++e) acc[r][e] = 0.f;
    }
    for (int j0 = 0; j0 < L; j0 += S::VT) {
      __syncthreads();
      if (!whole) load_keys(j0);
      __syncthreads();
      const int nk = min(S::VT, L - j0);
      for (int jj = lane; jj < nk; jj += 32) {
        float kr[DH];
#pragma unroll
        for (int e = 0; e < DH; ++e) kr[e] = e < dh ? k_s[jj * S::DP + e] : 0.f;
#pragma unroll
        for (int r = 0; r < S::ROWS_PER_WARP; ++r) {
          const int rr = warp * S::ROWS_PER_WARP + r;
          if (c0 + rr < ns) {
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < DH; ++e) s = fmaf(q_s[rr * DH + e], kr[e], s);
            s *= scale;
            if (s > mx[r]) {  // rescale this lane's partials to the new max
              const float f = expf(mx[r] - s);
              sum[r] *= f;
#pragma unroll
              for (int e = 0; e < DH; ++e) acc[r][e] *= f;
              mx[r] = s;
            }
            const float ex = expf(s - mx[r]);
            sum[r] += ex;
#pragma unroll
            for (int e = 0; e < DH; ++e)
              if (e < dh) acc[r][e] = fmaf(ex, v_s[jj * S::DP + e], acc[r][e]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < S::ROWS_PER_WARP; ++r) {
      const int rr = warp * S::ROWS_PER_WARP + r;
      if (c0 + rr < ns) {  // warp-uniform
        const float m_all = warp_max(mx[r]);
        const float f = expf(mx[r] - m_all);
        const float total = warp_sum(sum[r] * f);
        float out[2] = {0.f, 0.f};  // columns lane and lane + 32
#pragma unroll
        for (int e = 0; e < DH; ++e) {
          const float a = warp_sum(acc[r][e] * f);
          if (lane == e % 32) out[e / 32] = a;
        }
        const ll o = (ll)idx[c0 + rr] * D;
        if (lane < dh) stf(orow + o + lane, out[0] / total);
        if (lane + 32 < dh) stf(orow + o + lane + 32, out[1] / total);
      }
    }
  }
}

size_t measure_mma_smem_bytes(int D) {
  return (size_t)(QT + 2 * KT) * (D + 8) * sizeof(bf16) + 2 * (size_t)QT * LDCNT * sizeof(float);
}

size_t measure_fma_smem_bytes(int dh) {
  return sizeof(float) * ((size_t)(QT + KT) * (dh + 1) + (size_t)QT * (KT + 1));
}

// The head-width bucket of the select kernel: 16, 32 or 64.
int sel_dh(int dh) { return dh <= 16 ? 16 : dh <= 32 ? 32 : 64; }

size_t select_smem_bytes(int L, int dh) {
  const int DH = sel_dh(dh), VT = 4096 / DH;
  return sizeof(float) * (2 * (size_t)L + SEL_WARPS * 64 + 2 * VT * (DH + 1) + VT * DH +
                          SEL_THREADS + 68) +
         (size_t)L;
}

// -------------------------------------------- K3b's attention block
//
// One block per (row, head). Shared memory: q, k (values of the compute
// type), v (f32) and g, each L x (dh + 1); the score tile L x (L + 1); the
// selection (L): 208 tokens at 16-wide heads.

struct AttnSmem {
  float *q, *k, *v, *g, *s, *sel;
  int dhp, lp;
};

__device__ __forceinline__ AttnSmem attn_layout(float* base, int L, int dh) {
  AttnSmem a;
  a.dhp = dh + 1;
  a.lp = L + 1;
  a.q = base;
  a.k = a.q + L * a.dhp;
  a.v = a.k + L * a.dhp;
  a.g = a.v + L * a.dhp;
  a.s = a.g + L * a.dhp;
  a.sel = a.s + L * a.lp;
  return a;
}

template <typename T>
__device__ void attn_load(const AttnSmem& a, const T* __restrict__ qk, ll ld,
                          const float* __restrict__ v, ll ldv, const float* __restrict__ gin,
                          const int8_t* __restrict__ sel, int row, int h, int L, int D, int H) {
  const int dh = D / H;
  for (int idx = threadIdx.x; idx < L * dh; idx += blockDim.x) {
    const int i = idx / dh, e = idx % dh;
    const ll r = (ll)row * L + i;
    a.q[i * a.dhp + e] = ldf(qk + r * ld + h * dh + e);
    a.k[i * a.dhp + e] = ldf(qk + r * ld + D + h * dh + e);
    a.v[i * a.dhp + e] = v[r * ldv + h * dh + e];
    a.g[i * a.dhp + e] = gin[r * D + h * dh + e];
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    a.sel[i] = sel[((ll)row * H + h) * L + i] ? 1.f : 0.f;
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

// The scores (on mma.sync with `mma`, else FMA) and their f32 softmax, left
// in a.s.
__device__ void attn_probs(const AttnSmem& a, int L, int dh, float scale, bool mma) {
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

// dq, dk, dv of one (row, head) into dqkv (M, 3D) from datt (M, D), for
// the selection the forward's core wrote (sel, (R, H, L)).
template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_kernel(const T* __restrict__ qk, ll ld, const float* __restrict__ v, ll ldv,
                const float* __restrict__ datt, const int8_t* __restrict__ sel,
                float* __restrict__ dqkv, int L, int D, int H, float scale, int bf16_mode) {
  extern __shared__ float smem_f[];
  const int row = blockIdx.x, h = blockIdx.y, dh = D / H;
  const bool mma = bf16_mode && dh == 16;  // the products of bf16 operands on tensor cores
  const AttnSmem a = attn_layout(smem_f, L, dh);
  attn_load(a, qk, ld, v, ldv, datt, sel, row, h, L, D, H);
  attn_probs(a, L, dh, scale, mma);
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
    const bool sel_i = a.sel[i] != 0.f;
    float dp[MAX_KEYS / 32];
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < MAX_KEYS / 32; ++jj) {
      const int j = lane + 32 * jj;
      float d = 0.f;
      if (sel_i && j < L)
        for (int e = 0; e < dh; ++e) d = fmaf(a.g[i * a.dhp + e], a.v[j * a.dhp + e], d);
      dp[jj] = d;
      if (sel_i && j < L) rs += d * a.s[i * a.lp + j];
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

size_t attn_smem_bytes(int L, int dh) {
  return sizeof(float) * (4 * (size_t)L * (dh + 1) + (size_t)L * (L + 1) + (size_t)L);
}

// The opt-in to SMEM_MAX bytes of dynamic shared memory, once per kernel.
template <auto K>
cudaError_t allow_smem() {
  static const cudaError_t err =
      cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  return err;
}

// ------------------------------------------------------------- the layer

constexpr int KW = 6;  // the derived weights

// Elements per layer of the 16 stacked weights (wq bq wk bk wv bv wout bout
// g1 b1 wff1 bff1 wff2 bff2 g2 b2) and of the derived ones: wqkv (D, 3D) f32,
// bqkv (3D) f32, and the bf16 (out, in) copies Wqkv^T (3D, D), Wout^T (D, D),
// Wff1^T (F, D), Wff2^T (D, F).
void weight_sizes(ll D, ll F, ll w[16], ll kw[KW]) {
  const ll sizes[16] = {D * D, D, D * D, D, D * D, D, D * D, D, D, D, D * F, F, F * D, D, D, D};
  const ll derived[KW] = {3 * D * D, 3 * D, 3 * D * D, D * D, F * D, D * F};
  for (int i = 0; i < 16; ++i) w[i] = sizes[i];
  for (int i = 0; i < KW; ++i) kw[i] = derived[i];
}

struct Layer {
  const float* w[16];
  const float *wqkv, *bqkv;
  const bf16 *wqkv_t, *wout_t, *wff1_t, *wff2_t;
  const float* cnt;
  const int8_t *m1, *m2, *m3;
  float keep;
  int R, L, D, F, H, u, act, use_bf16;
  cudaStream_t st;
  ll M() const { return (ll)R * L; }
};

struct Work {  // offsets into the float workspace
  float *qkv, *meas;
  int8_t* sel;
  float *att, *x1, *xn1, *f1, *a1, *z, *stage;
  bf16 *xb, *xn1b;  // bf16 copies of the layer input and of xn1
  float *dz, *df2, *df1, *dxn1, *dx1, *dnew, *datt, *dqkv;
  // backward: per-split partial products and column sums, LayerNorm partials
  float *pqkv, *pout, *pff1, *pff2, *cqkv, *cout, *cff1, *cff2, *ln1, *ln2, *end;
};

ll align4(ll n) { return (n + 3) / 4 * 4; }

// The workspace of one layer call over M rows (regions in floats, each on
// 16 bytes). bf16 mode keeps q|k as bf16 in the first M D floats of qkv and
// v in the next M D, att and a1 as bf16 in the first half of theirs, and
// the GEMMs' bf16 operands xb and xn1b in M D / 2 floats each. The
// backward (bwd) adds its gradients and, for S splits of the weight-grad
// products, their partials.
Work carve(float* ws, ll M, ll D, ll F, ll H, ll S, bool bwd) {
  Work w;
  w.qkv = ws;
  w.meas = w.qkv + 3 * M * D;
  w.sel = reinterpret_cast<int8_t*>(w.meas + align4(M * H));
  w.att = w.meas + align4(M * H) + align4((M * H + 3) / 4);
  w.x1 = w.att + M * D;
  w.xn1 = w.x1 + M * D;
  w.f1 = w.xn1 + M * D;
  w.a1 = w.f1 + M * F;
  w.z = w.a1 + M * F;
  w.stage = w.z + M * D;
  w.xb = reinterpret_cast<bf16*>(w.stage + M * D);
  w.xn1b = w.xb + M * D;
  w.dz = w.stage + 2 * M * D;
  if (!bwd) {
    w.end = w.dz;
    return w;
  }
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
  w.ln2 = w.ln1 + LN_BLOCKS * 2 * D;
  w.end = w.ln2 + LN_BLOCKS * 2 * D;
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

// C (M x N) = epilogue(A B) on the GEMM core's converting producer (bf16
// mode; A f32 or bf16) or the FMA path (f32 A). With `partial`, the product
// is split over K in chunks of k_chunk rows: split s writes its raw sums to
// partial[s] (M x N) and, with `colsum`, B's column sums over its rows to
// colsum[s] (N); no epilogue runs.
template <class TA>
cudaError_t gemm(const Layer& P, const TA* A, ll sam, ll sak, const float* B, ll sbk, ll sbn,
                 ll M, int N, int K, const Epi& e, float* partial = nullptr,
                 float* colsum = nullptr, int k_chunk = 0) {
  const gemm90::Problem pr =
      gemm90::problem((int)M, N, K, partial ? k_chunk : 0, partial, colsum);
  auto off = [](const void* q, int bytes) { return reinterpret_cast<uintptr_t>(q) % bytes; };
  if (N % 2 || e.ldc % 2 || off(e.c, 8) || off(e.bias, 8) || off(e.aux, 8) || off(e.res, 8) ||
      off(e.mask, 2) || off(partial, 8))
    return cudaErrorInvalidValue;  // the epilogue's pair loads and stores
  if (!P.use_bf16) {
    if constexpr (std::is_same<TA, float>::value) {
      dim3 grid((N + BN - 1) / BN, (unsigned)((M + BM - 1) / BM), pr.splits);
      gemm_f32_kernel<<<grid, GEMM_THREADS, 0, P.st>>>(A, sam, sak, B, sbk, sbn, pr, e);
      return cudaGetLastError();
    }
    return cudaErrorInvalidValue;
  }
  const bool a_k = sak == 1, b_k = sbk == 1;
  const ll lda = a_k ? sam : sak, ldb = b_k ? sbn : sbk;
  if ((!a_k && sam != 1) || (!b_k && sbn != 1)) return cudaErrorInvalidValue;
  static const CUtensorMap none{};
  const gemm90::Operand oa{A, lda}, ob{B, ldb};
  if (a_k && b_k)
    return gemm90::launch<Epi, false, true, true, TA>(none, none, oa, ob, pr, e, P.st);
  if (a_k) return gemm90::launch<Epi, false, true, false, TA>(none, none, oa, ob, pr, e, P.st);
  if (!b_k) return gemm90::launch<Epi, false, false, false, TA>(none, none, oa, ob, pr, e, P.st);
  return cudaErrorInvalidValue;
}

// C (M x N) = epilogue(A W^T) on the core's TMA producer: A (M, K) and W
// (N, K) bf16, K contiguous.
template <class E>
cudaError_t gemm_tma(const Layer& P, const bf16* A, const bf16* W, ll M, int N, int K,
                     const E& e) {
  CUtensorMap ma, mb;
  cudaError_t err = gemm90::tensor_map(&ma, A, K, M, K);
  if (err == cudaSuccess) err = gemm90::tensor_map(&mb, W, K, N, K);
  if (err != cudaSuccess) return err;
  const gemm90::Operand oa{A, K}, ob{W, K};
  return gemm90::launch<E, true, true, true>(ma, mb, oa, ob,
                                             gemm90::problem((int)M, N, K, 0, nullptr, nullptr),
                                             e, P.st);
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

#define RF_TRY(call) \
  if ((err = (call)) != cudaSuccess) return err

// The measure and the selected attention of every (row, head): att from
// q|k (T) with row stride ld and v with row stride ldv.
template <typename T>
cudaError_t attention(const Layer& P, const T* qk, ll ld, const float* v, ll ldv, float* meas,
                      int8_t* sel, T* att) {
  const int dh = P.D / P.H;
  const dim3 tiles(P.R, (P.L + QT - 1) / QT);
  cudaError_t err = cudaSuccess;
  if (std::is_same<T, bf16>::value && dh % 16 == 0 && P.D <= MAX_MMA_D) {
    RF_TRY(allow_smem<measure_mma_kernel>());
    measure_mma_kernel<<<tiles, MEAS_THREADS, measure_mma_smem_bytes(P.D), P.st>>>(
        reinterpret_cast<const bf16*>(qk), ld, P.cnt, meas, P.L, P.D, P.H);
  } else {
    RF_TRY(allow_smem<measure_fma_kernel<T>>());
    measure_fma_kernel<T><<<dim3(P.R, tiles.y, P.H), 256, measure_fma_smem_bytes(dh), P.st>>>(
        qk, ld, P.cnt, meas, P.L, P.D, P.H);
  }
  RF_TRY(cudaGetLastError());
  const dim3 grid(P.R, P.H);
  const size_t smem = select_smem_bytes(P.L, dh);
  if (sel_dh(dh) == 16) {
    RF_TRY((allow_smem<select_kernel<T, 16>>()));
    select_kernel<T, 16><<<grid, SEL_THREADS, smem, P.st>>>(qk, ld, v, ldv, meas, sel, att, P.L,
                                                            P.D, P.H, P.u, attn_scale(P));
  } else if (sel_dh(dh) == 32) {
    RF_TRY((allow_smem<select_kernel<T, 32>>()));
    select_kernel<T, 32><<<grid, SEL_THREADS, smem, P.st>>>(qk, ld, v, ldv, meas, sel, att, P.L,
                                                            P.D, P.H, P.u, attn_scale(P));
  } else {
    RF_TRY((allow_smem<select_kernel<T, 64>>()));
    select_kernel<T, 64><<<grid, SEL_THREADS, smem, P.st>>>(qk, ld, v, ldv, meas, sel, att, P.L,
                                                            P.D, P.H, P.u, attn_scale(P));
  }
  return cudaGetLastError();
}

// The f32 check path of a layer: FMA GEMMs (Epi), the attention core on f32
// q|k|v, separate LayerNorm rows; x1, f1 and z always kept.
cudaError_t forward_f32(const Layer& P, const float* x, float* y, int8_t* s, const Work& W) {
  const ll M = P.M(), D = P.D, F = P.F;
  const float* const* w = P.w;
  cudaError_t err = cudaSuccess;
  Epi e = epi(W.qkv, 3 * D);  // q|k|v = x Wqkv + bqkv
  e.bias = P.bqkv;
  RF_TRY(gemm(P, x, D, 1, P.wqkv, 3 * D, 1, M, 3 * P.D, P.D, e));
  RF_TRY(attention(P, (const float*)W.qkv, 3 * D, W.qkv + 2 * D, 3 * D, W.meas, s, W.att));
  e = epi(W.x1, D);  // x1 = x + drop(att Wout + bout)
  e.bias = w[7];
  e.mask = P.m1;
  e.keep = P.keep;
  e.res = x;
  RF_TRY(gemm(P, (const float*)W.att, D, 1, w[6], D, 1, M, P.D, P.D, e));
  layernorm(P, W.x1, w[8], w[9], W.xn1);
  e = epi(W.a1, F);  // a1 = drop(act(xn1 Wff1 + bff1)), f1 the pre-activation
  e.bias = w[11];
  e.pre = W.f1;
  e.act = P.act;
  e.mask = P.m2;
  e.keep = P.keep;
  RF_TRY(gemm(P, (const float*)W.xn1, D, 1, w[10], F, 1, M, P.F, P.D, e));
  e = epi(W.z, D);  // z = xn1 + drop(a1 Wff2 + bff2)
  e.bias = w[13];
  e.mask = P.m3;
  e.keep = P.keep;
  e.res = W.xn1;
  RF_TRY(gemm(P, (const float*)W.a1, F, 1, w[12], D, 1, M, P.D, P.F, e));
  if (y) layernorm(P, W.z, w[14], w[15], y);
  return cudaGetLastError();
}

// One layer forward from x into y (the backward's recompute: y null, and
// x1, f1 and z kept). sel: null (the workspace's) or (R, H, L) int8. In
// bf16 mode W.xb holds x rounded when xb_ready (the previous layer's LN2
// wrote it), and y's rounded copy is left there for the next layer (next).
cudaError_t forward(const Layer& P, const float* x, float* y, int8_t* sel, const Work& W,
                    bool recompute, bool xb_ready = false, bool next = false) {
  const ll M = P.M(), D = P.D, F = P.F;
  const float* const* w = P.w;
  int8_t* s = sel ? sel : W.sel;
  cudaError_t err = cudaSuccess;
  if (!P.use_bf16) return forward_f32(P, x, y, s, W);
  bf16* qk = reinterpret_cast<bf16*>(W.qkv);
  bf16* att = reinterpret_cast<bf16*>(W.att);
  bf16* a1 = reinterpret_cast<bf16*>(W.a1);
  if (!xb_ready) {
    const ll blocks = (M * D + 255) / 256;
    to_bf16_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, P.st>>>(x, W.xb, M * D);
  }
  // q|k|v = x Wqkv + bqkv: q|k rounded into the bf16 (M, 2D) block, v f32 after it
  const FwdEpi<0> qkv{W.qkv + M * D, D, qk, 2 * D, 2 * P.D, P.bqkv, nullptr, nullptr, 0, 1.f};
  RF_TRY(gemm_tma(P, W.xb, P.wqkv_t, M, 3 * P.D, P.D, qkv));
  RF_TRY(attention(P, (const bf16*)qk, 2 * D, W.qkv + M * D, D, W.meas, s, att));
  // xn1 = LN1(x + drop(att Wout + bout)), also rounded into xn1b
  const NormEpi n1{W.xn1, D, W.xn1b, w[7], P.m1, P.keep, x, w[8], w[9],
                   recompute ? W.x1 : nullptr, LN_EPS};
  RF_TRY(gemm_tma(P, att, P.wout_t, M, P.D, P.D, n1));
  // a1 = drop(act(xn1 Wff1 + bff1)) rounded; the recompute keeps f1, the pre-activation
  float* f1 = recompute ? W.f1 : nullptr;
  if (P.act == 1) {
    const FwdEpi<1> e{nullptr, 0, a1, F, P.F, w[11], f1, P.m2, F, P.keep};
    RF_TRY(gemm_tma(P, W.xn1b, P.wff1_t, M, P.F, P.D, e));
  } else {
    const FwdEpi<2> e{nullptr, 0, a1, F, P.F, w[11], f1, P.m2, F, P.keep};
    RF_TRY(gemm_tma(P, W.xn1b, P.wff1_t, M, P.F, P.D, e));
  }
  // y = LN2(xn1 + drop(a1 Wff2 + bff2)), rounded into xb for the next layer;
  // the recompute keeps z
  const NormEpi n2{y ? y : W.stage, D, next ? W.xb : nullptr, w[13], P.m3, P.keep, W.xn1,
                   w[14], w[15], recompute ? W.z : nullptr, LN_EPS};
  RF_TRY(gemm_tma(P, a1, P.wff2_t, M, P.D, P.F, n2));
  return cudaGetLastError();
}

cudaError_t backward(const Layer& P, const float* x0, const float* g, float* dx, int8_t* sel,
                     float* const* dw, const Work& W, int split_rows) {
  const ll M = P.M(), D = P.D, F = P.F;
  const int S = (int)((M + split_rows - 1) / split_rows);
  const float* const* w = P.w;
  const Epi none = epi(nullptr, 0);
  const int8_t* s = sel ? sel : W.sel;
  cudaError_t err = forward(P, x0, nullptr, sel, W, true);  // recompute
  if (err != cudaSuccess) return err;
  // norm2 and the FFN
  layernorm_bwd(P, W.z, w[14], g, W.dz, W.df2, P.m3, W.ln2);
  // dWff2 (F, D) = a1^T df2 and dbff2, split over the rows
  if (P.use_bf16) {
    RF_TRY(gemm(P, (const bf16*)W.a1, 1, F, W.df2, D, 1, P.F, P.D, (int)M, none, W.pff2,
                W.cff2, split_rows));
  } else {
    RF_TRY(gemm(P, (const float*)W.a1, 1, F, W.df2, D, 1, P.F, P.D, (int)M, none, W.pff2,
                W.cff2, split_rows));
  }
  Epi e = epi(W.df1, F);  // df1 = drop(df2 Wff2^T) * act'(f1)
  e.mask = P.m2;
  e.keep = P.keep;
  e.aux = W.f1;
  e.aux_act = P.act;
  RF_TRY(gemm(P, (const float*)W.df2, D, 1, w[12], 1, D, M, P.F, P.D, e));
  // dWff1 (D, F) = xn1^T df1 and dbff1
  RF_TRY(gemm(P, (const float*)W.xn1, 1, D, W.df1, F, 1, P.D, P.F, (int)M, none, W.pff1,
              W.cff1, split_rows));
  e = epi(W.dxn1, D);  // dxn1 = dz + df1 Wff1^T
  e.res = W.dz;
  RF_TRY(gemm(P, (const float*)W.df1, F, 1, w[10], 1, F, M, P.D, P.F, e));
  // norm1 and the out-projection
  layernorm_bwd(P, W.x1, w[8], W.dxn1, W.dx1, W.dnew, P.m1, W.ln1);
  if (P.use_bf16) {
    RF_TRY(gemm(P, (const bf16*)W.att, 1, D, W.dnew, D, 1, P.D, P.D, (int)M, none, W.pout,
                W.cout, split_rows));
  } else {
    RF_TRY(gemm(P, (const float*)W.att, 1, D, W.dnew, D, 1, P.D, P.D, (int)M, none, W.pout,
                W.cout, split_rows));
  }
  RF_TRY(gemm(P, (const float*)W.dnew, D, 1, w[6], 1, D, M, P.D, P.D,
              epi(W.datt, D)));  // datt = dnew Wout^T
  // attention, for the forward's selection
  const size_t smem = attn_smem_bytes(P.L, P.D / P.H);
  const dim3 grid(P.R, P.H);
  if (P.use_bf16) {
    RF_TRY(allow_smem<attn_bwd_kernel<bf16>>());
    attn_bwd_kernel<bf16><<<grid, ATT_THREADS, smem, P.st>>>(
        reinterpret_cast<const bf16*>(W.qkv), 2 * D, W.qkv + M * D, D, W.datt, s, W.dqkv, P.L,
        P.D, P.H, attn_scale(P), 1);
  } else {
    RF_TRY(allow_smem<attn_bwd_kernel<float>>());
    attn_bwd_kernel<float><<<grid, ATT_THREADS, smem, P.st>>>(
        W.qkv, 3 * D, W.qkv + 2 * D, 3 * D, W.datt, s, W.dqkv, P.L, P.D, P.H, attn_scale(P), 0);
  }
  RF_TRY(cudaGetLastError());
  // dWq|dWk|dWv (D, 3D) = x0^T dqkv and their bias grads, then
  // dx0 = dx1 + dqkv Wqkv^T
  RF_TRY(gemm(P, x0, 1, D, W.dqkv, 3 * D, 1, P.D, 3 * P.D, (int)M, none, W.pqkv, W.cqkv,
              split_rows));
  e = epi(dx, D);
  e.res = W.dx1;
  RF_TRY(gemm(P, (const float*)W.dqkv, 3 * D, 1, P.wqkv, 1, 3 * D, M, P.D, 3 * P.D, e));
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

// What every layer call takes; with `bwd`, also the backward's attention
// block (its L x L tile).
cudaError_t check_layer(const Layer& P, bool bwd) {
  if (P.R < 1 || P.L < 1 || P.D < 1 || P.F < 1 || P.H < 1 || P.D % P.H || P.u < 0 ||
      P.D / P.H > 64 || P.act < 1 || P.act > 2 || (P.M() + BM - 1) / BM > 65535 ||
      (P.L + QT - 1) / QT > 65535 || P.D % 4 || P.F % 4 ||
      (P.use_bf16 && (P.D != gemm90::BN || P.F % 8)))
    return cudaErrorInvalidValue;
  if (!P.wqkv || !P.bqkv ||
      (P.use_bf16 && (!P.wqkv_t || !P.wout_t || !P.wff1_t || !P.wff2_t)))
    return cudaErrorInvalidValue;
  if (select_smem_bytes(P.L, P.D / P.H) > SMEM_MAX) return cudaErrorInvalidValue;
  if (bwd && (attn_smem_bytes(P.L, P.D / P.H) > SMEM_MAX || P.L > MAX_KEYS))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Layer i of stacked weights w (16) and kw (4), counts cnt (layer stride
// cnt_stride) and masks (N, R, L, D|F|D) or null.
Layer make_layer(const float* const* w, const void* const* kw, int i, const float* cnt,
                 ll cnt_stride, const int8_t* m1, const int8_t* m2, const int8_t* m3,
                 float keep, int R, int L, int D, int F, int H, int u, int act, int bf16_mode,
                 void* stream) {
  Layer P;
  ll ws[16], ks[KW];
  weight_sizes(D, F, ws, ks);
  for (int k = 0; k < 16; ++k) P.w[k] = w[k] + i * ws[k];
  auto half = [&](int k) {
    return kw[k] ? static_cast<const bf16*>(kw[k]) + i * ks[k] : nullptr;
  };
  P.wqkv = static_cast<const float*>(kw[0]) + i * ks[0];
  P.bqkv = static_cast<const float*>(kw[1]) + i * ks[1];
  P.wqkv_t = half(2);
  P.wout_t = half(3);
  P.wff1_t = half(4);
  P.wff2_t = half(5);
  P.cnt = cnt + i * cnt_stride;
  const ll M = (ll)R * L;
  P.m1 = m1 ? m1 + i * M * D : nullptr;
  P.m2 = m2 ? m2 + i * M * F : nullptr;
  P.m3 = m3 ? m3 + i * M * D : nullptr;
  P.keep = keep;
  P.R = R;
  P.L = L;
  P.D = D;
  P.F = F;
  P.H = H;
  P.u = u;
  P.act = act;
  P.use_bf16 = bf16_mode;
  P.st = static_cast<cudaStream_t>(stream);
  return P;
}

}  // namespace

// K3a: y = the N-layer stack over R rows of L tokens, in one call. x, y:
// (R, L, D) f32. w: the 16 stacked f32 weights ((N, in, out) matrices, (N,
// D|F) vectors); kw: the six derived ones, wqkv (N, D, 3D) and bqkv (N, 3D)
// f32 (q|k|v side by side) and, in bf16 mode, the bf16 (out, in) copies
// Wqkv^T (N, 3D, D), Wout^T (N, D, D), Wff1^T (N, F, D) and Wff2^T (N, D, F)
// (else null). cnt: (L, L) f32 counts of layer i at cnt
// + i cnt_stride. m1, m2, m3: (N, R, L, D|F|D) int8 keep-masks or all null
// (eval). act: 1 gelu, 2 relu. xs: null, or (N, R, L, D) f32 that receives
// each layer's input (for the backward). sel: null, or (N, R, H, L) int8
// that receives each layer's top-u selection. ws: ws_floats floats, at least
// M (9 D + 2 F) + the measures (M H) and selection (M H bytes), each rounded
// up to 4 floats, for M = R L. Returns the first CUDA error (0 on success).
extern "C" int rf_perceive_stack_fwd(const float* x, float* y, float* xs, int8_t* sel,
                                     const float* const* w, const void* const* kw,
                                     const float* cnt, long long cnt_stride, const int8_t* m1,
                                     const int8_t* m2, const int8_t* m3, float keep, int N,
                                     int R, int L, int D, int F, int H, int u, int act,
                                     int bf16, float* ws, long long ws_floats, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const Layer first = make_layer(w, kw, 0, cnt, cnt_stride, m1, m2, m3, keep, R, L, D, F, H, u,
                                 act, bf16, stream);
  cudaError_t err = check_layer(first, false);
  if (err != cudaSuccess) return (int)err;
  const ll M = first.M();
  const Work W = carve(ws, M, D, F, H, 0, false);
  if (W.end - ws > ws_floats) return (int)cudaErrorInvalidValue;
  if (xs) {
    RF_TRY(cudaMemcpyAsync(xs, x, M * D * sizeof(float), cudaMemcpyDeviceToDevice, first.st));
  }
  for (int i = 0; i < N; ++i) {
    const Layer P = make_layer(w, kw, i, cnt, cnt_stride, m1, m2, m3, keep, R, L, D, F, H, u,
                               act, bf16, stream);
    // eval: the middle layers run in place in the workspace's stage rows
    const float* in = i == 0 ? x : (xs ? xs + i * M * D : W.stage);
    float* out = i == N - 1 ? y : (xs ? xs + (i + 1) * M * D : W.stage);
    RF_TRY(forward(P, in, out, sel ? sel + i * M * H : nullptr, W, false, i > 0, i < N - 1));
  }
  return (int)cudaSuccess;
}

// K3b: dx and the 16 weight grads (dw, same shapes as w, overwritten) of one
// layer at input x0 with upstream g (R, L, D) f32; w and kw the layer's own
// (no layer axis), other arguments as K3a's. sel: null, or (R, H, L) int8
// that receives the selection the recompute made (and the backward used).
// The weight-grad products are split over chunks of split_rows rows (a
// multiple of 64), S = ceil(M / split_rows); ws holds K3a's workspace + M
// (9 D + F) + S (4 D^2 + 2 D F + 5 D + F) + 512 D floats (ws_floats, checked).
extern "C" int rf_perceive_layer_bwd(const float* x0, const float* g, float* dx, int8_t* sel,
                                     const float* const* w, const void* const* kw,
                                     float* const* dw, const float* cnt, const int8_t* m1,
                                     const int8_t* m2, const int8_t* m3, float keep, int R,
                                     int L, int D, int F, int H, int u, int act, int bf16,
                                     int split_rows, float* ws, long long ws_floats,
                                     void* stream) {
  const Layer P = make_layer(w, kw, 0, cnt, 0, m1, m2, m3, keep, R, L, D, F, H, u, act, bf16,
                             stream);
  cudaError_t err = check_layer(P, true);
  if (err != cudaSuccess) return (int)err;
  if (split_rows < 64 || split_rows % 64) return (int)cudaErrorInvalidValue;
  const ll S = (P.M() + split_rows - 1) / split_rows;
  const Work W = carve(ws, P.M(), D, F, H, S, true);
  if (W.end - ws > ws_floats) return (int)cudaErrorInvalidValue;
  return (int)backward(P, x0, g, dx, sel, dw, W, split_rows);
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
  Layer P;
  P.use_bf16 = bf16;
  P.st = static_cast<cudaStream_t>(stream);
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
