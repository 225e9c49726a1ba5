// K1: the fused SwinV2 block for Hopper (sm_90a), as a short pipeline.
//
// Replaces routeformer_tpu/ops/swin_block_fusion.py::fused_swin_block_forward
// (Pallas kernel _fused_block_kernel). The TPU kernel keeps a block's whole
// weight set in VMEM for each window: 12 C^2 bf16 values, 6.3 MB at stage 2
// and 25 MB at stage 3, against the 227 KB of shared memory an H100 block
// can use, and one program per window would give only 24 CTAs at stage 2
// for 132 SMs. So on Hopper the block runs over all windows at once as
//   1. qkv  = x W_qkv^T + b_qkv            (gemm_bias_act, f32 out)
//   2. attn = window attention (K2, window_attention.cu; bf16 out)
//   3. a    = attn W_proj^T + b_proj       (gemm_bias_act, f32 out)
//   4. x1   = x + LN1(a)                   (residual_layernorm, f32 + bf16)
//   5. y    = gelu_tanh(x1 W_fc1^T + b)    (gemm_bias_act, bf16 out)
//   6. y2   = y W_fc2^T + b_fc2            (gemm_bias_act, f32 out)
//   7. out  = x1 + LN2(y2)                 (residual_layernorm, out dtype)
// keeping the TPU kernel's rounding points: matmul operands bf16 with f32
// accumulation, qkv f32 until the normalisation, the residual stream f32
// inside the block, one rounding of the output.
//
// What bounds it: the four GEMMs carry 24 C^2 FLOPs per token (plus the
// attention's 4 n C), so at the flagship shapes the block is bound by
// tensor-core work; the intermediates (qkv, a, y, y2) make a round trip
// through device memory, which the TPU kernel avoided and a later fused
// design can remove. This first version is a tiled GEMM on bf16 tensor
// cores (WMMA 16x16x16, f32 accumulate) fed by a two-stage cp.async ring,
// with the bias, activation and output cast in its epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int GEMM_THREADS = 128;  // 4 warps, 2 x 2, each 32 x 32
constexpr int LDA_S = BK + 8;      // bf16 row stride of the staged tiles
constexpr int LDC_S = BN + 4;      // f32 row stride of the epilogue tile
constexpr int STAGE_ELEMS = (BM + BN) * LDA_S;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_size = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_size));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// Stage one BM x BK tile of A and one BN x BK tile of W (both K-contiguous).
__device__ __forceinline__ void load_stage(bf16* st, const bf16* __restrict__ A,
                                           const bf16* __restrict__ W, int M,
                                           int N, int K, int m0, int n0,
                                           int k0) {
  bf16* as = st;
  bf16* ws = st + BM * LDA_S;
  // 8 bf16 (16 bytes) per copy; BM * BK / 8 = 256 copies per operand.
  for (int idx = threadIdx.x; idx < BM * BK / 8; idx += GEMM_THREADS) {
    int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
    int gk = k0 + c;
    int gm = m0 + r;
    bool pa = gm < M && gk < K;
    cp_async16(as + r * LDA_S + c, pa ? A + (long long)gm * K + gk : A, pa);
    int gn = n0 + r;
    bool pw = gn < N && gk < K;
    cp_async16(ws + r * LDA_S + c, pw ? W + (long long)gn * K + gk : W, pw);
  }
}

// C[M, N] = act(A[M, K] W[N, K]^T + bias[N]); C is f32 or bf16, row-major.
template <typename TOUT, int ACT>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bias_act_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                     const float* __restrict__ bias, TOUT* __restrict__ C,
                     int M, int N, int K) {
  __shared__ __align__(128) unsigned char smem[2 * STAGE_ELEMS * sizeof(bf16)];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int kt_total = (K + BK - 1) / BK;
  load_stage(stages, A, W, M, N, K, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_total; ++kt) {
    if (kt + 1 < kt_total) {
      load_stage(stages + ((kt + 1) & 1) * STAGE_ELEMS, A, W, M, N, K, m0, n0,
                 (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = stages + (kt & 1) * STAGE_ELEMS;
    const bf16* ws = as + BM * LDA_S;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm + 16 * i) * LDA_S + kk, LDA_S);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], ws + (wn + 16 * j) * LDA_S + kk, LDA_S);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue through shared memory (the staging ring is free now).
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + 16 * i) * LDC_S + wn + 16 * j,
                              acc[i][j], LDC_S, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += GEMM_THREADS) {
    int r = idx / BN, c = idx % BN;
    int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      float v = cs[r * LDC_S + c] + bias[gn];
      if (ACT == 1) v = gelu_tanh(v);
      if constexpr (sizeof(TOUT) == 2)
        C[(long long)gm * N + gn] = __float2bfloat16(v);
      else
        C[(long long)gm * N + gn] = v;
    }
  }
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out = res + LN(a) per row (LayerNorm in f32: mean, then the mean of the
// squared deviations); one warp per row; writes f32 and/or bf16 outputs.
template <typename TRES>
__global__ void residual_layernorm_kernel(
    const float* __restrict__ a, const TRES* __restrict__ res,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ out_f32, bf16* __restrict__ out_bf16, int M, int C,
    float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= M) return;
  const float* ar = a + row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += ar[c];
  const float mu = warp_sum(s) / C;
  float ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    float d = ar[c] - mu;
    ss += d * d;
  }
  const float rstd = rsqrtf(warp_sum(ss) / C + eps);
  for (int c = lane; c < C; c += 32) {
    float v = load_f(res + row * C + c) + ((ar[c] - mu) * rstd * gamma[c] + beta[c]);
    if (out_f32) out_f32[row * C + c] = v;
    if (out_bf16) out_bf16[row * C + c] = __float2bfloat16(v);
  }
}

}  // namespace

// C = act(A W^T + bias). A: (M, K) bf16, W: (N, K) bf16, bias: (N,) f32,
// C: (M, N) f32 (c_bf16 = 0) or bf16. act: 0 none, 1 tanh gelu.
// K must be a multiple of 8. Returns cudaGetLastError().
extern "C" int rf_gemm_bias_act(const void* A, const void* W, const float* bias,
                                void* C, int c_bf16, int M, int N, int K,
                                int act, void* stream) {
  if (K % 8 != 0 || M < 1 || N < 1 || act < 0 || act > 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* w = static_cast<const bf16*>(W);
  if (c_bf16) {
    bf16* c = static_cast<bf16*>(C);
    if (act) gemm_bias_act_kernel<bf16, 1><<<grid, GEMM_THREADS, 0, st>>>(a, w, bias, c, M, N, K);
    else gemm_bias_act_kernel<bf16, 0><<<grid, GEMM_THREADS, 0, st>>>(a, w, bias, c, M, N, K);
  } else {
    float* c = static_cast<float*>(C);
    if (act) gemm_bias_act_kernel<float, 1><<<grid, GEMM_THREADS, 0, st>>>(a, w, bias, c, M, N, K);
    else gemm_bias_act_kernel<float, 0><<<grid, GEMM_THREADS, 0, st>>>(a, w, bias, c, M, N, K);
  }
  return (int)cudaGetLastError();
}

// out = res + LN(a). a: (M, C) f32; res: (M, C) f32 or bf16 (res_bf16);
// out_f32 / out_bf16 may each be null. Returns cudaGetLastError().
extern "C" int rf_residual_layernorm(const float* a, const void* res,
                                     int res_bf16, const float* gamma,
                                     const float* beta, float* out_f32,
                                     void* out_bf16, int M, int C, float eps,
                                     void* stream) {
  if (M < 1 || C < 1) return (int)cudaErrorInvalidValue;
  constexpr int ROWS = 8;
  dim3 grid((M + ROWS - 1) / ROWS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* ob = static_cast<bf16*>(out_bf16);
  if (res_bf16)
    residual_layernorm_kernel<bf16><<<grid, ROWS * 32, 0, st>>>(
        a, static_cast<const bf16*>(res), gamma, beta, out_f32, ob, M, C, eps);
  else
    residual_layernorm_kernel<float><<<grid, ROWS * 32, 0, st>>>(
        a, static_cast<const float*>(res), gamma, beta, out_f32, ob, M, C, eps);
  return (int)cudaGetLastError();
}
