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
// attention's 4 n C), so at stages 2-3 the block is bound by tensor-core
// work; at stages 0-1 (C 128, 256) the intermediates' round trips through
// device memory (qkv f32, a, x1, y, y2: ~78 C bytes a token) outweigh it.
// The GEMMs run on the Hopper core of gemm_sm90.cuh: wgmma m64n128k16 fed by
// a TMA producer warp through a five-stage ring of 128-byte-swizzled tiles,
// persistent CTAs whose epilogue (bias, tanh gelu, the f32 or bf16 store)
// works on the accumulator registers while the next tile's loads are in
// flight. The wrapper caches the bf16 weights, so no cast runs per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// The GEMMs' epilogue: C[row, col..col+1] = act(v + bias), f32 or bf16.
struct BiasActEpi {
  const float* bias;
  void* c;
  int ldc, act, c_bf16;
  typedef float2 In;
  static constexpr int GROUP = 8;  // bias pairs fetched ahead of the stores
  __device__ __forceinline__ In fetch(int, int col) const {
    return *reinterpret_cast<const float2*>(bias + col);
  }
  __device__ __forceinline__ void store(int row, int col, float v0, float v1, In b) const {
    v0 += b.x;
    v1 += b.y;
    if (act) {
      v0 = gelu_tanh(v0);
      v1 = gelu_tanh(v1);
    }
    const long long o = (long long)row * ldc + col;
    if (c_bf16)
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(c) + o) = __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(c) + o) = make_float2(v0, v1);
  }
};

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

// C = act(A W^T + bias). A: (M, K) bf16, W: (N, K) bf16, bias: (N,) f32
// on 8 bytes, C: (M, N) f32 (c_bf16 = 0) or bf16. act: 0 none, 1 tanh
// gelu. K must be a multiple of 8, N even, A and W on 16-byte boundaries.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rf_gemm_bias_act(const void* A, const void* W, const float* bias,
                                void* C, int c_bf16, int M, int N, int K,
                                int act, void* stream) {
  if (K % 8 != 0 || M < 1 || N < 1 || N % 2 || act < 0 || act > 1 ||
      reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(W) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  cudaError_t err = gemm90::tensor_map(&ma, A, K, M, K);
  if (err == cudaSuccess) err = gemm90::tensor_map(&mb, W, K, N, K);
  if (err != cudaSuccess) return (int)err;
  const BiasActEpi epi{bias, C, N, act, c_bf16};
  const gemm90::Operand oa{A, K}, ob{W, K};
  return (int)gemm90::launch<BiasActEpi, true, true, true>(
      ma, mb, oa, ob, gemm90::problem(M, N, K, 0, nullptr, nullptr), epi,
      static_cast<cudaStream_t>(stream));
}

namespace {

cudaError_t gemm_bias_act(const void* A, const void* W, const float* bias, void* C, int c_bf16,
                          int M, int N, int K, int act, cudaStream_t st) {
  return (cudaError_t)rf_gemm_bias_act(A, W, bias, C, c_bf16, M, N, K, act, st);
}

cudaError_t residual_layernorm(const float* a, const void* res, int res_bf16, const float* gamma,
                               const float* beta, float* out_f32, bf16* out_bf16, int M, int C,
                               float eps, cudaStream_t st) {
  constexpr int ROWS = 8;
  dim3 grid((M + ROWS - 1) / ROWS);
  if (res_bf16)
    residual_layernorm_kernel<bf16><<<grid, ROWS * 32, 0, st>>>(
        a, static_cast<const bf16*>(res), gamma, beta, out_f32, out_bf16, M, C, eps);
  else
    residual_layernorm_kernel<float><<<grid, ROWS * 32, 0, st>>>(
        a, static_cast<const float*>(res), gamma, beta, out_f32, out_bf16, M, C, eps);
  return cudaGetLastError();
}

}  // namespace

// The block after its attention, steps 3-7, in one call: a = attn
// W_proj^T + b_proj, x1 = x + LN1(a) (f32 and bf16), y = gelu(x1 W_fc1^T +
// b_fc1) (bf16), y2 = y W_fc2^T + b_fc2, out = x1 + LN2(y2). x: (M, C) bf16
// (x_bf16) or f32; attn: (M, C) bf16; the weights bf16 (out, in), the rest
// f32; out: (M, C) bf16 (out_bf16) or f32. ws: 11 M C / 2 floats on 16
// bytes (a, x1, x1 in bf16, y, y2); C a multiple of 8. Returns the first
// CUDA error (0 on success).
extern "C" int rf_swin_block_tail(const void* x, int x_bf16, const void* attn,
                                  const void* wproj, const float* bproj, const float* g1,
                                  const float* b1, const void* wfc1, const float* bfc1,
                                  const void* wfc2, const float* bfc2, const float* g2,
                                  const float* b2, void* out, int out_bf16, float* ws, int M,
                                  int C, float eps, void* stream) {
  if (M < 1 || C < 8 || C % 8 || reinterpret_cast<uintptr_t>(ws) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long mc = (long long)M * C;
  float* a = ws;
  float* x1 = a + mc;
  bf16* x1b = reinterpret_cast<bf16*>(x1 + mc);
  bf16* y = x1b + mc;
  float* y2 = reinterpret_cast<float*>(y + 4 * mc);
  cudaError_t err = gemm_bias_act(attn, wproj, bproj, a, 0, M, C, C, 0, st);
  if (err == cudaSuccess)
    err = residual_layernorm(a, x, x_bf16, g1, b1, x1, x1b, M, C, eps, st);
  if (err == cudaSuccess) err = gemm_bias_act(x1b, wfc1, bfc1, y, 1, M, 4 * C, C, 1, st);
  if (err == cudaSuccess) err = gemm_bias_act(y, wfc2, bfc2, y2, 0, M, C, 4 * C, 0, st);
  if (err == cudaSuccess)
    err = residual_layernorm(y2, x1, 0, g2, b2, out_bf16 ? nullptr : static_cast<float*>(out),
                             out_bf16 ? static_cast<bf16*>(out) : nullptr, M, C, eps, st);
  return (int)err;
}
