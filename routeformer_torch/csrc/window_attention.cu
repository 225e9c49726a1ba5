// K2: SwinV2 window attention for Hopper (sm_90a).
//
// Replaces routeformer_tpu/ops/flash_attention.py::flash_window_attention
// (Pallas kernel _flash_window_kernel, pallas_call in _flash_window_forward).
//
// Computes, per window b and head h,
//   softmax(scale[h] * (q^ k^T) + bias[b % nb, h]) v
// where q^, k^ are the rows of q, k L2-normalised in f32 as
// x * rsqrt(max(sum x^2, 1e-12)) (cosine mode; plain q k^T otherwise), then
// rounded to bf16 for the tensor cores. Scores, softmax and the PV sum are
// f32; P is rounded to bf16 before PV, as the TPU kernel does.
//
// What bounds it on the H100: at the flagship shapes (n = 256, d = 32) a
// (window, head) does 4 n^2 d FLOPs on 4 n d bf16 values of q, k, v and the
// output, 128 FLOPs per byte, below the ~295 at which bf16 tensor cores and
// not HBM set the pace; the f32 bias (n^2 per head) is shared by every
// window of one kind. So moving bytes bounds it. The design never writes
// scores or P to device memory: they stay in shared memory. Each window
// kind's bias is read from the 50 MB L2 (16.8 MB at stage 0). One CTA per
// (query tile of 64 rows, head, window) gives thousands of CTAs for the
// 132 SMs. K and V of the head sit in shared memory (n x d bf16 each). The
// f32 score tile makes a CTA take ~110 KB of shared memory at n = 256, so
// two CTAs share an SM; this first version is far from its bound.
// The TPU's transposed (H*d, n) operand layout only avoided lane padding
// and is not carried over.
//
// Inputs q, k, v may be f32 (the fused block reads its f32 qkv buffer
// directly) or bf16; any element strides for (batch, head, token), unit
// stride along d. Output is bf16 with its own strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int QTILE = 64;   // query rows per CTA
constexpr int NWARPS = 4;   // 16 query rows per warp
constexpr int MAX_N = 256;  // keys per window the softmax registers hold
constexpr int COLS_PER_LANE = MAX_N / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

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

// One warp copies one token row of length D into shared memory as bf16,
// L2-normalised first when `normalise` is set; rows past n are zeros.
template <int D, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ src, bf16* dst,
                                         bool valid, bool normalise, int lane) {
  float vals[(D + 31) / 32];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < (D + 31) / 32; ++i) {
    int c = lane + 32 * i;
    float x = (valid && c < D) ? to_f(src[c]) : 0.f;
    vals[i] = x;
    ss += x * x;
  }
  float inv = 1.f;
  if (normalise) inv = rsqrtf(fmaxf(warp_sum(ss), 1e-12f));
#pragma unroll
  for (int i = 0; i < (D + 31) / 32; ++i) {
    int c = lane + 32 * i;
    if (c < D) dst[c] = __float2bfloat16(vals[i] * inv);
  }
}

template <int D, typename TIN>
__global__ void __launch_bounds__(NWARPS * 32)
window_attention_kernel(const TIN* __restrict__ q, const TIN* __restrict__ k,
                        const TIN* __restrict__ v, long long s_b, long long s_h,
                        long long s_n, const float* __restrict__ bias, int nb,
                        const float* __restrict__ scale, bf16* __restrict__ out,
                        long long o_b, long long o_h, long long o_n, int n,
                        int n_pad, int ld_s, int heads, int cosine) {
  // ld_s: f32 row stride of the score tile, max(n_pad, D) + 4, so that a
  // warp's 16 score rows can later hold its 16 x D output tile.
  constexpr int LDT = D + 8;  // bf16 row stride of the Q/K/V tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + n_pad * LDT;
  bf16* qs = vs + n_pad * LDT;
  float* s_tile = reinterpret_cast<float*>(qs + QTILE * LDT);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * QTILE;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long in_off = b * s_b + h * s_h;
  const bool normalise = cosine != 0;

  for (int r = warp; r < n_pad; r += NWARPS) {
    bool valid = r < n;
    load_row<D>(k + in_off + r * s_n, ks + r * LDT, valid, normalise, lane);
    load_row<D>(v + in_off + r * s_n, vs + r * LDT, valid, false, lane);
  }
  for (int r = warp; r < QTILE; r += NWARPS) {
    int i = q0 + r;
    load_row<D>(q + in_off + (long long)i * s_n, qs + r * LDT, i < n, normalise,
                lane);
  }
  __syncthreads();

  // S = Q K^T for this warp's 16 query rows.
  const int row0 = warp * 16;
  float* s_w = s_tile + row0 * ld_s;
  for (int j = 0; j < n_pad / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, qs + row0 * LDT + kk * 16, LDT);
      wmma::load_matrix_sync(fb, ks + (j * 16) * LDT + kk * 16, LDT);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(s_w + j * 16, acc, ld_s, wmma::mem_row_major);
  }
  __syncwarp();

  // Row softmax in f32; P (bf16) overwrites the front of each score row.
  const float sc = normalise ? scale[h] : 1.f;
  const float* bias_h =
      bias + ((b % nb) * heads + h) * (long long)n * n;
  bf16* p_w = reinterpret_cast<bf16*>(s_w);  // bf16 row stride 2 * ld_s
  for (int r = 0; r < 16; ++r) {
    const int i = q0 + row0 + r;
    float* srow = s_w + r * ld_s;
    float vals[COLS_PER_LANE];
    float mx = NEG_INF;
#pragma unroll
    for (int t = 0; t < COLS_PER_LANE; ++t) {
      int c = lane + 32 * t;
      float s = NEG_INF;
      if (c < n && i < n) s = srow[c] * sc + bias_h[(long long)i * n + c];
      vals[t] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < COLS_PER_LANE; ++t) {
      int c = lane + 32 * t;
      float e = (c < n && i < n) ? expf(vals[t] - mx) : 0.f;
      vals[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    bf16* prow = p_w + r * (2 * ld_s);
#pragma unroll
    for (int t = 0; t < COLS_PER_LANE; ++t) {
      int c = lane + 32 * t;
      if (c < n_pad) prow[c] = __float2bfloat16(sum > 0.f ? vals[t] / sum : 0.f);
    }
    __syncwarp();
  }

  // O = P V, then stage O (f32) over this warp's score rows.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[D / 16];
#pragma unroll
  for (int t = 0; t < D / 16; ++t) wmma::fill_fragment(oacc[t], 0.f);
  for (int j = 0; j < n_pad / 16; ++j) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, p_w + j * 16, 2 * ld_s);
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, vs + (j * 16) * LDT + t * 16, LDT);
      wmma::mma_sync(oacc[t], fa, fb, oacc[t]);
    }
  }
  __syncwarp();
  constexpr int LDO = D + 4;
#pragma unroll
  for (int t = 0; t < D / 16; ++t)
    wmma::store_matrix_sync(s_w + t * 16, oacc[t], LDO, wmma::mem_row_major);
  __syncwarp();

  const long long out_off = b * o_b + h * o_h;
  for (int r = 0; r < 16; ++r) {
    const int i = q0 + row0 + r;
    if (i >= n) break;
    for (int c = lane; c < D; c += 32)
      out[out_off + (long long)i * o_n + c] = __float2bfloat16(s_w[r * LDO + c]);
  }
}

template <int D, typename TIN>
cudaError_t launch(const void* q, const void* k, const void* v, long long s_b,
                   long long s_h, long long s_n, const float* bias, int nb,
                   const float* scale, bf16* out, long long o_b, long long o_h,
                   long long o_n, int batch, int heads, int n, int cosine,
                   cudaStream_t stream) {
  const int n_pad = (n + 15) / 16 * 16;
  const int ld_s = (n_pad > D ? n_pad : D) + 4;
  const size_t smem = (size_t)(2 * n_pad + QTILE) * (D + 8) * sizeof(bf16) +
                      (size_t)QTILE * ld_s * sizeof(float);
  auto kernel = window_attention_kernel<D, TIN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + QTILE - 1) / QTILE, heads, batch);
  kernel<<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const TIN*>(q), static_cast<const TIN*>(k),
      static_cast<const TIN*>(v), s_b, s_h, s_n, bias, nb, scale, out, o_b, o_h,
      o_n, n, n_pad, ld_s, heads, cosine);
  return cudaGetLastError();
}

template <typename TIN>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       long long s_b, long long s_h, long long s_n,
                       const float* bias, int nb, const float* scale, bf16* out,
                       long long o_b, long long o_h, long long o_n, int batch,
                       int heads, int n, int cosine, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<16, TIN>(q, k, v, s_b, s_h, s_n, bias, nb, scale, out, o_b,
                             o_h, o_n, batch, heads, n, cosine, stream);
    case 32:
      return launch<32, TIN>(q, k, v, s_b, s_h, s_n, bias, nb, scale, out, o_b,
                             o_h, o_n, batch, heads, n, cosine, stream);
    case 64:
      return launch<64, TIN>(q, k, v, s_b, s_h, s_n, bias, nb, scale, out, o_b,
                             o_h, o_n, batch, heads, n, cosine, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rf_window_attention(const void* q, const void* k, const void* v,
                                   int in_bf16, long long s_b, long long s_h,
                                   long long s_n, const float* bias, int nb,
                                   const float* scale, void* out, long long o_b,
                                   long long o_h, long long o_n, int batch,
                                   int heads, int n, int d, int cosine,
                                   void* stream) {
  if (n < 1 || n > MAX_N || nb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* o = static_cast<bf16*>(out);
  cudaError_t err =
      in_bf16 ? dispatch_d<bf16>(d, q, k, v, s_b, s_h, s_n, bias, nb, scale, o,
                                 o_b, o_h, o_n, batch, heads, n, cosine, st)
              : dispatch_d<float>(d, q, k, v, s_b, s_h, s_n, bias, nb, scale, o,
                                  o_b, o_h, o_n, batch, heads, n, cosine, st);
  return (int)err;
}
