// K2: SwinV2 window attention for Hopper (sm_90a).
//
// Replaces routeformer_tpu/ops/flash_attention.py::flash_window_attention
// (Pallas kernel _flash_window_kernel, pallas_call in _flash_window_forward).
//
// Computes, per window b and head h,
//   softmax(scale[h] * (q^ k^T) + bias[b % nb, h]) v
// where q^, k^ are the rows of q, k L2-normalised in f32 as
// x * rsqrt(max(sum x^2, 1e-12)) (cosine mode; plain q k^T otherwise), then
// rounded to bf16 for the tensor cores. Scores and the softmax are f32, and
// P is normalised in f32 before it is rounded to bf16 for P.V, as the TPU
// kernel does (it rounds p / sum p); P.V accumulates in f32; the output is
// bf16.
//
// What bounds it on the H100: at the flagship shapes (n = 256, d = 32) a
// (window, head) does 4 n^2 d FLOPs on 4 n d values of q, k, v and the
// output, 128 FLOPs per byte even in bf16, below the ~295 at which the bf16
// tensor cores and not HBM set the pace. So moving bytes bounds it: per
// batch-1 flagship forward ~97 GFLOP (0.1 ms of tensor time) against a
// 0.258 ms byte bound, and 0.76 G exponentials (~0.2 ms on the special
// function units). The f32 bias (n^2 per head and window kind) is shared by
// the windows of one kind and read from the 50 MB L2, which the byte bound
// does not count: the 18 stage-2 blocks alone re-read ~1.8 GB of it.
//
// The design: one CTA of four warps per (window, head). The warps load K
// and V of the head once, with 16-byte loads (float4 of f32 or 8 bf16),
// several lanes per row and a shuffle for the row norm, and write them as
// bf16 into padded shared memory for ldmatrix. Each warp then walks its
// 16-row query strips: it stages the strip's bias rows with cp.async while
// it loads and normalises its 16 query rows and computes S = Q K^T with
// mma.sync m16n8k16, keeping S for all n keys in registers (16 x 256 f32 is
// 128 registers a thread). The exact row max and sum then give
// P = exp(s - m) / l, rounded to bf16 at the TPU's point and packed in
// registers into the A fragments of P.V, with V through ldmatrix.trans. O
// goes out through the strip's shared memory as 16-byte stores. Scores, P
// and O never leave registers; each window kind's bias is read from L2 once
// per (window, head). The TPU's transposed (H*d, n) operand layout only
// avoided lane padding and is not carried over. The softmax costs about
// eight instructions per score (scale, bias, max, 2^x on the special
// function unit, sum, normalise, pack); four partial maxima and sums per row
// and two P.V accumulator sets keep its dependency chains short, and a
// window with n equal to the keys held (256 or 64) skips the key masks.
//
// Where it still falls short of its bound: a CTA of 128 threads holds up to
// 255 registers a thread, so an SM runs two CTAs (eight warps), too few to
// hide the latency of the softmax chains and of the bias rows. Keeping a
// window kind's bias on chip across windows would need a CTA per block of
// rows that reloads K and V for every window: for the f32 inputs of the
// fused block that is as many L2 bytes as the bias it saves.
//
// Inputs q, k, v may be f32 (the fused block reads its f32 qkv buffer in
// place) or bf16; any (batch, head, token) element strides on 16-byte rows,
// unit stride along d. The output is bf16 with its own strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_frag.cuh"

using namespace attn;

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_N = 256;  // keys per window the score registers hold
constexpr float LOG2E = 1.4426950408889634f;

// One row chunk of 16 bytes (4 f32 or 8 bf16 values), loaded as raw bits.
__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack(uint4 u, float* x, float) {
  x[0] = __uint_as_float(u.x), x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z), x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(uint4 u, float* x, bf16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

// Rows of a (token, D) matrix are read by LPR = D / VEC consecutive lanes, one
// 16-byte chunk each (chunk lane % LPR).
template <int D, typename T>
struct RowGeom {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int LPR = D / VEC;
};

// One loaded chunk into shared memory as bf16 (row stride D + 8), the row
// L2-normalised first when `normalise` is set (a shuffle over the row's
// lanes, so every lane of the warp must call it together).
template <int D, typename T>
__device__ __forceinline__ void store_chunk(bf16* row, uint4 raw, bool normalise, int lane) {
  constexpr int VEC = RowGeom<D, T>::VEC, LPR = RowGeom<D, T>::LPR;
  float x[VEC];
  unpack(raw, x, T());
  if (normalise) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) ss += x[j] * x[j];
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = rsqrtf(fmaxf(ss, 1e-12f));
#pragma unroll
    for (int j = 0; j < VEC; ++j) x[j] *= inv;
  }
  uint32_t packed[VEC / 2];
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) packed[j] = pack_bf16(x[2 * j], x[2 * j + 1]);
  bf16* d = row + (lane % LPR) * VEC;
  if constexpr (VEC == 8)
    *reinterpret_cast<uint4*>(d) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  else
    *reinterpret_cast<uint2*>(d) = make_uint2(packed[0], packed[1]);
}

// Rows [0, rows) of a (token, D) matrix into shared memory (all threads of
// the CTA), U chunks in flight per thread; rows at or past n are zeros.
// `rows` is a multiple of 16, so the lanes of a warp stay in step around the
// shuffles.
template <int D, typename T, int U>
__device__ __forceinline__ void load_rows(bf16* dst, const T* __restrict__ src, long long s_n,
                                          int n, int rows, bool normalise) {
  constexpr int VEC = RowGeom<D, T>::VEC, LPR = RowGeom<D, T>::LPR;
  constexpr int STEP = NTHREADS / LPR;
  const int c = threadIdx.x % LPR;
  for (int base = threadIdx.x / LPR; base < rows; base += U * STEP) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * STEP;
      raw[u] = r < n ? ld16(src + (long long)r * s_n + c * VEC) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * STEP;
      if (r < rows) store_chunk<D, T>(dst + r * (D + 8), raw[u], normalise, threadIdx.x % 32);
    }
  }
}

// A warp's 16-row query strip: every chunk loaded at once (fetch_strip),
// stored later (store_strip), so the loads of the next strip fly while this
// one computes.
template <int D, typename T>
struct Strip {
  static constexpr int LPR = RowGeom<D, T>::LPR, PASSES = LPR / 2;
  uint4 raw[PASSES];
};

template <int D, typename T>
__device__ __forceinline__ void fetch_strip(Strip<D, T>& st, const T* __restrict__ src,
                                            long long s_n, int n, int row0, int lane) {
  constexpr int VEC = RowGeom<D, T>::VEC, LPR = RowGeom<D, T>::LPR;
#pragma unroll
  for (int u = 0; u < Strip<D, T>::PASSES; ++u) {
    const int i = row0 + lane / LPR + u * (32 / LPR);
    st.raw[u] = i < n ? ld16(src + (long long)i * s_n + (lane % LPR) * VEC)
                      : make_uint4(0, 0, 0, 0);
  }
}

template <int D, typename T>
__device__ __forceinline__ void store_strip(bf16* qw, const Strip<D, T>& st, bool normalise,
                                            int lane) {
  constexpr int LPR = RowGeom<D, T>::LPR;
#pragma unroll
  for (int u = 0; u < Strip<D, T>::PASSES; ++u)
    store_chunk<D, T>(qw + (lane / LPR + u * (32 / LPR)) * (D + 8), st.raw[u], normalise, lane);
}

// Bias rows [row0, row0 + 16) of one (n, n) head into a warp's f32 tile
// (row stride ldb), cp.async; rows past n are zeros.
__device__ __forceinline__ void stage_bias(float* bw, int ldb, const float* bias_h, int n,
                                           int row0, int lane) {
  if (n % 4 == 0) {
    const int cpr = n / 4;
    for (int idx = lane; idx < 16 * cpr; idx += 32) {
      const int r = idx / cpr, c = idx % cpr;
      const bool valid = row0 + r < n;
      cp_async16(bw + r * ldb + 4 * c,
                 valid ? bias_h + (long long)(row0 + r) * n + 4 * c : bias_h, valid);
    }
  } else {
    for (int idx = lane; idx < 16 * n; idx += 32) {
      const int r = idx / n, c = idx % n;
      const bool valid = row0 + r < n;
      cp_async4(bw + r * ldb + c, valid ? bias_h + (long long)(row0 + r) * n + c : bias_h,
                valid);
    }
  }
}

// NK: the most keys this instance holds (64 or MAX_N); n <= NK. FULL: n == NK,
// so no key is masked.
template <int D, int NK, bool FULL, typename TIN>
__global__ void __launch_bounds__(NTHREADS, 2)
window_attention_kernel(const TIN* __restrict__ q, const TIN* __restrict__ k,
                        const TIN* __restrict__ v, long long s_b, long long s_h,
                        long long s_n, const float* __restrict__ bias, int nb,
                        const float* __restrict__ scale, bf16* __restrict__ out,
                        long long o_b, long long o_h, long long o_n, int n, int heads,
                        int cosine) {
  constexpr int LDT = D + 8;  // bf16 row stride of the K, V and strip tiles
  const int n16 = (n + 15) / 16 * 16;
  const int ldb = n16 + 8;  // f32 row stride of a bias strip: conflict-free float2 reads
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  bf16* ks = reinterpret_cast<bf16*>(smem);  // n16 x LDT
  bf16* vs = ks + n16 * LDT;                 // n16 x LDT
  bf16* qw = vs + n16 * LDT + warp * 16 * LDT;  // this warp's 16 x LDT strip
  float* bw = reinterpret_cast<float*>(vs + n16 * LDT + NWARPS * 16 * LDT) + warp * 16 * ldb;

  const long long b = blockIdx.x;
  const int h = blockIdx.y;
  const long long in_off = b * s_b + h * s_h;
  const bool normalise = cosine != 0;
  const float* bias_h = bias + ((b % nb) * heads + h) * (long long)n * n;
  const int n_strips = n16 / 16;
  const bool has_strip = warp < n_strips;

  // The first strip's bias and query rows fly while K and V load.
  Strip<D, TIN> qnext;
  if (has_strip) {
    stage_bias(bw, ldb, bias_h, n, 16 * warp, lane);
    cp_async_commit();
    fetch_strip(qnext, q + in_off, s_n, n, 16 * warp, lane);
  }
  load_rows<D, TIN, 8>(ks, k + in_off, s_n, n, n16, normalise);
  load_rows<D, TIN, 8>(vs, v + in_off, s_n, n, n16, false);
  if (has_strip) store_strip(qw, qnext, normalise, lane);
  __syncthreads();

  const float sc = (normalise ? scale[h] : 1.f);
  bf16* ob = out + b * o_b + h * o_h;

  for (int st = warp; st < n_strips; st += NWARPS) {
    const int row0 = st * 16;
    const bool has_next = st + NWARPS < n_strips;
    __syncwarp();
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qa[kk], qw + ((lane % 8) + 8 * ((lane / 8) % 2)) * LDT + (2 * kk + lane / 16) * 8);
    if (has_next) fetch_strip(qnext, q + in_off, s_n, n, row0 + 16 * NWARPS, lane);

    // S = Q K^T for the strip's 16 rows and every key: n8 tile j at s[4j..4j+3].
    float s[NK / 2];
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < NK / 16; ++j2) {
      if (FULL || j2 < n_strips) {
        const int key = 16 * j2 + (lane % 8) + 8 * (lane / 16);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t bb[4];
          ldmatrix_x4(bb, ks + key * LDT + (2 * kk + (lane / 8) % 2) * 8);
          mma_bf16(s + 8 * j2, qa[kk], bb[0], bb[1]);
          mma_bf16(s + 8 * j2 + 4, qa[kk], bb[2], bb[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();

    // x = s * scale + bias in f32 (keys past n: -inf), and the row max over
    // four partial maxima (short dependency chains).
    float mx[2][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) mx[0][u] = mx[1][u] = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      const int col = 8 * j + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x0 = -INFINITY, x1 = -INFINITY;
        if (FULL || col < n) {
          const float2 bv = *reinterpret_cast<const float2*>(bw + (g + 8 * r) * ldb + col);
          x0 = __fadd_rn(__fmul_rn(s[4 * j + 2 * r], sc), bv.x);
          x1 = __fadd_rn(__fmul_rn(s[4 * j + 2 * r + 1], sc), bv.y);
          if (!FULL && col + 1 >= n) x1 = -INFINITY;
        }
        s[4 * j + 2 * r] = x0;
        s[4 * j + 2 * r + 1] = x1;
        mx[r][j % 4] = fmaxf(mx[r][j % 4], fmaxf(x0, x1));
      }
    }
    __syncwarp();  // every lane is done with the bias strip
    if (has_next) {
      stage_bias(bw, ldb, bias_h, n, row0 + 16 * NWARPS, lane);
      cp_async_commit();
    }

    // P = exp(x - max) / sum in f32: exp as 2^(x log2 e - max log2 e) on the
    // special function unit, the sum over four partial sums per row.
    float neg_m[2], sum[2][4], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      neg_m[r] = -LOG2E * quad_max(fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3])));
#pragma unroll
      for (int u = 0; u < 4; ++u) sum[r][u] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[4 * j + i] = exp2_approx(fmaf(s[4 * j + i], LOG2E, neg_m[i / 2]));
        sum[i / 2][j % 4] += s[4 * j + i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      inv[r] = 1.f / quad_sum((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[4 * j + i] *= inv[i / 2];

    // O = P V: P rounded to bf16 from the S registers, V through
    // ldmatrix.trans; OSETS accumulator sets take alternate key steps.
    constexpr int OSETS = D == 64 ? 1 : 2;
    float o[OSETS][D / 2];
#pragma unroll
    for (int u = 0; u < OSETS; ++u)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[u][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      if (FULL || kk < n_strips) {
        uint32_t pa[4];
        acc_to_a(s, kk, pa);
        const int key = 16 * kk + (lane % 8) + 8 * ((lane / 8) % 2);
        float* ok = o[kk % OSETS];
#pragma unroll
        for (int jd2 = 0; jd2 < D / 16; ++jd2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, vs + key * LDT + (2 * jd2 + lane / 16) * 8);
          mma_bf16(ok + 8 * jd2, pa, bb[0], bb[1]);
          mma_bf16(ok + 8 * jd2 + 4, pa, bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int u = 1; u < OSETS; ++u)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[0][i] += o[u][i];

    // O (bf16) through the strip's tile, then 16-byte stores of its rows.
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(qw + (g + 8 * r) * LDT + 8 * jd + 2 * t4) =
            pack_bf16(o[0][4 * jd + 2 * r], o[0][4 * jd + 2 * r + 1]);
    __syncwarp();
    for (int idx = lane; idx < 16 * (D / 8); idx += 32) {
      const int r = idx / (D / 8), c = idx % (D / 8);
      if (row0 + r < n)
        *reinterpret_cast<uint4*>(ob + (long long)(row0 + r) * o_n + 8 * c) =
            *reinterpret_cast<const uint4*>(qw + r * LDT + 8 * c);
    }
    __syncwarp();  // the strip tile is free for the next query rows
    if (has_next) store_strip(qw, qnext, normalise, lane);
  }
}

template <int D, int NK, bool FULL, typename TIN>
cudaError_t launch(const void* q, const void* k, const void* v, long long s_b, long long s_h,
                   long long s_n, const float* bias, int nb, const float* scale, bf16* out,
                   long long o_b, long long o_h, long long o_n, int batch, int heads, int n,
                   int cosine, cudaStream_t stream) {
  const int n16 = (n + 15) / 16 * 16;
  const size_t smem = (size_t)(2 * n16 + NWARPS * 16) * (D + 8) * sizeof(bf16) +
                      (size_t)NWARPS * 16 * (n16 + 8) * sizeof(float);
  auto kernel = window_attention_kernel<D, NK, FULL, TIN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch, heads);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const TIN*>(q), static_cast<const TIN*>(k), static_cast<const TIN*>(v), s_b,
      s_h, s_n, bias, nb, scale, out, o_b, o_h, o_n, n, heads, cosine);
  return cudaGetLastError();
}

template <typename TIN>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, long long s_b,
                     long long s_h, long long s_n, const float* bias, int nb, const float* scale,
                     bf16* out, long long o_b, long long o_h, long long o_n, int batch,
                     int heads, int n, int cosine, cudaStream_t stream) {
#define RF_LAUNCH(D, NK, FULL)                                                               \
  return launch<D, NK, FULL, TIN>(q, k, v, s_b, s_h, s_n, bias, nb, scale, out, o_b, o_h,   \
                                  o_n, batch, heads, n, cosine, stream)
#define RF_LAUNCH_D(D)                       \
  if (n == 64) RF_LAUNCH(D, 64, true);       \
  if (n < 64) RF_LAUNCH(D, 64, false);       \
  if (n == MAX_N) RF_LAUNCH(D, MAX_N, true); \
  RF_LAUNCH(D, MAX_N, false)
  switch (d) {
    case 16: RF_LAUNCH_D(16);
    case 32: RF_LAUNCH_D(32);
    case 64: RF_LAUNCH_D(64);
    default: return cudaErrorInvalidValue;
  }
#undef RF_LAUNCH_D
#undef RF_LAUNCH
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). q, k, v rows
// and the output rows must start on 16-byte boundaries.
extern "C" int rf_window_attention(const void* q, const void* k, const void* v, int in_bf16,
                                   long long s_b, long long s_h, long long s_n,
                                   const float* bias, int nb, const float* scale, void* out,
                                   long long o_b, long long o_h, long long o_n, int batch,
                                   int heads, int n, int d, int cosine, void* stream) {
  const int vec = in_bf16 ? 8 : 4;  // elements per 16 bytes
  if (n < 1 || n > MAX_N || nb < 1 || batch < 1 || heads < 1 || heads > 65535 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || s_b % vec ||
      s_h % vec || s_n % vec || o_b % 8 || o_h % 8 || o_n % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* o = static_cast<bf16*>(out);
  cudaError_t err = in_bf16 ? dispatch<bf16>(d, q, k, v, s_b, s_h, s_n, bias, nb, scale, o, o_b,
                                             o_h, o_n, batch, heads, n, cosine, st)
                            : dispatch<float>(d, q, k, v, s_b, s_h, s_n, bias, nb, scale, o,
                                              o_b, o_h, o_n, batch, heads, n, cosine, st);
  return (int)err;
}
