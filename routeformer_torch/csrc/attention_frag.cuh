// Fragment-level helpers of the attention kernels (K2 window_attention.cu,
// K4 dense_attention.cu): cp.async copies, ldmatrix loads, the mma.sync
// m16n8k16 bf16 product with f32 accumulation, row reductions over its
// accumulator layout, and packing f32 accumulators into bf16 A fragments.
//
// Register layouts of mma.m16n8k16 (PTX ISA), lane l, g = l / 4, t = l % 4:
//   C (16 x 8 f32):  c[0], c[1] row g, cols 2t, 2t + 1; c[2], c[3] row g + 8.
//   A (16 x 16 bf16, pairs): a[0] row g, k 2t, 2t + 1; a[1] row g + 8;
//                            a[2] row g, k 2t + 8, 2t + 9; a[3] row g + 8.
//   B (16 x 8 bf16, pairs):  b[0] k 2t, 2t + 1, col g; b[1] k 2t + 8, 2t + 9.
// The four lanes of a quad hold the same two rows, so a row reduction is two
// xor-shuffles. Two neighbouring n8 C tiles of a 16-row strip, packed to
// bf16, are exactly the A fragment of the k16 step they cover: a score tile
// becomes the left operand of p.v without leaving registers. Each warp of a
// wgmma m64nN accumulator holds its 16 rows in the same C layout.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b (m16n8k16, bf16 operands, f32 accumulators).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Max and sum over the four lanes of a quad (one accumulator row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x on the special function unit (relative error ~2^-22).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two f32 values (k or column 2t, 2t + 1) as one bf16 pair, rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// The same pair as a bf16 high part and the bf16 rounding of what it leaves,
// x - high: together they carry x to 2^-17 of its value.
__device__ __forceinline__ void pack_split(float lo, float hi, uint32_t& high, uint32_t& low) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 hf = __bfloat1622float2(h);
  high = bits(h);
  low = pack_bf16(lo - hf.x, hi - hf.y);
}

// The A fragment of k16 step kk from an accumulator strip c (n8 tile j at
// c[4j..4j+3]; step kk covers tiles 2kk and 2kk + 1), rounded to bf16. Call
// it from unrolled loops only, so that every index is a constant.
__device__ __forceinline__ void acc_to_a(const float* c, int kk, uint32_t a[4]) {
  a[0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

// The same step as high and low A fragments (pack_split).
__device__ __forceinline__ void acc_to_a_split(const float* c, int kk, uint32_t hi[4],
                                               uint32_t lo[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) pack_split(c[8 * kk + 2 * i], c[8 * kk + 2 * i + 1], hi[i], lo[i]);
}

}  // namespace attn
