// Helpers shared by the kernels (paged, flash and decode attention, WKV6,
// the Mamba scan): element loads as fp32, stores in the output type, the
// masked-score value, the tensor-core fragment helpers of the bf16 flash,
// paged and decode kernels (cp.async, ldmatrix, mma.sync m16n8k16), the
// 3xTF32 products of the fp32 flash kernel (mma.sync m16n8k8), and the
// merge of split-KV results of the paged and decode kernels.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace repro_attn {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to T and back: the probabilities are cast to V's type before
// the PV product, as the Pallas kernels do (`p.astype(v.dtype)`).
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// Eight consecutive elements as fp32, in one or two 16-byte loads; the
// caller guarantees 16-byte alignment (the wrappers check base pointers,
// and every row is a multiple of 8 elements).
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------
// tensor-core fragments (sm_80 and later): cp.async, ldmatrix, mma.sync

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !full (src-size 0:
// nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16, lo in the low half: the element of the lower
// column, as the mma fragments order a pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 3xTF32: an fp32 operand x is split into big = tf32(x) and small =
// tf32(x - big), both rounded to nearest with ties away from zero
// (x - big is exact in fp32), and a product is taken as a_small b_big +
// a_big b_small + a_big b_big in fp32 accumulators, the small x small term
// dropped: a few units of 2^-22 of relative error a product, where TF32
// alone (the big term) gives up to 2^-11, on the tensor cores.  It is
// what CUTLASS calls OpMultiplyAddFastF32 and what PyTorch's fp32
// memory-efficient attention runs on sm_80 and later.
//
// The rounding is cvt.rna's for finite values, in integer ops: half a
// TF32 unit (0x1000) added to the bits, which carries into the magnitude,
// then the 13 low bits cleared for big (its value is needed for x - big);
// small keeps them, since the tensor cores read only the top 19 bits of a
// tf32 operand.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// c += a (16x8, row) * b (8x8, col), tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32, from the (big, small) parts of both operands
__device__ __forceinline__ void mma_tf32x3(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           uint32_t b0_big, uint32_t b1_big,
                                           uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32(c, a_small, b0_big, b1_big);
  mma_tf32(c, a_big, b0_small, b1_small);
  mma_tf32(c, a_big, b0_big, b1_big);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The n splits of one output row merged in split order by one warp: ml
// holds each split's (m, l) and po its unnormalised O (d floats a split);
// m is in log2 units when LOG2 (the bf16 kernels' exp2f softmax), else
// in natural units (the fp32 kernels' expf).  The lanes read the splits'
// (m, l) a split each and reduce them with shuffles in a fixed tree; then
// every lane accumulates its columns over the splits in split order, so
// every run gives the same bits.  A lane takes 4 columns in each
// 128-column half of 256 columns, and the split loop is unrolled by 8: up
// to 16 of its loads are in flight at once (the merge waits on L2
// latency, not bandwidth).  Writes the normalised row to out (d of T)
// and, when lse is not null, the row's natural log-sum-exp to *lse.
// The natural log-sum-exp of a row from its running max m and sum l (m in
// log2 units when LOG2): -inf for a row that saw no key (l = 0).
template <bool LOG2>
__device__ __forceinline__ float row_lse(float m, float l) {
  return LOG2 ? (m + log2f(l)) * 0.6931471805599453f : m + logf(l);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, float4 a,
                                       float inv) {
  uint2 pk;
  pk.x = pack_bf16(a.x * inv, a.y * inv);
  pk.y = pack_bf16(a.z * inv, a.w * inv);
  *reinterpret_cast<uint2*>(out) = pk;
}
__device__ __forceinline__ void store4(float* out, float4 a, float inv) {
  *reinterpret_cast<float4*>(out) =
      make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
}

template <bool LOG2 = true, typename T>
__device__ __forceinline__ void combine_splits(const float* ml,
                                               const float* po, T* out,
                                               int n, int d,
                                               float* lse = nullptr) {
  const int lane = threadIdx.x & 31;
  auto ex = [](float x) { return LOG2 ? exp2f(x) : expf(x); };
  float mx = kNegInf;
  for (int s = lane; s < n; s += 32) mx = fmaxf(mx, ml[2 * s]);
  mx = warp_max(mx);
  float lsum = 0.f;
  for (int s = lane; s < n; s += 32)
    lsum += ml[2 * s + 1] * ex(ml[2 * s] - mx);
  lsum = warp_sum(lsum);
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  if (lse != nullptr && lane == 0) *lse = row_lse<LOG2>(mx, lsum);
  for (int c0 = lane * 4; c0 < d; c0 += 256) {
    const int c1 = c0 + 128;
    const bool two = c1 < d;
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 a1 = a0;
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const float w = ex(ml[2 * s] - mx);
      const float* ps = po + s * d;
      const float4 x = *reinterpret_cast<const float4*>(ps + c0);
      const float4 y = two ? *reinterpret_cast<const float4*>(ps + c1)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      a0.x += x.x * w;
      a0.y += x.y * w;
      a0.z += x.z * w;
      a0.w += x.w * w;
      a1.x += y.x * w;
      a1.y += y.y * w;
      a1.z += y.z * w;
      a1.w += y.w * w;
    }
    store4(out + c0, a0, inv);
    if (two) store4(out + c1, a1, inv);
  }
}

}  // namespace repro_attn
