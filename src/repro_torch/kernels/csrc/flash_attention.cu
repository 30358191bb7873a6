// Flash attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_kernel` / `flash_attention_fwd` of
// repro/kernels/flash_attention.py and computes the same function: q
// (B*Hq, Sq, D) against k/v (B*Hkv, Skv, D), query head bh reading kv head
// bh / (Hq/Hkv); the queries are the LAST Sq positions (q_offset =
// Skv - Sq); key j is visible to query i when j < Skv, j <= i + q_offset
// (causal) and j > i + q_offset - window (window).  Scores and the online
// softmax are fp32 (masked scores -1e30, l clamped at 1e-30); the
// probabilities are rounded to v's type before the PV product, as the
// Pallas kernel does.  Output in q's type.
//
// Design (first, simple version):
//   * one block of 256 threads per (64-query tile, query head); the block
//     walks the 64-key tiles of its live key range in a loop, which takes
//     the place of the TPU's sequential KV grid dimension.  Tiles above the
//     causal diagonal and below the window are never visited (the Pallas
//     kernel skips them with `pl.when`);
//   * Q, K and V tiles are staged in shared memory as fp32 (K rows padded
//     by one word against bank conflicts): about 210 KB at head_dim 256,
//     dynamic shared memory set with cudaFuncSetAttribute;
//   * each thread owns a 4x4 block of the 64x64 score tile and a 4 x D/16
//     block of the output accumulator, both in registers; the softmax
//     statistics of a row are one warp's work.  CUDA-core FMAs, no tensor
//     cores yet.
//
// What bounds it on the H100: operations.  For gemma-2b prefill (D = 256,
// G = 8 query heads per KV head, causal) it does 4*D flops per live
// (query, key) pair against 2*D*2 bytes per key read once: far above the
// ~295 flops/byte where the bf16 tensor cores become the limit.  This
// version runs on the CUDA cores (67 TFLOP/s fp32 peak), so it cannot
// reach the 989 TFLOP/s bound; wgmma tiles fed by TMA are the next step.
//
// TPU-isms of the Pallas kernel that do not carry over:
//   * lane padding of head_dim to 128 (`_pad_last`, repro/kernels/ops.py):
//     head_dim is a template parameter (16-256), nothing is padded;
//   * the (block_q, 128) VMEM scratch for m and l: the stats are 64 floats
//     each in shared memory;
//   * the sequential grid that carries the softmax state across KV tiles:
//     a loop inside the block;
//   * block_q = block_k = 128, sized for the MXU and VMEM: 64 x 64 here,
//     sized for shared memory and registers.

#include "attention_common.cuh"

namespace {

using repro_attn::kNegInf;
using repro_attn::round_to;
using repro_attn::store;
using repro_attn::to_f;
using repro_attn::warp_max;
using repro_attn::warp_sum;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBQ) * (D + 4) + kBK * (D + 1) + kBK * D +
         kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q,   // (BHq, Sq, D)
                       const T* __restrict__ k,   // (BHkv, Skv, D)
                       const T* __restrict__ v,
                       T* __restrict__ out,       // (BHq, Sq, D)
                       int sq, int skv, int group, float scale, int causal,
                       int window) {
  constexpr int QS = D + 4;   // q row stride: two row groups per warp
  constexpr int KS = D + 1;   // k row stride: 16 rows per warp
  constexpr int PS = kBK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                // (kBQ, QS)
  float* ks = qs + kBQ * QS;       // (kBK, KS)
  float* vs = ks + kBK * KS;       // (kBK, D)
  float* ps = vs + kBK * D;        // (kBQ, PS) scores, then probabilities
  float* m_s = ps + kBQ * PS;      // (kBQ,)
  float* l_s = m_s + kBQ;          // (kBQ,)
  float* a_s = l_s + kBQ;          // (kBQ,) rescale factor of this tile

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int kvh = bh / group;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;         // rows ty*4 .. ty*4+3
  const int tx = tid & 15;         // columns tx + 16*c
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q_offset = skv - sq;

  const T* qp = q + static_cast<size_t>(bh) * sq * D;
  const T* kp = k + static_cast<size_t>(kvh) * skv * D;
  const T* vp = v + static_cast<size_t>(kvh) * skv * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int qi = q0 + r;
    qs[r * QS + d] = qi < sq ? to_f(qp[static_cast<size_t>(qi) * D + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  // live keys of this query tile: [k_begin, k_end)
  const int last_q = min(q0 + kBQ, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, last_q + q_offset + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1);
  k_begin = (k_begin / kBK) * kBK;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      const int kj = k0 + j;
      float kf = 0.f, vf = 0.f;
      if (kj < skv) {
        kf = to_f(kp[static_cast<size_t>(kj) * D + d]);
        vf = to_f(vp[static_cast<size_t>(kj) * D + d]);
      }
      ks[j * KS + d] = kf;
      vs[j * D + d] = vf;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = ks[(tx + 16 * c) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] += a[i] * b[c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int q_pos = q0 + r + q_offset;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const int k_pos = k0 + j;
        bool ok = k_pos < skv && q0 + r < sq;
        if (causal) ok = ok && k_pos <= q_pos;
        if (window > 0) ok = ok && k_pos > q_pos - window;
        ps[r * PS + j] = ok ? s[i][c] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows w*8 .. w*8+7
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* row = ps + r * PS;
      const float s0 = row[lane];
      const float s1 = row[lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = s0 == kNegInf ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == kNegInf ? 0.f : expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      row[lane] = round_to(p0, T());
      row[lane + 32] = round_to(p1, T());
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = vs[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
      }
    }
    __syncthreads();
  }

  T* op = out + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qi = q0 + r;
    if (qi >= sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(op + static_cast<size_t>(qi) * D + tx + 16 * c, acc[i][c] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bhq,
           int bhkv, int sq, int skv, float scale, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, bhq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, bhq / bhkv,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* out,
               int bhq, int bhkv, int sq, int skv, float scale, int causal,
               int window, cudaStream_t stream) {
#define FA_CASE(DD)                                                       \
  case DD:                                                                \
    return launch<T, DD>(q, k, v, out, bhq, bhkv, sq, skv, scale, causal, \
                         window, stream);
  switch (d) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return -1;
  }
#undef FA_CASE
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q, k, v and out share it).  causal
// is 0 or 1; window <= 0 means no window.  Returns the CUDA error of the
// launch (0 on success), -1 for an unsupported head_dim, -3 for an
// unsupported dtype.
extern "C" int repro_flash_attention(int dtype, int d, const void* q,
                                     const void* k, const void* v, void* out,
                                     int bhq, int bhkv, int sq, int skv,
                                     float scale, int causal, int window,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, out, bhq, bhkv, sq, skv, scale,
                             causal, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, out, bhq, bhkv, sq, skv,
                                     scale, causal, window, st);
  return -3;
}
