// Decode attention over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_decode_kernel` / `decode_attention_fwd` of
// repro/kernels/decode_attention.py and computes the same function: the G
// query heads of KV head h of row b, q (B, Hkv, G, D), attend cache
// positions k_pos < cache_len[b] (and k_pos >= cache_len[b] - window when a
// window is given) of k/v (B, Hkv, Smax, D).  Scores and the softmax are
// fp32 (masked scores -1e30, l clamped at 1e-30); the probabilities are
// rounded to v's type before the PV product, as the Pallas kernel does.
// Output (B, Hkv, G, D) in q's type.  A row with cache_len 0 gives zeros.
//
// Design (first, simple version):
//   * one block of 8 warps per (row, kv head, chunk of up to 8 query
//     heads); the block holds the chunk's query heads, so each key is read
//     once for all of them (gemma-2b is MQA with G = 8: one chunk);
//   * the block loops over the LIVE keys only, [max(0, len - window), len),
//     never over Smax.  The keys are cut into 32-key tiles dealt round-robin
//     to the warps; in a tile each lane scores one key against all heads of
//     the chunk (16-byte loads of its key row), the warp runs the online
//     softmax with shuffles, and each lane accumulates D/32 output columns
//     of every head in registers, reading V rows coalesced;
//   * the warps' partial (m, l, acc) are merged in shared memory at the end
//     (the split-K combine of flash-decoding, inside one block).
//
// What bounds it on the H100: bytes.  Each live key costs 2*D*itemsize
// bytes of K and V and 4*G*D flops: 16 flops per byte for gemma-2b in
// bf16, far below the ~295 flops/byte where the tensor cores would bind.
// With B = 8 and one KV head there are only 8 blocks for 132 SMs, so this
// version is bound by one SM's CUDA cores per sequence, not by the card's
// bandwidth; splitting a sequence's keys over several blocks with a second
// combine pass is the next step.
//
// TPU-isms of the Pallas kernel that do not carry over:
//   * lane padding of head_dim to 128 (`_pad_last`, repro/kernels/ops.py):
//     head_dim is a template parameter (16-256), nothing is padded;
//   * the (G, 128) VMEM scratch for m and l: registers of each warp;
//   * the sequential grid over Smax/block_k tiles that carries the softmax
//     state, with dead tiles masked: a loop over the live keys only;
//   * `cache_len` as a scalar-prefetch operand: the block reads its own.

#include "attention_common.cuh"

namespace {

using repro_attn::kNegInf;
using repro_attn::load8;
using repro_attn::round_to;
using repro_attn::store;
using repro_attn::to_f;
using repro_attn::warp_max;
using repro_attn::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGC = 8;       // query heads per block

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kGC) * D + kWarps * kGC * 32 +
         kWarps * kGC * D + 2 * kWarps * kGC;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q,        // (B, Hkv, G, D)
                        const T* __restrict__ k_cache,  // (B, Hkv, Smax, D)
                        const T* __restrict__ v_cache,
                        const int* __restrict__ cache_len,  // (B,)
                        T* __restrict__ out,            // (B, Hkv, G, D)
                        int hkv, int g, int smax, float scale, int window) {
  constexpr int DPL = D >= 32 ? D / 32 : 1;   // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                           // (kGC, D)
  float* pw = qs + kGC * D;                   // (kWarps, kGC, 32)
  float* wacc = pw + kWarps * kGC * 32;       // (kWarps, kGC, D)
  float* wm = wacc + kWarps * kGC * D;        // (kWarps, kGC)
  float* wl = wm + kWarps * kGC;              // (kWarps, kGC)

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g0 = blockIdx.z * kGC;
  const int gc = min(kGC, g - g0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row = static_cast<size_t>(b) * hkv + h;

  const T* qp = q + (row * g + g0) * D;
  for (int e = tid; e < kGC * D; e += kThreads)
    qs[e] = e / D < gc ? to_f(qp[e]) : 0.f;

  const int len = min(cache_len[b], smax);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const T* kp = k_cache + row * smax * D;
  const T* vp = v_cache + row * smax * D;
  float* my_p = pw + warp * kGC * 32;
  __syncthreads();

  float m[kGC], l[kGC], acc[kGC][DPL];
#pragma unroll
  for (int gi = 0; gi < kGC; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[gi][c] = 0.f;
  }

  for (int t0 = lo + warp * 32; t0 < len; t0 += kWarps * 32) {
    const int kj = t0 + lane;
    const bool valid = kj < len;
    float s[kGC];
#pragma unroll
    for (int gi = 0; gi < kGC; ++gi) s[gi] = 0.f;
    if (valid) {
      const T* krow = kp + static_cast<size_t>(kj) * D;
#pragma unroll 2
      for (int d = 0; d < D; d += 8) {
        float kv[8];
        load8(krow + d, kv);
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int gi = 0; gi < kGC; ++gi) s[gi] += qs[gi * D + d + u] * kv[u];
      }
    }
#pragma unroll
    for (int gi = 0; gi < kGC; ++gi) {
      const float sc = valid ? s[gi] * scale : kNegInf;
      const float m_new = fmaxf(m[gi], warp_max(sc));
      const float p = valid ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[gi] - m_new);
      l[gi] = alpha * l[gi] + warp_sum(p);
      m[gi] = m_new;
      my_p[gi * 32 + lane] = round_to(p, T());
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[gi][c] *= alpha;
    }
    __syncwarp();
    const int n = min(32, len - t0);
    for (int j = 0; j < n; ++j) {
      const T* vrow = vp + static_cast<size_t>(t0 + j) * D;
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? to_f(vrow[d]) : 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < kGC; ++gi) {
        const float p = my_p[gi * 32 + j];
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[gi][c] += p * vv[c];
      }
    }
    __syncwarp();
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int gi = 0; gi < kGC; ++gi) {
    if (lane == 0) {
      wm[warp * kGC + gi] = m[gi];
      wl[warp * kGC + gi] = l[gi];
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) wacc[(warp * kGC + gi) * D + d] = acc[gi][c];
    }
  }
  __syncthreads();

  T* op = out + (row * g + g0) * D;
  for (int e = tid; e < gc * D; e += kThreads) {
    const int gi = e / D;
    const int d = e - gi * D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kGC + gi]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * kGC + gi] - mx);
      num += f * wacc[(w * kGC + gi) * D + d];
      den += f * wl[w * kGC + gi];
    }
    store(op + e, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const int* cache_len, void* out, int b, int hkv, int g, int smax,
           float scale, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = decode_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(b, hkv, (g + kGC - 1) / kGC);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), cache_len, static_cast<T*>(out), hkv,
      g, smax, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k_cache,
               const void* v_cache, const int* cache_len, void* out, int b,
               int hkv, int g, int smax, float scale, int window,
               cudaStream_t stream) {
#define DA_CASE(DD)                                                          \
  case DD:                                                                   \
    return launch<T, DD>(q, k_cache, v_cache, cache_len, out, b, hkv, g,     \
                         smax, scale, window, stream);
  switch (d) {
    DA_CASE(16)
    DA_CASE(32)
    DA_CASE(64)
    DA_CASE(128)
    DA_CASE(256)
    default:
      return -1;
  }
#undef DA_CASE
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q, caches and out share it).
// cache_len is (B,) int32; window <= 0 means no window.  Returns the CUDA
// error of the launch (0 on success), -1 for an unsupported head_dim, -3
// for an unsupported dtype.
extern "C" int repro_decode_attention(int dtype, int d, const void* q,
                                      const void* k_cache,
                                      const void* v_cache,
                                      const void* cache_len, void* out,
                                      int b, int hkv, int g, int smax,
                                      float scale, int window,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(cache_len);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k_cache, v_cache, lens, out, b, hkv, g,
                             smax, scale, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k_cache, v_cache, lens, out, b,
                                     hkv, g, smax, scale, window, st);
  return -3;
}
