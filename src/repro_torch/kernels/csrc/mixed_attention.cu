// Mixed prefill/decode attention over per-slot contiguous caches, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `_mixed_kernel` / `mixed_attention_fwd` of
// src/repro/kernels/decode_attention.py:186 and computes the same function:
// token t of a flat batch, with its G query heads of KV head h in q
// (T, Hkv, G, D), reads the cache row of slot clip(seg_ids[t], 0, S-1) of
// k/v (S, Hkv, L, D) (a padding token, seg < 0, reads slot 0 and the caller
// discards its output) and attends key positions k_pos <= positions[t], and
// k_pos > positions[t] - window when a window is given.  Scores and the
// softmax are fp32 (masked scores -1e30, l clamped at 1e-30); the
// probabilities are rounded to v's type before the PV product, as the
// Pallas kernel does (`p.astype(v.dtype)`).  Output (T, Hkv, G, D) in q's
// type.  A token with no visible key (only when positions[t] >= L under a
// window) gives zeros, as the Pallas kernel does.
//
// Design (first, simple version), the layout of decode_attention.cu:
//   * one block of 8 warps per (token, kv head, chunk of up to 8 query
//     heads); the block holds the chunk's query heads, so each key is read
//     once for all of them (gemma-2b is MQA with G = 8: one chunk);
//   * the block loops over the token's LIVE keys only,
//     [max(0, pos - window + 1), min(pos, L - 1)], never over L.  Both
//     bounds are one past the decode kernel's ([len - window, len)): the
//     query's own position is visible.  The keys are cut into 32-key tiles
//     dealt round-robin to the warps; in a tile each lane scores one key
//     against all heads of the chunk (16-byte loads of its key row), the
//     warp runs the online softmax with shuffles, and each lane accumulates
//     D/32 output columns of every head in registers, reading V rows
//     coalesced;
//   * the warps' partial (m, l, acc) are merged in shared memory at the end.
//
// What bounds it on the H100: bytes.  Each live (token, key) pair costs
// 2*D*itemsize bytes of K and V and 4*G*D flops: 16 flops per byte for
// gemma-2b in bf16, far below the ~295 flops/byte where the tensor cores
// would bind.  The tokens of one slot (a prefill chunk) re-read the same
// keys, each from its own block, so this version moves about T/S times the
// bytes that the bound counts (every cache row read once); a later version
// should share a slot's keys across its tokens (one block per slot and
// query tile, as the flash kernel does).
//
// TPU-isms of the Pallas kernel that do not carry over:
//   * lane padding of head_dim to 128 (`_pad_last`, repro/kernels/ops.py:37):
//     head_dim is a template parameter (16-256), nothing is padded or copied;
//   * the (G, 128) VMEM scratch for m and l: registers of each warp;
//   * the sequential grid over L / block_k tiles that carries the softmax
//     state, with dead tiles masked: a loop over the live keys only;
//   * `seg_ids` and `positions` as scalar-prefetch operands routing the
//     BlockSpec index map: the block reads its own slot and position.

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

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
mixed_attention_kernel(const TQ* __restrict__ q,        // (T, Hkv, G, D)
                       const TKV* __restrict__ k_cache,  // (S, Hkv, L, D)
                       const TKV* __restrict__ v_cache,
                       const int* __restrict__ seg_ids,    // (T,)
                       const int* __restrict__ positions,  // (T,)
                       TQ* __restrict__ out,            // (T, Hkv, G, D)
                       int hkv, int g, int n_slots, int seq_len, float scale,
                       int window) {
  constexpr int DPL = D >= 32 ? D / 32 : 1;   // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                           // (kGC, D)
  float* pw = qs + kGC * D;                   // (kWarps, kGC, 32)
  float* wacc = pw + kWarps * kGC * 32;       // (kWarps, kGC, D)
  float* wm = wacc + kWarps * kGC * D;        // (kWarps, kGC)
  float* wl = wm + kWarps * kGC;              // (kWarps, kGC)

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int g0 = blockIdx.z * kGC;
  const int gc = min(kGC, g - g0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t qrow = static_cast<size_t>(t) * hkv + h;

  const TQ* qp = q + (qrow * g + g0) * D;
  for (int e = tid; e < kGC * D; e += kThreads)
    qs[e] = e / D < gc ? to_f(qp[e]) : 0.f;

  const int slot = min(max(seg_ids[t], 0), n_slots - 1);
  const int pos = positions[t];
  const int hi = min(pos, seq_len - 1) + 1;            // exclusive
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const size_t crow = static_cast<size_t>(slot) * hkv + h;
  const TKV* kp = k_cache + crow * seq_len * D;
  const TKV* vp = v_cache + crow * seq_len * D;
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

  for (int t0 = lo + warp * 32; t0 < hi; t0 += kWarps * 32) {
    const int kj = t0 + lane;
    const bool valid = kj < hi;
    float s[kGC];
#pragma unroll
    for (int gi = 0; gi < kGC; ++gi) s[gi] = 0.f;
    if (valid) {
      const TKV* krow = kp + static_cast<size_t>(kj) * D;
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
      my_p[gi * 32 + lane] = round_to(p, TKV());
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[gi][c] *= alpha;
    }
    __syncwarp();
    const int n = min(32, hi - t0);
    for (int j = 0; j < n; ++j) {
      const TKV* vrow = vp + static_cast<size_t>(t0 + j) * D;
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

  TQ* op = out + (qrow * g + g0) * D;
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

struct Args {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const int* seg_ids;
  const int* positions;
  void* out;
  int t, hkv, g, n_slots, seq_len;
  float scale;
  int window;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D>
int launch(const Args& a) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = mixed_attention_kernel<TQ, TKV, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.t, a.hkv, (a.g + kGC - 1) / kGC);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_cache),
      static_cast<const TKV*>(a.v_cache), a.seg_ids, a.positions,
      static_cast<TQ*>(a.out), a.hkv, a.g, a.n_slots, a.seq_len, a.scale,
      a.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch<TQ, TKV, 16>(a);
    case 32: return launch<TQ, TKV, 32>(a);
    case 64: return launch<TQ, TKV, 64>(a);
    case 128: return launch<TQ, TKV, 128>(a);
    case 256: return launch<TQ, TKV, 256>(a);
    default: return -1;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  Pairs (q, k/v): (0, 0), (1, 1) and
// (1, 0) (bf16 queries over the fp32 caches that a gather from an int8/fp8
// pool gives); out has q's type.  seg_ids and positions are (T,) int32;
// window <= 0 means no window.  Returns the CUDA error of the launch (0 on
// success), -1 for an unsupported head_dim, -3 for an unsupported pair.
extern "C" int repro_mixed_attention(int q_dtype, int kv_dtype, int d,
                                     const void* q, const void* k_cache,
                                     const void* v_cache,
                                     const void* seg_ids,
                                     const void* positions, void* out, int t,
                                     int hkv, int g, int n_slots,
                                     int seq_len, float scale, int window,
                                     void* stream) {
  const Args a{q, k_cache, v_cache, static_cast<const int*>(seg_ids),
               static_cast<const int*>(positions), out, t, hkv, g, n_slots,
               seq_len, scale, window, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return dispatch_d<float, float>(d, a);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, a);
  if (q_dtype == 1 && kv_dtype == 0)
    return dispatch_d<__nv_bfloat16, float>(d, a);
  return -3;
}
