// Paged attention over the physical KV page pool, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_paged_kernel` / `paged_attention_fwd` of
// repro/kernels/decode_attention.py and computes the same function:
// token t attends slot clip(seg[t], 0, S-1)'s pages through
// tables[slot, page] at key positions <= pos[t] (and > pos[t] - window
// when a window is given), with an online softmax in fp32
// (NEG_INF = -1e30, l clamped at 1e-30).  Output (T, Hkv, G, D) in q's
// dtype.
//
// Design (first, simple version):
//   * one block per (token, kv-head); the block holds all G query heads
//     of the group, so a page is read once for the G heads;
//   * the block reads its own table row and loops over the LIVE pages
//     only: [first page of the window, page of pos[t]];
//   * each page is staged as a (ps, D) fp32 tile in shared memory for K
//     and for V; int8 / fp8_e4m3 codes are dequantized there from the
//     (N, ps, Hkv) fp32 scales, so the fp32 pool never exists in memory;
//   * scores: one warp per (head, key) pair, a shuffle reduction over D;
//     the PV update: each thread owns (head, d) accumulators in shared
//     memory.  Accumulation is fp32 throughout.
//
// What bounds it on the H100: bytes.  Each token reads its sequence's
// live pages (ps*D*2 elements per page) and does 4*G*D flops per key,
// about 2*G = 16 flops per byte for gemma-2b (G = 8) in bf16, far
// below the ~295 flops/byte where the tensor cores would bind.  Tokens
// of one prefill chunk read the same pages, which then come from L2.
// What this version does not do yet: split a long sequence's pages over
// several blocks (flash-decoding), use TMA/cp.async double buffering,
// or wgmma.  Those are later, measured work.
//
// TPU-isms of the Pallas kernel that do not carry over:
//   * lane padding (`_pad_last`, repro/kernels/ops.py:37-43): head_dim
//     is a template parameter here; no pool copy is ever padded;
//   * the `d % 128 == 0` auto rule and its try/except fallback
//     (repro/models/attention.py:243-256): the kernel takes every
//     instantiated head_dim, and the wrapper raises on any other;
//   * the (g, 128) VMEM scratch for m and l: the stats are G floats in
//     shared memory;
//   * `pages_per_tile`: it packed pages into one grid step to amortize
//     the TPU's per-grid-step overhead.  Here the block already loops
//     over pages in-kernel, so the parameter is gone;
//   * buffer donation: the page pool is a single-owner tensor updated in
//     place by the executor; this kernel only reads it.
//
// `window` is supported because the reference kernel supports it, though
// the serving executor passes none.

#include "attention_common.cuh"

namespace {

using repro_attn::kNegInf;
using repro_attn::store;
using repro_attn::to_f;

constexpr int kThreads = 256;

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q,          // (T, Hkv, G, D)
                       const KT* __restrict__ k_pages,    // (N, ps, Hkv, D)
                       const KT* __restrict__ v_pages,
                       const float* __restrict__ k_scale, // (N, ps, Hkv)|null
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,    // (S, P)
                       const int* __restrict__ seg,       // (T,)
                       const int* __restrict__ pos,       // (T,)
                       QT* __restrict__ out,              // (T, Hkv, G, D)
                       int hkv, int g, int ps, int s_slots, int p_pages,
                       float scale, int window) {
  extern __shared__ float smem[];
  float* ks = smem;               // (ps, D)
  float* vs = ks + ps * D;        // (ps, D)
  float* qs = vs + ps * D;        // (G, D)
  float* acc = qs + g * D;        // (G, D)
  float* sc = acc + g * D;        // (G, ps) scores, then probabilities
  float* m = sc + g * ps;         // (G,)
  float* l = m + g;               // (G,)
  float* alpha = l + g;           // (G,)

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  int slot = seg[t];
  slot = slot < 0 ? 0 : (slot > s_slots - 1 ? s_slots - 1 : slot);
  const int p_t = pos[t];
  const int* row = tables + static_cast<size_t>(slot) * p_pages;

  const QT* qp = q + (static_cast<size_t>(t) * hkv + h) * g * D;
  for (int e = tid; e < g * D; e += blockDim.x) {
    qs[e] = to_f(qp[e]);
    acc[e] = 0.f;
  }
  for (int e = tid; e < g; e += blockDim.x) {
    m[e] = kNegInf;
    l[e] = 0.f;
  }

  // live pages: from the first page that holds a key inside the window
  // to the page holding pos[t] (causal); never past the table width
  int last = p_t / ps;
  if (last > p_pages - 1) last = p_pages - 1;
  int first = 0;
  if (window > 0) {
    const int lo = p_t - window + 1;
    if (lo > 0) first = lo / ps;
  }
  __syncthreads();

  for (int pi = first; pi <= last; ++pi) {
    const size_t page = static_cast<size_t>(row[pi]);
    const int k_start = pi * ps;

    for (int e = tid; e < ps * D; e += blockDim.x) {
      const int j = e / D;
      const int d = e - j * D;
      const size_t tok = page * ps + j;
      const size_t off = (tok * hkv + h) * D + d;
      float kf = to_f(k_pages[off]);
      float vf = to_f(v_pages[off]);
      if (k_scale != nullptr) {
        kf *= k_scale[tok * hkv + h];
        vf *= v_scale[tok * hkv + h];
      }
      ks[e] = kf;
      vs[e] = vf;
    }
    __syncthreads();

    for (int pr = warp; pr < g * ps; pr += n_warps) {
      const int gi = pr / ps;
      const int j = pr - gi * ps;
      float sum = 0.f;
#pragma unroll
      for (int d = lane; d < D; d += 32) sum += qs[gi * D + d] * ks[j * D + d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const int kp = k_start + j;
        const bool ok = kp <= p_t && (window <= 0 || kp > p_t - window);
        sc[pr] = ok ? sum * scale : kNegInf;
      }
    }
    __syncthreads();

    for (int gi = tid; gi < g; gi += blockDim.x) {
      const float m_prev = m[gi];
      float m_new = m_prev;
      for (int j = 0; j < ps; ++j) m_new = fmaxf(m_new, sc[gi * ps + j]);
      float s = 0.f;
      for (int j = 0; j < ps; ++j) {
        const float p = expf(sc[gi * ps + j] - m_new);
        sc[gi * ps + j] = p;
        s += p;
      }
      const float a = expf(m_prev - m_new);
      l[gi] = a * l[gi] + s;
      m[gi] = m_new;
      alpha[gi] = a;
    }
    __syncthreads();

    for (int e = tid; e < g * D; e += blockDim.x) {
      const int gi = e / D;
      const int d = e - gi * D;
      float a = acc[e] * alpha[gi];
      const float* pg = sc + gi * ps;
      for (int j = 0; j < ps; ++j) a += pg[j] * vs[j * D + d];
      acc[e] = a;
    }
    __syncthreads();
  }

  QT* op = out + (static_cast<size_t>(t) * hkv + h) * g * D;
  for (int e = tid; e < g * D; e += blockDim.x)
    store(op + e, acc[e] / fmaxf(l[e / D], 1e-30f));
}

template <typename QT, typename KT, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* seg, const int* pos, void* out, int t, int hkv, int g,
           int ps, int s_slots, int p_pages, float scale, int window,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * ps * D + 2 * g * D + g * ps + 3 * g);
  auto kernel = paged_attention_kernel<QT, KT, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(t, hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), k_scale, v_scale, tables, seg, pos,
      static_cast<QT*>(out), hkv, g, ps, s_slots, p_pages, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int dispatch_d(int d, const void* q, const void* k_pages,
               const void* v_pages, const float* k_scale,
               const float* v_scale, const int* tables, const int* seg,
               const int* pos, void* out, int t, int hkv, int g, int ps,
               int s_slots, int p_pages, float scale, int window,
               cudaStream_t stream) {
#define PA_CASE(DD)                                                        \
  case DD:                                                                 \
    return launch<QT, KT, DD>(q, k_pages, v_pages, k_scale, v_scale,       \
                              tables, seg, pos, out, t, hkv, g, ps,        \
                              s_slots, p_pages, scale, window, stream);
  switch (d) {
    PA_CASE(16)
    PA_CASE(32)
    PA_CASE(64)
    PA_CASE(128)
    PA_CASE(256)
    default:
      return -1;
  }
#undef PA_CASE
}

template <typename QT>
int dispatch_kv(int kv_dtype, int d, const void* q, const void* k_pages,
                const void* v_pages, const float* k_scale,
                const float* v_scale, const int* tables, const int* seg,
                const int* pos, void* out, int t, int hkv, int g, int ps,
                int s_slots, int p_pages, float scale, int window,
                cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return dispatch_d<QT, float>(d, q, k_pages, v_pages, k_scale, v_scale,
                                   tables, seg, pos, out, t, hkv, g, ps,
                                   s_slots, p_pages, scale, window, stream);
    case 1:
      return dispatch_d<QT, __nv_bfloat16>(
          d, q, k_pages, v_pages, k_scale, v_scale, tables, seg, pos, out,
          t, hkv, g, ps, s_slots, p_pages, scale, window, stream);
    case 2:
      return dispatch_d<QT, int8_t>(d, q, k_pages, v_pages, k_scale,
                                    v_scale, tables, seg, pos, out, t, hkv,
                                    g, ps, s_slots, p_pages, scale, window,
                                    stream);
    case 3:
      return dispatch_d<QT, __nv_fp8_e4m3>(
          d, q, k_pages, v_pages, k_scale, v_scale, tables, seg, pos, out,
          t, hkv, g, ps, s_slots, p_pages, scale, window, stream);
    default:
      return -2;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 float8_e4m3fn.
// q/out take 0 or 1; the pool takes any.  k_scale/v_scale are null for
// an unquantized pool.  window <= 0 means no window.  Returns the CUDA
// error of the launch (0 on success), -1 for an unsupported head_dim,
// -2 for an unsupported pool dtype, -3 for an unsupported q dtype.
extern "C" int repro_paged_attention(
    int q_dtype, int kv_dtype, int d, const void* q, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* tables, const void* seg, const void* pos, void* out, int t,
    int hkv, int g, int ps, int s_slots, int p_pages, float scale,
    int window, void* stream) {
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* sg = static_cast<const int*>(seg);
  const int* ps_ = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_kv<float>(kv_dtype, d, q, k_pages, v_pages, ksc, vsc,
                              tb, sg, ps_, out, t, hkv, g, ps, s_slots,
                              p_pages, scale, window, st);
  if (q_dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, d, q, k_pages, v_pages, ksc,
                                      vsc, tb, sg, ps_, out, t, hkv, g, ps,
                                      s_slots, p_pages, scale, window, st);
  return -3;
}
