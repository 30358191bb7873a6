// Decode attention over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_decode_kernel` / `decode_attention_fwd` of
// repro/kernels/decode_attention.py and computes the same function: the G
// query heads of KV head h of row b, q (B, Hkv, G, D), attend cache
// positions k_pos < cache_len[b] (and k_pos >= cache_len[b] - window when a
// window is given) of k/v (B, Hkv, Smax, D); cache_len is clipped to Smax.
// Scores and the softmax are fp32 (masked scores -1e30, l clamped at
// 1e-30); the unnormalised probabilities are rounded to v's type before
// the PV product, as the Pallas kernel does.  Output (B, Hkv, G, D) in q's
// type.  A row with cache_len 0 gives zeros.
//
// What bounds it on the H100: bytes.  Each live key costs 2*D*itemsize
// bytes of K and V and 4*G*D flops: G = 8 flops a byte for gemma-2b in
// bf16 (4 in fp32), far below the ~295 flops a byte where the tensor cores
// would bind.  What the kernel must do is keep enough blocks reading: at
// gemma-2b (MQA, one KV head, B = 8) a block per (row, KV head) is 8 blocks
// for 132 SMs.
//
// bf16 ("mma", tensor cores; one launch a call, two with the combine):
//   * the rows of a block are the query heads of one KV head, an m16 tile
//     of up to 16 heads (G = 8 fills half of it, which costs nothing at 8
//     flops a byte); G > 16 takes one more grid slice (z) per 16 heads.
//     The Q fragments are loaded once into registers;
//   * split-KV over the live keys [lo, len), lo = max(0, len - window) (0
//     without a window): split s covers [lo + s*KS, min(len, lo +
//     (s+1)*KS)), KS = kSplitKeys = 128 (chosen by measurement: 64 and 256
//     were slower, PERF.md §6).  The grid, (B*Hkv, ceil(span / KS),
//     ceil(G/16)) with span = min(Smax, window), is sized on the host with
//     no sync (B*Hkv in x, which holds 2^31 - 1 blocks; y and z hold
//     65535); a block past its row's live splits exits before it touches
//     shared memory.  The window edge is a split's start, so only the
//     ragged end of a split is masked, on the warp tiles that cross it;
//   * K/V come by cp.async (16-byte chunks, rows past the split
//     zero-filled) into a 2-stage ring of 64-key stages, rows padded by 16
//     bytes for ldmatrix; stage j+1's copy is issued before stage j's
//     products.  The 4 warps hold the same head rows and split each stage's
//     keys, 16 a warp: S = Q K^T on mma.sync m16n8k16 with K by ldmatrix,
//     the online softmax in registers (log2 units, exp2f), P from the S
//     accumulators into the A fragment, O += P V with V by ldmatrix.trans.
//     The warps' (m, l, O) are merged in shared memory, in warp order;
//   * a row of one split normalises and writes its output.  Otherwise each
//     split writes fp32 (m, l) and unnormalised O to a workspace, and
//     `decode_attention_combine` (a block of one warp a row, each row's
//     split count from cache_len on the card; blocks of 2 and 8 rows were
//     slower, PERF.md §6) merges them in split order
//     (repro_attn::combine_splits, shared with the paged kernel), so every
//     run gives the same bits.  A grid of one split launches no combine;
//   * registers at D = 256: O is 128 fp32 a thread and the Q fragments 64;
//     shared memory is the Q tile and the ring (~144 KB at D = 256: one
//     block an SM).  `repro_decode_attention_attrs` reports registers,
//     spill bytes, shared memory and blocks per SM of each instantiation.
//
// fp32 ("simt", CUDA cores; one launch a call, two with the combine).
// fp32 is the parity path, held to 1e-5.  It is bound by bytes as bf16
// is (4 flops a byte, against the ~20 at which the fp32 CUDA cores would
// bind), so the tensor cores would not help it; what the first design
// lacked was parallelism: one block per (row, KV head) is 8 blocks for
// 132 SMs at gemma-2b.  It runs the bf16 path's split plan:
//   * the grid (B*Hkv, ceil(span / KS), ceil(G/8)), span = min(Smax,
//     window), KS = kSimtSplitKeys = 64, sized on the host with no sync;
//     split s covers [lo + s*KS, min(len, lo + (s+1)*KS)), so the
//     window's edge is a split's start; a block past its row's live
//     splits exits;
//   * one block of 4 warps per (row and KV head, split, chunk of up to 8
//     query heads); the block holds the chunk's query heads, so each key
//     is read once for all of them.  The split's keys are cut into
//     16-key tiles dealt round-robin to the warps; in a tile two lanes
//     score a key, each over half of D (16-byte loads of its key row,
//     unrolled 8 deep), a shuffle adds the halves, the warp runs the
//     online softmax with shuffles (natural units, expf), and each lane
//     accumulates D/32 output columns of every head in registers,
//     reading V rows in 16-byte loads.  A tile's time is the latency of
//     its loads, so short tiles on many blocks beat long ones: 64 keys a
//     split on 4 warps was the fastest of 8 tilings at dense_parity's
//     decode shape, where the main path's fp32 calls are (PERF.md §6);
//   * the warps' partial (m, l, acc) are merged in shared memory in warp
//     order.  A row of one split normalises and writes; otherwise each
//     split writes (m, l) and unnormalised O to the workspace and the
//     combine (`decode_attention_combine`, natural units, fp32 out)
//     merges them in split order, so every run gives the same bits.
//
// Both variants can also write each row's natural log-sum-exp (`lse`, for
// merging partials over disjoint key sets: the meshed decode step's cache
// slots split over ranks), where the row's max and sum are held: the main
// kernel for a row of one split, else the combine.  The output's
// arithmetic does not change.
//
// TPU-isms of the Pallas kernel that do not carry over:
//   * lane padding of head_dim to 128 (`_pad_last`, repro/kernels/ops.py):
//     head_dim is a template parameter (16-256), nothing is padded;
//   * the (G, 128) VMEM scratch for m and l: registers of each warp;
//   * the sequential grid over Smax/block_k tiles that carries the softmax
//     state, with dead tiles masked: a loop over the live keys only, cut
//     into splits that run in parallel and a combine that merges them;
//   * `cache_len` as a scalar-prefetch operand: the block reads its own.

#include "attention_common.cuh"

namespace {

using repro_attn::cp_async16;
using repro_attn::cp_async_commit;
using repro_attn::cp_async_wait;
using repro_attn::kLog2e;
using repro_attn::kNegInf;
using repro_attn::ldsm_x4;
using repro_attn::ldsm_x4_trans;
using repro_attn::load8;
using repro_attn::mma_bf16;
using repro_attn::pack_bf16;
using repro_attn::quad_max;
using repro_attn::quad_sum;
using repro_attn::smem_u32;
using repro_attn::warp_max;
using repro_attn::warp_sum;

// ---------------------------------------------------------------------
// the split plan both variants share

constexpr int kMaxGridYZ = 65535;  // gridDim.y and .z; x takes 2^31 - 1

// live keys [lo, len) of row b (cache_len clipped to [0, Smax])
__device__ __forceinline__ void live_keys(const int* cache_len, int b,
                                          int smax, int window, int* lo,
                                          int* len) {
  *len = max(0, min(cache_len[b], smax));
  *lo = window > 0 ? max(0, *len - window) : 0;
}

// splits of KS keys of a row with n live keys; a row with none has one,
// which writes zeros
template <int KS>
__device__ __forceinline__ int row_splits(int n) {
  return max(1, (n + KS - 1) / KS);
}

// splits of the grid: ceil(span / ks), span = min(Smax, window)
int grid_splits(int smax, int window, int ks) {
  const int span = window > 0 ? min(smax, window) : smax;
  return max(1, (span + ks - 1) / ks);
}

// Dynamic shared memory above 48 KB is allowed per kernel (and device).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// ---------------------------------------------------------------------
// fp32 on the CUDA cores ("simt")

// warps a block, keys a split and keys a warp's tile: chosen by
// tools/kernel_variants.py (PERF.md §6)
constexpr int kSimtWarps = 4;
constexpr int kThreads = 32 * kSimtWarps;
constexpr int kGC = 8;                // query heads per block
constexpr int kSimtSplitKeys = 64;
constexpr int kSimtWarpKeys = 16;
constexpr int kLanesPerKey = 32 / kSimtWarpKeys;

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kGC) * D + kSimtWarps * kGC * kSimtWarpKeys +
         kSimtWarps * kGC * D + 2 * kSimtWarps * kGC;
}

// N consecutive floats from p (16-byte aligned for N = 4) into o, or
// zeros when p is null
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* o) {
  if (p == nullptr) {
#pragma unroll
    for (int u = 0; u < N; ++u) o[u] = 0.f;
  } else if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x; o[1] = a.y;
  } else {
    o[0] = *p;
  }
}

// Block (b * Hkv + h, split, head chunk): split `split` of row b's live
// keys for query heads [8 z, 8 z + 8) of KV head h.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_simt(const float* __restrict__ q,        // (B, Hkv, G, D)
                      const float* __restrict__ k_cache,  // (B, Hkv, Smax, D)
                      const float* __restrict__ v_cache,
                      const int* __restrict__ cache_len,  // (B,)
                      float* __restrict__ out,            // (B, Hkv, G, D)
                      float* __restrict__ lse,  // (B, Hkv, G) or null
                      float* __restrict__ part_o,  // (B*Hkv*G, splits, D)
                      float* __restrict__ part_ml,  // (B*Hkv*G, splits, 2)
                      int hkv, int g, int smax, int max_splits, float scale,
                      int window) {
  // output columns of a lane: NV runs of V4 consecutive columns, run c
  // at column (32 c + lane) V4, so that a lane reads a V row in vector
  // loads (lanes past D at D = 16 hold nothing)
  constexpr int DPL = D >= 32 ? D / 32 : 1;
  constexpr int V4 = DPL < 4 ? DPL : 4;
  constexpr int NV = DPL / V4;
  constexpr int KW = kSimtWarpKeys;
  constexpr int DP = D / kLanesPerKey;  // columns of a key a lane scores
  extern __shared__ float smem[];
  float* qs = smem;                           // (kGC, D)
  float* pw = qs + kGC * D;                   // (kSimtWarps, kGC, KW)
  float* wacc = pw + kSimtWarps * kGC * KW;   // (kSimtWarps, kGC, D)
  float* wm = wacc + kSimtWarps * kGC * D;    // (kSimtWarps, kGC)
  float* wl = wm + kSimtWarps * kGC;          // (kSimtWarps, kGC)

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  int lo, len;
  live_keys(cache_len, bh / hkv, smax, window, &lo, &len);
  const int n_splits = row_splits<kSimtSplitKeys>(len - lo);
  if (split >= n_splits) return;
  const int k_begin = lo + split * kSimtSplitKeys;
  const int k_end = min(len, k_begin + kSimtSplitKeys);
  const int g0 = blockIdx.z * kGC;
  const int gc = min(kGC, g - g0);
  const size_t row0 = static_cast<size_t>(bh) * g + g0;  // first out row
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const float* qp = q + row0 * D;
  for (int e = tid; e < kGC * D; e += kThreads)
    qs[e] = e / D < gc ? qp[e] : 0.f;

  const float* kp = k_cache + static_cast<size_t>(bh) * smax * D;
  const float* vp = v_cache + static_cast<size_t>(bh) * smax * D;
  float* my_p = pw + warp * kGC * KW;
  __syncthreads();

  float m[kGC], l[kGC], acc[kGC][DPL];
#pragma unroll
  for (int gi = 0; gi < kGC; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[gi][c] = 0.f;
  }

  // a warp's tile of KW keys: lane (part, key) scores key t0 + lane % KW
  // over columns [part * DP, part * DP + DP)
  const int part = lane / KW;
  for (int t0 = k_begin + warp * KW; t0 < k_end; t0 += kSimtWarps * KW) {
    const int kj = t0 + lane % KW;
    const bool valid = kj < k_end;
    float s[kGC];
#pragma unroll
    for (int gi = 0; gi < kGC; ++gi) s[gi] = 0.f;
    if (valid) {
      // unrolled by 8 (up to 16 loads of 16 bytes in flight a lane): the
      // warp's time on a tile is load latency
      const float* krow = kp + static_cast<size_t>(kj) * D + part * DP;
      const float* qrow = qs + part * DP;
#pragma unroll 8
      for (int d = 0; d < DP; d += 8) {
        float kv[8];
        load8(krow + d, kv);
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int gi = 0; gi < kGC; ++gi)
            s[gi] += qrow[gi * D + d + u] * kv[u];
      }
    }
    // whole scores: the parts summed over the lanes of a key
#pragma unroll
    for (int o = KW; o < 32; o <<= 1)
#pragma unroll
      for (int gi = 0; gi < kGC; ++gi)
        s[gi] += __shfl_xor_sync(0xffffffffu, s[gi], o);
#pragma unroll
    for (int gi = 0; gi < kGC; ++gi) {
      const float sc = valid ? s[gi] * scale : kNegInf;
      const float m_new = fmaxf(m[gi], warp_max(sc));
      const float p = valid ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[gi] - m_new);
      l[gi] = alpha * l[gi] + warp_sum(part == 0 ? p : 0.f);
      m[gi] = m_new;
      if (part == 0) my_p[gi * KW + lane] = p;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[gi][c] *= alpha;
    }
    __syncwarp();
    const int n = min(KW, k_end - t0);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float* vrow = vp + static_cast<size_t>(t0 + j) * D;
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int d = (32 * c + lane) * V4;
        if (d < D)
          load_n<V4>(vrow + d, vv + c * V4);
        else
          load_n<V4>(nullptr, vv + c * V4);
      }
#pragma unroll
      for (int gi = 0; gi < kGC; ++gi) {
        const float p = my_p[gi * KW + j];
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[gi][c] += p * vv[c];
      }
    }
    __syncwarp();
  }

  // merge the warps' partial softmax states, in warp order
#pragma unroll
  for (int gi = 0; gi < kGC; ++gi) {
    if (lane == 0) {
      wm[warp * kGC + gi] = m[gi];
      wl[warp * kGC + gi] = l[gi];
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int d = (32 * c + lane) * V4;
#pragma unroll
      for (int u = 0; u < V4; ++u)
        if (d < D) wacc[(warp * kGC + gi) * D + d + u] = acc[gi][c * V4 + u];
    }
  }
  __syncthreads();

  for (int e = tid; e < gc * D; e += kThreads) {
    const int gi = e / D;
    const int d = e - gi * D;
    float mx = kNegInf;
    for (int w = 0; w < kSimtWarps; ++w) mx = fmaxf(mx, wm[w * kGC + gi]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kSimtWarps; ++w) {
      const float f = expf(wm[w * kGC + gi] - mx);
      num += f * wacc[(w * kGC + gi) * D + d];
      den += f * wl[w * kGC + gi];
    }
    const size_t r = row0 + gi;
    if (n_splits == 1) {
      out[r * D + d] = num / fmaxf(den, 1e-30f);
      if (lse != nullptr && d == 0)
        lse[r] = repro_attn::row_lse<false>(mx, den);
    } else {
      part_o[(r * max_splits + split) * D + d] = num;
      if (d == 0)
        *reinterpret_cast<float2*>(part_ml + (r * max_splits + split) * 2) =
            make_float2(mx, den);
    }
  }
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores ("mma")

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kRows = 16;                   // query heads of a block
constexpr int kWarpKeys = 16;               // keys of a warp in a stage
constexpr int kBK = kMmaWarps * kWarpKeys;  // keys of a ring stage
constexpr int kSplitKeys = 128;             // keys of a split
static_assert(kSplitKeys % kBK == 0, "a split is whole ring stages");

// the Q tile and a 2-stage ring of (K, V) tiles, rows padded by 8 bf16;
// the warps' merge reuses the ring
template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (kRows + 4 * kBK) * (D + 8);
}

// kBK rows of D from src (row stride D) into a shared tile of row stride
// D + 8 by cp.async; rows >= n become zeros
template <int D>
__device__ __forceinline__ void copy_keys(bf16* dst, const bf16* src, int n,
                                          int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  for (int c = tid; c < kBK * kChunks; c += kMmaThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const bool ok = r < n;
    cp_async16(smem_u32(dst + r * (D + 8) + col),
               src + static_cast<size_t>(ok ? r : 0) * D + col, ok);
  }
}

// One warp's 16 keys of a stage against the block's 16 head rows: S =
// Q K^T, the online softmax, O += P V.  n_valid: the keys of the 16 that
// are live (MASK: fewer than 16).
template <int D, bool MASK>
__device__ __forceinline__ void mma_keys(float (&o)[D / 8][4], float (&m)[2],
                                         float (&l)[2],
                                         const uint32_t (&qa)[D / 16][4],
                                         uint32_t k_addr, uint32_t v_addr,
                                         float scale_log2, int n_valid,
                                         int t) {
  float s[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(k_addr + kk * 16 * 2, b);
    mma_bf16(s[0], qa[kk], b[0], b[1]);
    mma_bf16(s[1], qa[kk], b[2], b[3]);
  }

  // scores in log2 units; keys past the split -1e30
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale_log2;
      if constexpr (MASK) x = 8 * j + 2 * t + (e & 1) < n_valid ? x : kNegInf;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(s[j][e] - m[e >> 1]);
      if constexpr (MASK) p = s[j][e] == kNegInf ? 0.f : p;
      s[j][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }

  // O += P V; P rounded to bf16 as the A fragment
  uint32_t a[4];
  a[0] = pack_bf16(s[0][0], s[0][1]);
  a[1] = pack_bf16(s[0][2], s[0][3]);
  a[2] = pack_bf16(s[1][0], s[1][1]);
  a[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_trans(v_addr + dp * 16 * 2, b);
    mma_bf16(o[2 * dp], a, b[0], b[1]);
    mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
  }
}

// Block (b * Hkv + h, split, head block): split `split` of row b's live
// keys for query heads [16 z, 16 z + 16) of KV head h.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
decode_attention_mma(const bf16* __restrict__ q,        // (B, Hkv, G, D)
                     const bf16* __restrict__ k_cache,  // (B, Hkv, Smax, D)
                     const bf16* __restrict__ v_cache,
                     const int* __restrict__ cache_len,  // (B,)
                     bf16* __restrict__ out,            // (B, Hkv, G, D)
                     float* __restrict__ lse,  // (B, Hkv, G) or null
                     float* __restrict__ part_o,  // (B*Hkv*G, splits, D)
                     float* __restrict__ part_ml,  // (B*Hkv*G, splits, 2)
                     int hkv, int g, int smax, int max_splits,
                     float scale_log2, int window) {
  constexpr int RS = D + 8;
  constexpr int WS = D + 8;        // fp32 row stride of the warps' merge
  constexpr int kTile = kBK * RS;  // bf16 elements of a K or V stage
  constexpr int kChunks = D / 8;   // 16-byte chunks of a bf16 row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  int lo, len;
  live_keys(cache_len, bh / hkv, smax, window, &lo, &len);
  const int n_splits = row_splits<kSplitKeys>(len - lo);
  if (split >= n_splits) return;
  const int k_begin = lo + split * kSplitKeys;
  const int n_keys = max(0, min(len, k_begin + kSplitKeys) - k_begin);
  const int g0 = blockIdx.z * kRows;
  const int rows = min(kRows, g - g0);
  const size_t row0 = static_cast<size_t>(bh) * g + g0;  // first out row

  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (kRows, RS)
  bf16* ring = qs + kRows * RS;  // stage s: K at tile 2s, V at 2s + 1
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment row (and row + 8)
  const int t4 = lane & 3;   // fragment column pair

  // the Q rows (zeros past the group), then stage 0
  for (int c = tid; c < kRows * kChunks; c += kMmaThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const bool ok = r < rows;
    cp_async16(smem_u32(qs + r * RS + col), q + (row0 + (ok ? r : 0)) * D + col,
               ok);
  }
  cp_async_commit();
  const size_t base = (static_cast<size_t>(bh) * smax + k_begin) * D;
  const bf16* kp = k_cache + base;
  const bf16* vp = v_cache + base;
  const int n_kt = (n_keys + kBK - 1) / kBK;
  if (n_kt > 0) {
    copy_keys<D>(ring, kp, n_keys, tid);
    copy_keys<D>(ring + kTile, vp, n_keys, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();  // the Q rows
  __syncthreads();

  // ldmatrix row addresses of this lane (as the flash and paged
  // kernels'): Q (A, x4) rows lane%16, columns +8 for lanes 16-31; K (B,
  // x4 = two n-tiles) keys lane%8 (+8 for lanes 16-31), columns +8 for
  // lanes 8-15 and 24-31; V (B, x4.trans) keys lane%8 (+8 for lanes 8-15
  // and 24-31), columns +8 for lanes 16-31.
  uint32_t qa[D / 16][4];
  const uint32_t q_addr = smem_u32(qs + (lane & 15) * RS + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(q_addr + kk * 16 * 2, qa[kk]);
  const int k_lane =
      ((lane & 7) + ((lane >> 4) << 3)) * RS + ((lane >> 3) & 1) * 8;
  const int v_lane =
      ((lane & 7) + (((lane >> 3) & 1) << 3)) * RS + (lane >> 4) * 8;

  float o[D / 8][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    if (it + 1 < n_kt) {
      bf16* next = ring + ((it + 1) & 1) * 2 * kTile;
      const int j = (it + 1) * kBK;
      copy_keys<D>(next, kp + static_cast<size_t>(j) * D, n_keys - j, tid);
      copy_keys<D>(next + kTile, vp + static_cast<size_t>(j) * D, n_keys - j,
                   tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int w0 = it * kBK + warp * kWarpKeys;  // the warp's first key
    if (w0 < n_keys) {
      const bf16* stage = ring + (it & 1) * 2 * kTile + warp * kWarpKeys * RS;
      const uint32_t k_addr = smem_u32(stage + k_lane);
      const uint32_t v_addr = smem_u32(stage + kTile + v_lane);
      if (w0 + kWarpKeys > n_keys)
        mma_keys<D, true>(o, m, l, qa, k_addr, v_addr, scale_log2,
                          n_keys - w0, t4);
      else
        mma_keys<D, false>(o, m, l, qa, k_addr, v_addr, scale_log2,
                           kWarpKeys, t4);
    }
    __syncthreads();  // the stage is refilled next iteration
  }

  // the warps' (m, l, O) merged in warp order; the ring is free
  float* wo = reinterpret_cast<float*>(ring);      // (warps, kRows, WS)
  float* wm = wo + kMmaWarps * kRows * WS;         // (warps, kRows)
  float* wl = wm + kMmaWarps * kRows;              // (warps, kRows)
  float* wf = wl + kMmaWarps * kRows;              // (warps, kRows)
  float* row_m = wf + kMmaWarps * kRows;           // (kRows,)
  float* row_l = row_m + kRows;                    // (kRows,)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 8 * r + gq;
    const float lsum = quad_sum(l[r]);
    if (row >= rows) continue;  // a head past the group
    float* dst = wo + (warp * kRows + row) * WS + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[j][2 * r], o[j][2 * r + 1]);
    if (t4 == 0) {
      wm[warp * kRows + row] = m[r];
      wl[warp * kRows + row] = lsum;
    }
  }
  __syncthreads();
  if (tid < rows) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) mx = fmaxf(mx, wm[w * kRows + tid]);
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float f = exp2f(wm[w * kRows + tid] - mx);
      wf[w * kRows + tid] = f;
      lt += f * wl[w * kRows + tid];
    }
    row_m[tid] = mx;
    row_l[tid] = lt;
  }
  __syncthreads();
  for (int e = tid; e < rows * (D / 4); e += kMmaThreads) {
    const int r = e / (D / 4);
    const int col = (e - r * (D / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float f = wf[w * kRows + r];
      const float4 x =
          *reinterpret_cast<const float4*>(wo + (w * kRows + r) * WS + col);
      acc.x += f * x.x;
      acc.y += f * x.y;
      acc.z += f * x.z;
      acc.w += f * x.w;
    }
    if (n_splits == 1) {
      const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
      uint2 pk;
      pk.x = pack_bf16(acc.x * inv, acc.y * inv);
      pk.y = pack_bf16(acc.z * inv, acc.w * inv);
      *reinterpret_cast<uint2*>(out + (row0 + r) * D + col) = pk;
    } else {
      *reinterpret_cast<float4*>(
          part_o + ((row0 + r) * max_splits + split) * D + col) = acc;
    }
  }
  if (n_splits > 1 && tid < rows)
    *reinterpret_cast<float2*>(part_ml +
                               ((row0 + tid) * max_splits + split) * 2) =
        make_float2(row_m[tid], row_l[tid]);
  else if (lse != nullptr && tid < rows)
    lse[row0 + tid] = repro_attn::row_lse<true>(row_m[tid], row_l[tid]);
}

// The splits of each output row (b, h, head) of a row with more than one
// split merged in split order, one warp a row; m in log2 units when LOG2
// (the bf16 kernel's exp2f), else natural (fp32's expf).
template <typename T, bool LOG2, int KS>
__global__ void __launch_bounds__(32)
decode_attention_combine(const int* __restrict__ cache_len,
                         const float* __restrict__ part_o,
                         const float* __restrict__ part_ml,
                         T* __restrict__ out, float* __restrict__ lse,
                         int hkv, int g, int d, int smax, int window,
                         int max_splits) {
  const int row = blockIdx.x;
  int lo, len;
  live_keys(cache_len, row / (hkv * g), smax, window, &lo, &len);
  const int n = row_splits<KS>(len - lo);
  if (n <= 1) return;
  const size_t r = static_cast<size_t>(row);
  repro_attn::combine_splits<LOG2>(part_ml + r * max_splits * 2,
                                   part_o + r * max_splits * d, out + r * d,
                                   n, d, lse == nullptr ? nullptr : lse + r);
}

// What a call launched, written to `launched` when it is not null: device
// launches, then the thread blocks of the main kernel and the combine.
void record(int* launched, int launches, int main_blocks, int combine) {
  if (launched == nullptr) return;
  launched[0] = launches;
  launched[1] = main_blocks;
  launched[2] = combine;
}

// A call's arguments, passed down the dtype and head-dim dispatch.
struct Args {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const int* cache_len;
  void* out;
  float* lse;
  void* work;
  int b, hkv, g, smax;
  float scale;
  int window;
  int* launched;
  cudaStream_t stream;
};

// What sets a variant's split plan and launch.  T: the element type; KS:
// keys a split; HEADS: query heads a block; LOG2: the softmax's units.
template <int D, bool F32>
struct Variant;

template <int D>
struct Variant<D, true> {
  using T = float;
  static constexpr int KS = kSimtSplitKeys;
  static constexpr int HEADS = kGC;
  static constexpr int THREADS = kThreads;
  static constexpr bool LOG2 = false;
  static constexpr size_t smem() { return sizeof(float) * smem_floats<D>(); }
  static auto kernel() { return &decode_attention_simt<D>; }
  static float scale(float s) { return s; }
  static constexpr int key_tile = kSimtWarpKeys;
};

template <int D>
struct Variant<D, false> {
  using T = bf16;
  static constexpr int KS = kSplitKeys;
  static constexpr int HEADS = kRows;
  static constexpr int THREADS = kMmaThreads;
  static constexpr bool LOG2 = true;
  static constexpr size_t smem() { return mma_smem_bytes<D>(); }
  static auto kernel() { return &decode_attention_mma<D>; }
  static float scale(float s) { return s * kLog2e; }
  static constexpr int key_tile = kBK;
};

// The main kernel over the grid (B*Hkv, ceil(span / KS), ceil(G/HEADS)),
// then, when that grid has more than one split, the combine.
template <int D, bool F32>
int launch(const Args& a) {
  using V = Variant<D, F32>;
  using T = typename V::T;
  const int ns = grid_splits(a.smax, a.window, V::KS);
  const int head_blocks = (a.g + V::HEADS - 1) / V::HEADS;
  if (ns > kMaxGridYZ || head_blocks > kMaxGridYZ) return -2;
  constexpr size_t smem = V::smem();
  auto kernel = V::kernel();
  int err = static_cast<int>(allow_smem(kernel, smem));
  if (err != 0) return err;
  const int n_rows = a.b * a.hkv * a.g;
  float* part_o = ns > 1 ? static_cast<float*>(a.work) : nullptr;
  float* part_ml =
      ns > 1 ? part_o + static_cast<size_t>(n_rows) * ns * D : nullptr;
  const dim3 grid(a.b * a.hkv, ns, head_blocks);
  kernel<<<grid, V::THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_cache),
      static_cast<const T*>(a.v_cache), a.cache_len, static_cast<T*>(a.out),
      a.lse, part_o, part_ml, a.hkv, a.g, a.smax, ns, V::scale(a.scale),
      a.window);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int main_blocks = static_cast<int>(grid.x * grid.y * grid.z);
  if (ns == 1) {
    record(a.launched, 1, main_blocks, 0);
    return 0;
  }
  decode_attention_combine<T, V::LOG2, V::KS><<<n_rows, 32, 0, a.stream>>>(
      a.cache_len, part_o, part_ml, static_cast<T*>(a.out), a.lse, a.hkv, a.g,
      D, a.smax, a.window, ns);
  err = static_cast<int>(cudaGetLastError());
  if (err == 0) record(a.launched, 2, main_blocks, n_rows);
  return err;
}

// registers, local (spill) bytes, dynamic shared bytes, blocks per SM,
// threads per block, keys a tile (a warp's for simt, a ring stage's for
// mma), keys a split
template <int D, bool F32>
int kernel_attrs(int* out) {
  using V = Variant<D, F32>;
  auto kernel = V::kernel();
  cudaError_t err = allow_smem(kernel, V::smem());
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      V::THREADS, V::smem());
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(V::smem());
  out[3] = blocks;
  out[4] = V::THREADS;
  out[5] = V::key_tile;
  out[6] = V::KS;
  return 0;
}

// launch, or report the attributes of the kernel a launch would run
// (attrs != null)
template <int D>
int run(int dtype, const Args& a, int* attrs) {
  if (dtype == 0)
    return attrs != nullptr ? kernel_attrs<D, true>(attrs)
                            : launch<D, true>(a);
  return attrs != nullptr ? kernel_attrs<D, false>(attrs)
                          : launch<D, false>(a);
}

int dispatch(int dtype, int d, const Args& a, int* attrs) {
  if (dtype != 0 && dtype != 1) return -3;
#define DA_CASE(DD) \
  case DD:          \
    return run<DD>(dtype, a, attrs);
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

// dtype codes: 0 float32 (the "simt" kernel), 1 bfloat16 (the "mma"
// kernel); each launches its main kernel and, when the grid has more than
// one split, the combine.  q, caches and out share the dtype.  cache_len
// is (B,) int32; window <= 0 means no window.  `lse`, when not null, is
// (B, Hkv, G) fp32 and gets each row's natural log-sum-exp of its visible
// scaled logits (-inf for a row with no live key), written where the row's
// max and sum are held: by the main kernel for a row of one split, else by
// the combine.  The output's bits do not depend on it.  `work` is a
// 16-byte aligned workspace of `repro_decode_workspace_bytes` bytes (null
// when that is 0).  `launched`, when not null, gets 3 ints: the device launches made,
// then the thread blocks of the main kernel and of the combine.  Returns
// the first nonzero CUDA error of the launches (0 on success), -1 for an
// unsupported head_dim, -2 when the grid's splits or head blocks pass
// 65535 (gridDim.y / .z), -3 for an unsupported dtype.
extern "C" int repro_decode_attention(int dtype, int d, const void* q,
                                      const void* k_cache,
                                      const void* v_cache,
                                      const void* cache_len, void* out,
                                      void* lse, void* work, int b, int hkv,
                                      int g, int smax, float scale,
                                      int window, int* launched,
                                      void* stream) {
  const Args a{q,
               k_cache,
               v_cache,
               static_cast<const int*>(cache_len),
               out,
               static_cast<float*>(lse),
               work,
               b,
               hkv,
               g,
               smax,
               scale,
               window,
               launched,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, d, a, nullptr);
}

// Bytes of the workspace for (B, Hkv, G, D) queries of `dtype` over Smax
// keys under `window`: B * Hkv * G * splits * (D + 2) fp32 of split
// results when the dtype's grid has more than one split, else 0.
extern "C" long long repro_decode_workspace_bytes(int dtype, int b, int hkv,
                                                  int g, int d, int smax,
                                                  int window) {
  const int ns =
      grid_splits(smax, window, dtype == 0 ? kSimtSplitKeys : kSplitKeys);
  if (ns == 1) return 0;
  return static_cast<long long>(sizeof(float)) * b * hkv * g * ns * (d + 2);
}

// The resources of the kernel that `repro_decode_attention` launches for
// (dtype, d): out[0] registers a thread, out[1] local (spill) bytes a
// thread, out[2] dynamic shared bytes a block, out[3] blocks an SM can
// hold, out[4] threads a block, out[5] keys a tile (a warp's 32-key tile
// for simt, a ring stage for mma), out[6] keys a split.  Returns as
// `repro_decode_attention` does.
extern "C" int repro_decode_attention_attrs(int dtype, int d, int* out) {
  return dispatch(dtype, d, Args{}, out);
}
