// The tile machinery shared by the paged kernel (paged_attention.cu) and
// the bf16 mixed kernel (mixed_attention.cu): both run query tiles of
// same-slot tokens x G heads against split key ranges, bf16 on mma.sync,
// fp32 (paged) on the CUDA cores.
//
//   * the work list: `build_worklist`, the body of each kernel's one-block
//     pre-pass, and its shape on the host (`Tiling`, `worklist_bytes`);
//   * one 32-key tile of one warp's 16 rows (`mma_tile`): S = Q K^T, the
//     online softmax in log2 units, O += P V;
//   * a work item's Q rows (`load_q_tile`) and its end (`finish_item`):
//     the normalised rows of a tile of one split, or the split's fp32
//     (m, l) and unnormalised O for the combine;
//   * the fp32 counterparts on the CUDA cores ("simt"): one 32-key tile of
//     one warp's 8 rows (`simt_tile`: register micro-tiles, the online
//     softmax in natural units with expf) and a work item's end
//     (`finish_simt_item`), for every fp32 split-KV path;
//   * the combine of one output row's splits (`combine_row`), on
//     repro_attn::combine_splits;
//   * host helpers: shared-memory opt-in, occupancy, kernel attributes,
//     the launch record.
//
// The kernels differ only in where a key's K/V row lives (through a page
// table, or at a fixed stride of a per-slot cache) and in the pool types
// they take; each keeps its own __global__ entry points, so the profiler
// names them apart.
#pragma once

#include "attention_common.cuh"

namespace repro_attn {

// a tile's descriptor in the work list: first token, tokens, slot, key
// range [lo, hi), splits, lowest and highest position of its tokens
constexpr int kTileFields = 8;
constexpr int kRows = 64;           // query rows of a block: 4 warps x 16
constexpr int kMmaThreads = 128;
constexpr int kBK = 32;             // keys of a ring stage
constexpr int kSplitKeys = 128;     // keys of a split, a multiple of kBK
static_assert(kSplitKeys % kBK == 0, "a split is whole ring stages");
constexpr int kPrepassThreads = 1024;
constexpr int kCombineThreads = 256;  // 8 rows a block, a warp each

__device__ __forceinline__ int clip_slot(int s, int n) {
  return s < 0 ? 0 : (s > n - 1 ? n - 1 : s);
}

// Inclusive scan of x over the block, by max (MAX) or by sum; *total gets
// the block's whole max or sum.  -1 is the identity of max (every value
// scanned by max is >= -1).
template <bool MAX>
__device__ int block_scan(int x, int* buf, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = MAX ? max(x, y) : x + y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? buf[lane] : (MAX ? -1 : 0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = MAX ? max(w, y) : w + y;
    }
    buf[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x = MAX ? max(x, buf[warp - 1]) : x + buf[warp - 1];
  *total = buf[n_warps - 1];
  __syncthreads();  // buf is reused by the next scan
  return x;
}

// The work list, in one int32 workspace:
//   [0] the number of tiles, [1] the number of work items;
//   then T tile descriptors of kTileFields ints;
//   then up to T * max_splits work items, split * T + tile, in tile order
//   (a tile's splits are neighbours, so they run at the same time);
//   then (T,) the split count of each token's tile, for the combine.
// One block walks T in chunks of its size, carrying the last run start
// and the tile and item counts.  key_cap: the keys a slot holds (the
// table width x the page size, or the cache length).
__device__ __forceinline__ void build_worklist(const int* __restrict__ seg,
                                               const int* __restrict__ pos,
                                               int* __restrict__ tiles, int t,
                                               int s_slots, int key_cap,
                                               int tile_tokens,
                                               int max_splits, int window) {
  __shared__ int buf[32];
  int* desc = tiles + 2;
  int* items = desc + t * kTileFields;
  int* token_splits = items + t * max_splits;
  int run_carry = 0, tile_carry = 0, item_carry = 0;
  for (int base = 0; base < t; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool in = i < t;
    const int slot = in ? clip_slot(seg[i], s_slots) : 0;
    const bool run_start =
        in && (i == 0 || clip_slot(seg[i - 1], s_slots) != slot);
    int run_max, n_starts, n_items;
    const int rs = max(block_scan<true>(run_start ? i : -1, buf, &run_max),
                       run_carry);
    const bool starts = in && (i - rs) % tile_tokens == 0;
    const int idx = tile_carry - (starts ? 1 : 0) +
                    block_scan<false>(starts ? 1 : 0, buf, &n_starts);
    int n_splits = 0;
    if (starts) {
      int lo_pos = pos[i], hi_pos = lo_pos, n = 1;
      while (n < tile_tokens && i + n < t &&
             clip_slot(seg[i + n], s_slots) == slot) {
        const int p = pos[i + n];
        lo_pos = min(lo_pos, p);
        hi_pos = max(hi_pos, p);
        ++n;
      }
      const int lo = window > 0 ? max(0, lo_pos - window + 1) : 0;
      const int hi = max(lo, min(hi_pos + 1, key_cap));
      n_splits = max(1, (hi - lo + kSplitKeys - 1) / kSplitKeys);
      int* d = desc + idx * kTileFields;
      d[0] = i;
      d[1] = n;
      d[2] = slot;
      d[3] = lo;
      d[4] = hi;
      d[5] = n_splits;
      d[6] = lo_pos;
      d[7] = hi_pos;
      for (int j = 0; j < n; ++j) token_splits[i + j] = n_splits;
    }
    const int item0 = item_carry - n_splits +
                      block_scan<false>(n_splits, buf, &n_items);
    for (int s = 0; s < n_splits; ++s) items[item0 + s] = s * t + idx;
    run_carry = max(run_carry, run_max);
    tile_carry += n_starts;
    item_carry += n_items;
  }
  if (threadIdx.x == 0) {
    tiles[0] = tile_carry;
    tiles[1] = item_carry;
  }
}

// One key tile of one warp's 16 rows: S = Q K^T, the online softmax,
// O += P V.  k0: the tile's first key; k_end: the split's end; pos_r: the
// positions of the thread's rows g and g + 8; ksc / vsc: the tile's
// per-key scales (CODES only).  MASK: apply the visibility rule.
template <int D, bool MASK, bool CODES>
__device__ __forceinline__ void mma_tile(float (&o)[D / 8][4], float (&m)[2],
                                         float (&l)[2], uint32_t q_addr,
                                         uint32_t k_addr, uint32_t v_addr,
                                         float scale_log2, const float* ksc,
                                         const float* vsc, int k0, int k_end,
                                         const int (&pos_r)[2], int window,
                                         int t) {
  constexpr int RS = D + 8;
  constexpr int NT = kBK / 8;  // n-tiles of S
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(q_addr + kk * 16 * 2, a);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(k_addr + (np * 16 * RS + kk * 16) * 2, b);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }

  // scores in log2 units; masked ones -1e30
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float2 ks2 = make_float2(1.f, 1.f);
    if constexpr (CODES) ks2 = *reinterpret_cast<const float2*>(ksc + 8 * j +
                                                                2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * ((e & 1) ? ks2.y : ks2.x) * scale_log2;
      if constexpr (MASK) {
        const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
        const int p = pos_r[e >> 1];
        bool ok = k_pos < k_end && k_pos <= p;
        if (window > 0) ok = ok && k_pos > p - window;
        x = ok ? x : kNegInf;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
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
  for (int j = 0; j < NT; ++j)
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
  if constexpr (CODES) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 vs2 = *reinterpret_cast<const float2*>(vsc + 8 * j + 2 * t);
      s[j][0] *= vs2.x;
      s[j][1] *= vs2.y;
      s[j][2] *= vs2.x;
      s[j][3] *= vs2.y;
    }
  }

  // O += P V; P rounded to bf16 as the A fragment
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(v_addr + (kk * 16 * RS + dp * 16) * 2, b);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// The Q rows of a work item into qs (row stride RS: D + 8 for bf16), by
// cp.async from kThreads threads: row r is head (row_base + r) % G of
// token first + (row_base + r) / G; rows past the tile (r >= n_rows) are
// zeros.  q is (T, Hkv, G, D).
template <int D, typename T, int RS = D + 8, int kThreads = kMmaThreads>
__device__ __forceinline__ void load_q_tile(T* qs, const T* q, int first,
                                            int row_base, int n_rows, int h,
                                            int hkv, int g, int tid) {
  constexpr int kElems = 16 / sizeof(T);  // elements of a 16-byte chunk
  constexpr int kChunks = D / kElems;
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * kElems;
    const bool ok = r < n_rows;
    const int gr = row_base + (ok ? r : 0);
    const T* src =
        q + ((static_cast<size_t>(first + gr / g) * hkv + h) * g + gr % g) *
                D +
        col;
    cp_async16(smem_u32(qs + r * RS + col), src, ok);
  }
}

// The end of a work item, for the warp that owns rows row0 .. row0 + 15 of
// the block's 64 (gq, t4: the lane's fragment row and column pair;
// warp_live: the warp holds a row of the tile).  A tile of one split
// normalises its rows: each warp stages them in its own rows of qs, then
// writes them to out (T, Hkv, G, D) with 16-byte stores, and, when lse
// (T, Hkv, G) is not null, each row's log-sum-exp.  A split of several
// writes its rows' unnormalised O and (m, l) in fp32, for the combine.
template <int D>
__device__ __forceinline__ void finish_item(
    const float (&o)[D / 8][4], const float (&m)[2], const float (&l)[2],
    __nv_bfloat16* qs, __nv_bfloat16* out, float* part_o, float* part_ml,
    int n_splits,
    int split, int max_splits, int first, int row_base, int n_rows, int h,
    int hkv, int g, int row0, int lane, int gq, int t4, bool warp_live,
    float* lse = nullptr) {
  constexpr int RS = D + 8;
  constexpr int kChunks = D / 8;
  if (n_splits == 1) {
    if (warp_live) {
      __nv_bfloat16* os = qs + row0 * RS;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lsum = quad_sum(l[r]);
        const float inv = 1.f / fmaxf(lsum, 1e-30f);
        const int lrow = row0 + 8 * r + gq;
        if (lse != nullptr && t4 == 0 && lrow < n_rows) {
          const int gr = row_base + lrow;
          lse[(static_cast<size_t>(first + gr / g) * hkv + h) * g + gr % g] =
              row_lse<true>(m[r], lsum);
        }
        __nv_bfloat16* row = os + (8 * r + gq) * RS + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(row + 8 * j) =
              pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      }
      __syncwarp();
      for (int c = lane; c < 16 * kChunks; c += 32) {
        const int r = c / kChunks;
        const int col = (c - r * kChunks) * 8;
        if (row0 + r >= n_rows) break;
        const int gr = row_base + row0 + r;
        const size_t orow =
            (static_cast<size_t>(first + gr / g) * hkv + h) * g + gr % g;
        *reinterpret_cast<uint4*>(out + orow * D + col) =
            *reinterpret_cast<const uint4*>(os + r * RS + col);
      }
    }
  } else {
    if (warp_live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lsum = quad_sum(l[r]);
        const int row = row0 + 8 * r + gq;
        if (row >= n_rows) continue;
        const int gr = row_base + row;
        const size_t orow =
            (static_cast<size_t>(first + gr / g) * hkv + h) * g + gr % g;
        const size_t prow = orow * max_splits + split;
        float* po = part_o + prow * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(po + 8 * j) =
              make_float2(o[j][2 * r], o[j][2 * r + 1]);
        if (t4 == 0)
          *reinterpret_cast<float2*>(part_ml + prow * 2) =
              make_float2(m[r], lsum);
      }
    }
  }
}

// The combine's body: the splits of each output row merged in split order
// (combine_splits: m in log2 units when LOG2), one warp per row (token,
// KV head, query head) of a token whose tile has more than one split.
template <bool LOG2 = true, typename T>
__device__ __forceinline__ void combine_row(const int* __restrict__ tiles,
                                            const float* __restrict__ part_o,
                                            const float* __restrict__ part_ml,
                                            T* __restrict__ out, int t,
                                            int hkv, int g, int d,
                                            int max_splits,
                                            float* lse = nullptr) {
  const size_t row =
      static_cast<size_t>(blockIdx.x) * (kCombineThreads / 32) +
      (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(t) * hkv * g) return;
  const int tok = static_cast<int>(row / (static_cast<size_t>(hkv) * g));
  const int n = tiles[2 + t * (kTileFields + max_splits) + tok];
  if (n <= 1) return;
  combine_splits<LOG2>(part_ml + row * max_splits * 2,
                       part_o + row * max_splits * d, out + row * d, n, d,
                       lse == nullptr ? nullptr : lse + row);
}

// ---------------------------------------------------------------------
// fp32 on the CUDA cores ("simt"): the same work items, 8 warps a block,
// 8 of the 64 rows a warp.  Lane (rg, cg) = (lane / 8, lane % 8) holds
// rows 8 * warp + 2 * rg and + 1; of a 32-key tile it scores keys cg, cg
// + 8, cg + 16 and cg + 24 (so the 8 lanes of a row hold its 32 keys and
// reduce them with three shuffles), and of O it holds D / 8 columns, in
// chunks of kCW at cg * kCW + 8 * kCW * n.  Shared rows are padded by
// kSimtPad floats: the 16-byte loads of 8 lanes that read 8 different
// rows then hit 8 different bank groups, and the rows of the 4 row
// groups are broadcasts.

constexpr int kSimtThreads = 256;
constexpr int kSimtPad = 4;        // floats a shared row is padded by

template <int D>
struct SimtCols {
  static constexpr int kCW = D >= 32 ? 4 : 2;  // columns of a chunk
  static constexpr int kNC = D / (8 * kCW);    // chunks a lane
};

// kCW floats from shared memory / to global memory
template <int N>
__device__ __forceinline__ void load_cols(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
}
template <int N>
__device__ __forceinline__ void store_cols(float* p, const float* v,
                                           float inv) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) =
        make_float4(v[0] * inv, v[1] * inv, v[2] * inv, v[3] * inv);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0] * inv, v[1] * inv);
}

// One 32-key tile of one lane's two rows: S = Q K^T (a 2 x 4 micro-tile),
// the online softmax in fp32 with expf, P through the warp's rows of the
// shared P buffer (pa: the lane's first row, stride kBK + kSimtPad), then
// O += P V (a 2 x D / 8 micro-tile).  qa: the lane's first Q row (the
// second follows at RS); kt / vt: the tile's K and V rows (stride RS); k0:
// the tile's first key; k_end: the split's end; pos_r: the positions of
// the lane's rows.  Every product and sum is taken in a fixed order with
// explicit rounding (__fmul_rn, __fmaf_rn), so a row's result depends
// neither on the other rows of its tile nor on the MASK instantiation.
template <int D, bool MASK>
__device__ __forceinline__ void simt_tile(
    float (&o)[2][D / 8], float (&m)[2], float (&l)[2], const float* qa,
    const float* kt, const float* vt, float* pa, float scale, int k0,
    int k_end, const int (&pos_r)[2], int window, int cg) {
  constexpr int RS = D + kSimtPad;
  constexpr int PS = kBK + kSimtPad;
  constexpr int kCW = SimtCols<D>::kCW;
  constexpr int kNC = SimtCols<D>::kNC;
  float s[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[r][i] = 0.f;
  const float* kc = kt + cg * RS;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 q0 = *reinterpret_cast<const float4*>(qa + d);
    const float4 q1 = *reinterpret_cast<const float4*>(qa + RS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 k = *reinterpret_cast<const float4*>(kc + 8 * i * RS + d);
      s[0][i] = __fmaf_rn(q0.x, k.x, s[0][i]);
      s[0][i] = __fmaf_rn(q0.y, k.y, s[0][i]);
      s[0][i] = __fmaf_rn(q0.z, k.z, s[0][i]);
      s[0][i] = __fmaf_rn(q0.w, k.w, s[0][i]);
      s[1][i] = __fmaf_rn(q1.x, k.x, s[1][i]);
      s[1][i] = __fmaf_rn(q1.y, k.y, s[1][i]);
      s[1][i] = __fmaf_rn(q1.z, k.z, s[1][i]);
      s[1][i] = __fmaf_rn(q1.w, k.w, s[1][i]);
    }
  }

  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = __fmul_rn(s[r][i], scale);
      if constexpr (MASK) {
        const int k_pos = k0 + cg + 8 * i;
        bool ok = k_pos < k_end && k_pos <= pos_r[r];
        if (window > 0) ok = ok && k_pos > pos_r[r] - window;
        x = ok ? x : kNegInf;
      }
      s[r][i] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int o2 = 1; o2 < 8; o2 <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p = expf(s[r][i] - m_new);
      if constexpr (MASK) p = s[r][i] == kNegInf ? 0.f : p;
      pa[r * PS + cg + 8 * i] = p;
      sum = __fadd_rn(sum, p);
    }
#pragma unroll
    for (int o2 = 1; o2 < 8; o2 <<= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o2));
    l[r] = __fmaf_rn(l[r], alpha[r], sum);
  }
  __syncwarp();

#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o[r][c] = __fmul_rn(o[r][c], alpha[r]);
  const float* vc = vt + cg * kCW;
#pragma unroll 2
  for (int j = 0; j < kBK; j += 4) {
    float p[2][4];
    load_cols<4>(pa + j, p[0]);
    load_cols<4>(pa + PS + j, p[1]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int n = 0; n < kNC; ++n) {
        float v[kCW];
        load_cols<kCW>(vc + (j + jj) * RS + 8 * kCW * n, v);
#pragma unroll
        for (int e = 0; e < kCW; ++e) {
          o[0][n * kCW + e] = __fmaf_rn(p[0][jj], v[e], o[0][n * kCW + e]);
          o[1][n * kCW + e] = __fmaf_rn(p[1][jj], v[e], o[1][n * kCW + e]);
        }
      }
    }
  }
}

// The end of a simt work item for a lane's two rows (r0, r0 + 1 of the
// block's 64): a tile of one split writes its normalised rows to out (T,
// Hkv, G, D), and, when lse (T, Hkv, G) is not null, their log-sum-exp;
// a split of several writes its unnormalised O and (m, l), m in natural
// units, for the combine (combine_row<false>).
template <int D>
__device__ __forceinline__ void finish_simt_item(
    const float (&o)[2][D / 8], const float (&m)[2], const float (&l)[2],
    float* out, float* part_o, float* part_ml, int n_splits, int split,
    int max_splits, int first, int row_base, int n_rows, int h, int hkv,
    int g, int r0, int cg, float* lse = nullptr) {
  constexpr int kCW = SimtCols<D>::kCW;
  constexpr int kNC = SimtCols<D>::kNC;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r0 + r >= n_rows) continue;
    const int gr = row_base + r0 + r;
    const size_t orow =
        (static_cast<size_t>(first + gr / g) * hkv + h) * g + gr % g;
    float* dst;
    float inv = 1.f;
    if (n_splits == 1) {
      dst = out + orow * D;
      inv = 1.f / fmaxf(l[r], 1e-30f);
      if (lse != nullptr && cg == 0) lse[orow] = row_lse<false>(m[r], l[r]);
    } else {
      const size_t prow = orow * max_splits + split;
      dst = part_o + prow * D;
      if (cg == 0)
        *reinterpret_cast<float2*>(part_ml + prow * 2) =
            make_float2(m[r], l[r]);
    }
#pragma unroll
    for (int n = 0; n < kNC; ++n)
      store_cols<kCW>(dst + cg * kCW + 8 * kCW * n, o[r] + n * kCW, inv);
  }
}

// ---------------------------------------------------------------------
// host side

// The work list's shape for G query heads a KV head over key_cap keys a
// slot: M tokens at most a tile (M * G <= kRows, one token when G >=
// kRows), the most splits a tile can have, and the 64-row blocks a
// tile's rows take.
struct Tiling {
  int tile_tokens, max_splits, row_blocks;
};

inline Tiling tiling(int g, int key_cap) {
  Tiling s;
  s.tile_tokens = max(1, kRows / g);
  s.max_splits = max(1, (key_cap + kSplitKeys - 1) / kSplitKeys);
  s.row_blocks = (s.tile_tokens * g + kRows - 1) / kRows;
  return s;
}

// Bytes of the work list in the workspace, rounded up to 256: the split
// workspace (fp32) follows it.
inline size_t worklist_bytes(int t, int max_splits) {
  const size_t n = sizeof(int) * (2 + static_cast<size_t>(t) *
                                          (kTileFields + max_splits + 1));
  return (n + 255) / 256 * 256;
}

// Bytes of the workspace for T tokens of (Hkv, G, D): the work list, then,
// when a tile can have more than one split, T * Hkv * G * max_splits *
// (D + 2) fp32 of split results (none for hkv = 0: the work list alone).
inline size_t workspace_bytes(int t, int hkv, int g, int d, int key_cap) {
  const Tiling s = tiling(g, key_cap);
  size_t n = worklist_bytes(t, s.max_splits);
  if (s.max_splits > 1)
    n += sizeof(float) * static_cast<size_t>(t) * hkv * g * s.max_splits *
         (d + 2);
  return n;
}

// Dynamic shared memory above 48 KB is allowed per kernel (and device).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The blocks of `kernel` the card holds at once (blocks an SM x SMs).
template <typename K>
int card_blocks(K kernel, int threads, size_t smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = max(1, per_sm) * sms;
  return 0;
}

// registers, local (spill) bytes, dynamic shared bytes, blocks per SM,
// threads per block, keys per tile
template <typename K>
int kernel_attrs(K kernel, size_t smem, int threads, int key_tile,
                 int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  out[4] = threads;
  out[5] = key_tile;
  return 0;
}

// What a call launched, written to `launched` when it is not null: device
// launches, then the thread blocks of the pre-pass, the main kernel and
// the combine.
inline void record(int* launched, int launches, int prepass, int main_blocks,
                   int combine) {
  if (launched == nullptr) return;
  launched[0] = launches;
  launched[1] = prepass;
  launched[2] = main_blocks;
  launched[3] = combine;
}

}  // namespace repro_attn
