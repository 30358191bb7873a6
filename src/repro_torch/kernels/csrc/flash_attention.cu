// Flash attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_kernel` / `flash_attention_fwd` of
// repro/kernels/flash_attention.py (pallas_call at :123) and computes the
// same function: q (B*Hq, Sq, D) against k/v (B*Hkv, Skv, D), query head
// bh reading kv head bh / (Hq/Hkv); the queries are the LAST Sq positions
// (q_offset = Skv - Sq); key j is visible to query i when j < Skv,
// j <= i + q_offset (causal) and j > i + q_offset - window (window).
// Scores and the online softmax are fp32 (masked scores -1e30 give p = 0
// exactly, l clamped at 1e-30); the unnormalised probabilities are
// rounded to v's type before the PV product, as the Pallas kernel does
// (a no-op for fp32).
// Output in q's type.  Tiles wholly above the causal diagonal or below
// the window are never visited (the Pallas kernel's `pl.when`).
//
// What bounds it on the H100: operations.  For gemma-2b prefill (D = 256,
// G = 8 query heads per KV head, causal) it does 4*D flops per live
// (query, key) pair against 2*D*2 bytes per key read once: far above the
// ~295 flops/byte where the bf16 tensor cores (989 TFLOP/s) become the
// limit, and above the ~49 at which 3xTF32 (three products at the
// 494.7 TFLOP/s TF32 rate) becomes the limit for fp32.
//
// bf16: tensor cores (`flash_attention_mma`, variant "mma").
//   * One block of 4 warps (128 threads) per (query tile, query head).
//     At D = 256 a warp owns 16 query rows (64-query tiles); at D <= 128
//     it owns two 16-row m-tiles (128-query tiles), so that every K and
//     V fragment read from shared memory feeds two mma's, as
//     FlashAttention-2 does at those head dims.  blockIdx.x is the query
//     head and blockIdx.y counts query tiles from the last one down, so
//     the blocks issued first (x varies fastest) are every head's last
//     tile, the causal tiles with the most keys, and the tail of the
//     last wave is made of short tiles.  The heads of one KV head are
//     neighbours in that order and share its K/V through L2.
//   * mma.sync.m16n8k16 bf16 x bf16 -> fp32.  S = Q K^T: Q fragments by
//     ldmatrix.x4 from shared memory (held in registers for D <= 64,
//     re-read every k-step for D = 128 and 256, as FlashAttention-2 does
//     at large head dims); K fragments by ldmatrix (non-transposed) from
//     K rows stored (key, d).  O += P V: the S accumulators of two
//     neighbouring n-tiles are the m16n8k16 A fragment, so P goes from
//     registers to the tensor cores as packed bf16 pairs and never
//     touches shared memory; V fragments by ldmatrix.trans from V rows
//     stored (key, d).
//   * The online softmax in registers: a thread holds two rows of each
//     m-tile; a row's max is reduced over its quad (__shfl_xor 1, 2), m
//     stays in registers, l is summed per thread and reduced over the
//     quad once, at the end.  scale * log2(e) is folded into the scores
//     and exp2f takes the place of exp.
//   * A 2-stage ring of (K, V) tiles in shared memory, filled by
//     cp.async.cg 16-byte copies; tile j+1's copy is issued before tile
//     j's products.  A stage holds 32 keys at D >= 128 and 64 below.
//     Rows past Skv (or Sq, for Q) are zero-filled through cp.async's
//     src-size operand and never read.  Rows are padded by 16 bytes
//     (stride D + 8 bf16), which makes every ldmatrix phase (8 rows of
//     16 bytes) and the epilogue's bf16-pair stores free of bank
//     conflicts; no swizzle.  Shared memory: the Q tile plus 2 x (K + V),
//     101,376 bytes at D = 256 and 69,632 at D = 128: two blocks an SM.
//   * The mask arithmetic runs only on the tiles that need it (the causal
//     diagonal, the window's lower edge, the ragged last tile): a
//     template flag chosen per tile, outside the inner loops.
//   * Epilogue: normalise, round to bf16, stage each warp's rows in its
//     own rows of the Q buffer, write them with 16-byte stores.
//   * Registers: the O accumulator is MT * D/2 fp32 a thread (128 at
//     D = 256 and at D = 128) beside MT * BK/2 for S (16 and 32).  With
//     64-key tiles, D = 256 spilled (255 registers, 48 bytes a thread)
//     and held one block an SM; 32-key tiles halve S and the ring, and
//     no instantiation spills (240 registers at D = 256, 252 at 128).
//     `repro_flash_attention_attrs` reports registers, spill bytes,
//     shared memory and blocks per SM of each instantiation.
//   * Not here yet: wgmma, TMA, warp specialisation, persistent blocks,
//     folding the G query heads of one KV head into one tile.
//
// fp32: tensor cores in 3xTF32 (`flash_attention_tf32x3`, variant
// "tf32x3").  fp32 is the parity path, held to 1e-5 (2e-3 at Skv >= 1024)
// against the plain version.  TF32 alone keeps 11 significant bits and
// misses that tier, but three TF32 products of each operand's big and
// small parts (attention_common.cuh: `split_tf32`, `mma_tf32x3`) are
// accurate to a few units of 2^-22, as PyTorch's own fp32
// memory-efficient attention computes it (CUTLASS's OpMultiplyAddFastF32
// on m16n8k8).  What bounds it is then 3x the
// operations at the TF32 rate (494.7 TFLOP/s dense, a wgmma rate; the
// mma.sync products here ran at about half of it on an NVIDIA H100 80GB
// HBM3 at 700.00 W, PERF.md §6).
//   * The grid order, ring, mask flag and epilogue are the bf16 kernel's;
//     a block is 64 query rows and a stage 32 keys at every head_dim.
//   * 8 warps: the two warps of a row group (w and w + 4) hold the same
//     16 rows, each the O columns of its half of D, so a thread keeps
//     D/4 O accumulators.  Each warp sums S = Q K^T over its half of D;
//     the two partial tiles meet in shared memory (a named barrier of the
//     pair) and both warps add them (a + b == b + a, so both hold the same
//     S and run the same softmax); each then multiplies P by its half of
//     V.  With 4 warps of full rows (the first build) a thread held D/2
//     accumulators, used 255 registers at D = 256 and ran one warp a
//     scheduler: 98 us of device time at PERF.md's table row against 53
//     for this design (NVIDIA H100 80GB HBM3, 700.00 W).
//   * mma.sync.m16n8k8 tf32, fp32 accumulators.  Q and K fragments by
//     ldmatrix .b16 (an 8 x 8 b16 matrix is 8 rows of 4 floats, so lane
//     (g, t) gets row g, float t: the tf32 A and B layouts), each split
//     into big and small as it is loaded (not when staged: split copies of
//     the tiles would not fit in shared memory at D = 256).  O += P V: the
//     8 keys of a k-step are relabelled (k = t is key 2t, k = t + 4 key
//     2t + 1) so that S's accumulators (c0, c2, c1, c3) are P's A
//     fragment, with no shuffle; V's B fragment is then V[key 2t][d g] and
//     V[key 2t + 1][d g], two 32-bit shared loads (ldmatrix.trans has no
//     32-bit form; the stride of D + 4 floats puts a warp's 32 loads on 32
//     banks).  Q is re-read from shared memory every k-step.
//   * Shared memory: Q, two (K, V) stages and the exchange, 216,064 bytes
//     at D = 256 (one block an SM); 179 registers at D = 256, no spill.
//
// TPU-isms of the Pallas kernel that do not carry over:
//   * lane padding of head_dim to 128 (`_pad_last`, repro/kernels/ops.py):
//     head_dim is a template parameter (16-256), nothing is padded;
//   * the (block_q, 128) VMEM scratch for m and l: registers;
//   * the sequential grid that carries the softmax state across KV tiles:
//     a loop inside the block;
//   * block_q = block_k = 128, sized for the MXU and VMEM: 64 or 128
//     queries by 32 or 64 keys here, sized for shared memory and registers.

#include "attention_common.cuh"

namespace {

using repro_attn::cp_async16;
using repro_attn::cp_async_commit;
using repro_attn::cp_async_wait;
using repro_attn::kLog2e;
using repro_attn::kNegInf;
using repro_attn::ldsm_x4;
using repro_attn::ldsm_x4_trans;
using repro_attn::mma_bf16;
using repro_attn::mma_tf32x3;
using repro_attn::pack_bf16;
using repro_attn::quad_max;
using repro_attn::quad_sum;
using repro_attn::smem_u32;
using repro_attn::split_tf32;

// ---------------------------------------------------------------------
// bf16 on the tensor cores

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

// keys of a ring stage
template <int D>
__host__ __device__ constexpr int mma_key_tile() {
  return D >= 128 ? 32 : 64;
}

// 16-row m-tiles of a warp
template <int D>
__host__ __device__ constexpr int mma_row_tiles() {
  return D <= 128 ? 2 : 1;
}

// query rows of a block
template <int D>
__host__ __device__ constexpr int mma_block_q() {
  return 16 * kMmaWarps * mma_row_tiles<D>();
}

// bf16 elements of a shared-memory row: 16 bytes of padding
template <int D>
__host__ __device__ constexpr int mma_row_stride() {
  return D + 8;
}

// Q tile + 2 stages of (K, V) tiles
template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * mma_row_stride<D>() *
         (mma_block_q<D>() + 4 * mma_key_tile<D>());
}

// Blocks an SM should hold (__launch_bounds__): what shared memory allows
// (227 KB), and what the registers allow if a thread needs its fp32 O and
// S accumulators and 96 more.
template <int D>
constexpr int mma_min_blocks() {
  constexpr int by_smem = static_cast<int>(232448 / mma_smem_bytes<D>());
  constexpr int acc = mma_row_tiles<D>() * (D + mma_key_tile<D>()) / 2;
  constexpr int by_regs = 65536 / kMmaThreads / (acc + 96);
  constexpr int n = by_smem < by_regs ? by_smem : by_regs;
  return n > 1 ? n : 1;
}

// ROWS rows of D bf16 from src (rows r0 .. r0+ROWS-1 of n_rows) into a
// shared tile of stride D + 8, by cp.async; rows >= n_rows become zeros.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int r0,
                                          int n_rows, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  static_assert(ROWS * kChunks % kMmaThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kMmaThreads; ++i) {
    const int c = tid + i * kMmaThreads;
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const bool ok = r0 + r < n_rows;
    const bf16* g = src + static_cast<size_t>(ok ? r0 + r : 0) * D + col;
    cp_async16(smem_u32(dst + r * mma_row_stride<D>() + col), g, ok);
  }
}

// Where a thread's rows and a key tile stand: what the mask needs.
struct TilePos {
  int q_pos0;  // position of the thread's first row (m-tile 0, row g)
  int k0;      // first key of the tile
  int skv;
  int causal;
  int window;
};

// The online softmax of a warp's S tile (MT m-tiles by NT n-tiles of the
// m16n8 accumulator layout) in registers: scores scaled to log2 units
// (masked ones -1e30 when MASK), each row's max reduced over its quad, O
// (DN n-tiles) rescaled, l summed per thread (reduced over the quad at
// the end); S becomes the unnormalised probabilities.
template <int MT, int NT, int DN, bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[MT][NT][4],
                                               float (&o)[MT][DN][4],
                                               float (&m)[MT][2],
                                               float (&l)[MT][2],
                                               float scale_log2,
                                               const TilePos& tp, int t) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    // scores in log2 units; masked ones -1e30
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][j][e] * scale_log2;
        if constexpr (MASK) {
          const int k_pos = tp.k0 + 8 * j + 2 * t + (e & 1);
          const int q_pos = tp.q_pos0 + 16 * i + (e >> 1) * 8;
          bool ok = k_pos < tp.skv;
          if (tp.causal) ok = ok && k_pos <= q_pos;
          if (tp.window > 0) ok = ok && k_pos > q_pos - tp.window;
          x = ok ? x : kNegInf;
        }
        s[i][j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[i][r], quad_max(mx[r]));
      alpha[r] = exp2f(m[i][r] - m_new);
      m[i][r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[i][j][e] - m[i][e >> 1]);
        if constexpr (MASK) p = s[i][j][e] == kNegInf ? 0.f : p;
        s[i][j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[i][r] = alpha[r] * l[i][r] + sum[r];
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      o[i][j][0] *= alpha[0];
      o[i][j][1] *= alpha[0];
      o[i][j][2] *= alpha[1];
      o[i][j][3] *= alpha[1];
    }
  }
}

// One key tile of one warp: S = Q K^T, the online softmax, O += P V, for
// the warp's MT m-tiles (K and V fragments are read once for all of
// them).  MASK: apply the visibility rule (only tiles that need it).
template <int D, bool MASK>
__device__ __forceinline__ void mma_tile(
    float (&o)[mma_row_tiles<D>()][D / 8][4],
    float (&m)[mma_row_tiles<D>()][2], float (&l)[mma_row_tiles<D>()][2],
    const uint32_t (&qf)[mma_row_tiles<D>()][D <= 64 ? D / 16 : 1][4],
    uint32_t q_addr, uint32_t k_addr, uint32_t v_addr, float scale_log2,
    const TilePos& tp, int t) {
  constexpr int RS = mma_row_stride<D>();
  constexpr int BK = mma_key_tile<D>();
  constexpr int MT = mma_row_tiles<D>();
  constexpr int NT = BK / 8;  // n-tiles of S
  float s[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;

#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if constexpr (D <= 64) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][e] = qf[i][kk][e];
      } else {
        ldsm_x4(q_addr + (i * 16 * RS + kk * 16) * 2, a[i]);
      }
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(k_addr + (np * 16 * RS + kk * 16) * 2, b);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(s[i][2 * np], a[i], b[0], b[1]);
        mma_bf16(s[i][2 * np + 1], a[i], b[2], b[3]);
      }
    }
  }

  online_softmax<MT, NT, D / 8, MASK>(s, o, m, l, scale_log2, tp, t);

  // O += P V; P rounded to bf16 as the A fragment
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      a[i][0] = pack_bf16(s[i][2 * kk][0], s[i][2 * kk][1]);
      a[i][1] = pack_bf16(s[i][2 * kk][2], s[i][2 * kk][3]);
      a[i][2] = pack_bf16(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1]);
      a[i][3] = pack_bf16(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(v_addr + (kk * 16 * RS + dp * 16) * 2, b);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(o[i][2 * dp], a[i], b[0], b[1]);
        mma_bf16(o[i][2 * dp + 1], a[i], b[2], b[3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<D>())
flash_attention_mma(const bf16* __restrict__ q,  // (BHq, Sq, D)
                    const bf16* __restrict__ k,  // (BHkv, Skv, D)
                    const bf16* __restrict__ v,
                    bf16* __restrict__ out,      // (BHq, Sq, D)
                    int sq, int skv, int group, float scale_log2,
                    int causal, int window) {
  constexpr int RS = mma_row_stride<D>();
  constexpr int BK = mma_key_tile<D>();
  constexpr int MT = mma_row_tiles<D>();
  constexpr int BQ = mma_block_q<D>();
  constexpr int kTile = BK * RS;  // bf16 elements of a K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (BQ, RS)
  bf16* ring = qs + BQ * RS;  // stage s: K at tile 2s, V at tile 2s + 1

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = bh / group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int row0 = warp * 16 * MT;  // the warp's first row in the tile
  const int q_offset = skv - sq;

  const bf16* qp = q + static_cast<size_t>(bh) * sq * D;
  const bf16* kp = k + static_cast<size_t>(kvh) * skv * D;
  const bf16* vp = v + static_cast<size_t>(kvh) * skv * D;

  // live keys of this query tile: [k_begin, k_end)
  const int last_q = min(q0 + BQ, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, last_q + q_offset + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  copy_rows<D, BQ>(qs, qp, q0, sq, tid);
  if (n_tiles > 0) {
    copy_rows<D, BK>(ring, kp, k_begin, skv, tid);
    copy_rows<D, BK>(ring + kTile, vp, k_begin, skv, tid);
  }
  cp_async_commit();

  // ldmatrix row addresses of this lane.  Q (A, x4): rows row0 + lane%16,
  // columns +8 for lanes 16-31.  K (B, x4 = two n-tiles): keys lane%8
  // (+8 for lanes 16-31), columns +8 for lanes 8-15 and 24-31.  V (B,
  // x4.trans = two n-tiles of d): keys lane%8 (+8 for lanes 8-15 and
  // 24-31), columns +8 for lanes 16-31.
  const uint32_t q_addr =
      smem_u32(qs + (row0 + (lane & 15)) * RS + (lane >> 4) * 8);
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * RS +
                     ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * RS +
                     (lane >> 4) * 8;

  float o[MT][D / 8][4];
  float m[MT][2];
  float l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;
    m[i][0] = m[i][1] = kNegInf;
    l[i][0] = l[i][1] = 0.f;
  }
  uint32_t qf[MT][D <= 64 ? D / 16 : 1][4];

  TilePos tp{q0 + row0 + g + q_offset, 0, skv, causal, window};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    bf16* stage = ring + (it & 1) * 2 * kTile;
    if (it + 1 < n_tiles) {
      bf16* next = ring + ((it + 1) & 1) * 2 * kTile;
      copy_rows<D, BK>(next, kp, k0 + BK, skv, tid);
      copy_rows<D, BK>(next + kTile, vp, k0 + BK, skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (D <= 64) {
      if (it == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            ldsm_x4(q_addr + (i * 16 * RS + kk * 16) * 2, qf[i][kk]);
      }
    }
    const uint32_t k_addr = smem_u32(stage + k_lane);
    const uint32_t v_addr = smem_u32(stage + kTile + v_lane);
    tp.k0 = k0;
    const bool need_mask = k0 + BK > skv ||
                           (causal && k0 + BK - 1 > q0 + q_offset) ||
                           (window > 0 && k0 <= last_q + q_offset - window);
    if (need_mask)
      mma_tile<D, true>(o, m, l, qf, q_addr, k_addr, v_addr, scale_log2, tp,
                        t);
    else
      mma_tile<D, false>(o, m, l, qf, q_addr, k_addr, v_addr, scale_log2,
                         tp, t);
    __syncthreads();  // the stage is refilled next iteration
  }
  cp_async_wait<0>();  // the Q copy, when no tile was live
  __syncthreads();

  // epilogue: each warp stages its rows in its own rows of qs
  bf16* os = qs + row0 * RS;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / fmaxf(quad_sum(l[i][r]), 1e-30f);
      bf16* row = os + (16 * i + 8 * r + g) * RS + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            pack_bf16(o[i][j][2 * r] * inv, o[i][j][2 * r + 1] * inv);
    }
  __syncwarp();
  bf16* op = out + static_cast<size_t>(bh) * sq * D;
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int n = 0; n < 16 * MT * kChunks / 32; ++n) {
    const int c = lane + 32 * n;
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const int qi = q0 + row0 + r;
    if (qi < sq)
      *reinterpret_cast<uint4*>(op + static_cast<size_t>(qi) * D + col) =
          *reinterpret_cast<const uint4*>(os + r * RS + col);
  }
}

// ---------------------------------------------------------------------
// fp32 on the tensor cores, 3xTF32

constexpr int kTfWarps = 8;   // 4 row groups of two warps, each half of D
constexpr int kTfThreads = 32 * kTfWarps;
constexpr int kTfRows = 64;   // query rows of a block
constexpr int kTfKeys = 32;   // keys of a ring stage

// floats of a shared-memory row: 16 bytes of padding
template <int D>
__host__ __device__ constexpr int tf32_row_stride() {
  return D + 4;
}

// the Q tile, 2 stages of (K, V) tiles, and the partial score tiles the
// warps of a row group exchange (kTfKeys / 2 floats a thread)
template <int D>
constexpr size_t tf32_smem_bytes() {
  return sizeof(float) * (tf32_row_stride<D>() * (kTfRows + 4 * kTfKeys) +
                          kTfThreads * kTfKeys / 2);
}

// ROWS rows of D floats from src (rows r0 .. r0+ROWS-1 of n_rows) into a
// shared tile of stride D + 4, by cp.async; rows >= n_rows become zeros.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows_f32(float* dst, const float* src,
                                              int r0, int n_rows, int tid) {
  constexpr int kChunks = D / 4;  // 16-byte chunks of a row
  for (int c = tid; c < ROWS * kChunks; c += kTfThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 4;
    const bool ok = r0 + r < n_rows;
    const float* g = src + static_cast<size_t>(ok ? r0 + r : 0) * D + col;
    cp_async16(smem_u32(dst + r * tf32_row_stride<D>() + col), g, ok);
  }
}

// the two warps of a row group (64 threads) meet at barrier `id`
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// the (big, small) parts of four fp32 values held as bits
__device__ __forceinline__ void split4(const uint32_t (&x)[4],
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_tf32(__uint_as_float(x[e]), big[e], small[e]);
}

// One key tile of one warp, for its row group's 16 rows and its half of
// D (the columns at q_addr, k_addr and v_lane), on mma.sync m16n8k8 in
// 3xTF32: S's partial sum over the half (Q and K fragments by ldmatrix,
// split as they are loaded), added to the other half's through shared
// memory (xs: this warp's slots, xs_other: its pair's; barrier pair_id);
// the online softmax (the same in both warps of the pair);
// O += P V for the half's columns (P from the S accumulators with the
// keys of a k-step relabelled; V by 32-bit shared loads at v_lane, this
// lane's V[key 2t][d g] of the stage).
template <int D, bool MASK>
__device__ __forceinline__ void tf32_tile(float (&o)[1][D / 16][4],
                                          float (&m)[1][2], float (&l)[1][2],
                                          uint32_t q_addr, uint32_t k_addr,
                                          const float* v_lane, float* xs,
                                          const float* xs_other, int pair_id,
                                          float scale_log2,
                                          const TilePos& tp, int t) {
  constexpr int RS = tf32_row_stride<D>();
  constexpr int NT = kTfKeys / 8;  // n-tiles of S
  constexpr int DH = D / 2;        // columns of the half
  float s[1][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[0][j][e] = 0.f;

#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    uint32_t a[4], ab[4], as[4];
    ldsm_x4(q_addr + kk * 8 * 4, a);
    split4(a, ab, as);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4], bb[4], bs[4];
      ldsm_x4(k_addr + (np * 16 * RS + kk * 8) * 4, b);
      split4(b, bb, bs);
      mma_tf32x3(s[0][2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
      mma_tf32x3(s[0][2 * np + 1], ab, as, bb[2], bb[3], bs[2],
                 bs[3]);
    }
  }

  // S = the two halves' sums (a + b == b + a: both warps get the same S)
#pragma unroll
  for (int j = 0; j < NT; ++j)
    *reinterpret_cast<float4*>(xs + j * 128) =
        make_float4(s[0][j][0], s[0][j][1], s[0][j][2], s[0][j][3]);
  pair_sync(pair_id);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(xs_other + j * 128);
    s[0][j][0] += x.x;
    s[0][j][1] += x.y;
    s[0][j][2] += x.z;
    s[0][j][3] += x.w;
  }

  online_softmax<1, NT, D / 16, MASK>(s, o, m, l, scale_log2, tp, t);

  // O += P V: A = (c0, c2, c1, c3) of the k-step's n-tile of S
#pragma unroll
  for (int kk = 0; kk < kTfKeys / 8; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(s[0][kk][0], ab[0], as[0]);
    split_tf32(s[0][kk][2], ab[1], as[1]);
    split_tf32(s[0][kk][1], ab[2], as[2]);
    split_tf32(s[0][kk][3], ab[3], as[3]);
    const float* vk = v_lane + kk * 8 * RS;
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn) {
      uint32_t b0b, b0s, b1b, b1s;
      split_tf32(vk[8 * dn], b0b, b0s);
      split_tf32(vk[RS + 8 * dn], b1b, b1s);
      mma_tf32x3(o[0][dn], ab, as, b0b, b1b, b0s, b1s);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTfThreads)
flash_attention_tf32x3(const float* __restrict__ q,  // (BHq, Sq, D)
                       const float* __restrict__ k,  // (BHkv, Skv, D)
                       const float* __restrict__ v,
                       float* __restrict__ out,      // (BHq, Sq, D)
                       int sq, int skv, int group, float scale_log2,
                       int causal, int window) {
  constexpr int RS = tf32_row_stride<D>();
  constexpr int BK = kTfKeys;
  constexpr int BQ = kTfRows;
  constexpr int DH = D / 2;       // O columns of a warp
  constexpr int kTile = BK * RS;  // floats of a K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // (BQ, RS)
  float* ring = qs + BQ * RS;  // stage s: K at tile 2s, V at tile 2s + 1

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = bh / group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  // warps w and w + 4 hold the same 16 rows, each half of O's columns
  const int rw = warp % 4;
  const int c0 = warp / 4 * DH;
  const int row0 = rw * 16;
  const int q_offset = skv - sq;

  const float* qp = q + static_cast<size_t>(bh) * sq * D;
  const float* kp = k + static_cast<size_t>(kvh) * skv * D;
  const float* vp = v + static_cast<size_t>(kvh) * skv * D;

  // live keys of this query tile: [k_begin, k_end)
  const int last_q = min(q0 + BQ, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, last_q + q_offset + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  copy_rows_f32<D, BQ>(qs, qp, q0, sq, tid);
  if (n_tiles > 0) {
    copy_rows_f32<D, BK>(ring, kp, k_begin, skv, tid);
    copy_rows_f32<D, BK>(ring + kTile, vp, k_begin, skv, tid);
  }
  cp_async_commit();

  // ldmatrix row addresses of this lane, in its half of D: Q (A, x4) rows
  // row0 + lane%16, columns +4 for lanes 16-31; K (B, x4 = two n-tiles)
  // keys lane%8 (+8 for lanes 16-31), columns +4 for lanes 8-15 and 24-31.
  // V (32-bit loads): key 2t, column g.
  const uint32_t q_addr =
      smem_u32(qs + (row0 + (lane & 15)) * RS + c0 + (lane >> 4) * 4);
  const int k_lane =
      ((lane & 7) + ((lane >> 4) << 3)) * RS + c0 + ((lane >> 3) & 1) * 4;
  const int v_lane = 2 * t * RS + c0 + g;
  // the partial score tiles: a float4 of each n-tile a lane, [warp][n-tile]
  // [lane]; the pair's warp is 4 warps away
  float* xs = ring + 4 * kTile + warp * BK * 16 + lane * 4;
  const float* xs_other = xs + (warp < 4 ? 4 : -4) * BK * 16;

  float o[1][DH / 8][4];
  float m[1][2] = {{kNegInf, kNegInf}};
  float l[1][2] = {{0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[0][j][e] = 0.f;

  TilePos tp{q0 + row0 + g + q_offset, 0, skv, causal, window};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    float* stage = ring + (it & 1) * 2 * kTile;
    if (it + 1 < n_tiles) {
      float* next = ring + ((it + 1) & 1) * 2 * kTile;
      copy_rows_f32<D, BK>(next, kp, k0 + BK, skv, tid);
      copy_rows_f32<D, BK>(next + kTile, vp, k0 + BK, skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t k_addr = smem_u32(stage + k_lane);
    const float* v_ptr = stage + kTile + v_lane;
    tp.k0 = k0;
    const bool need_mask = k0 + BK > skv ||
                           (causal && k0 + BK - 1 > q0 + q_offset) ||
                           (window > 0 && k0 <= last_q + q_offset - window);
    if (need_mask)
      tf32_tile<D, true>(o, m, l, q_addr, k_addr, v_ptr, xs, xs_other,
                         1 + rw, scale_log2, tp, t);
    else
      tf32_tile<D, false>(o, m, l, q_addr, k_addr, v_ptr, xs, xs_other,
                          1 + rw, scale_log2, tp, t);
    __syncthreads();  // the stage is refilled next iteration
  }
  cp_async_wait<0>();  // the Q copy, when no tile was live
  __syncthreads();

  // epilogue: each warp stages its half of its rows in qs, then writes
  // them with 16-byte stores
  float* os = qs + row0 * RS + c0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / fmaxf(quad_sum(l[0][r]), 1e-30f);
    float* row = os + (8 * r + g) * RS + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(o[0][j][2 * r] * inv, o[0][j][2 * r + 1] * inv);
  }
  __syncwarp();
  float* op = out + static_cast<size_t>(bh) * sq * D + c0;
  constexpr int kChunks = DH / 4;
#pragma unroll
  for (int n = 0; n < 16 * kChunks / 32; ++n) {
    const int c = lane + 32 * n;
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 4;
    const int qi = q0 + row0 + r;
    if (qi < sq)
      *reinterpret_cast<float4*>(op + static_cast<size_t>(qi) * D + col) =
          *reinterpret_cast<const float4*>(os + r * RS + col);
  }
}

// ---------------------------------------------------------------------
// launchers

// Dynamic shared memory above 48 KB is allowed per kernel (and device).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int bhq, int bhkv, int sq, int skv, float scale, int causal,
               int window, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  auto kernel = flash_attention_mma<D>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bhq, (sq + mma_block_q<D>() - 1) / mma_block_q<D>());
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), sq, skv,
      bhq / bhkv, scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tf32x3(const void* q, const void* k, const void* v, void* out,
                  int bhq, int bhkv, int sq, int skv, float scale,
                  int causal, int window, cudaStream_t stream) {
  const size_t smem = tf32_smem_bytes<D>();
  auto kernel = flash_attention_tf32x3<D>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bhq, (sq + kTfRows - 1) / kTfRows);
  kernel<<<grid, kTfThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, skv,
      bhq / bhkv, scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
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

template <int D>
int attrs_d(int dtype, int* out) {
  if (dtype == 0)
    return kernel_attrs(flash_attention_tf32x3<D>, tf32_smem_bytes<D>(),
                        kTfThreads, kTfKeys, out);
  return kernel_attrs(flash_attention_mma<D>, mma_smem_bytes<D>(),
                      kMmaThreads, mma_key_tile<D>(), out);
}

#define FA_HEAD_DIMS(X) X(16) X(32) X(64) X(128) X(256)

int dispatch(int dtype, int d, const void* q, const void* k, const void* v,
             void* out, int bhq, int bhkv, int sq, int skv, float scale,
             int causal, int window, cudaStream_t stream) {
#define FA_CASE(DD)                                                        \
  case DD:                                                                 \
    return dtype == 0 ? launch_tf32x3<DD>(q, k, v, out, bhq, bhkv, sq,   \
                                          skv, scale, causal, window,      \
                                          stream)                          \
                      : launch_mma<DD>(q, k, v, out, bhq, bhkv, sq, skv,   \
                                       scale, causal, window, stream);
  switch (d) {
    FA_HEAD_DIMS(FA_CASE)
    default:
      return -1;
  }
#undef FA_CASE
}

}  // namespace

// dtype codes: 0 float32 (3xTF32 tensor cores), 1 bfloat16 (bf16 tensor
// cores); q, k, v and out share it.  causal is 0 or 1; window <= 0 means
// no window.
// Returns the CUDA error of the launch (0 on success), -1 for an
// unsupported head_dim, -3 for an unsupported dtype.
extern "C" int repro_flash_attention(int dtype, int d, const void* q,
                                     const void* k, const void* v, void* out,
                                     int bhq, int bhkv, int sq, int skv,
                                     float scale, int causal, int window,
                                     void* stream) {
  if (dtype != 0 && dtype != 1) return -3;
  return dispatch(dtype, d, q, k, v, out, bhq, bhkv, sq, skv, scale, causal,
                  window, static_cast<cudaStream_t>(stream));
}

// The resources of the kernel that `repro_flash_attention` launches for
// (dtype, d): out[0] registers a thread, out[1] local (spill) bytes a
// thread, out[2] dynamic shared bytes a block, out[3] blocks an SM can
// hold, out[4] threads a block, out[5] keys a tile.  Returns as
// `repro_flash_attention` does.
extern "C" int repro_flash_attention_attrs(int dtype, int d, int* out) {
  if (dtype != 0 && dtype != 1) return -3;
#define FA_ATTRS(DD) \
  case DD:           \
    return attrs_d<DD>(dtype, out);
  switch (d) {
    FA_HEAD_DIMS(FA_ATTRS)
    default:
      return -1;
  }
#undef FA_ATTRS
}
#undef FA_HEAD_DIMS
