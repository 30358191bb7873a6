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
// What bounds it on the H100: bytes.  Each visible key of a slot costs
// 2*D*itemsize bytes of K and V, read once for all the tokens of the slot
// that see it; each (token, key) pair costs 4*G*D flops.  A decode token
// of gemma-2b in bf16 does G = 8 flops a byte, M*G for the M tokens of a
// prefill chunk that share a key tile: far below the ~295 flops a byte
// where the tensor cores would bind.  What the kernel must avoid is
// reading a slot's keys once per token (the tokens of a prefill chunk
// share them) and leaving the card idle while a long sequence's keys are
// read by one block.  Over fp32 caches the same pair costs 8*D bytes of K
// and V against 4*G*D flops taken as three TF32 products (494.7 / 3
// TFLOP/s): the ~49 flops a byte where 3xTF32 binds lie between a decode
// token's G / 2 a byte (4 at G = 8) and a prefill chunk's slot, whose
// keys all its tokens share, so the bound is bytes or operations by the
// batch.
//
// bf16 q over bf16 caches: tensor cores ("mma", three launches a call:
// the pre-pass, the main kernel and the combine, which a cache of at most
// one split does not need).  The design of the bf16 paged kernel
// (paged_attention.cu), over contiguous caches; the tile machinery is
// shared with it (attention_tiles.cuh):
//   * query tiles: a maximal run of consecutive flat tokens with the same
//     clipped slot, cut every M = max(1, 64 / G) tokens; its rows are its
//     tokens x the G query heads of one KV head, M * G <= 64 (for G > 64
//     one token's heads are cut into 64-row blocks).  A tile's key range
//     is [lo, hi), lo = max(0, min_pos - window + 1) (0 without a window),
//     hi = min(max_pos + 1, L) (never below lo); padding tokens form
//     slot-0 tiles at their own positions and are computed, so no output
//     row is left unwritten;
//   * split-KV: split s of a tile covers keys [lo + s*128, min(hi, lo +
//     (s+1)*128)); a decode token's up to L live keys run as
//     ceil(span / 128) blocks at once, a prefill chunk's as its tiles x
//     splits;
//   * the work list is made on the card by a one-block pre-pass
//     (`mixed_attention_tiles`: the paged pre-pass with the table width x
//     page size replaced by L); the launcher sizes everything from T, G
//     and L, with no host sync;
//   * persistent blocks of 4 warps walk the work items, one KV head [and
//     row block] each (gridDim.z); a warp owns 16 rows.  mma.sync m16n8k16
//     bf16 x bf16 -> fp32: Q and K by ldmatrix, V by ldmatrix.trans, P
//     from the S accumulators into the A fragment, the online softmax in
//     registers (log2 units, exp2f);
//   * key k of (slot, h) lives at ((slot*Hkv + h)*L + k)*D, so a 32-key
//     tile is one contiguous 32 x D run: cp.async copies it (16-byte
//     chunks, rows past the split zero-filled) into a 2-stage ring of rows
//     padded by 16 bytes for ldmatrix, tile j+1's copy issued before tile
//     j's products.  No key addresses are staged (the paged kernel stages
//     each key's pool row from its table);
//   * the causal and window masks apply per row, by each token's own
//     position, on the key tiles that need them only (the causal edge of
//     the tile's lowest position, the window edge of its highest, the
//     ragged end of the split), chosen per tile by a template flag;
//   * a tile of one split normalises and writes its rows; otherwise each
//     split writes its rows' fp32 (m, l) and unnormalised O to a workspace
//     and `mixed_attention_combine` (a warp a row) merges them in split
//     order (repro_attn::combine_splits), so every run gives the same bits;
//   * shared memory at D = 256: the Q tile and two (K, V) stages, ~99 KB:
//     two blocks an SM.  `repro_mixed_attention_attrs` reports registers,
//     spill bytes, shared memory and blocks per SM of each instantiation.
//
// fp32 caches, under fp32 or bf16 q: tensor cores in 3xTF32 ("tf32x3",
// three launches a call as for bf16, two when L fits one split).  fp32 is
// the parity path, held to 1e-5, which TF32 alone misses; the fp32 caches
// that `gather` makes from an int8/fp8 pool are code x scale, not bf16
// values, so rounding them to bf16 would change the function.  The
// probabilities stay fp32 (v's type) before the PV product.
//   * the bf16 path's pre-pass, work list, query tiles, key splits and
//     combine (the combine templated on the output type: fp32 rows for
//     fp32 q, bf16 rows for bf16 q); persistent blocks walk the items;
//   * mma.sync m16n8k8 tf32 with fp32 accumulators, each operand split
//     into a TF32 part and a TF32 remainder (attention_common.cuh:
//     `split_tf32`, `mma_tf32x3`, the fp32 flash kernel's arithmetic), for
//     both S = Q K^T and O += P V.  A bf16 q is exact in TF32, so its
//     remainder is zero and its S takes two products, not three;
//   * 8 warps of 64 rows: the two warps of a row group (w and w + 4) hold
//     the same 16 rows, each the O columns of its half of D (D/4
//     accumulators a thread; a 16-row warp of full rows would hold 128
//     fp32 of O a lane at D = 256).  Each sums S over its half of D and the
//     two partial tiles meet in shared memory (a named barrier of the
//     pair); a + b == b + a, so both warps run the same softmax;
//   * a narrow item (at most 16 rows: a decode token's G = 8 heads, half
//     an m16 tile) would leave 6 of the 8 warps idle and its pair on one
//     scheduler.  At D >= 64 it deals the same products to all 8 warps
//     instead: warp (j, h) sums S's n-tile j over half h, the 8 partial
//     tiles meet in shared memory, every warp adds the halves and runs the
//     softmax on the whole stage, and warp w multiplies P by D/8 of V's
//     columns.  Each output element sees the same operations in the same
//     order as in a wide item, so the narrow and wide paths give the same
//     bits.  The main kernel over the gemma row's 14 decode tokens alone
//     took 26.4 us of device time on one pair, 16.6 on all 8 warps (NVIDIA
//     H100 80GB HBM3, 700 W; PERF.md);
//   * Q and K fragments by ldmatrix .b16 on fp32 rows (lane (g, t) gets
//     row g, float t: the tf32 A and B layouts), split as they are loaded;
//     P from S's accumulators with the keys of a k-step relabelled, V by
//     32-bit shared loads (rows of D + 4 floats: conflict-free);
//   * a 32-key fp32 stage is one contiguous 32 x D run of (slot, h):
//     cp.async copies it (16-byte chunks, rows past the split zero-filled)
//     into a 2-stage ring; a bf16 q is widened to fp32 as its tile is
//     loaded, an fp32 q goes by cp.async;
//   * a row's bits do not depend on its tile-mates (no window): splits
//     start at key 0 in multiples of kSplitKeys, each row masks by its own
//     position, the softmax rounds every step explicitly (__fmul_rn,
//     __fadd_rn, __fmaf_rn: no contraction that a mask flag could change),
//     and the combine merges in split order; a tile of one split divides
//     as the combine does;
//   * shared memory at D = 256: the Q tile, two (K, V) stages and the
//     exchange, 216,064 bytes: one block an SM; 198 registers, no spill,
//     which also caps a block at 8 warps.  Measured and dropped
//     (tools/kernel_variants.py mixed, PERF.md):
//     16-key stages (12% slower), Q's TF32 parts stored once at the load
//     (it needs 16-key stages at D = 256), a second accumulator chain for
//     S's remainder products, a bf16 q's zero remainder product, and 16
//     warps of a quarter of D each (128 registers, 7% slower).
//
// TPU-isms of the Pallas kernel that do not carry over:
//   * lane padding of head_dim to 128 (`_pad_last`, repro/kernels/ops.py:37):
//     head_dim is a template parameter (16-256), nothing is padded or copied;
//   * the (G, 128) VMEM scratch for m and l: registers of each warp;
//   * the sequential grid over L / block_k tiles that carries the softmax
//     state, with dead tiles masked: split-KV over the live keys only,
//     splits that run in parallel and a combine that merges them;
//   * `seg_ids` and `positions` as scalar-prefetch operands routing the
//     BlockSpec index map: the pre-pass reads them into the work list, and
//     each block reads its own tile's rows.

#include <type_traits>

#include "attention_tiles.cuh"

namespace {

using repro_attn::allow_smem;
using repro_attn::cp_async16;
using repro_attn::cp_async_commit;
using repro_attn::cp_async_wait;
using repro_attn::kBK;
using repro_attn::kCombineThreads;
using repro_attn::kernel_attrs;
using repro_attn::kLog2e;
using repro_attn::kMmaThreads;
using repro_attn::kNegInf;
using repro_attn::kPrepassThreads;
using repro_attn::kRows;
using repro_attn::kSplitKeys;
using repro_attn::kTileFields;
using repro_attn::ldsm_x4;
using repro_attn::mma_tf32;
using repro_attn::mma_tf32x3;
using repro_attn::mma_tile;
using repro_attn::quad_max;
using repro_attn::quad_sum;
using repro_attn::record;
using repro_attn::smem_u32;
using repro_attn::split_tf32;
using repro_attn::Tiling;
using repro_attn::worklist_bytes;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------
// bf16 q over bf16 caches on the tensor cores ("mma")

// The work list (repro_attn::build_worklist) over L keys a slot, built by
// one block.
__global__ void __launch_bounds__(kPrepassThreads)
mixed_attention_tiles(const int* __restrict__ seg,
                      const int* __restrict__ pos, int* __restrict__ tiles,
                      int t, int n_slots, int seq_len, int tile_tokens,
                      int max_splits, int window) {
  repro_attn::build_worklist(seg, pos, tiles, t, n_slots, seq_len,
                             tile_tokens, max_splits, window);
}

// Shared memory of the mma kernel: the Q tile and a 2-stage ring of (K, V)
// tiles, rows of D + 8 bf16.
template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (kRows + 4 * kBK) * (D + 8);
}

// Key rows j0 .. j0+kBK-1 of a split (contiguous rows of D from src) into
// a shared tile of row stride D + 8, by cp.async; rows >= n_keys become
// zeros.
template <int D>
__device__ __forceinline__ void copy_keys(bf16* dst, const bf16* src, int j0,
                                          int n_keys, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  for (int c = tid; c < kBK * kChunks; c += kMmaThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const bool ok = j0 + r < n_keys;
    cp_async16(smem_u32(dst + r * (D + 8) + col),
               src + static_cast<size_t>(ok ? j0 + r : 0) * D + col, ok);
  }
}

// Persistent blocks over the work list: block (x, z) takes items x, x +
// gridDim.x, ... for KV head z % Hkv and row block z / Hkv.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
mixed_attention_mma(const bf16* __restrict__ q,        // (T, Hkv, G, D)
                    const bf16* __restrict__ k_cache,  // (S, Hkv, L, D)
                    const bf16* __restrict__ v_cache,
                    const int* __restrict__ pos,       // (T,)
                    const int* __restrict__ tiles,     // the work list
                    bf16* __restrict__ out,            // (T, Hkv, G, D)
                    float* __restrict__ part_o,   // (T*Hkv*G, splits, D)
                    float* __restrict__ part_ml,  // (T*Hkv*G, splits, 2)
                    int t, int hkv, int g, int seq_len, int max_splits,
                    float scale_log2, int window) {
  constexpr int RS = D + 8;
  constexpr int kTile = kBK * RS;  // bf16 elements of a K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (kRows, RS)
  bf16* kv = qs + kRows * RS;  // stage s: K at tile 2s, V at 2s + 1

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment row (and row + 8)
  const int t4 = lane & 3;   // fragment column pair
  const int row0 = warp * 16;
  const int h = blockIdx.z % hkv;
  const int row_base = (blockIdx.z / hkv) * kRows;  // in the tile's rows

  // ldmatrix row addresses of this lane, as the paged kernel's
  const uint32_t q_addr =
      smem_u32(qs + (row0 + (lane & 15)) * RS + (lane >> 4) * 8);
  const int k_lane =
      ((lane & 7) + ((lane >> 4) << 3)) * RS + ((lane >> 3) & 1) * 8;
  const int v_lane =
      ((lane & 7) + (((lane >> 3) & 1) << 3)) * RS + (lane >> 4) * 8;

  const int* descs = tiles + 2;
  const int* items = descs + t * kTileFields;
  const int n_slots = t * max_splits;  // entries of `items`
  // the first item is read beside the item count, and each next one
  // while the current one runs (an entry past the count is never used)
  const int n_items = tiles[1];
  int item = static_cast<int>(blockIdx.x) < n_slots ? items[blockIdx.x] : 0;

  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int tile = item % t;
    const int split = item / t;
    const int w_next = w + gridDim.x;
    const int item_next = w_next < n_slots ? items[w_next] : 0;
    const int* desc = descs + tile * kTileFields;
    const int first = desc[0];
    const int n_rows = min(kRows, desc[1] * g - row_base);
    if (n_rows <= 0) {  // no row block z of this tile
      item = item_next;
      continue;
    }
    const int n_splits = desc[5];
    const int k_begin = desc[3] + split * kSplitKeys;
    const int k_end = min(desc[4], k_begin + kSplitKeys);
    const int n_keys = k_end - k_begin;
    const int min_pos = desc[6];
    const int max_pos = desc[7];
    // the split's first key row of (slot, h)
    const size_t key0 =
        (static_cast<size_t>(desc[2]) * hkv + h) * seq_len + k_begin;
    const bf16* k_src = k_cache + key0 * D;
    const bf16* v_src = v_cache + key0 * D;

    repro_attn::load_q_tile<D>(qs, q, first, row_base, n_rows, h, hkv, g,
                               tid);
    const int n_kt = (n_keys + kBK - 1) / kBK;
    if (n_kt > 0) {
      copy_keys<D>(kv, k_src, 0, n_keys, tid);
      copy_keys<D>(kv + kTile, v_src, 0, n_keys, tid);
    }
    cp_async_commit();

    // this thread's rows' positions (rows past the tile see nothing)
    int pos_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r + gq;
      pos_r[r] = row < n_rows ? pos[first + (row_base + row) / g] : -1;
    }
    const bool warp_live = row0 < n_rows;

    float o[D / 8][4];
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

    for (int it = 0; it < n_kt; ++it) {
      if (it + 1 < n_kt) {
        bf16* next = kv + ((it + 1) & 1) * 2 * kTile;
        copy_keys<D>(next, k_src, (it + 1) * kBK, n_keys, tid);
        copy_keys<D>(next + kTile, v_src, (it + 1) * kBK, n_keys, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (warp_live) {
        const bf16* k_tile = kv + (it & 1) * 2 * kTile;
        const uint32_t k_addr = smem_u32(k_tile + k_lane);
        const uint32_t v_addr = smem_u32(k_tile + kTile + v_lane);
        const int k0 = k_begin + it * kBK;
        const bool need_mask = k0 + kBK > k_end || k0 + kBK - 1 > min_pos ||
                               (window > 0 && k0 <= max_pos - window);
        if (need_mask)
          mma_tile<D, true, false>(o, m, l, q_addr, k_addr, v_addr,
                                   scale_log2, nullptr, nullptr, k0, k_end,
                                   pos_r, window, t4);
        else
          mma_tile<D, false, false>(o, m, l, q_addr, k_addr, v_addr,
                                    scale_log2, nullptr, nullptr, k0, k_end,
                                    pos_r, window, t4);
      }
      __syncthreads();  // the stage is refilled next iteration
    }
    cp_async_wait<0>();  // the Q copy, when no key tile was live
    __syncthreads();

    repro_attn::finish_item<D>(o, m, l, qs, out, part_o, part_ml, n_splits,
                               split, max_splits, first, row_base, n_rows, h,
                               hkv, g, row0, lane, gq, t4, warp_live);
    __syncthreads();  // shared memory is refilled by the next item
    item = item_next;
  }
}

// ---------------------------------------------------------------------
// fp32 caches under fp32 or bf16 q on the tensor cores, 3xTF32 ("tf32x3")

constexpr int kTfWarps = 8;  // 4 row groups of two warps, each half of D
constexpr int kTfThreads = 32 * kTfWarps;
constexpr int kTfKeys = 32;  // keys of a ring stage
static_assert(kSplitKeys % kTfKeys == 0, "a split is whole ring stages");
static_assert(kTfKeys == 32, "a narrow item gives each row group one "
                             "8-key n-tile of the stage");

// floats of a shared row: 16 bytes of padding
template <int D>
__host__ __device__ constexpr int tf_row_stride() {
  return D + 4;
}

// whether items of at most 16 rows run narrow (below D = 64 a warp's
// eighth of D is less than an 8-column n-tile)
template <int D>
__host__ __device__ constexpr bool tf_narrow_items() {
  return D >= 64;
}

// the Q tile, 2 stages of (K, V) tiles, and the partial score tiles the
// warps exchange (kTfKeys / 2 floats a thread)
template <int D>
constexpr size_t tf_smem_bytes() {
  return sizeof(float) * (tf_row_stride<D>() * (kRows + 4 * kTfKeys) +
                          kTfThreads * kTfKeys / 2);
}

// Key rows j0 .. j0 + kTfKeys - 1 of a split (contiguous rows of D floats
// from src) into a shared tile of row stride D + 4, by cp.async; rows >=
// n_keys become zeros.
template <int D>
__device__ __forceinline__ void copy_keys_f32(float* dst, const float* src,
                                              int j0, int n_keys, int tid) {
  constexpr int kChunks = D / 4;  // 16-byte chunks of a row
  for (int c = tid; c < kTfKeys * kChunks; c += kTfThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 4;
    const bool ok = j0 + r < n_keys;
    cp_async16(smem_u32(dst + r * tf_row_stride<D>() + col),
               src + static_cast<size_t>(ok ? j0 + r : 0) * D + col, ok);
  }
}

// The Q rows of a work item as fp32 rows of stride D + 4: row r is head
// (row_base + r) % G of token first + (row_base + r) / G of q (T, Hkv, G,
// D); rows past the tile (r >= n_rows) are zeros.  An fp32 q goes by
// cp.async (committed with the first key stage); a bf16 q through
// registers, widened to fp32 (exact in TF32), 4 elements a step.
template <typename TQ, int D>
__device__ __forceinline__ void load_q_f32(float* qs, const TQ* q,
                                           int first, int row_base,
                                           int n_rows, int h, int hkv, int g,
                                           int tid) {
  constexpr int RS = tf_row_stride<D>();
  if constexpr (std::is_same<TQ, float>::value) {
    repro_attn::load_q_tile<D, float, RS, kTfThreads>(qs, q, first, row_base,
                                                      n_rows, h, hkv, g, tid);
  } else {
    constexpr int kChunks = D / 4;
    for (int c = tid; c < kRows * kChunks; c += kTfThreads) {
      const int r = c / kChunks;
      const int col = (c - r * kChunks) * 4;
      uint2 u = make_uint2(0u, 0u);
      if (r < n_rows) {
        const int gr = row_base + r;
        u = *reinterpret_cast<const uint2*>(
            q + ((static_cast<size_t>(first + gr / g) * hkv + h) * g +
                 gr % g) * D + col);
      }
      // a bf16's bits are the top half of its fp32's
      *reinterpret_cast<uint4*>(qs + r * RS + col) =
          make_uint4(u.x << 16, u.x & 0xffff0000u, u.y << 16,
                     u.y & 0xffff0000u);
    }
  }
}

// the (big, small) TF32 parts of four fp32 values held as bits
__device__ __forceinline__ void split4(const uint32_t (&x)[4],
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_tf32(__uint_as_float(x[e]), big[e], small[e]);
}

// The A fragment of Q for k-step kk of the warp's half (q_addr: this
// lane's ldmatrix row), as TF32 parts: an fp32 q split, a bf16 q (exact
// in TF32) as it is.
template <typename TQ>
__device__ __forceinline__ void q_fragment(uint32_t q_addr, int kk,
                                           uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
  ldsm_x4(q_addr + kk * 8 * 4, big);
  if constexpr (std::is_same<TQ, float>::value) {
    const uint32_t x[4] = {big[0], big[1], big[2], big[3]};
    split4(x, big, small);
  }
}

// c += a b for one k-step: three TF32 products (mma_tf32x3), or two for
// a bf16 q, whose remainder is zero (its a_small term dropped, the other
// two in mma_tf32x3's order)
template <typename TQ>
__device__ __forceinline__ void qk_product(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t b0b, uint32_t b1b,
                                           uint32_t b0s, uint32_t b1s) {
  if constexpr (std::is_same<TQ, bf16>::value) {
    mma_tf32(c, ab, b0s, b1s);
    mma_tf32(c, ab, b0b, b1b);
  } else {
    mma_tf32x3(c, ab, as, b0b, b1b, b0s, b1s);
  }
}

// the two warps of a row group (64 threads) meet at barrier `id`
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// The online softmax of one stage's S (16 rows x kTfKeys keys, the m16n8
// accumulator layout) in log2 units, every step rounded explicitly, so
// that a row's result depends neither on its tile-mates nor on MASK nor
// on which warps computed it: masked scores -1e30 (k0: the stage's first
// key; k_end: the split's end; pos_r: the positions of the thread's rows
// g and g + 8), O's NJ n-tiles rescaled, l summed per thread (reduced
// over the quad at the end); S becomes the unnormalised probabilities.
template <int NJ, bool MASK>
__device__ __forceinline__ void tf32_softmax(float (&s)[kTfKeys / 8][4],
                                             float (&o)[NJ][4],
                                             float (&m)[2], float (&l)[2],
                                             float scale_log2, int k0,
                                             int k_end,
                                             const int (&pos_r)[2],
                                             int window, int t) {
  constexpr int NT = kTfKeys / 8;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(s[j][e], scale_log2);
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
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = exp2f(__fsub_rn(m[r], m_new));
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(__fsub_rn(s[j][e], m[e >> 1]));
      if constexpr (MASK) p = s[j][e] == kNegInf ? 0.f : p;
      s[j][e] = p;
      sum[e >> 1] = __fadd_rn(sum[e >> 1], p);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(alpha[r], l[r], sum[r]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    o[j][0] = __fmul_rn(o[j][0], alpha[0]);
    o[j][1] = __fmul_rn(o[j][1], alpha[0]);
    o[j][2] = __fmul_rn(o[j][2], alpha[1]);
    o[j][3] = __fmul_rn(o[j][3], alpha[1]);
  }
}

// O += P V for the first NJ of the warp's 8-column n-tiles (v_lane: this
// lane's V[key 2t][column g] of the stage, of its first n-tile): A = (c0,
// c2, c1, c3) of each k-step's n-tile of S (the k-step's keys relabelled,
// k = t as key 2t and k = t + 4 as 2t + 1), B by 32-bit shared loads.
template <int D, int NJ, int NO>
__device__ __forceinline__ void tf32_pv(float (&o)[NO][4],
                                        const float (&s)[kTfKeys / 8][4],
                                        const float* v_lane) {
  constexpr int RS = tf_row_stride<D>();
#pragma unroll
  for (int kk = 0; kk < kTfKeys / 8; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(s[kk][0], ab[0], as[0]);
    split_tf32(s[kk][2], ab[1], as[1]);
    split_tf32(s[kk][1], ab[2], as[2]);
    split_tf32(s[kk][3], ab[3], as[3]);
    const float* vk = v_lane + kk * 8 * RS;
#pragma unroll
    for (int dn = 0; dn < NJ; ++dn) {
      uint32_t b0b, b0s, b1b, b1s;
      split_tf32(vk[8 * dn], b0b, b0s);
      split_tf32(vk[RS + 8 * dn], b1b, b1s);
      mma_tf32x3(o[dn], ab, as, b0b, b1b, b0s, b1s);
    }
  }
}

// One key stage of a wide item (more than 16 rows) for one warp: its row
// group's 16 rows, its half of D (the columns at q_addr, k_addr and
// v_lane).  S's partial sum over the half (Q and K fragments by
// ldmatrix, split as they are loaded), added to the other half's through
// shared memory (xs: this warp's slots, xs_other: its pair's; barrier
// pair_id; a + b == b + a, so both warps get the same S); the softmax;
// O += P V for the half's columns.
template <typename TQ, int D, bool MASK>
__device__ __forceinline__ void tf32_tile(
    float (&o)[D / 16][4], float (&m)[2], float (&l)[2], uint32_t q_addr,
    uint32_t k_addr, const float* v_lane, float* xs, const float* xs_other,
    int pair_id, float scale_log2, int k0, int k_end, const int (&pos_r)[2],
    int window, int t) {
  constexpr int RS = tf_row_stride<D>();
  constexpr int NT = kTfKeys / 8;  // n-tiles of S
  constexpr int DH = D / 2;        // columns of the half
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    uint32_t ab[4], as[4];
    q_fragment<TQ>(q_addr, kk, ab, as);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4], bb[4], bs[4];
      ldsm_x4(k_addr + (np * 16 * RS + kk * 8) * 4, b);
      split4(b, bb, bs);
      qk_product<TQ>(s[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
      qk_product<TQ>(s[2 * np + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j)
    *reinterpret_cast<float4*>(xs + j * 128) =
        make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
  pair_sync(pair_id);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(xs_other + j * 128);
    s[j][0] = __fadd_rn(s[j][0], x.x);
    s[j][1] = __fadd_rn(s[j][1], x.y);
    s[j][2] = __fadd_rn(s[j][2], x.z);
    s[j][3] = __fadd_rn(s[j][3], x.w);
  }

  tf32_softmax<D / 16, MASK>(s, o, m, l, scale_log2, k0, k_end, pos_r,
                             window, t);
  tf32_pv<D, D / 16>(o, s, v_lane);
}

// One key stage of a narrow item (at most 16 rows: a decode token's G
// heads) for one warp of all 8: the item's 16 rows, the same products in
// the same order as a wide item's, dealt to every warp.  Warp (j, h) =
// (w % 4, w / 4) sums S's n-tile j over half h of D (k_addr: keys 8j ..,
// its half), the 8 partial tiles meet in shared memory (xs: [n-tile][half]
// [lane]; a barrier of the block), every warp adds the halves of every
// n-tile as the pair of a wide item does and runs the softmax on the
// whole S; then warp w multiplies P by V's columns [w D/8, (w + 1) D/8)
// (v_lane).  So every row's bits are a wide item's, at four times the
// warps.
template <typename TQ, int D, bool MASK>
__device__ __forceinline__ void tf32_tile_narrow(
    float (&o)[D / 16][4], float (&m)[2], float (&l)[2], uint32_t q_addr,
    uint32_t k_addr, const float* v_lane, float* xs, int slot,
    float scale_log2, int k0, int k_end, const int (&pos_r)[2], int window,
    int t) {
  constexpr int NT = kTfKeys / 8;
  constexpr int DH = D / 2;
  const int lane = threadIdx.x & 31;
  float sj[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k2 = 0; k2 < DH / 16; ++k2) {
    // K of two k-steps: b[0], b[1] k-step 2 k2, b[2], b[3] k-step 2 k2 + 1
    uint32_t b[4], bb[4], bs[4];
    ldsm_x4(k_addr + k2 * 16 * 4, b);
    split4(b, bb, bs);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      uint32_t ab[4], as[4];
      q_fragment<TQ>(q_addr, 2 * k2 + u, ab, as);
      qk_product<TQ>(sj, ab, as, bb[2 * u], bb[2 * u + 1], bs[2 * u],
                     bs[2 * u + 1]);
    }
  }
  *reinterpret_cast<float4*>(xs + slot * 128 + lane * 4) =
      make_float4(sj[0], sj[1], sj[2], sj[3]);
  __syncthreads();
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(xs + (2 * j) * 128 +
                                                      lane * 4);
    const float4 c = *reinterpret_cast<const float4*>(
        xs + (2 * j + 1) * 128 + lane * 4);
    s[j][0] = __fadd_rn(a.x, c.x);
    s[j][1] = __fadd_rn(a.y, c.y);
    s[j][2] = __fadd_rn(a.z, c.z);
    s[j][3] = __fadd_rn(a.w, c.w);
  }
  tf32_softmax<D / 16, MASK>(s, o, m, l, scale_log2, k0, k_end, pos_r,
                             window, t);
  tf32_pv<D, D / 64>(o, s, v_lane);
}

// two neighbouring output columns, in the output type
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = repro_attn::pack_bf16(a, b);
}

// The end of a tf32x3 work item, for a warp that owns rows row0 .. row0 +
// 15 of the block's 64 and the NJ 8-column n-tiles from column c0.  A
// tile of one split writes its normalised rows to out (T, Hkv, G, D),
// each value o * (1 / l) as the combine computes it; a split of several
// writes its rows' unnormalised O and, where write_ml, (m, l) in fp32 (m
// in log2 units) for the combine.
template <typename TQ, int D, int NJ>
__device__ __forceinline__ void finish_tf32_item(
    const float (&o)[D / 16][4], const float (&m)[2], const float (&l)[2],
    TQ* out, float* part_o, float* part_ml, int n_splits, int split,
    int max_splits, int first, int row_base, int n_rows, int h, int hkv,
    int g, int row0, int c0, bool write_ml, int gq, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const int row = row0 + 8 * r + gq;
    if (row >= n_rows) continue;
    const int gr = row_base + row;
    const size_t orow =
        (static_cast<size_t>(first + gr / g) * hkv + h) * g + gr % g;
    if (n_splits == 1) {
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      TQ* dst = out + orow * D + c0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        store2(dst + 8 * j, o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    } else {
      const size_t prow = orow * max_splits + split;
      float* po = part_o + prow * D + c0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        store2(po + 8 * j, o[j][2 * r], o[j][2 * r + 1]);
      if (write_ml && t4 == 0)
        *reinterpret_cast<float2*>(part_ml + prow * 2) =
            make_float2(m[r], lsum);
    }
  }
}

// Persistent blocks over the work list, as mixed_attention_mma: block (x,
// z) takes items x, x + gridDim.x, ... for KV head z % Hkv and row block
// z / Hkv.  A wide item (more than 16 rows): warps w and w + 4 own rows 16
// (w % 4) .. + 15, each half of D.  A narrow item (at most 16 rows, at D
// >= 64): every warp works on its rows (tf32_tile_narrow).
template <typename TQ, int D>
__global__ void __launch_bounds__(kTfThreads, 1)
mixed_attention_tf32x3(const TQ* __restrict__ q,          // (T, Hkv, G, D)
                       const float* __restrict__ k_cache,  // (S, Hkv, L, D)
                       const float* __restrict__ v_cache,
                       const int* __restrict__ pos,        // (T,)
                       const int* __restrict__ tiles,      // the work list
                       TQ* __restrict__ out,               // (T, Hkv, G, D)
                       float* __restrict__ part_o,  // (T*Hkv*G, splits, D)
                       float* __restrict__ part_ml,  // (T*Hkv*G, splits, 2)
                       int t, int hkv, int g, int seq_len, int max_splits,
                       float scale_log2, int window) {
  constexpr int RS = tf_row_stride<D>();
  constexpr int BK = kTfKeys;
  constexpr int DH = D / 2;       // O columns of a warp of a wide item
  constexpr int DN = D / 8;       // O columns of a warp of a narrow item
  constexpr int kTile = BK * RS;  // floats of a K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // (kRows, RS)
  float* ring = qs + kRows * RS;  // stage s: K at tile 2s, V at 2s + 1
  float* xbuf = ring + 4 * kTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment row (and row + 8)
  const int t4 = lane & 3;   // fragment column pair
  const int rw = warp % 4;
  const int c0 = warp / 4 * DH;
  const int row0 = rw * 16;
  const int h = blockIdx.z % hkv;
  const int row_base = (blockIdx.z / hkv) * kRows;  // in the tile's rows

  // ldmatrix row addresses of this lane, in its half of D: Q (A, x4) rows
  // row0 + lane%16, columns +4 for lanes 16-31; K (B, x4 = two n-tiles)
  // keys lane%8 (+8 for lanes 16-31), columns +4 for lanes 8-15 and 24-31.
  // V (32-bit loads): key 2t, column g.
  const uint32_t q_addr =
      smem_u32(qs + (row0 + (lane & 15)) * RS + c0 + (lane >> 4) * 4);
  const int k_lane =
      ((lane & 7) + ((lane >> 4) << 3)) * RS + c0 + ((lane >> 3) & 1) * 4;
  const int v_lane = 2 * t4 * RS + c0 + gq;
  // a narrow item's: Q rows 0-15; K (x4 = two k-steps of n-tile rw) keys
  // 8 rw + lane%8, columns +4 a matrix; V columns from warp * DN
  const uint32_t q_addr_n =
      smem_u32(qs + (lane & 15) * RS + c0 + (lane >> 4) * 4);
  const int k_lane_n = (8 * rw + (lane & 7)) * RS + c0 + (lane >> 3) * 4;
  const int v_lane_n = 2 * t4 * RS + warp * DN + gq;
  // the partial score tiles of a wide item: a float4 of each n-tile a
  // lane, [warp][n-tile][lane]; the pair's warp is 4 warps away
  float* xs = xbuf + warp * BK * 16 + lane * 4;
  const float* xs_other = xs + (warp < 4 ? 4 : -4) * BK * 16;

  const int* descs = tiles + 2;
  const int* items = descs + t * kTileFields;
  const int n_slots = t * max_splits;  // entries of `items`
  // the first item is read beside the item count, and each next one
  // while the current one runs (an entry past the count is never used)
  const int n_items = tiles[1];
  int item = static_cast<int>(blockIdx.x) < n_slots ? items[blockIdx.x] : 0;

  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int tile = item % t;
    const int split = item / t;
    const int w_next = w + gridDim.x;
    const int item_next = w_next < n_slots ? items[w_next] : 0;
    const int* desc = descs + tile * kTileFields;
    const int first = desc[0];
    const int n_rows = min(kRows, desc[1] * g - row_base);
    if (n_rows <= 0) {  // no row block z of this tile
      item = item_next;
      continue;
    }
    const int n_splits = desc[5];
    const int k_begin = desc[3] + split * kSplitKeys;
    const int k_end = min(desc[4], k_begin + kSplitKeys);
    const int n_keys = k_end - k_begin;
    const int min_pos = desc[6];
    const int max_pos = desc[7];
    const bool narrow = tf_narrow_items<D>() && n_rows <= 16;
    // the split's first key row of (slot, h)
    const size_t key0 =
        (static_cast<size_t>(desc[2]) * hkv + h) * seq_len + k_begin;
    const float* k_src = k_cache + key0 * D;
    const float* v_src = v_cache + key0 * D;

    if constexpr (std::is_same<TQ, float>::value)
      load_q_f32<TQ, D>(qs, q, first, row_base, n_rows, h, hkv, g, tid);
    const int n_kt = (n_keys + BK - 1) / BK;
    if (n_kt > 0) {
      copy_keys_f32<D>(ring, k_src, 0, n_keys, tid);
      copy_keys_f32<D>(ring + kTile, v_src, 0, n_keys, tid);
    }
    cp_async_commit();
    if constexpr (!std::is_same<TQ, float>::value)
      load_q_f32<TQ, D>(qs, q, first, row_base, n_rows, h, hkv, g, tid);

    // this thread's rows' positions (rows past the tile see nothing)
    const int my_row0 = narrow ? 0 : row0;
    int pos_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = my_row0 + 8 * r + gq;
      pos_r[r] = row < n_rows ? pos[first + (row_base + row) / g] : -1;
    }
    const bool warp_live = narrow || row0 < n_rows;

    float o[DH / 8][4];
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

    for (int it = 0; it < n_kt; ++it) {
      if (it + 1 < n_kt) {
        float* next = ring + ((it + 1) & 1) * 2 * kTile;
        copy_keys_f32<D>(next, k_src, (it + 1) * BK, n_keys, tid);
        copy_keys_f32<D>(next + kTile, v_src, (it + 1) * BK, n_keys, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* stage = ring + (it & 1) * 2 * kTile;
      const int k0 = k_begin + it * BK;
      const bool need_mask = k0 + BK > k_end || k0 + BK - 1 > min_pos ||
                             (window > 0 && k0 <= max_pos - window);
      if constexpr (tf_narrow_items<D>()) {
        if (narrow) {
          const uint32_t k_addr = smem_u32(stage + k_lane_n);
          const float* v_ptr = stage + kTile + v_lane_n;
          const int slot = 2 * rw + warp / 4;
          if (need_mask)
            tf32_tile_narrow<TQ, D, true>(o, m, l, q_addr_n, k_addr, v_ptr,
                                          xbuf, slot, scale_log2, k0, k_end,
                                          pos_r, window, t4);
          else
            tf32_tile_narrow<TQ, D, false>(o, m, l, q_addr_n, k_addr,
                                           v_ptr, xbuf, slot, scale_log2,
                                           k0, k_end, pos_r, window, t4);
        }
      }
      if (!narrow && warp_live) {
        const uint32_t k_addr = smem_u32(stage + k_lane);
        const float* v_ptr = stage + kTile + v_lane;
        if (need_mask)
          tf32_tile<TQ, D, true>(o, m, l, q_addr, k_addr, v_ptr, xs,
                                 xs_other, 1 + rw, scale_log2, k0, k_end,
                                 pos_r, window, t4);
        else
          tf32_tile<TQ, D, false>(o, m, l, q_addr, k_addr, v_ptr, xs,
                                  xs_other, 1 + rw, scale_log2, k0, k_end,
                                  pos_r, window, t4);
      }
      __syncthreads();  // the stage is refilled next iteration
    }
    cp_async_wait<0>();  // the Q copy, when no key stage was live

    if (narrow)
      finish_tf32_item<TQ, D, DN / 8>(o, m, l, out, part_o, part_ml,
                                      n_splits, split, max_splits, first,
                                      row_base, n_rows, h, hkv, g, 0,
                                      warp * DN, warp == 0, gq, t4);
    else if (warp_live)
      finish_tf32_item<TQ, D, DH / 8>(o, m, l, out, part_o, part_ml,
                                      n_splits, split, max_splits, first,
                                      row_base, n_rows, h, hkv, g, row0, c0,
                                      c0 == 0, gq, t4);
    __syncthreads();  // shared memory is refilled by the next item
    item = item_next;
  }
}

// ---------------------------------------------------------------------
// the launches, shared by both variants

// The splits of each output row merged in split order
// (repro_attn::combine_row, m in log2 units), rows of q's type.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
mixed_attention_combine(const int* __restrict__ tiles,
                        const float* __restrict__ part_o,
                        const float* __restrict__ part_ml,
                        T* __restrict__ out, int t, int hkv, int g, int d,
                        int max_splits) {
  repro_attn::combine_row(tiles, part_o, part_ml, out, t, hkv, g, d,
                          max_splits);
}

int launch_tiles(const int* seg, const int* pos, int* tiles, int t,
                 int n_slots, int seq_len, const Tiling& s, int window,
                 cudaStream_t stream) {
  mixed_attention_tiles<<<1, kPrepassThreads, 0, stream>>>(
      seg, pos, tiles, t, n_slots, seq_len, s.tile_tokens, s.max_splits,
      window);
  return static_cast<int>(cudaGetLastError());
}

// A call's arguments, passed down the dtype and head-dim dispatch.
struct Args {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const int* seg_ids;
  const int* positions;
  void* out;
  void* work;
  int t, hkv, g, n_slots, seq_len;
  float scale;
  int window;
  int* launched;
  cudaStream_t stream;
};

// The main kernel of a (q, cache) pair: bf16 over bf16 on the bf16 tensor
// cores ("mma"), fp32 caches in 3xTF32 ("tf32x3"), with its threads, key
// stage and shared bytes; `attrs` reports its resources, `grid_x` sizes
// its grid and `run` launches it over the work list.
template <typename TQ, typename TKV, int D>
struct Main {
  static constexpr bool kTf = std::is_same<TKV, float>::value;
  static constexpr int kThreads = kTf ? kTfThreads : kMmaThreads;
  static constexpr int kKeys = kTf ? kTfKeys : kBK;
  static constexpr size_t smem() {
    if constexpr (kTf)
      return tf_smem_bytes<D>();
    else
      return mma_smem_bytes<D>();
  }
  static auto kernel() {
    if constexpr (kTf)
      return mixed_attention_tf32x3<TQ, D>;
    else
      return mixed_attention_mma<D>;
  }
  static int attrs(int* out) {
    return kernel_attrs(kernel(), smem(), kThreads, kKeys, out);
  }
  // Blocks the grid's x dimension gets: as many work items as there can
  // be, at most what the card holds at once, shared among the z_blocks
  // KV heads x row blocks.  The occupancy of an instantiation is asked
  // once.
  static int grid_x(int max_items, int z_blocks, int* out) {
    static int held = 0;
    if (held == 0) {
      const int err =
          repro_attn::card_blocks(kernel(), kThreads, smem(), &held);
      if (err != 0) return err;
    }
    *out = max(1, min(max_items, held / z_blocks));
    return 0;
  }
  static void run(const Args& a, dim3 grid, const Tiling& s, float* part,
                  float* part_ml) {
    const auto k = kernel();
    k<<<grid, kThreads, smem(), a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_cache),
        static_cast<const TKV*>(a.v_cache), a.positions,
        static_cast<const int*>(a.work), static_cast<TQ*>(a.out), part,
        part_ml, a.t, a.hkv, a.g, a.seq_len, s.max_splits, a.scale * kLog2e,
        a.window);
  }
};

// the pre-pass, the main kernel and (with more than one split possible)
// the combine, on one stream
template <typename TQ, typename TKV, int D>
int launch(const Args& a) {
  using M = Main<TQ, TKV, D>;
  const Tiling s = repro_attn::tiling(a.g, a.seq_len);
  int* tiles = static_cast<int*>(a.work);
  float* part = s.max_splits > 1
                    ? reinterpret_cast<float*>(
                          static_cast<char*>(a.work) +
                          worklist_bytes(a.t, s.max_splits))
                    : nullptr;
  int err = launch_tiles(a.seg_ids, a.positions, tiles, a.t, a.n_slots,
                         a.seq_len, s, a.window, a.stream);
  if (err != 0) return err;
  err = static_cast<int>(allow_smem(M::kernel(), M::smem()));
  if (err != 0) return err;
  const int z_blocks = a.hkv * s.row_blocks;
  int gx = 0;
  err = M::grid_x(a.t * s.max_splits, z_blocks, &gx);
  if (err != 0) return err;
  float* part_ml =
      part == nullptr
          ? nullptr
          : part + static_cast<size_t>(a.t) * a.hkv * a.g * s.max_splits * D;
  M::run(a, dim3(gx, 1, z_blocks), s, part, part_ml);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (s.max_splits == 1) {
    record(a.launched, 2, 1, gx * z_blocks, 0);
    return 0;
  }
  constexpr int kRowsABlock = kCombineThreads / 32;
  const size_t rows = static_cast<size_t>(a.t) * a.hkv * a.g;
  const unsigned blocks =
      static_cast<unsigned>((rows + kRowsABlock - 1) / kRowsABlock);
  mixed_attention_combine<TQ><<<blocks, kCombineThreads, 0, a.stream>>>(
      tiles, part, part_ml, static_cast<TQ*>(a.out), a.t, a.hkv, a.g, D,
      s.max_splits);
  err = static_cast<int>(cudaGetLastError());
  if (err == 0)
    record(a.launched, 3, 1, gx * z_blocks, static_cast<int>(blocks));
  return err;
}

// what to do once the pair and head_dim are known: launch, or report the
// attributes of the main kernel a launch would run (attrs != null)
template <typename TQ, typename TKV, int D>
int run(const Args& a, int* attrs) {
  if (attrs != nullptr) return Main<TQ, TKV, D>::attrs(attrs);
  return launch<TQ, TKV, D>(a);
}

template <typename TQ, typename TKV>
int dispatch_d(int d, const Args& a, int* attrs) {
  switch (d) {
    case 16: return run<TQ, TKV, 16>(a, attrs);
    case 32: return run<TQ, TKV, 32>(a, attrs);
    case 64: return run<TQ, TKV, 64>(a, attrs);
    case 128: return run<TQ, TKV, 128>(a, attrs);
    case 256: return run<TQ, TKV, 256>(a, attrs);
    default: return -1;
  }
}

int dispatch(int q_dtype, int kv_dtype, int d, const Args& a, int* attrs) {
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch_d<float, float>(d, a, attrs);
  if (q_dtype == 1 && kv_dtype == 1) return dispatch_d<bf16, bf16>(d, a, attrs);
  if (q_dtype == 1 && kv_dtype == 0)
    return dispatch_d<bf16, float>(d, a, attrs);
  return -3;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  Pairs (q, k/v): (1, 1) runs the
// "mma" main kernel, (0, 0) and (1, 0) (bf16 queries over the fp32 caches
// that a gather from an int8/fp8 pool gives) the "tf32x3" one; every pair
// runs the pre-pass, the main kernel and, when a tile can have more than
// one split, the combine.  out has q's type.  seg_ids and positions are
// (T,) int32; window <= 0 means no window.  `work` is a 256-byte aligned
// workspace of `repro_mixed_workspace_bytes` bytes.
// `launched`, when not null, gets 4 ints: the device launches made, then
// the thread blocks of the pre-pass, the main kernel and the combine.
// Returns the first nonzero CUDA error of the launches (0 on success), -1
// for an unsupported head_dim, -3 for an unsupported pair.
extern "C" int repro_mixed_attention(int q_dtype, int kv_dtype, int d,
                                     const void* q, const void* k_cache,
                                     const void* v_cache,
                                     const void* seg_ids,
                                     const void* positions, void* out,
                                     void* work, int t, int hkv, int g,
                                     int n_slots, int seq_len, float scale,
                                     int window, int* launched,
                                     void* stream) {
  const Args a{q, k_cache, v_cache, static_cast<const int*>(seg_ids),
               static_cast<const int*>(positions), out, work, t, hkv, g,
               n_slots, seq_len, scale, window, launched,
               static_cast<cudaStream_t>(stream)};
  return dispatch(q_dtype, kv_dtype, d, a, nullptr);
}

// The work list for G query heads a KV head over caches of L
// keys a slot: out[0] tokens at most a tile, out[1] keys a split, out[2]
// the most splits a tile can have.
extern "C" void repro_mixed_tiling(int g, int seq_len, int* out) {
  const Tiling s = repro_attn::tiling(g, seq_len);
  out[0] = s.tile_tokens;
  out[1] = kSplitKeys;
  out[2] = s.max_splits;
}

// Bytes of the workspace for T tokens of (Hkv, G, D) over
// caches of L keys a slot: the int32 work list, then, when a tile can have
// more than one split, T * Hkv * G * max_splits * (D + 2) fp32 of split
// results (none for hkv = 0: the work list alone).
extern "C" long long repro_mixed_workspace_bytes(int t, int hkv, int g,
                                                 int d, int seq_len) {
  return static_cast<long long>(
      repro_attn::workspace_bytes(t, hkv, g, d, seq_len));
}

// The pre-pass alone: writes the work list for G query heads a
// KV head into `tiles` (a workspace of at least
// `repro_mixed_workspace_bytes(t, 0, g, 0, seq_len)` bytes), as
// `repro_mixed_attention` does before its main kernel.  Returns the CUDA
// error of the launch.
extern "C" int repro_mixed_tiles(const void* seg, const void* pos,
                                 void* tiles, int t, int n_slots,
                                 int seq_len, int g, int window,
                                 void* stream) {
  return launch_tiles(static_cast<const int*>(seg),
                      static_cast<const int*>(pos), static_cast<int*>(tiles),
                      t, n_slots, seq_len, repro_attn::tiling(g, seq_len),
                      window, static_cast<cudaStream_t>(stream));
}

// The resources of the main kernel that `repro_mixed_attention` launches
// for (q dtype, cache dtype, d): out[0] registers a thread, out[1] local
// (spill) bytes a thread, out[2] dynamic shared bytes a block, out[3]
// blocks an SM can hold, out[4] threads a block, out[5] keys a tile.
// Returns as `repro_mixed_attention` does.
extern "C" int repro_mixed_attention_attrs(int q_dtype, int kv_dtype, int d,
                                           int* out) {
  return dispatch(q_dtype, kv_dtype, d, Args{}, out);
}
