// Paged attention over the physical KV page pool, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_paged_kernel` / `paged_attention_fwd` of
// repro/kernels/decode_attention.py and computes the same function:
// token t attends slot clip(seg[t], 0, S-1)'s pages through
// tables[slot, page] at key positions <= pos[t] (and > pos[t] - window
// when a window is given), with an online softmax in fp32
// (NEG_INF = -1e30, l clamped at 1e-30).  The unnormalised probabilities
// are rounded to bf16 before the PV product when q is bf16, as the Pallas
// kernel does (`p.astype(v.dtype)`).  Output (T, Hkv, G, D) in q's dtype.
//
// What bounds it on the H100: bytes.  Each live page is ps*D*2 elements
// of K and V (4*D bytes a key in bf16), and each (token, key) pair costs
// 4*G*D flops: G = 8 flops a byte for a decode token of gemma-2b in bf16
// (M*G for M tokens of a prefill chunk that share the page), far below
// the ~295 flops a byte where the tensor cores would bind.  The bytes that count are
// each live page read once; what the kernel must avoid is reading a page
// once per token (the tokens of a prefill chunk share their pages) and
// leaving the card idle while a long sequence's pages are read by one
// block.
//
// bf16 queries: tensor cores ("mma", three launches a call: the
// pre-pass, the main kernel and the combine, which a table of one split
// does not need).
//   * Query tiles that share pages.  A tile is a maximal run of
//     consecutive flat tokens with the same clipped slot, cut every M
//     tokens; its rows are its tokens x the G query heads of one KV head
//     (row = token * G + head), M = max(1, 64 / G), so M * G <= 64 rows
//     (8 tokens at gemma-2b's G = 8; for G > 64 one token's heads are cut
//     into 64-row blocks).  The executor lays out each span's tokens
//     contiguously at consecutive positions, so a prefill chunk's K/V tiles
//     are read once for up to M tokens and all their heads.  Every row
//     masks by its own position and window: correctness never depends on
//     the layout, other layouts only make more tiles.  Padding tokens (seg
//     < 0) form slot-0 tiles at their own positions and are computed, so no
//     output row is left unwritten.
//   * Split-KV: split s of a tile covers keys [lo + s*KS, min(hi, lo +
//     (s+1)*KS)) (KS = kSplitKeys = 128, chosen by measurement: 64 and
//     256 were slower; PERF.md §6).  The decode
//     tokens (one token, up to 64 pages) get their parallelism from the
//     splits, the prefill chunks from their tiles.  A tile of one split
//     normalises and writes its output.  Otherwise each split writes its
//     rows' fp32 (m, l) and unnormalised O to a workspace, and
//     `paged_attention_combine` (one warp per output row) merges them in
//     split order: the output is the same bits every run.  (Merging in
//     the main kernel, by whichever split of a tile finished last, put a
//     chain of dependent L2 reads on one block per tile and was slower;
//     PERF.md §6.)
//   * The work list is made on the card (`paged_attention_tiles`, one
//     block): block-wide scans (the start of each token's run, the count
//     of tile starts, the count of splits) give each tile its index and
//     its first work item; the thread of a tile's first token writes its
//     descriptor (first token, tokens, slot, key range [lo, hi) clipped to
//     the table width x ps, splits, lowest and highest position), its
//     work items (tile, split) and the tile's split count beside each of
//     its tokens, for the combine.  No host sync: the launcher sizes
//     everything from T, G and the table width (`tiling`).
//   * Persistent blocks of 4 warps walk the work items (item x, x +
//     gridDim.x, ...; gridDim.x: the blocks the card holds at once, at
//     most the items there can be), for one KV head [and row block] each
//     (gridDim.z).  A grid of one block per possible (tile, split) had
//     been mostly blocks with nothing to do, each holding its ~100 KB of
//     shared memory while it found that out.  A warp owns 16 rows.
//     mma.sync.m16n8k16 bf16 x bf16 -> fp32, the fragment code of the
//     flash kernel (attention_common.cuh): Q and K by ldmatrix, V by
//     ldmatrix.trans, P from the S accumulators straight into the A
//     fragment, the online softmax in registers (log2 units, exp2f).  A
//     warp with no live row (a decode tile holds G rows) skips the
//     products but still helps with the copies.
//   * K/V are staged key by key through the table: the block first writes
//     the pool row of each key of its split to shared memory (key k lives
//     in page tables[slot, k / ps], row k % ps, so every page size works),
//     then copies 32-key tiles by cp.async (16-byte chunks, rows past the
//     split zero-filled) into a 2-stage ring of rows padded by 16 bytes for
//     ldmatrix; tile j+1's copy is issued before tile j's products.
//   * int8 and fp8_e4m3 pools: cp.async cannot convert, so the codes are
//     staged as they are (a 2-stage ring of code tiles) and converted to
//     bf16 in shared memory (exact: int8 and e4m3 values are bf16 values)
//     into one bf16 stage before the products, by integer and fp32
//     bit arithmetic rather than I2F/F2F conversions, which run at a
//     fraction of the rate.  Each key's K scale
//     multiplies its scores in fp32; its V scale multiplies its
//     probabilities before they are rounded to bf16.  The fp32 pool never
//     exists in memory.
//   * The mask arithmetic runs only on key tiles that need it (the causal
//     edge of the tile's lowest position, the window edge of its highest,
//     the ragged end of the split), chosen per tile by a template flag.
//   * Registers: O is D/2 fp32 a thread (128 at D = 256) beside 16 for S;
//     shared memory at D = 256 is about 104 KB: two blocks an SM.
//     `repro_paged_attention_attrs` reports registers, spill bytes, shared
//     memory and blocks per SM of each instantiation.
//   * The work list, the key tile, a work item's Q rows and end, and the
//     combine live in attention_tiles.cuh, shared with the bf16 mixed
//     kernel (mixed_attention.cu), which runs this design over contiguous
//     per-slot caches.
//
// fp32 queries: CUDA cores ("simt", three launches a call as for bf16).
// fp32 is the parity path, held to 1e-5, which TF32 alone misses; 3xTF32
// on the tensor cores holds it (the fp32 flash kernel runs so), but this
// kernel keeps the CUDA cores for now, and what bounds it is operations:
// 4*G*D flops a live (token, key) pair at 67 TFLOP/s (at serving's mixed
// batch about twice the time of reading the live fp32 pages once).  It runs the same
// work list, pre-pass and split combine as the bf16 path:
//   * persistent blocks of 8 warps walk the work items; a warp owns 8 of
//     the tile's 64 rows, and a warp with no live row (a decode tile of
//     G rows) skips the products but helps with the copies;
//   * each split's 32-key K and V tiles are gathered through the table
//     (the pool row of every key staged first, as for bf16) and copied by
//     cp.async into a 2-stage ring of fp32 rows padded by 16 bytes; int8
//     and fp8 codes are staged as they are and dequantized once into one
//     fp32 stage with the (N, ps, Hkv) scales, so the fp32 pool never
//     exists in memory; the tile's Q rows stay in shared memory.  Each
//     K/V element is read from memory once a tile (not once a token, as
//     the first design did: one block per token read its whole context);
//   * S = Q K^T and O += P V are register micro-tiles (a lane: 2 rows x 4
//     keys, then 2 rows x D / 8 columns; repro_attn::simt_tile), so each
//     shared K/V load serves 2 rows and each Q load 4 keys, the 8 lanes
//     of a row hold its 32 keys and the online softmax (fp32, exact
//     expf) reduces them with three shuffles: the tile needs no block
//     barrier between S and O, only the warp's;
//   * a token's result does not depend on its tile-mates: without a
//     window, splits start at key 0 in multiples of kSplitKeys, every row
//     masks by its own position (a key tile or split a row cannot see
//     adds exact zeros), every sum runs in a fixed order with explicit
//     rounding, and the combine divides as the one-split end does;
//   * shared memory at D = 256: Q 66.5 KB, the fp32 ring 133 KB, P 9 KB:
//     one block of 256 threads an SM; O is 64 fp32 registers a lane.
//     `repro_paged_attention_attrs` reports registers, spill bytes, shared
//     memory and blocks per SM of each instantiation.
//   Any page size works: keys are staged one by one through the table,
//   never a page at a time (the first design refused page sizes whose
//   (ps, D) K and V tiles did not fit in shared memory).

// TPU-isms of the Pallas kernel that do not carry over:
//   * lane padding (`_pad_last`, repro/kernels/ops.py:37-43): head_dim
//     is a template parameter here; no pool copy is ever padded;
//   * the `d % 128 == 0` auto rule and its try/except fallback
//     (repro/models/attention.py:243-256): the kernel takes every
//     instantiated head_dim, and the wrapper raises on any other;
//   * the (g, 128) VMEM scratch for m and l: registers;
//   * the sequential grid over one token's pages that carries the softmax
//     state: a loop in the block over its split's keys, and a combine
//     kernel that merges the splits in split order;
//   * scalar prefetch of tables / seg_ids / positions routing a BlockSpec
//     index map: the pre-pass builds the work list and each block reads
//     its own table entries;
//   * `pages_per_tile`: it packed pages into one grid step to amortize
//     the TPU's per-grid-step overhead.  Here a block loops over keys
//     in-kernel, so the parameter is gone;
//   * buffer donation: the page pool is a single-owner tensor updated in
//     place by the executor; this kernel only reads it.
//
// `window` is supported because the reference kernel supports it, though
// the serving executor passes none.

#include <type_traits>

#include "attention_tiles.cuh"

namespace {

using repro_attn::allow_smem;
using repro_attn::cp_async16;
using repro_attn::cp_async_commit;
using repro_attn::cp_async_wait;
using repro_attn::kBK;
using repro_attn::kCombineThreads;
using repro_attn::kLog2e;
using repro_attn::kMmaThreads;
using repro_attn::kNegInf;
using repro_attn::kPrepassThreads;
using repro_attn::kRows;
using repro_attn::kSimtPad;
using repro_attn::kSimtThreads;
using repro_attn::kSplitKeys;
using repro_attn::kTileFields;
using repro_attn::kernel_attrs;
using repro_attn::mma_tile;
using repro_attn::record;
using repro_attn::simt_tile;
using repro_attn::smem_u32;
using repro_attn::Tiling;
using repro_attn::to_f;
using repro_attn::worklist_bytes;

using bf16 = __nv_bfloat16;

// The work list (repro_attn::build_worklist), built by one block.
__global__ void __launch_bounds__(kPrepassThreads)
paged_attention_tiles(const int* __restrict__ seg,
                      const int* __restrict__ pos, int* __restrict__ tiles,
                      int t, int s_slots, int key_cap, int tile_tokens,
                      int max_splits, int window) {
  repro_attn::build_worklist(seg, pos, tiles, t, s_slots, key_cap,
                             tile_tokens, max_splits, window);
}

// Shared memory of the mma kernel: the Q tile; for a bf16 pool a 2-stage
// ring of (K, V) bf16 tiles; for a code pool a 2-stage ring of (K, V) code
// tiles and one (K, V) bf16 stage they are converted into; then each key
// of the split's pool row (and its K and V scales for a code pool).
template <typename KT, int D>
constexpr size_t mma_smem_bytes() {
  constexpr bool kCodes = sizeof(KT) == 1;
  constexpr size_t kTileBytes = sizeof(bf16) * kBK * (D + 8);
  return sizeof(bf16) * kRows * (D + 8) + (kCodes ? 2 : 4) * kTileBytes +
         (kCodes ? 4 * kBK * D : 0) + kSplitKeys * (kCodes ? 12 : 4);
}

// The pool row of every key of the split [k_begin, k_begin + n_keys) of
// `slot` into key_tok (key k lives in page tables[slot, k / ps], row k %
// ps, so every page size works), and for a code pool its K and V scales;
// entries past n_keys are row 0 with scales 0, never read through a live
// score.
template <bool CODES, int kThreads>
__device__ __forceinline__ void stage_key_rows(
    int* key_tok, float* k_sc, float* v_sc, const int* tables,
    const float* k_scale, const float* v_scale, int slot, int p_pages,
    int ps, int k_begin, int n_keys, int h, int hkv, int tid) {
  const int* tab = tables + static_cast<size_t>(slot) * p_pages;
  for (int j = tid; j < kSplitKeys; j += kThreads) {
    int tok = 0;
    float ks = 0.f, vs = 0.f;
    if (j < n_keys) {
      const int key = k_begin + j;
      tok = tab[key / ps] * ps + key % ps;
      if constexpr (CODES) {
        ks = k_scale[static_cast<size_t>(tok) * hkv + h];
        vs = v_scale[static_cast<size_t>(tok) * hkv + h];
      }
    }
    key_tok[j] = tok;
    if constexpr (CODES) {
      k_sc[j] = ks;
      v_sc[j] = vs;
    }
  }
}

// kBK key rows j0 .. j0+kBK-1 of the split (pool rows key_tok[j]) of KV
// head h into a shared tile of row stride kStride (the mma kernel: D + 8
// for bf16, D for codes), by cp.async from kThreads threads; rows >=
// n_keys become zeros.
template <typename KT, int D, int kStride = (sizeof(KT) == 1 ? D : D + 8),
          int kThreads = kMmaThreads>
__device__ __forceinline__ void copy_keys(KT* dst, const KT* pool,
                                          const int* key_tok, int j0,
                                          int n_keys, int h, int hkv,
                                          int tid) {
  constexpr int kElems = 16 / sizeof(KT);  // elements of a 16-byte chunk
  constexpr int kChunks = D / kElems;
  for (int c = tid; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * kElems;
    const bool ok = j0 + r < n_keys;
    const KT* src =
        pool + (static_cast<size_t>(key_tok[ok ? j0 + r : 0]) * hkv + h) * D +
        col;
    cp_async16(smem_u32(dst + r * kStride + col), src, ok);
  }
}

// Four int8 codes (one 32-bit word, the lowest code first) as two pairs
// of bf16, exactly, without I2F (a quarter-rate instruction): code c
// becomes the float with bits 0x4B000000 | (c + 128), which is 2^23 + 128
// + c, minus 2^23 + 128.  An integer of at most 8 bits is a bf16 value:
// the float's upper half.
__device__ __forceinline__ void codes_to_bf16(uint32_t w, int8_t,
                                              uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// Four fp8 e4m3 codes as two pairs of bf16, exactly: the code's sign and
// exponent-mantissa bits moved to the top of a float give its value times
// 2^-120 (normals and subnormals alike: fp32 keeps subnormals without
// fast math), which times 2^120 has at most 4 significant bits, a bf16
// value.  Codes 0x7F / 0xFF (NaN) never occur: the quantizer clamps to
// +-448.
__device__ __forceinline__ void codes_to_bf16(uint32_t w, __nv_fp8_e4m3,
                                              uint32_t& lo, uint32_t& hi) {
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t b = w >> (8 * k);
    f[k] = __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7Fu) << 20)) *
           0x1p120f;
  }
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// kBK rows of D codes -> bf16 rows of stride D + 8, eight codes a step
template <typename KT, int D>
__device__ __forceinline__ void convert_keys(bf16* dst, const KT* src,
                                             int tid) {
  constexpr int kSteps = D / 8;
  for (int c = tid; c < kBK * kSteps; c += kMmaThreads) {
    const int r = c / kSteps;
    const int col = (c - r * kSteps) * 8;
    const uint2 u = *reinterpret_cast<const uint2*>(src + r * D + col);
    uint4 o;
    codes_to_bf16(u.x, KT(), o.x, o.y);
    codes_to_bf16(u.y, KT(), o.z, o.w);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + col) = o;
  }
}

// Persistent blocks over the work list: block (x, z) takes items x, x +
// gridDim.x, ... for KV head z % Hkv and row block z / Hkv.
template <typename KT, int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
paged_attention_mma(const bf16* __restrict__ q,        // (T, Hkv, G, D)
                    const KT* __restrict__ k_pages,    // (N, ps, Hkv, D)
                    const KT* __restrict__ v_pages,
                    const float* __restrict__ k_scale, // (N, ps, Hkv)|null
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,    // (S, P)
                    const int* __restrict__ pos,       // (T,)
                    const int* __restrict__ tiles,     // the work list
                    bf16* __restrict__ out,            // (T, Hkv, G, D)
                    float* __restrict__ lse,           // (T, Hkv, G)|null
                    float* __restrict__ part_o,   // (T*Hkv*G, splits, D)
                    float* __restrict__ part_ml,  // (T*Hkv*G, splits, 2)
                    int t, int hkv, int g, int ps, int p_pages,
                    int max_splits, float scale_log2, int window) {
  constexpr bool kCodes = sizeof(KT) == 1;
  constexpr int RS = D + 8;
  constexpr int kTile = kBK * RS;  // bf16 elements of a K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];

  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (kRows, RS)
  // bf16 pool: stage s has K at tile 2s, V at 2s + 1; codes: one stage
  bf16* kv = qs + kRows * RS;
  KT* codes = reinterpret_cast<KT*>(kv + (kCodes ? 2 : 4) * kTile);
  int* key_tok = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(codes) + (kCodes ? 4 * kBK * D : 0));
  float* k_sc = reinterpret_cast<float*>(key_tok + kSplitKeys);
  float* v_sc = k_sc + kSplitKeys;
  const int ring_tile = kCodes ? kBK * D : kTile;  // elements of a stage half
  KT* ring = kCodes ? codes : reinterpret_cast<KT*>(kv);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment row (and row + 8)
  const int t4 = lane & 3;   // fragment column pair
  const int row0 = warp * 16;
  const int h = blockIdx.z % hkv;
  const int row_base = (blockIdx.z / hkv) * kRows;  // in the tile's rows

  // ldmatrix row addresses of this lane (as the flash kernel's): Q (A,
  // x4) rows row0 + lane%16, columns +8 for lanes 16-31; K (B, x4 = two
  // n-tiles) keys lane%8 (+8 for lanes 16-31), columns +8 for lanes 8-15
  // and 24-31; V (B, x4.trans) keys lane%8 (+8 for lanes 8-15 and 24-31),
  // columns +8 for lanes 16-31.
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
    const int slot = desc[2];
    const int n_splits = desc[5];
    const int k_begin = desc[3] + split * kSplitKeys;
    const int k_end = min(desc[4], k_begin + kSplitKeys);
    const int n_keys = k_end - k_begin;
    const int min_pos = desc[6];
    const int max_pos = desc[7];

    repro_attn::load_q_tile<D>(qs, q, first, row_base, n_rows, h, hkv, g,
                               tid);
    stage_key_rows<kCodes, kMmaThreads>(key_tok, k_sc, v_sc, tables,
                                        k_scale, v_scale, slot, p_pages, ps,
                                        k_begin, n_keys, h, hkv, tid);
    __syncthreads();

    const int n_kt = (n_keys + kBK - 1) / kBK;
    if (n_kt > 0) {
      copy_keys<KT, D>(ring, k_pages, key_tok, 0, n_keys, h, hkv, tid);
      copy_keys<KT, D>(ring + ring_tile, v_pages, key_tok, 0, n_keys, h,
                       hkv, tid);
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
        KT* next = ring + ((it + 1) & 1) * 2 * ring_tile;
        copy_keys<KT, D>(next, k_pages, key_tok, (it + 1) * kBK, n_keys, h,
                         hkv, tid);
        copy_keys<KT, D>(next + ring_tile, v_pages, key_tok, (it + 1) * kBK,
                         n_keys, h, hkv, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* k_tile;
      if constexpr (kCodes) {
        const KT* stage = ring + (it & 1) * 2 * ring_tile;
        convert_keys<KT, D>(kv, stage, tid);
        convert_keys<KT, D>(kv + kTile, stage + ring_tile, tid);
        __syncthreads();
        k_tile = kv;
      } else {
        k_tile = kv + (it & 1) * 2 * kTile;
      }
      if (warp_live) {
        const uint32_t k_addr = smem_u32(k_tile + k_lane);
        const uint32_t v_addr = smem_u32(k_tile + kTile + v_lane);
        const int k0 = k_begin + it * kBK;
        const float* ksc = k_sc + it * kBK;
        const float* vsc = v_sc + it * kBK;
        const bool need_mask = k0 + kBK > k_end || k0 + kBK - 1 > min_pos ||
                               (window > 0 && k0 <= max_pos - window);
        if (need_mask)
          mma_tile<D, true, kCodes>(o, m, l, q_addr, k_addr, v_addr,
                                    scale_log2, ksc, vsc, k0, k_end, pos_r,
                                    window, t4);
        else
          mma_tile<D, false, kCodes>(o, m, l, q_addr, k_addr, v_addr,
                                     scale_log2, ksc, vsc, k0, k_end, pos_r,
                                     window, t4);
      }
      __syncthreads();  // the stage is refilled next iteration
    }
    cp_async_wait<0>();  // the Q copy, when no key tile was live
    __syncthreads();

    repro_attn::finish_item<D>(o, m, l, qs, out, part_o, part_ml, n_splits,
                               split, max_splits, first, row_base, n_rows, h,
                               hkv, g, row0, lane, gq, t4, warp_live, lse);
    __syncthreads();  // shared memory is refilled by the next item
    item = item_next;
  }
}

// ---------------------------------------------------------------------
// fp32 queries on the CUDA cores ("simt")

// Shared memory of the simt kernel: the Q tile (fp32 rows of D + kSimtPad);
// for an fp32 pool a 2-stage ring of (K, V) fp32 tiles; for a code pool a
// 2-stage ring of (K, V) code tiles and one (K, V) fp32 stage they are
// dequantized into; the P rows; then each key of the split's pool row
// (and its K and V scales for a code pool).
template <typename KT, int D>
constexpr size_t simt_smem_bytes() {
  constexpr bool kCodes = sizeof(KT) == 1;
  constexpr size_t kTileBytes = sizeof(float) * kBK * (D + kSimtPad);
  return sizeof(float) * kRows * (D + kSimtPad) +
         (kCodes ? 2 : 4) * kTileBytes + (kCodes ? 4 * kBK * D : 0) +
         sizeof(float) * kRows * (kBK + kSimtPad) +
         kSplitKeys * (kCodes ? 12 : 4);
}

// kBK rows of D codes -> fp32 rows of stride D + kSimtPad, each times its
// key's scale (exact codes, one rounding: the plain version's
// dequantization)
template <typename KT, int D>
__device__ __forceinline__ void dequantize_keys(float* dst, const KT* src,
                                                const float* sc, int tid) {
  constexpr int kSteps = D / 4;
  for (int c = tid; c < kBK * kSteps; c += kSimtThreads) {
    const int r = c / kSteps;
    const int col = (c - r * kSteps) * 4;
    const KT* x = src + r * D + col;
    const float f = sc[r];
    *reinterpret_cast<float4*>(dst + r * (D + kSimtPad) + col) =
        make_float4(to_f(x[0]) * f, to_f(x[1]) * f, to_f(x[2]) * f,
                    to_f(x[3]) * f);
  }
}

// Persistent blocks over the work list, as paged_attention_mma: block (x,
// z) takes items x, x + gridDim.x, ... for KV head z % Hkv and row block
// z / Hkv; warp w owns rows 8w .. 8w + 7 of the block's 64.
template <typename KT, int D>
__global__ void __launch_bounds__(kSimtThreads, 1)
paged_attention_simt(const float* __restrict__ q,      // (T, Hkv, G, D)
                     const KT* __restrict__ k_pages,   // (N, ps, Hkv, D)
                     const KT* __restrict__ v_pages,
                     const float* __restrict__ k_scale,  // (N, ps, Hkv)|null
                     const float* __restrict__ v_scale,
                     const int* __restrict__ tables,   // (S, P)
                     const int* __restrict__ pos,      // (T,)
                     const int* __restrict__ tiles,    // the work list
                     float* __restrict__ out,          // (T, Hkv, G, D)
                     float* __restrict__ lse,          // (T, Hkv, G)|null
                     float* __restrict__ part_o,  // (T*Hkv*G, splits, D)
                     float* __restrict__ part_ml,  // (T*Hkv*G, splits, 2)
                     int t, int hkv, int g, int ps, int p_pages,
                     int max_splits, float scale, int window) {
  constexpr bool kCodes = sizeof(KT) == 1;
  constexpr int RS = D + kSimtPad;
  constexpr int kTile = kBK * RS;  // floats of a K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];

  float* qs = reinterpret_cast<float*>(smem_raw);  // (kRows, RS)
  // fp32 pool: stage s has K at tile 2s, V at 2s + 1; codes: one stage
  float* kv = qs + kRows * RS;
  KT* codes = reinterpret_cast<KT*>(kv + (kCodes ? 2 : 4) * kTile);
  float* pbuf = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(codes) + (kCodes ? 4 * kBK * D : 0));
  int* key_tok = reinterpret_cast<int*>(pbuf + kRows * (kBK + kSimtPad));
  float* k_sc = reinterpret_cast<float*>(key_tok + kSplitKeys);
  float* v_sc = k_sc + kSplitKeys;
  const int ring_tile = kCodes ? kBK * D : kTile;  // elements of a stage half
  KT* ring = kCodes ? codes : reinterpret_cast<KT*>(kv);
  constexpr int kStride = kCodes ? D : RS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int cg = lane & 7;                      // key / column group
  const int r0 = warp * 8 + (lane >> 3) * 2;    // the lane's first row
  const int h = blockIdx.z % hkv;
  const int row_base = (blockIdx.z / hkv) * kRows;  // in the tile's rows

  const int* descs = tiles + 2;
  const int* items = descs + t * kTileFields;
  const int n_slots = t * max_splits;  // entries of `items`
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
    const int slot = desc[2];
    const int n_splits = desc[5];
    const int k_begin = desc[3] + split * kSplitKeys;
    const int k_end = min(desc[4], k_begin + kSplitKeys);
    const int n_keys = k_end - k_begin;
    const int min_pos = desc[6];
    const int max_pos = desc[7];

    repro_attn::load_q_tile<D, float, RS, kSimtThreads>(
        qs, q, first, row_base, n_rows, h, hkv, g, tid);
    stage_key_rows<kCodes, kSimtThreads>(key_tok, k_sc, v_sc, tables,
                                         k_scale, v_scale, slot, p_pages, ps,
                                         k_begin, n_keys, h, hkv, tid);
    __syncthreads();

    const int n_kt = (n_keys + kBK - 1) / kBK;
    if (n_kt > 0) {
      copy_keys<KT, D, kStride, kSimtThreads>(ring, k_pages, key_tok, 0,
                                              n_keys, h, hkv, tid);
      copy_keys<KT, D, kStride, kSimtThreads>(ring + ring_tile, v_pages,
                                              key_tok, 0, n_keys, h, hkv,
                                              tid);
    }
    cp_async_commit();

    // this lane's rows' positions (rows past the tile see nothing)
    int pos_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      pos_r[r] = r0 + r < n_rows ? pos[first + (row_base + r0 + r) / g] : -1;
    const bool warp_live = warp * 8 < n_rows;

    float o[2][D / 8];
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < D / 8; ++c) o[r][c] = 0.f;

    for (int it = 0; it < n_kt; ++it) {
      if (it + 1 < n_kt) {
        KT* next = ring + ((it + 1) & 1) * 2 * ring_tile;
        copy_keys<KT, D, kStride, kSimtThreads>(
            next, k_pages, key_tok, (it + 1) * kBK, n_keys, h, hkv, tid);
        copy_keys<KT, D, kStride, kSimtThreads>(
            next + ring_tile, v_pages, key_tok, (it + 1) * kBK, n_keys, h,
            hkv, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* k_tile;
      if constexpr (kCodes) {
        const KT* stage = ring + (it & 1) * 2 * ring_tile;
        dequantize_keys<KT, D>(kv, stage, k_sc + it * kBK, tid);
        dequantize_keys<KT, D>(kv + kTile, stage + ring_tile,
                               v_sc + it * kBK, tid);
        __syncthreads();
        k_tile = kv;
      } else {
        k_tile = kv + (it & 1) * 2 * kTile;
      }
      if (warp_live) {
        const int k0 = k_begin + it * kBK;
        const bool need_mask = k0 + kBK > k_end || k0 + kBK - 1 > min_pos ||
                               (window > 0 && k0 <= max_pos - window);
        float* pa = pbuf + r0 * (kBK + kSimtPad);
        if (need_mask)
          simt_tile<D, true>(o, m, l, qs + r0 * RS, k_tile, k_tile + kTile,
                             pa, scale, k0, k_end, pos_r, window, cg);
        else
          simt_tile<D, false>(o, m, l, qs + r0 * RS, k_tile, k_tile + kTile,
                              pa, scale, k0, k_end, pos_r, window, cg);
      }
      __syncthreads();  // the stage (and P) is refilled next iteration
    }
    cp_async_wait<0>();  // the Q copy, when no key tile was live
    __syncthreads();

    repro_attn::finish_simt_item<D>(o, m, l, out, part_o, part_ml, n_splits,
                                    split, max_splits, first, row_base,
                                    n_rows, h, hkv, g, r0, cg, lse);
    __syncthreads();  // shared memory is refilled by the next item
    item = item_next;
  }
}

// ---------------------------------------------------------------------
// the launches, shared by both variants

// The splits of each output row merged in split order
// (repro_attn::combine_row; m in log2 units for bf16, natural for fp32).
template <bool LOG2, typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_attention_combine(const int* __restrict__ tiles,
                        const float* __restrict__ part_o,
                        const float* __restrict__ part_ml,
                        T* __restrict__ out, float* __restrict__ lse,
                        int t, int hkv, int g, int d, int max_splits) {
  repro_attn::combine_row<LOG2>(tiles, part_o, part_ml, out, t, hkv, g, d,
                                max_splits, lse);
}

// The work list's shape (repro_attn::tiling) over a table of p_pages
// pages of ps.
Tiling tiling(int g, int p_pages, int ps) {
  return repro_attn::tiling(g, p_pages * ps);
}

int launch_tiles(const int* seg, const int* pos, int* tiles, int t,
                 int s_slots, int p_pages, int ps, const Tiling& s,
                 int window, cudaStream_t stream) {
  paged_attention_tiles<<<1, kPrepassThreads, 0, stream>>>(
      seg, pos, tiles, t, s_slots, p_pages * ps, s.tile_tokens, s.max_splits,
      window);
  return static_cast<int>(cudaGetLastError());
}

// A call's arguments, passed down the dtype and head-dim dispatch.
struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* seg;
  const int* pos;
  void* out;
  float* lse;
  void* work;
  int t, hkv, g, ps, s_slots, p_pages;
  float scale;
  int window;
  int* launched;
  cudaStream_t stream;
};

// The main kernel of a variant: fp32 q on the CUDA cores (SIMT) or bf16 q
// on the tensor cores, with its threads and shared bytes; `attrs` reports
// its resources, `held` the blocks the card holds at once, and `launch`
// runs it over the work list.
template <typename KT, int D, bool SIMT>
struct Main {
  using QT = std::conditional_t<SIMT, float, bf16>;
  static constexpr int kThreads = SIMT ? kSimtThreads : kMmaThreads;
  static constexpr size_t smem() {
    if constexpr (SIMT)
      return simt_smem_bytes<KT, D>();
    else
      return mma_smem_bytes<KT, D>();
  }
  static auto kernel() {
    if constexpr (SIMT)
      return paged_attention_simt<KT, D>;
    else
      return paged_attention_mma<KT, D>;
  }
  static int attrs(int* out) {
    return kernel_attrs(kernel(), smem(), kThreads, kBK, out);
  }
  // Blocks the main grid's x dimension gets: as many work items as there
  // can be, at most what the card holds at once (blocks an SM x SMs,
  // shared among the z_blocks KV heads x row blocks).  The occupancy of
  // an instantiation is asked once.
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
    const float scale = SIMT ? a.scale : a.scale * kLog2e;
    const auto k = kernel();
    k<<<grid, kThreads, smem(), a.stream>>>(
        static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pages),
        static_cast<const KT*>(a.v_pages), a.k_scale, a.v_scale, a.tables,
        a.pos, static_cast<const int*>(a.work), static_cast<QT*>(a.out),
        a.lse, part, part_ml, a.t, a.hkv, a.g, a.ps, a.p_pages, s.max_splits,
        scale, a.window);
  }
};

// the pre-pass, the main kernel and (with more than one split possible)
// the combine, on one stream
template <typename KT, int D, bool SIMT>
int launch(const Args& a) {
  using M = Main<KT, D, SIMT>;
  const Tiling s = tiling(a.g, a.p_pages, a.ps);
  int* tiles = static_cast<int*>(a.work);
  float* part = s.max_splits > 1 ? reinterpret_cast<float*>(
                                       static_cast<char*>(a.work) +
                                       worklist_bytes(a.t, s.max_splits))
                                 : nullptr;
  int err = launch_tiles(a.seg, a.pos, tiles, a.t, a.s_slots, a.p_pages,
                         a.ps, s, a.window, a.stream);
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
  paged_attention_combine<!SIMT><<<blocks, kCombineThreads, 0, a.stream>>>(
      tiles, part, part_ml, static_cast<typename M::QT*>(a.out), a.lse, a.t,
      a.hkv, a.g, D, s.max_splits);
  err = static_cast<int>(cudaGetLastError());
  if (err == 0)
    record(a.launched, 3, 1, gx * z_blocks, static_cast<int>(blocks));
  return err;
}

// what to do once the pool type and head_dim are known: launch, or report
// the attributes of the main kernel a launch would run (attrs != null).
// fp32 q takes an fp32, int8 or fp8 pool; bf16 q a bf16, int8 or fp8 one.
template <typename KT, int D>
int run(int q_dtype, const Args& a, int* attrs) {
  if (q_dtype == 0) {
    if constexpr (std::is_same<KT, bf16>::value) {
      return -2;
    } else {
      using M = Main<KT, D, true>;
      return attrs != nullptr ? M::attrs(attrs) : launch<KT, D, true>(a);
    }
  }
  if constexpr (std::is_same<KT, float>::value) {
    return -2;
  } else {
    using M = Main<KT, D, false>;
    return attrs != nullptr ? M::attrs(attrs) : launch<KT, D, false>(a);
  }
}

template <typename KT>
int dispatch_d(int q_dtype, int d, const Args& a, int* attrs) {
#define PA_CASE(DD) \
  case DD:          \
    return run<KT, DD>(q_dtype, a, attrs);
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

int dispatch(int q_dtype, int kv_dtype, int d, const Args& a, int* attrs) {
  if (q_dtype != 0 && q_dtype != 1) return -3;
  switch (kv_dtype) {
    case 0:
      return dispatch_d<float>(q_dtype, d, a, attrs);
    case 1:
      return dispatch_d<__nv_bfloat16>(q_dtype, d, a, attrs);
    case 2:
      return dispatch_d<int8_t>(q_dtype, d, a, attrs);
    case 3:
      return dispatch_d<__nv_fp8_e4m3>(q_dtype, d, a, attrs);
    default:
      return -2;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 float8_e4m3fn.  q/out
// take 0 (the "simt" main kernel on the CUDA cores; an fp32, int8 or fp8
// pool) or 1 (the "mma" main kernel on the tensor cores; a bf16, int8 or
// fp8 pool); both launch the pre-pass, the main kernel and, when a tile
// can have more than one split, the combine.  k_scale/v_scale are null
// for an unquantized pool.  lse, when not null, gets each output row's
// natural log-sum-exp of its visible scaled logits ((T, Hkv, G) fp32,
// -inf where no key is visible); a call without it writes the same out.
// window <= 0 means no window.  `work` is a
// 256-byte aligned workspace of `repro_paged_workspace_bytes` bytes.  `launched`, when not null, gets 4
// ints: the device launches made, then the thread blocks of the pre-pass,
// the main kernel and the combine.  Returns the first nonzero CUDA error
// of the launches (0 on success), -1 for an unsupported head_dim, -2 for
// an unsupported pool dtype, -3 for an unsupported q dtype.
extern "C" int repro_paged_attention(
    int q_dtype, int kv_dtype, int d, const void* q, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* tables, const void* seg, const void* pos, void* out,
    void* lse, void* work, int t, int hkv, int g, int ps, int s_slots,
    int p_pages, float scale, int window, int* launched, void* stream) {
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(tables), static_cast<const int*>(seg),
               static_cast<const int*>(pos), out, static_cast<float*>(lse),
               work, t, hkv, g, ps,
               s_slots, p_pages, scale, window, launched,
               static_cast<cudaStream_t>(stream)};
  return dispatch(q_dtype, kv_dtype, d, a, nullptr);
}

// The work list for G query heads a KV head over a table of
// p_pages pages of ps: out[0] tokens at most a tile, out[1] keys a split,
// out[2] the most splits a tile can have.
extern "C" void repro_paged_tiling(int g, int p_pages, int ps, int* out) {
  const Tiling s = tiling(g, p_pages, ps);
  out[0] = s.tile_tokens;
  out[1] = kSplitKeys;
  out[2] = s.max_splits;
}

// Bytes of the workspace for T tokens of (Hkv, G, D) over a
// table of p_pages pages of ps: the int32 work list, then, when a tile can
// have more than one split, T * Hkv * G * max_splits * (D + 2) fp32 of
// split results (none for hkv = 0: the work list alone).
extern "C" long long repro_paged_workspace_bytes(int t, int hkv, int g, int d,
                                                 int p_pages, int ps) {
  return static_cast<long long>(
      repro_attn::workspace_bytes(t, hkv, g, d, p_pages * ps));
}

// The pre-pass alone: writes the work list for G query heads a
// KV head into `tiles` (a workspace of at least
// `repro_paged_workspace_bytes(t, 0, g, 0, p_pages, ps)` bytes), as
// `repro_paged_attention` does before its main kernel.  Returns the CUDA
// error of the launch.
extern "C" int repro_paged_tiles(const void* seg, const void* pos,
                                 void* tiles, int t, int s_slots, int p_pages,
                                 int ps, int g, int window, void* stream) {
  return launch_tiles(static_cast<const int*>(seg),
                      static_cast<const int*>(pos), static_cast<int*>(tiles),
                      t, s_slots, p_pages, ps, tiling(g, p_pages, ps), window,
                      static_cast<cudaStream_t>(stream));
}

// The resources of the main kernel that `repro_paged_attention` launches
// for (q dtype, pool dtype, d): out[0] registers a thread, out[1] local
// (spill) bytes a thread, out[2] dynamic shared bytes a block, out[3]
// blocks an SM can hold, out[4] threads a block, out[5] keys a tile.
// Returns as `repro_paged_attention` does.
extern "C" int repro_paged_attention_attrs(int q_dtype, int kv_dtype, int d,
                                           int* out) {
  return dispatch(q_dtype, kv_dtype, d, Args{}, out);
}
