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
// read by one block.
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
// fp32 caches, under fp32 or bf16 q: CUDA cores ("simt", the first
// design; one launch a call).  fp32 is the parity path, held to 1e-5,
// which TF32 alone misses (3xTF32 on the tensor cores would hold it, as
// the fp32 flash kernel shows; not done here yet); the fp32 caches that
// `gather` makes from an int8/fp8 pool are code x scale, not bf16 values,
// so rounding them to bf16 would change the function.
//   * one block of 8 warps per (token, kv head, chunk of up to 8 query
//     heads); the block holds the chunk's query heads, so each key is read
//     once for all of them;
//   * the block loops over the token's LIVE keys only,
//     [max(0, pos - window + 1), min(pos, L - 1)], never over L.  The keys
//     are cut into 32-key tiles dealt round-robin to the warps; in a tile
//     each lane scores one key against all heads of the chunk (16-byte
//     loads of its key row), the warp runs the online softmax with
//     shuffles, and each lane accumulates D/32 output columns of every head
//     in registers, reading V rows coalesced;
//   * the warps' partial (m, l, acc) are merged in shared memory at the
//     end.  The tokens of one slot re-read its keys, each from its own
//     block.
//
// TPU-isms of the Pallas kernel that do not carry over:
//   * lane padding of head_dim to 128 (`_pad_last`, repro/kernels/ops.py:37):
//     head_dim is a template parameter (16-256), nothing is padded or copied;
//   * the (G, 128) VMEM scratch for m and l: registers of each warp;
//   * the sequential grid over L / block_k tiles that carries the softmax
//     state, with dead tiles masked: split-KV over the live keys only,
//     splits that run in parallel and a combine that merges them (mma), or
//     a loop over a token's live keys (simt);
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
using repro_attn::kLog2e;
using repro_attn::kMmaThreads;
using repro_attn::kNegInf;
using repro_attn::kPrepassThreads;
using repro_attn::kRows;
using repro_attn::kSplitKeys;
using repro_attn::kTileFields;
using repro_attn::kernel_attrs;
using repro_attn::load8;
using repro_attn::mma_tile;
using repro_attn::record;
using repro_attn::round_to;
using repro_attn::smem_u32;
using repro_attn::store;
using repro_attn::Tiling;
using repro_attn::to_f;
using repro_attn::warp_max;
using repro_attn::warp_sum;
using repro_attn::worklist_bytes;

// ---------------------------------------------------------------------
// fp32 caches on the CUDA cores ("simt")

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

// ---------------------------------------------------------------------
// bf16 q over bf16 caches on the tensor cores ("mma")

using bf16 = __nv_bfloat16;

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

// The splits of each output row merged in split order
// (repro_attn::combine_row).
__global__ void __launch_bounds__(kCombineThreads)
mixed_attention_combine(const int* __restrict__ tiles,
                        const float* __restrict__ part_o,
                        const float* __restrict__ part_ml,
                        bf16* __restrict__ out, int t, int hkv, int g,
                        int d, int max_splits) {
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

// Blocks the main grid's x dimension gets: as many work items as there
// can be, at most what the card holds at once, shared among the z_blocks
// KV heads x row blocks.  The occupancy of an instantiation is asked once.
template <int D>
int grid_x(size_t smem, int max_items, int z_blocks, int* out) {
  static int held = 0;
  if (held == 0) {
    const int err = repro_attn::card_blocks(mixed_attention_mma<D>,
                                            kMmaThreads, smem, &held);
    if (err != 0) return err;
  }
  *out = max(1, min(max_items, held / z_blocks));
  return 0;
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

// the pre-pass, the main kernel and (with more than one split possible)
// the combine, on one stream
template <int D>
int launch_mma(const Args& a) {
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
  constexpr size_t smem = mma_smem_bytes<D>();
  auto kernel = mixed_attention_mma<D>;
  err = static_cast<int>(allow_smem(kernel, smem));
  if (err != 0) return err;
  const int z_blocks = a.hkv * s.row_blocks;
  int gx = 0;
  err = grid_x<D>(smem, a.t * s.max_splits, z_blocks, &gx);
  if (err != 0) return err;
  float* part_ml =
      part == nullptr
          ? nullptr
          : part + static_cast<size_t>(a.t) * a.hkv * a.g * s.max_splits * D;
  kernel<<<dim3(gx, 1, z_blocks), kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k_cache),
      static_cast<const bf16*>(a.v_cache), a.positions, tiles,
      static_cast<bf16*>(a.out), part, part_ml, a.t, a.hkv, a.g, a.seq_len,
      s.max_splits, a.scale * kLog2e, a.window);
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
  mixed_attention_combine<<<blocks, kCombineThreads, 0, a.stream>>>(
      tiles, part, part_ml, static_cast<bf16*>(a.out), a.t, a.hkv, a.g, D,
      s.max_splits);
  err = static_cast<int>(cudaGetLastError());
  if (err == 0)
    record(a.launched, 3, 1, gx * z_blocks, static_cast<int>(blocks));
  return err;
}

template <typename TQ, typename TKV, int D>
int launch_simt(const Args& a) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = mixed_attention_kernel<TQ, TKV, D>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.t, a.hkv, (a.g + kGC - 1) / kGC);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_cache),
      static_cast<const TKV*>(a.v_cache), a.seg_ids, a.positions,
      static_cast<TQ*>(a.out), a.hkv, a.g, a.n_slots, a.seq_len, a.scale,
      a.window);
  const int e = static_cast<int>(cudaGetLastError());
  if (e == 0) record(a.launched, 1, 0, grid.x * grid.y * grid.z, 0);
  return e;
}

// what to do once the pair and head_dim are known: launch, or report the
// attributes of the kernel a launch would run (attrs != null)
template <typename TQ, typename TKV, int D>
int run(const Args& a, int* attrs) {
  if constexpr (std::is_same<TKV, bf16>::value) {
    if (attrs != nullptr)
      return kernel_attrs(mixed_attention_mma<D>, mma_smem_bytes<D>(),
                          kMmaThreads, kBK, attrs);
    return launch_mma<D>(a);
  } else {
    if (attrs != nullptr)
      return kernel_attrs(mixed_attention_kernel<TQ, TKV, D>,
                          sizeof(float) * smem_floats<D>(), kThreads, 32,
                          attrs);
    return launch_simt<TQ, TKV, D>(a);
  }
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
// "mma" path (the pre-pass, the main kernel and, when a tile can have more
// than one split, the combine); (0, 0) and (1, 0) (bf16 queries over the
// fp32 caches that a gather from an int8/fp8 pool gives) the "simt"
// kernel, one launch.  out has q's type.  seg_ids and positions are (T,)
// int32; window <= 0 means no window.  The mma path also takes `work`, a
// 256-byte aligned workspace of `repro_mixed_workspace_bytes` bytes.
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

// The mma path's work list for G query heads a KV head over caches of L
// keys a slot: out[0] tokens at most a tile, out[1] keys a split, out[2]
// the most splits a tile can have.
extern "C" void repro_mixed_tiling(int g, int seq_len, int* out) {
  const Tiling s = repro_attn::tiling(g, seq_len);
  out[0] = s.tile_tokens;
  out[1] = kSplitKeys;
  out[2] = s.max_splits;
}

// Bytes of the mma path's workspace for T tokens of (Hkv, G, D) over
// caches of L keys a slot: the int32 work list, then, when a tile can have
// more than one split, T * Hkv * G * max_splits * (D + 2) fp32 of split
// results (none for hkv = 0: the work list alone).
extern "C" long long repro_mixed_workspace_bytes(int t, int hkv, int g,
                                                 int d, int seq_len) {
  return static_cast<long long>(
      repro_attn::workspace_bytes(t, hkv, g, d, seq_len));
}

// The pre-pass alone: writes the mma path's work list for G query heads a
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
