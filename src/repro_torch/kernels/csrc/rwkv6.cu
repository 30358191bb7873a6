// WKV6 recurrence (RWKV-6 "Finch" time mix), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_rwkv6_kernel` / `rwkv6_scan_fwd` of
// repro/kernels/rwkv6.py and computes the function of the reference's
// lax.scan oracles `_wkv6_ref` and `_wkv6_ref_with_state`
// (repro/models/layers.py): per (batch, head) pair (b, h), a (D, D) fp32
// state S starts at state0[b, h] (zeros when state0 is null) and for
// t = 0..S-1
//
//     out[t, j] = sum_i r[t, i] * (S[i, j] + u[i] * k[t, i] * v[t, j])
//     S[i, j]  <- w[t, i] * S[i, j] + k[t, i] * v[t, j]
//
// with u the head's bonus.  The bonus term is a per-step scalar times
// v[t, j], so the kernel computes
//
//     out[t, j] = sum_i r[t, i] S[i, j] + v[t, j] * sum_i r[t, i] u[i] k[t, i]
//
// r/k/v/w are (B, H, S, D) views with a unit last stride and one set of
// (b, h, t) strides between them (the layer passes transposed views of
// its (B, S, H*D) projections, so nothing is copied into a head-major
// layout), fp32 or bf16, read as fp32; every row and base pointer is
// 16-byte aligned (the wrapper copies operands that are not); u is (H, D)
// fp32; the states are contiguous (B, H, D, D) fp32; out has its own
// (b, h, t) strides, 16-byte aligned rows, in the input type, rounded
// once from the fp32 sum.
//
// What bounds it on the H100: operations, and on this serial form the
// issue of each step's instructions.  Each step costs 5 fp32 operations
// per state element in 3 instructions (the r FMA, k*v, the decay FMA);
// the bonus scalar is O(D) a step.  The rwkv6-1.6b prefill row (B=4,
// H=32, S=1024, D=64) needs 2.7 GFLOP against 86 MB: 0.040 ms at the
// 67 TFLOP/s fp32 peak against 0.026 ms at 3.35 TB/s (the state math is
// fp32 whatever the input type).  The steps of one (b, h) are serial,
// and B*H = 128 blocks is about one per SM, so a step's D*D elements are
// spread over a whole SM: 3 instructions x 4096 elements over 128 lanes
// is 96 cycles a step.  Every element also needs r_i, k_i and w_i (its
// row's) and v_j (its column's) from shared memory, a thread holding NC
// columns x R rows loads 3R + NC floats for NC*R elements, and the
// column sums are reduced across the threads that share a column.  Held
// one column a thread (512 threads, R = 8), the loads and a reduction
// each step put ~500 cycles on a step on an H100; four columns a thread
// and reductions shared by a batch of steps take ~75 instructions a
// thread a step (48 of them fp32), ~150 cycles of issue for the 8 warps
// of an SM, and the step runs in about 1.7 times that.  A decode step
// (S = 1, from a state) is bound by bytes instead: the state's D*D fp32
// in and out, 32 KB a (b, h) at D = 64.
//
// Design:
//   * one block per (b, h) of (D/NC) x P threads: NC = 4 columns and
//     P = 16 parts a column, R = D/P rows a part (256 threads at D = 64,
//     512 at D = 128); thread (g, p) = threadIdx.x / P, % P holds rows
//     [p*R, (p+1)*R) of columns [g*NC, (g+1)*NC) of the state in
//     registers for the whole sweep.  state0 comes in and the final state
//     goes out through shared memory, a warp moving 512 contiguous bytes
//     of them at a time: 16-byte accesses straight from the registers
//     touch one 32-byte sector of each of 16 rows, four times the
//     requests, and a decode step took 2.5 times as long with them;
//   * the P parts of a column group sit in adjacent lanes.  The steps run
//     in batches of U = P/NC (one at D = 128), and a batch's U x NC
//     partial sums a thread are reduced over the P lanes by a fixed
//     __shfl_xor reduce-scatter: log2(U*NC) rounds, each halving the sums
//     a lane keeps, then plain butterfly rounds over the remaining lanes,
//     leave each lane p < U*NC with one (step, column) output, which it
//     stores (a chunk's last steps short of a batch run one at a time).
//     The same bits on every run; and a batch's shuffles are shared by U
//     steps: reduced a step at a time, their latency made each step ~1.6
//     times as long;
//   * steps are staged by cp.async a chunk of kChunk at a time: the r, k,
//     v and w rows of the next chunk are copied as 16-byte pieces, in the
//     input type, while the current chunk's steps run.  When a chunk has
//     landed, one warp a step converts its rows to fp32 into the working
//     buffers and reduces the step's bonus scalar there, and stores v_j
//     and v_j * bonus;
//   * a thread reads its R rows of r, k and w for a step as 16-byte
//     shared loads (8-byte at R = 2) and its NC values of v as one, a
//     step ahead of their use.
//     Threads with equal p read the same address (a broadcast), and the
//     working rows are interleaved so that the P distinct addresses of
//     one load are P consecutive pieces: distinct banks;
//   * each step's output is written, rounded once, into a chunk tile in
//     shared memory, which leaves as coalesced 16-byte stores when the
//     next chunk starts;
//   * two barriers per chunk, none per step;
//   * a single step (S = 1: every decode step) keeps no state across
//     steps, so it skips the staging, the working rows, the batches and
//     the state's way through shared memory: the threads take the state
//     in its memory order, a warp reading and writing 512 contiguous
//     bytes straight from and to global memory, read r, k, w and v from
//     global memory, and only the column sums cross threads (a shuffle
//     tree, then one barrier and a fixed sum over the warps).
//
// Measured against the other layouts at D = 64 on an H100, prefill row:
// one column a thread (8 parts, 512 threads) and eight columns a thread
// (16 parts, 128 threads) both ran slower than four (PERF.md §6).
//
// What is left: the loads, shuffles and loop take a third of the issue
// slots, two warps a scheduler hide their latency only in part, and a
// block's steps are one serial chain.  The chunked
// form (intra-chunk products on the tensor cores, the state carried
// between chunks) would cut both, but it divides by products of decays
// that underflow in fp32 within a chunk and runs in TF32, short of the
// fp32 tier.
//
// TPU-isms of the Pallas kernel that do not carry over:
//   * 128-lane padding of D, with w padded with ones (repro/kernels/ops.py
//     `_rwkv6_impl`): D is a template parameter (32, 64, 128), nothing is
//     padded;
//   * the sequential chunk grid dimension with the state in VMEM scratch
//     and its tail guard for a partial last chunk: one block sweeps exactly
//     S steps in a loop, the last chunk staged to its true length;
//   * u broadcast to (B*H, D) by the wrapper: the block reads its head's row
//     of the (H, D) bonus;
//   * the (B*H, S, D) relayout of the inputs: the kernel reads the
//     projections through their strides;
//   * no initial-state input (so the reference ran decode through the jnp
//     oracle): state0 is an optional input here, and decode uses it.

#include <type_traits>

#include "attention_tiles.cuh"

namespace {

using repro_attn::cp_async16;
using repro_attn::cp_async_commit;
using repro_attn::cp_async_wait;
using repro_attn::smem_u32;
using repro_attn::store;
using repro_attn::to_f;

constexpr int kChunk = 32;   // steps staged in shared memory at a time
constexpr int kCols = 4;     // NC: state columns a thread holds
constexpr int kParts = 16;   // P: threads a column group is spread over

// (b, h, t) element strides of a (B, H, S, D) view; the last stride is 1
struct Strides {
  long long b, h, t;
};

// The block of one head size: (D/NC) x P threads, R = D/P state rows and
// NC columns a thread, V rows a shared load, and the dynamic shared
// memory: the staged rows in the input type ([4][kChunk][D]: r, k, v, w),
// the working rows in fp32 (r, k, w interleaved, v, v * bonus; [kChunk][D]
// each) and the output tile ([kChunk][D], input type).
template <typename T, int D>
struct Shape {
  static constexpr int NC = kCols, P = kParts;
  static_assert(D % P == 0 && D / P >= 2, "a part holds two rows or more");
  static constexpr int kThreads = D / NC * P;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRows = D / P;
  static constexpr int kVec = kRows < 4 ? kRows : 4;
  static constexpr int kPiece = 16 / static_cast<int>(sizeof(T));
  static constexpr int kRawBytes = 4 * kChunk * D * sizeof(T);
  static constexpr int kWorkBytes = 5 * kChunk * D * 4;
  static constexpr int kOutBytes = kChunk * D * sizeof(T);
  static constexpr int kSmem = kRawBytes + kWorkBytes + kOutBytes;
  // blocks of up to 256 threads: two an SM at most 128 registers each
  static constexpr int kMinBlocks = kThreads <= 256 ? 2 : 1;
  // steps whose partial sums are reduced together (NC of them a step): as
  // many as the column group has parts; one at 8 rows a thread, whose
  // state leaves no registers for more
  static constexpr int kBatch = kRows <= 4 ? P / NC : 1;
};

// Where element i of a step's row sits in its working row: the rows a
// thread reads in one load of V are V consecutive floats, and the P
// threads of a column group read P consecutive V-float pieces.
template <int D>
__device__ __forceinline__ int work_pos(int i) {
  constexpr int R = D / kParts, V = R < 4 ? R : 4;
  const int p = i / R, rem = i % R;
  return (rem / V) * (kParts * V) + p * V + rem % V;
}

// Where element (i, j) of the staged state sits: row-major, its 16-byte
// pieces XOR-swizzled by the part that holds row i, so that the threads of
// a quarter warp, which read one piece each of 8 rows of 8 parts, read 8
// distinct groups of 4 banks.
template <int D>
__device__ __forceinline__ int state_at(int i, int j) {
  return i * D + ((((j / 4) ^ (i / (D / kParts) % 8))) * 4) + j % 4;
}

// N consecutive floats of shared memory, 16 (or 8) bytes a load
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + q);
      o[q] = x.x; o[q + 1] = x.y; o[q + 2] = x.z; o[q + 3] = x.w;
    }
  } else {
    static_assert(N == 2, "N is 2 or a multiple of 4");
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  }
}

// The N partial sums of each of N adjacent lanes reduced over those
// lanes, one sum left in a[0] of each lane: in round n = N, N/2, ..., 2
// (lane offset N/n) the lanes whose offset bit is set keep the upper half
// of their n sums, the others the lower half, and each adds its partner's
// sums of the half it keeps.  A lane ends with sum number
// reduced_index<N>(lane).
template <int N, int n = N>
__device__ __forceinline__ void reduce_scatter(float (&a)[N], int lane) {
  if constexpr (n > 1) {
    const int off = N / n;
    const bool upper = lane & off;
#pragma unroll
    for (int c = 0; c < n / 2; ++c) {
      const float keep = upper ? a[c + n / 2] : a[c];
      const float send = upper ? a[c] : a[c + n / 2];
      a[c] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    reduce_scatter<N, n / 2>(a, lane);
  }
}

template <int N>
__device__ __forceinline__ int reduced_index(int lane) {
  int idx = 0;
#pragma unroll
  for (int n = N, off = 1; n > 1; n /= 2, off *= 2)
    if (lane & off) idx += n / 2;
  return idx;
}

// One thread's operands of a step: its R rows of r, k and w, and v at its
// NC columns.
template <int R>
struct StepRows {
  float r[R], k[R], w[R], v[kCols];
};

// A single step of one (b, h) (S = 1), with the state in its memory
// order: 16-byte piece x = tid + q * kThreads of the state is row
// x / (D/4), columns 4 * (x % (D/4)) + 0..3, so a thread holds 4 columns
// of D/16 rows, 16 rows apart, and a warp moves 512 contiguous bytes a
// piece.  The threads that share 4 columns are the lanes that differ
// above bit log2(D/4) and the same lanes of every warp: a shuffle tree,
// then the warps' sums in `red` ([kWarps][D] floats) added in warp order.
// Every warp reduces the bonus scalar for itself.
template <typename T, int D>
__device__ __forceinline__ void single_step(
    const T* r, const T* k, const T* v, const T* w, const float* u,
    const float* state0, T* out, float* state_out, float* red) {
  using L = Shape<T, D>;
  constexpr int Q = D * D / 4 / L::kThreads;       // pieces a thread
  constexpr int kGroups = D / 4;                   // 4-column groups
  constexpr int kRowStride = L::kThreads / kGroups;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i0 = tid / kGroups, j = 4 * (tid % kGroups);

  float4 st[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q)
    st[q] = state0 != nullptr
                ? reinterpret_cast<const float4*>(state0)[tid + q * L::kThreads]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  float ri[Q], ki[Q], wi[Q], vj[4];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = i0 + q * kRowStride;
    ri[q] = to_f(r[i]);
    ki[q] = to_f(k[i]);
    wi[q] = to_f(w[i]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) vj[c] = to_f(v[j + c]);
  float bonus = 0.f;
#pragma unroll
  for (int m = 0; m < D / 32; ++m) {
    const int i = lane + 32 * m;
    bonus += to_f(r[i]) * u[i] * to_f(k[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    bonus += __shfl_xor_sync(0xffffffffu, bonus, off);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float sq[4] = {st[q].x, st[q].y, st[q].z, st[q].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c] = fmaf(ri[q], sq[c], acc[c]);
      sq[c] = fmaf(wi[q], sq[c], ki[q] * vj[c]);
    }
    reinterpret_cast<float4*>(state_out)[tid + q * L::kThreads] =
        make_float4(sq[0], sq[1], sq[2], sq[3]);
  }
#pragma unroll
  for (int off = kGroups; off < 32; off *= 2) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  if (lane < kGroups)
    *reinterpret_cast<float4*>(red + warp * D + j) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (tid < D) {
    float sum = 0.f;
#pragma unroll
    for (int x = 0; x < L::kWarps; ++x) sum += red[x * D + tid];
    store(out + tid, sum + to_f(v[tid]) * bonus);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Shape<T, D>::kThreads,
                                  Shape<T, D>::kMinBlocks)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             Strides in,
             const float* __restrict__ u,        // (H, D)
             const float* __restrict__ state0,   // (B, H, D, D) or null
             T* __restrict__ out, Strides os,    // (B, H, S, D) view
             float* __restrict__ state_out,      // (B, H, D, D)
             int h, int s) {
  using L = Shape<T, D>;
  constexpr int C = kChunk, NC = L::NC, P = L::P;
  constexpr int R = L::kRows, V = L::kVec, U = L::kBatch;
  constexpr int kConv = (C + L::kWarps - 1) / L::kWarps;  // steps a warp
  constexpr int kStatePieces = D * D / 4 / L::kThreads;  // 16 B a thread
  constexpr int kRowPieces = D / L::kPiece;   // 16-byte pieces a row
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem);
  float* wr = reinterpret_cast<float*>(smem + L::kRawBytes);
  float* wk = wr + C * D;
  float* ww = wk + C * D;
  float* wv = ww + C * D;
  float* wvb = wv + C * D;   // v_j * bonus
  T* tile = reinterpret_cast<T*>(smem + L::kRawBytes + L::kWorkBytes);
  static_assert(L::kWorkBytes >= D * D * 4 && D * D / 4 % L::kThreads == 0,
                "the state passes through `ss` in whole rounds");

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = tid / P, p = tid % P;
  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const long long ib = bi * in.b + hi * in.h;
  const long long ob = bi * os.b + hi * os.h;
  float* ss = wr;   // the state's way in and out, D*D floats
  const size_t sb = static_cast<size_t>(bh) * D * D;

  if (s == 1) {
    single_step<T, D>(r + ib, k + ib, v + ib, w + ib, u + hi * D,
                      state0 == nullptr ? nullptr : state0 + sb, out + ob,
                      state_out + sb, wr);
    return;
  }

  // the rows of steps t0..min(t0+C, s)-1 into `raw`, as one group
  auto stage = [&](int t0) {
    const T* src[4] = {r + ib, k + ib, v + ib, w + ib};
    const int pieces = min(C, s - t0) * kRowPieces;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      for (int x = tid; x < pieces; x += L::kThreads) {
        const int c = x / kRowPieces, q = x % kRowPieces;
        cp_async16(smem_u32(raw + (a * C + c) * D + q * L::kPiece),
                   src[a] + (t0 + c) * in.t + q * L::kPiece, true);
      }
    }
    cp_async_commit();
  };
  // this thread's operands of step c of the chunk
  auto load_step = [&](int c, StepRows<R>& o) {
    const int step = c * D;
    load_vec<NC>(wv + step + g * NC, o.v);
#pragma unroll
    for (int gq = 0; gq < R / V; ++gq) {
      const int at = step + gq * P * V + p * V;
      load_vec<V>(wr + at, o.r + gq * V);
      load_vec<V>(wk + at, o.k + gq * V);
      load_vec<V>(ww + at, o.w + gq * V);
    }
  };
  // the output tile of steps t0..t0+n-1, as 16-byte stores
  auto write_tile = [&](int t0, int n) {
    for (int x = tid; x < n * kRowPieces; x += L::kThreads) {
      const int c = x / kRowPieces, q = x % kRowPieces;
      *reinterpret_cast<uint4*>(out + ob + (t0 + c) * os.t + q * L::kPiece) =
          *reinterpret_cast<const uint4*>(tile + c * D + q * L::kPiece);
    }
  };

  float ur[D / 32];   // u at the elements this lane converts
#pragma unroll
  for (int m = 0; m < D / 32; ++m) ur[m] = u[hi * D + lane + 32 * m];

  float st[R][NC];
  if (state0 != nullptr) {
    // every load in flight before the first store into `ss`
    const float4* g4 = reinterpret_cast<const float4*>(state0 + sb);
    float4 in4[kStatePieces];
#pragma unroll
    for (int q = 0; q < kStatePieces; ++q) in4[q] = g4[tid + q * L::kThreads];
#pragma unroll
    for (int q = 0; q < kStatePieces; ++q) {
      const int x = tid + q * L::kThreads;
      *reinterpret_cast<float4*>(
          ss + state_at<D>(x / (D / 4), 4 * (x % (D / 4)))) = in4[q];
    }
    __syncthreads();
    if (s > 0) stage(0);
#pragma unroll
    for (int q = 0; q < R; ++q)
      load_vec<NC>(ss + state_at<D>(p * R + q, g * NC), st[q]);
  } else {
    if (s > 0) stage(0);
#pragma unroll
    for (int q = 0; q < R; ++q) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) st[q][cc] = 0.f;
    }
  }

  for (int t0 = 0; t0 < s; t0 += C) {
    const int n = min(C, s - t0);
    cp_async_wait<0>();
    __syncthreads();   // this chunk landed; the last one's steps are done
    if (t0 > 0) write_tile(t0 - C, C);
    // one warp a step (kConv steps a warp, loaded and reduced together):
    // fp32 working rows, and the step's bonus scalar
    float cr[kConv][D / 32], ck[kConv][D / 32], cw[kConv][D / 32],
        cv[kConv][D / 32], part[kConv];
#pragma unroll
    for (int q = 0; q < kConv; ++q) {
      const int c = warp + q * L::kWarps;
      part[q] = 0.f;
#pragma unroll
      for (int m = 0; m < D / 32; ++m) {
        const int i = c * D + lane + 32 * m;
        const bool live = c < n;
        cr[q][m] = live ? to_f(raw[i]) : 0.f;
        ck[q][m] = live ? to_f(raw[C * D + i]) : 0.f;
        cv[q][m] = live ? to_f(raw[2 * C * D + i]) : 0.f;
        cw[q][m] = live ? to_f(raw[3 * C * D + i]) : 0.f;
        part[q] += cr[q][m] * ur[m] * ck[q][m];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
#pragma unroll
      for (int q = 0; q < kConv; ++q)
        part[q] += __shfl_xor_sync(0xffffffffu, part[q], off);
    }
#pragma unroll
    for (int q = 0; q < kConv; ++q) {
      const int c = warp + q * L::kWarps;
      if (c < n) {
#pragma unroll
        for (int m = 0; m < D / 32; ++m) {
          const int i = lane + 32 * m;
          const int pos = c * D + work_pos<D>(i);
          wr[pos] = cr[q][m];
          wk[pos] = ck[q][m];
          ww[pos] = cw[q][m];
          wv[c * D + i] = cv[q][m];
          wvb[c * D + i] = cv[q][m] * part[q];
        }
      }
    }
    __syncthreads();   // working rows ready; `raw` is free again
    if (t0 + C < s) stage(t0 + C);

    // a step's operands are loaded one step ahead of their use, so their
    // shared-memory latency hides behind the step before
    StepRows<R> cur;
    load_step(0, cur);
    // one step: the state update, and its NC partial sums into acc
    auto step = [&](StepRows<R>& next, int ahead, float* acc) {
      load_step(min(ahead, C - 1), next);
#pragma unroll
      for (int x = 0; x < R; ++x) {
        float (&row)[NC] = st[x];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          acc[cc] = fmaf(cur.r[x], row[cc], acc[cc]);
          row[cc] = fmaf(cur.w[x], row[cc], cur.k[x] * cur.v[cc]);
        }
      }
      cur = next;
    };
    // B steps, their B x NC sums reduced together: lane p < B*NC of a
    // column group ends with one (step, column) output and stores it
    auto batch = [&](auto steps, int c) {
      constexpr int B = decltype(steps)::value, NB = B * NC;
      float acc[NB];
#pragma unroll
      for (int x = 0; x < NB; ++x) acc[x] = 0.f;
#pragma unroll
      for (int uu = 0; uu < B; ++uu) {
        StepRows<R> next;
        step(next, c + uu + 1, acc + uu * NC);
      }
      reduce_scatter<NB>(acc, lane);
#pragma unroll
      for (int off = NB; off < P; off *= 2)
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
      const int red = reduced_index<NB>(lane);
      const int at = (c + red / NC) * D + g * NC + red % NC;
      if (p < NB) store(tile + at, acc[0] + wvb[at]);
    };
    int c = 0;
    for (; c + U <= n; c += U) batch(std::integral_constant<int, U>(), c);
    // the chunk's last steps short of a batch
    for (; c < n; ++c) batch(std::integral_constant<int, 1>(), c);
  }

  __syncthreads();   // every step is done: the working rows are free
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const float* o = st[q];
    *reinterpret_cast<float4*>(ss + state_at<D>(p * R + q, g * NC)) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();
  if (s > 0) {
    const int t0 = (s - 1) / C * C;
    write_tile(t0, s - t0);
  }
  float4* g4 = reinterpret_cast<float4*>(state_out + sb);
#pragma unroll
  for (int q = 0; q < kStatePieces; ++q) {
    const int x = tid + q * L::kThreads;
    g4[x] = *reinterpret_cast<const float4*>(
        ss + state_at<D>(x / (D / 4), 4 * (x % (D / 4))));
  }
}

// A call's arguments, passed down the dtype and shape dispatch.
struct Args {
  const void *r, *k, *v, *w;
  Strides in;
  const float* u;
  const float* state0;
  void* out;
  Strides os;
  float* state_out;
  int bh, h, s;
  cudaStream_t stream;
};

struct Launch {
  const Args& a;
  template <typename T, int D>
  int run() const {
    using L = Shape<T, D>;
    cudaError_t err = repro_attn::allow_smem(rwkv6_kernel<T, D>, L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    rwkv6_kernel<T, D><<<a.bh, L::kThreads, L::kSmem, a.stream>>>(
        static_cast<const T*>(a.r), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.w), a.in, a.u,
        a.state0, static_cast<T*>(a.out), a.os, a.state_out, a.h, a.s);
    return static_cast<int>(cudaGetLastError());
  }
};

// repro_attn::kernel_attrs (registers, local (spill) bytes, dynamic
// shared bytes, blocks an SM, threads, and here the steps a chunk), then
// the columns NC and parts P a thread's share of the state spans
struct Attrs {
  int* out;
  template <typename T, int D>
  int run() const {
    using L = Shape<T, D>;
    const int err = repro_attn::kernel_attrs(rwkv6_kernel<T, D>, L::kSmem,
                                             L::kThreads, kChunk, out);
    out[6] = L::NC;
    out[7] = L::P;
    return err;
  }
};

// dtype codes: 0 float32, 1 bfloat16; -1 for another head size, -3 for
// another dtype
template <typename T, typename Op>
int by_shape(int d, const Op& op) {
  switch (d) {
    case 32: return op.template run<T, 32>();
    case 64: return op.template run<T, 64>();
    case 128: return op.template run<T, 128>();
    default: return -1;
  }
}

template <typename Op>
int by_type(int dtype, int d, const Op& op) {
  if (dtype == 0) return by_shape<float>(d, op);
  if (dtype == 1) return by_shape<__nv_bfloat16>(d, op);
  return -3;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (r, k, v, w and out share it); u,
// state0 and state_out are float32; state0 may be null (zero initial
// state).  in_b/in_h/in_t are the (b, h, t) element strides shared by r,
// k, v and w; out_b/out_h/out_t those of out.  Returns the CUDA error of
// the launch (0 on success), -1 for an unsupported head size, -3 for an
// unsupported dtype.
extern "C" int repro_rwkv6_scan(int dtype, int d, const void* r,
                                const void* k, const void* v, const void* w,
                                long long in_b, long long in_h,
                                long long in_t, const void* u,
                                const void* state0, void* out,
                                long long out_b, long long out_h,
                                long long out_t, void* state_out, int b,
                                int h, int s, void* stream) {
  const Args a{r, k, v, w, Strides{in_b, in_h, in_t},
               static_cast<const float*>(u),
               static_cast<const float*>(state0), out,
               Strides{out_b, out_h, out_t},
               static_cast<float*>(state_out), b * h, h, s,
               static_cast<cudaStream_t>(stream)};
  return by_type(dtype, d, Launch{a});
}

// The resources of the kernel a call with (dtype, d) launches, into
// out[8] (see Attrs).  Returns 0, a CUDA error, or -1/-3 as above.
extern "C" int repro_rwkv6_attrs(int dtype, int d, int* out) {
  return by_type(dtype, d, Attrs{out});
}
