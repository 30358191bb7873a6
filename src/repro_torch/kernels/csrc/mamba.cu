// Mamba selective scan, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_mamba_kernel` / `mamba_scan_fwd` of
// repro/kernels/mamba.py and computes the function of the reference's
// step loop `_ssm_scan_ref` (repro/models/layers.py): per (batch, channel)
// pair (b, d), an N-vector fp32 state h starts at h0[b, d] (zeros when h0
// is null) and for t = 0..S-1
//
//     h[n]    <- exp(dt[t] * A[d, n]) * h[n] + (dt[t] * x[t]) * B[t, n]
//     y[t]     = sum_n h[n] * C[t, n] + D[d] * x[t]
//
// with x, dt the (b, t, d) inputs and B, C the (b, t, :) rows that every
// channel of the row shares.  All of it is fp32 whatever the input type;
// y is rounded once to the input type, as the Pallas kernel rounds
// `y + d_vec * x_t` (repro/kernels/mamba.py:49).  The final state is
// written to h_out, so the layer's decode step runs this kernel with S = 1
// from its cached state.
//
// Operands: x and dt share one set of (b, t) element strides with a unit
// channel stride; B and C have their own (b, t) strides and a unit state
// stride, so the layer's column slices of its (B, S, R + 2N) projection
// are read in place; A is (Di, N) fp32, D (Di,) fp32, h0 and h_out
// contiguous (B, Di, N) fp32, y a contiguous (B, S, Di) tensor.  For
// S > 1 every row of x, dt, B and C, and their base pointers, are 16-byte
// aligned, and x's rows hold whole 16-byte pieces (the wrapper copies
// operands that are not so); A and h0 are 16-byte aligned.
//
// What bounds it on the H100.  At the jamba-1.5-large prefill row (B=4,
// S=1024, Di=16384, N=16, bf16) x and dt in and y out are 403 MB, 0.120 ms
// at 3.35 TB/s, against 7 fp32 operations a state element a step (7.5
// GFLOP, 0.112 ms at 67 TFLOP/s); its one exponential a state element a
// step is a further floor of 0.26 ms on the SFUs (16 a clock an SM at
// 1.98 GHz).  In practice the issue of each step's instructions sets the
// pace: a state element needs 4 fp32 instructions and 1 MUFU at the least
// (dt * A, the exponential, (dt * x) * B, the state FMA, C's FMA), and a
// kernel reaches the SFU floor only if little else is issued beside them.
// Measured on an H100 (PERF.md §6): a build whose exponential was taken
// out ran only 6% faster, and spreading a channel's 16 states over 4
// lanes (4 a lane, at most 64 registers) ran 0.49 ms, against 0.38 ms for
// one thread a channel, whose steps need no shuffles and load each B and
// C value once for 16 states.  The first kernel (one thread a channel, an
// exact expf, x and dt prefetched in registers, 167 registers, 12 warps
// an SM) took 0.94 ms.
//
// Design:
//   * one thread per (b, channel) holds the channel's N states and its row
//     of A (times log2 e) in registers for the whole sweep; a block is
//     kCh = 128 channels of one batch row, the grid (ceil(Di / 128), B),
//     at most 128 registers a thread, so 4 blocks an SM (16 warps): the
//     prefill row's 512 blocks fill 0.97 of one wave;
//   * bf16 rows take the exponential as `ex2.approx.ftz` of dt * A * log2 e
//     (one FMUL, one MUFU; relative error about 2^-22); fp32 rows take an
//     exact expf: the approximate one left the fp32 row at 0.62 of its
//     1e-5 tier, no margin;
//   * operands are staged through shared memory a chunk of kChunk = 16
//     steps ahead: x and dt for the block's channels and the chunk's B and
//     C rows, copied as 16-byte pieces by cp.async while the current chunk
//     runs; when a chunk has landed, the block converts it once to fp32
//     working rows ({dt, x} pairs, B, C), which each thread (and, for B and
//     C, every thread of the block, as a broadcast) then reads from shared
//     memory;
//   * y is collected in a shared tile and leaves as 16-byte coalesced
//     stores when the next chunk starts (element by element when Di's rows
//     are not whole pieces);
//   * two barriers a chunk, none a step;
//   * a single step (S = 1: every decode step) keeps no state across
//     steps and is bound by the states' bytes, so it takes its own layout:
//     the block's states and A rows in their memory order, 4 states (16
//     bytes) a lane, so that a warp moves 512 contiguous bytes a load, a
//     channel's N/4 lanes adjacent and summing y with a shuffle tree; x,
//     dt, B and C straight from global memory; no barrier (read as one
//     thread a channel, 64 bytes a thread, the jamba decode row took 9.8
//     us, against 6.3 in this layout, PERF.md §6);
//   * steps at t >= S are never loaded or stored: the last chunk runs to
//     its true length (the Pallas kernel has no tail guard).
//
// TPU-isms of the Pallas kernel that do not carry over:
//   * the transposed (N, Di_blk) state that puts N on sublanes and channels
//     on the 128 lanes: here a thread owns a channel's N states;
//   * block_di = 512 and the sequential chunk grid axis (chunk = 64) with
//     the state in VMEM scratch: one block sweeps all S steps in a loop;
//   * no initial or final state (so the reference's decode ran a jnp
//     recurrence): h0 and h_out are operands here.

#include <type_traits>

#include "attention_tiles.cuh"

namespace {

using repro_attn::cp_async16;
using repro_attn::cp_async_commit;
using repro_attn::cp_async_wait;
using repro_attn::smem_u32;
using repro_attn::store;
using repro_attn::to_f;

constexpr int kCh = 128;     // channels (threads) a block
constexpr int kChunk = 16;   // steps staged at a time
constexpr int kMinBlocks = 4;   // blocks an SM: 128 registers a thread
constexpr float kLog2e = 1.4426950408889634f;

// (b, t) element strides of a (B, S, *) operand whose last stride is 1
struct Strides {
  long long b, t;
};

// The shared memory of one (dtype, N): the staged chunk in the input
// type (x and dt [kChunk][kCh], B and C [kChunk][N]), the working rows in
// fp32 ({dt, x} [kChunk][kCh], B and C [kChunk][N]) and the y tile
// ([kChunk][kCh], input type).
template <typename T, int N>
struct Shape {
  static_assert(N % 4 == 0, "a state row is whole 16-byte pieces");
  static constexpr int kPiece = 16 / static_cast<int>(sizeof(T));
  static constexpr int kRawX = 2 * kChunk * kCh * sizeof(T);
  static constexpr int kRawBC = 2 * kChunk * N * sizeof(T);
  static constexpr int kWorkX = kChunk * kCh * 8;
  static constexpr int kWorkBC = 2 * kChunk * N * 4;
  static constexpr int kTile = kChunk * kCh * sizeof(T);
  static constexpr int kSmem = kRawX + kRawBC + kWorkX + kWorkBC + kTile;
  // bf16 rows take ex2.approx; fp32 rows an exact expf (the approximate
  // one left them 0.62 of their 1e-5 tier at S = 200, no margin)
  static constexpr bool kFastExp = std::is_same<T, __nv_bfloat16>::value;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One step of a channel's N states: h <- exp(dt A) h + (dt x) B, and
// sum_n h C.  With kFast, `a` holds A * log2 e and the exponential is
// ex2.approx; else `a` holds A and it is an exact expf.
template <bool kFast, int N>
__device__ __forceinline__ float step(float (&h)[N], const float (&a)[N],
                                      float dt, float dx,
                                      const float (&b)[N],
                                      const float (&c)[N]) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float e = kFast ? ex2(dt * a[k]) : expf(dt * a[k]);
    h[k] = fmaf(e, h[k], dx * b[k]);
    acc = fmaf(h[k], c[k], acc);
  }
  return acc;
}

// N consecutive floats, 16 bytes a load
template <int N>
__device__ __forceinline__ void load_states(const float* p, float (&o)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    o[k] = v.x; o[k + 1] = v.y; o[k + 2] = v.z; o[k + 3] = v.w;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kCh, kMinBlocks)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  Strides xs, const T* __restrict__ bm, Strides bs,
                  const T* __restrict__ cm, Strides cs,
                  const float* __restrict__ a,      // (Di, N)
                  const float* __restrict__ dvec,   // (Di,)
                  const float* __restrict__ h0,     // (B, Di, N) or null
                  T* __restrict__ y,                // (B, S, Di)
                  float* __restrict__ h_out,        // (B, Di, N)
                  int s, int di) {
  using Sh = Shape<T, N>;
  constexpr int C = kChunk, P = Sh::kPiece;
  constexpr int kXPieces = kCh / P;   // 16-byte pieces of a step's x row
  constexpr int kBPieces = N / P;     // ... of a step's B (or C) row
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw_x = reinterpret_cast<T*>(smem);
  T* raw_dt = raw_x + C * kCh;
  T* raw_b = raw_dt + C * kCh;
  T* raw_c = raw_b + C * N;
  float2* wx = reinterpret_cast<float2*>(smem + Sh::kRawX + Sh::kRawBC);
  float* wb = reinterpret_cast<float*>(wx + C * kCh);
  float* wc = wb + C * N;
  T* tile = reinterpret_cast<T*>(smem + Sh::kRawX + Sh::kRawBC +
                                 Sh::kWorkX + Sh::kWorkBC);

  const int tid = threadIdx.x;
  const int bi = blockIdx.y, c0 = blockIdx.x * kCh;
  const long long xb = bi * xs.b, bb = bi * bs.b, cb = bi * cs.b;

  if (s == 1) {
    // The block's states and A rows in their memory order: piece i of
    // 4 states (16 bytes) is channel c0 + i / L, states 4 (i % L) on, so
    // a warp moves 512 contiguous bytes a load; a channel's L pieces sit
    // in adjacent lanes, which sum y with a shuffle tree.
    constexpr int L = N / 4;
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const int i = tid + r * kCh, p = i % L, ch = c0 + i / L;
      // pieces past Di compute on a real channel and store nothing, so
      // that every lane takes part in the shuffles
      const int chc = ch < di ? ch : di - 1;
      const size_t at = (static_cast<size_t>(bi) * di + chc) * N + 4 * p;
      float av[4], h[4] = {0.f, 0.f, 0.f, 0.f}, bv[4], cv[4];
      load_states(a + static_cast<size_t>(chc) * N + 4 * p, av);
      if (h0 != nullptr) load_states(h0 + at, h);
      const float dtv = to_f(dt[xb + chc]), xv = to_f(x[xb + chc]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (Sh::kFastExp) av[k] *= kLog2e;
        bv[k] = to_f(bm[bb + 4 * p + k]);
        cv[k] = to_f(cm[cb + 4 * p + k]);
      }
      float acc = step<Sh::kFastExp>(h, av, dtv, dtv * xv, bv, cv);
#pragma unroll
      for (int off = 1; off < L; off *= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (ch < di) {
        if (p == 0)
          store(y + static_cast<size_t>(bi) * di + ch, acc + dvec[ch] * xv);
        *reinterpret_cast<float4*>(h_out + at) =
            make_float4(h[0], h[1], h[2], h[3]);
      }
    }
    return;
  }

  const int ch = c0 + tid;
  const bool live = ch < di;
  // threads past Di compute on a real channel and store nothing, so that
  // every thread takes part in the barriers
  const int chc = live ? ch : di - 1;
  const size_t hrow = (static_cast<size_t>(bi) * di + chc) * N;

  float av[N], h[N];
  load_states(a + static_cast<size_t>(chc) * N, av);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (Sh::kFastExp) av[k] *= kLog2e;
    h[k] = 0.f;
  }
  if (h0 != nullptr) load_states(h0 + hrow, h);
  const float dd = dvec[chc];

  // the rows of steps t0..min(t0+C, s)-1 into the raw buffers, one group
  auto stage = [&](int t0) {
    const int n = min(C, s - t0);
    for (int i = tid; i < n * kXPieces; i += kCh) {
      const int c = i / kXPieces, q = i % kXPieces;
      const long long src = xb + (t0 + c) * xs.t + c0 + q * P;
      const bool in = c0 + q * P < di;
      cp_async16(smem_u32(raw_x + i * P), x + (in ? src : 0), in);
      cp_async16(smem_u32(raw_dt + i * P), dt + (in ? src : 0), in);
    }
    for (int i = tid; i < n * kBPieces; i += kCh) {
      const int c = i / kBPieces, q = i % kBPieces;
      cp_async16(smem_u32(raw_b + i * P),
                 bm + bb + (t0 + c) * bs.t + q * P, true);
      cp_async16(smem_u32(raw_c + i * P),
                 cm + cb + (t0 + c) * cs.t + q * P, true);
    }
    cp_async_commit();
  };
  // the y tile of steps t0..t0+n-1 out to global memory
  const bool y_vec = di % P == 0;
  auto write_tile = [&](int t0, int n) {
    for (int i = tid; i < n * kXPieces; i += kCh) {
      const int c = i / kXPieces, col = c0 + i % kXPieces * P;
      if (col >= di) continue;
      T* dst = y + (static_cast<size_t>(bi) * s + t0 + c) * di + col;
      const T* src = tile + i * P;
      if (y_vec) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < P && col + e < di; ++e) dst[e] = src[e];
      }
    }
  };

  if (s > 0) stage(0);
  for (int t0 = 0; t0 < s; t0 += C) {
    const int n = min(C, s - t0);
    cp_async_wait<0>();
    __syncthreads();   // this chunk landed; the last one's steps are done
    if (t0 > 0) write_tile(t0 - C, C);
    for (int i = tid; i < n * kCh; i += kCh)
      wx[i] = make_float2(to_f(raw_dt[i]), to_f(raw_x[i]));
    for (int i = tid; i < n * N; i += kCh) {
      wb[i] = to_f(raw_b[i]);
      wc[i] = to_f(raw_c[i]);
    }
    __syncthreads();   // working rows ready; the raw buffers are free
    if (t0 + C < s) stage(t0 + C);
    for (int c = 0; c < n; ++c) {
      const float2 v = wx[c * kCh + tid];   // {dt, x}
      float bv[N], cv[N];
      load_states(wb + c * N, bv);
      load_states(wc + c * N, cv);
      const float acc = step<Sh::kFastExp>(h, av, v.x, v.x * v.y, bv, cv);
      store(tile + c * kCh + tid, acc + dd * v.y);
    }
  }
  __syncthreads();   // the last chunk's outputs are in the tile
  if (s > 0) {
    const int t0 = (s - 1) / C * C;
    write_tile(t0, s - t0);
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(h_out + hrow + k) =
          make_float4(h[k], h[k + 1], h[k + 2], h[k + 3]);
  }
}

// A call's arguments, passed down the dtype and state-size dispatch.
struct Args {
  const void *x, *dt;
  Strides xs;
  const void* bm;
  Strides bs;
  const void* cm;
  Strides cs;
  const float *a, *d, *h0;
  void* y;
  float* h_out;
  int b, s, di;
  cudaStream_t stream;
};

struct Launch {
  const Args& a;
  template <typename T, int N>
  int run() const {
    using Sh = Shape<T, N>;
    cudaError_t err = repro_attn::allow_smem(mamba_scan_kernel<T, N>,
                                             Sh::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.di + kCh - 1) / kCh, a.b);
    mamba_scan_kernel<T, N><<<grid, kCh, Sh::kSmem, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.dt), a.xs,
        static_cast<const T*>(a.bm), a.bs, static_cast<const T*>(a.cm),
        a.cs, a.a, a.d, a.h0, static_cast<T*>(a.y), a.h_out, a.s, a.di);
    return static_cast<int>(cudaGetLastError());
  }
};

// repro_attn::kernel_attrs (registers, local (spill) bytes, dynamic
// shared bytes, blocks an SM, threads (= channels) a block, and here the
// steps a chunk), then the card's SMs
struct Attrs {
  int* out;
  template <typename T, int N>
  int run() const {
    using Sh = Shape<T, N>;
    const int err = repro_attn::kernel_attrs(mamba_scan_kernel<T, N>,
                                             Sh::kSmem, kCh, kChunk, out);
    if (err != 0) return err;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&out[6], cudaDevAttrMultiProcessorCount,
                                 dev);
    return static_cast<int>(e);
  }
};

// -1 for another state size, -3 for another dtype
template <typename T, typename Op>
int by_state(int n, const Op& op) {
  switch (n) {
    case 8: return op.template run<T, 8>();
    case 16: return op.template run<T, 16>();
    default: return -1;
  }
}

template <typename Op>
int by_type(int dtype, int n, const Op& op) {
  if (dtype == 0) return by_state<float>(n, op);
  if (dtype == 1) return by_state<__nv_bfloat16>(n, op);
  return -3;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x, dt, B, C and y share it); A, D,
// h0 and h_out are float32; h0 may be null (zero initial state).
// x_b/x_t are the (b, t) element strides shared by x and dt, b_b/b_t those
// of B, c_b/c_t those of C; y is contiguous (B, S, Di).  Returns the CUDA
// error of the launch (0 on success), -1 for an unsupported state size,
// -3 for an unsupported dtype.
extern "C" int repro_mamba_scan(int dtype, int n, const void* x,
                                const void* dt, long long x_b, long long x_t,
                                const void* bm, long long b_b, long long b_t,
                                const void* cm, long long c_b, long long c_t,
                                const void* a, const void* d, const void* h0,
                                void* y, void* h_out, int b, int s, int di,
                                void* stream) {
  const Args args{x, dt, Strides{x_b, x_t}, bm, Strides{b_b, b_t}, cm,
                  Strides{c_b, c_t}, static_cast<const float*>(a),
                  static_cast<const float*>(d),
                  static_cast<const float*>(h0), y,
                  static_cast<float*>(h_out), b, s, di,
                  static_cast<cudaStream_t>(stream)};
  return by_type(dtype, n, Launch{args});
}

// The resources of the kernel a call with (dtype, n) launches, into
// out[7] (see Attrs).  Returns 0, a CUDA error, or -1/-3 as above.
extern "C" int repro_mamba_attrs(int dtype, int n, int* out) {
  return by_type(dtype, n, Attrs{out});
}
