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
// contiguous (B, Di, N) fp32, y a contiguous (B, S, Di) tensor.
//
// Design (first, simple version):
//   * one thread per (b, channel): it holds its N state values and its row
//     of A in registers for the whole sweep (N is a template parameter, 8
//     or 16), so the state never leaves the SM; a block is 128 consecutive
//     channels of one row, the grid (ceil(Di / 128), B);
//   * x and dt are read one step at a time per thread, coalesced across
//     the block's channels; the next chunk's kChunk steps are loaded into
//     registers before the current chunk runs, so their DRAM latency hides
//     behind the steps (the lesson of the WKV6 kernel, csrc/rwkv6.cu);
//   * a chunk's B and C rows (N values a step, the same for every channel)
//     are staged in shared memory and read by all threads at one address
//     (a broadcast);
//   * steps at t >= S are never loaded or stored: the last chunk runs to
//     its true length (the Pallas kernel has no tail guard).
//
// What bounds it on the H100: bytes.  At the jamba prefill row (B=4,
// S=1024, Di=16384, N=16, bf16) x and dt in and y out are 403 MB, 0.120 ms
// at 3.35 TB/s, against 7 fp32 operations a state element a step (7.5
// GFLOP, 0.112 ms at 67 TFLOP/s).  One exp a state element a step is also
// 1.07 G transcendentals, about 0.26 ms on the SFUs (16 a clock an SM), a
// floor for any kernel that evaluates them one by one, this one included.
// With 4 warps a block and 512 blocks the SMs hold few warps; splitting
// the N states of a channel over threads, or the sequence over blocks
// (a chunked scan), is the next step.
//
// TPU-isms of the Pallas kernel that do not carry over:
//   * the transposed (N, Di_blk) state that puts N on sublanes and channels
//     on the 128 lanes: here each thread owns one channel's N values;
//   * block_di = 512 and the sequential chunk grid axis (chunk = 64) with
//     the state in VMEM scratch: one block sweeps all S steps in a loop;
//   * no initial or final state (so the reference's decode ran a jnp
//     recurrence): h0 and h_out are operands here.

#include "attention_common.cuh"

namespace {

using repro_attn::store;
using repro_attn::to_f;

constexpr int kThreads = 128;   // channels a block
constexpr int kChunk = 16;      // steps staged at a time

// (b, t) element strides of a (B, S, *) operand whose last stride is 1
struct Strides {
  long long b, t;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  Strides xs, const T* __restrict__ bm, Strides bs,
                  const T* __restrict__ cm, Strides cs,
                  const float* __restrict__ a,      // (Di, N)
                  const float* __restrict__ dvec,   // (Di,)
                  const float* __restrict__ h0,     // (B, Di, N) or null
                  T* __restrict__ y,                // (B, S, Di)
                  float* __restrict__ h_out,        // (B, Di, N)
                  int s, int di) {
  // 16-byte aligned: the step loop reads the rows as float4
  __shared__ __align__(16) float b_s[kChunk][N];
  __shared__ __align__(16) float c_s[kChunk][N];

  const int bi = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ch < di;
  // threads past Di load a real channel's values and store nothing, so
  // that every thread takes part in the block's barriers
  const int chc = live ? ch : di - 1;
  const size_t hrow = (static_cast<size_t>(bi) * di + chc) * N;

  float h[N], av[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = a[static_cast<size_t>(chc) * N + n];
    h[n] = h0 != nullptr ? h0[hrow + n] : 0.f;
  }
  const float dd = dvec[chc];
  const T* xrow = x + bi * xs.b + chc;
  const T* dtrow = dt + bi * xs.b + chc;
  const T* brow = bm + bi * bs.b;
  const T* crow = cm + bi * cs.b;
  T* yrow = y + static_cast<size_t>(bi) * s * di + chc;

  // the next chunk's x and dt, loaded while the current chunk runs
  T px[kChunk], pdt[kChunk];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (t0 + c < s) {
        px[c] = xrow[(t0 + c) * xs.t];
        pdt[c] = dtrow[(t0 + c) * xs.t];
      }
    }
  };
  fetch(0);

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int steps = min(kChunk, s - t0);   // the same for the whole block
    __syncthreads();   // the previous chunk's readers are done
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      const int c = i / N, n = i % N;
      b_s[c][n] = to_f(brow[(t0 + c) * bs.t + n]);
      c_s[c][n] = to_f(crow[(t0 + c) * cs.t + n]);
    }
    __syncthreads();
    float xv[kChunk], dtv[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      xv[c] = to_f(px[c]);
      dtv[c] = to_f(pdt[c]);
    }
    if (t0 + kChunk < s) fetch(t0 + kChunk);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c < steps) {
        const float dx = dtv[c] * xv[c];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < N; n += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(&b_s[c][n]);
          const float4 c4 = *reinterpret_cast<const float4*>(&c_s[c][n]);
          h[n] = expf(dtv[c] * av[n]) * h[n] + dx * b4.x;
          h[n + 1] = expf(dtv[c] * av[n + 1]) * h[n + 1] + dx * b4.y;
          h[n + 2] = expf(dtv[c] * av[n + 2]) * h[n + 2] + dx * b4.z;
          h[n + 3] = expf(dtv[c] * av[n + 3]) * h[n + 3] + dx * b4.w;
          acc[0] += h[n] * c4.x;
          acc[1] += h[n + 1] * c4.y;
          acc[2] += h[n + 2] * c4.z;
          acc[3] += h[n + 3] * c4.w;
        }
        if (live)
          store(yrow + static_cast<size_t>(t0 + c) * di,
                (acc[0] + acc[1]) + (acc[2] + acc[3]) + dd * xv[c]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[hrow + n] = h[n];
  }
}

template <typename T, int N>
int launch(const void* x, const void* dt, Strides xs, const void* bm,
           Strides bs, const void* cm, Strides cs, const float* a,
           const float* d, const float* h0, void* y, float* h_out, int b,
           int s, int di, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, b);
  mamba_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), xs,
      static_cast<const T*>(bm), bs, static_cast<const T*>(cm), cs, a, d,
      h0, static_cast<T*>(y), h_out, s, di);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int n, const void* x, const void* dt, Strides xs,
               const void* bm, Strides bs, const void* cm, Strides cs,
               const float* a, const float* d, const float* h0, void* y,
               float* h_out, int b, int s, int di, cudaStream_t stream) {
  switch (n) {
    case 8:
      return launch<T, 8>(x, dt, xs, bm, bs, cm, cs, a, d, h0, y, h_out, b,
                          s, di, stream);
    case 16:
      return launch<T, 16>(x, dt, xs, bm, bs, cm, cs, a, d, h0, y, h_out, b,
                           s, di, stream);
    default:
      return -1;
  }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides xs{x_b, x_t}, bs{b_b, b_t}, cs{c_b, c_t};
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(d);
  const float* h0f = static_cast<const float*>(h0);
  float* hof = static_cast<float*>(h_out);
  if (dtype == 0)
    return dispatch_n<float>(n, x, dt, xs, bm, bs, cm, cs, af, df, h0f, y,
                             hof, b, s, di, st);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(n, x, dt, xs, bm, bs, cm, cs, af, df,
                                     h0f, y, hof, b, s, di, st);
  return -3;
}
