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
// layout), fp32 or bf16, read as fp32; u is (H, D) fp32; the states are
// contiguous (B, H, D, D) fp32; out has its own (b, h, t) strides, in the
// input type, rounded once from the fp32 sum.
//
// Design (first, simple version; the layout of the RWKV authors' public
// CUDA kernel):
//   * one block of D threads per (b, h); thread j owns column j of the
//     state, S[:, j], in D registers for the whole sweep, so the state never
//     leaves the SM between steps;
//   * the block stages kChunk steps of r, k, w and v in shared memory at a
//     time (thread j loads element j of each step's row: coalesced), and
//     reduces each step's bonus scalar sum_i r_i u_i k_i there (a warp sum,
//     then one partial per warp); then each thread walks the chunk's steps
//     in order.  The next chunk's loads are issued into registers before
//     the walk, so their DRAM latency overlaps it (a version that loaded
//     each step's row just before reducing it ran at twice the time).
//     r/k/w are read by all threads at the same address (a broadcast),
//     four at a time as float4, since shared-memory load instructions, not
//     the FMAs, bound a step with scalar loads; v by its own thread;
//   * two barriers per chunk, not per step.
//
// What bounds it on the H100: operations.  Each step costs 5 fp32
// operations per state element (the r FMA, k*v, the decay FMA); the bonus
// scalar is O(D) a step.  The rwkv6-1.6b prefill row (B=4, H=32, S=1024,
// D=64) needs 2.7 GFLOP against 86 MB of bytes: 0.040 ms at the 67 TFLOP/s
// fp32 peak against 0.026 ms at 3.35 TB/s.  The state math is fp32
// whatever the input type, so the fp32 peak is the one that applies.  This
// version is far from it: 128 blocks of 2 warps leave each SM's schedulers
// mostly idle, and the sweep over S is serial.  The chunked form
// (intra-chunk products on the tensor cores, the state carried between
// chunks) and several blocks per (b, h) are the next steps.
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

#include "attention_common.cuh"

namespace {

using repro_attn::store;
using repro_attn::to_f;
using repro_attn::warp_sum;

constexpr int kChunk = 16;   // steps staged in shared memory at a time

// (b, h, t) element strides of a (B, H, S, D) view; the last stride is 1
struct Strides {
  long long b, h, t;
};

template <typename T, int D>
__global__ void __launch_bounds__(D)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             Strides in,
             const float* __restrict__ u,        // (H, D)
             const float* __restrict__ state0,   // (B, H, D, D) or null
             T* __restrict__ out, Strides os,    // (B, H, S, D) view
             float* __restrict__ state_out,      // (B, H, D, D)
             int h, int s) {
  constexpr int kWarps = D / 32;
  // 16-byte aligned: the step loop reads r, k and w as float4
  __shared__ __align__(16) float rs[kChunk][D];
  __shared__ __align__(16) float ks[kChunk][D];
  __shared__ __align__(16) float ws[kChunk][D];
  __shared__ float vs[kChunk][D];
  __shared__ float bonus[kChunk][kWarps];   // per-warp sum_i r_i u_i k_i

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const int j = threadIdx.x;
  const long long row = bi * in.b + hi * in.h + j;
  const long long orow = bi * os.b + hi * os.h + j;
  const size_t sbase = static_cast<size_t>(bh) * D * D;
  const float uj = u[static_cast<size_t>(hi) * D + j];

  float st[D];
#pragma unroll
  for (int i = 0; i < D; ++i)
    st[i] = state0 != nullptr ? state0[sbase + static_cast<size_t>(i) * D + j]
                              : 0.f;

  // The next chunk's elements, loaded into registers while the current
  // chunk's steps run: all 4 * kChunk loads are in flight at once, and
  // their latency hides behind the steps, not in front of them.
  T pr[kChunk], pk[kChunk], pw[kChunk], pv[kChunk];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (t0 + c < s) {
        const long long off = row + (t0 + c) * in.t;
        pr[c] = r[off];
        pk[c] = k[off];
        pw[c] = w[off];
        pv[c] = v[off];
      }
    }
  };
  fetch(0);

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int n = min(kChunk, s - t0);
    __syncthreads();   // the previous chunk's readers are done
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c < n) {     // n is the same for the whole block
        const float rj = to_f(pr[c]), kj = to_f(pk[c]);
        rs[c][j] = rj;
        ks[c][j] = kj;
        ws[c][j] = to_f(pw[c]);
        vs[c][j] = to_f(pv[c]);
        const float part = warp_sum(rj * uj * kj);
        if (j % 32 == 0) bonus[c][j / 32] = part;
      }
    }
    __syncthreads();
    if (t0 + kChunk < s) fetch(t0 + kChunk);
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float ruk = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) ruk += bonus[c][q];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[c][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[c][i]);
        acc[0] += r4.x * st[i];
        acc[1] += r4.y * st[i + 1];
        acc[2] += r4.z * st[i + 2];
        acc[3] += r4.w * st[i + 3];
        st[i] = w4.x * st[i] + k4.x * vj;
        st[i + 1] = w4.y * st[i + 1] + k4.y * vj;
        st[i + 2] = w4.z * st[i + 2] + k4.z * vj;
        st[i + 3] = w4.w * st[i + 3] + k4.w * vj;
      }
      store(out + orow + (t0 + c) * os.t,
            (acc[0] + acc[1]) + (acc[2] + acc[3]) + vj * ruk);
    }
  }

#pragma unroll
  for (int i = 0; i < D; ++i)
    state_out[sbase + static_cast<size_t>(i) * D + j] = st[i];
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const void* w,
           Strides in, const float* u, const float* state0, void* out,
           Strides os, float* state_out, int bh, int h, int s,
           cudaStream_t stream) {
  rwkv6_kernel<T, D><<<bh, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), in, u, state0,
      static_cast<T*>(out), os, state_out, h, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* r, const void* k, const void* v,
               const void* w, Strides in, const float* u,
               const float* state0, void* out, Strides os, float* state_out,
               int bh, int h, int s, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(r, k, v, w, in, u, state0, out, os, state_out,
                           bh, h, s, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, in, u, state0, out, os, state_out,
                           bh, h, s, stream);
    case 128:
      return launch<T, 128>(r, k, v, w, in, u, state0, out, os, state_out,
                            bh, h, s, stream);
    default:
      return -1;
  }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  float* so = static_cast<float*>(state_out);
  const Strides in{in_b, in_h, in_t}, os{out_b, out_h, out_t};
  if (dtype == 0)
    return dispatch_d<float>(d, r, k, v, w, in, uf, s0, out, os, so, b * h,
                             h, s, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, r, k, v, w, in, uf, s0, out, os, so,
                                     b * h, h, s, st);
  return -3;
}
