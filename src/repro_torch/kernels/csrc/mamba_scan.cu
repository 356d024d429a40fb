// Selective scan of the mamba1 mixer (the prefill's state recurrence), for
// Hopper (sm_90a).
//
// mamba_scan_fwd replaces the TPU kernel mamba_scan
// (src/repro/kernels/mamba_scan.py:44). For every batch row b and inner
// channel d, from h = 0:
//   h_t[n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[n] + (dt_t[d] * x_t[d]) * B_t[n]
//   y_t[d] = sum_n h_t[n] * C_t[n]
// and the last state h_S is written out in f32. exp(dt * A) is computed at
// every step, as the TPU kernel does (no cumulative product of the decays,
// which would round differently). x, dt, A, B and C may each be f32 or
// bf16; they are widened to f32 as they are staged, and all the math is
// f32. y has x's dtype.
//
// Mapping: LANES threads (the state dimension rounded up to 8 or 16) share
// one channel, each holding one state of h in a register, so a block of
// 256 threads carries 256 / LANES channels of one batch row. At the
// serve path's prefill (Di 8192, N 16) that is 512 blocks of 16 channels,
// which the 132 SMs hold at once. Each step's y is the sum over the
// channel's lanes, reduced with __shfl_xor_sync. The sequence is walked in
// tiles of T steps: the block stages the tile's dt and x (its channels), B
// and C (all states) in shared memory, runs the T dependent steps, then
// writes the tile's y from shared memory, neighbouring threads on
// neighbouring channels. The only dependency carried from one step to the
// next is one FMA per state; the exponential, the loads and the reduction
// of a step do not wait on the previous step.
//
// Inputs are read through their strides (in elements), so the model hands
// in B and C as column slices of its [B, S, dt_rank + 2N] projection with
// no copy. Any Di and S: a channel past Di or a step past S is masked (it
// loads zeros, and nothing of it is written); a state past N carries
// A = B = C = 0, so it stays 0 and adds nothing to y.
//
// Bound: at the full-width prefill (B 1, S 1536, Di 8192, N 16, f32 x, dt
// and y) the kernel must move about 152 MB (0.045 ms at 3.35 TB/s) and
// evaluate B*S*Di*N = 201,326,592 exponentials; at 16 per clock per SM on
// the special-function units that is about 0.048 ms at 1.98 GHz, so the
// exponentials bound it. This first version is a plain SIMT kernel:
// accurate expf (not __expf) and about 25 instructions per state and step,
// so it runs several times above that bound.
//
// Plain C interface, for ctypes: the function launches on the given stream
// and returns cudaGetLastError() (0 on success). It never synchronises and
// allocates nothing; the caller allocates y and h_last, both contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int T = 64;   // steps staged per tile

// An input: its pointer, dtype (0 = float32, 1 = bfloat16) and strides.
struct In {
  const void* p;
  int dtype;
  int64_t s0, s1, s2;
};

__device__ __forceinline__ float load(const In& in, int64_t i) {
  if (in.dtype == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(in.p)[i]);
  return static_cast<const float*>(in.p)[i];
}

template <int LANES>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(In x, In dt, In A, In Bm, In Cm, void* y, int y_bf16,
                      float* h_last, int S, int Di, int N) {
  constexpr int CH = kThreads / LANES;   // channels per block
  __shared__ float s_dt[T][CH], s_x[T][CH], s_y[T][CH];
  __shared__ float s_b[T][LANES], s_c[T][LANES];

  const int tid = threadIdx.x;
  const int lane = tid % LANES;          // this thread's state
  const int cl = tid / LANES;            // this thread's channel in the block
  const int c0 = blockIdx.x * CH;
  const int c = c0 + cl;
  const int b = blockIdx.y;

  const float av = (c < Di && lane < N) ? load(A, c * A.s0 + lane * A.s1)
                                        : 0.f;
  float h = 0.f;

  for (int t0 = 0; t0 < S; t0 += T) {
    const int steps = min(T, S - t0);
    for (int i = tid; i < T * CH; i += kThreads) {
      const int tt = i / CH, cc = i % CH, ch = c0 + cc;
      const bool ok = tt < steps && ch < Di;
      const int64_t t = t0 + tt;
      s_dt[tt][cc] = ok ? load(dt, b * dt.s0 + t * dt.s1 + ch * dt.s2) : 0.f;
      s_x[tt][cc] = ok ? load(x, b * x.s0 + t * x.s1 + ch * x.s2) : 0.f;
    }
    for (int i = tid; i < T * LANES; i += kThreads) {
      const int tt = i / LANES, n = i % LANES;
      const bool ok = tt < steps && n < N;
      const int64_t t = t0 + tt;
      s_b[tt][n] = ok ? load(Bm, b * Bm.s0 + t * Bm.s1 + n * Bm.s2) : 0.f;
      s_c[tt][n] = ok ? load(Cm, b * Cm.s0 + t * Cm.s1 + n * Cm.s2) : 0.f;
    }
    __syncthreads();

    for (int tt = 0; tt < steps; ++tt) {
      const float d = s_dt[tt][cl];
      const float u = d * s_x[tt][cl];
      h = fmaf(expf(d * av), h, u * s_b[tt][lane]);
      float part = h * s_c[tt][lane];
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) s_y[tt][cl] = part;
    }
    __syncthreads();

    for (int i = tid; i < steps * CH; i += kThreads) {
      const int tt = i / CH, cc = i % CH, ch = c0 + cc;
      if (ch >= Di) continue;
      const int64_t at = ((int64_t)b * S + t0 + tt) * Di + ch;
      if (y_bf16)
        static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(s_y[tt][cc]);
      else
        static_cast<float*>(y)[at] = s_y[tt][cc];
    }
    // the next tile's staging writes s_dt, s_x, s_b and s_c, which every
    // thread finished reading before the barrier above; s_y is written
    // again only after the next tile's barrier
  }

  if (c < Di && lane < N) h_last[((int64_t)b * Di + c) * N + lane] = h;
}

template <int LANES>
int launch(In x, In dt, In A, In Bm, In Cm, void* y, int y_bf16,
           float* h_last, int B, int S, int Di, int N, cudaStream_t stream) {
  constexpr int CH = kThreads / LANES;
  dim3 grid((Di + CH - 1) / CH, B);
  mamba_scan_kernel<LANES><<<grid, kThreads, 0, stream>>>(
      x, dt, A, Bm, Cm, y, y_bf16, h_last, S, Di, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Dtypes: 0 = float32, 1 = bfloat16, per input; y has x's dtype. Strides
// are in elements: x, dt (b, s, d); A (d, n); Bm, Cm (b, s, n). y is a
// contiguous [B, S, Di], h_last a contiguous f32 [B, Di, N]. N from 1 to
// 16, mamba1's state sizes (anything else returns cudaErrorInvalidValue).
extern "C" int mamba_scan_fwd(
    const void* x, int x_dtype, int64_t xsb, int64_t xss, int64_t xsd,
    const void* dt, int dt_dtype, int64_t dsb, int64_t dss, int64_t dsd,
    const void* A, int a_dtype, int64_t asd, int64_t asn, const void* Bm,
    int b_dtype, int64_t bsb, int64_t bss, int64_t bsn, const void* Cm,
    int c_dtype, int64_t csb, int64_t css, int64_t csn, void* y,
    float* h_last, int B, int S, int Di, int N, void* stream) {
  const In xi{x, x_dtype, xsb, xss, xsd}, di{dt, dt_dtype, dsb, dss, dsd},
      ai{A, a_dtype, asd, asn, 0}, bi{Bm, b_dtype, bsb, bss, bsn},
      ci{Cm, c_dtype, csb, css, csn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N >= 1 && N <= 8)
    return launch<8>(xi, di, ai, bi, ci, y, x_dtype, h_last, B, S, Di, N, st);
  if (N > 8 && N <= 16)
    return launch<16>(xi, di, ai, bi, ci, y, x_dtype, h_last, B, S, Di, N,
                      st);
  return (int)cudaErrorInvalidValue;
}
