// Selective scan of the mamba1 mixer (the prefill's state recurrence), for
// Hopper (sm_90a).
//
// mamba_scan_fwd replaces the TPU kernel mamba_scan
// (src/repro/kernels/mamba_scan.py:44). For every batch row b and inner
// channel d, from h = 0:
//   h_t[n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[n] + (dt_t[d] * x_t[d]) * B_t[n]
//   y_t[d] = sum_n h_t[n] * C_t[n]
// and the last state h_S is written out in f32. exp(dt * A) is computed at
// every step with accurate expf, as the TPU kernel does (no cumulative
// product of the decays, which would round differently), and the state
// takes one fmaf per step, in time order. x, dt, B and C are all f32 or
// all bf16 (the wrapper widens a mix to f32, exactly), A either; all the
// math is f32. y has the dtype the wrapper names.
//
// Bound: at the full-width prefill (B 1, S 1536, Di 8192, N 16, f32 x, dt
// and y) the kernel must move about 152 MB (0.045 ms at 3.35 TB/s) and
// evaluate B*S*Di*N = 201,326,592 exponentials; at 16 per clock per SM on
// the special-function units that is about 0.048 ms at 1.98 GHz, so the
// exponentials bound it. The first kernel put one lane on each state: every
// lane paid a 4-level shuffle reduction of y, the loads of dt and x and
// the product dt * x at every step, about 30 instructions per state and
// step, and each 64-step tile was staged behind two barriers with no
// overlap: 10.8% of the bound.
//
// Design. A thread carries SPT = 4 states of one channel in registers, and
// LANES = 4 neighbouring lanes share a channel, so that y's sum over the
// states is in-thread FMAs and a 2-level shuffle; at B 1 and Di 8192 that
// is 32,768 threads. (SPT 8, 2 lanes and 1 level, half the threads, was
// slower on the H100: PERF.md, section 6.) A block carries CH = 16 channels
// of one batch row. dt and dt * x are computed once per thread and step,
// for its SPT states; B_t and C_t are read from shared memory as 16- or
// 8-byte vectors that every lane of a warp with the same state slice
// shares (a broadcast). The sequence is
// walked in tiles of T = 64 steps through two buffers: while tile i is
// scanned, tile i + 1's x, dt, B and C are already on their way into the
// other buffer with cp.async (16-byte copies; rows past S or channels past
// Di are zero-filled). The tile's y is staged in shared memory and written
// with coalesced stores, neighbouring threads on neighbouring channels.
// The only dependency carried from one step to the next is one FMA per
// state.
//
// Inputs are read through their strides (in elements), so the model hands
// in B and C as column slices of its [B, S, dt_rank + 2N] projection with
// no copy. The 16-byte copies need 16-byte-aligned starts and strides and
// rows whose length (Di or N) fills whole 16-byte chunks; an input pair
// that does not is staged with plain loads (the wrapper's flags vec_xdt
// and vec_bc). Any Di and S: a channel past Di or a step past S is masked;
// a state past N carries A = B = C = 0, so it stays 0 and adds nothing.
//
// Shared memory per block (the plan the wrapper checks, mamba_scan.py
// smem_bytes): two buffers of x and dt [T, CH] and B and C [T, 16] in the
// inputs' dtype, and y [T, CH] in f32: 36,864 bytes with f32 inputs, under
// the 48 KB a launch may take without opting in.
//
// Plain C interface, for ctypes: the function launches on the given stream
// and returns cudaGetLastError() (0 on success). It never synchronises and
// allocates nothing; the caller allocates y and h_last, both contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;    // steps a tile
constexpr int CH = 16;   // channels a block
constexpr int NS = 16;   // states a channel carries (N padded)
constexpr int SPT = 4;   // states a thread

// An input: its pointer, dtype (0 = float32, 1 = bfloat16) and strides.
struct In {
  const void* p;
  int dtype;
  int64_t s0, s1, s2;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float load(const In& in, int64_t i) {
  if (in.dtype == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(in.p)[i]);
  return static_cast<const float*>(in.p)[i];
}

template <typename TI>
struct alignas(16) Tiles {
  TI x[T][CH], dt[T][CH];
  TI b[T][NS], c[T][NS];
};

template <typename TI>
struct alignas(16) Smem {
  Tiles<TI> buf[2];
  float y[T][CH];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  // 16 bytes, or zeros when !ok
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// SPT consecutive states of a B or C row as f32 (16-byte loads of f32,
// 4-byte loads of bf16 pairs).
__device__ __forceinline__ void load_states(float (&out)[SPT],
                                            const float* p) {
#pragma unroll
  for (int i = 0; i < SPT; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    out[i] = v.x;
    out[i + 1] = v.y;
    out[i + 2] = v.z;
    out[i + 3] = v.w;
  }
}
__device__ __forceinline__ void load_states(float (&out)[SPT],
                                            const __nv_bfloat16* p) {
#pragma unroll
  for (int i = 0; i < SPT; i += 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p + i);
    out[i] = __low2float(v);
    out[i + 1] = __high2float(v);
  }
}

// Rows [t0, t0 + T) of a [B, S, cols] input (row b), columns [col0,
// col0 + W), into dst[T][ld] in the input's dtype: 16-byte cp.async when
// `vec` (rows past S and chunks past `cols` zero-filled), else plain loads
// (zeros past the edges).
template <typename TE, int W, int kThreads>
__device__ __forceinline__ void stage_rows(TE* dst, int ld, const In& in,
                                           bool vec, int b, int t0, int S,
                                           int col0, int cols) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int PER = 16 / sizeof(TE);   // elements a chunk
    constexpr int CHUNKS = W / PER;        // chunks a row
    for (int i = tid; i < T * CHUNKS; i += kThreads) {
      const int r = i / CHUNKS, col = (i % CHUNKS) * PER;
      const bool ok = t0 + r < S && col0 + col < cols;
      const TE* src = static_cast<const TE*>(in.p);
      if (ok) src += b * in.s0 + (int64_t)(t0 + r) * in.s1 + col0 + col;
      cp_async16(dst + r * ld + col, src, ok);
    }
  } else {
    for (int i = tid; i < T * W; i += kThreads) {
      const int r = i / W, col = i % W;
      const bool ok = t0 + r < S && col0 + col < cols;
      const TE* src = static_cast<const TE*>(in.p);
      dst[r * ld + col] =
          ok ? src[b * in.s0 + (int64_t)(t0 + r) * in.s1 +
                   (int64_t)(col0 + col) * in.s2]
             : TE(0.f);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <typename TI, int kThreads>
__device__ __forceinline__ void stage(Tiles<TI>& buf, const In& x,
                                      const In& dt, const In& Bm,
                                      const In& Cm, bool vec_xdt,
                                      bool vec_bc, int b, int t0, int S,
                                      int c0, int Di, int N) {
  stage_rows<TI, CH, kThreads>(&buf.x[0][0], CH, x, vec_xdt, b, t0, S, c0,
                               Di);
  stage_rows<TI, CH, kThreads>(&buf.dt[0][0], CH, dt, vec_xdt, b, t0, S, c0,
                               Di);
  // B and C: the first N states of a row (vec: N fills whole chunks), and
  // zeros in the padding past N
  stage_rows<TI, NS, kThreads>(&buf.b[0][0], NS, Bm, vec_bc, b, t0, S, 0, N);
  stage_rows<TI, NS, kThreads>(&buf.c[0][0], NS, Cm, vec_bc, b, t0, S, 0, N);
}

template <typename TI>
__global__ void __launch_bounds__(CH * (NS / SPT))
    mamba_scan_kernel(In x, In dt, In A, In Bm, In Cm, int vec_xdt,
                      int vec_bc, void* y, int y_bf16, float* h_last, int S,
                      int Di, int N) {
  constexpr int LANES = NS / SPT;       // lanes a channel
  constexpr int kThreads = CH * LANES;
  constexpr int U = 32 / SPT;           // steps taken together (T % U == 0)
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem<TI>& sm = *reinterpret_cast<Smem<TI>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid % LANES;          // this thread's slice of states
  const int cl = tid / LANES;            // its channel in the block
  const int n0 = lane * SPT;
  const int c0 = blockIdx.x * CH, c = c0 + cl;
  const int b = blockIdx.y;
  const int n_tiles = (S + T - 1) / T;

  float a[SPT], h[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    a[i] = (c < Di && n0 + i < N) ? load(A, c * A.s0 + (n0 + i) * A.s1)
                                  : 0.f;
    h[i] = 0.f;
  }
  stage<TI, kThreads>(sm.buf[0], x, dt, Bm, Cm, vec_xdt, vec_bc, b, 0, S,
                      c0, Di, N);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * T, steps = min(T, S - t0);
    if (it + 1 < n_tiles) {
      // the other buffer was last read before the previous tile's second
      // barrier
      stage<TI, kThreads>(sm.buf[(it + 1) & 1], x, dt, Bm, Cm, vec_xdt,
                          vec_bc, b, t0 + T, S, c0, Di, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // every thread's copies of tile it have landed

    // U steps at a time: first their loads, decays exp(dt * A) and inputs
    // (dt * x) * B, which do not wait on the state, then the U dependent
    // updates of the state. Rows past `steps` are zeros (dt 0: exp(0) = 1,
    // dt * x = 0), which leave the state exactly as it was; their y is
    // not stored.
    const Tiles<TI>& cur = sm.buf[it & 1];
    for (int t8 = 0; t8 < steps; t8 += U) {
      float e[U][SPT], bu[U][SPT], cv[U][SPT], part[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const float d = widen(cur.dt[t8 + k][cl]);
        const float u = d * widen(cur.x[t8 + k][cl]);
        float bv[SPT];
        load_states(bv, &cur.b[t8 + k][n0]);
        load_states(cv[k], &cur.c[t8 + k][n0]);
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          e[k][i] = expf(d * a[i]);
          bu[k][i] = u * bv[i];
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          h[i] = fmaf(e[k][i], h[i], bu[k][i]);
          part[k] = i == 0 ? h[0] * cv[k][0] : fmaf(h[i], cv[k][i], part[k]);
        }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
#pragma unroll
        for (int k = 0; k < U; ++k)
          part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < U; ++k) sm.y[t8 + k][cl] = part[k];
      }
    }
    __syncthreads();   // y complete; tile it's buffer free

    for (int i = tid; i < steps * CH; i += kThreads) {
      const int tt = i / CH, cc = i % CH, ch = c0 + cc;
      if (ch >= Di) continue;
      const int64_t at = ((int64_t)b * S + t0 + tt) * Di + ch;
      if (y_bf16)
        static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(sm.y[tt][cc]);
      else
        static_cast<float*>(y)[at] = sm.y[tt][cc];
    }
    // sm.y is written again only after the next tile's first barrier
  }

  if (c < Di) {
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      if (n0 + i < N) h_last[((int64_t)b * Di + c) * N + n0 + i] = h[i];
  }
}

template <typename TI>
int launch(In x, In dt, In A, In Bm, In Cm, int vec_xdt, int vec_bc, void* y,
           int y_bf16, float* h_last, int B, int S, int Di, int N,
           int smem_bytes, cudaStream_t stream) {
  constexpr int bytes = sizeof(Smem<TI>);
  static_assert(bytes <= 48 * 1024, "a launch past 48 KB must opt in");
  if (smem_bytes != bytes) return (int)cudaErrorInvalidValue;
  dim3 grid((Di + CH - 1) / CH, B);
  mamba_scan_kernel<TI><<<grid, CH * (NS / SPT), bytes, stream>>>(
      x, dt, A, Bm, Cm, vec_xdt, vec_bc, y, y_bf16, h_last, S, Di, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Dtypes: 0 = float32, 1 = bfloat16, per input (x, dt, Bm and Cm of one
// dtype; A either); y is bf16 when y_bf16. Strides are in elements: x, dt
// (b, s, d); A (d, n); Bm, Cm (b, s, n). y is a contiguous [B, S, Di],
// h_last a contiguous f32 [B, Di, N]. N from 1 to 16 (mamba1's state
// sizes). vec_xdt, vec_bc: the pair may be copied in 16-byte chunks.
// smem_bytes is the wrapper's plan of a block's shared memory. Anything
// else returns cudaErrorInvalidValue.
extern "C" int mamba_scan_fwd(
    const void* x, int x_dtype, int64_t xsb, int64_t xss, int64_t xsd,
    const void* dt, int dt_dtype, int64_t dsb, int64_t dss, int64_t dsd,
    const void* A, int a_dtype, int64_t asd, int64_t asn, const void* Bm,
    int b_dtype, int64_t bsb, int64_t bss, int64_t bsn, const void* Cm,
    int c_dtype, int64_t csb, int64_t css, int64_t csn, void* y, int y_bf16,
    float* h_last, int B, int S, int Di, int N, int vec_xdt, int vec_bc,
    int smem_bytes, void* stream) {
  const In xi{x, x_dtype, xsb, xss, xsd}, di{dt, dt_dtype, dsb, dss, dsd},
      ai{A, a_dtype, asd, asn, 0}, bi{Bm, b_dtype, bsb, bss, bsn},
      ci{Cm, c_dtype, csb, css, csn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > NS || dt_dtype != x_dtype || b_dtype != x_dtype ||
      c_dtype != x_dtype)
    return (int)cudaErrorInvalidValue;
  if (x_dtype == 0)
    return launch<float>(xi, di, ai, bi, ci, vec_xdt, vec_bc, y, y_bf16,
                         h_last, B, S, Di, N, smem_bytes, st);
  return launch<__nv_bfloat16>(xi, di, ai, bi, ci, vec_xdt, vec_bc, y,
                               y_bf16, h_last, B, S, Di, N, smem_bytes, st);
}
