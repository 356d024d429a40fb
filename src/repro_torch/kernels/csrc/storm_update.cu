// Fused elementwise update kernels of AdaFBiO for Hopper (sm_90a).
//
// storm_update_f32 replaces the TPU kernel storm_update
// (src/repro/kernels/storm_update.py:45): est' = g_new + (1-beta)(est - g_old).
// adafbio_update_f32 replaces adafbio_update (same file, line 80), Eq. 14:
// p' = p - lr_eta * w / (sqrt(a) + rho).
//
// Both are bound by memory, at 16 bytes per element: storm reads three
// f32 streams and writes one; adafbio reads p and w and writes p' (12 B),
// and reads `a`, the fourth stream. `a` is one [n] row shared by every
// client row (row stride 0: read once from device memory, then from L2 for
// every further client row) or one row per client (row stride n, the
// gossip engine's per-node accumulators: 16 B per element in all). The
// design does what a memory-bound pass can: one launch covers all M client
// rows of the packed [M, n] buffer, each thread moves 16 bytes per load
// (float4) where the pointers are 16-byte aligned, a grid-stride loop keeps
// enough loads in flight, and the ragged tail is masked. The scalars (beta,
// lr_eta, rho) are read from device pointers, as the Pallas kernels read
// them from SMEM refs, so the host never waits for the card to learn them.
//
// The arithmetic uses the _rn intrinsics so that no multiply-add is
// contracted into an FMA: each result is rounded as the plain PyTorch
// version (kernels/ref.py) rounds it, operation by operation. sqrtf and the
// division stay IEEE (the build passes no --use_fast_math).
//
// Plain C interface, for ctypes: each function launches on the given stream
// and returns cudaGetLastError() (0 on success). It never synchronises and
// allocates nothing; the caller allocates the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident-ish blocks per SM

__device__ __forceinline__ float storm_one(float gn, float go, float est,
                                           float one_minus_beta) {
  return __fadd_rn(gn, __fmul_rn(one_minus_beta, __fsub_rn(est, go)));
}

__device__ __forceinline__ float adafbio_one(float p, float w, float a,
                                             float lr_eta, float rho) {
  float upd = __fdiv_rn(w, __fadd_rn(__fsqrt_rn(a), rho));
  return __fsub_rn(p, __fmul_rn(lr_eta, upd));
}

// Flat pass over all M*n elements (STORM is elementwise over the buffer):
// float4 over the first n4 quads, then the masked scalar tail [4*n4, total).
// The host passes n4 = 0 when a pointer is not 16-byte aligned.
__global__ void storm_kernel(const float* __restrict__ gn,
                             const float* __restrict__ go,
                             const float* __restrict__ est,
                             const float* __restrict__ beta,
                             float* __restrict__ out, int64_t n4,
                             int64_t total) {
  const float omb = __fsub_rn(1.0f, beta[0]);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float4* gn4 = reinterpret_cast<const float4*>(gn);
  const float4* go4 = reinterpret_cast<const float4*>(go);
  const float4* est4 = reinterpret_cast<const float4*>(est);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int64_t i = tid; i < n4; i += stride) {
    float4 a = gn4[i], b = go4[i], e = est4[i], r;
    r.x = storm_one(a.x, b.x, e.x, omb);
    r.y = storm_one(a.y, b.y, e.y, omb);
    r.z = storm_one(a.z, b.z, e.z, omb);
    r.w = storm_one(a.w, b.w, e.w, omb);
    out4[i] = r;
  }
  for (int64_t i = 4 * n4 + tid; i < total; i += stride) {
    out[i] = storm_one(gn[i], go[i], est[i], omb);
  }
}

// One grid row (blockIdx.y) per client row; client row r reads the `a` row
// at a + r * a_stride (a_stride 0: one row shared by all; n: a row each).
// float4 over the first n4 quads of the row, then the masked scalar tail
// [4*n4, n). The host passes n4 = 0 unless n % 4 == 0 and every pointer is
// 16-byte aligned (then every row start is aligned too).
__global__ void adafbio_kernel(const float* __restrict__ p,
                               const float* __restrict__ w,
                               const float* __restrict__ a_base,
                               const float* __restrict__ lr_eta_ptr,
                               const float* __restrict__ rho_ptr,
                               float* __restrict__ out, int64_t n,
                               int64_t n4, int64_t a_stride) {
  const float lr_eta = lr_eta_ptr[0], rho = rho_ptr[0];
  const int64_t row = (int64_t)blockIdx.y * n;
  const float* a = a_base + (int64_t)blockIdx.y * a_stride;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float4* p4 = reinterpret_cast<const float4*>(p + row);
  const float4* w4 = reinterpret_cast<const float4*>(w + row);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  float4* o4 = reinterpret_cast<float4*>(out + row);
  for (int64_t i = tid; i < n4; i += stride) {
    float4 pv = p4[i], wv = w4[i], av = a4[i], r;
    r.x = adafbio_one(pv.x, wv.x, av.x, lr_eta, rho);
    r.y = adafbio_one(pv.y, wv.y, av.y, lr_eta, rho);
    r.z = adafbio_one(pv.z, wv.z, av.z, lr_eta, rho);
    r.w = adafbio_one(pv.w, wv.w, av.w, lr_eta, rho);
    o4[i] = r;
  }
  for (int64_t i = 4 * n4 + tid; i < n; i += stride) {
    out[row + i] = adafbio_one(p[row + i], w[row + i], a[i], lr_eta, rho);
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

inline unsigned blocks_for(int64_t work, int64_t cap) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > cap) b = cap;
  return (unsigned)b;
}

}  // namespace

extern "C" {

// out[i] = g_new[i] + (1 - beta[0]) * (est[i] - g_old[i]) for i < total
// (total = M * n: the packed client rows, contiguous).
int storm_update_f32(const float* g_new, const float* g_old, const float* est,
                     const float* beta, float* out, int64_t total,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total <= 0) return (int)cudaGetLastError();
  const bool vec = aligned16(g_new) && aligned16(g_old) && aligned16(est) &&
                   aligned16(out);
  const int64_t n4 = vec ? total / 4 : 0;
  storm_kernel<<<blocks_for(vec ? n4 : total, kMaxBlocks), kThreads, 0, s>>>(
      g_new, g_old, est, beta, out, n4, total);
  return (int)cudaGetLastError();
}

// out[r, i] = p[r, i] - lr_eta[0] * w[r, i] / (sqrt(a[r * a_stride + i])
// + rho[0]) for r < rows, i < n; p, w, out are [rows, n] contiguous, a is
// one [n] row (a_stride 0) or [rows, n] contiguous (a_stride n).
int adafbio_update_f32(const float* p, const float* w, const float* a,
                       const float* lr_eta, const float* rho, float* out,
                       int64_t rows, int64_t n, int64_t a_stride,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  if (a_stride != 0 && a_stride != n) return (int)cudaErrorInvalidValue;
  const int64_t cap = kMaxBlocks / rows > 0 ? kMaxBlocks / rows : 1;
  const bool vec = n % 4 == 0 && aligned16(p) && aligned16(w) &&
                   aligned16(a) && aligned16(out);
  const int64_t n4 = vec ? n / 4 : 0;
  dim3 grid(blocks_for(vec ? n4 : n, cap), (unsigned)rows);
  adafbio_kernel<<<grid, kThreads, 0, s>>>(p, w, a, lr_eta, rho, out, n, n4,
                                           a_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
