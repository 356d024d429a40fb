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
// The leaf-table entries (storm_update_leaves, adafbio_update_leaves) run
// the same arithmetic over a tree's leaves where they lie, with no packed
// f32 copy: at language-model width one f32 copy of the backbone is 14 GB,
// and the pack-kernel-unpack route holds four of them. Each leaf is an
// entry of two device tables: `ptrs` [L, 4] (the three operands' and the
// output's addresses, written each call) and `info` [L, 4] (elements per
// row, rows, the leaf's first work unit, dtype flags; built once per tree
// layout). A work unit is 8 consecutive elements of a leaf; one launch
// walks the prefix sum of the leaves' units with a grid-stride loop and a
// cursor that only steps forward (as csrc/quantize.cu's segments), loads
// and stores 16 bytes at a time (one uint4 of bf16, two float4 of f32)
// where a leaf's operands are 16-byte aligned, and goes element by element
// elsewhere. Each operand is f32 or bf16 by its own flag; the math is f32
// with the same _rn intrinsics, and each output is rounded once, to
// nearest even, into its leaf's dtype: bit for bit what packing to f32,
// the packed kernel and casting back give. Bytes per element: 4 bf16
// streams, 8 B; 4 f32 streams, 16 B.
//
// Plain C interface, for ctypes: each function launches on the given stream
// and returns cudaGetLastError() (0 on success). It never synchronises and
// allocates nothing; the caller allocates the output.

#include <cuda_bf16.h>
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

// ------------------------------------------------------------ leaf tables

constexpr int kUnit = 8;           // elements a work unit
constexpr int64_t kPerRowA = 16;   // info flag, adafbio: `a` has a row per row

struct LeafPtrs {
  const void* in0;   // storm: g_new; adafbio: p
  const void* in1;   // storm: g_old; adafbio: w
  const void* in2;   // storm: est;   adafbio: a
  void* out;
};

struct LeafInfo {
  int64_t n;         // elements per row
  int64_t rows;
  int64_t start;     // the leaf's first unit in the launch's prefix sum
  int64_t flags;     // bit k (k < 4): operand k (in0, in1, in2, out) bf16
};

__device__ __forceinline__ bool is_bf16(int64_t flags, int k) {
  return (flags >> k) & 1;
}

__device__ __forceinline__ float load1(const void* p, bool bf, int64_t i) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store1(void* p, bool bf, int64_t i,
                                       float v) {
  if (bf) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// 8 elements from e (a multiple of 8) of a 16-byte aligned operand
__device__ __forceinline__ void load8(const void* p, bool bf, int64_t e,
                                      float* v) {
  if (bf) {
    uint4 r = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p) + e);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + e);
    float4 a = q[0], b = q[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

__device__ __forceinline__ void store8(void* p, bool bf, int64_t e,
                                       const float* v) {
  if (bf) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k],
                                                            v[2 * k + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p) + e) = r;
  } else {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(p) + e);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ bool al16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The leaf a unit lies in, for units that only grow (one per thread).
struct LeafCursor {
  const LeafPtrs* ptrs;
  const LeafInfo* info;
  int64_t n_leaves, total;
  int64_t leaf, begin, end;
  LeafPtrs p;
  LeafInfo li;

  __device__ LeafCursor(const LeafPtrs* pt, const LeafInfo* in, int64_t nl,
                        int64_t tot)
      : ptrs(pt), info(in), n_leaves(nl), total(tot), leaf(-1), begin(0),
        end(0) {}

  // steps forward to the leaf of unit u (also over empty leaves); true
  // when it moved
  __device__ __forceinline__ bool seek(int64_t u) {
    bool moved = false;
    while (u >= end) {
      ++leaf;
      li = info[leaf];
      begin = li.start;
      end = leaf + 1 < n_leaves ? info[leaf + 1].start : total;
      moved = true;
    }
    if (moved) p = ptrs[leaf];
    return moved;
  }
};

__global__ void storm_leaves_kernel(const LeafPtrs* __restrict__ ptrs,
                                    const LeafInfo* __restrict__ info,
                                    int64_t n_leaves, int64_t total,
                                    const float* __restrict__ beta) {
  const float omb = __fsub_rn(1.0f, beta[0]);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  LeafCursor cur(ptrs, info, n_leaves, total);
  bool vec = false, b0 = false, b1 = false, b2 = false, b3 = false;
  for (int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; u < total;
       u += stride) {
    if (cur.seek(u)) {
      const int64_t f = cur.li.flags;
      b0 = is_bf16(f, 0); b1 = is_bf16(f, 1);
      b2 = is_bf16(f, 2); b3 = is_bf16(f, 3);
      vec = al16(cur.p.in0) && al16(cur.p.in1) && al16(cur.p.in2) &&
            al16(cur.p.out);
    }
    const int64_t numel = cur.li.n * cur.li.rows;
    const int64_t e0 = (u - cur.begin) * kUnit;
    if (vec && e0 + kUnit <= numel) {
      float gn[kUnit], go[kUnit], es[kUnit], r[kUnit];
      load8(cur.p.in0, b0, e0, gn);
      load8(cur.p.in1, b1, e0, go);
      load8(cur.p.in2, b2, e0, es);
#pragma unroll
      for (int k = 0; k < kUnit; ++k) r[k] = storm_one(gn[k], go[k], es[k],
                                                       omb);
      store8(cur.p.out, b3, e0, r);
    } else {
      const int64_t e1 = e0 + kUnit < numel ? e0 + kUnit : numel;
      for (int64_t e = e0; e < e1; ++e) {
        store1(cur.p.out, b3, e,
               storm_one(load1(cur.p.in0, b0, e), load1(cur.p.in1, b1, e),
                         load1(cur.p.in2, b2, e), omb));
      }
    }
  }
}

// `a` is one row shared by every row (index e % n) or one row per row
// (index e, kPerRowA)
__global__ void adafbio_leaves_kernel(const LeafPtrs* __restrict__ ptrs,
                                      const LeafInfo* __restrict__ info,
                                      int64_t n_leaves, int64_t total,
                                      const float* __restrict__ lr_eta_ptr,
                                      const float* __restrict__ rho_ptr) {
  const float lr_eta = lr_eta_ptr[0], rho = rho_ptr[0];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  LeafCursor cur(ptrs, info, n_leaves, total);
  bool vec = false, shared = false, b0 = false, b1 = false, b2 = false,
       b3 = false;
  for (int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; u < total;
       u += stride) {
    if (cur.seek(u)) {
      const int64_t f = cur.li.flags;
      b0 = is_bf16(f, 0); b1 = is_bf16(f, 1);
      b2 = is_bf16(f, 2); b3 = is_bf16(f, 3);
      shared = !(f & kPerRowA) && cur.li.rows > 1;
      // a unit stays in one row of a shared `a` when rows are whole units
      vec = al16(cur.p.in0) && al16(cur.p.in1) && al16(cur.p.in2) &&
            al16(cur.p.out) && (!shared || cur.li.n % kUnit == 0);
    }
    const int64_t n = cur.li.n;
    const int64_t numel = n * cur.li.rows;
    const int64_t e0 = (u - cur.begin) * kUnit;
    if (vec && e0 + kUnit <= numel) {
      const int64_t a0 = shared ? e0 % n : e0;
      float pv[kUnit], wv[kUnit], av[kUnit], r[kUnit];
      load8(cur.p.in0, b0, e0, pv);
      load8(cur.p.in1, b1, e0, wv);
      load8(cur.p.in2, b2, a0, av);
#pragma unroll
      for (int k = 0; k < kUnit; ++k) r[k] = adafbio_one(pv[k], wv[k], av[k],
                                                         lr_eta, rho);
      store8(cur.p.out, b3, e0, r);
    } else {
      const int64_t e1 = e0 + kUnit < numel ? e0 + kUnit : numel;
      for (int64_t e = e0; e < e1; ++e) {
        store1(cur.p.out, b3, e,
               adafbio_one(load1(cur.p.in0, b0, e), load1(cur.p.in1, b1, e),
                           load1(cur.p.in2, b2, shared ? e % n : e), lr_eta,
                           rho));
      }
    }
  }
}

}  // namespace

extern "C" {

// STORM over a table of leaves: for each leaf l and element e of it,
// out[e] = g_new[e] + (1 - beta[0]) * (est[e] - g_old[e]). `ptrs` and
// `info` are the [n_leaves, 4] int64 device tables of the header comment;
// `total` is the units of all leaves (info[l].start is leaf l's first).
int storm_update_leaves(const int64_t* ptrs, const int64_t* info,
                        int64_t n_leaves, int64_t total, const float* beta,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_leaves <= 0 || total <= 0) return (int)cudaGetLastError();
  storm_leaves_kernel<<<blocks_for(total, kMaxBlocks), kThreads, 0, s>>>(
      reinterpret_cast<const LeafPtrs*>(ptrs),
      reinterpret_cast<const LeafInfo*>(info), n_leaves, total, beta);
  return (int)cudaGetLastError();
}

// Eq. 14 over a table of leaves: out = p - lr_eta[0] * w / (sqrt(a) +
// rho[0]); each leaf's p, w, out are [rows, n], its `a` one [n] row shared
// by every row, or [rows, n] with the kPerRowA flag.
int adafbio_update_leaves(const int64_t* ptrs, const int64_t* info,
                          int64_t n_leaves, int64_t total,
                          const float* lr_eta, const float* rho,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_leaves <= 0 || total <= 0) return (int)cudaGetLastError();
  adafbio_leaves_kernel<<<blocks_for(total, kMaxBlocks), kThreads, 0, s>>>(
      reinterpret_cast<const LeafPtrs*>(ptrs),
      reinterpret_cast<const LeafInfo*>(info), n_leaves, total, lr_eta, rho);
  return (int)cudaGetLastError();
}

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
