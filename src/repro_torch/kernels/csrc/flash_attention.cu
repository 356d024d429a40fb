// Forward causal / sliding-window GQA attention (flash style) in f32, for
// Hopper (sm_90a).
//
// flash_attention_fwd replaces the TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:63) for f32 inputs: o = softmax(q
// k^T / sqrt(D) + mask) v with an online softmax in f32, q head h reading
// kv head h / (H / KV), positions counted from 0 in q and k, the causal
// mask kpos <= qpos and the window mask kpos > qpos - window. bf16 inputs
// go to the tensor-core kernel of csrc/flash_attention_sm90.cu; f32 stays
// here because the f32 serve and hybrid checks hold the kernel to 1e-6 of
// its plain version per element, which products rounded to bf16 (or TF32)
// on the tensor cores cannot meet. The wrapper dispatches by dtype.
//
// One block computes BQ = 64 query rows of one head against the key tiles
// it needs, BK = 64 keys at a time: q, k and v tiles are copied to shared
// memory (q scaled by 1/sqrt(D) as it is loaded), each of the 256 threads
// computes a 4x4 patch of the 64x64 score tile with f32 FMAs, masks it,
// updates the running max and denominator of its four rows (the 16
// threads that share a row reduce with warp shuffles), writes the
// probabilities to shared memory and adds their product with the v tile to
// its 4 x D/16 patch of the output, kept in registers. Tiles above the
// diagonal (causal) and before the window's start are never loaded, as in
// the TPU kernel; a tile past the end of k (ragged Sk) or of q (ragged Sq)
// is masked, so any prompt length works.
//
// The inputs are read through their strides (the last dimension must be
// contiguous): the serve path hands in [B, S, H, D] projections viewed as
// [B, H, S, D], with no transposed copies. Rows are loaded 16 bytes a
// thread when every row start is 16-byte aligned, else one element at a
// time.
//
// Bound: f32 FMAs on the CUDA cores (67 TFLOP/s) at the f32 checks' shapes
// (for example B 1, 8 heads over 2, S 512, D 64: 0.004 ms); the kernel
// reaches a few percent of it, since shared-memory loads pace its inner
// loops. The f32 path is a correctness path, not the serve path's.
//
// Plain C interface, for ctypes: the function launches on the given stream
// and returns cudaGetLastError() (0 on success). It never synchronises and
// allocates nothing; the caller allocates the output.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// Rows [row0, row0 + ROWS) of a [rows, D] matrix whose rows are `stride`
// elements apart, multiplied by `mul`, into shared memory rows `ld` floats
// apart; rows at or past `n_rows` are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int64_t stride, int row0,
                                          int n_rows, float mul, bool vec) {
  if (vec) {
    constexpr int kPer = 4;                // floats per 16-byte load
    constexpr int kChunks = D / kPer;      // loads per row
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kPer;
      const int row = row0 + r;
      float* out = dst + r * ld + c;
      if (row < n_rows) {
        const float4 e =
            *reinterpret_cast<const float4*>(src + row * stride + c);
        out[0] = __fmul_rn(e.x, mul);
        out[1] = __fmul_rn(e.y, mul);
        out[2] = __fmul_rn(e.z, mul);
        out[3] = __fmul_rn(e.w, mul);
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) out[j] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int row = row0 + r;
      dst[r * ld + c] =
          row < n_rows ? __fmul_rn(src[row * stride + c], mul) : 0.f;
    }
  }
}

struct Strides {  // element strides of a [B, heads, S, D] view
  int64_t b, h, s;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides qs, Strides ks, Strides vs, Strides os, int H,
                     int KV, int Sq, int Sk, int causal, int window,
                     float scale, int vec_q, int vec_kv) {
  constexpr int kCols = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);           // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);           // [BK][D]
  float* Ps = Vs + BK * D;                 // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  load_rows<D, BQ>(Qs, D + 1, qb, qs.s, q0, Sq, scale, vec_q);

  float acc[4][kCols], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // the key tiles any row of this block can see
  const int last_q = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, last_q + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    load_rows<D, BK>(Ks, D + 1, kb, ks.s, k0, Sk, 1.f, vec_kv);
    load_rows<D, BK>(Vs, D, vb, vs.s, k0, Sk, 1.f, vec_kv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        // a masked key scores -1e30, as in the plain version; a key past
        // the end of k (the last tile's tail) scores -inf, so that it
        // weighs 0 even in a row that sees no key
        if (kp >= Sk)
          s[i][j] = -CUDART_INF_F;
        else if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are 16 neighbouring lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      ob[qp * os.s + tx + 16 * j] = acc[i][j] / denom;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, int B, int H, int KV, int Sq,
           int Sk, int causal, int window, float scale, int vec_q,
           int vec_kv, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D>;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os, H,
      KV, Sq, Sk, causal, window, scale, vec_q, vec_kv);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 q, k, v and o; head_dim 64 or 128 (anything else returns
// cudaErrorInvalidValue). Strides are in elements, per tensor (b, head,
// s); the last dimension is contiguous. window <= 0: no window.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int head_dim, int64_t qsb, int64_t qsh,
    int64_t qss, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
    int64_t vsh, int64_t vss, int64_t osb, int64_t osh, int64_t oss,
    int causal, int window, float scale, int vec_q, int vec_kv,
    void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch<64>(q, k, v, o, qs, ks, vs, os, B, H, KV, Sq, Sk, causal,
                      window, scale, vec_q, vec_kv, st);
  if (head_dim == 128)
    return launch<128>(q, k, v, o, qs, ks, vs, os, B, H, KV, Sq, Sk, causal,
                       window, scale, vec_q, vec_kv, st);
  return (int)cudaErrorInvalidValue;
}
