// Stochastic int8 quantize / dequantize of the lossy update codec, for
// Hopper (sm_90a).
//
// quantize_stoch_i8 replaces the TPU kernel quantize_stoch
// (src/repro/kernels/quantize.py:37): q = clip(floor(x / scale + u), ±qmax)
// as int8, with u uniform[0, 1) noise handed in. dequantize_i8 replaces
// dequantize (same file, line 69): x = q * scale back to f32.
//
// The TPU kernels run once per leaf per client, each over one 1-D buffer
// with one scalar scale. Here one launch covers the whole client-stacked
// message: the [M, n] buffer holds every client's leaves packed side by
// side, a leaf is the segment [offsets[s], offsets[s+1]) of each row, and
// its scale is scale[row * L + s]. Each thread walks its row with a
// grid-stride loop, so the element index it visits only grows; it keeps the
// current segment's end and scale in registers and steps the cursor forward
// when an element crosses into the next segment, reading the small offset
// table (L+1 int64) only then.
//
// Both are bound by memory: quantize reads x and u and writes q (9 bytes
// per element), dequantize reads q and writes f32 (5 bytes). The design
// does what a memory-bound pass can: one launch for all rows and leaves,
// 16-byte loads of x and u (float4) and 4-byte stores of q (char4) where the
// row length is a multiple of 4 and the pointers are aligned, a grid-stride
// loop to keep loads in flight, and a masked scalar tail (or a scalar pass
// for ragged rows and misaligned views).
//
// Rounding follows the plain PyTorch versions (kernels/ref.py) operation by
// operation, so the levels are bit-exact: __fdiv_rn divides by the scale (a
// multiply by its reciprocal would move levels at rounding boundaries),
// __fadd_rn adds the noise, then floorf, the clamp and the int8 store;
// dequantize multiplies with __fmul_rn.
//
// Plain C interface, for ctypes: each function launches on the given stream
// and returns cudaGetLastError() (0 on success). It never synchronises and
// allocates nothing; the caller allocates the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// The segment an element of one row lies in, for indices that only grow.
struct SegmentCursor {
  const int64_t* offsets;
  const float* scales;  // this row's L scales
  int seg;
  int64_t end;
  float scale;

  __device__ SegmentCursor(const int64_t* off, const float* row_scales)
      : offsets(off), scales(row_scales), seg(0), end(off[1]),
        scale(row_scales[0]) {}

  __device__ __forceinline__ float at(int64_t e) {
    while (e >= end) {  // also steps over empty segments
      ++seg;
      end = offsets[seg + 1];
      scale = scales[seg];
    }
    return scale;
  }
};

__device__ __forceinline__ signed char quant_one(float x, float u, float s,
                                                 float qmax) {
  float v = floorf(__fadd_rn(__fdiv_rn(x, s), u));
  v = fminf(fmaxf(v, -qmax), qmax);
  return (signed char)__float2int_rn(v);  // v is already an integer
}

// One grid row (blockIdx.y) per client row. char4/float4 over the first n4
// quads of the row, then the masked scalar tail [4*n4, n). The host passes
// n4 = 0 unless n % 4 == 0 and every pointer is 16-byte aligned.
__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ u,
                                const float* __restrict__ scale,
                                const int64_t* __restrict__ offsets,
                                int64_t n_seg, float qmax,
                                signed char* __restrict__ q, int64_t n,
                                int64_t n4) {
  const int64_t row = blockIdx.y;
  const float* xr = x + row * n;
  const float* ur = u + row * n;
  signed char* qr = q + row * n;
  SegmentCursor cur(offsets, scale + row * n_seg);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float4* x4 = reinterpret_cast<const float4*>(xr);
  const float4* u4 = reinterpret_cast<const float4*>(ur);
  char4* q4 = reinterpret_cast<char4*>(qr);
  for (int64_t i = tid; i < n4; i += stride) {
    const int64_t e = 4 * i;
    float4 xv = x4[i], uv = u4[i];
    char4 r;
    r.x = quant_one(xv.x, uv.x, cur.at(e), qmax);
    r.y = quant_one(xv.y, uv.y, cur.at(e + 1), qmax);
    r.z = quant_one(xv.z, uv.z, cur.at(e + 2), qmax);
    r.w = quant_one(xv.w, uv.w, cur.at(e + 3), qmax);
    q4[i] = r;
  }
  for (int64_t e = 4 * n4 + tid; e < n; e += stride) {
    qr[e] = quant_one(xr[e], ur[e], cur.at(e), qmax);
  }
}

__global__ void dequantize_kernel(const signed char* __restrict__ q,
                                  const float* __restrict__ scale,
                                  const int64_t* __restrict__ offsets,
                                  int64_t n_seg, float* __restrict__ out,
                                  int64_t n, int64_t n4) {
  const int64_t row = blockIdx.y;
  const signed char* qr = q + row * n;
  float* outr = out + row * n;
  SegmentCursor cur(offsets, scale + row * n_seg);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const char4* q4 = reinterpret_cast<const char4*>(qr);
  float4* o4 = reinterpret_cast<float4*>(outr);
  for (int64_t i = tid; i < n4; i += stride) {
    const int64_t e = 4 * i;
    char4 qv = q4[i];
    float4 r;
    r.x = __fmul_rn((float)qv.x, cur.at(e));
    r.y = __fmul_rn((float)qv.y, cur.at(e + 1));
    r.z = __fmul_rn((float)qv.z, cur.at(e + 2));
    r.w = __fmul_rn((float)qv.w, cur.at(e + 3));
    o4[i] = r;
  }
  for (int64_t e = 4 * n4 + tid; e < n; e += stride) {
    outr[e] = __fmul_rn((float)qr[e], cur.at(e));
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

inline int64_t row_cap(int64_t rows) {
  return kMaxBlocks / rows > 0 ? kMaxBlocks / rows : 1;
}

}  // namespace

extern "C" {

// q[r, i] = clip(floor(x[r, i] / scale[r, s] + u[r, i]), ±qmax) for the
// segment s with offsets[s] <= i < offsets[s+1]; x, u, q are [rows, n]
// contiguous, scale is [rows, n_seg], offsets is [n_seg + 1] with
// offsets[0] = 0 and offsets[n_seg] = n, all in device memory.
int quantize_stoch_i8(const float* x, const float* u, const float* scale,
                      const int64_t* offsets, int64_t n_seg, int64_t rows,
                      int64_t n, int64_t qmax, signed char* out,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  if (rows > 65535 || n_seg <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(x) && aligned16(u) &&
                   aligned16(out);
  const int64_t n4 = vec ? n / 4 : 0;
  dim3 grid(blocks_for(vec ? n4 : n, row_cap(rows)), (unsigned)rows);
  quantize_kernel<<<grid, kThreads, 0, s>>>(x, u, scale, offsets, n_seg,
                                            (float)qmax, out, n, n4);
  return (int)cudaGetLastError();
}

// out[r, i] = q[r, i] * scale[r, s], segments as in quantize_stoch_i8.
int dequantize_i8(const signed char* q, const float* scale,
                  const int64_t* offsets, int64_t n_seg, int64_t rows,
                  int64_t n, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  if (rows > 65535 || n_seg <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(q) && aligned16(out);
  const int64_t n4 = vec ? n / 4 : 0;
  dim3 grid(blocks_for(vec ? n4 : n, row_cap(rows)), (unsigned)rows);
  dequantize_kernel<<<grid, kThreads, 0, s>>>(q, scale, offsets, n_seg, out,
                                              n, n4);
  return (int)cudaGetLastError();
}

}  // extern "C"
