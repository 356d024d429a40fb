// One-token GQA decode attention over an int8 KV cache, for Hopper
// (sm_90a).
//
// quant_decode_attention replaces the TPU kernel of the same name
// (src/repro/kernels/quant_decode.py:64): for each row b and query head h,
// o = softmax(q k^T / sqrt(Dh)) v over the cache slots s < pos[b], where
// k = k8 * k_scale and v = v8 * v_scale are dequantized in the kernel (int8
// levels, one f32 scale per (token, head)), with an online softmax in f32.
// The output has q's dtype (f32 or bf16).
//
// One block serves one (row, kv head) and one run of the cache: the
// g = H / KV query heads of the group share every K/V tile it loads, so the
// cache is read once per row and kv head whatever g is (5 at qwen2.5-14b's
// width, 48 for an MQA model; g is a runtime value and the group's queries,
// accumulators and probabilities live in shared memory sized by the
// caller). B * KV pairs alone (64 at the serve path's 8 slots, 4 for MQA
// at B 4) would leave most of the 132 SMs idle while each block walks a
// whole cache, so the caller cuts each row's tiles into n_split runs (about
// two blocks per SM in all); each block writes its running max,
// denominator and unnormalized output, and combine_kernel merges them
// (split-K decoding; one run writes the output directly). A run is walked
// BS = 64 slots at a time: the tile is dequantized into shared
// memory, the 256 threads compute the group's g x 64 scores, one warp per
// head updates that head's running max and denominator with shuffles, and
// each thread adds the probabilities' product with the V tile to the
// accumulators it owns. Tiles at or past pos[b] are never read (their
// slots are masked to -1e30 and would contribute exactly 0); the tile that
// holds pos[b] is masked slot by slot. pos is read from device memory, one
// int per row (stride 0 for a scalar shared by every row), so the caller
// never waits for the card. pos <= 0 masks every slot, as the plain
// version does, and then every tile is read.
//
// The cache is read through its strides: the serve path hands in one
// layer's slice of the [B, W, KV, Dh] pool viewed as [B, KV, W, Dh] (and
// the [B, W, KV] scales as [B, KV, W]), so no copy of the cache is made.
// A slot's Dh levels are loaded 16 bytes a thread when every slot start is
// 16-byte aligned, else one byte at a time.
//
// Bound: memory. Per row it reads 2 * pos * Dh bytes of levels and
// 8 * pos bytes of scales per kv head, and does 4 * g * Dh operations per
// slot, far below the card's operations-per-byte balance.
//
// Plain C interface, for ctypes: the function launches on the given stream
// and returns cudaGetLastError() (0 on success). It never synchronises and
// allocates nothing; the caller allocates the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BS = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {  // element strides of a [B, KV, S(, Dh)] view
  int64_t b, h, s;
};

// Slots [s0, s0 + BS) of one (row, kv head), dequantized into shared rows
// `ld` floats apart; slots at or past S are zero.
template <int D>
__device__ __forceinline__ void dequant_tile(float* dst, int ld,
                                             const int8_t* lv,
                                             const float* sc, Strides ls,
                                             int64_t sc_s, int s0, int S,
                                             bool vec) {
  if (vec) {
    constexpr int kChunks = D / 16;
    for (int i = threadIdx.x; i < BS * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 16;
      const int slot = s0 + r;
      float* out = dst + r * ld + c;
      if (slot < S) {
        const float s = sc[slot * sc_s];
        int4 raw = *reinterpret_cast<const int4*>(lv + slot * ls.s + c);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int j = 0; j < 16; ++j) out[j] = __fmul_rn((float)e[j], s);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) out[j] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < BS * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int slot = s0 + r;
      dst[r * ld + c] =
          slot < S ? __fmul_rn((float)lv[slot * ls.s + c], sc[slot * sc_s])
                   : 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    quant_decode_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                        const float* __restrict__ ksc,
                        const int8_t* __restrict__ v8,
                        const float* __restrict__ vsc,
                        const int* __restrict__ pos, int64_t pos_stride,
                        T* __restrict__ o, float* __restrict__ part,
                        int64_t qsb, int64_t qsh, int64_t osb, int64_t osh,
                        Strides kls, Strides kss, Strides vls, Strides vss,
                        int H, int KV, int S, float scale, int vec,
                        int tiles_per_split) {
  const int g = H / KV;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [g][D]
  float* Acc = Qs + g * D;           // [g][D]
  float* Ks = Acc + g * D;           // [BS][D + 1]
  float* Vs = Ks + BS * (D + 1);     // [BS][D]
  float* Ps = Vs + BS * D;           // [g][BS]
  float* M = Ps + g * BS;            // [g] running max
  float* L = M + g;                  // [g] running denominator
  float* C = L + g;                  // [g] this tile's correction

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int p = pos[b * pos_stride];
  const int valid = min(p, S);
  const int n_slots = p > 0 ? valid : S;
  // this block's share of the row's slots (empty past n_slots)
  const int s_begin = split * tiles_per_split * BS;
  const int s_end = min(s_begin + tiles_per_split * BS, n_slots);

  for (int i = threadIdx.x; i < g * D; i += kThreads) {
    const int hh = kvh * g + i / D;
    Qs[i] = __fmul_rn(widen(q[b * qsb + hh * qsh + i % D]), scale);
    Acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < g; i += kThreads) {
    M[i] = kNegInf;
    L[i] = 0.f;
  }
  const int8_t* kl = k8 + b * kls.b + kvh * kls.h;
  const int8_t* vl = v8 + b * vls.b + kvh * vls.h;
  const float* kscale = ksc + b * kss.b + kvh * kss.h;
  const float* vscale = vsc + b * vss.b + kvh * vss.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int s0 = s_begin; s0 < s_end; s0 += BS) {
    __syncthreads();   // the previous tile's readers are done
    dequant_tile<D>(Ks, D + 1, kl, kscale, kls, kss.s, s0, S, vec);
    dequant_tile<D>(Vs, D, vl, vscale, vls, vss.s, s0, S, vec);
    __syncthreads();

    for (int i = threadIdx.x; i < g * BS; i += kThreads) {
      const int hh = i / BS, r = i % BS;
      const float* qh = Qs + hh * D;
      const float* kr = Ks + r * (D + 1);
      // four partial sums: four independent FMA chains in flight
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s4[j] = fmaf(qh[d + j], kr[d + j], s4[j]);
      }
      const float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      // a masked slot scores -1e30, as in the plain version; a slot past
      // the cache's end (the last tile's tail) scores -inf, so that it
      // weighs 0 even when every slot is masked (pos <= 0)
      Ps[i] = s0 + r < valid ? s
                             : (s0 + r < S ? kNegInf : -CUDART_INF_F);
    }
    __syncthreads();

    for (int hh = warp; hh < g; hh += kWarps) {
      float* ph = Ps + hh * BS;
      float a = ph[lane], c = ph[lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = M[hh];
      const float m_new = fmaxf(m_old, mx);
      a = expf(a - m_new);
      c = expf(c - m_new);
      ph[lane] = a;
      ph[lane + 32] = c;
      float sum = a + c;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        C[hh] = corr;
        L[hh] = L[hh] * corr + sum;
        M[hh] = m_new;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < g * D; i += kThreads) {
      const int hh = i / D, d = i % D;
      const float* ph = Ps + hh * BS;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int r = 0; r < BS; r += 2) {
        a0 = fmaf(ph[r], Vs[r * D + d], a0);
        a1 = fmaf(ph[r + 1], Vs[(r + 1) * D + d], a1);
      }
      Acc[i] = fmaf(Acc[i], C[hh], a0 + a1);
    }
  }
  __syncthreads();

  if (gridDim.z == 1) {
    for (int i = threadIdx.x; i < g * D; i += kThreads) {
      const int hh = i / D;
      o[b * osb + (kvh * g + hh) * osh + i % D] =
          narrow<T>(Acc[i] / fmaxf(L[hh], 1e-30f));
    }
    return;
  }
  // split: this block's running max, denominator and unnormalized output
  // per head, [m, l, acc[D]], for combine_kernel
  float* pb = part + (((int64_t)b * KV + kvh) * gridDim.z + split) *
                         g * (D + 2);
  for (int i = threadIdx.x; i < g * D; i += kThreads)
    pb[(i / D) * (D + 2) + 2 + i % D] = Acc[i];
  for (int i = threadIdx.x; i < g; i += kThreads) {
    pb[i * (D + 2)] = M[i];
    pb[i * (D + 2) + 1] = L[i];
  }
}

// Merges the n_split partial results of each (row, head): rescales each by
// exp(m_s - max_s m_s) and divides the summed outputs by the summed
// denominators. A split that saw no slot has l = 0 and acc = 0.
template <typename T, int D>
__global__ void combine_kernel(const float* __restrict__ part,
                               T* __restrict__ o, int64_t osb, int64_t osh,
                               int H, int KV, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, g = H / KV;
  const int64_t stride = (int64_t)g * (D + 2);
  const float* pb = part + ((int64_t)b * KV + h / g) * n_split * stride +
                    (h % g) * (D + 2);
  float mx = -CUDART_INF_F;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pb[s * stride]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(pb[s * stride] - mx);
      num = fmaf(w, pb[s * stride + 2 + d], num);
      den = fmaf(w, pb[s * stride + 1], den);
    }
    o[b * osb + h * osh + d] = narrow<T>(num / fmaxf(den, 1e-30f));
  }
}

template <int D>
size_t smem_bytes(int g) {
  return sizeof(float) *
         (2 * g * D + BS * (D + 1) + BS * D + g * BS + 3 * g);
}

template <typename T, int D>
int launch(const void* q, const int8_t* k8, const float* ksc,
           const int8_t* v8, const float* vsc, const int* pos,
           int64_t pos_stride, void* o, float* part, int64_t qsb,
           int64_t qsh, int64_t osb, int64_t osh, Strides kls, Strides kss,
           Strides vls, Strides vss, int B, int H, int KV, int S, float scale,
           int vec, int n_split, int tiles_per_split, cudaStream_t stream) {
  auto kernel = quant_decode_kernel<T, D>;
  const size_t bytes = smem_bytes<D>(H / KV);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV, B, n_split);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), k8, ksc, v8, vsc, pos, pos_stride,
      static_cast<T*>(o), part, qsb, qsh, osb, osh, kls, kss, vls, vss, H,
      KV, S, scale, vec, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  combine_kernel<T, D><<<dim3(H, B), D, 0, stream>>>(
      part, static_cast<T*>(o), osb, osh, H, KV, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs for a group of g query heads, in bytes
// (the wrapper refuses a group that does not fit in a block).
extern "C" int64_t quant_decode_smem_bytes(int head_dim, int g) {
  if (head_dim == 64) return (int64_t)smem_bytes<64>(g);
  if (head_dim == 128) return (int64_t)smem_bytes<128>(g);
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16 (q and o). head_dim: 64 or 128
// (anything else returns cudaErrorInvalidValue). Strides are in elements:
// q and o (b, head) with the last dimension contiguous; levels and scales
// (b, kv head, slot). pos holds int32 values pos_stride apart. Each row's
// slots are cut into n_split runs of tiles_per_split tiles of 64; with
// n_split > 1, part holds B * KV * n_split * (H / KV) * (head_dim + 2)
// floats of scratch.
extern "C" int quant_decode_attention(
    const void* q, const void* k8, const void* k_scale, const void* v8,
    const void* v_scale, const void* pos, int64_t pos_stride, void* o,
    void* part, int n_split, int tiles_per_split, int dtype, int B, int H, int KV, int S, int head_dim, int64_t qsb,
    int64_t qsh, int64_t osb, int64_t osh, int64_t klb, int64_t klh,
    int64_t kls, int64_t ksb, int64_t ksh, int64_t kss, int64_t vlb,
    int64_t vlh, int64_t vls, int64_t vsb, int64_t vsh, int64_t vss,
    float scale, int vec, void* stream) {
  const Strides kl{klb, klh, kls}, ks{ksb, ksh, kss}, vl{vlb, vlh, vls},
      vs{vsb, vsh, vss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* k = static_cast<const int8_t*>(k8);
  const int8_t* v = static_cast<const int8_t*>(v8);
  const float* kc = static_cast<const float*>(k_scale);
  const float* vc = static_cast<const float*>(v_scale);
  const int* p = static_cast<const int*>(pos);
#define QD_LAUNCH(T, D)                                                     \
  return launch<T, D>(q, k, kc, v, vc, p, pos_stride, o,                  \
                      static_cast<float*>(part), qsb, qsh, osb, osh, kl, ks, \
                      vl, vs, B, H, KV, S, scale, vec, n_split,             \
                      tiles_per_split, st)
  if (dtype == 0 && head_dim == 64) QD_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) QD_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) QD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) QD_LAUNCH(__nv_bfloat16, 128);
#undef QD_LAUNCH
  return (int)cudaErrorInvalidValue;
}
