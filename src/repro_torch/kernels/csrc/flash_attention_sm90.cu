// Forward causal / sliding-window GQA attention in bf16 on Hopper's tensor
// cores (sm_90a): wgmma products, TMA tile loads into a ring of shared
// memory, the online softmax in f32 registers.
//
// flash_attention_sm90_fwd replaces the TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:63) for bf16 inputs: o =
// softmax(q k^T / sqrt(D) + mask) v with q head h reading kv head
// h / (H / KV), positions counted from 0 in q and k, the causal mask
// kpos <= qpos and the window mask kpos > qpos - window; a masked key
// scores -1e30 and a key past Sk -inf, as in csrc/flash_attention.cu (the
// f32 kernel, which keeps the f32 inputs). The output is bf16,
// acc / max(l, 1e-30).
//
// Bound: at the serve path's prefill (B 1, S 1536, 40 query heads over 8,
// D 128) the work is 24.2 GFLOP against 38 MB moved, so the tensor cores'
// 989 TFLOP/s bound it (0.024 ms). The first kernel did its products with
// f32 FMAs on the CUDA cores, with q, k and v widened to f32 in shared
// memory (shared-memory bandwidth set its pace) and every tile loaded
// synchronously between two barriers: 1.8% of the bound.
//
// Design. A block owns BQ = 128 query rows of one head and walks the key
// tiles those rows can see, BK = 128 keys at a time, with two consumer
// warpgroups (64 rows each) and a producer warpgroup, which hands its
// registers to the consumers (setmaxnreg: 24 a thread against 240):
// - The producer's one active lane issues every load with TMA
//   (cp.async.bulk.tensor) through 4-D tensor maps over (D, S, heads, B)
//   with the strides the wrapper passes, so the prefill's [B, S, H, D]
//   projections viewed as [B, H, S, D] are read in place. Tiles land in
//   bf16, in the 128-byte swizzle that the wgmma descriptors name, as
//   64-column panels (128 bytes a row); rows past S are filled with zeros.
//   K and V go into a ring of two stages with an mbarrier each way: K of
//   tile t is requested as soon as both warpgroups have finished S of
//   tile t - 2, V of tile t as soon as they have finished P V of tile
//   t - 2, so each arrives at least a tile ahead of its use.
// - S = Q K^T is wgmma m64n128k16 with both operands in shared memory; a
//   K tile [BK, D] stored row by row is already K-major for B.
// - The softmax runs on the f32 accumulator fragment: the scale 1/sqrt(D)
//   and log2 e are folded into the FMA that feeds each ex2 (the scores of
//   a tile with masked pairs are scaled and masked first), a row's max is
//   taken over the 4 lanes that share it, its sum l stays a partial sum
//   per lane (rescaled like the output) until the end, summed from the
//   unrounded f32 probabilities. Only the tiles with masked pairs run the
//   mask code.
// - O += P V is wgmma m64nDk16 with P from registers: the fragment of S,
//   rounded to bf16 in place, is the A operand; V is the B operand,
//   MN-major (the transpose bit 16-bit types allow).
// - Each warpgroup issues S of tile j, then P V of tile j - 1, and runs
//   the softmax of tile j while P V of tile j - 1 is still on the tensor
//   cores; the output is rescaled before the next P V. The two
//   warpgroups take turns to issue (two named barriers), so that one's
//   softmax overlaps the other's products.
// - Masks are applied only on the tiles that need them (the diagonal, the
//   window's first tile, a ragged last tile of k); tiles wholly masked for
//   the block are never loaded. Query rows past Sq are computed on zeros
//   and not stored.
// The output fragment is divided by max(l, 1e-30) and stored as bf16
// pairs.
//
// Shared memory per block (1024-byte aligned tiles; the plan the wrapper
// checks, flash_attention.py sm90_smem_bytes): Q [128, D] + 2 stages of
// K and V [128, D], bf16, 1024 bytes of alignment slack and 128 of
// barriers: 164,992 bytes at D 128, 83,072 at D 64 (one block per SM).
//
// Inputs: bf16, D 64 or 128, any B, H, KV with H % KV == 0, Sq, Sk >= 1.
// TMA needs 16-byte-aligned starts and (b, head, s) strides; the wrapper
// checks them and raises otherwise.
//
// Plain C interface, for ctypes: the function launches on the given stream
// and returns cudaGetLastError() (0 on success). It never synchronises and
// allocates nothing; the caller allocates the output.

#include <cuda.h>   // CUtensorMap; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;         // query rows a block, 64 a warpgroup
constexpr int BK = 128;         // keys a tile
constexpr int kStages = 2;      // K/V tiles in flight
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 128;   // and a producer warpgroup
constexpr int kPanel = 64;      // columns of a 128-byte swizzled panel
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets from the 1024-aligned base of shared memory.
template <int D>
struct Layout {
  static constexpr uint32_t kQBytes = BQ * D * 2;
  static constexpr uint32_t kTileBytes = BK * D * 2;   // one K or V tile
  static constexpr uint32_t kK = kQBytes;              // + stage * 2 tiles
  static constexpr uint32_t kV = kK + kTileBytes;      // + stage * 2 tiles
  static constexpr uint32_t kBars = kK + kStages * 2 * kTileBytes;
  static constexpr uint32_t kBytes = 1024 + kBars + 128;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory at `dst`, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor: 128-byte swizzle, the tile at `addr`
// (1024-aligned apart from the offset of a k-step inside a row), the
// leading and stride byte offsets.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B both K-major in shared
// memory (128-byte swizzle); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (four bf16 pairs a
// thread), B MN-major in shared memory (128-byte swizzle, transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (four bf16 pairs a
// thread), B MN-major in shared memory (128-byte swizzle, transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The barriers from `bars`: Q's, then each stage's K and V arrivals and
// K and V releases.
__device__ __forceinline__ uint32_t k_full(uint32_t bars, int s) {
  return bars + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t v_full(uint32_t bars, int s) {
  return bars + 8 * (1 + kStages + s);
}
__device__ __forceinline__ uint32_t k_free(uint32_t bars, int s) {
  return bars + 8 * (1 + 2 * kStages + s);
}
__device__ __forceinline__ uint32_t v_free(uint32_t bars, int s) {
  return bars + 8 * (1 + 3 * kStages + s);
}

// Rows [row, row + rows) of one (head, batch), as D / 64 panels of `rows`
// rows from `dst`, completing on `bar`.
template <int D>
__device__ __forceinline__ void load_panels(const CUtensorMap* map,
                                            uint32_t dst, int rows,
                                            uint32_t bar, int row, int head,
                                            int b) {
#pragma unroll
  for (int p = 0; p < D / kPanel; ++p)
    tma_load(dst + p * rows * 128, map, bar, p * kPanel, row, head, b);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One warpgroup's online softmax over a [64, BK] score fragment, in
// place; leaves the unnormalised probabilities in sc and in corr the
// factors by which the output accumulated so far must be scaled, and
// updates the running max m (log2 units) and partial sum l of this
// thread's two rows. kMasked: the tile holds masked pairs, so the scores
// are scaled and masked first; otherwise the scale is folded into the
// FMA before each exponential.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0,
                                             int row, int col, int Sk,
                                             int causal, int window,
                                             float scale_log2) {
  if constexpr (kMasked) {
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * c + col + e % 2, qp = row + 8 * (e / 2);
        float z = sc[4 * c + e] * scale_log2;
        if (kp >= Sk)
          z = -CUDART_INF_F;
        else if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
          z = kNegInf;
        sc[4 * c + e] = z;
      }
  }
  const float mul = kMasked ? 1.f : scale_log2;   // scale > 0: max commutes
  // two partial maxima and sums a row keep the dependent chains short
  float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
#pragma unroll
  for (int c = 0; c < BK / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e / 2][c % 2] = fmaxf(mx[e / 2][c % 2], sc[4 * c + e]);
  float neg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t = fmaxf(mx[i][0], mx[i][1]);
    // the 4 lanes of a row are neighbours
    t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 1));
    t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 2));
    const float m_new = fmaxf(m[i], t * mul);
    corr[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    neg[i] = -m_new;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int c = 0; c < BK / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(sc[4 * c + e], mul, neg[e / 2]));
      sum[e / 2][c % 2] += p;
      sc[4 * c + e] = p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + (sum[i][0] + sum[i][1]);
}

// P as wgmma's A fragments: k-step kk covers chunks 2kk and 2kk + 1.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void scale_rows(float (&acc)[N],
                                           const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= corr[(i % 4) / 2];
}

// S = Q K^T for one warpgroup's 64 rows and the K tile at `kt`.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint32_t q_rows,
                                        uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // panel kk / 4, 16 columns (32 bytes) a step inside its rows
    const uint32_t qa = q_rows + (kk / 4) * BQ * 128 + (kk % 4) * 32;
    const uint32_t ka = kt + (kk / 4) * BK * 128 + (kk % 4) * 32;
    wgmma_ss_n128(sc, desc(qa, 16, 1024), desc(ka, 16, 1024), kk > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// O += P V for one warpgroup's 64 rows and the V tile at `vt`.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = desc(vt + kk * 16 * 128, BK * 128, 1024);
    if constexpr (D == 64)
      wgmma_rs_n64(acc, pa[kk], dv);
    else
      wgmma_rs_n128(acc, pa[kk], dv);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2, one a warpgroup), so one's softmax runs while the
// other's products are on the tensor cores.
__device__ __forceinline__ void turn_wait(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  else
    asm volatile("bar.sync 2, %0;" ::"n"(kConsumers) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  if (wg == 0)
    asm volatile("bar.arrive 2, %0;" ::"n"(kConsumers) : "memory");
  else
    asm volatile("bar.arrive 1, %0;" ::"n"(kConsumers) : "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

struct Strides {  // element strides of a [B, heads, S, D] view
  int64_t b, h, s;
};

// The two consumer warpgroups' part of flash_sm90_kernel: 64 query rows
// each, from q0.
template <int D>
__device__ __forceinline__ void consume(__nv_bfloat16* __restrict__ o,
                                        Strides os, uint32_t base, int h,
                                        int b, int q0, int n_tiles,
                                        int tile0, int Sq, int Sk,
                                        int causal, int window,
                                        float scale_log2) {
  using L = Layout<D>;
  const uint32_t bars = base + L::kBars, q_full = bars;
  const int tid = threadIdx.x;

  // This thread's rows of the accumulator fragments (row and row + 8) and
  // its first column in each 8-column chunk.
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row_wg = q0 + wg * 64;
  const int row = row_wg + warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const uint32_t q_rows = base + wg * 64 * 128;   // in each Q panel

  float acc[D / 2], sc[BK / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float corr[2];
  uint32_t pa[BK / 16][4];
  // the tile from key k0 needs masks where some pair of this warpgroup's
  // rows and its keys is masked
  auto softmax = [&](int k0) {
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > row_wg) ||
        (window > 0 && k0 <= row_wg + 63 - window))
      softmax_tile<true>(sc, m, l, corr, k0, row, col, Sk, causal, window,
                         scale_log2);
    else
      softmax_tile<false>(sc, m, l, corr, k0, row, col, Sk, causal, window,
                          scale_log2);
  };
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  bar_wait(q_full, 0);
  if (n_tiles > 0) {
    // Tile 0: S, then its softmax. Each later tile j issues S_j and then
    // P_{j-1} V_{j-1}, and runs softmax_j while P_{j-1} V_{j-1} is still
    // on the tensor cores. Each issue takes this warpgroup's turn and
    // passes it on; warpgroup 0 goes first, and warpgroup 1 passes no
    // turn after its last issue, so every turn is taken.
    if (wg == 1) turn_pass(wg);
    bar_wait(k_full(bars, 0), 0);
    fence_regs(sc);
    turn_wait(wg);
    wg_fence();
    issue_s<D>(sc, q_rows, base + L::kK);
    turn_pass(wg);
    wg_wait<0>();
    fence_regs(sc);
    bar_arrive(k_free(bars, 0));
    softmax(tile0 * BK);
    pack_p(pa, sc);

    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kStages, sp = (j - 1) % kStages;
      const int k0 = (tile0 + j) * BK;
      bar_wait(k_full(bars, s), (j / kStages) & 1);
      fence_regs(sc);
      turn_wait(wg);
      wg_fence();
      issue_s<D>(sc, q_rows, base + L::kK + s * 2 * L::kTileBytes);
      scale_rows(acc, corr);
      bar_wait(v_full(bars, sp), ((j - 1) / kStages) & 1);
      fence_regs(acc);
      wg_fence();
      issue_pv<D>(acc, pa, base + L::kV + sp * 2 * L::kTileBytes);
      turn_pass(wg);
      wg_wait<1>();   // S_j is done
      fence_regs(sc);
      bar_arrive(k_free(bars, s));
      softmax(k0);
      wg_wait<0>();   // P_{j-1} V_{j-1} is done
      fence_regs(acc);
      fence_regs(pa);   // P_{j-1} stays in its registers until here
      bar_arrive(v_free(bars, sp));
      pack_p(pa, sc);
    }

    const int sl = (n_tiles - 1) % kStages;
    scale_rows(acc, corr);
    bar_wait(v_full(bars, sl), ((n_tiles - 1) / kStages) & 1);
    fence_regs(acc);
    turn_wait(wg);
    wg_fence();
    issue_pv<D>(acc, pa, base + L::kV + sl * 2 * L::kTileBytes);
    if (wg == 0) turn_pass(wg);
    wg_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row + 8 * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = ob + qp * os.s + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * i] / denom,
                                acc[4 * c + 2 * i + 1] / denom);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o, Strides os, int H,
                      int KV, int Sq, int Sk, int causal, int window,
                      float scale_log2) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBars, q_full = bars;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const int kvh = h / (H / KV);

  // the key tiles any row of this block can see
  const int last_q = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, last_q + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int tile0 = k_begin / BK;
  const int n_tiles = max(0, (k_end + BK - 1) / BK - tile0);

  if (tid == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(k_full(bars, s), 1);
      bar_init(v_full(bars, s), 1);
      bar_init(k_free(bars, s), kConsumers);
      bar_init(v_free(bars, s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warpgroup hands its registers to the consumers; one
    // lane keeps the K/V ring full. Tile t goes into stage t % kStages
    // once the consumers have released that stage's K (after S of tile
    // t - kStages) and V (after its P V).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (tid == kConsumers) {
      bar_expect(q_full, L::kQBytes);
      load_panels<D>(&tq, base, BQ, q_full, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, round = t / kStages;
        const int k0 = (tile0 + t) * BK;
        const uint32_t stage = base + s * 2 * L::kTileBytes;
        if (round > 0) bar_wait(k_free(bars, s), (round - 1) & 1);
        bar_expect(k_full(bars, s), L::kTileBytes);
        load_panels<D>(&tk, stage + L::kK, BK, k_full(bars, s), k0, kvh, b);
        if (round > 0) bar_wait(v_free(bars, s), (round - 1) & 1);
        bar_expect(v_full(bars, s), L::kTileBytes);
        load_panels<D>(&tv, stage + L::kV, BK, v_full(bars, s), k0, kvh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    consume<D>(o, os, base, h, b, q0, n_tiles, tile0, Sq, Sk, causal, window,
               scale_log2);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda that the CUDA runtime
// has loaded (the library does not link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (D, S, heads, B) of the bf16 tensor at `ptr` (strides in
// elements): boxes of 64 columns by `rows` rows in the 128-byte swizzle,
// zeros past the edges.
bool encode(CUtensorMap* map, const void* ptr, int D, int S, int heads,
            int B, Strides st, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {kPanel, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, int B, int H, int KV, int Sq,
           int Sk, int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, D, Sq, H, B, qs, BQ) ||
      !encode(&tk, k, D, Sk, KV, B, ks, BK) ||
      !encode(&tv, v, D, Sk, KV, B, vs, BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_sm90_kernel<D>;
  constexpr int bytes = Layout<D>::kBytes;
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, (Sq + BQ - 1) / BQ, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), os, H, KV, Sq, Sk, causal,
      window, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v and o; head_dim 64 or 128. Strides are in elements, per
// tensor (b, head, s); the last dimension is contiguous; every start and
// stride of q, k and v is a multiple of 16 bytes. window <= 0: no window.
// smem_bytes is the wrapper's plan of a block's shared memory; a plan that
// differs from the kernel's returns cudaErrorInvalidValue, as does any
// other head_dim or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int flash_attention_sm90_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int head_dim, int64_t qsb, int64_t qsh,
    int64_t qss, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
    int64_t vsh, int64_t vss, int64_t osb, int64_t osh, int64_t oss,
    int causal, int window, float scale, int smem_bytes, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64 && smem_bytes == (int)Layout<64>::kBytes)
    return launch<64>(q, k, v, o, qs, ks, vs, os, B, H, KV, Sq, Sk, causal,
                      window, scale, st);
  if (head_dim == 128 && smem_bytes == (int)Layout<128>::kBytes)
    return launch<128>(q, k, v, o, qs, ks, vs, os, B, H, KV, Sq, Sk, causal,
                       window, scale, st);
  return (int)cudaErrorInvalidValue;
}
