// One-token GQA decode attention over an int8 KV cache, for Hopper
// (sm_90a).
//
// quant_decode_attention replaces the TPU kernel of the same name
// (src/repro/kernels/quant_decode.py:64): for each row b and query head h,
// o = softmax(q k^T / sqrt(Dh)) v over the cache slots s < pos[b], where
// k = k8 * k_scale and v = v8 * v_scale are dequantized in the kernel (int8
// levels, one f32 scale per (slot, kv head)), with an online softmax in f32.
// The output has q's dtype (f32 or bf16). pos <= 0 masks every slot, as
// the plain version does: the row then averages all S slots.
//
// Bound: memory. A (row, kv head) reads 2 * n * (Dh + 4) bytes of levels and
// scales for its n valid slots, and does 4 * g * Dh operations a slot, far
// below the card's operations-per-byte balance at g = H / KV = 5 (48 for
// MQA).
//
// Work split, computed on the device. The cache is cut into tiles of
// BS = 64 slots. Row b holds n_b = ceil(N_b / 64) tiles, where N_b =
// min(pos_b, S) if pos_b > 0 and S otherwise, for each of its KV heads. The
// tasks, one per (row, kv head, tile), are numbered row-major:
//   start_b = KV * sum_{b' < b} n_b',   T = start_B,
//   task t = start_b + kvh * n_b + j    (tile j of kv head kvh of row b).
// The grid is fixed from sizes the host knows (B, KV, S, the SM count):
// N blocks a pass of query heads. Every block reads the B positions,
// computes the prefix above, and with nblk = min(N, T) (blocks past nblk
// idle) block i < nblk takes the contiguous share
//   [floor(i * T / nblk), floor((i + 1) * T / nblk))
// of the tasks, at least one, which may cross from one (row, kv head) into
// the next; no share exceeds ceil(T / nblk) tiles. The block holding task
// t is
//   block_of(t) = floor(((t + 1) * nblk - 1) / T).
// A (row, kv head) p whose tasks [s_p, e_p) lie in one block is written by
// it directly. Otherwise each block i of block_of(s_p) .. block_of(e_p - 1)
// writes a partial (running max, denominator and unnormalised output per
// head) to record i + p of the scratch (i + p is unique: along the tasks
// both i and p only grow), adds one to p's counter, and the block that
// brings the counter to the number of parts merges the records in block
// order (so the output does not depend on which block ends last) and sets
// the counter back to 0 for the next call or graph replay. pos is read from
// device memory and nothing depends on it on the host, so one launch does
// the whole call and captures in a CUDA graph.
//
// A block is 4 warps; a tile's 64 slots are 16 per warp. Tiles stay int8 in
// shared memory, in a ring of 3 stages loaded with cp.async 16 bytes a
// thread: tile t + 2's loads are issued before tile t is computed. A stage
// holds the tile's K and V levels (16-byte chunks XOR-swizzled within each
// 128-byte line, so the reads below hit no bank twice), their scales, and,
// when the tile is the first of a (row, kv head) in the block, the group's
// q rows. A slot's Dh levels are contiguous even in the strided pool view
// (one layer's [B, W, KV, Dh] slice viewed as [B, KV, W, Dh]), so each
// 16-byte chunk is one copy; where a slot start is not 16-byte aligned the
// levels are copied byte by byte (and q element by element where its rows
// are not). Levels become floats in registers, exactly: a byte permute
// forms the float 2^23 + 128 + level, one subtraction leaves the level.
// Each warp keeps its own online softmax in registers, and the 4 warps
// merge through shared memory once per (row, kv head) of the share. A pass
// (blockIdx.y) serves G heads of each group: more take several passes.
//
// bf16 q: the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums), G = 8
// heads a pass. Scores: q (bf16, exact) times the K levels turned into
// bf16 (exact: |level| <= 127), the heads as the rows (8-15 zero), the
// slot's scale and 1/sqrt(Dh) applied to the f32 sums; the dims of a
// k-step are permuted alike in q and K so that a lane reads its slot's
// levels as 16-byte vectors. P.V as O^T = V^T P^T: the V levels in bf16
// as the A operand (the output dims permuted so that a lane reads
// contiguous levels of each of its 4 slots), P times the slot's V scale,
// rounded to bf16, as the B operand straight from the scores' registers.
// Exponentials are ex2.approx on scores kept in log2 units.
//
// f32 q: f32 FMAs, G = 5 heads, each lane with 16 of a slot's Dh columns
// (D / 16 lanes a slot): q held pre-scaled in registers, one 16-byte read
// of a slot's levels serves every head, each head's score reduced across
// the slot's lanes with shuffles, and each level dequantized as
// __fmul_rn(level, scale), which keeps the f32 path to the plain version's
// rounding (1e-6).
//
// Plain C interface, for ctypes: the function launches on the given stream
// and returns cudaGetLastError() (0 on success). It never synchronises and
// allocates nothing; the caller allocates the output, the partials' scratch
// and the zeroed counters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BS = 64;                   // slots a tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpSlots = BS / kWarps;  // slots of a tile each warp takes
constexpr int kStages = 3;
constexpr int kSmemLimit = 232448;       // shared memory a block may use
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

struct Args {
  const void* q;
  const int8_t* k8;
  const float* ksc;
  const int8_t* v8;
  const float* vsc;
  const int* pos;
  int64_t pos_stride;
  void* o;
  float* part;
  int* counters;
  int64_t qsb, qsh, osb, osh;
  Strides kl, ks, vl, vs;
  int B, H, KV, S, gc;
  float scale;
  int vec_kv, vec_q;
};

// Shared memory of one block: the ring of stages (K levels, V levels, K
// scales, V scales, G q rows), the warps' merge area [warp][G][D] plus
// [warp][G][2] (max, denominator), and the B positions, B + 1 task starts
// and a flag.
template <typename T, int D> struct Plan {
  static constexpr int G = std::is_same<T, float>::value ? 5 : 8;
  static constexpr int kLevels = BS * D;
  static constexpr int kStage =
      2 * kLevels + 2 * BS * (int)sizeof(float) + G * D * (int)sizeof(T);
  static constexpr int kMerge = kWarps * G * (D + 2) * (int)sizeof(float);
  // floats of a partial record, [G][D] then [G][2], whole float4s
  static constexpr int kRecord = (G * (D + 2) + 3) / 4 * 4;
  static size_t bytes(int B) {
    return (size_t)kStages * kStage + kMerge + (size_t)(2 * B + 2) * 4;
  }
};

// Byte offset of 16-byte chunk c of tile row r: chunks XOR-swizzled within
// each 128-byte line (the line's index, times the rows a line holds).
template <int D> __device__ __forceinline__ int chunk_at(int r, int c) {
  const int line = r * D / 128, in_line = (r * D % 128) / 16 + c;
  return line * 128 + 16 * (in_line ^ (r & 7 & ~(128 / D - 1)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// *p += v at gpu scope, releasing this block's earlier writes (each
// thread's fenced, then ordered before it by a barrier) and acquiring
// those of the blocks before it.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Level j (byte j) of a word of 4 levels already XORed with 0x80808080, as
// a float, exactly: the byte is the low byte of 2^23 + 128 + level.
__device__ __forceinline__ float level(uint32_t u, int j) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) -
         8388736.0f;
}

// Two integer-valued floats as bf16x2 (lo in the low half): their top
// halves, exact for |x| <= 256.
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d += a b, m16n8k16, bf16 in, f32 sums.
__device__ __forceinline__ void mma(float d[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// What a tile's compute sees: its stage, the row's slots and position.
struct Tile {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  int s0, n, p_row;
};

// f32: SIMT FMAs. Lane (sg, cg) takes 16 columns cg of slot sg of each warp
// step (D / 16 lanes a slot, 32 / (D / 16) slots a step).
template <int D> struct SimtF32 {
  static constexpr int G = Plan<float, D>::G;
  static constexpr int CH = D / 16, SPW = 32 / CH, STEPS = kWarpSlots / SPW;
  float qr[G][16], acc[G][16], m[G], l[G];

  __device__ __forceinline__ void start(const float* qs, int gv, float scale,
                                        int lane) {
    const int cg = lane % CH;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        // a head past the group (the last pass's) computes on zeros and is
        // never written
        qr[h][e] = h < gv ? __fmul_rn(qs[h * D + cg * 16 + e], scale) : 0.f;
        acc[h][e] = 0.f;
      }
    }
  }

  __device__ __forceinline__ static void dequant16(const int8_t* src, float s,
                                                   float out[16]) {
    const int4 raw = *reinterpret_cast<const int4*>(src);
    const uint32_t w[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z,
                           (uint32_t)raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t u = w[k] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) out[4 * k + j] = __fmul_rn(level(u, j), s);
    }
  }

  __device__ __forceinline__ void tile(const Tile& t, int warp, int lane) {
    const int cg = lane % CH, sg = lane / CH;
#pragma unroll
    for (int step = 0; step < STEPS; ++step) {
      const int r = warp * kWarpSlots + step * SPW + sg;
      const int slot = t.s0 + r;
      float x[16];
      dequant16(t.k + chunk_at<D>(r, cg), t.ks[r], x);
      // the G heads' scores of this lane's slot: independent chains, each
      // summed over the slot's lanes
      float s[G], mx[G];
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int e = 0; e < 16; e += 2) {
          p0 = fmaf(qr[h][e], x[e], p0);
          p1 = fmaf(qr[h][e + 1], x[e + 1], p1);
        }
        s[h] = p0 + p1;
      }
#pragma unroll
      for (int off = CH / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int h = 0; h < G; ++h)
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], off);
      }
      // a masked slot scores -1e30, as in the plain version; a slot past
      // the row's walk (the last tile's tail) -inf, so it weighs 0
#pragma unroll
      for (int h = 0; h < G; ++h) {
        s[h] = slot < t.n ? (t.p_row > 0 ? s[h] : kNegInf) : -CUDART_INF_F;
        mx[h] = s[h];
      }
#pragma unroll
      for (int off = CH; off < 32; off <<= 1) {
#pragma unroll
        for (int h = 0; h < G; ++h)
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
      }
      // the running max is the warp's: one branch for the rare step that
      // raises it
      bool raised = false;
#pragma unroll
      for (int h = 0; h < G; ++h) raised |= mx[h] > m[h];
      if (raised) {
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float mn = fmaxf(m[h], mx[h]);
          const float corr = expf(m[h] - mn);
          l[h] *= corr;
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[h][e] *= corr;
          m[h] = mn;
        }
      }
#pragma unroll
      for (int h = 0; h < G; ++h) {
        s[h] = expf(s[h] - m[h]);
        l[h] += s[h];
      }
      dequant16(t.v + chunk_at<D>(r, cg), t.vs[r], x);
#pragma unroll
      for (int h = 0; h < G; ++h) {
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[h][e] = fmaf(s[h], x[e], acc[h][e]);
      }
    }
  }

  // the warp's (max, denominator, output) per head into the merge area;
  // the max is in natural-log units
  __device__ __forceinline__ void to_merge(float* macc, float* mml,
                                           int lane) {
    const int cg = lane % CH, sg = lane / CH;
#pragma unroll
    for (int off = CH; off < 32; off <<= 1) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], off);
#pragma unroll
        for (int e = 0; e < 16; ++e)
          acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], off);
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (sg == 0) {
        float4* dst = reinterpret_cast<float4*>(macc + h * D + cg * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[e] = make_float4(acc[h][4 * e], acc[h][4 * e + 1],
                               acc[h][4 * e + 2], acc[h][4 * e + 3]);
      }
      if (lane == 0) {
        mml[2 * h] = m[h];
        mml[2 * h + 1] = l[h];
      }
    }
  }
};

// bf16: the tensor cores. Lane (gid, tig) = (lane / 4, lane % 4).
// Scores S = q K^T with the heads as rows (rows 8-15 zero): the lane holds
// head gid at the warp's slots 8 nt + 2 tig + {0, 1}. Output O^T = V^T P^T
// with the dims as rows and the 8 heads as columns, so S's fragments are
// P^T's B operand as they stand and no accumulator is wasted: the lane
// holds heads 2 tig + {0, 1} at dims gid MT + mt and (gid + 8) MT + mt of
// m-tile mt (MT = D / 16 m-tiles; the dims are permuted so that a lane
// reads MT contiguous levels of a slot).
template <int D> struct MmaBf16 {
  static constexpr int KS = D / 16;  // k-steps of q.k
  static constexpr int MT = D / 16;  // m-tiles of O^T
  uint32_t qa[KS][2];  // q's A fragment (rows 0-7) at each k-step
  float o[MT][4];      // O^T: [mt][c] head 2 tig + c % 2, dim row c / 2
  float m, l;          // head gid's running max (log2 units), denominator

  __device__ __forceinline__ void start(const __nv_bfloat16* qs, int gv,
                                        float, int lane) {
    const int gid = lane / 4, tig = lane % 4;
    // k-step ks's logical columns 2 tig + {0, 1} and 2 tig + 8 + {0, 1}
    // are dims (D / 4) tig + 4 ks + {0, 1} and + {2, 3}: 4 contiguous bf16
    const uint2* src =
        reinterpret_cast<const uint2*>(qs + gid * D + (D / 4) * tig);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint2 w = gid < gv ? src[ks] : make_uint2(0u, 0u);
      qa[ks][0] = w.x;
      qa[ks][1] = w.y;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[mt][c] = 0.f;
    m = kNegInf;
    l = 0.f;
  }

  __device__ __forceinline__ void tile(const Tile& t, int warp, int lane,
                                       float scale) {
    const int gid = lane / 4, tig = lane % 4;
    const int base = warp * kWarpSlots;
    // V^T's A fragments need slots 2 tig + {0, 1, 8, 9}, MT levels each at
    // dims gid MT and (gid + 8) MT: loaded first, independent of the scores
    uint32_t vw[4][2][MT / 4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = base + 2 * tig + (i & 1) + 8 * (i >> 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int at = (gid + 8 * half) * MT;  // byte of the row
        const int8_t* src = t.v + chunk_at<D>(rr, at / 16) + at % 16;
        if constexpr (MT == 8) {
          const uint2 raw = *reinterpret_cast<const uint2*>(src);
          vw[i][half][0] = raw.x ^ 0x80808080u;
          vw[i][half][1] = raw.y ^ 0x80808080u;
        } else {
          vw[i][half][0] = *reinterpret_cast<const uint32_t*>(src) ^
                           0x80808080u;
        }
      }
    }
    // scores of head gid at the warp's slots 8 nt + 2 tig + {0, 1}: two
    // chains a slot group (even and odd k-steps), summed at the end
    float s[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int r = base + 8 * nt + gid;  // the slot whose levels we read
      float acc[2][4] = {};
#pragma unroll
      for (int h = 0; h < D / 64; ++h) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            t.k + chunk_at<D>(r, (D / 64) * tig + h));
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t u = w[k] ^ 0x80808080u;
          const uint32_t b0 = pack_exact(level(u, 0), level(u, 1));
          const uint32_t b1 = pack_exact(level(u, 2), level(u, 3));
          const int ks = 4 * h + k;
          mma(acc[ks & 1], qa[ks][0], 0u, qa[ks][1], 0u, b0, b1);
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int rr = base + 8 * nt + 2 * tig + c, slot = t.s0 + rr;
        // a masked slot scores -1e30, as in the plain version; a slot past
        // the row's walk (the last tile's tail) -inf, so it weighs 0
        s[nt][c] = slot < t.n ? (t.p_row > 0 ? (acc[0][c] + acc[1][c]) *
                                                   (t.ks[rr] * scale)
                                             : kNegInf)
                              : -CUDART_INF_F;
      }
    }
    float mx = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // rescale every tile (a factor of 1 unless the max rose): no branch, so
    // the tile schedules as one block of instructions
    const float mn = fmaxf(m, mx);
    const float corr = ex2(m - mn);
    m = mn;
    l *= corr;
    // O^T's columns are heads 2 tig + {0, 1}: their factors from lanes
    // 8 tig and 8 tig + 4
    const float c0 = __shfl_sync(0xffffffffu, corr, 8 * tig);
    const float c1 = __shfl_sync(0xffffffffu, corr, 8 * tig + 4);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      o[mt][0] *= c0;
      o[mt][1] *= c1;
      o[mt][2] *= c0;
      o[mt][3] *= c1;
    }
    // P^T (times the slot's V scale) as the B fragment: head gid at slots
    // 2 tig + {0, 1} (b0) and 2 tig + 8 + {0, 1} (b1), as S holds them
    uint32_t pb[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int rr = base + 8 * nt + 2 * tig;
      const float p0 = ex2(s[nt][0] - m), p1 = ex2(s[nt][1] - m);
      l += p0 + p1;
      pb[nt] = pack_rn(p0 * t.vs[rr], p1 * t.vs[rr + 1]);
    }
    // V^T's A fragment of m-tile mt: dims gid MT + mt (rows gid) and
    // (gid + 8) MT + mt (rows gid + 8) at slots 2 tig + {0, 1} (a0, a1)
    // and 2 tig + 8 + {0, 1} (a2, a3)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int k = mt / 4, j = mt % 4;
      const uint32_t a0 =
          pack_exact(level(vw[0][0][k], j), level(vw[1][0][k], j));
      const uint32_t a1 =
          pack_exact(level(vw[0][1][k], j), level(vw[1][1][k], j));
      const uint32_t a2 =
          pack_exact(level(vw[2][0][k], j), level(vw[3][0][k], j));
      const uint32_t a3 =
          pack_exact(level(vw[2][1][k], j), level(vw[3][1][k], j));
      mma(o[mt], a0, a1, a2, a3, pb[0], pb[1]);
    }
  }

  // the warp's (max, denominator, output) of each head into the merge
  // area; the max back in natural-log units
  __device__ __forceinline__ void to_merge(float* macc, float* mml,
                                           int lane) {
    const int gid = lane / 4, tig = lane % 4;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* dst = macc + (2 * tig + c % 2) * D + (gid + 8 * (c / 2)) * MT;
#pragma unroll
      for (int e = 0; e < MT / 4; ++e)
        reinterpret_cast<float4*>(dst)[e] =
            make_float4(o[4 * e][c], o[4 * e + 1][c], o[4 * e + 2][c],
                        o[4 * e + 3][c]);
    }
    if (tig == 0) {
      mml[2 * gid] = m / kLog2e;
      mml[2 * gid + 1] = l;
    }
  }
};

// A walk over tasks: tile j of kv head kvh of row b, whose row has n tiles.
struct Cursor {
  int b, kvh, j, n;
};

// The valid slots of a row at position p: min(p, S), or all S if p <= 0.
__device__ __forceinline__ int row_slots(int p, int S) {
  return p > 0 ? min(p, S) : S;
}

// Blocks an SM holds: the f32 kernel's registers allow 2, the bf16
// kernel's 3 (and its shared memory, 3 x 73.5 KB at Dh 128).
template <typename T> constexpr int kBlocksPerSm =
    std::is_same<T, float>::value ? 2 : 3;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<T>)
    quant_decode_kernel(const Args a) {
  using P = Plan<T, D>;
  constexpr int G = P::G;
  using Compute = std::conditional_t<std::is_same<T, float>::value,
                                     SimtF32<D>, MmaBf16<D>>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* merge_acc = reinterpret_cast<float*>(smem + kStages * P::kStage);
  float* merge_ml = merge_acc + kWarps * G * D;
  int* pos_s = reinterpret_cast<int*>(merge_ml + kWarps * G * 2);
  int* start_s = pos_s + a.B;        // [B + 1]
  int* flag_s = start_s + a.B + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = a.H / a.KV, pass = blockIdx.y;
  const int gv = min(a.gc, g - pass * a.gc);  // heads of the group here
  const int S = a.S, KV = a.KV, pairs = a.B * a.KV;

  // the positions and each row's first task (warp 0: a chunk of rows a
  // lane, then a scan of the chunks' task counts across the lanes)
  if (warp == 0) {
    const int per = (a.B + 31) / 32;
    const int lo = min(lane * per, a.B), hi = min(lo + per, a.B);
    int sum = 0;
    for (int r = lo; r < hi; ++r) {
      const int p = a.pos[r * a.pos_stride];
      pos_s[r] = p;
      sum += (row_slots(p, S) + BS - 1) / BS * KV;
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    int run = incl - sum;
    for (int r = lo; r < hi; ++r) {
      start_s[r] = run;
      run += (row_slots(pos_s[r], S) + BS - 1) / BS * KV;
    }
    if (lane == 31) start_s[a.B] = incl;
  }
  __syncthreads();
  const int64_t total = start_s[a.B];
  // with fewer tasks than blocks, one task a block and the rest idle, so
  // that every block between two of a pair's blocks holds part of it
  const int64_t nblk = min((int64_t)gridDim.x, total), blk = blockIdx.x;
  if (blk >= nblk) return;
  const int64_t t0 = blk * total / nblk, t1 = (blk + 1) * total / nblk;
  auto block_of = [&](int64_t t) { return ((t + 1) * nblk - 1) / total; };
  auto tiles = [&](int b) { return (row_slots(pos_s[b], S) + BS - 1) / BS; };
  auto advance = [&](Cursor& c) {
    if (++c.j == c.n) {
      c.j = 0;
      if (++c.kvh == KV) {
        c.kvh = 0;
        if (++c.b < a.B) c.n = tiles(c.b);
      }
    }
  };

  Cursor ci;  // the share's first task: the last row starting at or before
  {
    int lo = 0, hi = a.B - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (start_s[mid] <= t0) lo = mid; else hi = mid - 1;
    }
    ci.b = lo;
    ci.n = tiles(lo);
    const int r = (int)(t0 - start_s[lo]);
    ci.kvh = r / ci.n;
    ci.j = r % ci.n;
  }
  Cursor cc = ci;  // the task being computed; ci the next one loaded

  // loads tile ci into a stage (and the group's q rows when `with_q`)
  auto issue = [&](int stage, bool with_q) {
    unsigned char* st = smem + stage * P::kStage;
    int8_t* kd = reinterpret_cast<int8_t*>(st);
    int8_t* vd = kd + P::kLevels;
    float* ksd = reinterpret_cast<float*>(vd + P::kLevels);
    float* vsd = ksd + BS;
    const int b = ci.b, kvh = ci.kvh, s0 = ci.j * BS;
    const int n = row_slots(pos_s[b], S);
    const int8_t* kl = a.k8 + b * a.kl.b + kvh * a.kl.h;
    const int8_t* vl = a.v8 + b * a.vl.b + kvh * a.vl.h;
    if (a.vec_kv) {
      for (int i = threadIdx.x; i < BS * D / 16; i += kThreads) {
        const int r = i / (D / 16), c = i % (D / 16), slot = s0 + r;
        const int at = chunk_at<D>(r, c);
        if (slot < n) {
          cp_async16(kd + at, kl + slot * a.kl.s + 16 * c);
          cp_async16(vd + at, vl + slot * a.vl.s + 16 * c);
        } else {  // past the row's slots: zeros, weighed 0
          *reinterpret_cast<int4*>(kd + at) = make_int4(0, 0, 0, 0);
          *reinterpret_cast<int4*>(vd + at) = make_int4(0, 0, 0, 0);
        }
      }
    } else {
      for (int i = threadIdx.x; i < BS * D; i += kThreads) {
        const int r = i / D, c = i % D, slot = s0 + r;
        const int at = chunk_at<D>(r, c / 16) + c % 16;
        kd[at] = slot < n ? kl[slot * a.kl.s + c] : 0;
        vd[at] = slot < n ? vl[slot * a.vl.s + c] : 0;
      }
    }
    for (int i = threadIdx.x; i < 2 * BS; i += kThreads) {
      const int r = i % BS, slot = s0 + r;
      float* dst = i < BS ? ksd + r : vsd + r;
      if (slot < n) {
        cp_async4(dst, i < BS ? a.ksc + b * a.ks.b + kvh * a.ks.h +
                                    slot * a.ks.s
                              : a.vsc + b * a.vs.b + kvh * a.vs.h +
                                    slot * a.vs.s);
      } else {
        *dst = 0.f;
      }
    }
    if (with_q) {
      T* qd = reinterpret_cast<T*>(vsd + BS);
      const T* q = static_cast<const T*>(a.q) + b * a.qsb +
                   (int64_t)(kvh * g + pass * a.gc) * a.qsh;
      if (a.vec_q) {
        constexpr int kChunks = D * (int)sizeof(T) / 16;  // a row's
        for (int i = threadIdx.x; i < gv * kChunks; i += kThreads) {
          const int h = i / kChunks;
          const int c = (i % kChunks) * (16 / (int)sizeof(T));
          cp_async16(qd + h * D + c, q + h * a.qsh + c);
        }
      } else {
        for (int i = threadIdx.x; i < gv * D; i += kThreads)
          qd[i] = q[(i / D) * a.qsh + i % D];
      }
    }
  };

  Compute cmp;
  Cursor seg = cc;  // the (row, kv head) being accumulated
  const int64_t rec_stride = P::kRecord;
  float* recs = a.part + (int64_t)pass * (nblk + pairs) * rec_stride;

  // writes the share's result for (seg.b, seg.kvh): directly when the
  // share holds all its tiles, else through the partials. Thread d < D
  // takes column d of every head.
  auto finalize = [&]() {
    __syncthreads();  // the last finalize's readers are done with merge_*
    cmp.to_merge(merge_acc + warp * G * D, merge_ml + warp * G * 2, lane);
    __syncthreads();
    const int pair = seg.b * KV + seg.kvh;
    const int64_t ps = start_s[seg.b] + (int64_t)seg.kvh * seg.n;
    const int64_t first = block_of(ps), last = block_of(ps + seg.n - 1);
    T* o = static_cast<T*>(a.o) + seg.b * a.osb +
           (int64_t)(seg.kvh * g + pass * a.gc) * a.osh;
    float* rec = recs + (blk + pair) * rec_stride;
    const int d = threadIdx.x;
    if (d < D) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (h >= gv) continue;
        float mx = kNegInf;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          mx = fmaxf(mx, merge_ml[(w * G + h) * 2]);
        float den = 0.f, num = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float wt = expf(merge_ml[(w * G + h) * 2] - mx);
          den = fmaf(wt, merge_ml[(w * G + h) * 2 + 1], den);
          num = fmaf(wt, merge_acc[(w * G + h) * D + d], num);
        }
        if (first == last) {
          o[h * a.osh + d] = narrow<T>(num / den);
        } else {
          rec[h * D + d] = num;
          if (d == 0) {
            rec[G * D + 2 * h] = mx;
            rec[G * D + 2 * h + 1] = den;
          }
        }
      }
    }
    if (first == last) return;
    __threadfence();  // each thread's part of the record, visible
    __syncthreads();
    if (threadIdx.x == 0) {
      int* cnt = a.counters + (int64_t)pass * pairs + pair;
      const int seen = atomic_add_acq_rel(cnt, 1);
      const bool done = seen == (int)(last - first);
      if (done) *cnt = 0;  // clean for the next call
      flag_s[0] = done;
    }
    __syncthreads();
    if (!flag_s[0]) return;
    // The last block merges the parts in block order, a chunk at a time:
    // the parts' maxima and denominators staged in the merge area (all
    // threads at once), each head's new running max, factor and
    // denominator and each part's weight worked out by thread h, then the
    // numerators as float4 loads, 4 columns of a head a thread, each load
    // independent of the others.
    constexpr int kCap = kWarps * D / 2;        // parts a chunk
    constexpr int kGroups = (G * D / 4 + kThreads - 1) / kThreads;
    float* run = merge_ml;                      // [G][3]: max, factor, den
    float4 num[kGroups];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) num[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (threadIdx.x < G) {
      run[3 * threadIdx.x] = kNegInf;
      run[3 * threadIdx.x + 2] = 0.f;
    }
    for (int64_t c0 = first; c0 <= last; c0 += kCap) {
      const int cnt = (int)min((int64_t)kCap, last - c0 + 1);
      __syncthreads();  // the last chunk's readers are done
      for (int i = threadIdx.x; i < cnt * G; i += kThreads) {
        const float* ml = recs + (c0 + i / G + pair) * rec_stride + G * D +
                          2 * (i % G);
        merge_acc[2 * i] = __ldcg(ml);
        merge_acc[2 * i + 1] = __ldcg(ml + 1);
      }
      __syncthreads();
      if (threadIdx.x < G) {
        const int h = threadIdx.x;
        float mc = run[3 * h];
        for (int k = 0; k < cnt; ++k)
          mc = fmaxf(mc, merge_acc[2 * (k * G + h)]);
        const float corr = expf(run[3 * h] - mc);
        float den = run[3 * h + 2] * corr;
        for (int k = 0; k < cnt; ++k) {
          const float w = expf(merge_acc[2 * (k * G + h)] - mc);
          den = fmaf(w, merge_acc[2 * (k * G + h) + 1], den);
          merge_acc[2 * (k * G + h)] = w;  // the part's weight
        }
        run[3 * h] = mc;
        run[3 * h + 1] = corr;
        run[3 * h + 2] = den;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const int q = threadIdx.x + j * kThreads;  // float4 q of [G][D]
        if (q >= G * D / 4) break;
        const int h = 4 * q / D;
        const float corr = run[3 * h + 1];
        float4 acc = make_float4(num[j].x * corr, num[j].y * corr,
                                 num[j].z * corr, num[j].w * corr);
        const float* base = recs + (c0 + pair) * rec_stride + 4 * q;
#pragma unroll 8
        for (int k = 0; k < cnt; ++k) {
          const float4 v =
              __ldcg(reinterpret_cast<const float4*>(base + k * rec_stride));
          const float w = merge_acc[2 * (k * G + h)];
          acc.x = fmaf(w, v.x, acc.x);
          acc.y = fmaf(w, v.y, acc.y);
          acc.z = fmaf(w, v.z, acc.z);
          acc.w = fmaf(w, v.w, acc.w);
        }
        num[j] = acc;
      }
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int q = threadIdx.x + j * kThreads;
      if (q >= G * D / 4) break;
      const int h = 4 * q / D, d4 = 4 * q % D;
      if (h >= gv) continue;
      const float den = run[3 * h + 2];
      o[h * a.osh + d4] = narrow<T>(num[j].x / den);
      o[h * a.osh + d4 + 1] = narrow<T>(num[j].y / den);
      o[h * a.osh + d4 + 2] = narrow<T>(num[j].z / den);
      o[h * a.osh + d4 + 3] = narrow<T>(num[j].w / den);
    }
  };

  // the ring's first kStages - 1 tiles
  int64_t ti = t0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (ti < t1) {
      issue(s, ti == t0 || ci.j == 0);
      advance(ci);
      ++ti;
    }
    cp_async_commit();
  }

  for (int64_t t = t0; t < t1; ++t) {
    const int k = (int)(t - t0);
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (ti < t1) {
      issue((k + kStages - 1) % kStages, ci.j == 0);
      advance(ci);
      ++ti;
    }
    cp_async_commit();

    const unsigned char* st = smem + (k % kStages) * P::kStage;
    Tile tl;
    tl.k = reinterpret_cast<const int8_t*>(st);
    tl.v = tl.k + P::kLevels;
    tl.ks = reinterpret_cast<const float*>(tl.v + P::kLevels);
    tl.vs = tl.ks + BS;
    if (t == t0 || cc.j == 0) {  // a new (row, kv head) starts here
      if (t != t0) finalize();
      seg = cc;
      cmp.start(reinterpret_cast<const T*>(tl.vs + BS), gv, a.scale, lane);
    }
    tl.s0 = cc.j * BS;
    tl.p_row = pos_s[cc.b];
    tl.n = row_slots(tl.p_row, S);
    if constexpr (std::is_same<T, float>::value) {
      cmp.tile(tl, warp, lane);
    } else {
      cmp.tile(tl, warp, lane, a.scale * kLog2e);
    }
    advance(cc);
  }
  finalize();
}

template <typename T, int D>
int launch(const Args& a, int n_blocks, int passes, cudaStream_t stream) {
  auto kernel = quant_decode_kernel<T, D>;
  // the opt-in to more than 48 KB of shared memory, once per device
  static unsigned long long ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(ready >> dev & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    ready |= 1ull << dev;
  }
  if (a.gc > Plan<T, D>::G) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(n_blocks, passes), kThreads, Plan<T, D>::bytes(a.B),
           stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and o). head_dim: 64 or 128. The
// grid is n_blocks x passes; pass y serves query heads [y * gc, (y + 1) *
// gc) of each group of H / KV (gc <= 5 for f32, 8 for bf16; passes * gc >=
// H / KV > (passes - 1) * gc). Strides are in elements: q and o (b, head)
// with the last dimension contiguous; levels and scales (b, kv head,
// slot). pos holds int32 values pos_stride apart. part holds passes *
// (n_blocks + B * KV) records of G * (head_dim + 2) floats, rounded up to a
// multiple of 4 (G = 5 for f32, 8 for bf16), 16-byte aligned; counters
// passes * B * KV ints, zero before the first
// call (each call leaves them zero). vec_kv: every slot's levels start on
// a 16-byte boundary; vec_q: so do q's rows. Anything else the kernel does
// not take returns cudaErrorInvalidValue.
extern "C" int quant_decode_attention(
    const void* q, const void* k8, const void* k_scale, const void* v8,
    const void* v_scale, const void* pos, int64_t pos_stride, void* o,
    void* part, void* counters, int n_blocks, int passes, int gc, int dtype,
    int B, int H, int KV, int S, int head_dim, int64_t qsb, int64_t qsh,
    int64_t osb, int64_t osh, int64_t klb, int64_t klh, int64_t kls,
    int64_t ksb, int64_t ksh, int64_t kss, int64_t vlb, int64_t vlh,
    int64_t vls, int64_t vsb, int64_t vsh, int64_t vss, float scale,
    int vec_kv, int vec_q, void* stream) {
  if (B < 1 || KV < 1 || H % KV || S < 1 || n_blocks < 1 || passes < 1 ||
      gc < 1 || (int64_t)gc * passes < H / KV ||
      (int64_t)gc * (passes - 1) >= H / KV)
    return (int)cudaErrorInvalidValue;
  const Args a{q, static_cast<const int8_t*>(k8),
               static_cast<const float*>(k_scale),
               static_cast<const int8_t*>(v8),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(pos), pos_stride, o,
               static_cast<float*>(part), static_cast<int*>(counters),
               qsb, qsh, osb, osh, Strides{klb, klh, kls},
               Strides{ksb, ksh, kss}, Strides{vlb, vlh, vls},
               Strides{vsb, vsh, vss}, B, H, KV, S, gc, scale, vec_kv,
               vec_q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(a, n_blocks, passes, st);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(a, n_blocks, passes, st);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(a, n_blocks, passes, st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(a, n_blocks, passes, st);
  return (int)cudaErrorInvalidValue;
}
