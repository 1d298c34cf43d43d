// Packed masked attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces deepv_tpu/ops/attention.py::_attn_kernel (the Pallas TPU kernel
// behind attention_pallas). Computes, for q/k/v [b, S, h, d=64]:
//
//   allowed(i, j) = (valid[b, i] == valid[b, j]) && (times[i] >= times[j])
//   out[b, i, h]  = softmax_j(q_i . k_j / sqrt(d), disallowed -> -1e30) . v
//
// What bounds it on the H100: at the rollout's layouts (S = 461 .. 2285,
// b*h = 48 .. 72) the work is ~1e10-1e11 FLOP per call against ~50 MB of
// q/k/v/o, about 10x more operations per byte than the card's bf16 ridge
// point: the products bound it, not the memory. Only the allowed pairs need
// products, and 31-41% of the 128 x 64 blocks of the rollout's masks hold
// none.
//
// attn_fwd_wgmma (bf16; what the model runs):
//   * One CTA per (128 query rows, batch*head): two consumer warpgroups of 64
//     rows each and one producer warp. Online (running max / running sum)
//     softmax in f32 over 64-key tiles, so no [S, S] logits reach device
//     memory.
//   * TMA loads straight from [b, S, h, 64] (one 4-D tensor map per operand,
//     dims (64, h, S, b), 128-byte rows in the 128-byte swizzle that the
//     wgmma descriptors read; its zero fill covers rows past S). The Q tile
//     is loaded once; the producer keeps a 3-stage ring of K and V tiles
//     full on mbarriers, and writes each tile's 64 key valid/time values
//     beside it for the mask.
//   * S = Q.K^T by wgmma.m64n64k16 with both operands K-major in shared
//     memory; O += P.V by wgmma with P from registers (the f32 accumulator
//     converted to bf16 has the A-fragment layout) and V [keys][64] read
//     MN-major through the transpose-B bit. f32 accumulation, P rounded to
//     bf16 before P.V as the TPU kernel rounds its weights, the row sums
//     taken from the f32 values, one rounding at the store.
//   * The softmax stays in the accumulator's registers: a thread holds two
//     rows, row max and sum need two __shfl_xor steps, exp2 with
//     scale*log2(e) folded in.
//   * Per-tile mask schedule: at CTA start each key tile is classified from
//     the min/max of times and of valid[b] over its keys and over the CTA's
//     query rows (ops/attention.py::tile_classes is the same rule):
//       skip:    max t_q < min t_k, or the valid ranges are disjoint;
//       full:    min t_q >= max t_k, all four valid extremes equal, and the
//                tile lies inside S;
//       partial: everything else; only these tiles build the mask.
//     The producer loads only the listed tiles and the consumers walk the
//     same list. Skipping is exact: every row attends at least itself, so
//     its running max is a real logit, and a disallowed key's term is
//     exp(-1e30 - m) = 0 in f32; dropping the tiles that hold only such
//     terms changes no sum. The schedule also covers the TPU wrapper's
//     n_last split (the prefix x current block is a skip) in one launch.
//   * Keys past S are excluded (-inf), rows past S are computed on the
//     zero fill and not stored. S is capped at 65,536 (1,024 key tiles,
//     the schedule's shared-memory list).
//
// attn_fwd_f32 (the exactness check on the card, and f32 forwards): one CTA
// per (64 query rows, batch*head), 64-key tiles in shared memory, plain FMA
// in f32, the same online softmax with the mask rebuilt per tile, and a
// time-only tile skip.
//
// Both forwards write, when given an lse pointer (training), each row's
// log-sum-exp of its masked, scaled logits in the natural log, [b, h, S]
// f32: m + log(l) (attn_fwd_wgmma keeps m and l in base 2 and stores
// ln 2 * (m + log2 l)). Without it (inference) nothing changes.
//
// Backward (no TPU kernel: deepv_tpu trains through its jnp attention,
// models/mmdit.py:289-299, which jax.value_and_grad differentiates). With
// scale = 1/8, P = exp(Q.K^T * scale - LSE) on allowed pairs (else 0),
// D = rowsum(dO * O): dV = P^T dO, dS = P * (dO V^T - D), dQ = dS K * scale,
// dK = dS^T Q * scale. Five S x S x 64 products over the allowed pairs
// bound it (3.8e10 FLOP at the stage-2 training layout, b=1, S=2,093,
// against 51 MB of q, k, v, O, dO in and dq, dk, dv out in bf16: ~750
// operations a byte, past the bf16 ridge of ~295). The design is plain:
//   * attn_bwd_delta: D, one warp per row;
//   * attn_bwd_dkdv_*: one CTA per (64 keys, batch*head) keeps its K and V
//     tile, walks the query tiles, recomputes P and dS and accumulates dK
//     and dV in registers;
//   * attn_bwd_dq_*: one CTA per (64 query rows, batch*head) keeps Q and dO,
//     walks the key tiles, recomputes P and dS and accumulates dQ.
//   No float atomics: each gradient row is summed by one thread in a fixed
//   order, so two runs agree bit for bit. Recomputing P and dP in both
//   kernels costs seven products where five would do.
//   * Mask schedule: each CTA classifies its own 64-row tile against every
//     64-row tile of the sequence by the forward's rule (tile_classes at
//     (64, 64)), own tile on the key side in dK/dV and on the query side in
//     dQ, and loads only kept tiles; only partial tiles build the mask. A
//     row past S gets LSE = +inf, so its P is 0 in a full tile too.
//   * f32 (`_f32`): 256 threads as 16 x 16, 4 x 4 outputs each, FMA from
//     shared memory at a 65-float row stride.
//   * bf16 (`_bf16`): 4 warps of mma.sync.m16n8k16 (f32 accumulate); each
//     warp keeps its 16 own rows as A fragments in registers, the other
//     side's tiles sit in shared memory (144-byte rows); P and dS are
//     rounded to bf16 for the second products, as the forward rounds P.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;          // head dim
constexpr float kMasked = -1e30f;

// attn_fwd_f32's tiles
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per tile
constexpr int kWarps = 4;       // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Per-tile vectors: valid and time of the tile's 64 rows (queries or keys).
__device__ __forceinline__ void load_vectors(int* sv, float* st, const int* valid,
                                             const float* times, int bi, int s,
                                             int start) {
  const int t = threadIdx.x;
  if (t < 64) {
    const int r = start + t;
    sv[t] = r < s ? valid[(size_t)bi * s + r] : -1;
    st[t] = r < s ? times[r] : 0.f;
  }
}

// Largest (want_max) or smallest in-range time of a 64-row tile, computed
// by each warp on its own so every thread reaches the same value.
__device__ __forceinline__ float tile_time_bound(const float* st, int start, int s,
                                                 bool want_max) {
  const int lane = threadIdx.x & 31;
  const float fill = want_max ? -INFINITY : INFINITY;
  const float a = start + lane < s ? st[lane] : fill;
  const float b = start + lane + 32 < s ? st[lane + 32] : fill;
  return want_max ? warp_max(fmaxf(a, b)) : warp_min(fminf(a, b));
}

// Row r of the (b, h) slice of a [b, S, h, 64] tensor.
template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* base, int bi, int hi, int r,
                                            int s, int h) {
  return base + (((size_t)bi * s + r) * h + hi) * kD;
}

// Online-softmax update of one row from its two logits (columns lane and
// lane+32 of the tile). Returns the two probabilities; updates m and l.
__device__ __forceinline__ void online_update(float s0, float s1, float& m, float& l,
                                              float& alpha, float& p0, float& p1) {
  const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
  alpha = expf(m - m_new);
  p0 = expf(s0 - m_new);
  p1 = expf(s1 - m_new);
  l = l * alpha + warp_sum(p0 + p1);
  m = m_new;
}

// Masked, scaled logit of (query row, key column) or -inf for a missing key.
__device__ __forceinline__ float masked_logit(float dot, float scale, int vq, float tq,
                                              int vk, float tk, bool key_in_range) {
  if (!key_in_range) return -INFINITY;
  return (vq == vk && tq >= tk) ? dot * scale : kMasked;
}

// ---------------------------------------------------------------------------
// f32: plain FMA (the exactness check on the card)
// ---------------------------------------------------------------------------

constexpr int kLdK = kD + 1;    // f32 K row stride: conflict-free column reads

struct SmemF32 {
  float q[kBQ * kD];
  float k[kBK * kLdK];
  float v[kBK * kD];
  float p[kBQ * kBK];
  int vq[64];
  float tq[64];
  int vk[64];
  float tk[64];
};

__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* src, int bi,
                                              int hi, int start, int s, int h) {
  for (int i = threadIdx.x; i < 64 * (kD / 4); i += kThreads) {
    const int r = i / (kD / 4);
    const int c = (i % (kD / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (start + r < s)
      val = *reinterpret_cast<const float4*>(row_ptr(src, bi, hi, start + r, s, h) + c);
    dst[r * ld + c] = val.x;
    dst[r * ld + c + 1] = val.y;
    dst[r * ld + c + 2] = val.z;
    dst[r * ld + c + 3] = val.w;
  }
}

__global__ void __launch_bounds__(kThreads)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ valid,
             const float* __restrict__ times, float* __restrict__ out,
             float* __restrict__ lse, int s, int h, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemF32& sm = *reinterpret_cast<SmemF32*>(smem_raw);

  const int q0 = blockIdx.x * kBQ;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * kRows;

  load_tile_f32(sm.q, kD, q, bi, hi, q0, s, h);
  load_vectors(sm.vq, sm.tq, valid, times, bi, s, q0);
  __syncthreads();
  const float tq_max = tile_time_bound(sm.tq, q0, s, true);

  float m[kRows], l[kRows], o0[kRows], o1[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) { m[r] = -INFINITY; l[r] = 0.f; o0[r] = 0.f; o1[r] = 0.f; }

  const int n_tiles = (s + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_vectors(sm.vk, sm.tk, valid, times, bi, s, k0);
    __syncthreads();
    if (tile_time_bound(sm.tk, k0, s, false) > tq_max) continue;
    load_tile_f32(sm.k, kLdK, k, bi, hi, k0, s, h);
    load_tile_f32(sm.v, kD, v, bi, hi, k0, s, h);
    __syncthreads();

    // logits of keys lane and lane+32 for the warp's 16 rows
    float d0[kRows], d1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) { d0[r] = 0.f; d1[r] = 0.f; }
    for (int d = 0; d < kD; ++d) {
      const float ka = sm.k[lane * kLdK + d];
      const float kb = sm.k[(lane + 32) * kLdK + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = sm.q[(row0 + r) * kD + d];
        d0[r] = fmaf(qv, ka, d0[r]);
        d1[r] = fmaf(qv, kb, d1[r]);
      }
    }

    const bool in0 = k0 + lane < s, in1 = k0 + lane + 32 < s;
    const int vk0 = sm.vk[lane], vk1 = sm.vk[lane + 32];
    const float tk0 = sm.tk[lane], tk1 = sm.tk[lane + 32];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const float s0 = masked_logit(d0[r], scale, sm.vq[row], sm.tq[row], vk0, tk0, in0);
      const float s1 = masked_logit(d1[r], scale, sm.vq[row], sm.tq[row], vk1, tk1, in1);
      float alpha, p0, p1;
      online_update(s0, s1, m[r], l[r], alpha, p0, p1);
      sm.p[row * kBK + lane] = p0;
      sm.p[row * kBK + lane + 32] = p1;
      o0[r] *= alpha;
      o1[r] *= alpha;
    }
    __syncwarp();

    // outputs of head-dim columns lane and lane+32
    for (int c = 0; c < kBK; ++c) {
      const float va = sm.v[c * kD + lane];
      const float vb = sm.v[c * kD + lane + 32];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = sm.p[(row0 + r) * kBK + c];
        o0[r] = fmaf(p, va, o0[r]);
        o1[r] = fmaf(p, vb, o1[r]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (q0 + row >= s) continue;
    const float inv = 1.f / l[r];
    float* dst = out + (((size_t)bi * s + q0 + row) * h + hi) * kD;
    dst[lane] = o0[r] * inv;
    dst[lane + 32] = o1[r] * inv;
    if (lse != nullptr && lane == 0) lse[((size_t)bi * h + hi) * s + q0 + row] = m[r] + logf(l[r]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------------------
// bf16: TMA-fed wgmma with a per-tile mask schedule
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int kBQ = 128;                   // query rows per CTA, 64 per consumer warpgroup
constexpr int kBK = 64;                    // keys per tile
constexpr int kStages = 3;                 // K/V ring depth
constexpr int kConsumers = 256;            // warpgroups 0 and 1
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = 1024;            // key tiles of one sequence: S <= 65,536
constexpr int kTileBytes = kBK * kD * 2;   // one [64 keys][64] bf16 tile, 8 KB
constexpr int kQBytes = kBQ * kD * 2;      // 16 KB
// V [keys][64] read MN-major: a k16 slice is two 8-key groups of 128-byte
// rows (SBO apart); N = 64 is one swizzle atom wide, so LBO is not read
constexpr uint32_t kVLbo = kTileBytes;
constexpr uint32_t kVSbo = 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum : uint8_t { kSkip = 0, kFull = 1, kPartial = 2 };

// Shared memory, from a 1024-byte aligned base (the swizzle atom)
constexpr int kQOff = 0;
constexpr int kKOff = kQOff + kQBytes;
constexpr int kVOff = kKOff + kStages * kTileBytes;
constexpr int kVkOff = kVOff + kStages * kTileBytes;       // int [kStages][64]
constexpr int kTkOff = kVkOff + kStages * kBK * 4;         // float [kStages][64]
constexpr int kBarOff = kTkOff + kStages * kBK * 4;        // q_full, full[], empty[]
constexpr int kQStatOff = kBarOff + (1 + 2 * kStages) * 8; // 2 halves x (tmin, tmax, vmin, vmax)
constexpr int kCountOff = kQStatOff + 2 * 16;              // schedule length
constexpr int kClsOff = kCountOff + 16;                    // uint8 [kMaxTiles]
constexpr int kListOff = kClsOff + kMaxTiles;              // uint16 [kMaxTiles]
constexpr int kSmemBytes = kListOff + 2 * kMaxTiles + 1024;  // + alignment slack
static_assert(kBarOff % 8 == 0, "mbarriers are 8-byte aligned");

struct Stats {
  float tmin, tmax;
  int vmin, vmax;
};

// min / max of times and of valid[bi] over rows [start, min(start + 64, s))
// of the sequence, computed by one warp; every lane gets the result.
__device__ __forceinline__ Stats warp_stats(const int* __restrict__ valid,
                                            const float* __restrict__ times, int bi, int s,
                                            int start) {
  const int lane = threadIdx.x & 31;
  Stats r{INFINITY, -INFINITY, INT_MAX, INT_MIN};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = start + lane + 32 * half;
    if (row < s) {
      const float t = times[row];
      const int v = valid[(size_t)bi * s + row];
      r.tmin = fminf(r.tmin, t);
      r.tmax = fmaxf(r.tmax, t);
      r.vmin = min(r.vmin, v);
      r.vmax = max(r.vmax, v);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    r.tmin = fminf(r.tmin, __shfl_xor_sync(0xffffffffu, r.tmin, o));
    r.tmax = fmaxf(r.tmax, __shfl_xor_sync(0xffffffffu, r.tmax, o));
    r.vmin = min(r.vmin, __shfl_xor_sync(0xffffffffu, r.vmin, o));
    r.vmax = max(r.vmax, __shfl_xor_sync(0xffffffffu, r.vmax, o));
  }
  return r;
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]: A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory (transpose-B)
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {   // over the 4 lanes of a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap tmap_q,
               const __grid_constant__ CUtensorMap tmap_k,
               const __grid_constant__ CUtensorMap tmap_v, const int* __restrict__ valid,
               const float* __restrict__ times, __nv_bfloat16* __restrict__ out,
               float* __restrict__ lse, int s, int h, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = wg_smem + (base - raw);
  const uint32_t q_full = base + kBarOff;
  const uint32_t full = q_full + 8;                        // + 8 * stage
  const uint32_t empty = full + 8 * kStages;
  float* qstat_t = reinterpret_cast<float*>(smem + kQStatOff);   // [half][tmin, tmax, -, -]
  int* qstat_v = reinterpret_cast<int*>(smem + kQStatOff);       // [half][-, -, vmin, vmax]
  int* n_sched = reinterpret_cast<int*>(smem + kCountOff);
  uint8_t* cls = smem + kClsOff;
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + kListOff);

  const int q0 = blockIdx.x * kBQ;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y - bi * h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_kt = (s + kBK - 1) / kBK;

  // ---- the mask schedule, by the whole CTA ----
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);                                  // the producer's expect_tx
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 32);                        // every producer lane
      mbar_init(empty + 8 * st, kConsumers);               // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, kQBytes);                       // Q loads while the schedule is built
    tma_load_4d(base + kQOff, &tmap_q, q_full, 0, hi, q0, bi);
  }
  if (warp < 2) {                                          // query rows, 64 per warp
    const Stats q = warp_stats(valid, times, bi, s, q0 + 64 * warp);
    if (lane == 0) {
      qstat_t[4 * warp] = q.tmin;
      qstat_t[4 * warp + 1] = q.tmax;
      qstat_v[4 * warp + 2] = q.vmin;
      qstat_v[4 * warp + 3] = q.vmax;
    }
  }
  __syncthreads();
  {
    const float tq_min = fminf(qstat_t[0], qstat_t[4]);
    const float tq_max = fmaxf(qstat_t[1], qstat_t[5]);
    const int vq_min = min(qstat_v[2], qstat_v[6]);
    const int vq_max = max(qstat_v[3], qstat_v[7]);
    for (int t = warp; t < n_kt; t += kWarps) {
      const Stats k = warp_stats(valid, times, bi, s, t * kBK);
      if (lane == 0) {
        const bool skip = tq_max < k.tmin || vq_max < k.vmin || k.vmax < vq_min;
        const bool all = tq_min >= k.tmax && vq_min == vq_max && k.vmin == k.vmax &&
                         vq_min == k.vmin && (t + 1) * kBK <= s;
        cls[t] = skip ? kSkip : (all ? kFull : kPartial);
      }
    }
  }
  __syncthreads();
  if (warp == 0) {                                         // compact the kept tiles, in order
    int count = 0;
    for (int t0 = 0; t0 < n_kt; t0 += 32) {
      const int t = t0 + lane;
      const uint8_t c = t < n_kt ? cls[t] : kSkip;
      const unsigned kept = __ballot_sync(0xffffffffu, c != kSkip);
      if (c != kSkip)
        list[count + __popc(kept & ((1u << lane) - 1u))] =
            (uint16_t)(t | (c == kPartial ? 0x8000 : 0));
      count += __popc(kept);
    }
    if (lane == 0) *n_sched = count;
  }
  __syncthreads();
  const int n = *n_sched;

  if (warp == kWarps - 1) {
    // ---- producer warp: the listed K/V tiles through the ring ----
    int* vk_ring = reinterpret_cast<int*>(smem + kVkOff);
    float* tk_ring = reinterpret_cast<float*>(smem + kTkOff);
    for (int j = 0; j < n; ++j) {
      const int st = j % kStages;
      mbar_wait(empty + 8 * st, ((j / kStages) & 1) ^ 1);
      const int k0 = (list[j] & 0x7fff) * kBK;
#pragma unroll
      for (int half = 0; half < 2; ++half) {               // the keys' mask vectors
        const int c = lane + 32 * half, key = k0 + c;
        vk_ring[st * kBK + c] = key < s ? valid[(size_t)bi * s + key] : 0;
        tk_ring[st * kBK + c] = key < s ? times[key] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full + 8 * st, 2 * kTileBytes);
        tma_load_4d(base + kKOff + st * kTileBytes, &tmap_k, full + 8 * st, 0, hi, k0, bi);
        tma_load_4d(base + kVOff + st * kTileBytes, &tmap_v, full + 8 * st, 0, hi, k0, bi);
      } else {
        mbar_arrive(full + 8 * st);
      }
    }
  } else {
    // ---- consumers: warpgroup g owns query rows q0 + 64 g .. + 63 ----
    const int g = warp >> 2;
    const int wq = warp & 3;
    const int row0 = q0 + 64 * g + 16 * wq + (lane >> 2);   // and row0 + 8
    const int row1 = row0 + 8;
    const int vq0 = row0 < s ? valid[(size_t)bi * s + row0] : 0;
    const int vq1 = row1 < s ? valid[(size_t)bi * s + row1] : 0;
    const float tq0 = row0 < s ? times[row0] : 0.f;
    const float tq1 = row1 < s ? times[row1] : 0.f;
    const uint32_t qs = base + kQOff + g * (kQBytes / 2);
    const int col_base = 2 * (lane & 3);

    float o[32], sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) { o[i] = 0.f; sc[i] = 0.f; }
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // l: this thread's columns

    mbar_wait(q_full, 0);
    for (int j = 0; j < n; ++j) {
      const int st = j % kStages;
      mbar_wait(full + 8 * st, (j / kStages) & 1);
      const int entry = list[j];
      const int k0 = (entry & 0x7fff) * kBK;
      const uint32_t ks = base + kKOff + st * kTileBytes;
      const uint32_t vs = base + kVOff + st * kTileBytes;

      // S = Q . K^T: [64 rows][64 keys], K-major operands, k16 slices 32 bytes apart
      fence_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_m64n64k16(sc, smem_desc(qs + kk * 32, 16, 1024),
                           smem_desc(ks + kk * 32, 16, 1024), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);

      // logits in the log2 domain; the mask only on partial tiles.
      // sc[4i + c] is (row0, key 8i + col_base + c), sc[4i + 2 + c] is row1's.
      if (entry & 0x8000) {
        const int* vk = reinterpret_cast<const int*>(smem + kVkOff) + st * kBK;
        const float* tk = reinterpret_cast<const float*>(smem + kTkOff) + st * kBK;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 8 * i + col_base;
          const int2 kv = *reinterpret_cast<const int2*>(vk + col);
          const float2 kt = *reinterpret_cast<const float2*>(tk + col);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int vkc = c ? kv.y : kv.x;
            const float tkc = c ? kt.y : kt.x;
            const bool in = k0 + col + c < s;
            float& a = sc[4 * i + c];
            float& b = sc[4 * i + 2 + c];
            a = !in ? -INFINITY : (vq0 == vkc && tq0 >= tkc) ? a * scale_log2 : kMasked;
            b = !in ? -INFINITY : (vq1 == vkc && tq1 >= tkc) ? b * scale_log2 : kMasked;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
      }

      // online softmax of the thread's two rows
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sc[4 * i] = exp2f(sc[4 * i] - mn0);
        sc[4 * i + 1] = exp2f(sc[4 * i + 1] - mn0);
        sc[4 * i + 2] = exp2f(sc[4 * i + 2] - mn1);
        sc[4 * i + 3] = exp2f(sc[4 * i + 3] - mn1);
        sum0 += sc[4 * i] + sc[4 * i + 1];
        sum1 += sc[4 * i + 2] + sc[4 * i + 3];
        o[4 * i] *= alpha0;
        o[4 * i + 1] *= alpha0;
        o[4 * i + 2] *= alpha1;
        o[4 * i + 3] *= alpha1;
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;

      // P in bf16 as the A fragments of the four k16 slices (keys 16 kk ..)
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P . V: V MN-major, k16 slices 16 rows (2 KB) apart
      fence_acc(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs_m64n64k16_tb(o, pa[kk], smem_desc(vs + kk * 2048, kVLbo, kVSbo));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      mbar_arrive(empty + 8 * st);
    }

    // epilogue: 1/l, one rounding, 4-byte stores into [b, S, h, 64]; the
    // row LSE in the natural log: ln 2 * (m + log2 l), m and l in base 2
    const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    if (lse != nullptr && (lane & 3) == 0) {
      float* dst = lse + ((size_t)bi * h + hi) * s;
      if (row0 < s) dst[row0] = (m0 + log2f(sum0)) * kLn2;
      if (row1 < s) dst[row1] = (m1 + log2f(sum1)) * kLn2;
    }
    __nv_bfloat16* dst0 = out + (((size_t)bi * s + row0) * h + hi) * kD + col_base;
    __nv_bfloat16* dst1 = out + (((size_t)bi * s + row1) * h + hi) * kD + col_base;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (row0 < s)
        *reinterpret_cast<__nv_bfloat162*>(dst0 + 8 * i) =
            __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
      if (row1 < s)
        *reinterpret_cast<__nv_bfloat162*>(dst1 + 8 * i) =
            __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    }
  }
}

// One [b, S, h, 64] bf16 tensor: dims (64, h, S, b), boxes of `rows` rows
CUresult encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int b, int s, int h,
                    int rows) {
  const cuuint64_t dim[4] = {(cuuint64_t)kD, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t stride[3] = {(cuuint64_t)kD * 2, (cuuint64_t)h * kD * 2,
                                (cuuint64_t)s * h * kD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kD, 1, (cuuint32_t)rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dim, stride,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int launch(const void* q, const void* k, const void* v, const int* valid, const float* times,
           __nv_bfloat16* out, float* lse, int b, int s, int h, cudaStream_t stream) {
  if (s > kMaxTiles * kBK || (int64_t)b * h > 65535 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = encode_map(encode, &tq, q, b, s, h, kBQ);
  if (r == CUDA_SUCCESS) r = encode_map(encode, &tk, k, b, s, h, kBK);
  if (r == CUDA_SUCCESS) r = encode_map(encode, &tv, v, b, s, h, kBK);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_wgmma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + kBQ - 1) / kBQ, b * h);
  const float scale_log2 = kLog2e / sqrtf((float)kD);
  attn_fwd_wgmma<<<grid, kThreads, kSmemBytes, stream>>>(tq, tk, tv, valid, times, out, lse, s,
                                                         h, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// backward: D = rowsum(dO * O), then dK/dV over key tiles and dQ over query
// tiles, each recomputing P from the forward's row LSE
// ---------------------------------------------------------------------------

namespace bwd {

constexpr int kT = 64;           // rows of a query tile, keys of a key tile
constexpr int kMaxTiles = 1024;  // 64-row tiles of one sequence: S <= 65,536

// The CTA's mask schedule: its own 64-row tile against every 64-row tile of
// the sequence, by the rule of ops/attention.py::tile_classes at (64, 64),
// the own tile on the query side (dq kernels) or the key side (dk/dv
// kernels); the kept tiles in order, bit 15 set on partial ones.
struct Sched {
  uint8_t cls[kMaxTiles];
  uint16_t list[kMaxTiles];
  wg::Stats own;
  int n;
};

template <int kWarpCount>
__device__ int build_schedule(Sched& sc, const int* __restrict__ valid,
                              const float* __restrict__ times, int bi, int s, int own0,
                              bool own_is_query) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_t = (s + kT - 1) / kT;
  if (warp == 0) {
    const wg::Stats o = wg::warp_stats(valid, times, bi, s, own0);
    if (lane == 0) sc.own = o;
  }
  __syncthreads();
  const wg::Stats own = sc.own;
  for (int t = warp; t < n_t; t += kWarpCount) {
    const wg::Stats o = wg::warp_stats(valid, times, bi, s, t * kT);
    if (lane == 0) {
      const wg::Stats& qs = own_is_query ? own : o;
      const wg::Stats& ks = own_is_query ? o : own;
      const int k_start = own_is_query ? t * kT : own0;
      const bool skip = qs.tmax < ks.tmin || qs.vmax < ks.vmin || ks.vmax < qs.vmin;
      const bool all = qs.tmin >= ks.tmax && qs.vmin == qs.vmax && ks.vmin == ks.vmax &&
                       qs.vmin == ks.vmin && k_start + kT <= s;
      sc.cls[t] = skip ? wg::kSkip : (all ? wg::kFull : wg::kPartial);
    }
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int t0 = 0; t0 < n_t; t0 += 32) {
      const int t = t0 + lane;
      const uint8_t c = t < n_t ? sc.cls[t] : wg::kSkip;
      const unsigned kept = __ballot_sync(0xffffffffu, c != wg::kSkip);
      if (c != wg::kSkip)
        sc.list[count + __popc(kept & ((1u << lane) - 1u))] =
            (uint16_t)(t | (c == wg::kPartial ? 0x8000 : 0));
      count += __popc(kept);
    }
    if (lane == 0) sc.n = count;
  }
  __syncthreads();
  return sc.n;
}

// valid and time of a tile's 64 rows and, for a query tile (lse != null),
// its LSE and D; a row past S gets LSE +inf, so its P is exp(-inf) = 0
__device__ __forceinline__ void load_row_vectors(int* sv, float* st, float* slse, float* sdel,
                                                 const int* valid, const float* times,
                                                 const float* lse, const float* delta, int bi,
                                                 int hi, int s, int h, int start) {
  const int t = threadIdx.x;
  if (t < kT) {
    const int r = start + t;
    const bool in = r < s;
    sv[t] = in ? valid[(size_t)bi * s + r] : 0;
    st[t] = in ? times[r] : 0.f;
    if (lse != nullptr) {
      const size_t at = ((size_t)bi * h + hi) * s + r;
      slse[t] = in ? lse[at] : INFINITY;
      sdel[t] = in ? delta[at] : 0.f;
    }
  }
}

// P and dS of one pair of (query, key) entries: P = exp(logit - LSE) on an
// allowed pair, else 0; dS = P (dP - D). `check` is set on partial tiles.
__device__ __forceinline__ void p_and_ds(float& sc, float& dp, float scale, float lse, float del,
                                         bool check, bool q_in, bool k_in, int vq, int vk,
                                         float tq, float tk) {
  const bool ok = !check || (q_in && k_in && vq == vk && tq >= tk);
  const float p = ok ? expf(sc * scale - lse) : 0.f;
  sc = p;
  dp = p * (dp - del);
}

// D[b, h, S] = sum over the head dim of dO * O, one warp per row
template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
               int rows, int s, int h) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);    // over [b, S, h] in memory order
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* po = o + (size_t)row * kD;
  const T* pd = dout + (size_t)row * kD;
  float x = to_f32(po[lane]) * to_f32(pd[lane]) + to_f32(po[lane + 32]) * to_f32(pd[lane + 32]);
  x = warp_sum(x);
  if (lane == 0) {
    const int hi = row % h, bs = row / h;
    delta[((size_t)(bs / s) * h + hi) * s + bs % s] = x;
  }
}

// ---- f32: plain FMA. 256 threads as 16 x 16, each 4 x 4 outputs at rows
// ty + 16 r and columns tx + 16 c (conflict-free shared reads at stride 65)

constexpr int kFThreads = 256;
constexpr int kFWarps = kFThreads / 32;
constexpr int kLd = kD + 1;
constexpr int kTile = kT * kLd;

__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int bi, int hi,
                                              int start, int s, int h) {
  for (int i = threadIdx.x; i < kT * kD; i += kFThreads) {
    const int r = i >> 6, c = i & 63;
    dst[r * kLd + c] = start + r < s ? row_ptr(src, bi, hi, start + r, s, h)[c] : 0.f;
  }
}

// S = Q.K^T and dP = dO.V^T for rows ty + 16 r (of Q, dO) and columns
// tx + 16 c (rows of K, V)
__device__ __forceinline__ void products_f32(const float* sq, const float* sdo, const float* sk,
                                             const float* sv, float (&sc)[4][4],
                                             float (&dp)[4][4], int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) { sc[r][c] = 0.f; dp[r][c] = 0.f; }
  for (int d = 0; d < kD; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qa[r] = sq[(ty + 16 * r) * kLd + d];
      oa[r] = sdo[(ty + 16 * r) * kLd + d];
      kb[r] = sk[(tx + 16 * r) * kLd + d];
      vb[r] = sv[(tx + 16 * r) * kLd + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[r][c] = fmaf(qa[r], kb[c], sc[r][c]);
        dp[r][c] = fmaf(oa[r], vb[c], dp[r][c]);
      }
  }
}

struct SmemDkdvF32 {
  float k[kTile], v[kTile], q[kTile], dout[kTile], p[kTile], ds[kTile];
  int vq[kT], vk[kT];
  float tq[kT], tk[kT], lse[kT], del[kT];
  Sched sched;
};

struct SmemDqF32 {
  float q[kTile], dout[kTile], k[kTile], v[kTile], ds[kTile];
  int vq[kT], vk[kT];
  float tq[kT], tk[kT], lse[kT], del[kT];
  Sched sched;
};

// dK and dV of one 64-key tile, over the query tiles its schedule keeps
__global__ void __launch_bounds__(kFThreads)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ valid, const float* __restrict__ times,
                  float* __restrict__ dk, float* __restrict__ dv, int s, int h, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemDkdvF32& sm = *reinterpret_cast<SmemDkdvF32*>(smem_raw);
  const int k0 = blockIdx.x * kT;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows_f32(sm.k, k, bi, hi, k0, s, h);
  load_rows_f32(sm.v, v, bi, hi, k0, s, h);
  load_row_vectors(sm.vk, sm.tk, nullptr, nullptr, valid, times, nullptr, nullptr, bi, hi, s, h,
                   k0);
  const int n = build_schedule<kFWarps>(sm.sched, valid, times, bi, s, k0, false);

  float adk[4][4], adv[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) { adk[r][c] = 0.f; adv[r][c] = 0.f; }

  for (int j = 0; j < n; ++j) {
    const int entry = sm.sched.list[j];
    const int q0 = (entry & 0x7fff) * kT;
    const bool partial = entry & 0x8000;
    __syncthreads();                                  // the last tile's readers are done
    load_rows_f32(sm.q, q, bi, hi, q0, s, h);
    load_rows_f32(sm.dout, dout, bi, hi, q0, s, h);
    load_row_vectors(sm.vq, sm.tq, sm.lse, sm.del, valid, times, lse, delta, bi, hi, s, h, q0);
    __syncthreads();

    // rows: queries ty + 16 r; columns: keys tx + 16 c
    float sc[4][4], dp[4][4];
    products_f32(sm.q, sm.dout, sm.k, sm.v, sc, dp, tx, ty);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = tx + 16 * c;
        p_and_ds(sc[r][c], dp[r][c], scale, sm.lse[i], sm.del[i], partial, q0 + i < s,
                 k0 + kj < s, sm.vq[i], sm.vk[kj], sm.tq[i], sm.tk[kj]);
        sm.p[i * kLd + kj] = sc[r][c];
        sm.ds[i * kLd + kj] = dp[r][c];
      }
    }
    __syncthreads();

    // dV[key][c] += sum_i P[i][key] dO[i][c], dK[key][c] += sum_i dS[i][key] Q[i][c];
    // keys ty + 16 r, head-dim columns tx + 16 c
    for (int i = 0; i < kT; ++i) {
      float pk[4], sk[4], oc[4], qc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pk[r] = sm.p[i * kLd + ty + 16 * r];
        sk[r] = sm.ds[i * kLd + ty + 16 * r];
        oc[r] = sm.dout[i * kLd + tx + 16 * r];
        qc[r] = sm.q[i * kLd + tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          adv[r][c] = fmaf(pk[r], oc[c], adv[r][c]);
          adk[r][c] = fmaf(sk[r], qc[c], adk[r][c]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty + 16 * r;
    if (key >= s) continue;
    float* pk = dk + (((size_t)bi * s + key) * h + hi) * kD;
    float* pv = dv + (((size_t)bi * s + key) * h + hi) * kD;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pk[tx + 16 * c] = adk[r][c] * scale;
      pv[tx + 16 * c] = adv[r][c];
    }
  }
}

// dQ of one 64-row query tile, over the key tiles its schedule keeps
__global__ void __launch_bounds__(kFThreads)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ valid, const float* __restrict__ times,
                float* __restrict__ dq, int s, int h, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemDqF32& sm = *reinterpret_cast<SmemDqF32*>(smem_raw);
  const int q0 = blockIdx.x * kT;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows_f32(sm.q, q, bi, hi, q0, s, h);
  load_rows_f32(sm.dout, dout, bi, hi, q0, s, h);
  load_row_vectors(sm.vq, sm.tq, sm.lse, sm.del, valid, times, lse, delta, bi, hi, s, h, q0);
  const int n = build_schedule<kFWarps>(sm.sched, valid, times, bi, s, q0, true);

  float adq[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) adq[r][c] = 0.f;

  for (int j = 0; j < n; ++j) {
    const int entry = sm.sched.list[j];
    const int k0 = (entry & 0x7fff) * kT;
    const bool partial = entry & 0x8000;
    __syncthreads();
    load_rows_f32(sm.k, k, bi, hi, k0, s, h);
    load_rows_f32(sm.v, v, bi, hi, k0, s, h);
    load_row_vectors(sm.vk, sm.tk, nullptr, nullptr, valid, times, nullptr, nullptr, bi, hi, s,
                     h, k0);
    __syncthreads();

    float sc[4][4], dp[4][4];
    products_f32(sm.q, sm.dout, sm.k, sm.v, sc, dp, tx, ty);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = tx + 16 * c;
        p_and_ds(sc[r][c], dp[r][c], scale, sm.lse[i], sm.del[i], partial, q0 + i < s,
                 k0 + kj < s, sm.vq[i], sm.vk[kj], sm.tq[i], sm.tk[kj]);
        sm.ds[i * kLd + kj] = dp[r][c];
      }
    }
    __syncthreads();

    // dQ[i][c] += sum_key dS[i][key] K[key][c]; rows ty + 16 r, columns tx + 16 c
    for (int kj = 0; kj < kT; ++kj) {
      float si[4], kc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        si[r] = sm.ds[(ty + 16 * r) * kLd + kj];
        kc[r] = sm.k[kj * kLd + tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) adq[r][c] = fmaf(si[r], kc[c], adq[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= s) continue;
    float* pq = dq + (((size_t)bi * s + row) * h + hi) * kD;
#pragma unroll
    for (int c = 0; c < 4; ++c) pq[tx + 16 * c] = adq[r][c] * scale;
  }
}

// ---- bf16: mma.sync.m16n8k16 with f32 accumulation. 4 warps; warp w owns
// rows 16 w .. 16 w + 15 of the CTA's own tile (thread: rows g and g + 8,
// g = lane / 4; columns 2 t, 2 t + 1 of each 8-wide n-tile, t = lane % 4).
// The own tile's operands stay in registers as A fragments; the other
// side's tiles sit in shared memory at a 144-byte row stride. P and dS are
// rounded to bf16 for the second products, as the forward rounds P.

constexpr int kBThreads = 128;
constexpr int kBWarps = kBThreads / 32;
constexpr int kLdB = kD + 8;                  // bf16 row stride: 144 bytes
constexpr int kTileB = kT * kLdB;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of one column from consecutive rows, the lower row in the low half
__device__ __forceinline__ uint32_t ld_pair_col(const __nv_bfloat16* p) {
  return (uint32_t)__bfloat16_as_ushort(p[0]) | ((uint32_t)__bfloat16_as_ushort(p[kLdB]) << 16);
}

__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int bi, int hi, int start, int s, int h) {
  for (int i = threadIdx.x; i < kT * 8; i += kBThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (start + r < s)
      val = *reinterpret_cast<const uint4*>(row_ptr(src, bi, hi, start + r, s, h) + c);
    *reinterpret_cast<uint4*>(dst + r * kLdB + c) = val;
  }
}

// A fragments of the warp's 16 rows of a shared [64][kLdB] tile, k16 slices kk
__device__ __forceinline__ void a_fragments(uint32_t (&a)[4][4], const __nv_bfloat16* tile,
                                            int row0, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const __nv_bfloat16* p = tile + row0 * kLdB + 16 * kk + 2 * t;
    a[kk][0] = ld_u32(p);
    a[kk][1] = ld_u32(p + 8 * kLdB);
    a[kk][2] = ld_u32(p + 8);
    a[kk][3] = ld_u32(p + 8 * kLdB + 8);
  }
}

// acc[n-tile][4] = A (the warp's 16 rows x 64) . B^T, B a shared [64 rows][64]
// tile read as the col-major k x n operand (n = B's rows)
__device__ __forceinline__ void rows_dot(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                         const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const __nv_bfloat16* p = tile + (8 * nt + g) * kLdB + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_bf16(acc[nt], a[kk], ld_u32(p + 16 * kk), ld_u32(p + 16 * kk + 8));
  }
}

// acc[d n-tile][4] += X (the warp's 16 rows x 64, in accumulator layout,
// rounded to bf16) . B, B a shared [64 rows][64] tile (k = B's rows)
__device__ __forceinline__ void acc_times_rows(float (&acc)[8][4], const float (&x)[8][4],
                                               const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = wg::pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = wg::pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = wg::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = wg::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const __nv_bfloat16* p = tile + (16 * kk + 2 * t) * kLdB + g;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      mma_bf16(acc[nd], a, ld_pair_col(p + 8 * nd), ld_pair_col(p + 8 * kLdB + 8 * nd));
  }
}

struct SmemDkdvBf16 {
  __nv_bfloat16 own_a[kTileB], own_b[kTileB], q[kTileB], dout[kTileB];
  int vq[kT], vk[kT];
  float tq[kT], tk[kT], lse[kT], del[kT];
  Sched sched;
};

struct SmemDqBf16 {
  __nv_bfloat16 own_a[kTileB], own_b[kTileB], k[kTileB], v[kTileB];
  int vq[kT], vk[kT];
  float tq[kT], tk[kT], lse[kT], del[kT];
  Sched sched;
};

// dK and dV of one 64-key tile: warp w's 16 keys hold S^T = K.Q^T and
// dP^T = V.dO^T for each kept query tile, then dV += P^T.dO, dK += dS^T.Q
__global__ void __launch_bounds__(kBThreads)
attn_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const int* __restrict__ valid, const float* __restrict__ times,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int s, int h,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemDkdvBf16& sm = *reinterpret_cast<SmemDkdvBf16*>(smem_raw);
  const int k0 = blockIdx.x * kT;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;                       // the thread's keys: r0 and r0 + 8

  load_rows_bf16(sm.own_a, k, bi, hi, k0, s, h);
  load_rows_bf16(sm.own_b, v, bi, hi, k0, s, h);
  load_row_vectors(sm.vk, sm.tk, nullptr, nullptr, valid, times, nullptr, nullptr, bi, hi, s, h,
                   k0);
  const int n = build_schedule<kBWarps>(sm.sched, valid, times, bi, s, k0, false);
  uint32_t ka[4][4], va[4][4];
  a_fragments(ka, sm.own_a, r0, t);
  a_fragments(va, sm.own_b, r0, t);
  const int vk[2] = {sm.vk[r0], sm.vk[r0 + 8]};
  const float tk[2] = {sm.tk[r0], sm.tk[r0 + 8]};
  const bool k_in[2] = {k0 + r0 < s, k0 + r0 + 8 < s};

  float adk[8][4], adv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) { adk[nt][e] = 0.f; adv[nt][e] = 0.f; }

  for (int j = 0; j < n; ++j) {
    const int entry = sm.sched.list[j];
    const int q0 = (entry & 0x7fff) * kT;
    const bool partial = entry & 0x8000;
    __syncthreads();
    load_rows_bf16(sm.q, q, bi, hi, q0, s, h);
    load_rows_bf16(sm.dout, dout, bi, hi, q0, s, h);
    load_row_vectors(sm.vq, sm.tq, sm.lse, sm.del, valid, times, lse, delta, bi, hi, s, h, q0);
    __syncthreads();

    float sc[8][4], dp[8][4];
    rows_dot(sc, ka, sm.q, g, t);                     // S^T [keys][queries]
    rows_dot(dp, va, sm.dout, g, t);                  // dP^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * nt + 2 * t + (e & 1);      // the query column
        const int kr = e >> 1;                         // key r0 or r0 + 8
        p_and_ds(sc[nt][e], dp[nt][e], scale, sm.lse[i], sm.del[i], partial, q0 + i < s,
                 k_in[kr], sm.vq[i], vk[kr], sm.tq[i], tk[kr]);
      }
    acc_times_rows(adv, sc, sm.dout, g, t);          // dV += P^T . dO
    acc_times_rows(adk, dp, sm.q, g, t);             // dK += dS^T . Q
  }

#pragma unroll
  for (int kr = 0; kr < 2; ++kr) {
    const int key = k0 + r0 + 8 * kr;
    if (key >= s) continue;
    __nv_bfloat16* pk = dk + (((size_t)bi * s + key) * h + hi) * kD + 2 * t;
    __nv_bfloat16* pv = dv + (((size_t)bi * s + key) * h + hi) * kD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(pk + 8 * nd) =
          __floats2bfloat162_rn(adk[nd][2 * kr] * scale, adk[nd][2 * kr + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(pv + 8 * nd) =
          __floats2bfloat162_rn(adv[nd][2 * kr], adv[nd][2 * kr + 1]);
    }
  }
}

// dQ of one 64-row query tile: warp w's 16 rows hold S = Q.K^T and
// dP = dO.V^T for each kept key tile, then dQ += dS.K
__global__ void __launch_bounds__(kBThreads)
attn_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ valid, const float* __restrict__ times,
                 __nv_bfloat16* __restrict__ dq, int s, int h, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemDqBf16& sm = *reinterpret_cast<SmemDqBf16*>(smem_raw);
  const int q0 = blockIdx.x * kT;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;                       // the thread's rows: r0 and r0 + 8

  load_rows_bf16(sm.own_a, q, bi, hi, q0, s, h);
  load_rows_bf16(sm.own_b, dout, bi, hi, q0, s, h);
  load_row_vectors(sm.vq, sm.tq, sm.lse, sm.del, valid, times, lse, delta, bi, hi, s, h, q0);
  const int n = build_schedule<kBWarps>(sm.sched, valid, times, bi, s, q0, true);
  uint32_t qa[4][4], oa[4][4];
  a_fragments(qa, sm.own_a, r0, t);
  a_fragments(oa, sm.own_b, r0, t);
  const int vq[2] = {sm.vq[r0], sm.vq[r0 + 8]};
  const float tq[2] = {sm.tq[r0], sm.tq[r0 + 8]};
  const float lq[2] = {sm.lse[r0], sm.lse[r0 + 8]};
  const float dq_[2] = {sm.del[r0], sm.del[r0 + 8]};
  const bool q_in[2] = {q0 + r0 < s, q0 + r0 + 8 < s};

  float adq[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[nt][e] = 0.f;

  for (int j = 0; j < n; ++j) {
    const int entry = sm.sched.list[j];
    const int k0 = (entry & 0x7fff) * kT;
    const bool partial = entry & 0x8000;
    __syncthreads();
    load_rows_bf16(sm.k, k, bi, hi, k0, s, h);
    load_rows_bf16(sm.v, v, bi, hi, k0, s, h);
    load_row_vectors(sm.vk, sm.tk, nullptr, nullptr, valid, times, nullptr, nullptr, bi, hi, s,
                     h, k0);
    __syncthreads();

    float sc[8][4], dp[8][4];
    rows_dot(sc, qa, sm.k, g, t);                     // S [queries][keys]
    rows_dot(dp, oa, sm.v, g, t);                     // dP
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = 8 * nt + 2 * t + (e & 1);     // the key column
        const int qr = e >> 1;                         // row r0 or r0 + 8
        p_and_ds(sc[nt][e], dp[nt][e], scale, lq[qr], dq_[qr], partial, q_in[qr], k0 + kj < s,
                 vq[qr], sm.vk[kj], tq[qr], sm.tk[kj]);
      }
    acc_times_rows(adq, dp, sm.k, g, t);             // dQ += dS . K
  }

#pragma unroll
  for (int qr = 0; qr < 2; ++qr) {
    const int row = q0 + r0 + 8 * qr;
    if (row >= s) continue;
    __nv_bfloat16* pq = dq + (((size_t)bi * s + row) * h + hi) * kD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(pq + 8 * nd) =
          __floats2bfloat162_rn(adq[nd][2 * qr] * scale, adq[nd][2 * qr + 1] * scale);
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch_smem(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                        Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, const int* valid, const float* times, void* dq,
           void* dk, void* dv, int b, int s, int h, int dtype, cudaStream_t stream) {
  if (s > kMaxTiles * kT || (int64_t)b * h > 65535) return (int)cudaErrorInvalidValue;
  const int rows = b * s * h;
  const dim3 grid_rows((rows + 7) / 8), grid((s + kT - 1) / kT, b * h);
  const float scale = 1.f / sqrtf((float)kD);
  cudaError_t err;
  if (dtype == 0) {
    using F = const float*;
    attn_bwd_delta<float><<<grid_rows, 256, 0, stream>>>(F(out), F(dout), delta, rows, s, h);
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = launch_smem(attn_bwd_dkdv_f32, grid, kFThreads, sizeof(SmemDkdvF32), stream, F(q),
                        F(k), F(v), F(dout), lse, (const float*)delta, valid, times,
                        static_cast<float*>(dk), static_cast<float*>(dv), s, h, scale);
    if (err == cudaSuccess)
      err = launch_smem(attn_bwd_dq_f32, grid, kFThreads, sizeof(SmemDqF32), stream, F(q), F(k),
                        F(v), F(dout), lse, (const float*)delta, valid, times,
                        static_cast<float*>(dq), s, h, scale);
    return (int)err;
  }
  using B = const __nv_bfloat16*;
  attn_bwd_delta<__nv_bfloat16><<<grid_rows, 256, 0, stream>>>(B(out), B(dout), delta, rows, s,
                                                                 h);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_smem(attn_bwd_dkdv_bf16, grid, kBThreads, sizeof(SmemDkdvBf16), stream, B(q),
                      B(k), B(v), B(dout), lse, (const float*)delta, valid, times,
                      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), s, h,
                      scale);
  if (err == cudaSuccess)
    err = launch_smem(attn_bwd_dq_bf16, grid, kBThreads, sizeof(SmemDqBf16), stream, B(q), B(k),
                      B(v), B(dout), lse, (const float*)delta, valid, times,
                      static_cast<__nv_bfloat16*>(dq), s, h, scale);
  return (int)err;
}

}  // namespace bwd

}  // namespace

// dtype: 0 = float32 (attn_fwd_f32), 1 = bfloat16 (attn_fwd_wgmma). Pointers
// are device pointers of contiguous tensors: q/k/v/out [b, s, h, d], valid
// [b, s] int32, times [s] float32, lse [b, h, s] float32 or null (then the
// row log-sum-exp is not written); bf16 q/k/v 16-byte aligned and s <=
// 65,536. Launches on `stream`; returns a cudaError_t, or 1000 + the
// CUresult of a tensor map that could not be encoded.
extern "C" int deepv_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* valid, const void* times, void* out, void* lse,
                                   int b, int s, int h, int d, int dtype, void* stream) {
  if (d != kD || b <= 0 || s <= 0 || h <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return wg::launch(q, k, v, static_cast<const int*>(valid), static_cast<const float*>(times),
                      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), b, s, h, st);
  const dim3 grid((s + kBQ - 1) / kBQ, b * h);
  const float scale = 1.f / sqrtf((float)d);
  cudaError_t err = allow_smem(attn_fwd_f32, sizeof(SmemF32));
  if (err != cudaSuccess) return (int)err;
  attn_fwd_f32<<<grid, kThreads, sizeof(SmemF32), st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(valid),
      static_cast<const float*>(times), static_cast<float*>(out), static_cast<float*>(lse), s,
      h, scale);
  return (int)cudaGetLastError();
}

// The backward of deepv_attention_fwd: dq, dk, dv [b, s, h, d] of q/k/v
// given out and dout [b, s, h, d] (q's dtype), the forward's lse [b, h, s]
// (natural log) and a float32 scratch delta [b, h, s]; bf16 q/k/v/dout
// 16-byte aligned. Launches attn_bwd_delta, then attn_bwd_dkdv_* and
// attn_bwd_dq_* on `stream`; returns a cudaError_t.
extern "C" int deepv_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta,
                                   const void* valid, const void* times, void* dq, void* dk,
                                   void* dv, int b, int s, int h, int d, int dtype,
                                   void* stream) {
  if (d != kD || b <= 0 || s <= 0 || h <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return bwd::launch(q, k, v, out, dout, static_cast<const float*>(lse),
                     static_cast<float*>(delta), static_cast<const int*>(valid),
                     static_cast<const float*>(times), dq, dk, dv, b, s, h, dtype,
                     reinterpret_cast<cudaStream_t>(stream));
}
