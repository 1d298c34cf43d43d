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
             int s, int h, float scale) {
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
               const float* __restrict__ times, __nv_bfloat16* __restrict__ out, int s, int h,
               float scale_log2) {
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

    // epilogue: 1/l, one rounding, 4-byte stores into [b, S, h, 64]
    const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
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
           __nv_bfloat16* out, int b, int s, int h, cudaStream_t stream) {
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
  attn_fwd_wgmma<<<grid, kThreads, kSmemBytes, stream>>>(tq, tk, tv, valid, times, out, s, h,
                                                         scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32 (attn_fwd_f32), 1 = bfloat16 (attn_fwd_wgmma). Pointers
// are device pointers of contiguous tensors: q/k/v/out [b, s, h, d], valid
// [b, s] int32, times [s] float32; bf16 q/k/v 16-byte aligned and s <=
// 65,536. Launches on `stream`; returns a cudaError_t, or 1000 + the
// CUresult of a tensor map that could not be encoded.
extern "C" int deepv_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* valid, const void* times, void* out,
                                   int b, int s, int h, int d, int dtype, void* stream) {
  if (d != kD || b <= 0 || s <= 0 || h <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return wg::launch(q, k, v, static_cast<const int*>(valid), static_cast<const float*>(times),
                      static_cast<__nv_bfloat16*>(out), b, s, h, st);
  const dim3 grid((s + kBQ - 1) / kBQ, b * h);
  const float scale = 1.f / sqrtf((float)d);
  cudaError_t err = allow_smem(attn_fwd_f32, sizeof(SmemF32));
  if (err != cudaSuccess) return (int)err;
  attn_fwd_f32<<<grid, kThreads, sizeof(SmemF32), st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(valid),
      static_cast<const float*>(times), static_cast<float*>(out), s, h, scale);
  return (int)cudaGetLastError();
}
