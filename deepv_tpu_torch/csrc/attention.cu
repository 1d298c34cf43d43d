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
// attn_fwd_tf32x3 (f32; training in f32 runs it, and f32 forwards): the
// dQ kernel's shape below (attn_bwd_dq_tf32x3), one CTA per (64 query rows,
// batch*head), 4 warps of 16 rows, on the TF32 tensor cores by 3xTF32 (each
// product three mma.sync TF32 products of split operands, about f32
// accuracy: tf32x3.cuh). Q is split into registers once; the kept K and V
// tiles (the backward's mask schedule, the own tile on the query side) come
// through a 2-stage cp.async ring of 68-float rows; S = Q.K^T, the online
// softmax in base 2 in the accumulators' registers (row max and sum over the
// 4 lanes of a row), O += P.V with P straight from the accumulators in the
// permuted k order. The grid launches the last query tiles (the longest under
// a causal mask) first. wgmma takes tf32 only with both operands K-major, and
// P.V's V is MN-major, so mma.sync reads V in either orientation instead.
// It replaces a plain FMA kernel that reached a fifth of the f32 FMA rate
// on an H100.
//
// Both forwards write, when given an lse pointer (training), each row's
// log-sum-exp of its masked, scaled logits in the natural log, [b, h, S]
// f32: m + log(l) (both keep m and l in base 2 and store ln 2 * (m +
// log2 l)). Without it (inference) nothing changes: the output is the same
// bit for bit.
//
// Backward (no TPU kernel: deepv_tpu trains through its jnp attention,
// models/mmdit.py:289-299, which jax.value_and_grad differentiates). With
// scale = 1/8, P = exp(Q.K^T * scale - LSE) on allowed pairs (else 0),
// D = rowsum(dO * O): dV = P^T dO, dS = P * (dP - D) with dP = dO V^T,
// dQ = dS K * scale, dK = dS^T Q * scale. Five S x S x 64 products over the
// allowed pairs bound it (3.8e10 FLOP at the stage-2 training layout, b=1,
// S=2,093, against 51 MB of q, k, v, O, dO in and dq, dk, dv out in bf16:
// ~750 operations a byte, past the bf16 ridge of ~295). The design:
//   * attn_bwd_delta: D, one warp per row;
//   * attn_bwd_dkdv_*: one CTA per (64 keys, batch*head) keeps its K and V,
//     walks the query tiles its mask schedule keeps, recomputes S^T and
//     dP^T, P^T and dS^T, and accumulates dK and dV in registers;
//   * attn_bwd_dq_*: one CTA per (64 query rows, batch*head) keeps Q and dO,
//     walks its key tiles, recomputes S and dP and accumulates dQ.
//   Seven products where five would do, but no float atomics: each gradient
//   row is summed by one thread in a fixed order, so two runs agree bit for
//   bit. The grid is (batch*head, S / 64) and launches tile-major with the
//   heaviest tiles first (the first keys, the last query rows), so the long
//   CTAs of a causal mask do not finish last; the dQ kernel is launched as
//   the dK/dV kernel's programmatic dependent, so that their CTAs share the
//   card and their tails overlap. Two CTAs of 64 own rows share an SM;
//   CTAs of 128 own rows (two warpgroups sharing each streamed tile) were
//   tried on an H100 and were not faster: coarser tiles balance the
//   triangular work worse, and one CTA an SM leaves its prologue unhidden.
//   * Mask schedule: each CTA classifies its own tile against every 64-row
//     tile of the sequence by the forward's rule (tile_classes at (64, 64))
//     and walks only kept tiles; only partial tiles build the mask. A row
//     past S gets LSE = +inf, so its P is 0 in a full tile too. P is taken
//     in base 2: exp2(S * scale log2 e - LSE log2 e).
//   * bf16 (attn_bwd_*_wgmma): the forward's shape. One consumer warpgroup
//     and one producer warp; TMA loads the own tiles once and the producer
//     streams the other side's two 64-row tiles through a 3-stage ring on
//     mbarriers, with the rows' LSE, D, valid and times beside them. The
//     first two products are wgmma.m64n64k16 with both operands K-major in
//     shared memory (S^T = K.Q^T, dP^T = V.dO^T; S = Q.K^T, dP = dO.V^T); P
//     and dS are computed in the accumulators' registers, rounded to bf16 (as
//     the forward rounds P) and repacked in registers as the A operand of the
//     second products (dV += P^T.dO, dK += dS^T.Q; dQ += dS.K), whose B tile
//     [rows][64] is read MN-major through the transpose-B bit.
//   * f32 (attn_bwd_*_tf32x3): 3xTF32 on the tensor cores. Each f32 operand
//     x splits in registers as big = tf32(x) and small = tf32(x - big), both
//     rounded to nearest, ties away (cvt.rna's rounding, done as (bits +
//     0x1000) & ~0x1fff: ptxas emulates the cvt with a longer sequence);
//     each product is three mma.sync.m16n8k8 TF32 products (small.big +
//     big.small + big.big) with f32 accumulation, which keeps about f32
//     accuracy (the dropped small.small term is 2^-22 of the product;
//     tf32x3.cuh, shared with the f32 forward and conv_igemm.cu). wgmma
//     takes tf32 only with both operands K-major, and three of each
//     kernel's four products need a transposed one, so mma.sync reads its
//     fragments from shared memory in either orientation: rows of 68 floats
//     make both the row reads and the column reads of a fragment
//     conflict-free. Each of 4 warps owns 16 rows; all threads feed the
//     other side's tiles through a 2-stage cp.async ring of 16-byte copies
//     (zero fill past S). The second products take P and dS straight from
//     the accumulators: their k order is permuted (k t <-> column 2t, k t +
//     4 <-> column 2t + 1), so the accumulator is the A fragment, and B is
//     read in the same order.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kD = 64;          // head dim
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row r of the (b, h) slice of a [b, S, h, 64] tensor.
template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* base, int bi, int hi, int r,
                                            int s, int h) {
  return base + (((size_t)bi * s + r) * h + hi) * kD;
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

using namespace hopper;
using namespace tf32x3;

constexpr int kT = 64;           // own rows of a CTA; rows of a streamed tile
constexpr int kMaxTiles = 1024;  // 64-row tiles of one sequence: S <= 65,536
constexpr float kLog2e = 1.4426950408889634f;

// The CTA's mask schedule: its own 64-row tile against every 64-row tile of
// the sequence, by the rule of ops/attention.py::tile_classes at (64, 64),
// the own tile on the query side (dQ kernels) or the key side (dK/dV
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

// The CTA's own tile: grid (b * h, S / 64 tiles), launched tile-major with
// the heaviest tiles first (under a causal mask the first keys and the last
// query rows take the most tiles), so the long CTAs do not finish last.
__device__ __forceinline__ int own_tile_start(bool own_is_query) {
  return (own_is_query ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kT;
}

// The dQ kernel needs nothing the dK/dV kernel writes, so it is launched as
// that kernel's programmatic dependent: each dK/dV CTA lets it start at once
// (launch_dependents), and the two kernels' CTAs share the card, each at its
// own register count, so that their tails overlap. Every dQ thread waits for
// the dK/dV grid before it exits (wait_primary), so the call still ends when
// both have.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// A streamed tile's row vectors, [4][64] floats: LSE * log2 e (+inf past S,
// so a row past S has P = 0), D, valid (as int) and time of its 64 rows
// starting at `start`; lane `c` of the writer fills row c (lse and delta
// null: not needed)
__device__ __forceinline__ void write_row_vectors(float* vs, int c, int start,
                                                  const float* __restrict__ lse,
                                                  const float* __restrict__ delta,
                                                  const int* __restrict__ valid,
                                                  const float* __restrict__ times, int bi,
                                                  int hi, int s, int h) {
  const int row = start + c;
  const bool in = row < s;
  const size_t at = ((size_t)bi * h + hi) * s + row;
  vs[c] = in && lse != nullptr ? lse[at] * kLog2e : INFINITY;
  vs[kT + c] = in && delta != nullptr ? delta[at] : 0.f;
  reinterpret_cast<int*>(vs)[2 * kT + c] = in ? valid[(size_t)bi * s + row] : 0;
  vs[3 * kT + c] = in ? times[row] : 0.f;
}

// P = exp(logit * scale - LSE) on an allowed pair, else 0, taken in base 2
// (scale_log2 = scale log2 e, lse2 = LSE log2 e); dS = P (dP - D)
__device__ __forceinline__ void p_ds(float& sc, float& dp, bool ok, float scale_log2, float lse2,
                                     float del) {
  const float p = ok ? exp2f(fmaf(sc, scale_log2, -lse2)) : 0.f;
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

// ---- bf16: TMA-fed wgmma. One consumer warpgroup (the 64 own rows) and one
// producer warp. Shared memory from a 1024-byte aligned base: the own tiles,
// a ring of the two streamed operands and their rows' vectors, the
// mbarriers and the schedule.

constexpr int kStages = 3;                     // streamed-tile ring depth
constexpr int kTileBytes = kT * kD * 2;        // one [64][64] bf16 box, 8 KB
constexpr int kVecFloats = 4 * kT;             // a streamed tile's row vectors
constexpr int kWgThreads = 128 + 32;
constexpr int kOwnA = 0;                       // K (dK/dV) or Q (dQ)
constexpr int kOwnB = kOwnA + kTileBytes;      // V or dO
constexpr int kRingX = kOwnB + kTileBytes;     // Q or K, [kStages] boxes
constexpr int kRingY = kRingX + kStages * kTileBytes;         // dO or V
constexpr int kVec = kRingY + kStages * kTileBytes;           // float [kStages][4][64]
constexpr int kBar = kVec + kStages * kVecFloats * 4;         // own_full, full[], empty[]
constexpr int kSchedOff = kBar + 8 * (2 * kStages + 2);
constexpr int kWgSmem = kSchedOff + (int)sizeof(Sched) + 1024;  // + alignment slack

// Barriers and the own tiles' TMA loads (thread 0), then the schedule (every
// thread)
__device__ __forceinline__ int wg_setup(uint32_t base, unsigned char* smem,
                                        const CUtensorMap* own_a, const CUtensorMap* own_b,
                                        const int* __restrict__ valid,
                                        const float* __restrict__ times, int bi, int hi, int s,
                                        int own0, bool own_is_query) {
  const uint32_t own_full = base + kBar, full = own_full + 8, empty = full + 8 * kStages;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 32);                        // every producer lane
      mbar_init(empty + 8 * st, 128);                      // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(own_full, 2 * kTileBytes);
    tma_load_4d(base + kOwnA, own_a, own_full, 0, hi, own0, bi);
    tma_load_4d(base + kOwnB, own_b, own_full, 0, hi, own0, bi);
  }
  return build_schedule<kWgThreads / 32>(*reinterpret_cast<Sched*>(smem + kSchedOff), valid,
                                         times, bi, s, own0, own_is_query);
}

// The producer warp: the listed 64-row tiles of two operands through the
// ring, each stage with its rows' vectors
__device__ __forceinline__ void wg_produce(uint32_t base, unsigned char* smem, int n,
                                           const CUtensorMap* map_x, const CUtensorMap* map_y,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           const int* __restrict__ valid,
                                           const float* __restrict__ times, int bi, int hi,
                                           int s, int h) {
  const uint32_t full = base + kBar + 8, empty = full + 8 * kStages;
  const uint16_t* list = reinterpret_cast<const Sched*>(smem + kSchedOff)->list;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < n; ++j) {
    const int st = j % kStages;
    mbar_wait(empty + 8 * st, ((j / kStages) & 1) ^ 1);
    const int r0 = (list[j] & 0x7fff) * kT;
    float* vs = reinterpret_cast<float*>(smem + kVec) + st * kVecFloats;
    write_row_vectors(vs, lane, r0, lse, delta, valid, times, bi, hi, s, h);
    write_row_vectors(vs, lane + 32, r0, lse, delta, valid, times, bi, hi, s, h);
    if (lane == 0) {
      mbar_expect_tx(full + 8 * st, 2 * kTileBytes);
      tma_load_4d(base + kRingX + st * kTileBytes, map_x, full + 8 * st, 0, hi, r0, bi);
      tma_load_4d(base + kRingY + st * kTileBytes, map_y, full + 8 * st, 0, hi, r0, bi);
    } else {
      mbar_arrive(full + 8 * st);
    }
  }
}

// acc = own (64 rows, a K-major box) . streamed^T, for two (own, streamed)
// pairs, in one commit group
__device__ __forceinline__ void wg_two_products(float (&a)[32], uint32_t own_a, uint32_t xs,
                                                float (&b)[32], uint32_t own_b, uint32_t ys) {
  fence_acc(a);
  fence_acc(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wg::wgmma_ss_m64n64k16(a, smem_desc(own_a + kk * 32, 16, 1024),
                           smem_desc(xs + kk * 32, 16, 1024), kk);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wg::wgmma_ss_m64n64k16(b, smem_desc(own_b + kk * 32, 16, 1024),
                           smem_desc(ys + kk * 32, 16, 1024), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(a);
  fence_acc(b);
}

// An accumulator tile rounded to bf16 as the A fragments of its four k16
// slices (the forward's P . V repacking)
__device__ __forceinline__ void pack_a(uint32_t (&x)[4][4], const float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[kk][e] = wg::pack_bf16(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1]);
}

// acc += A (registers) . B, B a streamed [64 rows][64] box read MN-major
__device__ __forceinline__ void wg_acc_product(float (&acc)[32], const uint32_t (&a)[4][4],
                                               uint32_t bs) {
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk)
    wg::wgmma_rs_m64n64k16_tb(acc, a[kk], smem_desc(bs + kk * 2048, wg::kVLbo, wg::kVSbo));
}

// One row pair of a thread's accumulator tile stored as bf16 into [b, S, h, 64]
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* __restrict__ dst,
                                                const float (&acc)[32], float mul, int bi, int hi,
                                                int row0, int s, int h, int col_base) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= s) continue;
    __nv_bfloat16* p = dst + (((size_t)bi * s + row) * h + hi) * kD + col_base;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i + 2 * half] * mul, acc[4 * i + 2 * half + 1] * mul);
  }
}

// dK and dV of 64 keys: the warpgroup holds S^T = K.Q^T and dP^T = V.dO^T of
// each kept query tile, then dV += P^T.dO, dK += dS^T.Q
__global__ void __launch_bounds__(kWgThreads, 2)
attn_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tmap_q,
                    const __grid_constant__ CUtensorMap tmap_k,
                    const __grid_constant__ CUtensorMap tmap_v,
                    const __grid_constant__ CUtensorMap tmap_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ valid,
                    const float* __restrict__ times, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int s, int h, float scale_log2,
                    float scale) {
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const uint32_t raw = smem_u32(bwd_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = bwd_smem + (base - raw);
  launch_dependents();
  const int own0 = own_tile_start(false);
  const int bi = blockIdx.x / h, hi = blockIdx.x - bi * h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = wg_setup(base, smem, &tmap_k, &tmap_v, valid, times, bi, hi, s, own0, false);
  if (warp == 4) {
    wg_produce(base, smem, n, &tmap_q, &tmap_do, lse, delta, valid, times, bi, hi, s, h);
    return;
  }
  const uint32_t full = base + kBar + 8, empty = full + 8 * kStages;
  const uint16_t* list = reinterpret_cast<const Sched*>(smem + kSchedOff)->list;
  const int key0 = own0 + 16 * warp + (lane >> 2);                 // and key0 + 8
  const bool kin0 = key0 < s, kin1 = key0 + 8 < s;
  const int vk0 = kin0 ? valid[(size_t)bi * s + key0] : 0;
  const int vk1 = kin1 ? valid[(size_t)bi * s + key0 + 8] : 0;
  const float tk0 = kin0 ? times[key0] : 0.f, tk1 = kin1 ? times[key0 + 8] : 0.f;
  const int col_base = 2 * (lane & 3);

  float adk[32], adv[32], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) { adk[i] = 0.f; adv[i] = 0.f; sc[i] = 0.f; dp[i] = 0.f; }
  mbar_wait(base + kBar, 0);
  for (int j = 0; j < n; ++j) {
    const int st = j % kStages;
    mbar_wait(full + 8 * st, (j / kStages) & 1);
    const bool partial = list[j] & 0x8000;
    const uint32_t xs = base + kRingX + st * kTileBytes;        // Q
    const uint32_t ys = base + kRingY + st * kTileBytes;        // dO
    wg_two_products(sc, base + kOwnA, xs, dp, base + kOwnB, ys);  // S^T, dP^T: [keys][queries]

    // P^T and dS^T; sc[4i + c] is (key0, query 8i + col_base + c), sc[4i + 2 + c] key0 + 8's
    const float* vs = reinterpret_cast<const float*>(smem + kVec) + st * kVecFloats;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + col_base;
      const float2 l2 = *reinterpret_cast<const float2*>(vs + col);
      const float2 dd = *reinterpret_cast<const float2*>(vs + kT + col);
      const int2 vq =
          *reinterpret_cast<const int2*>(reinterpret_cast<const int*>(vs) + 2 * kT + col);
      const float2 tq = *reinterpret_cast<const float2*>(vs + 3 * kT + col);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int vqc = c ? vq.y : vq.x;
        const float tqc = c ? tq.y : tq.x, lc = c ? l2.y : l2.x, dc = c ? dd.y : dd.x;
        p_ds(sc[4 * i + c], dp[4 * i + c],
             !partial || (kin0 && vqc == vk0 && tqc >= tk0), scale_log2, lc, dc);
        p_ds(sc[4 * i + 2 + c], dp[4 * i + 2 + c],
             !partial || (kin1 && vqc == vk1 && tqc >= tk1), scale_log2, lc, dc);
      }
    }
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, sc);
    pack_a(da, dp);

    // dV += P^T.dO, dK += dS^T.Q
    fence_acc(adv);
    fence_acc(adk);
    wgmma_fence();
    wg_acc_product(adv, pa, ys);
    wg_acc_product(adk, da, xs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(adv);
    fence_acc(adk);
    mbar_arrive(empty + 8 * st);
  }
  store_rows_bf16(dk, adk, scale, bi, hi, key0, s, h, col_base);
  store_rows_bf16(dv, adv, 1.f, bi, hi, key0, s, h, col_base);
}

// dQ of 64 query rows: the warpgroup holds S = Q.K^T and dP = dO.V^T of each
// kept key tile, then dQ += dS.K
__global__ void __launch_bounds__(kWgThreads, 2)
attn_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tmap_q,
                  const __grid_constant__ CUtensorMap tmap_k,
                  const __grid_constant__ CUtensorMap tmap_v,
                  const __grid_constant__ CUtensorMap tmap_do, const float* __restrict__ lse,
                  const float* __restrict__ delta, const int* __restrict__ valid,
                  const float* __restrict__ times, __nv_bfloat16* __restrict__ dq, int s, int h,
                  float scale_log2, float scale) {
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const uint32_t raw = smem_u32(bwd_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = bwd_smem + (base - raw);
  const int own0 = own_tile_start(true);
  const int bi = blockIdx.x / h, hi = blockIdx.x - bi * h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = wg_setup(base, smem, &tmap_q, &tmap_do, valid, times, bi, hi, s, own0, true);
  if (warp == 4) {
    wg_produce(base, smem, n, &tmap_k, &tmap_v, nullptr, nullptr, valid, times, bi, hi, s, h);
    wait_primary();
    return;
  }
  const uint32_t full = base + kBar + 8, empty = full + 8 * kStages;
  const uint16_t* list = reinterpret_cast<const Sched*>(smem + kSchedOff)->list;
  const int row0 = own0 + 16 * warp + (lane >> 2);                 // and row0 + 8
  float lq[2], dq_[2], tq[2];
  int vq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool in = row < s;
    const size_t at = ((size_t)bi * h + hi) * s + row;
    lq[r] = in ? lse[at] * kLog2e : INFINITY;
    dq_[r] = in ? delta[at] : 0.f;
    vq[r] = in ? valid[(size_t)bi * s + row] : 0;
    tq[r] = in ? times[row] : 0.f;
  }
  const int col_base = 2 * (lane & 3);

  float adq[32], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) { adq[i] = 0.f; sc[i] = 0.f; dp[i] = 0.f; }
  mbar_wait(base + kBar, 0);
  for (int j = 0; j < n; ++j) {
    const int st = j % kStages;
    mbar_wait(full + 8 * st, (j / kStages) & 1);
    const int entry = list[j];
    const bool partial = entry & 0x8000;
    const int k0 = (entry & 0x7fff) * kT;
    const uint32_t xs = base + kRingX + st * kTileBytes;        // K
    const uint32_t ys = base + kRingY + st * kTileBytes;        // V
    wg_two_products(sc, base + kOwnA, xs, dp, base + kOwnB, ys);  // S, dP: [queries][keys]

    // P and dS; sc[4i + c] is (row0, key 8i + col_base + c), sc[4i + 2 + c] row0 + 8's
    const float* vs = reinterpret_cast<const float*>(smem + kVec) + st * kVecFloats;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + col_base;
      const int2 vk =
          *reinterpret_cast<const int2*>(reinterpret_cast<const int*>(vs) + 2 * kT + col);
      const float2 tk = *reinterpret_cast<const float2*>(vs + 3 * kT + col);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int vkc = c ? vk.y : vk.x;
        const float tkc = c ? tk.y : tk.x;
        const bool kin = k0 + col + c < s;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          p_ds(sc[4 * i + 2 * r + c], dp[4 * i + 2 * r + c],
               !partial || (kin && vq[r] == vkc && tq[r] >= tkc), scale_log2, lq[r], dq_[r]);
      }
    }
    uint32_t da[4][4];
    pack_a(da, dp);

    // dQ += dS.K
    fence_acc(adq);
    wgmma_fence();
    wg_acc_product(adq, da, xs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(adq);
    mbar_arrive(empty + 8 * st);
  }
  store_rows_bf16(dq, adq, scale, bi, hi, row0, s, h, col_base);
  wait_primary();
}

// ---- f32: 3xTF32 mma.sync.m16n8k8. 4 warps; warp w owns rows 16 w ..
// 16 w + 15 of the CTA's own tile (thread: rows g and g + 8, g = lane / 4;
// t = lane % 4). Tiles sit in shared memory at a 68-float row stride.

constexpr int kFStages = 2;                    // streamed-tile ring depth
constexpr int kLdF = kD + 4;                   // 272 bytes: conflict-free rows and columns
constexpr int kTileF = kT * kLdF;              // floats of one 64-row tile

constexpr int kFThreads = 128;
constexpr int kFOwnA = 0;                               // K (dK/dV) or Q (dQ); offsets in floats
constexpr int kFOwnB = kFOwnA + kTileF;                 // V or dO
constexpr int kFRingX = kFOwnB + kTileF;                // Q or K, [kFStages] tiles
constexpr int kFRingY = kFRingX + kFStages * kTileF;    // dO or V
constexpr int kFVec = kFRingY + kFStages * kTileF;      // [kFStages][4][64]
constexpr int kFSched = kFVec + kFStages * kVecFloats;
constexpr int kFSmem = kFSched * 4 + (int)sizeof(Sched);

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [start, start + 64) of the (b, h) slice into a [64][kLdF] tile,
// 16-byte cp.async copies by every thread, zeros past S
__device__ __forceinline__ void load_rows_async(float* dst, const float* __restrict__ src, int bi,
                                                int hi, int start, int s, int h) {
  for (int i = threadIdx.x; i < kT * (kD / 4); i += kFThreads) {
    const int r = i >> 4, c = (i & 15) * 4;
    const bool in = start + r < s;
    cp_async16(dst + r * kLdF + c, in ? row_ptr(src, bi, hi, start + r, s, h) + c : src, in);
  }
}

// The split A fragment of k-step ks of the warp's rows r, r + 8 of an own
// tile: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
__device__ __forceinline__ void split_a_fragment(uint32_t (&ab)[4], uint32_t (&as)[4],
                                                 const float* own, int r, int ks, int t) {
  const float* pa = own + r * kLdF + 8 * ks + t;
  split_tf32(pa[0], ab[0], as[0]);
  split_tf32(pa[8 * kLdF], ab[1], as[1]);
  split_tf32(pa[4], ab[2], as[2]);
  split_tf32(pa[8 * kLdF + 4], ab[3], as[3]);
}

// acc[nt] += A(k-step ks) . B^T: B a streamed [64 rows][kLdF] tile (n = its
// rows); b0 (k t, n g), b1 (k t + 4, n g)
__device__ __forceinline__ void k_step_3xtf32(float (&acc)[8][4], const uint32_t (&ab)[4],
                                              const uint32_t (&as)[4], const float* tile, int ks,
                                              int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float* pb = tile + (8 * nt + g) * kLdF + 8 * ks + t;
    mma_3xtf32(acc[nt], ab, as, pb[0], pb[4]);
  }
}

// acc[nt] = A . B^T over the head dim: A the warp's rows r, r + 8 of an own
// tile, B a streamed [64 rows][kLdF] tile
__device__ __forceinline__ void rows_dot_3xtf32(float (&acc)[8][4], const float* own,
                                                const float* tile, int r, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks) {
    uint32_t ab[4], as[4];
    split_a_fragment(ab, as, own, r, ks, t);
    k_step_3xtf32(acc, ab, as, tile, ks, g, t);
  }
}

// acc[nd] += X . B: X the warp's rows in accumulator layout (x[kk] holds
// columns 8 kk + 2t, + 1 of rows g, g + 8), B a streamed [64 rows = k][kLdF]
// tile. The k order of each k-step is permuted, k t <-> column 2t and k t + 4
// <-> column 2t + 1, so x[kk] is the A fragment as it stands and B is read
// in the same order: b0 = B[8 kk + 2t][8 nd + g], b1 = B[8 kk + 2t + 1][8 nd + g]
__device__ __forceinline__ void acc_times_rows_3xtf32(float (&acc)[8][4], const float (&x)[8][4],
                                                      const float* tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kT / 8; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(x[kk][0], ab[0], as[0]);
    split_tf32(x[kk][2], ab[1], as[1]);
    split_tf32(x[kk][1], ab[2], as[2]);
    split_tf32(x[kk][3], ab[3], as[3]);
    const float* pb = tile + (8 * kk + 2 * t) * kLdF + g;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) mma_3xtf32(acc[nd], ab, as, pb[8 * nd], pb[kLdF + 8 * nd]);
  }
}

// The warp's rows r, r + 8 (of global row0, row0 + 8) of an accumulator
// tile into [b, S, h, 64], row r times mul0, row r + 8 times mul1
__device__ __forceinline__ void store_rows_f32(float* __restrict__ dst, const float (&acc)[8][4],
                                               float mul0, float mul1, int bi, int hi, int row0,
                                               int s, int h, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= s) continue;
    const float mul = half ? mul1 : mul0;
    float* p = dst + (((size_t)bi * s + row) * h + hi) * kD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      *reinterpret_cast<float2*>(p + 8 * nd) =
          make_float2(acc[nd][2 * half] * mul, acc[nd][2 * half + 1] * mul);
  }
}

// The listed tile j of two operands into ring stage j % kFStages, with its
// rows' vectors (lse and delta null: not needed)
__device__ __forceinline__ void f32_issue(float* sm, const uint16_t* list, int j,
                                          const float* __restrict__ x,
                                          const float* __restrict__ y,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          const int* __restrict__ valid,
                                          const float* __restrict__ times, int bi, int hi, int s,
                                          int h) {
  const int st = j % kFStages;
  const int r0 = (list[j] & 0x7fff) * kT;
  load_rows_async(sm + kFRingX + st * kTileF, x, bi, hi, r0, s, h);
  load_rows_async(sm + kFRingY + st * kTileF, y, bi, hi, r0, s, h);
  if (threadIdx.x < kT)
    write_row_vectors(sm + kFVec + st * kVecFloats, threadIdx.x, r0, lse, delta, valid, times, bi,
                      hi, s, h);
}

// dK and dV of 64 keys: warp w's 16 keys hold S^T = K.Q^T and
// dP^T = V.dO^T of each kept query tile, then dV += P^T.dO, dK += dS^T.Q
__global__ void __launch_bounds__(kFThreads, 2)
attn_bwd_dkdv_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ valid, const float* __restrict__ times,
                     float* __restrict__ dk, float* __restrict__ dv, int s, int h,
                     float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  Sched& sched = *reinterpret_cast<Sched*>(sm + kFSched);
  launch_dependents();
  const int own0 = own_tile_start(false);
  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 16 * warp + g;                        // own rows r and r + 8

  load_rows_async(sm + kFOwnA, k, bi, hi, own0, s, h);
  load_rows_async(sm + kFOwnB, v, bi, hi, own0, s, h);
  const int n = build_schedule<kFThreads / 32>(sched, valid, times, bi, s, own0, false);
#pragma unroll
  for (int p = 0; p < kFStages - 1; ++p) {
    if (p < n) f32_issue(sm, sched.list, p, q, dout, lse, delta, valid, times, bi, hi, s, h);
    cp_async_commit();
  }
  const int key0 = own0 + r;
  const bool kin[2] = {key0 < s, key0 + 8 < s};
  const int vk[2] = {kin[0] ? valid[(size_t)bi * s + key0] : 0,
                     kin[1] ? valid[(size_t)bi * s + key0 + 8] : 0};
  const float tk[2] = {kin[0] ? times[key0] : 0.f, kin[1] ? times[key0 + 8] : 0.f};
  const bool warp_in = own0 + 16 * warp < s;

  float adk[8][4], adv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) { adk[nt][e] = 0.f; adv[nt][e] = 0.f; }

  for (int j = 0; j < n; ++j) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();                                  // tile j landed; tile j - 1's readers done
    if (j + kFStages - 1 < n)
      f32_issue(sm, sched.list, j + kFStages - 1, q, dout, lse, delta, valid, times, bi, hi,
                   s, h);
    cp_async_commit();
    if (!warp_in) continue;
    const int st = j % kFStages;
    const bool partial = sched.list[j] & 0x8000;
    const float* xs = sm + kFRingX + st * kTileF;   // Q
    const float* ys = sm + kFRingY + st * kTileF;   // dO
    const float* vs = sm + kFVec + st * kVecFloats;
    const int* ivs = reinterpret_cast<const int*>(vs);

    float sc[8][4], dp[8][4];
    rows_dot_3xtf32(sc, sm + kFOwnA, xs, r, g, t);  // S^T [keys][queries]
    rows_dot_3xtf32(dp, sm + kFOwnB, ys, r, g, t);  // dP^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * t + (e & 1);     // the query column
        const int kr = e >> 1;                         // key r or r + 8
        p_ds(sc[nt][e], dp[nt][e],
             !partial || (kin[kr] && ivs[2 * kT + col] == vk[kr] && vs[3 * kT + col] >= tk[kr]),
             scale_log2, vs[col], vs[kT + col]);
      }
    acc_times_rows_3xtf32(adv, sc, ys, g, t);         // dV += P^T.dO
    acc_times_rows_3xtf32(adk, dp, xs, g, t);         // dK += dS^T.Q
  }
  store_rows_f32(dk, adk, scale, scale, bi, hi, key0, s, h, t);
  store_rows_f32(dv, adv, 1.f, 1.f, bi, hi, key0, s, h, t);
}

// dQ of 64 query rows: warp w's 16 rows hold S = Q.K^T and dP = dO.V^T of
// each kept key tile, then dQ += dS.K
__global__ void __launch_bounds__(kFThreads, 2)
attn_bwd_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const int* __restrict__ valid, const float* __restrict__ times,
                   float* __restrict__ dq, int s, int h, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  Sched& sched = *reinterpret_cast<Sched*>(sm + kFSched);
  const int own0 = own_tile_start(true);
  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 16 * warp + g;                        // own rows r and r + 8

  load_rows_async(sm + kFOwnA, q, bi, hi, own0, s, h);
  load_rows_async(sm + kFOwnB, dout, bi, hi, own0, s, h);
  const int n = build_schedule<kFThreads / 32>(sched, valid, times, bi, s, own0, true);
#pragma unroll
  for (int p = 0; p < kFStages - 1; ++p) {
    if (p < n)
      f32_issue(sm, sched.list, p, k, v, nullptr, nullptr, valid, times, bi, hi, s, h);
    cp_async_commit();
  }
  const int row0 = own0 + r;
  float lq[2], dq_[2], tq[2];
  int vq[2];
#pragma unroll
  for (int qr = 0; qr < 2; ++qr) {
    const int row = row0 + 8 * qr;
    const bool in = row < s;
    const size_t at = ((size_t)bi * h + hi) * s + row;
    lq[qr] = in ? lse[at] * kLog2e : INFINITY;
    dq_[qr] = in ? delta[at] : 0.f;
    vq[qr] = in ? valid[(size_t)bi * s + row] : 0;
    tq[qr] = in ? times[row] : 0.f;
  }
  const bool warp_in = own0 + 16 * warp < s;

  float adq[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[nt][e] = 0.f;

  for (int j = 0; j < n; ++j) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();
    if (j + kFStages - 1 < n)
      f32_issue(sm, sched.list, j + kFStages - 1, k, v, nullptr, nullptr, valid, times, bi,
                   hi, s, h);
    cp_async_commit();
    if (!warp_in) continue;
    const int st = j % kFStages;
    const int entry = sched.list[j];
    const bool partial = entry & 0x8000;
    const int k0 = (entry & 0x7fff) * kT;
    const float* xs = sm + kFRingX + st * kTileF;   // K
    const float* ys = sm + kFRingY + st * kTileF;   // V
    const float* vs = sm + kFVec + st * kVecFloats;
    const int* ivs = reinterpret_cast<const int*>(vs);

    float sc[8][4], dp[8][4];
    rows_dot_3xtf32(sc, sm + kFOwnA, xs, r, g, t);  // S [queries][keys]
    rows_dot_3xtf32(dp, sm + kFOwnB, ys, r, g, t);  // dP
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * t + (e & 1);     // the key column
        const int qr = e >> 1;                         // row r or r + 8
        p_ds(sc[nt][e], dp[nt][e],
             !partial || (k0 + col < s && vq[qr] == ivs[2 * kT + col] &&
                          tq[qr] >= vs[3 * kT + col]),
             scale_log2, lq[qr], dq_[qr]);
      }
    acc_times_rows_3xtf32(adq, dp, xs, g, t);         // dQ += dS.K
  }
  store_rows_f32(dq, adq, scale, scale, bi, hi, row0, s, h, t);
  wait_primary();
}

// The forward in f32: O of 64 query rows. Warp w's 16 rows keep their Q
// split in registers, and for each kept key tile compute S = Q.K^T, the
// online softmax in base 2 (logits times scale log2 e; row max and sum over
// the 4 lanes of a row, the sum kept per lane until the end) and O += P.V
__global__ void __launch_bounds__(kFThreads, 2)
attn_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ valid,
                const float* __restrict__ times, float* __restrict__ out,
                float* __restrict__ lse, int s, int h, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  Sched& sched = *reinterpret_cast<Sched*>(sm + kFSched);
  const int own0 = own_tile_start(true);
  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 16 * warp + g;                        // own rows r and r + 8

  load_rows_async(sm + kFOwnA, q, bi, hi, own0, s, h);
  cp_async_commit();
  const int n = build_schedule<kFThreads / 32>(sched, valid, times, bi, s, own0, true);
#pragma unroll
  for (int p = 0; p < kFStages - 1; ++p) {
    if (p < n)
      f32_issue(sm, sched.list, p, k, v, nullptr, nullptr, valid, times, bi, hi, s, h);
    cp_async_commit();
  }
  const int row0 = own0 + r;
  float tq[2];
  int vq[2];
#pragma unroll
  for (int qr = 0; qr < 2; ++qr) {
    const int row = row0 + 8 * qr;
    vq[qr] = row < s ? valid[(size_t)bi * s + row] : 0;
    tq[qr] = row < s ? times[row] : 0.f;
  }
  const bool warp_in = own0 + 16 * warp < s;

  cp_async_wait<kFStages - 1>();                      // Q landed
  __syncthreads();
  uint32_t qb[kD / 8][4], qs[kD / 8][4];
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks) split_a_fragment(qb[ks], qs[ks], sm + kFOwnA, r, ks, t);

  float o[8][4];
#pragma unroll
  for (int nd = 0; nd < 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // l: this lane's columns

  for (int j = 0; j < n; ++j) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();                                  // tile j landed; tile j - 1's readers done
    if (j + kFStages - 1 < n)
      f32_issue(sm, sched.list, j + kFStages - 1, k, v, nullptr, nullptr, valid, times, bi, hi,
                s, h);
    cp_async_commit();
    if (!warp_in) continue;
    const int st = j % kFStages;
    const int entry = sched.list[j];
    const bool partial = entry & 0x8000;
    const int k0 = (entry & 0x7fff) * kT;
    const float* xs = sm + kFRingX + st * kTileF;     // K
    const float* ys = sm + kFRingY + st * kTileF;     // V
    const float* vs = sm + kFVec + st * kVecFloats;
    const int* ivs = reinterpret_cast<const int*>(vs);

    // S [queries][keys]; sc[nt][e] is (row r + 8 (e >> 1), key 8 nt + 2t + (e & 1))
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks) k_step_3xtf32(sc, qb[ks], qs[ks], xs, ks, g, t);

    // logits in the log2 domain; the mask only on partial tiles
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * t + (e & 1);
        const int qr = e >> 1;
        float x = sc[nt][e] * scale_log2;
        if (partial)
          x = k0 + col >= s ? -INFINITY
              : (vq[qr] == ivs[2 * kT + col] && tq[qr] >= vs[3 * kT + col]) ? x : kMasked;
        sc[nt][e] = x;
        mx[qr] = fmaxf(mx[qr], x);
      }
    float alpha[2];
#pragma unroll
    for (int qr = 0; qr < 2; ++qr) {
      const float mn = fmaxf(m[qr], wg::quad_max(mx[qr]));
      alpha[qr] = exp2f(m[qr] - mn);
      m[qr] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = e >> 1;
        sc[nt][e] = exp2f(sc[nt][e] - m[qr]);
        sum[qr] += sc[nt][e];
        o[nt][e] *= alpha[qr];
      }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
    acc_times_rows_3xtf32(o, sc, ys, g, t);           // O += P.V
  }

  // epilogue: 1/l, the row LSE in the natural log: ln 2 * (m + log2 l)
  const float sum0 = wg::quad_sum(l[0]), sum1 = wg::quad_sum(l[1]);
  if (lse != nullptr && t == 0) {
    float* dst = lse + ((size_t)bi * h + hi) * s;
    if (row0 < s) dst[row0] = (m[0] + log2f(sum0)) * wg::kLn2;
    if (row0 + 8 < s) dst[row0 + 8] = (m[1] + log2f(sum1)) * wg::kLn2;
  }
  store_rows_f32(out, o, 1.f / sum0, 1.f / sum1, bi, hi, row0, s, h, t);
}

template <typename Kernel, typename... Args>
cudaError_t launch_smem(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                        Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The same as a programmatic dependent of the kernel before it on `stream`
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// attn_fwd_tf32x3 on the grid (b * h, ceil(S / 64)), heaviest query tiles first
int launch_fwd_f32(const float* q, const float* k, const float* v, const int* valid,
                   const float* times, float* out, float* lse, int b, int s, int h,
                   cudaStream_t stream) {
  if (s > kMaxTiles * kT || (int64_t)b * h > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid(b * h, (s + kT - 1) / kT);
  return (int)launch_smem(attn_fwd_tf32x3, grid, kFThreads, kFSmem, stream, q, k, v, valid,
                          times, out, lse, s, h, kLog2e / sqrtf((float)kD));
}

int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, const int* valid, const float* times, void* dq,
           void* dk, void* dv, int b, int s, int h, int dtype, cudaStream_t stream) {
  if (s > kMaxTiles * kT) return (int)cudaErrorInvalidValue;
  const int n_rows = b * s * h;
  const dim3 grid_rows((n_rows + 7) / 8), grid(b * h, (s + kT - 1) / kT);
  const float scale = 1.f / sqrtf((float)kD), scale_log2 = scale * kLog2e;
  cudaError_t err;
  if (dtype == 0) {
    using F = const float*;
    attn_bwd_delta<float><<<grid_rows, 256, 0, stream>>>(F(out), F(dout), delta, n_rows, s, h);
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = launch_smem(attn_bwd_dkdv_tf32x3, grid, kFThreads, kFSmem, stream, F(q), F(k), F(v),
                        F(dout), lse, (F)delta, valid, times, static_cast<float*>(dk),
                        static_cast<float*>(dv), s, h, scale_log2, scale);
    if (err == cudaSuccess)
      err = launch_dependent(attn_bwd_dq_tf32x3, grid, kFThreads, kFSmem, stream, F(q), F(k),
                             F(v), F(dout), lse, (F)delta, valid, times, static_cast<float*>(dq),
                             s, h, scale_log2, scale);
    return (int)err;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv, tdo;                     // 64-row boxes
  CUresult r = wg::encode_map(encode, &tq, q, b, s, h, kT);
  if (r == CUDA_SUCCESS) r = wg::encode_map(encode, &tk, k, b, s, h, kT);
  if (r == CUDA_SUCCESS) r = wg::encode_map(encode, &tv, v, b, s, h, kT);
  if (r == CUDA_SUCCESS) r = wg::encode_map(encode, &tdo, dout, b, s, h, kT);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  using B = const __nv_bfloat16*;
  attn_bwd_delta<__nv_bfloat16><<<grid_rows, 256, 0, stream>>>(B(out), B(dout), delta, n_rows, s,
                                                                 h);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_smem(attn_bwd_dkdv_wgmma, grid, kWgThreads, kWgSmem, stream, tq, tk, tv, tdo,
                      lse, (const float*)delta, valid, times, static_cast<__nv_bfloat16*>(dk),
                      static_cast<__nv_bfloat16*>(dv), s, h, scale_log2, scale);
  if (err == cudaSuccess)
    err = launch_dependent(attn_bwd_dq_wgmma, grid, kWgThreads, kWgSmem, stream, tq, tk, tv,
                           tdo, lse, (const float*)delta, valid, times,
                           static_cast<__nv_bfloat16*>(dq), s, h, scale_log2, scale);
  return (int)err;
}

}  // namespace bwd

}  // namespace

// dtype: 0 = float32 (attn_fwd_tf32x3), 1 = bfloat16 (attn_fwd_wgmma).
// Pointers are device pointers of contiguous tensors: q/k/v/out [b, s, h, d],
// valid [b, s] int32, times [s] float32, lse [b, h, s] float32 or null (then
// the row log-sum-exp is not written); q/k/v 16-byte aligned and s <=
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
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  return bwd::launch_fwd_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), static_cast<const int*>(valid),
                             static_cast<const float*>(times), static_cast<float*>(out),
                             static_cast<float*>(lse), b, s, h, st);
}

// The backward of deepv_attention_fwd: dq, dk, dv [b, s, h, d] of q/k/v
// given out and dout [b, s, h, d] (q's dtype), the forward's lse [b, h, s]
// (natural log) and a float32 scratch delta [b, h, s]; bf16 q/k/v/dout
// 16-byte aligned. Launches attn_bwd_delta, then attn_bwd_dkdv_* and
// attn_bwd_dq_* (bf16: *_wgmma, f32: *_tf32x3) on `stream`; returns a
// cudaError_t, or 1000 + the CUresult of a tensor map that could not be
// encoded.
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

