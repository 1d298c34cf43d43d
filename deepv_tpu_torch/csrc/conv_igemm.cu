// Implicit-GEMM 3x3x3 causal conv for Hopper (sm_90a), with a plain C interface.
//
// Replaces deepv_tpu/ops/conv_igemm.py::_kernel (the Pallas TPU kernel behind
// conv3d_igemm). For x [b, ci, t_in, h, w], a weight w [co, ci, 3, 3, 3] and a
// bias [co] in x's dtype:
//
//   y[b, co, t, h, w] = bias[co] + sum_{kt,kh,kw,ci} w[co, ci, kt, kh, kw]
//                         * x[b, ci, t + kt - time_pad, h + kh - 1, w + kw - 1]
//
// with zeros outside the input (time_pad = 2: two causal zero frames in the
// past; time_pad = 0: the context frames are already in x). f32 accumulation,
// the bias added in f32 after the sum, one rounding to x's dtype at the store.
//
// What bounds it on the H100: at the VAE's eligible layers (ci, co = 128..2048,
// h x w = 48x64 .. 384x512) a call does 2*27*ci*co operations per output pixel
// against 2*(ci + co) bytes, 1e3-1e4 operations per byte: the tensor cores
// bound it, far above the bf16 ridge point (~295 operations per byte). Inside
// the card the next limit is the bytes a tile pulls from L2 per operation.
//
// Two conv kernels, chosen by the wrapper (ops/conv_igemm.py::kernel_for):
//
// conv3d_igemm_wgmma<BN, A> (bf16), one template whose A operand comes from
// one of two layouts of x; the B operand, the K walk, the tiles and the
// epilogue are shared:
//   * GEMM view: M = output pixels, N = co, K = 27 taps x ci.
//   * An M tile is two "runs" of 64 output pixels, each one row segment of
//     one frame; wide frames put several runs in a row, 64-wide frames one.
//     Runs past w or h compute on zeros or halo rows and are not stored.
//   * K walks (kt, kh, 64-channel chunk) "units", kt-major; one A load per
//     unit and run serves the three kw taps. Units whose input frame lies
//     wholly in the causal past are skipped. TMA zero-fills every element
//     outside x, negative coordinates included: the spatial halo and the
//     causal past cost nothing, no padded copy of x is made.
//   * A = kNcdhw, x [b, ci, t, h, w] read along w (every conv of the
//     rollout; w % 8 == 0): a 5-D tensor map with w innermost loads one
//     unswizzled [64 ci][88 px] box per unit and run, columns w0 - 8 ..
//     w0 + 79. This A is MN-major, and a shift of one column breaks the
//     16-byte alignment a shared-memory wgmma descriptor needs, so the
//     consumers read the shifted A operand into registers (the m16n8k16 A
//     fragment, 16-bit shared loads) and issue wgmma with A from registers.
//   * A = kCl, x channels-last (ci innermost: the view the encoder's mid
//     block hands on after its attention, or the wrapper's channels-last
//     copy of an x that TMA cannot read along w, w % 8 != 0): x's own
//     layout is the K-major A wgmma reads from shared memory, so no register
//     staging. A 5-D map over (ci, w, h, t, b), b and t apart so that a
//     negative t reads zeros and never the previous batch's frames, loads
//     per unit and run one box of [66 px][64 ci], w0 - 1 .. w0 + 64, with
//     the 128-byte swizzle, 1024-byte aligned: tap kw is the descriptor of
//     the same box started kw 128-byte rows in (the swizzle is a function
//     of the absolute shared-memory address, so the shifted start reads the
//     shifted rows). wgmma.m64n128k16 with A and B from shared memory; one
//     wgmma group stays in flight. This path replaces an earlier cp.async
//     gather kernel: WMMA on sm_80 fragments, every K step walked (the
//     causal past too), 96 CTAs at the rollout's call, and a second weight
//     layout made on every call.
//     Two other A loads were measured against this one on the H100 and
//     dropped, both slower at the rollout's call (PERF.md): three swizzled
//     boxes of [64 px][64 ci] per unit and run, one per kw (three times the
//     bytes), and eight unswizzled [66 px][8 ci] boxes, 16-byte core-matrix
//     columns read 16*kw bytes on (conv_int8.cu's layout; eight TMA loads).
//   * B is K-major: the wrapper re-lays the weight out to [27, co, ci], and a
//     3-D tensor map loads one [BN co][64 ci] box per tap with the 128-byte
//     swizzle that the wgmma descriptor reads.
//   * Warp-specialised: warpgroup 0 gives up its registers and one thread
//     keeps both rings (A units, B taps) full with TMA and mbarriers;
//     warpgroups 1 and 2 each take one run and issue wgmma (bf16 in, f32
//     accumulators in registers) on the stages that have arrived, releasing
//     each stage to the producer by its mbarrier. No block-wide barrier in
//     the K loop.
//   * Tiles (ops/conv_igemm.py::tile_plan), one CTA an SM: 128 pixels x
//     256 channels or x 128 from x [b, ci, t, h, w]; 128 x 128 from x
//     channels-last. A 128 x 64 tile, two CTAs an SM, put a CTA on every SM
//     at the encoder's 512->512 @48x64 call (192 CTAs, where 128 x 128
//     leaves 36 of 132 SMs idle), but each CTA re-reads the run's A for half
//     the products, and it measured slower there; it was dropped.
//   * Epilogue: bias added in f32, one rounding, the tile transposed through
//     shared memory to [co][pixel] and stored 16 bytes (8 pixels) a thread
//     into y [b, co, t, h, w] (element by element where w % 8 != 0), clipped
//     at w and h; 64-bit offsets.
//
// conv3d_igemm_tf32x3 (float32), the channels-last path's structure on the
// TF32 tensor cores by 3xTF32 (tf32x3.cuh): each f32 product is three TF32
// products, small.big + big.small + big.big, of operands split as big =
// tf32(x) and small = tf32(x - big), with f32 accumulation, about f32
// accuracy at three times the TF32 work (165 TF/s of f32 products against
// the 67 TF/s of f32 FMA). wgmma takes tf32 only K-major, from shared
// memory, which channels-last x and the [27, co, ci] weight are:
//   * split_tf32_cl splits once per call: x (any strides) into two
//     channels-last planes [2][b, t, h, w, ci] (big, small) in one pass
//     through a shared-memory transpose, and the weight [co, ci, 27] into
//     two planes of the [27, co, ci] layout (the same transpose, ci*co
//     "channels" of 27 "pixels"), so the main loop does no conversion.
//   * 32 f32 channels make one 128-byte row, so the cl path's A trick holds:
//     one swizzled TMA box of [66 px][32 ci] per unit (kt, kh, 32-channel
//     chunk), run and plane, read for tap kw from row kw on; the planes are
//     the map's batch dimension (plane * b + batch). B stages hold one
//     tap's [128 co][32 ci] of both planes.
//   * Per tap and run, 4 k8 slices x 3 wgmma.m64n128k8.f32.tf32.tf32 with A
//     and B from shared memory. The tensor cores round each product into
//     their accumulator with less than f32's precision (on an H100 the error
//     grew with K, to 1.3e-3 at ci = 512), so a tap's 12 products start a
//     partial sum that is added to the f32 accumulator in registers. Units
//     whose input frame lies wholly in the causal past are skipped.
//   * The same producer thread and two consumer warpgroups, 128 x 128 tiles,
//     and an f32 epilogue (bias added after the sum, 16-byte stores).
//   It replaces a plain FMA kernel on a channels-last copy (a 64 x 64 tile,
//   synchronous scattered loads, every tap walked) that reached 42% of the
//   f32 FMA rate on an H100.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

// ---------------------------------------------------------------------------
// TMA-fed wgmma: bf16 with A from x [b, ci, t, h, w] or from x channels-last,
// f32 by 3xTF32 from split channels-last planes
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

// where the A operand comes from (see the note at the top)
enum ASource : int { kNcdhw = 0, kCl = 1 };

constexpr int kRun = 64;                    // output pixels of a run: one row segment
constexpr int kHalo = 8;                    // columns loaded left of a run: one 16-byte unit
constexpr int kBoxW = 88;                   // columns of an A box, w0 - 8 .. w0 + 80 (176 bytes)
constexpr int kBK = 64;                     // input channels per K step
constexpr int kThreads = 384;               // warpgroup 0: producer; 1, 2: consumers
constexpr int kConsumers = 256;
constexpr int kBoxBytes = kBK * kBoxW * 2;  // one [64 ci][88 px] box, 11 KB
constexpr int kRingBudget = 216 * 1024;    // of the 227 KB a block may use
// channels-last A: a box of [66 px][64 ci] with 128-byte rows, swizzled
constexpr int kClW = kRun + 2;
constexpr int kBoxSwz = (kClW * 128 + 1023) / 1024 * 1024;

// An M tile is two runs, one per consumer warpgroup (64 output rows of
// wgmma each); BN: output channels of the tile. B stages hold one tap's
// [BN co][64 ci]; A stages one (kt, kh, 64-channel chunk)'s A loads for
// both runs, which serve the three kw taps.
constexpr int kRuns = 2;
constexpr int kBM = kRun * kRuns;

template <int BN, int A>
struct Tile {
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kBStages = BN == 128 ? 8 : 4;
  static constexpr int kABytes = A == kNcdhw ? kRuns * kBoxBytes : kRuns * kBoxSwz;
  static constexpr int kATx = A == kNcdhw ? kABytes : kRuns * kClW * kBK * 2;
  static constexpr int kAFit = (kRingBudget - kBStages * kBBytes) / kABytes;
  static constexpr int kAStages = kAFit > 4 ? 4 : kAFit;
  static constexpr int kRingBytes = kBStages * kBBytes + kAStages * kABytes;
  static constexpr int kAcc = BN / 2;                                  // f32 a thread per run
  static constexpr int kLdC = kBM + 8;                                 // bf16 [co][px] row stride
  static_assert(kAStages >= 2, "fewer than two A stages");
  static_assert(kRingBytes <= kRingBudget, "the rings exceed their budget");
  static_assert(BN * kLdC * 2 <= kRingBytes, "epilogue tile exceeds the ring");
  static constexpr int kBarBytes = 2 * (kAStages + kBStages) * 8;
  static constexpr int kSmemBytes = kRingBytes + kBarBytes + 1024;     // + alignment slack
};

struct Params {
  int b, ci, co, t_out, h, w, time_pad;
  int runs_per_row, m_tiles;
  const __nv_bfloat16* bias;
  __nv_bfloat16* y;
};

// D[64 x N] += A[64 x 16] * B[16 x N], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x N] += A[64 x 16] * B[16 x N]: A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (BN == 256) {
    wgmma_rs_m64n256k16(d, a, db);
  } else {
    wgmma_rs_m64n128k16(d, a, db);
  }
}

__device__ __forceinline__ void consumer_sync() {   // the two consumer warpgroups only
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// Run `run` of the frame: its row and first column.
__device__ __forceinline__ void run_origin(int runs_per_row, int run, int& hh, int& w0) {
  hh = run / runs_per_row;
  w0 = (run - hh * runs_per_row) * kRun;
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

template <int BN, int A>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_igemm_wgmma(const __grid_constant__ CUtensorMap tmap_x,
                   const __grid_constant__ CUtensorMap tmap_w, const Params p) {
  using T = Tile<BN, A>;
  static_assert(A == kNcdhw || BN == 128, "channels-last x takes the 128-wide tile");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // swizzled tiles and wgmma descriptors want 1024-byte aligned stages
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = wg_smem + (base - raw);
  const uint32_t b_ring = base;                                  // kBStages x [BN][64] bf16
  const uint32_t a_ring = base + T::kBStages * T::kBBytes;       // kAStages x both runs' A
  const uint32_t a_full = base + T::kRingBytes;                  // barriers, 8 bytes each
  const uint32_t a_empty = a_full + T::kAStages * 8;
  const uint32_t b_full = a_empty + T::kAStages * 8;
  const uint32_t b_empty = b_full + T::kBStages * 8;

  const int m_tile = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int bi = blockIdx.z / p.t_out;
  const int to = blockIdx.z - bi * p.t_out;
  const int chunks = p.ci / kBK;
  // K loop: units (kt, kh, 64-channel chunk), each three iterations kw = 0, 1, 2.
  // Units whose input frame lies in the causal past read only zeros and are
  // skipped.
  const int u_begin = max(0, p.time_pad - to) * 3 * chunks;
  const int u_end = 9 * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kAStages; ++s) {
      mbar_init(a_full + 8 * s, 1);                              // the producer's expect_tx
      mbar_init(a_empty + 8 * s, kConsumers);                    // every consumer thread
    }
    for (int s = 0; s < T::kBStages; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ---- producer: one thread keeps both rings full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int ib = 0;
      for (int u = u_begin, ia = 0; u < u_end; ++u, ++ia) {
        const int sa = ia % T::kAStages;
        mbar_wait(a_empty + 8 * sa, ((ia / T::kAStages) & 1) ^ 1);
        mbar_expect_tx(a_full + 8 * sa, T::kATx);
        const int g = u / chunks;
        const int c0 = (u - g * chunks) * kBK;
        const int kt = g / 3, kh = g - 3 * (g / 3);
        const int ti = to + kt - p.time_pad;
        const uint32_t stage = a_ring + sa * T::kABytes;
        for (int r = 0; r < kRuns; ++r) {
          int hh, w0;
          run_origin(p.runs_per_row, m_tile * kRuns + r, hh, w0);
          if constexpr (A == kNcdhw) {
            tma_load_5d(stage + r * kBoxBytes, &tmap_x, a_full + 8 * sa, w0 - kHalo, hh + kh - 1,
                        ti, c0, bi);
          } else {
            tma_load_5d(stage + r * kBoxSwz, &tmap_x, a_full + 8 * sa, c0, w0 - 1, hh + kh - 1,
                        ti, bi);
          }
        }
        for (int kw = 0; kw < 3; ++kw, ++ib) {
          const int sb = ib % T::kBStages;
          mbar_wait(b_empty + 8 * sb, ((ib / T::kBStages) & 1) ^ 1);
          mbar_expect_tx(b_full + 8 * sb, T::kBBytes);
          tma_load_3d(b_ring + sb * T::kBBytes, &tmap_w, b_full + 8 * sb, c0, n0,
                      kt * 9 + kh * 3 + kw);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 takes run 0 of the tile, warpgroup 2 run 1 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x - 128;                    // 0..255
    const int run = wgi - 1;
    const int warp = (ct & 127) >> 5, lane = ct & 31;
    float acc[T::kAcc];
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;

    if constexpr (A == kNcdhw) {
      // this thread's A fragment elements: pixel m = 16 warp + lane / 4 (and
      // m + 8), channels k = 2 (lane % 4) (+1, +8, +9) of each k16 step; the
      // kw tap reads column m + kw - 1 of the run, box column m + kw + 7
      const int a_off = 2 * (lane & 3) * kBoxW + warp * 16 + (lane >> 2) + kHalo - 1;
      int ib = 0;
      for (int u = u_begin, ia = 0; u < u_end; ++u, ++ia) {
        const int sa = ia % T::kAStages;
        mbar_wait(a_full + 8 * sa, (ia / T::kAStages) & 1);
        const uint16_t* abox = reinterpret_cast<const uint16_t*>(
            smem + (a_ring - base) + sa * T::kABytes + run * kBoxBytes) + a_off;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw, ++ib) {
          uint32_t frag[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint16_t* q = abox + kw + kk * 16 * kBoxW;
            frag[kk][0] = pack2(q[0], q[kBoxW]);
            frag[kk][1] = pack2(q[8], q[kBoxW + 8]);
            frag[kk][2] = pack2(q[8 * kBoxW], q[9 * kBoxW]);
            frag[kk][3] = pack2(q[8 * kBoxW + 8], q[9 * kBoxW + 8]);
          }
          if (kw == 2) mbar_arrive(a_empty + 8 * sa);    // the boxes are in registers
          const int sb = ib % T::kBStages;
          mbar_wait(b_full + 8 * sb, (ib / T::kBStages) & 1);
          const uint32_t bs = b_ring + sb * T::kBBytes;
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            // B [BN co][64 ci], K-major, 128-byte swizzle: k16 slices are 32
            // bytes apart in each row, 8-row groups 1024 bytes apart
            wgmma_rs<BN>(acc, frag[kk], smem_desc(bs + kk * 32, 16, 1024));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc);
          mbar_arrive(b_empty + 8 * sb);
        }
      }
    } else {
      // A and B from shared memory; a tap's stages go back to the producer
      // once the next tap's group is committed and the previous one retired
      int ib = 0, prev_sa = 0, prev_sb = 0;
      bool prev = false, prev_last = false;
      for (int u = u_begin, ia = 0; u < u_end; ++u, ++ia) {
        const int sa = ia % T::kAStages;
        mbar_wait(a_full + 8 * sa, (ia / T::kAStages) & 1);
        const uint32_t astage = a_ring + sa * T::kABytes;
#pragma unroll 1
        for (int kw = 0; kw < 3; ++kw, ++ib) {
          const int sb = ib % T::kBStages;
          mbar_wait(b_full + 8 * sb, (ib / T::kBStages) & 1);
          const uint32_t bs = b_ring + sb * T::kBBytes;
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            // the run's swizzled [66 px][64 ci] box: tap kw starts kw
            // 128-byte rows in (the swizzle follows the absolute address)
            const uint64_t da = smem_desc(astage + run * kBoxSwz + kw * 128 + kk * 32, 16, 1024);
            wgmma_ss_m64n128k16(acc, da, smem_desc(bs + kk * 32, 16, 1024));
          }
          wgmma_commit();
          wgmma_wait<1>();                               // the previous tap's group retired
          fence_acc(acc);
          if (prev) {
            mbar_arrive(b_empty + 8 * prev_sb);
            if (prev_last) mbar_arrive(a_empty + 8 * prev_sa);
          }
          prev = true;
          prev_sb = sb;
          prev_sa = sa;
          prev_last = kw == 2;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
    }
    consumer_sync();                                     // the rings are free from here on
    // epilogue: bias in f32, one rounding, [co][pixel] tile in shared memory
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);
    const int px = run * kRun + warp * 16 + (lane >> 2);
#pragma unroll
    for (int i8 = 0; i8 < BN / 8; ++i8) {
      const int n = i8 * 8 + (lane & 3) * 2;
      const float b0 = __bfloat162float(p.bias[n0 + n]);
      const float b1 = __bfloat162float(p.bias[n0 + n + 1]);
      st[n * T::kLdC + px] = __float2bfloat16_rn(acc[4 * i8 + 0] + b0);
      st[(n + 1) * T::kLdC + px] = __float2bfloat16_rn(acc[4 * i8 + 1] + b1);
      st[n * T::kLdC + px + 8] = __float2bfloat16_rn(acc[4 * i8 + 2] + b0);
      st[(n + 1) * T::kLdC + px + 8] = __float2bfloat16_rn(acc[4 * i8 + 3] + b1);
    }
    consumer_sync();
    const int64_t hw = (int64_t)p.h * p.w;
    const bool vec = p.w % 8 == 0;                       // rows of y 16-byte aligned
    for (int idx = ct; idx < BN * kRuns * 8; idx += kConsumers) {
      const int n = idx / (kRuns * 8);
      const int c = idx - n * (kRuns * 8);
      const int r = c >> 3, px8 = (c & 7) * 8;
      int hh, w0;
      run_origin(p.runs_per_row, m_tile * kRuns + r, hh, w0);
      if (hh >= p.h || w0 + px8 >= p.w) continue;
      const __nv_bfloat16* src = st + n * T::kLdC + r * kRun + px8;
      __nv_bfloat16* dst = p.y + (((int64_t)bi * p.co + n0 + n) * p.t_out + to) * hw +
                           (int64_t)hh * p.w + w0 + px8;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && w0 + px8 + e < p.w; ++e) dst[e] = src[e];
      }
    }
  }
}

// x's tensor map: for kNcdhw dims (w, h, t, c, b), w innermost, boxes of
// [64 c][1][1][1 h][88 w] unswizzled (the consumers read them with any
// one-column shift), sx = x's (b, c, t, h) element strides; for the
// channels-last sources dims (c, w, h, t, b), c innermost, sx = (b, t, h,
// w): boxes of [66 w][64 c] with the 128-byte swizzle.
template <int A>
CUresult encode_x(EncodeTiled encode, CUtensorMap* tx, const void* x, const Params& p, int t_in,
                  const int64_t* sx) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  if constexpr (A == kNcdhw) {
    const cuuint64_t dim[5] = {(cuuint64_t)p.w, (cuuint64_t)p.h, (cuuint64_t)t_in,
                               (cuuint64_t)p.ci, (cuuint64_t)p.b};
    const cuuint64_t stride[4] = {(cuuint64_t)sx[3] * 2, (cuuint64_t)sx[2] * 2,
                                  (cuuint64_t)sx[1] * 2, (cuuint64_t)sx[0] * 2};
    const cuuint32_t box[5] = {kBoxW, 1, 1, kBK, 1};
    return encode(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dim, stride,
                  box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dim[5] = {(cuuint64_t)p.ci, (cuuint64_t)p.w, (cuuint64_t)p.h,
                               (cuuint64_t)t_in, (cuuint64_t)p.b};
    const cuuint64_t stride[4] = {(cuuint64_t)sx[3] * 2, (cuuint64_t)sx[2] * 2,
                                  (cuuint64_t)sx[1] * 2, (cuuint64_t)sx[0] * 2};
    const cuuint32_t box[5] = {kBK, kClW, 1, 1, 1};
    return encode(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dim, stride,
                  box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
}

template <int BN, int A>
int launch(const void* x, const void* wk, const Params& p, int t_in, const int64_t* sx,
           cudaStream_t stream) {
  using T = Tile<BN, A>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tx, tw;
  CUresult r = encode_x<A>(encode, &tx, x, p, t_in, sx);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  // weight [27, co, ci]: boxes of [BN co][64 ci]
  const cuuint64_t wdim[3] = {(cuuint64_t)p.ci, (cuuint64_t)p.co, 27};
  const cuuint64_t wstride[2] = {(cuuint64_t)p.ci * 2, (cuuint64_t)p.ci * p.co * 2};
  const cuuint32_t wbox[3] = {kBK, BN, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  r = encode(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(wk), wdim, wstride,
             wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;

  auto kernel = conv3d_igemm_wgmma<BN, A>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)p.m_tiles, (unsigned)(p.co / BN), (unsigned)(p.b * p.t_out));
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(tx, tw, p);
  return (int)cudaGetLastError();
}

// ---- f32: 3xTF32 wgmma from split channels-last planes ----

namespace tf {

using namespace tf32x3;

constexpr int kBK = 32;                          // f32 channels per unit: one 128-byte row
constexpr int kBN = 128;                         // output channels of a tile
constexpr int kBoxBytes = kBoxSwz;               // one [66 px][32 ci] f32 box, 1024-aligned
constexpr int kBoxTx = kClW * kBK * 4;           // bytes TMA writes per box
constexpr int kABytes = 2 * kRuns * kBoxBytes;   // an A stage: both planes, both runs
constexpr int kBPlane = kBN * kBK * 4;           // one plane of a tap's [128 co][32 ci], 16 KB
constexpr int kBBytes = 2 * kBPlane;             // a B stage: both planes of one tap
constexpr int kAStages = 2;
constexpr int kBStages = 4;
constexpr int kRingBytes = kAStages * kABytes + kBStages * kBBytes;
constexpr int kLdC = kBM + 4;                    // f32 [co][px] epilogue row stride
constexpr int kSmemBytes = kRingBytes + 2 * (kAStages + kBStages) * 8 + 1024;
static_assert(kRingBytes <= kRingBudget, "the rings exceed their budget");
static_assert(kBN * kLdC * 4 <= kRingBytes, "epilogue tile exceeds the ring");

struct Params {
  int b, ci, co, t_out, h, w, time_pad;
  int runs_per_row, m_tiles;
  const float* bias;
  float* y;
};

// D[64 x 128] (+)= A[64 x 8] * B[8 x 128] in TF32, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// src (n, c, t, h, w) at element strides (sn, sc, st, sh, sw) -> dst planes
// [2][n, t, h, w, c]: big = tf32(x) at dst, small = tf32(x - big) one plane
// on. Tiles of 32 pixels (t, h, w flattened) x 32 channels through shared
// memory: reads along the pixels, writes along the channels.
__global__ void __launch_bounds__(256)
split_tf32_cl(const float* __restrict__ src, float* __restrict__ dst, int n, int c, int t,
              int h, int w, int64_t sn, int64_t sc, int64_t st, int64_t sh, int64_t sw) {
  __shared__ float tile[32][33];
  const int64_t thw = (int64_t)t * h * w;
  const int64_t p_tiles = (thw + 31) / 32;
  const int c_tiles = (c + 31) / 32;
  const int64_t n_tiles = p_tiles * c_tiles * n;
  const int64_t plane = (int64_t)n * thw * c;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int64_t i = blockIdx.x; i < n_tiles; i += gridDim.x) {
    const int64_t pt = i % p_tiles;
    const int64_t rest = i / p_tiles;
    const int c0 = (int)(rest % c_tiles) * 32;
    const int bi = (int)(rest / c_tiles);
    const int64_t p0 = pt * 32;
    const int64_t p = p0 + tx;                       // the pixel this thread reads
    int64_t off = -1;
    if (p < thw) {
      const int ww = (int)(p % w);
      const int64_t q = p / w;
      off = bi * sn + (q / h) * st + (q % h) * sh + ww * sw;
    }
    __syncthreads();                                 // the previous tile's readers are done
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int cc = c0 + ty + 8 * k;
      tile[ty + 8 * k][tx] = off >= 0 && cc < c ? src[off + cc * sc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t pp = p0 + ty + 8 * k;
      const int cc = c0 + tx;
      if (pp >= thw || cc >= c) continue;
      uint32_t big, small;
      split_tf32(tile[tx][ty + 8 * k], big, small);
      const int64_t at = ((int64_t)bi * thw + pp) * c + cc;
      dst[at] = __uint_as_float(big);
      dst[plane + at] = __uint_as_float(small);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv3d_igemm_tf32x3(const __grid_constant__ CUtensorMap tmap_x,
                    const __grid_constant__ CUtensorMap tmap_w, const Params p) {
  extern __shared__ __align__(1024) unsigned char tf_smem[];
  const uint32_t raw = smem_u32(tf_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = tf_smem + (base - raw);
  const uint32_t b_ring = base;                                // kBStages x 2 planes [128][32]
  const uint32_t a_ring = base + kBStages * kBBytes;           // kAStages x 2 planes x 2 runs
  const uint32_t a_full = base + kRingBytes;                   // barriers, 8 bytes each
  const uint32_t a_empty = a_full + kAStages * 8;
  const uint32_t b_full = a_empty + kAStages * 8;
  const uint32_t b_empty = b_full + kBStages * 8;

  const int m_tile = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int bi = blockIdx.z / p.t_out;
  const int to = blockIdx.z - bi * p.t_out;
  const int chunks = p.ci / kBK;
  // units (kt, kh, 32-channel chunk), each three taps kw; units whose input
  // frame lies in the causal past read only zeros and are skipped
  const int u_begin = max(0, p.time_pad - to) * 3 * chunks;
  const int u_end = 9 * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAStages; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, kConsumers);
    }
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ---- producer: one thread keeps both rings full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int ib = 0;
      for (int u = u_begin, ia = 0; u < u_end; ++u, ++ia) {
        const int sa = ia % kAStages;
        mbar_wait(a_empty + 8 * sa, ((ia / kAStages) & 1) ^ 1);
        mbar_expect_tx(a_full + 8 * sa, 2 * kRuns * kBoxTx);
        const int g = u / chunks;
        const int c0 = (u - g * chunks) * kBK;
        const int kt = g / 3, kh = g - 3 * (g / 3);
        const int ti = to + kt - p.time_pad;
        for (int plane = 0; plane < 2; ++plane)
          for (int r = 0; r < kRuns; ++r) {
            int hh, w0;
            run_origin(p.runs_per_row, m_tile * kRuns + r, hh, w0);
            tma_load_5d(a_ring + sa * kABytes + (plane * kRuns + r) * kBoxBytes, &tmap_x,
                        a_full + 8 * sa, c0, w0 - 1, hh + kh - 1, ti, plane * p.b + bi);
          }
        for (int kw = 0; kw < 3; ++kw, ++ib) {
          const int sb = ib % kBStages;
          mbar_wait(b_empty + 8 * sb, ((ib / kBStages) & 1) ^ 1);
          mbar_expect_tx(b_full + 8 * sb, kBBytes);
          const int tap = kt * 9 + kh * 3 + kw;
          tma_load_3d(b_ring + sb * kBBytes, &tmap_w, b_full + 8 * sb, c0, n0, tap);
          tma_load_3d(b_ring + sb * kBBytes + kBPlane, &tmap_w, b_full + 8 * sb, c0, n0,
                      27 + tap);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 takes run 0 of the tile, warpgroup 2 run 1 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x - 128;                   // 0..255
    const int run = wgi - 1;
    const int warp = (ct & 127) >> 5, lane = ct & 31;
    // each tap's 12 products go into a partial sum, started by its first
    // wgmma (scale-d 0), which is then added to the f32 accumulator
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) { acc[i] = 0.f; part[i] = 0.f; }

    int ib = 0;
    for (int u = u_begin, ia = 0; u < u_end; ++u, ++ia) {
      const int sa = ia % kAStages;
      mbar_wait(a_full + 8 * sa, (ia / kAStages) & 1);
      const uint32_t a_big = a_ring + sa * kABytes + run * kBoxBytes;
      const uint32_t a_small = a_big + kRuns * kBoxBytes;
#pragma unroll 1
      for (int kw = 0; kw < 3; ++kw, ++ib) {
        const int sb = ib % kBStages;
        mbar_wait(b_full + 8 * sb, (ib / kBStages) & 1);
        const uint32_t b_big = b_ring + sb * kBBytes, b_small = b_big + kBPlane;
        fence_acc(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          // k8 slices are 32 bytes apart in each 128-byte row; tap kw starts
          // kw rows into the run's box (the swizzle follows the absolute address)
          const uint32_t ka = kw * 128 + kk * 32, kb = kk * 32;
          const uint64_t dab = smem_desc(a_big + ka, 16, 1024);
          const uint64_t das = smem_desc(a_small + ka, 16, 1024);
          const uint64_t dbb = smem_desc(b_big + kb, 16, 1024);
          const uint64_t dbs = smem_desc(b_small + kb, 16, 1024);
          wgmma_m64n128k8_tf32(part, das, dbb, kk);
          wgmma_m64n128k8_tf32(part, dab, dbs, 1);
          wgmma_m64n128k8_tf32(part, dab, dbb, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(part);
        mbar_arrive(b_empty + 8 * sb);
        if (kw == 2) mbar_arrive(a_empty + 8 * sa);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
    }
    consumer_sync();                                   // the rings are free from here on
    // epilogue: bias in f32 after the sum, the [co][pixel] tile in shared memory
    float* stile = reinterpret_cast<float*>(smem);
    const int px = run * kRun + warp * 16 + (lane >> 2);
#pragma unroll
    for (int i8 = 0; i8 < kBN / 8; ++i8) {
      const int n = i8 * 8 + (lane & 3) * 2;
      const float b0 = p.bias[n0 + n], b1 = p.bias[n0 + n + 1];
      stile[n * kLdC + px] = acc[4 * i8 + 0] + b0;
      stile[(n + 1) * kLdC + px] = acc[4 * i8 + 1] + b1;
      stile[n * kLdC + px + 8] = acc[4 * i8 + 2] + b0;
      stile[(n + 1) * kLdC + px + 8] = acc[4 * i8 + 3] + b1;
    }
    consumer_sync();
    const int64_t hw = (int64_t)p.h * p.w;
    const bool vec = p.w % 4 == 0;                     // rows of y 16-byte aligned
    for (int idx = ct; idx < kBN * kRuns * 16; idx += kConsumers) {
      const int n = idx / (kRuns * 16);
      const int c = idx - n * (kRuns * 16);
      const int r = c >> 4, px4 = (c & 15) * 4;
      int hh, w0;
      run_origin(p.runs_per_row, m_tile * kRuns + r, hh, w0);
      if (hh >= p.h || w0 + px4 >= p.w) continue;
      const float* src = stile + n * kLdC + r * kRun + px4;
      float* dst = p.y + (((int64_t)bi * p.co + n0 + n) * p.t_out + to) * hw +
                   (int64_t)hh * p.w + w0 + px4;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
        for (int e = 0; e < 4 && w0 + px4 + e < p.w; ++e) dst[e] = src[e];
      }
    }
  }
}

// The planes' tensor maps: x planes [2 b, t, h, w, ci] as dims (ci, w, h, t,
// 2 b), boxes of [66 w][32 ci]; weight planes [2 * 27, co, ci] as dims (ci,
// co, 54), boxes of [128 co][32 ci]; both with the 128-byte swizzle
int launch(const float* xp, const float* wp, const Params& p, int t_in, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tx, tw;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const cuuint64_t xdim[5] = {(cuuint64_t)p.ci, (cuuint64_t)p.w, (cuuint64_t)p.h,
                              (cuuint64_t)t_in, (cuuint64_t)(2 * p.b)};
  const cuuint64_t xstride[4] = {(cuuint64_t)p.ci * 4, (cuuint64_t)p.w * p.ci * 4,
                                 (cuuint64_t)p.h * p.w * p.ci * 4,
                                 (cuuint64_t)t_in * p.h * p.w * p.ci * 4};
  const cuuint32_t xbox[5] = {kBK, kClW, 1, 1, 1};
  CUresult r = encode(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(xp), xdim,
                      xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const cuuint64_t wdim[3] = {(cuuint64_t)p.ci, (cuuint64_t)p.co, 54};
  const cuuint64_t wstride[2] = {(cuuint64_t)p.ci * 4, (cuuint64_t)p.ci * p.co * 4};
  const cuuint32_t wbox[3] = {kBK, kBN, 1};
  r = encode(&tw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(wp), wdim, wstride, wbox,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  cudaError_t err = cudaFuncSetAttribute(conv3d_igemm_tf32x3,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)p.m_tiles, (unsigned)(p.co / kBN), (unsigned)(p.b * p.t_out));
  conv3d_igemm_tf32x3<<<grid, kThreads, kSmemBytes, stream>>>(tx, tw, p);
  return (int)cudaGetLastError();
}

}  // namespace tf

}  // namespace wg

}  // namespace

// Kernel split_tf32_cl: src, float32 (n, c, t, h, w) at element strides
// (sn, sc, st, sh, sw), into dst, two contiguous float32 planes [2][n, t, h,
// w, c] (big = tf32(x), small = tf32(x - big)). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int deepv_split_tf32_cl(const void* src, void* dst, int n, int c, int t, int h, int w,
                                   int64_t sn, int64_t sc, int64_t st, int64_t sh, int64_t sw,
                                   void* stream) {
  if (n <= 0 || c <= 0 || t <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int64_t tiles = ((int64_t)t * h * w + 31) / 32 * ((c + 31) / 32) * n;
  const unsigned grid = (unsigned)(tiles < (1 << 20) ? tiles : (1 << 20));
  wg::tf::split_tf32_cl<<<grid, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), n, c, t, h, w, sn, sc, st, sh,
      sw);
  return (int)cudaGetLastError();
}

// Kernel conv3d_igemm_tf32x3, float32. xp: x's planes from split_tf32_cl,
// [2][b, t_in, h, w, ci]; wp: the weight's planes [2][27, co, ci]; bias
// [co]; y [b, co, t_out, h, w] contiguous. The grid follows
// ops/conv_igemm.py::make_plan at 128-wide tiles: runs_per_row = ceil(w /
// 64), m_tiles = ceil(h * runs_per_row / 2). Requires ci, co multiples of
// 128, even h and w, 16-byte aligned xp, wp and y, time_pad 0 or 2 and
// t_out = t_in + time_pad - 2 >= 1. Launches on `stream`; returns a
// cudaError_t, or 1000 + the CUresult of a tensor map that could not be
// encoded.
extern "C" int deepv_conv3d_igemm_tf32x3(const void* xp, const void* wp, const void* bias,
                                         void* y, int b, int ci, int co, int t_in, int t_out,
                                         int h, int w, int time_pad, void* stream) {
  if (b <= 0 || ci <= 0 || co <= 0 || h <= 0 || w <= 0 || ci % 128 || co % 128 || h % 2 ||
      w % 2 || (time_pad != 0 && time_pad != 2) || t_out < 1 ||
      t_out != t_in + time_pad - 2 || (int64_t)b * t_out > 65535 ||
      reinterpret_cast<uintptr_t>(xp) % 16 || reinterpret_cast<uintptr_t>(wp) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorInvalidValue;
  wg::tf::Params p;
  p.b = b; p.ci = ci; p.co = co; p.t_out = t_out; p.h = h; p.w = w; p.time_pad = time_pad;
  p.runs_per_row = (w + wg::kRun - 1) / wg::kRun;
  p.m_tiles = (int)(((int64_t)h * p.runs_per_row + wg::kRuns - 1) / wg::kRuns);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  return wg::tf::launch(static_cast<const float*>(xp), static_cast<const float*>(wp), p, t_in,
                        reinterpret_cast<cudaStream_t>(stream));
}

// Kernel conv3d_igemm_wgmma, bfloat16 only. `a_source` says how x is laid
// out and read: 0 (kNcdhw), x [b, ci, t_in, h, w] with unit stride along w
// and element strides sx = (b, c, t, h); 1 (kCl), x with unit stride along
// ci and element strides sx = (b, t, h, w). wk [27, co, ci] contiguous
// (tap-major, ci innermost); bias [co]; y [b, co, t_out, h, w] contiguous.
// The tile is 128 pixels x bn channels: bn 256 or 128 for a_source 0, 128
// for 1. The grid and the tile's runs follow ops/conv_igemm.py::make_plan:
// runs_per_row = ceil(w / 64), m_tiles = ceil(h * runs_per_row / 2). Requires ci, co multiples of 128 (co of
// bn), even h and w, w % 8 == 0 for a_source 0, 16-byte aligned x, wk and y,
// x's strides multiples of 8 elements, time_pad 0 or 2 and t_out = t_in +
// time_pad - 2 >= 1. Launches on `stream`; returns a cudaError_t, or 1000 +
// the CUresult of a tensor map that could not be encoded.
extern "C" int deepv_conv3d_igemm_wgmma(const void* x, const void* wk, const void* bias,
                                        void* y, int b, int ci, int co, int t_in, int t_out,
                                        int h, int w, int time_pad, int64_t sx_0,
                                        int64_t sx_1, int64_t sx_2, int64_t sx_3, int bn,
                                        int a_source, void* stream) {
  const int64_t sx[4] = {sx_0, sx_1, sx_2, sx_3};
  bool strides_ok = true;
  for (int i = 0; i < 4; ++i) strides_ok = strides_ok && sx[i] > 0 && sx[i] % 8 == 0;
  const bool tile_ok = (a_source == wg::kNcdhw && (bn == 256 || bn == 128) && w % 8 == 0) ||
                       (a_source == wg::kCl && bn == 128);
  if (b <= 0 || ci <= 0 || co <= 0 || h <= 0 || w <= 0 || ci % 128 || co % 128 || h % 2 ||
      w % 2 || (time_pad != 0 && time_pad != 2) || t_out < 1 ||
      t_out != t_in + time_pad - 2 || (int64_t)b * t_out > 65535 || !tile_ok || co % bn ||
      !strides_ok || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16 ||
      reinterpret_cast<uintptr_t>(wk) % 16)
    return (int)cudaErrorInvalidValue;
  wg::Params p;
  p.b = b; p.ci = ci; p.co = co; p.t_out = t_out; p.h = h; p.w = w; p.time_pad = time_pad;
  p.runs_per_row = (w + wg::kRun - 1) / wg::kRun;
  p.m_tiles = (int)(((int64_t)h * p.runs_per_row + wg::kRuns - 1) / wg::kRuns);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (a_source == wg::kCl) return wg::launch<128, wg::kCl>(x, wk, p, t_in, sx, st);
  return bn == 256 ? wg::launch<256, wg::kNcdhw>(x, wk, p, t_in, sx, st)
                   : wg::launch<128, wg::kNcdhw>(x, wk, p, t_in, sx, st);
}
