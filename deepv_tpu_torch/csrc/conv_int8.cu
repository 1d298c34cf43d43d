// Symmetric int8 3x3x3 causal conv for Hopper (sm_90a), with a plain C interface.
//
// K3. It has no TPU kernel to replace: deepv_tpu computes the same function
// with XLA's int8 convolution (deepv_tpu/ops/conv_int8.py::conv3d_int8,
// lax.conv_general_dilated on int8 with int32 accumulation), and PyTorch has
// no int8 3D convolution on CUDA. A call is two launches:
//
// quantize_k3_input: x [b, ci, t, h, w] (bf16 or f32) and the f32 scale sx
// (one reduction over x, made by the wrapper) -> x8 [b, t, h, w, ci_pad]
// int8, channels-last, zero channels up to a multiple of 32:
//
//   x8[b, t, h, w, c] = round_half_even(f32(x[b, c, t, h, w]) / sx)   (c < ci)
//
// with IEEE division (__fdiv_rn, as the plain version divides) and
// __float2int_rn. One pass: a CTA reads a [128 ci][64 w] tile coalesced
// along w (16 bytes, 8 pixels, a thread where w % 8 == 0), packs four
// channels a 32-bit word into shared memory and writes 16 bytes (16
// channels) a thread along ci. Bound by bytes: it reads x once and writes
// x8 once.
//
// the conv (conv3d_int8_wgmma, or conv3d_int8_mma for narrow channels): for
// x8, the K-major quantised weight wk [27, co_pad, ci_pad] (tap-major, built
// once when the VAE is built), sx, the per-channel weight scales sw [co] and
// the bias [co] (bf16, f32 or none):
//
//   acc[b, co, t, h, w] = sum_{kt,kh,kw,ci} wk[kt*9 + kh*3 + kw, co, ci]
//                           * x8[b, t + kt - time_pad, h + kh - 1, w + kw - 1, ci]
//   y = (float(acc) * (sx * sw[co])) + bias[co]   (three f32 roundings, no FMA)
//
// with zeros outside the input (time_pad = 2: two causal zero frames in the
// past; time_pad = 0: the context frames are already in x8). The int32 sum
// is exact (at most 256 * 27 * 127^2 < 2^31 per output), so the
// accumulators equal the plain version's bit for bit, and y is rounded to
// the output type (bf16 or f32) once. A non-null `acc` makes the kernel
// store the int32 accumulators instead of y (the exactness check).
//
// What bounds it on the H100: 2*27*ci*co operations per output pixel against
// ci + 2*co bytes (int8 in, bf16 out), hundreds to thousands of operations
// per byte at the VAE's int8-eligible layers (ci, co = 3..256 at 384x512),
// above the int8 ridge point (~590 per byte) at ci, co >= 128: the tensor
// cores bound those; the 3-channel layers (encoder conv_in, decoder
// conv_out) move more bytes than they compute and are bound by bytes.
//
// conv3d_int8_wgmma (ci_pad a multiple of 128: 128->128, 256->128, 256->512
// and conv_out's 128->3), TMA-fed s8 wgmma:
//   * GEMM view: M = output pixels of one row segment (b, t, h, w0..w0+BM),
//     N = BN output channels (128, or 16 where co is not a multiple of 128:
//     conv_out's 3, zero-padded), K = 27 taps x ci_pad, walked in units of
//     (kt, kh, 128-channel chunk), each serving the three kw taps.
//   * A operand, K-major without swizzle: per unit and consumer warpgroup,
//     eight TMA boxes of [run + 2 pixels][16 channels] from a 5-D map over
//     x8 (dims ci, w, h, t, b; b and t apart, so a negative t reads zeros
//     and never the previous batch's frames). TMA's zero fill gives the
//     spatial halo, the causal past and the w tail. Each box is one column
//     of 16-byte core matrices with pixels 16 bytes apart, so the tap kw is
//     the same descriptor started 16*kw bytes on: one A load per unit serves
//     three taps (the choice that cuts L2 -> SM traffic, with 256-pixel
//     CTAs: see below), at 8% more bytes than the run.
//   * B operand: a 3-D map over wk, one [BN co][128 ci] box per tap with the
//     128-byte swizzle (rows of 128 bytes, 8-row groups 1024 bytes apart).
//   * Warp-specialised: warpgroup 0 gives up its registers and one thread
//     keeps the A ring (3-6 units) and the B ring (7-9 taps) full; warpgroups
//     1 and 2 each take one run of 64*MB pixels (MB = 2 where w > 128, else
//     1) and run wgmma.m64n{BN}k32.s32.s8.s8 from shared memory, MB
//     row blocks per k32 step, int32 accumulators in registers (BN/2*MB a
//     thread). One wgmma group stays in flight: a tap's stages go back to the
//     producer once the next tap's group is committed and the previous one
//     has retired.
//   * L2 -> SM traffic per CTA and unit: 2 x 8 x (run + 2) x 16 bytes of A,
//     3 x 16 KB of B, against 2 x 3 x 128 x BM x 128 operations: with BM =
//     256 that is ~0.0034 bytes an operation, ~6.7 TB/s at the int8 peak
//     (128-pixel tiles, one box per tap: ~0.0078). Measured by
//     chip_smoke.py phase 9 on an H100 SXM (700 W): ~960 TOPS at 128->128
//     (9 units a CTA), ~1,200 at 256->128 and 256->512 (18 units): the
//     per-CTA prologue and epilogue, which this non-persistent kernel does
//     not overlap with products, cost the short K loops most.
//   * Taps whose input frame lies wholly in the causal past are skipped.
//   * Epilogue: the tile goes to shared memory as [co][pixel] 32-bit words
//     (f32 values or int32 sums), then 16 bytes a thread into y [b, co, t,
//     h, w], coalesced along w; scalar stores at a w tail that is not a
//     multiple of the vector; padding channels are not stored; 64-bit
//     offsets.
//
// conv3d_int8_mma (ci_pad not a multiple of 128: encoder conv_in, ci = 3,
// ci_pad = 32), simple first: mma.sync m16n8k32 s8 with int32 accumulators
// and a cp.async ring, no TMA.
//   * GEMM view: M = output pixels of one frame (a CTA takes 128 of them),
//     N = output channels (a CTA takes 128, or 16 for narrow co such as 3),
//     K = 27 taps x ci_pad, walked 32 channels at a time.
//   * A 4-stage cp.async ring: each stage holds the A tile [128 px][32 ci]
//     (one 16-byte copy per thread; pixels whose tap falls outside x, in the
//     causal past or the spatial halo, get zeros from cp.async's zero fill)
//     and the B tile [BN co][32 ci]. Rows are 48 bytes apart, so the 32-bit
//     fragment reads of a warp hit 32 distinct banks.
//   * 8 warps: 4 x 2 warp tiles of 32 px x 64 co (BN = 128) or 8 x 1 of
//     16 px x 16 co (BN = 16); fragments are read as 32-bit words straight
//     in the m16n8k32 layouts (A row-major, B column-major).
//   * Taps whose input frame lies wholly in the causal past are skipped.
//   * Epilogue: the int32 tile goes through shared memory to [co][pixel], so
//     a warp stores 32 consecutive pixels of one channel into y [b, co, t, h,
//     w]; 64-bit offsets.
//   * The fast rollout runs only BN = 128 here (conv_in, 3 -> 128). BN = 16
//     stays because supports_int8 admits any ci and co at h >= MIN_H, and a
//     conv with neither ci_pad nor co a multiple of 128 (3 -> 3, say) has
//     no other kernel; chip_smoke.py's 3 -> 3 case holds it to the plain
//     version. Whether the wgmma kernel, with conv_in's ci padded to 128,
//     is no slower than this kernel (and could replace it) is not measured.
//
// ops/conv_int8.py::plan picks the kernel and its tile for each call.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// y = (float(a) * (sx * sw[c])) + bias[c], each product and sum rounded
// apart, as the plain version's f32 ops (no FMA).
__device__ __forceinline__ float dequant(int32_t a, float sx, const float* __restrict__ sw,
                                         const void* __restrict__ bias, int bias_bf16, int c) {
  float v = __fmul_rn(__int2float_rn(a), __fmul_rn(sx, sw[c]));
  if (bias != nullptr)
    v = __fadd_rn(v, bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[c])
                               : static_cast<const float*>(bias)[c]);
  return v;
}

// ---------------------------------------------------------------------------
// the quantise pass: x [b, ci, t, h, w] -> x8 [b, t, h, w, ci_pad]
// ---------------------------------------------------------------------------

constexpr int kQPx = 64;            // pixels (along w) of a tile
constexpr int kQCh = 128;           // channels of a tile
constexpr int kQThreads = 256;
constexpr int kQLd = kQCh / 4 + 1;  // 32-bit words between pixel rows (odd: fewer bank conflicts)

struct QShape {
  int b, ci, ci_pad, t, h, w;
};

// VEC consecutive elements of x as f32: one or two 16-byte loads for VEC = 8
template <int VEC>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);             // bf16 -> f32 is exact
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
}

// VEC = 8 where w % 8 == 0 and x is 16-byte aligned (a group of 8 pixels
// then lies inside one row, 16-byte aligned), else 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(kQThreads)
quantize_k3_input(const T* __restrict__ x, const float* __restrict__ sx_ptr,
                  int8_t* __restrict__ x8, QShape s) {
  __shared__ uint32_t tile[kQPx * kQLd];     // [pixel][4-channel word]
  const int w_tiles = (s.w + kQPx - 1) / kQPx;
  const int px0 = (blockIdx.x % w_tiles) * kQPx;
  const int c0 = (blockIdx.x / w_tiles) * kQCh;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z / s.t, tt = blockIdx.z % s.t;
  const float sx = *sx_ptr;
  const int64_t plane = (int64_t)s.t * s.h * s.w;                 // x's channel stride
  const T* xrow = x + ((int64_t)bi * s.ci * s.t + tt) * s.h * s.w + (int64_t)hh * s.w;

  // read: item i is pixels px0 + VEC (i % (64 / VEC)) .. + VEC - 1 and
  // channels c0 + 4 (i / (64 / VEC)) .. + 3; a warp's loads of one channel
  // are consecutive along w
  constexpr int kGroups = kQPx / VEC;
  for (int i = threadIdx.x; i < kGroups * (kQCh / 4); i += kQThreads) {
    const int pg = i % kGroups, q = i / kGroups;
    const int pw = px0 + pg * VEC;
    uint32_t word[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) word[e] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + 4 * q + k;
      if (c < s.ci && pw < s.w) {
        float v[VEC];
        load_f32<VEC>(xrow + c * plane + pw, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          word[e] |= (uint32_t)(__float2int_rn(__fdiv_rn(v[e], sx)) & 0xFF) << (8 * k);
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) tile[(pg * VEC + e) * kQLd + q] = word[e];
  }
  __syncthreads();
  // write: pixel i / 8, 16 channels at 16 (i % 8), 16 bytes a thread
  for (int i = threadIdx.x; i < kQPx * (kQCh / 16); i += kQThreads) {
    const int px = i / (kQCh / 16), g = i % (kQCh / 16);
    const int pw = px0 + px, c = c0 + 16 * g;
    if (pw < s.w && c < s.ci_pad) {
      const uint32_t* src = tile + px * kQLd + 4 * g;
      int8_t* dst = x8 + ((((int64_t)bi * s.t + tt) * s.h + hh) * s.w + pw) * s.ci_pad + c;
      *reinterpret_cast<uint4*>(dst) = make_uint4(src[0], src[1], src[2], src[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// conv3d_int8_mma: cp.async + mma.sync m16n8k32 (ci_pad not a multiple of 128)
// ---------------------------------------------------------------------------

constexpr int kBM = 128;          // output pixels per CTA
constexpr int kBK = 32;           // int8 input channels per K step (one mma k)
constexpr int kLd = kBK + 16;     // bytes between shared rows
constexpr int kStages = 4;
constexpr int kThreads = 256;

struct Shape {
  int b, ci_pad, co, co_pad, t_in, t_out, h, w, time_pad;
};

template <int BN>
struct Tile {
  static constexpr int kWarpsN = BN >= 64 ? 2 : 1;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kWM = kBM / kWarpsM;     // pixels of a warp tile
  static constexpr int kWN = BN / kWarpsN;      // channels of a warp tile
  static constexpr int kMT = kWM / 16;
  static constexpr int kNT = kWN / 8;
  static constexpr int kLdC = kBM + 4;          // int32 row stride of the epilogue tile
  static constexpr size_t kSmemPipe = (size_t)kStages * (kBM + BN) * kLd;
  static constexpr size_t kSmemEpi = (size_t)BN * kLdC * sizeof(int32_t);
  static constexpr size_t kSmem = kSmemPipe > kSmemEpi ? kSmemPipe : kSmemEpi;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b, m16n8k32, s8 inputs, s32 accumulators.
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv3d_int8_mma(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                const float* __restrict__ sx, const float* __restrict__ sw,
                const void* __restrict__ bias, int bias_bf16, void* __restrict__ y,
                int32_t* __restrict__ acc_out, int out_bf16, Shape s) {
  using T = Tile<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sa = reinterpret_cast<int8_t*>(smem);
  int8_t* sb = sa + kStages * kBM * kLd;

  const int hw = s.h * s.w;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int bi = blockIdx.z / s.t_out;
  const int to = blockIdx.z % s.t_out;
  const int tid = threadIdx.x;

  // this thread's copies: A row (pixel) a_row, B row (channel) b_row, both
  // the 16-byte half `half` of the stage's 32 channels
  const int a_row = tid >> 1, half = tid & 1, b_row = tid >> 1;
  const int p = m0 + a_row;
  const bool p_ok = p < hw;
  const int ph = p_ok ? p / s.w : 0;
  const int pw = p_ok ? p % s.w : 0;
  const bool b_on = tid < 2 * BN;

  const int kc_steps = s.ci_pad / kBK;
  const int it0 = max(0, s.time_pad - to) * 9 * kc_steps;   // skip taps in the causal past
  const int it1 = 27 * kc_steps;

  auto load = [&](int stage, int it) {
    const int tap = it / kc_steps;
    const int c0 = (it - tap * kc_steps) * kBK + half * 16;
    const int kt = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    const int ti = to + kt - s.time_pad, hi = ph + kh - 1, wi = pw + kw - 1;
    const bool ok = p_ok && ti >= 0 && ti < s.t_in && hi >= 0 && hi < s.h && wi >= 0 &&
                    wi < s.w;
    const int8_t* src =
        ok ? x + ((((int64_t)bi * s.t_in + ti) * s.h + hi) * s.w + wi) * s.ci_pad + c0 : x;
    cp_async16(sa + (stage * kBM + a_row) * kLd + half * 16, src, ok);
    if (b_on)
      cp_async16(sb + (stage * BN + b_row) * kLd + half * 16,
                 wk + ((int64_t)tap * s.co_pad + n0 + b_row) * s.ci_pad + c0, true);
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp % T::kWarpsM) * T::kWM;
  const int wn = (warp / T::kWarpsM) * T::kWN;
  int32_t acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (it0 + st < it1) load(st, it0 + st);
    cp_async_commit();
  }

  for (int it = it0; it < it1; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                       // stage `it` landed; stage it-1 fully consumed
    const int nxt = it + kStages - 1;
    if (nxt < it1) load((nxt - it0) % kStages, nxt);
    cp_async_commit();

    const int stage = (it - it0) % kStages;
    const int8_t* ta = sa + stage * kBM * kLd;
    const int8_t* tb = sb + stage * BN * kLd;
    uint32_t af[T::kMT][4], bf[T::kNT][2];
#pragma unroll
    for (int i = 0; i < T::kMT; ++i) {
      const int8_t* r = ta + (wm + i * 16 + g) * kLd + tig * 4;
      af[i][0] = ld32(r);                  // row g,     k 0..15
      af[i][1] = ld32(r + 8 * kLd);        // row g + 8, k 0..15
      af[i][2] = ld32(r + 16);             // row g,     k 16..31
      af[i][3] = ld32(r + 8 * kLd + 16);   // row g + 8, k 16..31
    }
#pragma unroll
    for (int j = 0; j < T::kNT; ++j) {
      const int8_t* r = tb + (wn + j * 8 + g) * kLd + tig * 4;
      bf[j][0] = ld32(r);                  // column g, k 0..15
      bf[j][1] = ld32(r + 16);             // column g, k 16..31
    }
#pragma unroll
    for (int i = 0; i < T::kMT; ++i)
#pragma unroll
      for (int j = 0; j < T::kNT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
  cp_async_wait<0>();
  __syncthreads();                         // the ring is free: reuse it for the epilogue

  int32_t* sc = reinterpret_cast<int32_t*>(smem);   // [co][pixel]
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = wn + j * 8 + tig * 2 + (r & 1);
        sc[col * T::kLdC + row] = acc[i][j][r];
      }
  __syncthreads();

  const float sxv = *sx;
  for (int idx = tid; idx < BN * kBM; idx += kThreads) {
    const int n = idx / kBM, m = idx % kBM;
    const int c = n0 + n, px = m0 + m;
    if (c >= s.co || px >= hw) continue;
    const int64_t off = (((int64_t)bi * s.co + c) * s.t_out + to) * hw + px;
    const int32_t a = sc[n * T::kLdC + m];
    if (acc_out != nullptr) {
      acc_out[off] = a;
      continue;
    }
    const float v = dequant(a, sxv, sw, bias, bias_bf16, c);
    if (out_bf16)
      static_cast<__nv_bfloat16*>(y)[off] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(y)[off] = v;
  }
}

template <int BN>
int launch(const int8_t* x8, const int8_t* wk, const float* sx, const float* sw, const void* bias,
           int bias_bf16, void* y, int32_t* acc, int out_bf16, const Shape& s, cudaStream_t st) {
  using T = Tile<BN>;
  cudaError_t err = cudaFuncSetAttribute(conv3d_int8_mma<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t hw = (int64_t)s.h * s.w;
  const dim3 grid((unsigned)((hw + kBM - 1) / kBM), s.co_pad / BN, s.b * s.t_out);
  conv3d_int8_mma<BN><<<grid, kThreads, T::kSmem, st>>>(x8, wk, sx, sw, bias, bias_bf16, y, acc,
                                                        out_bf16, s);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// conv3d_int8_wgmma: TMA-fed s8 wgmma (ci_pad a multiple of 128)
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int kChunk = 128;                // input channels of a unit: one 128-byte B row
constexpr int kSlotCh = 16;                // channels of one A box: a core-matrix column
constexpr int kSlots = kChunk / kSlotCh;   // A boxes per run and unit
constexpr int kThreads = 384;              // warpgroup 0: producer; 1, 2: consumers
constexpr int kConsumers = 256;
constexpr int kRingBudget = 216 * 1024;    // of the 227 KB a block may use

// MB: 64-row wgmma blocks of a consumer warpgroup's run; BN: output
// channels of a CTA, 128, or 16 for narrow co (conv_out's 3, zero-padded).
template <int MB, int BN>
struct Tile {
  static constexpr int kRun = 64 * MB;                          // pixels of a warpgroup
  static constexpr int kBM = 2 * kRun;                          // pixels of the CTA
  static constexpr int kBoxW = kRun + 2;                        // w0 - 1 .. w0 + run
  static constexpr int kSlot = (kBoxW * 16 + 127) / 128 * 128;  // bytes of a box, 128-aligned
  static constexpr int kABytes = 2 * kSlots * kSlot;            // one unit, both runs
  static constexpr int kATx = 2 * kSlots * kBoxW * 16;          // bytes TMA writes to it
  static constexpr int kBBytes = BN * kChunk;                   // one tap's [BN co][128 ci]
  // a narrow B leaves room for more A stages
  static constexpr int kAStages = BN == 128 ? (MB == 2 ? 3 : 4) : (MB == 2 ? 5 : 6);
  static constexpr int kBStages =
      BN == 128 ? (kRingBudget - kAStages * kABytes) / kBBytes : 8;
  static constexpr int kRingBytes = kBStages * kBBytes + kAStages * kABytes;
  static constexpr int kAcc = BN / 2;                           // int32 a thread per block
  static constexpr int kLdE = kBM + 4;                          // words between epilogue rows
  static_assert(kBStages >= 3, "fewer than three B stages");
  static_assert(kRingBytes <= kRingBudget, "the rings exceed their budget");
  static_assert(BN * kLdE * 4 <= kRingBytes, "epilogue tile exceeds the ring");
  static constexpr int kBarBytes = 2 * (kAStages + kBStages) * 8;
  static constexpr int kSmemBytes = kRingBytes + kBarBytes + 1024;   // + alignment slack
};

struct Params {
  int b, ci_pad, co, co_pad, t_out, h, w, time_pad, segs;
  int out;                                     // 0: f32 y, 1: bf16 y, 2: the int32 sums
  const float* sx;
  const float* sw;
  const void* bias;
  int bias_bf16;
  void* y;
};

// D[64 x 128] += A[64 x 32] * B[32 x 128], s8 in, s32 accumulators; A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n128k32(int32_t (&d)[64], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_m64n16k32(int32_t (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int32_t (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_ss_m64n128k32(d, da, db);
  } else {
    wgmma_ss_m64n16k32(d, da, db);
  }
}

// two f32 (as bits) rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(__uint_as_float(a), __uint_as_float(b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void consumer_sync() {   // the two consumer warpgroups only
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// The [BN co][BM px] tile of 32-bit words (f32 values, or int32 sums) from
// shared memory into y or acc [b, co, t, h, w]: VEC elements (16 bytes of
// output) a thread, coalesced along w, scalar where w is not a multiple of
// VEC; channels at or past co are padding and are not stored.
template <int BM, int BN, int VEC>
__device__ __forceinline__ void store_tile(const uint32_t* st, int ld, const Params& p, int n0,
                                           int bi, int to, int hh, int w0, int ct) {
  constexpr int kGroups = BM / VEC;
  const int64_t plane = (int64_t)p.h * p.w;
  const bool aligned = p.w % VEC == 0;
  for (int idx = ct; idx < BN * kGroups; idx += kConsumers) {
    const int n = idx / kGroups;
    const int px = (idx - n * kGroups) * VEC;
    const int pw = w0 + px;
    if (pw >= p.w || n0 + n >= p.co) continue;
    const int64_t off = (((int64_t)bi * p.co + n0 + n) * p.t_out + to) * plane +
                        (int64_t)hh * p.w + pw;
    const uint32_t* src = st + n * ld + px;
    if constexpr (VEC == 8) {                          // bf16 y
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.y) + off;
      if (aligned) {                                   // the whole group lies inside w
        const uint4 lo = *reinterpret_cast<const uint4*>(src);
        const uint4 hi = *reinterpret_cast<const uint4*>(src + 4);
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack_bf16x2(lo.x, lo.y), pack_bf16x2(lo.z, lo.w),
                       pack_bf16x2(hi.x, hi.y), pack_bf16x2(hi.z, hi.w));
      } else {
        for (int e = 0; e < VEC && pw + e < p.w; ++e)
          dst[e] = __float2bfloat16_rn(__uint_as_float(src[e]));
      }
    } else {                                           // f32 y or int32 acc
      uint32_t* dst = static_cast<uint32_t*>(p.y) + off;
      if (aligned) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < VEC && pw + e < p.w; ++e) dst[e] = src[e];
      }
    }
  }
}

template <int MB, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_int8_wgmma(const __grid_constant__ CUtensorMap tmap_x,
                  const __grid_constant__ CUtensorMap tmap_w, const Params p) {
  using T = Tile<MB, BN>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // swizzled B tiles want 1024-byte aligned stages
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = wg_smem + (base - raw);
  const uint32_t b_ring = base;                                  // kBStages x [BN co][128 ci]
  const uint32_t a_ring = base + T::kBStages * T::kBBytes;       // kAStages x 2 runs x 8 boxes
  const uint32_t a_full = base + T::kRingBytes;                  // barriers, 8 bytes each
  const uint32_t a_empty = a_full + T::kAStages * 8;
  const uint32_t b_full = a_empty + T::kAStages * 8;
  const uint32_t b_empty = b_full + T::kBStages * 8;

  const int hh = blockIdx.x / p.segs;
  const int w0 = (blockIdx.x - hh * p.segs) * T::kBM;
  const int n0 = blockIdx.y * BN;
  const int bi = blockIdx.z / p.t_out;
  const int to = blockIdx.z - bi * p.t_out;
  const int chunks = p.ci_pad / kChunk;
  // K loop: units (kt, kh, 128-channel chunk), each three taps kw = 0, 1, 2.
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
        const int c0 = (u - g * chunks) * kChunk;
        const int kt = g / 3, kh = g - 3 * (g / 3);
        for (int r = 0; r < 2; ++r)
          for (int j = 0; j < kSlots; ++j)
            tma_load_5d(a_ring + sa * T::kABytes + (r * kSlots + j) * T::kSlot, &tmap_x,
                        a_full + 8 * sa, c0 + j * kSlotCh, w0 + r * T::kRun - 1, hh + kh - 1,
                        to + kt - p.time_pad, bi);
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
    int32_t acc[MB][T::kAcc];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < T::kAcc; ++i) acc[mb][i] = 0;

    int ib = 0, prev_sa = 0, prev_sb = 0;
    bool prev = false, prev_last = false;
    for (int u = u_begin, ia = 0; u < u_end; ++u, ++ia) {
      const int sa = ia % T::kAStages;
      mbar_wait(a_full + 8 * sa, (ia / T::kAStages) & 1);
      const uint32_t abox = a_ring + sa * T::kABytes + run * kSlots * T::kSlot;
#pragma unroll 1
      for (int kw = 0; kw < 3; ++kw, ++ib) {
        const int sb = ib % T::kBStages;
        mbar_wait(b_full + 8 * sb, (ib / T::kBStages) & 1);
        const uint32_t bs = b_ring + sb * T::kBBytes;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 32; ++kk) {
          // B [BN co][128 ci], 128-byte swizzle: k32 slices 32 bytes apart
          // in each row, 8-row groups 1024 bytes apart
          const uint64_t db = smem_desc(bs + kk * 32, 16, 1024);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            // A: channels 32 kk .. 32 kk + 31 are boxes 2 kk and 2 kk + 1
            // (LBO = one box); rows are pixels, 16 bytes apart, 8-row groups
            // 128 bytes apart; tap kw starts kw pixels into the box
            const uint64_t da = smem_desc_noswizzle(
                abox + 2 * kk * T::kSlot + (mb * 64 + kw) * 16, T::kSlot, 128);
            wgmma_tile<BN>(acc[mb], da, db);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();                                 // the previous tap's group retired
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);
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
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);
    consumer_sync();                                     // the rings are free from here on

    // epilogue: [co][pixel] 32-bit words in shared memory (f32 y or int32
    // sums); padding channels (n0 + n >= co) are neither dequantised nor stored
    uint32_t* st = reinterpret_cast<uint32_t*>(smem);
    const bool deq = p.out != 2;
    const float sxv = deq ? *p.sx : 0.f;
#pragma unroll
    for (int i8 = 0; i8 < BN / 8; ++i8) {
      const int n = i8 * 8 + (lane & 3) * 2;
      // this thread's two channels: sx * sw and the bias, read once
      float sc[2], bv[2];
      bool on[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = n0 + n + j;
        on[j] = deq && c < p.co;
        sc[j] = on[j] ? __fmul_rn(sxv, p.sw[c]) : 0.f;
        bv[j] = on[j] && p.bias != nullptr
                    ? (p.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[c])
                                   : static_cast<const float*>(p.bias)[c])
                    : 0.f;
      }
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const int px = run * T::kRun + mb * 64 + warp * 16 + (lane >> 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e & 1;
          const int32_t a = acc[mb][4 * i8 + e];
          float v = __fmul_rn(__int2float_rn(a), sc[j]);
          if (p.bias != nullptr) v = __fadd_rn(v, bv[j]);       // as dequant() rounds it
          st[(n + j) * T::kLdE + px + (e >> 1) * 8] = on[j] ? __float_as_uint(v) : (uint32_t)a;
        }
      }
    }
    consumer_sync();
    if (p.out == 1)
      store_tile<T::kBM, BN, 8>(st, T::kLdE, p, n0, bi, to, hh, w0, ct);
    else
      store_tile<T::kBM, BN, 4>(st, T::kLdE, p, n0, bi, to, hh, w0, ct);
  }
}

template <int MB, int BN>
int launch(const void* x8, const void* wk, const Params& p, int t_in, cudaStream_t stream) {
  using T = Tile<MB, BN>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // x8: dims (ci, w, h, t, b), ci innermost; boxes of [1][1][1][run + 2 w][16 ci],
  // unswizzled (the consumers' descriptors start at any pixel)
  CUtensorMap tx, tw;
  const cuuint64_t ci = (cuuint64_t)p.ci_pad;
  const cuuint64_t xdim[5] = {ci, (cuuint64_t)p.w, (cuuint64_t)p.h, (cuuint64_t)t_in,
                              (cuuint64_t)p.b};
  const cuuint64_t xstride[4] = {ci, ci * p.w, ci * p.w * p.h, ci * p.w * p.h * t_in};
  const cuuint32_t xbox[5] = {kSlotCh, T::kBoxW, 1, 1, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUresult r = encode(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(x8), xdim,
                      xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  // wk [27, co_pad, ci]: boxes of [BN co][128 ci], 128-byte swizzle
  const cuuint64_t wdim[3] = {ci, (cuuint64_t)p.co_pad, 27};
  const cuuint64_t wstride[2] = {ci, ci * p.co_pad};
  const cuuint32_t wbox[3] = {kChunk, BN, 1};
  r = encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(wk), wdim, wstride, wbox,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;

  auto kernel = conv3d_int8_wgmma<MB, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(p.h * p.segs), (unsigned)(p.co_pad / BN),
                  (unsigned)(p.b * p.t_out));
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(tx, tw, p);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// Kernel quantize_k3_input. x [b, ci, t, h, w] contiguous, in f32 (in_dtype
// 0) or bf16 (1); sx one f32 on the device; x8 [b, t, h, w, ci_pad] int8,
// 16-byte aligned, ci_pad a multiple of 32 and at least ci. Every byte of x8
// is written (the padding channels as 0). Returns a CUDA error code.
extern "C" int deepv_quantize_k3(const void* x, int in_dtype, const void* sx, void* x8, int b,
                                 int ci, int ci_pad, int t, int h, int w, void* stream) {
  if (b <= 0 || ci <= 0 || ci_pad < ci || ci_pad % 32 || t <= 0 || h <= 0 || w <= 0 ||
      h > 65535 || (int64_t)b * t > 65535 || (in_dtype != 0 && in_dtype != 1) ||
      reinterpret_cast<uintptr_t>(x8) % 16)
    return (int)cudaErrorInvalidValue;
  const QShape s{b, ci, ci_pad, t, h, w};
  const int w_tiles = (w + kQPx - 1) / kQPx, c_tiles = (ci_pad + kQCh - 1) / kQCh;
  const dim3 grid((unsigned)(w_tiles * c_tiles), (unsigned)h, (unsigned)(b * t));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(sx);
  int8_t* xp = static_cast<int8_t*>(x8);
  const bool vec = w % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (in_dtype == 1) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    if (vec)
      quantize_k3_input<__nv_bfloat16, 8><<<grid, kQThreads, 0, st>>>(xb, sp, xp, s);
    else
      quantize_k3_input<__nv_bfloat16, 1><<<grid, kQThreads, 0, st>>>(xb, sp, xp, s);
  } else {
    const float* xf = static_cast<const float*>(x);
    if (vec)
      quantize_k3_input<float, 8><<<grid, kQThreads, 0, st>>>(xf, sp, xp, s);
    else
      quantize_k3_input<float, 1><<<grid, kQThreads, 0, st>>>(xf, sp, xp, s);
  }
  return (int)cudaGetLastError();
}

// Kernel conv3d_int8_mma. x8 [b, t_in, h, w, ci_pad] int8, wk [27, co_pad,
// ci_pad] int8, sx one f32, sw [co] f32, bias [co] in f32 (bias_dtype 0) or
// bf16 (1), or null; y [b, co, t_out, h, w] in f32 (out_dtype 0) or bf16
// (1), or, when acc is not null, acc [b, co, t_out, h, w] int32 instead of
// y. bn is the CTA's channel width, 128 or 16, and divides co_pad. Returns a
// CUDA error code (0 on success); a refused launch is reported, not run.
extern "C" int deepv_conv3d_int8(const void* x8, const void* wk, const void* sx, const void* sw,
                                 const void* bias, int bias_dtype, void* y, void* acc, int b,
                                 int ci_pad, int co, int co_pad, int t_in, int t_out, int h,
                                 int w, int time_pad, int out_dtype, int bn, void* stream) {
  if (b <= 0 || ci_pad <= 0 || ci_pad % kBK || co <= 0 || co > co_pad || h <= 0 || w <= 0 ||
      (bn != 128 && bn != 16) || co_pad % bn || (time_pad != 0 && time_pad != 2) ||
      t_out < 1 || t_out != t_in + time_pad - 2 || (int64_t)b * t_out > 65535 ||
      (out_dtype != 0 && out_dtype != 1) || (bias_dtype != 0 && bias_dtype != 1) ||
      (acc == nullptr && y == nullptr) || reinterpret_cast<uintptr_t>(x8) % 16 ||
      reinterpret_cast<uintptr_t>(wk) % 16)
    return (int)cudaErrorInvalidValue;
  const Shape s{b, ci_pad, co, co_pad, t_in, t_out, h, w, time_pad};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x8);
  const int8_t* wp = static_cast<const int8_t*>(wk);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  int32_t* ap = static_cast<int32_t*>(acc);
  if (bn == 128) return launch<128>(xp, wp, sxp, swp, bias, bias_dtype, y, ap, out_dtype, s, st);
  return launch<16>(xp, wp, sxp, swp, bias, bias_dtype, y, ap, out_dtype, s, st);
}

// Kernel conv3d_int8_wgmma. Arguments as deepv_conv3d_int8's; ci_pad a
// multiple of 128; bn (128 or 16) the CTA's output channels, dividing co_pad;
// mb (1 or 2) sets the CTA's pixels, 128 * mb along one output row, and segs,
// the CTAs along a row, must be ceil(w / (128 * mb)) (ops/conv_int8.py::plan).
// x8, wk and y or acc 16-byte aligned. Returns a cudaError_t, or 1000 + the
// CUresult of a tensor map that could not be encoded.
extern "C" int deepv_conv3d_int8_wgmma(const void* x8, const void* wk, const void* sx,
                                       const void* sw, const void* bias, int bias_dtype, void* y,
                                       void* acc, int b, int ci_pad, int co, int co_pad,
                                       int t_in, int t_out, int h, int w, int time_pad,
                                       int out_dtype, int bn, int mb, int segs, void* stream) {
  void* out = acc != nullptr ? acc : y;
  if (b <= 0 || ci_pad <= 0 || ci_pad % wg::kChunk || co <= 0 || co > co_pad ||
      (bn != 128 && bn != 16) || co_pad % bn || h <= 0 || w <= 0 ||
      (time_pad != 0 && time_pad != 2) || t_out < 1 || t_out != t_in + time_pad - 2 ||
      (int64_t)b * t_out > 65535 || (mb != 1 && mb != 2) || segs < 1 ||
      (int64_t)segs * 128 * mb < w || (int64_t)(segs - 1) * 128 * mb >= w ||
      (out_dtype != 0 && out_dtype != 1) || (bias_dtype != 0 && bias_dtype != 1) ||
      out == nullptr || reinterpret_cast<uintptr_t>(x8) % 16 ||
      reinterpret_cast<uintptr_t>(wk) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  wg::Params p;
  p.b = b; p.ci_pad = ci_pad; p.co = co; p.co_pad = co_pad; p.t_out = t_out; p.h = h;
  p.w = w; p.time_pad = time_pad;
  p.segs = segs;
  if ((int64_t)h * p.segs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.out = acc != nullptr ? 2 : out_dtype;
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.bias = bias;
  p.bias_bf16 = bias_dtype;
  p.y = out;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bn == 128)
    return mb == 2 ? wg::launch<2, 128>(x8, wk, p, t_in, st)
                   : wg::launch<1, 128>(x8, wk, p, t_in, st);
  return mb == 2 ? wg::launch<2, 16>(x8, wk, p, t_in, st)
                 : wg::launch<1, 16>(x8, wk, p, t_in, st);
}
