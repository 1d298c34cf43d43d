// Symmetric int8 3x3x3 causal conv for Hopper (sm_90a), with a plain C interface.
//
// K3. It has no TPU kernel to replace: deepv_tpu computes the same function
// with XLA's int8 convolution (deepv_tpu/ops/conv_int8.py::conv3d_int8,
// lax.conv_general_dilated on int8 with int32 accumulation), and PyTorch has
// no int8 3D convolution on CUDA. For the wrapper's quantised input x8
// [b, t_in, h, w, ci_pad] (channels-last, input channels zero-padded to a
// multiple of 32), the K-major quantised weight wk [27, co_pad, ci_pad]
// (tap-major, built once when the VAE is built) and f32 vectors scale
// [co] = sx * sw and bias [co]:
//
//   acc[b, co, t, h, w] = sum_{kt,kh,kw,ci} wk[kt*9 + kh*3 + kw, co, ci]
//                           * x8[b, t + kt - time_pad, h + kh - 1, w + kw - 1, ci]
//   y = float(acc) * scale[co] + bias[co]      (two f32 roundings, no FMA)
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
// Design (simple first; speed is later work): mma.sync m16n8k32 s8 with
// int32 accumulators, no TMA, no wgmma (whose 8-bit forms need both
// operands K-major, which the channels-last x8 and wk already are).
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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
                const float* __restrict__ scale, const float* __restrict__ bias,
                void* __restrict__ y, int32_t* __restrict__ acc_out, int out_bf16, Shape s) {
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
    const float v = __fadd_rn(__fmul_rn(__int2float_rn(a), scale[c]), bias[c]);
    if (out_bf16)
      static_cast<__nv_bfloat16*>(y)[off] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(y)[off] = v;
  }
}

template <int BN>
int launch(const int8_t* x8, const int8_t* wk, const float* scale, const float* bias, void* y,
           int32_t* acc, int out_bf16, const Shape& s, cudaStream_t st) {
  using T = Tile<BN>;
  cudaError_t err = cudaFuncSetAttribute(conv3d_int8_mma<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t hw = (int64_t)s.h * s.w;
  const dim3 grid((unsigned)((hw + kBM - 1) / kBM), s.co_pad / BN, s.b * s.t_out);
  conv3d_int8_mma<BN><<<grid, kThreads, T::kSmem, st>>>(x8, wk, scale, bias, y, acc, out_bf16,
                                                        s);
  return (int)cudaGetLastError();
}

}  // namespace

// x8 [b, t_in, h, w, ci_pad] int8, wk [27, co_pad, ci_pad] int8, scale and
// bias [co] f32; y [b, co, t_out, h, w] in f32 (out_dtype 0) or bf16 (1), or,
// when acc is not null, acc [b, co, t_out, h, w] int32 instead of y. bn is
// the CTA's channel width, 128 or 16, and divides co_pad. Returns a CUDA
// error code (0 on success); a refused launch is reported, not run.
extern "C" int deepv_conv3d_int8(const void* x8, const void* wk, const void* scale,
                                 const void* bias, void* y, void* acc, int b, int ci_pad, int co,
                                 int co_pad, int t_in, int t_out, int h, int w, int time_pad,
                                 int out_dtype, int bn, void* stream) {
  if (b <= 0 || ci_pad <= 0 || ci_pad % kBK || co <= 0 || co > co_pad || h <= 0 || w <= 0 ||
      (bn != 128 && bn != 16) || co_pad % bn || (time_pad != 0 && time_pad != 2) ||
      t_out < 1 || t_out != t_in + time_pad - 2 || (int64_t)b * t_out > 65535 ||
      (out_dtype != 0 && out_dtype != 1) || (acc == nullptr && y == nullptr) ||
      reinterpret_cast<uintptr_t>(x8) % 16 || reinterpret_cast<uintptr_t>(wk) % 16)
    return (int)cudaErrorInvalidValue;
  const Shape s{b, ci_pad, co, co_pad, t_in, t_out, h, w, time_pad};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x8);
  const int8_t* wp = static_cast<const int8_t*>(wk);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  int32_t* ap = static_cast<int32_t*>(acc);
  if (bn == 128) return launch<128>(xp, wp, sp, bp, y, ap, out_dtype, s, st);
  return launch<16>(xp, wp, sp, bp, y, ap, out_dtype, s, st);
}
