// Implicit-GEMM 3x3x3 causal conv for Hopper (sm_90a), with a plain C interface.
//
// Replaces deepv_tpu/ops/conv_igemm.py::_kernel (the Pallas TPU kernel behind
// conv3d_igemm). For a channels-last input x [b, t_in, h, w, ci], a weight
// re-laid out to wr [(kt, kh, kw, ci), co] and a bias [co] in x's dtype:
//
//   y[b, co, t, h, w] = bias[co] + sum_{kt,kh,kw,ci} wr[(kt,kh,kw,ci), co]
//                         * x[b, t + kt - time_pad, h + kh - 1, w + kw - 1, ci]
//
// with zeros outside the input (time_pad = 2: two causal zero frames in the
// past; time_pad = 0: the context frames are already in x). f32 accumulation,
// the bias added in f32 after the sum, one rounding to x's dtype at the store.
//
// What bounds it on the H100: at the VAE's eligible layers (ci, co = 128..2048,
// h x w = 48x64 .. 384x512) a call does 2*27*ci*co operations per output pixel
// against 2*(ci + co) bytes, 1e3-1e4 operations per byte: the tensor cores
// bound it, far above the bf16 ridge point (~295 operations per byte).
//
// What the design does about that:
//   * The GEMM view: M = output pixels of one frame (h*w flattened), N = co,
//     K = 27 taps x ci. One CTA per (128 pixels, 128 channels, batch * output
//     frame); blocks run in any order and carry nothing between them (the TPU
//     kernel's input tile reused across Cout blocks relies on its sequential
//     grid and has no counterpart here: each CTA loads the input it needs).
//   * The K loop walks (tap, 32-channel chunk) steps through a 3-stage ring of
//     cp.async 16-byte copies: the A tile is 128 pixels x 32 channels gathered
//     at the tap's (dt, dh, dw) offset, the causal and spatial halo zero-filled
//     by the copy itself (src-size 0), so no padded copy of x exists in memory.
//   * bf16: WMMA 16x16x16 bf16 fragments with f32 accumulators kept in
//     registers across the whole K loop (8 warps, 64x32 outputs each).
//     f32 (the exactness check on the card): plain FMA, 64x64 tiles, 4x4 a thread.
//   * Epilogue: the accumulators go through shared memory transposed to
//     [co][pixel], so the store into y [b, co, t, h, w] is contiguous along the
//     pixels (4 a thread); bias added in f32, one rounding.
//   * Element offsets are 64-bit: a 17-frame, 512-channel activation at
//     384x512 is within a factor of 5 of 2^31 elements.
//   wgmma, TMA and a persistent schedule are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

struct Shape {
  int b, ci, co, t_in, t_out, h, w, time_pad;
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

// Offset of x[bi, ti, hi, wi, c] in the channels-last input, or -1 when the
// tap falls in the zero halo (causal past, spatial border).
__device__ __forceinline__ int64_t tap_offset(const Shape& s, int bi, int ti, int hi, int wi,
                                              int c) {
  if (ti < 0 || hi < 0 || hi >= s.h || wi < 0 || wi >= s.w) return -1;
  return ((((int64_t)bi * s.t_in + ti) * s.h + hi) * s.w + wi) * s.ci + c;
}

// ---------------------------------------------------------------------------
// bf16: WMMA tensor-core products
// ---------------------------------------------------------------------------

constexpr int kBM = 128;          // output pixels per CTA
constexpr int kBN = 128;          // output channels per CTA
constexpr int kBK = 32;           // input channels per K step
constexpr int kStages = 3;
constexpr int kThreads = 256;     // 8 warps: 2 (pixels) x 4 (channels), 64x32 each
constexpr int kLdA = kBK + 8;     // bf16 row stride of the A tile (80 B)
constexpr int kLdB = kBN + 8;     // bf16 row stride of the B tile (272 B)
constexpr int kLdC = kBM + 4;     // f32 row stride of the [co][pixel] epilogue tile
constexpr int kTileA = kBM * kLdA;
constexpr int kTileB = kBK * kLdB;
constexpr size_t kSmemPipe = (size_t)kStages * (kTileA + kTileB) * sizeof(__nv_bfloat16);
constexpr size_t kSmemEpi = (size_t)kBN * kLdC * sizeof(float);
constexpr size_t kSmemBf16 = kSmemPipe > kSmemEpi ? kSmemPipe : kSmemEpi;

// This thread's two rows of the A tile (pixel, 8-channel chunk).
struct ARows {
  int row[2], chunk[2], h[2], w[2];
  bool ok[2];
};

__device__ __forceinline__ void load_stage_bf16(
    __nv_bfloat16* sa, __nv_bfloat16* sb, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ wr, const Shape& s, const ARows& ar, int bi, int to,
    int n0, int it, int ci_steps) {
  const int tap = it / ci_steps;
  const int c0 = (it - tap * ci_steps) * kBK;
  const int kt = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  const int ti = to + kt - s.time_pad;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t off = ar.ok[j] ? tap_offset(s, bi, ti, ar.h[j] + kh - 1, ar.w[j] + kw - 1,
                                              c0 + ar.chunk[j] * 8)
                                 : -1;
    cp_async16(sa + ar.row[j] * kLdA + ar.chunk[j] * 8, off >= 0 ? x + off : x, off >= 0);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int r = idx >> 4, c = idx & 15;
    cp_async16(sb + r * kLdB + c * 8, wr + ((int64_t)tap * s.ci + c0 + r) * s.co + n0 + c * 8,
               true);
  }
}

__global__ void __launch_bounds__(kThreads)
conv3d_igemm_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wr,
                  const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                  Shape s) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sb = sa + kStages * kTileA;

  const int hw = s.h * s.w;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int bi = blockIdx.z / s.t_out;
  const int to = blockIdx.z % s.t_out;

  ARows ar;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    ar.row[j] = idx >> 2;
    ar.chunk[j] = idx & 3;
    const int p = m0 + ar.row[j];
    ar.ok[j] = p < hw;
    ar.h[j] = p / s.w;
    ar.w[j] = p % s.w;
  }
  const int ci_steps = s.ci / kBK;
  const int k_iters = 27 * ci_steps;

  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 64;
  const int wn = (warp >> 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < k_iters)
      load_stage_bf16(sa + st * kTileA, sb + st * kTileB, x, wr, s, ar, bi, to, n0, st,
                      ci_steps);
    cp_async_commit();
  }

  for (int it = 0; it < k_iters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                       // stage `it` landed; stage it-1 fully consumed
    const int nxt = it + kStages - 1;
    if (nxt < k_iters) {
      const int st = nxt % kStages;
      load_stage_bf16(sa + st * kTileA, sb + st * kTileB, x, wr, s, ar, bi, to, n0, nxt,
                      ci_steps);
    }
    cp_async_commit();

    const __nv_bfloat16* ta = sa + (it % kStages) * kTileA;
    const __nv_bfloat16* tb = sb + (it % kStages) * kTileB;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], ta + (wm + i * 16) * kLdA + kk * 16, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], tb + kk * 16 * kLdB + wn + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                         // the ring is free: reuse it for the epilogue

  float* sc = reinterpret_cast<float*>(smem_raw);   // [co][pixel]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sc + (wn + j * 16) * kLdC + wm + i * 16, acc[i][j], kLdC,
                              wmma::mem_col_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < kBN * (kBM / 4); idx += kThreads) {
    const int n = idx / (kBM / 4);
    const int m = (idx % (kBM / 4)) * 4;
    if (m0 + m >= hw) continue;            // hw is a multiple of 4: whole groups drop
    const float bv = __bfloat162float(bias[n0 + n]);
    const float4 v = *reinterpret_cast<const float4*>(sc + n * kLdC + m);
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x + bv, v.y + bv);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z + bv, v.w + bv);
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned*>(&lo);
    packed.y = *reinterpret_cast<unsigned*>(&hi);
    __nv_bfloat16* dst = y + (((int64_t)bi * s.co + n0 + n) * s.t_out + to) * hw + m0 + m;
    *reinterpret_cast<uint2*>(dst) = packed;
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMA (the exactness check on the card)
// ---------------------------------------------------------------------------

constexpr int kFBM = 64;          // output pixels per CTA
constexpr int kFBN = 64;          // output channels per CTA
constexpr int kFBK = 16;          // input channels per K step
constexpr int kFLdA = kFBM + 4;   // [k][pixel] rows, 16-byte aligned

__global__ void __launch_bounds__(kThreads)
conv3d_igemm_f32(const float* __restrict__ x, const float* __restrict__ wr,
                 const float* __restrict__ bias, float* __restrict__ y, Shape s) {
  __shared__ __align__(16) float sa[kFBK * kFLdA];   // [k][pixel]
  __shared__ __align__(16) float sb[kFBK * kFBN];    // [k][co]

  const int hw = s.h * s.w;
  const int m0 = blockIdx.x * kFBM;
  const int n0 = blockIdx.y * kFBN;
  const int bi = blockIdx.z / s.t_out;
  const int to = blockIdx.z % s.t_out;
  const int tid = threadIdx.x;

  // loads: A row (pixel) tid/4 with 4 channels at (tid%4)*4; B row tid/16, 4 co at (tid%16)*4
  const int a_row = tid >> 2, a_c = (tid & 3) * 4;
  const int p = m0 + a_row;
  const bool a_ok = p < hw;
  const int a_h = p / s.w, a_w = p % s.w;
  const int b_row = tid >> 4, b_c = (tid & 15) * 4;
  // compute: 4 pixels at ty*4, 4 channels at tx*4
  const int tx = tid & 15, ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int ci_steps = s.ci / kFBK;
  const int k_iters = 27 * ci_steps;
  for (int it = 0; it < k_iters; ++it) {
    const int tap = it / ci_steps;
    const int c0 = (it - tap * ci_steps) * kFBK;
    const int kt = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    const int64_t off = a_ok ? tap_offset(s, bi, to + kt - s.time_pad, a_h + kh - 1,
                                          a_w + kw - 1, c0 + a_c)
                             : -1;
    const float4 a = off >= 0 ? *reinterpret_cast<const float4*>(x + off)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    sa[(a_c + 0) * kFLdA + a_row] = a.x;
    sa[(a_c + 1) * kFLdA + a_row] = a.y;
    sa[(a_c + 2) * kFLdA + a_row] = a.z;
    sa[(a_c + 3) * kFLdA + a_row] = a.w;
    *reinterpret_cast<float4*>(sb + b_row * kFBN + b_c) = *reinterpret_cast<const float4*>(
        wr + ((int64_t)tap * s.ci + c0 + b_row) * s.co + n0 + b_c);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(sa + k * kFLdA + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(sb + k * kFBN + tx * 4);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int m = m0 + ty * 4;
  if (m >= hw) return;                     // hw is a multiple of 4: whole groups drop
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    const float bv = bias[n];
    float* dst = y + (((int64_t)bi * s.co + n) * s.t_out + to) * hw + m;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[0][j] + bv, acc[1][j] + bv, acc[2][j] + bv, acc[3][j] + bv);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers of
// contiguous tensors: x [b, t_in, h, w, ci] (channels-last), wr [27*ci, co]
// ((kt, kh, kw, ci) rows), bias [co], y [b, co, t_out, h, w]; all in one
// dtype. Requires ci, co multiples of 128, even h and w, time_pad 0 or 2 and
// t_out = t_in + time_pad - 2 >= 1. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int deepv_conv3d_igemm(const void* x, const void* wr, const void* bias, void* y,
                                  int b, int ci, int co, int t_in, int t_out, int h, int w,
                                  int time_pad, int dtype, void* stream) {
  if (b <= 0 || ci <= 0 || co <= 0 || h <= 0 || w <= 0 || ci % 128 || co % 128 || h % 2 ||
      w % 2 || (time_pad != 0 && time_pad != 2) || t_out < 1 ||
      t_out != t_in + time_pad - 2 || (dtype != 0 && dtype != 1) ||
      (int64_t)b * t_out > 65535)
    return (int)cudaErrorInvalidValue;
  const Shape s{b, ci, co, t_in, t_out, h, w, time_pad};
  const int64_t hw = (int64_t)h * w;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(conv3d_igemm_bf16,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmemBf16);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((hw + kBM - 1) / kBM), co / kBN, b * t_out);
    conv3d_igemm_bf16<<<grid, kThreads, kSmemBf16, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wr),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), s);
  } else {
    const dim3 grid((unsigned)((hw + kFBM - 1) / kFBM), co / kFBN, b * t_out);
    conv3d_igemm_f32<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wr),
        static_cast<const float*>(bias), static_cast<float*>(y), s);
  }
  return (int)cudaGetLastError();
}
