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
// point: the products bound it, not the memory.
//
// What the design does about that:
//   * One CTA per (64-row q tile, b*h); a loop over 64-key K/V tiles staged
//     in shared memory with an online (running max / running sum) softmax
//     in f32, so no [S, S] logits ever reach device memory and no sequence
//     length cap exists (the TPU kernel's single-pass VMEM budget and its
//     XLA fallback have no counterpart here).
//   * The mask is rebuilt per tile from valid (i32) and times (f32), with
//     the TPU kernel's -1e30 fill. Buffers are not padded: ragged q rows are
//     computed but never stored, ragged keys are zero-filled and excluded.
//   * Causal tile skipping: a K tile whose smallest key time exceeds the q
//     tile's largest query time holds no allowed pair and is skipped. That
//     subsumes the TPU wrapper's n_last split (prefix x current block) in
//     one launch.
//   * bf16: both products on the tensor cores through WMMA 16x16x16 bf16
//     fragments with f32 accumulation; the probabilities are rounded to
//     bf16 for the P.V product, as the TPU kernel rounds its weights.
//     f32 (used to check exactness on the card): plain FMA in f32.
//   wgmma, TMA and warp specialisation are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per tile
constexpr int kWarps = 4;       // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;
constexpr float kMasked = -1e30f;

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
// bf16: WMMA tensor-core products
// ---------------------------------------------------------------------------

constexpr int kLdH = kD + 8;    // bf16 row stride of Q/K/V/P tiles (144 B)
constexpr int kLdF = kBK + 4;   // f32 row stride of S/O tiles (272 B)

struct SmemBf16 {
  __nv_bfloat16 q[kBQ * kLdH];
  __nv_bfloat16 k[kBK * kLdH];
  __nv_bfloat16 v[kBK * kLdH];
  __nv_bfloat16 p[kBQ * kLdH];
  float s[kBQ * kLdF];
  float o[kBQ * kLdF];
  int vq[64];
  float tq[64];
  int vk[64];
  float tk[64];
};

// Copy a 64-row bf16 tile (zero rows past s) with 16-byte vectors.
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src, int bi,
                                               int hi, int start, int s, int h) {
  for (int i = threadIdx.x; i < 64 * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (start + r < s)
      val = *reinterpret_cast<const uint4*>(row_ptr(src, bi, hi, start + r, s, h) + c);
    *reinterpret_cast<uint4*>(dst + r * kLdH + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid,
              const float* __restrict__ times, __nv_bfloat16* __restrict__ out,
              int s, int h, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(smem_raw);

  const int q0 = blockIdx.x * kBQ;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * kRows;

  load_tile_bf16(sm.q, q, bi, hi, q0, s, h);
  load_vectors(sm.vq, sm.tq, valid, times, bi, s, q0);
  for (int i = threadIdx.x; i < kBQ * kLdF; i += kThreads) sm.o[i] = 0.f;
  __syncthreads();
  const float tq_max = tile_time_bound(sm.tq, q0, s, true);

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], sm.q + row0 * kLdH + kk * 16, kLdH);

  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) { m[r] = -INFINITY; l[r] = 0.f; }

  const int n_tiles = (s + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                      // previous tile fully consumed
    load_vectors(sm.vk, sm.tk, valid, times, bi, s, k0);
    __syncthreads();
    if (tile_time_bound(sm.tk, k0, s, false) > tq_max) continue;  // no allowed pair
    load_tile_bf16(sm.k, k, bi, hi, k0, s, h);
    load_tile_bf16(sm.v, v, bi, hi, k0, s, h);
    __syncthreads();

    // S strip of this warp: rows row0..row0+15 x 64 keys.
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wmma::load_matrix_sync(kb, sm.k + n * 16 * kLdH + kk * 16, kLdH);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(sm.s + row0 * kLdF + n * 16, acc, kLdF, wmma::mem_row_major);
    }
    __syncwarp();

    const bool in0 = k0 + lane < s, in1 = k0 + lane + 32 < s;
    const int vk0 = sm.vk[lane], vk1 = sm.vk[lane + 32];
    const float tk0 = sm.tk[lane], tk1 = sm.tk[lane + 32];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const int vq = sm.vq[row];
      const float tq = sm.tq[row];
      const float s0 = masked_logit(sm.s[row * kLdF + lane], scale, vq, tq, vk0, tk0, in0);
      const float s1 = masked_logit(sm.s[row * kLdF + lane + 32], scale, vq, tq, vk1, tk1, in1);
      float alpha, p0, p1;
      online_update(s0, s1, m[r], l[r], alpha, p0, p1);
      sm.p[row * kLdH + lane] = __float2bfloat16(p0);
      sm.p[row * kLdH + lane + 32] = __float2bfloat16(p1);
      sm.o[row * kLdF + lane] *= alpha;
      sm.o[row * kLdF + lane + 32] *= alpha;
    }
    __syncwarp();

    // O strip += P strip . V
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sm.o + row0 * kLdF + n * 16, kLdF, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, sm.p + row0 * kLdH + kk * 16, kLdH);
        wmma::load_matrix_sync(vb, sm.v + kk * 16 * kLdH + n * 16, kLdH);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(sm.o + row0 * kLdF + n * 16, acc, kLdF, wmma::mem_row_major);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (q0 + row >= s) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* dst = out + (((size_t)bi * s + q0 + row) * h + hi) * kD;
    dst[lane] = __float2bfloat16(sm.o[row * kLdF + lane] * inv);
    dst[lane + 32] = __float2bfloat16(sm.o[row * kLdF + lane + 32] * inv);
  }
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers of
// contiguous tensors: q/k/v/out [b, s, h, d], valid [b, s] int32, times [s]
// float32. Launches on `stream` and returns cudaGetLastError().
extern "C" int deepv_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* valid, const void* times, void* out,
                                   int b, int s, int h, int d, int dtype, void* stream) {
  if (d != kD || b <= 0 || s <= 0 || h <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((s + kBQ - 1) / kBQ, b * h);
  const float scale = 1.f / sqrtf((float)d);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = allow_smem(attn_fwd_bf16, sizeof(SmemBf16));
    if (err != cudaSuccess) return (int)err;
    attn_fwd_bf16<<<grid, kThreads, sizeof(SmemBf16), st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(valid),
        static_cast<const float*>(times), static_cast<__nv_bfloat16*>(out), s, h, scale);
  } else {
    err = allow_smem(attn_fwd_f32, sizeof(SmemF32));
    if (err != cudaSuccess) return (int)err;
    attn_fwd_f32<<<grid, kThreads, sizeof(SmemF32), st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(valid),
        static_cast<const float*>(times), static_cast<float*>(out), s, h, scale);
  }
  return (int)cudaGetLastError();
}
