// 3xTF32 arithmetic shared by the f32 kernels of this directory: an f32
// operand x splits as big = tf32(x) and small = tf32(x - big), and a product
// a.b is taken as three TF32 tensor-core products, small.big + big.small +
// big.big, with f32 accumulation. The dropped small.small term and the
// splits' rounding are ~2^-21 of each term, so the sum keeps about f32
// accuracy at the TF32 rate (495 TF/s on an H100 SXM, against 67 TF/s of
// f32 FMA). attention.cu splits in registers before mma.sync; conv_igemm.cu
// splits x and the weight once per call into two planes that wgmma reads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32 (10 stored mantissa bits) to nearest, ties away from
// zero: what cvt.rna.tf32.f32 gives for finite x, in two integer operations
// (ptxas emulates the cvt with a longer sequence)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32: big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a . b, one mma.sync.m16n8k8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b to about f32 accuracy: three TF32 products of the split
// operands, the small ones first (small . small, 2^-22 of the product, dropped)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

}  // namespace tf32x3
