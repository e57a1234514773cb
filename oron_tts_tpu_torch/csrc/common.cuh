// Shared device helpers for the port's Hopper kernels (sm_90a).
//
// mma.sync m16n8k16 with bf16 operands and f32 accumulators. Fragment
// layout per thread (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..+9],   a3 = A[g+8][2t+8..+9]
//   B (16x8, k-major):    b0 = B[2t..2t+1][g],   b1 = B[2t+8..+9][g]
//   C (16x8, f32):        c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// Each 32-bit register holds two bf16, the lower column in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace oron {

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// y * tanh(softplus(y)), softplus(y) = max(y, 0) + log1p(exp(-|y|))
__device__ __forceinline__ float mish(float y) {
  float sp = fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)));
  return y * tanhf(sp);
}

}  // namespace oron
