// Shared device helpers for the port's Hopper kernels (sm_90a).
//
// The mma.sync m16n8k16 fragment layout (bf16 operands, f32 accumulators),
// which wgmma's register A operand follows (wgmma.cuh). Per thread, with
// g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"):
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..+9],   a3 = A[g+8][2t+8..+9]
//   C (16x8, f32):        c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// Each 32-bit register holds two bf16, the lower column in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace oron {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// y * tanh(softplus(y)), softplus(y) = max(y, 0) + log1p(exp(-|y|))
__device__ __forceinline__ float mish(float y) {
  float sp = fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)));
  return y * tanhf(sp);
}

// The same function for an output rounded to bf16: y * n / (n + 2) with
// n = e^y (e^y + 2), one fast exponential and one fast division, where
// tanh, log1p and exp cost the grouped conv's bf16 kernel a sixth of its
// time (PERF.md). e^y is clamped at e^20, past which n / (n + 2) is 1 in f32.
__device__ __forceinline__ float mish_bf16_out(float y) {
  const float e = __expf(fminf(y, 20.f));
  const float n = e * (e + 2.f);
  return y * __fdividef(n, n + 2.f);
}

}  // namespace oron
