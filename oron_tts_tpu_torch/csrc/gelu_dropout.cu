// Fused tanh-GELU + seeded dropout, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels oron_tts_tpu/ops/gelu_dropout.py:76 (_fwd_kernel)
// and :87 (_bwd_kernel). Forward: y = gelu_tanh(x) * keep / (1 - rate).
// Backward: dx = dy * dgelu_tanh(x) * keep / (1 - rate), with the keep mask
// regenerated, so only x and the seed are kept for the backward and the mask
// never exists in device memory.
//
// The mask is the TPU kernel's, bit for bit: a pure function of the seed and
// the element's index in the flattened [rows, feat] tensor, in uint32
// wrap-around arithmetic:
//   z = idx * 2654435761 + seed;  z ^= z >> 16;  z *= 0x85EBCA6B;
//   z ^= z >> 13;  z *= 0xC2B2AE35;  z ^= z >> 16;  keep = z >= threshold
// with threshold = min(round(rate * 2^32), 2^32 - 1); threshold 0 is plain
// GELU. GELU and its derivative are computed in f32 whatever the storage
// type, and rounded once at the store.
//
// Bound on the H100: bytes. Each element is read once (twice in the
// backward: x and dy) and written once, against ~30 f32 and 8 integer
// operations, so the design is only about memory: 16-byte loads and stores,
// neighbouring threads on neighbouring addresses, one pass, nothing staged.
// The TPU kernel's row blocks (sized to VMEM) have no counterpart here.
#include "common.cuh"

namespace {

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;

__device__ __forceinline__ bool keep_at(uint32_t idx, uint32_t seed, uint32_t threshold) {
  uint32_t z = idx * 2654435761u + seed;
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  z = z ^ (z >> 16);
  return z >= threshold;
}

__device__ __forceinline__ float gelu_f32(float x) {
  const float t = tanhf(kSqrt2OverPi * (x + kGeluC * x * x * x));
  return 0.5f * x * (1.0f + t);
}

__device__ __forceinline__ float dgelu_f32(float x) {
  const float t = tanhf(kSqrt2OverPi * (x + kGeluC * x * x * x));
  return 0.5f * (1.0f + t) +
         0.5f * x * (1.0f - t * t) * kSqrt2OverPi * (1.0f + 3.0f * kGeluC * x * x);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One 16-byte vector per thread and step: 8 bf16 or 4 f32. BWD reads dy too.
// n may exceed 2^32: the hash index wraps, as on the TPU.
template <typename T, bool BWD>
__global__ void __launch_bounds__(256)
gelu_dropout_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    T* __restrict__ out, size_t n, uint32_t seed,
                    uint32_t threshold, float inv_keep) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t stride = (size_t)gridDim.x * blockDim.x * VEC;
  for (size_t i0 = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC; i0 < n;
       i0 += stride) {
    __align__(16) T xv[VEC];
    __align__(16) T gv[VEC];
    __align__(16) T ov[VEC];
    const bool full = i0 + VEC <= n;
    if (full) {
      *reinterpret_cast<uint4*>(xv) = *reinterpret_cast<const uint4*>(x + i0);
      if (BWD) *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(dy + i0);
    } else {
      for (int j = 0; j < VEC; ++j) {
        const bool ok = i0 + j < n;
        xv[j] = ok ? x[i0 + j] : x[n - 1];
        if (BWD) gv[j] = ok ? dy[i0 + j] : dy[n - 1];
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xf = to_f32(xv[j]);
      float r = BWD ? to_f32(gv[j]) * dgelu_f32(xf) : gelu_f32(xf);
      if (threshold > 0u)
        r = keep_at((uint32_t)(i0 + j), seed, threshold) ? r * inv_keep : 0.f;
      from_f32(&ov[j], r);
    }
    if (full) {
      *reinterpret_cast<uint4*>(out + i0) = *reinterpret_cast<const uint4*>(ov);
    } else {
      for (int j = 0; j < VEC && i0 + j < n; ++j) out[i0 + j] = ov[j];
    }
  }
}

template <typename T, bool BWD>
int launch(const void* x, const void* dy, void* out, size_t n, uint32_t seed,
           uint32_t threshold, float inv_keep, cudaStream_t st) {
  if (n == 0) return 0;
  constexpr int VEC = 16 / sizeof(T);
  const size_t vecs = (n + VEC - 1) / VEC;
  size_t blocks = (vecs + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond that
  gelu_dropout_kernel<T, BWD><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(out), n,
      seed, threshold, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out (and dy) are contiguous and 16-byte aligned; n elements in all.
extern "C" int gelu_dropout_fwd(const void* x, void* out, long long n,
                                unsigned int seed, unsigned int threshold,
                                float inv_keep, int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(x, nullptr, out, (size_t)n, seed, threshold,
                                        inv_keep, st);
  return launch<float, false>(x, nullptr, out, (size_t)n, seed, threshold, inv_keep, st);
}

extern "C" int gelu_dropout_bwd(const void* x, const void* dy, void* dx, long long n,
                                unsigned int seed, unsigned int threshold,
                                float inv_keep, int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, true>(x, dy, dx, (size_t)n, seed, threshold, inv_keep,
                                       st);
  return launch<float, true>(x, dy, dx, (size_t)n, seed, threshold, inv_keep, st);
}
