// Fused tanh-GELU + seeded dropout, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels oron_tts_tpu/ops/gelu_dropout.py:76 (_fwd_kernel)
// and :87 (_bwd_kernel). Forward: y = gelu_tanh(x) * keep / (1 - rate).
// Backward: dx = dy * dgelu_tanh(x) * keep / (1 - rate), with the keep mask
// regenerated, so only x and the seed are kept for the backward and the mask
// never exists in device memory.
//
// dropout_fwd / dropout_bwd are the same pass without the GELU, for the
// attention output's dropout (which the JAX package leaves to XLA, so no TPU
// kernel stands behind them): out = keep / (1 - rate) * x forward, the same on
// dy backward, and a row left out of the batch's mask (a padded frame) zeroed
// in the same pass, so neither direction keeps a mask or an activation.
//
// The mask is the TPU kernel's, bit for bit: a pure function of the seed and
// the element's index in the flattened global [rows, gcols] tensor, in uint32
// wrap-around arithmetic:
//   z = idx * 2654435761 + seed;  z ^= z >> 16;  z *= 0x85EBCA6B;
//   z ^= z >> 13;  z *= 0xC2B2AE35;  z ^= z >> 16;  keep = z >= threshold
// with threshold = min(round(rate * 2^32), 2^32 - 1); threshold 0 is plain
// GELU. A call may hold a shard of the global tensor (a mesh rank's rows, or
// its columns under tensor parallelism): local row r, column c of a shard
// [rows, cols] placed at global row row0 and column col0 has the index
// (row0 + r) * gcols + col0 + c, so a shard draws the slice of the mask one
// call over the whole tensor draws. Whole rows (cols == gcols) need no
// division: the index is row0 * gcols + i. A column shard divides once per
// 16-byte vector. A single call over the whole tensor has base 0 and the
// flat index, as before. GELU and its derivative are computed in f32 whatever the storage
// type, and rounded once at the store.
//
// Bound on the H100: bytes. Each element is read once (twice in the GELU
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

enum Op { kGeluFwd, kGeluBwd, kScale };

// One 16-byte vector per thread and step: 8 bf16 or 4 f32. kGeluBwd reads dy
// too; kScale is the mask and the scale alone (the attention output's
// dropout, forward on x and backward on dy).
// n may exceed 2^32: the hash index wraps, as on the TPU.
// COLS: the call holds a column shard (cols < gcols), and a local index
// maps to its global one through one division per vector.
// ROWS: row_keep holds one byte per local row of [n / cols, cols]; a row
// whose byte is 0 is written as zeros (the padded frames of a batch). The
// byte is read once per vector, and again only where the vector crosses
// into the next row.
template <typename T, int OP, bool COLS, bool ROWS>
__device__ __forceinline__ void elementwise(const T* __restrict__ x, const T* __restrict__ dy,
                                            const uint8_t* __restrict__ row_keep,
                                            T* __restrict__ out, size_t n, uint32_t seed,
                                            uint32_t threshold, float inv_keep, uint32_t base,
                                            size_t cols, uint32_t gcols) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr bool BWD = OP == kGeluBwd;
  const size_t stride = (size_t)gridDim.x * blockDim.x * VEC;
  for (size_t i0 = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC; i0 < n;
       i0 += stride) {
    size_t r = 0, c = 0;
    if (COLS || ROWS) {
      r = i0 / cols;
      c = i0 - r * cols;
    }
    bool row_on = !ROWS || row_keep[r];
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
      float v = OP == kGeluFwd ? gelu_f32(xf)
                : OP == kGeluBwd ? to_f32(gv[j]) * dgelu_f32(xf)
                                 : xf;
      if (threshold > 0u) {
        const uint32_t idx = COLS ? base + (uint32_t)r * gcols + (uint32_t)c
                                  : base + (uint32_t)(i0 + j);
        v = keep_at(idx, seed, threshold) ? v * inv_keep : 0.f;
      }
      if (!row_on) v = 0.f;
      if ((COLS || ROWS) && ++c == cols) {
        c = 0;
        ++r;
        if (ROWS) row_on = i0 + j + 1 < n && row_keep[r];
      }
      from_f32(&ov[j], v);
    }
    if (full) {
      *reinterpret_cast<uint4*>(out + i0) = *reinterpret_cast<const uint4*>(ov);
    } else {
      for (int j = 0; j < VEC && i0 + j < n; ++j) out[i0 + j] = ov[j];
    }
  }
}

template <typename T, bool BWD, bool COLS>
__global__ void __launch_bounds__(256)
gelu_dropout_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    T* __restrict__ out, size_t n, uint32_t seed,
                    uint32_t threshold, float inv_keep, uint32_t base,
                    size_t cols, uint32_t gcols) {
  elementwise<T, BWD ? kGeluBwd : kGeluFwd, COLS, false>(
      x, dy, nullptr, out, n, seed, threshold, inv_keep, base, cols, gcols);
}

template <typename T, bool COLS, bool ROWS>
__global__ void __launch_bounds__(256)
hash_dropout_kernel(const T* __restrict__ x, const uint8_t* __restrict__ row_keep,
                    T* __restrict__ out, size_t n, uint32_t seed, uint32_t threshold,
                    float inv_keep, uint32_t base, size_t cols, uint32_t gcols) {
  elementwise<T, kScale, COLS, ROWS>(x, nullptr, row_keep, out, n, seed, threshold,
                                     inv_keep, base, cols, gcols);
}

// 256 threads a block, one vector each, up to 64 blocks an SM of 132; the
// grid strides beyond that.
template <typename T>
unsigned grid_for(size_t n) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t vecs = (n + VEC - 1) / VEC;
  size_t blocks = (vecs + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;
  return (unsigned)blocks;
}

template <typename T, bool BWD>
int launch(const void* x, const void* dy, void* out, size_t n, uint32_t seed,
           uint32_t threshold, float inv_keep, uint32_t base, size_t cols,
           uint32_t gcols, cudaStream_t st) {
  if (n == 0) return 0;
  const unsigned blocks = grid_for<T>(n);
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(out);
  if (threshold > 0u && cols != (size_t)gcols)
    gelu_dropout_kernel<T, BWD, true><<<blocks, 256, 0, st>>>(
        xp, dyp, op, n, seed, threshold, inv_keep, base, cols, gcols);
  else
    gelu_dropout_kernel<T, BWD, false><<<blocks, 256, 0, st>>>(
        xp, dyp, op, n, seed, threshold, inv_keep, base, cols, gcols);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scale(const void* x, const void* row_keep, void* out, size_t n, uint32_t seed,
                 uint32_t threshold, float inv_keep, uint32_t base, size_t cols,
                 uint32_t gcols, cudaStream_t st) {
  if (n == 0) return 0;
  const unsigned blocks = grid_for<T>(n);
  const T* xp = static_cast<const T*>(x);
  const uint8_t* rk = static_cast<const uint8_t*>(row_keep);
  T* op = static_cast<T*>(out);
  const bool col_shard = threshold > 0u && cols != (size_t)gcols;
#define ORON_SCALE(COLS, ROWS)                                                   \
  hash_dropout_kernel<T, COLS, ROWS><<<blocks, 256, 0, st>>>(xp, rk, op, n, seed, \
                                                             threshold, inv_keep, \
                                                             base, cols, gcols)
  if (rk == nullptr) {
    if (col_shard) ORON_SCALE(true, false); else ORON_SCALE(false, false);
  } else {
    if (col_shard) ORON_SCALE(true, true); else ORON_SCALE(false, true);
  }
#undef ORON_SCALE
  return (int)cudaGetLastError();
}

}  // namespace

// x, out (and dy) are contiguous and 16-byte aligned; n elements in all, rows
// of cols. The shard sits at global row row0 and column col0 of a tensor
// gcols wide; a whole tensor is row0 = col0 = 0, gcols = cols.
static uint32_t global_base(long long row0, long long gcols, long long col0) {
  return (uint32_t)((unsigned long long)row0 * (unsigned long long)gcols +
                    (unsigned long long)col0);
}

extern "C" int gelu_dropout_fwd(const void* x, void* out, long long n,
                                unsigned int seed, unsigned int threshold,
                                float inv_keep, int is_bf16, long long cols,
                                long long row0, long long gcols, long long col0,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t base = global_base(row0, gcols, col0);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(x, nullptr, out, (size_t)n, seed, threshold,
                                        inv_keep, base, (size_t)cols, (uint32_t)gcols, st);
  return launch<float, false>(x, nullptr, out, (size_t)n, seed, threshold, inv_keep, base,
                              (size_t)cols, (uint32_t)gcols, st);
}

extern "C" int gelu_dropout_bwd(const void* x, const void* dy, void* dx, long long n,
                                unsigned int seed, unsigned int threshold,
                                float inv_keep, int is_bf16, long long cols,
                                long long row0, long long gcols, long long col0,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t base = global_base(row0, gcols, col0);
  if (is_bf16)
    return launch<__nv_bfloat16, true>(x, dy, dx, (size_t)n, seed, threshold, inv_keep,
                                       base, (size_t)cols, (uint32_t)gcols, st);
  return launch<float, true>(x, dy, dx, (size_t)n, seed, threshold, inv_keep, base,
                             (size_t)cols, (uint32_t)gcols, st);
}

// The attention output's dropout: out = row_keep[r] && keep(idx) ? x / (1 - rate) : 0,
// the product in f32 and rounded once at the store. row_keep is one byte per
// row of [n / cols, cols], or null for every row kept.
extern "C" int dropout_fwd(const void* x, const void* row_keep, void* out, long long n,
                           unsigned int seed, unsigned int threshold, float inv_keep,
                           int is_bf16, long long cols, long long row0, long long gcols,
                           long long col0, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t base = global_base(row0, gcols, col0);
  if (is_bf16)
    return launch_scale<__nv_bfloat16>(x, row_keep, out, (size_t)n, seed, threshold,
                                       inv_keep, base, (size_t)cols, (uint32_t)gcols, st);
  return launch_scale<float>(x, row_keep, out, (size_t)n, seed, threshold, inv_keep, base,
                             (size_t)cols, (uint32_t)gcols, st);
}

// Its backward: the same mask, regenerated from the seed, on dy.
extern "C" int dropout_bwd(const void* dy, const void* row_keep, void* dx, long long n,
                           unsigned int seed, unsigned int threshold, float inv_keep,
                           int is_bf16, long long cols, long long row0, long long gcols,
                           long long col0, void* stream) {
  return dropout_fwd(dy, row_keep, dx, n, seed, threshold, inv_keep, is_bf16, cols, row0,
                     gcols, col0, stream);
}
