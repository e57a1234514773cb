// Lanes-layout flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel oron_tts_tpu/ops/flash_attention.py:387
// (_flash_lanes_kernel). q, k, v and o stay in the [B, T, H*D] layout the
// projections write: a block reads its head's 64 columns with strided rows,
// so no head transpose is ever materialised.
//
// Semantics kept from the TPU kernel: non-causal softmax attention, keys at
// or beyond kv_lens[b] masked (the TPU writes -1e30; a masked key weighs 0
// either way, and kv_len <= 0 gives every key the same weight), the scale
// 1/sqrt(D) with log2(e) folded in and exp2, P cast to the input type
// before the PV product, f32 accumulation, and out / max(l, 1e-30).
//
// Design: one block per (query tile of 64 rows, head, batch row). The TPU
// kernel holds a whole key row in VMEM and runs a two-pass softmax; here
// K/V tiles of 64 keys stream through shared memory with an online softmax
// (running max m, running sum l, rescaled accumulator). Tiles past
// kv_len are skipped. Query rows past kv_len are computed like any other
// (finite; the caller re-masks them); rows and keys past T are masked.
//
// Bound on the H100: at the slice's shapes (T ~ 832, H*D = 1024) the work
// is ~4*T*kv*H*D flops over ~8*T*H*D bytes, some 400 flops per byte, so
// the bound is the tensor cores. bf16 uses mma.sync m16n8k16 with f32
// accumulators (not yet wgmma/TMA); f32 inputs take a plain SIMT kernel
// in true f32, one query row per thread.
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int BM = 64;       // query rows per block: 4 warps x 16
constexpr int BN = 64;       // keys per shared-memory tile
constexpr int LDS = D + 8;   // padded row stride (bf16 elements)
constexpr int LDV = BN + 8;  // padded row stride of the transposed V tile

__global__ void __launch_bounds__(128)
flash_lanes_bf16(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ kv_lens,
                 __nv_bfloat16* __restrict__ o, int T, int HD,
                 float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Ks[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * LDV];  // [d][key]

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * T * HD + (size_t)h * D;

  const int kv = kv_lens[b];
  int limit = kv < T ? kv : T;
  float s_scale = scale_log2;
  if (kv <= 0) {  // every key masked: equal weights, as -1e30 everywhere
    limit = T;
    s_scale = 0.f;
  }

  for (int idx = tid; idx < BM * (D / 8); idx += blockDim.x) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < T)
      val = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * HD + c);
    *reinterpret_cast<uint4*>(&Qs[r * LDS + c]) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qa[kk][0] = oron::ld32(&Qs[r0 * LDS + c]);
    qa[kk][1] = oron::ld32(&Qs[(r0 + 8) * LDS + c]);
    qa[kk][2] = oron::ld32(&Qs[r0 * LDS + c + 8]);
    qa[kk][3] = oron::ld32(&Qs[(r0 + 8) * LDS + c + 8]);
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  const int n_tiles = (limit + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BN * (D / 8); idx += blockDim.x) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
      if (k0 + r < T) {
        const size_t off = base + (size_t)(k0 + r) * HD + c;
        kval = *reinterpret_cast<const uint4*>(k + off);
        vval = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LDS + c]) = kval;
      const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * LDV + r] = vp[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int n = j * 8 + g, c = kk * 16 + t4 * 2;
        uint32_t bb[2] = {oron::ld32(&Ks[n * LDS + c]),
                          oron::ld32(&Ks[n * LDS + c + 8])};
        oron::mma_bf16_16816(s[j], qa[kk], bb);
      }
    }

    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t4 * 2 + (e & 1);
        const float val = col < limit ? s[j][e] * s_scale : -INFINITY;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_i[r] - mx[r]);  // 0 on the first tile
      m_i[r] = mx[r];
      l_i[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_i[e >> 1]);
        s[j][e] = p;
        l_i[e >> 1] += p;
        acc[j][e] *= alpha[e >> 1];
      }

    // O += P V: P from the S accumulators (cast to bf16), V^T from smem
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4] = {oron::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        oron::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        oron::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        oron::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = j * 8 + g, c = kk * 16 + t4 * 2;
        uint32_t bb[2] = {oron::ld32(&Vt[n * LDV + c]),
                          oron::ld32(&Vt[n * LDV + c + 8])};
        oron::mma_bf16_16816(acc[j], pa, bb);
      }
    }
  }

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l_i[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    l[r] = fmaxf(x, 1e-30f);
  }
  const int row = q0 + r0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (row < T)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)row * HD + col) =
          oron::pack_bf16(acc[j][0] / l[0], acc[j][1] / l[0]);
    if (row + 8 < T)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)(row + 8) * HD + col) =
          oron::pack_bf16(acc[j][2] / l[1], acc[j][3] / l[1]);
  }
}

constexpr int F32_ROWS = 64;  // query rows (threads) per block
constexpr int F32_KEYS = 32;  // keys per shared-memory tile

__global__ void __launch_bounds__(F32_ROWS)
flash_lanes_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ kv_lens,
                float* __restrict__ o, int T, int HD, float scale_log2) {
  __shared__ float Ks[F32_KEYS][D];
  __shared__ float Vs[F32_KEYS][D];
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * F32_ROWS + threadIdx.x;
  const size_t base = (size_t)b * T * HD + (size_t)h * D;

  const int kv = kv_lens[b];
  int limit = kv < T ? kv : T;
  float s_scale = scale_log2;
  if (kv <= 0) {
    limit = T;
    s_scale = 0.f;
  }

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row < T ? q[base + (size_t)row * HD + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < limit; k0 += F32_KEYS) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < F32_KEYS * D; idx += blockDim.x) {
      const int r = idx / D, c = idx % D;
      const bool ok = k0 + r < T;
      Ks[r][c] = ok ? k[base + (size_t)(k0 + r) * HD + c] : 0.f;
      Vs[r][c] = ok ? v[base + (size_t)(k0 + r) * HD + c] : 0.f;
    }
    __syncthreads();
    const int n = min(F32_KEYS, limit - k0);
    for (int j = 0; j < n; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], Ks[j][d], dot);
      const float sv = dot * s_scale;
      const float mn = fmaxf(m, sv);
      const float corr = exp2f(m - mn);
      const float p = exp2f(sv - mn);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d] * corr);
      m = mn;
    }
  }
  if (row < T) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) o[base + (size_t)row * HD + d] = acc[d] / denom;
  }
}

}  // namespace

extern "C" int flash_lanes_fwd(const void* q, const void* k, const void* v,
                               const void* kv_lens, void* out, int B, int T,
                               int H, int Dh, int is_bf16, void* stream) {
  if (Dh != D) return (int)cudaErrorInvalidValue;
  const int HD = H * Dh;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)Dh);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dim3 grid((T + BM - 1) / BM, H, B);
    flash_lanes_bf16<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_lens),
        static_cast<__nv_bfloat16*>(out), T, HD, scale_log2);
  } else {
    dim3 grid((T + F32_ROWS - 1) / F32_ROWS, H, B);
    flash_lanes_f32<<<grid, F32_ROWS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(kv_lens),
        static_cast<float*>(out), T, HD, scale_log2);
  }
  return (int)cudaGetLastError();
}
