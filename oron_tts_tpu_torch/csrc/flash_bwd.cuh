// Attention backward bodies shared by the lanes and classic kernels (sm_90a).
//
// Math, per head and (query i, key j), kept from the TPU kernels
// (oron_tts_tpu/ops/flash_attention.py:528 _flash_lanes_bwd_kernel and :749
// _flash_bwd_kernel):
//   s  = q_i.k_j / sqrt(D) * log2(e);  p = exp2(s - lse2_i), 0 for j >= kv_len
//   dp = dO_i.v_j;   delta_i = sum_d dO_i[d] * O_i[d]   (f32)
//   ds = p * (dp - delta_i) / sqrt(D)                   (no log2(e) here)
//   dq_i = sum_j ds k_j;  dk_j = sum_i ds q_i;  dv_j = sum_i p dO_i
// with ds and p rounded to the input type before those three products and
// f32 accumulation throughout. Rows live where a Layout (flash_fwd.cuh) says.
//
// A row with kv_len <= 0: the lanes backward gives it zero gradients (exact
// when its dO is 0, as for the batch-padding rows of training); the classic
// backward (uniform_empty) gives it what the TPU's -1e30 mask gives, equal
// weights over all T keys (p = 1/T, with lse2 = log2 T from the stats pass)
// and the gradients that follow from them.
//
// Design. The TPU kernels run one program per (batch row, head or lane tile)
// that walks the query blocks in order and carries dK/dV for the whole
// sequence in VMEM. Thread blocks run in no order and hold far less, so the
// work is cut twice and S is recomputed in both cuts:
//   1. attn_delta: one warp per (row, head) writes delta [B, H, T].
//   2. bwd_dkdv: one block per (64-key tile, head, batch row) loops over the
//      query tiles and keeps its dK/dV tile in registers; each warp owns 16
//      keys and computes S^T = K Q^T so that P^T and dS^T come out of the
//      accumulators already in the A-fragment layout of the next product.
//   3. bwd_dq: one block per (64-query tile, head, batch row) loops over the
//      key tiles below kv_len, as the forward does.
// No atomics, so the result is the same from run to run. Key tiles past
// kv_len are skipped and their dK/dV rows are written as exact zeros. Query
// rows past kv_len are computed like any other, as in the forward.
//
// bf16 uses mma.sync m16n8k16 with f32 accumulators (seven products with the
// recompute, no wgmma/TMA yet); f32 inputs take SIMT kernels in true f32, one
// query row (dq) or key row (dkdv) per thread.
#pragma once

#include "flash_fwd.cuh"

namespace oron {
namespace attn {

// ---------------------------------------------------------------- delta

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

// delta[(b*H + h)*T + t] = sum_d dO[row] * O[row]; one warp each
template <typename T, int D>
__global__ void __launch_bounds__(256)
attn_delta(const T* __restrict__ o, const T* __restrict__ dout,
           float* __restrict__ delta, int B, int Tn, int H, Layout lay) {
  const int lane = threadIdx.x & 31;
  const size_t idx = (size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (idx >= (size_t)B * H * Tn) return;
  const int t = (int)(idx % Tn);
  const size_t bh = idx / Tn;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const size_t off = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride +
                     (size_t)t * lay.row_stride;
  float x = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) x += to_f32<T>(dout[off + d]) * to_f32<T>(o[off + d]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  if (lane == 0) delta[idx] = x;
}

// Keys that count in the backward, and the score scale (see the header).
__device__ __forceinline__ void bwd_limit(int kv, int T, float scale_log2,
                                          int uniform_empty, int& limit, float& s_scale) {
  limit = kv < T ? kv : T;
  s_scale = scale_log2;
  if (kv <= 0) {
    limit = uniform_empty ? T : 0;
    s_scale = 0.f;
  }
}

// ----------------------------------------------------------- bf16 helpers

template <int D>
struct BwdSmem {
  static constexpr int LDS = D + 8;   // row-major [row][d]
  static constexpr int LDT = BN + 8;  // transposed [d][row]
};

// 64 rows x D columns of one head into smem, row-major (dst[r][c]) and,
// where dst_t is given, transposed too (dst_t[c][r]). Rows at or beyond T
// are zeros.
template <int D>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          size_t base, int row0, int T, int rs,
                                          __nv_bfloat16* dst, __nv_bfloat16* dst_t) {
  constexpr int LDS = BwdSmem<D>::LDS, LDT = BwdSmem<D>::LDT;
  for (int idx = threadIdx.x; idx < BN * (D / 8); idx += blockDim.x) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < T)
      val = *reinterpret_cast<const uint4*>(src + base + (size_t)(row0 + r) * rs + c);
    *reinterpret_cast<uint4*>(&dst[r * LDS + c]) = val;
    if (dst_t != nullptr) {
      const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(c + j) * LDT + r] = vp[j];
    }
  }
}

// This warp's 16 rows of a row-major [64][D] smem tile as mma A fragments
template <int D>
__device__ __forceinline__ void load_a_frags(const __nv_bfloat16* tile, int r0, int t4,
                                             uint32_t (*a)[4]) {
  constexpr int LDS = BwdSmem<D>::LDS;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    a[kk][0] = ld32(&tile[r0 * LDS + c]);
    a[kk][1] = ld32(&tile[(r0 + 8) * LDS + c]);
    a[kk][2] = ld32(&tile[r0 * LDS + c + 8]);
    a[kk][3] = ld32(&tile[(r0 + 8) * LDS + c + 8]);
  }
}

// acc[16 x 64] = A[16 x D] * Bs^T, Bs row-major [64 n][D k] in smem
template <int D>
__device__ __forceinline__ void mma_a_bt(float (*acc)[4], uint32_t (*a)[4],
                                         const __nv_bfloat16* bs, int g, int t4) {
  constexpr int LDS = BwdSmem<D>::LDS;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int n = j * 8 + g, c = kk * 16 + t4 * 2;
      uint32_t bb[2] = {ld32(&bs[n * LDS + c]), ld32(&bs[n * LDS + c + 8])};
      mma_bf16_16816(acc[j], a[kk], bb);
    }
  }
}

// acc[16 x D] += round_bf16(x)[16 x 64] * Bt^T, where x is an accumulator
// tile of a previous product and Bt is [D n][64 k] in smem (transposed)
template <int D>
__device__ __forceinline__ void mma_acc_bt(float (*acc)[4], float (*x)[4],
                                           const __nv_bfloat16* bt, int g, int t4) {
  constexpr int LDT = BwdSmem<D>::LDT;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                     pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                     pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                     pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int n = j * 8 + g, c = kk * 16 + t4 * 2;
      uint32_t bb[2] = {ld32(&bt[n * LDT + c]), ld32(&bt[n * LDT + c + 8])};
      mma_bf16_16816(acc[j], a, bb);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_tile_rows(__nv_bfloat16* __restrict__ dst,
                                                size_t base, int row, int T, int rs,
                                                float (*acc)[4], int t4) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (row < T)
      *reinterpret_cast<uint32_t*>(dst + base + (size_t)row * rs + col) =
          pack_bf16(acc[j][0], acc[j][1]);
    if (row + 8 < T)
      *reinterpret_cast<uint32_t*>(dst + base + (size_t)(row + 8) * rs + col) =
          pack_bf16(acc[j][2], acc[j][3]);
  }
}

// ------------------------------------------------------------- bf16 dK/dV

template <int D>
__global__ void __launch_bounds__(128)
bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int T, Layout lay, float sm_scale,
              float scale_log2, int uniform_empty) {
  constexpr int LDS = BwdSmem<D>::LDS, LDT = BwdSmem<D>::LDT;
  __shared__ __align__(16) __nv_bfloat16 Qs[BN * LDS];   // [query][d]
  __shared__ __align__(16) __nv_bfloat16 Qt[D * LDT];    // [d][query]
  __shared__ __align__(16) __nv_bfloat16 dOs[BN * LDS];  // [query][d]
  __shared__ __align__(16) __nv_bfloat16 dOt[D * LDT];   // [d][query]
  __shared__ float lse_s[BN];
  __shared__ float delta_s[BN];

  const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, rs = lay.row_stride;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const size_t stat = ((size_t)b * H + h) * T;
  int limit;
  float s_scale;
  bwd_limit(kv_lens[b], T, scale_log2, uniform_empty, limit, s_scale);
  const int r0 = warp * 16 + g;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  if (k0 < limit) {
    // this block's keys and values as A fragments (staged through smem)
    uint32_t ka[D / 16][4], va[D / 16][4];
    load_tile<D>(k, base, k0, T, rs, Qs, nullptr);
    load_tile<D>(v, base, k0, T, rs, dOs, nullptr);
    __syncthreads();
    load_a_frags<D>(Qs, r0, t4, ka);
    load_a_frags<D>(dOs, r0, t4, va);

    const int n_q = (T + BN - 1) / BN;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * BN;
      __syncthreads();  // the previous tile is no longer read
      load_tile<D>(q, base, q0, T, rs, Qs, Qt);
      load_tile<D>(dout, base, q0, T, rs, dOs, dOt);
      if (tid < BN) {
        const bool ok = q0 + tid < T;
        lse_s[tid] = ok ? lse[stat + q0 + tid] : INFINITY;  // p = 0 past T
        delta_s[tid] = ok ? delta[stat + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[BN / 8][4], dp[BN / 8][4];
      mma_a_bt<D>(s, ka, Qs, g, t4);    // S^T  = K Q^T   [key][query]
      mma_a_bt<D>(dp, va, dOs, g, t4);  // dP^T = V dO^T  [key][query]
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + t4 * 2 + (e & 1);
          const int key = k0 + r0 + (e >> 1) * 8;
          const float p = key < limit ? exp2f(s[j][e] * s_scale - lse_s[qc]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[qc]) * sm_scale;
        }
      mma_acc_bt<D>(dv_acc, s, dOt, g, t4);  // dV += P^T dO
      mma_acc_bt<D>(dk_acc, dp, Qt, g, t4);  // dK += dS^T Q
    }
  }
  store_tile_rows<D>(dk, base, k0 + r0, T, rs, dk_acc, t4);
  store_tile_rows<D>(dv, base, k0 + r0, T, rs, dv_acc, t4);
}

// ---------------------------------------------------------------- bf16 dQ

template <int D>
__global__ void __launch_bounds__(128)
bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ dq, int T,
            Layout lay, float sm_scale, float scale_log2, int uniform_empty) {
  constexpr int LDS = BwdSmem<D>::LDS, LDT = BwdSmem<D>::LDT;
  __shared__ __align__(16) __nv_bfloat16 Ks[BN * LDS];  // [key][d]
  __shared__ __align__(16) __nv_bfloat16 Kt[D * LDT];   // [d][key]
  __shared__ __align__(16) __nv_bfloat16 Vs[BN * LDS];  // [key][d]

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, rs = lay.row_stride;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const size_t stat = ((size_t)b * H + h) * T;
  int limit;
  float s_scale;
  bwd_limit(kv_lens[b], T, scale_log2, uniform_empty, limit, s_scale);
  const int r0 = warp * 16 + g;

  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_tile<D>(q, base, q0, T, rs, Ks, nullptr);
  load_tile<D>(dout, base, q0, T, rs, Vs, nullptr);
  __syncthreads();
  load_a_frags<D>(Ks, r0, t4, qa);
  load_a_frags<D>(Vs, r0, t4, doa);

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    lse_r[r] = row < T ? lse[stat + row] : INFINITY;
    delta_r[r] = row < T ? delta[stat + row] : 0.f;
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  const int n_tiles = (limit + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile (or the staging) is no longer read
    load_tile<D>(k, base, k0, T, rs, Ks, Kt);
    load_tile<D>(v, base, k0, T, rs, Vs, nullptr);
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
    mma_a_bt<D>(s, qa, Ks, g, t4);    // S  = Q K^T   [query][key]
    mma_a_bt<D>(dp, doa, Vs, g, t4);  // dP = dO V^T  [query][key]
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t4 * 2 + (e & 1);
        const float p = key < limit ? exp2f(s[j][e] * s_scale - lse_r[e >> 1]) : 0.f;
        dp[j][e] = p * (dp[j][e] - delta_r[e >> 1]) * sm_scale;
      }
    mma_acc_bt<D>(dq_acc, dp, Kt, g, t4);  // dQ += dS K
  }
  store_tile_rows<D>(dq, base, q0 + r0, T, rs, dq_acc, t4);
}

// ------------------------------------------------------------ f32 (SIMT)

constexpr int F32_TILE = 16;  // rows of the streamed tile

template <int D>
__global__ void __launch_bounds__(F32_ROWS)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int* __restrict__ kv_lens, float* __restrict__ dk,
             float* __restrict__ dv, int T, Layout lay, float sm_scale, float scale_log2,
             int uniform_empty) {
  constexpr int LDF = D + 1;  // padded stride: thread r reads row r
  __shared__ float Ks[F32_ROWS * LDF];
  __shared__ float Vs[F32_ROWS * LDF];
  __shared__ float Qs[F32_TILE][D];
  __shared__ float dOs[F32_TILE][D];
  __shared__ float lse_s[F32_TILE];
  __shared__ float delta_s[F32_TILE];

  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y, rs = lay.row_stride;
  const int k0 = blockIdx.x * F32_ROWS, tid = threadIdx.x;
  const int key = k0 + tid;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const size_t stat = ((size_t)b * H + h) * T;
  int limit;
  float s_scale;
  bwd_limit(kv_lens[b], T, scale_log2, uniform_empty, limit, s_scale);

  float dk_acc[D], dv_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dk_acc[d] = dv_acc[d] = 0.f;

  if (k0 < limit) {
    for (int idx = tid; idx < F32_ROWS * D; idx += blockDim.x) {
      const int r = idx / D, c = idx % D;
      const bool ok = k0 + r < T;
      Ks[r * LDF + c] = ok ? k[base + (size_t)(k0 + r) * rs + c] : 0.f;
      Vs[r * LDF + c] = ok ? v[base + (size_t)(k0 + r) * rs + c] : 0.f;
    }
    const float* kr = &Ks[tid * LDF];
    const float* vr = &Vs[tid * LDF];
    for (int q0 = 0; q0 < T; q0 += F32_TILE) {
      __syncthreads();
      for (int idx = tid; idx < F32_TILE * D; idx += blockDim.x) {
        const int r = idx / D, c = idx % D;
        const bool ok = q0 + r < T;
        Qs[r][c] = ok ? q[base + (size_t)(q0 + r) * rs + c] : 0.f;
        dOs[r][c] = ok ? dout[base + (size_t)(q0 + r) * rs + c] : 0.f;
      }
      if (tid < F32_TILE) {
        const bool ok = q0 + tid < T;
        lse_s[tid] = ok ? lse[stat + q0 + tid] : INFINITY;
        delta_s[tid] = ok ? delta[stat + q0 + tid] : 0.f;
      }
      __syncthreads();
      if (key < limit) {
        const int n = min(F32_TILE, T - q0);
        for (int i = 0; i < n; ++i) {
          float sdot = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            sdot = fmaf(Qs[i][d], kr[d], sdot);
            dp = fmaf(dOs[i][d], vr[d], dp);
          }
          const float p = exp2f(sdot * s_scale - lse_s[i]);
          const float ds = p * (dp - delta_s[i]) * sm_scale;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            dk_acc[d] = fmaf(ds, Qs[i][d], dk_acc[d]);
            dv_acc[d] = fmaf(p, dOs[i][d], dv_acc[d]);
          }
        }
      }
    }
  }
  if (key < T) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[base + (size_t)key * rs + d] = dk_acc[d];
      dv[base + (size_t)key * rs + d] = dv_acc[d];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F32_ROWS)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ kv_lens, float* __restrict__ dq, int T, Layout lay,
           float sm_scale, float scale_log2, int uniform_empty) {
  constexpr int LDF = D + 1;
  __shared__ float Qs[F32_ROWS * LDF];
  __shared__ float dOs[F32_ROWS * LDF];
  __shared__ float Ks[F32_TILE][D];
  __shared__ float Vs[F32_TILE][D];

  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y, rs = lay.row_stride;
  const int q0 = blockIdx.x * F32_ROWS, tid = threadIdx.x;
  const int row = q0 + tid;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const size_t stat = ((size_t)b * H + h) * T;
  int limit;
  float s_scale;
  bwd_limit(kv_lens[b], T, scale_log2, uniform_empty, limit, s_scale);

  for (int idx = tid; idx < F32_ROWS * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D;
    const bool ok = q0 + r < T;
    Qs[r * LDF + c] = ok ? q[base + (size_t)(q0 + r) * rs + c] : 0.f;
    dOs[r * LDF + c] = ok ? dout[base + (size_t)(q0 + r) * rs + c] : 0.f;
  }
  const float* qr = &Qs[tid * LDF];
  const float* dor = &dOs[tid * LDF];
  const float lse_r = row < T ? lse[stat + row] : INFINITY;
  const float delta_r = row < T ? delta[stat + row] : 0.f;

  float dq_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dq_acc[d] = 0.f;

  for (int k0 = 0; k0 < limit; k0 += F32_TILE) {
    __syncthreads();
    for (int idx = tid; idx < F32_TILE * D; idx += blockDim.x) {
      const int r = idx / D, c = idx % D;
      const bool ok = k0 + r < T;
      Ks[r][c] = ok ? k[base + (size_t)(k0 + r) * rs + c] : 0.f;
      Vs[r][c] = ok ? v[base + (size_t)(k0 + r) * rs + c] : 0.f;
    }
    __syncthreads();
    const int n = min(F32_TILE, limit - k0);
    for (int j = 0; j < n; ++j) {
      float sdot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sdot = fmaf(qr[d], Ks[j][d], sdot);
        dp = fmaf(dor[d], Vs[j][d], dp);
      }
      const float p = exp2f(sdot * s_scale - lse_r);
      const float ds = p * (dp - delta_r) * sm_scale;
#pragma unroll
      for (int d = 0; d < D; ++d) dq_acc[d] = fmaf(ds, Ks[j][d], dq_acc[d]);
    }
  }
  if (row < T) {
#pragma unroll
    for (int d = 0; d < D; ++d) dq[base + (size_t)row * rs + d] = dq_acc[d];
  }
}

// ------------------------------------------------------------------ host

// delta, then dK/dV and dQ; lse [B, H, T] f32 must already hold lse2.
template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, const void* kv_lens, void* delta,
               void* dq, void* dk, void* dv, int B, int Tn, int H, Layout lay,
               int uniform_empty, cudaStream_t st) {
  const float sm_scale = 1.f / sqrtf((float)D);
  const float scale_log2 = 1.4426950408889634f * sm_scale;
  const size_t n_warps = (size_t)B * Tn * H;
  attn_delta<T, D><<<(unsigned)((n_warps + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<float*>(delta),
      B, Tn, H, lay);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const int* lens = static_cast<const int*>(kv_lens);
  if constexpr (sizeof(T) == 2) {
    dim3 grid((Tn + BM - 1) / BM, H, B);
    bwd_dkdv_bf16<D><<<grid, 128, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse_f, delta_f, lens, static_cast<T*>(dk),
        static_cast<T*>(dv), Tn, lay, sm_scale, scale_log2, uniform_empty);
    bwd_dq_bf16<D><<<grid, 128, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse_f, delta_f, lens, static_cast<T*>(dq), Tn, lay,
        sm_scale, scale_log2, uniform_empty);
  } else {
    dim3 grid((Tn + F32_ROWS - 1) / F32_ROWS, H, B);
    bwd_dkdv_f32<D><<<grid, F32_ROWS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse_f, delta_f, lens, static_cast<T*>(dk),
        static_cast<T*>(dv), Tn, lay, sm_scale, scale_log2, uniform_empty);
    bwd_dq_f32<D><<<grid, F32_ROWS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse_f, delta_f, lens, static_cast<T*>(dq), Tn, lay,
        sm_scale, scale_log2, uniform_empty);
  }
  return (int)cudaGetLastError();
}

}  // namespace attn
}  // namespace oron
