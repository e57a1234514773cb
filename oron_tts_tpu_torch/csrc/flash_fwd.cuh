// Attention forward bodies shared by the lanes and classic kernels (sm_90a).
//
// One body serves four TPU kernels of oron_tts_tpu/ops/flash_attention.py and
// scripts/bench_attention.py: the lanes forward (:387) and its stats variant
// (:424), the classic forward (:32), the packed head-pair forward (:246) and
// the no-softmax split (_nosm_kernel). They differ only in where a head's
// rows live, so a Layout names them: element (t, d) of head h of batch row b
// is at b * batch_stride + h * head_stride + t * row_stride + d.
//   lanes   [B, T, H*D]:  batch_stride T*H*D, head_stride D,   row_stride H*D
//   classic [B, H, T, D]: batch_stride H*T*D, head_stride T*D, row_stride D
//
// Semantics kept from the TPU kernels: non-causal attention, keys at or
// beyond kv_lens[b] masked (the TPU writes -1e30 after scaling; a masked key
// weighs 0 either way, and kv_len <= 0 gives every one of the T keys the same
// weight, as exp(-1e30 - (-1e30)) = 1 does there), scores in f32, P cast to
// the input type before the PV product, f32 accumulation, out / max(l, 1e-30).
// exp2 of s * scale * log2(e), or exp of s * scale (the TPU kernel's
// use_exp2=False); the softmax value is the same.
//
// Modes: SOFTMAX writes the output (and lse2 = m + log2(max(l, 1e-30)) when
// given a pointer); STATS writes only lse2 (the classic backward's recomputed
// statistics, no PV product); NOSM is the bench's split, (q.k in f32) / T cast
// to the input type, times V, no mask, no max, no sum.
//
// Design: a group of 128 threads (4 warps x 16 query rows) owns a tile of 64
// query rows of one head; K/V tiles of 64 keys stream through shared memory
// with an online softmax (running max m, running sum l, rescaled
// accumulator); tiles past kv_len are skipped. The TPU kernels hold a whole
// key row in VMEM and run a two-pass softmax; a thread block cannot hold
// that. The Q tile is staged through the K buffer and kept in registers as
// mma A fragments. A block holds HPB such groups: the packed kernel runs the
// even and odd head of a pair side by side (HPB = 2), each with its own
// online softmax, where the TPU packed both heads into one block-diagonal
// [2T, 2D] product with zero halves (twice the MACs, for its 128-lane unit).
//
// bf16 uses mma.sync m16n8k16 with f32 accumulators; f32 inputs take a SIMT
// path in true f32, one query row per thread.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace oron {
namespace attn {

constexpr int BM = 64;   // query rows per group: 4 warps x 16
constexpr int BN = 64;   // keys per shared-memory tile
constexpr int NT = 128;  // threads per group (bf16)

enum Mode { SOFTMAX = 0, STATS = 1, NOSM = 2 };

struct Layout {
  long long batch_stride, head_stride;
  int row_stride;
};

__host__ __device__ inline Layout lanes_layout(int T, int H, int D) {
  return Layout{(long long)T * H * D, (long long)D, H * D};
}

__host__ __device__ inline Layout classic_layout(int T, int H, int D) {
  return Layout{(long long)H * T * D, (long long)T * D, D};
}

// shared memory of one group, bf16 elements: the K tile (Q staged there
// first) [64][D + 8] and V transposed [D][64 + 8]
template <int D>
struct FwdSmem {
  static constexpr int LDS = D + 8;
  static constexpr int LDV = BN + 8;
  static constexpr int K_ELEMS = BN * LDS;
  static constexpr int ELEMS = K_ELEMS + D * LDV;
  static constexpr int BYTES = ELEMS * 2;
};

// Keys that count for a row of batch b, and the score scale. kv <= 0: all T
// keys with scale 0 (equal weights).
__device__ __forceinline__ void key_limit(int kv, int T, float scale, int& limit,
                                          float& s_scale) {
  limit = kv < T ? kv : T;
  s_scale = scale;
  if (kv <= 0) {
    limit = T;
    s_scale = 0.f;
  }
}

__device__ __forceinline__ float softmax_exp(float x, bool use_exp2) {
  return use_exp2 ? exp2f(x) : expf(x);
}

// One group's 64 query rows [q0, q0 + 64) of one head, bf16.
template <int D, int MODE>
__device__ __forceinline__ void fwd_group_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse_row, size_t base, int rs, int T, int kv, int q0,
    float scale, bool use_exp2, __nv_bfloat16* Ks, int tid) {
  using S = FwdSmem<D>;
  constexpr int LDS = S::LDS, LDV = S::LDV, KD = D / 16, ND = D / 8;
  __nv_bfloat16* Vt = Ks + S::K_ELEMS;  // [d][key]
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  int limit;
  float s_scale;
  if (MODE == NOSM) {
    limit = T;
    s_scale = scale;  // 1 / T
  } else {
    key_limit(kv, T, scale, limit, s_scale);
  }
  const bool ex2 = MODE == STATS ? true : use_exp2;

  for (int idx = tid; idx < BM * (D / 8); idx += NT) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < T)
      val = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * rs + c);
    *reinterpret_cast<uint4*>(&Ks[r * LDS + c]) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qa[kk][0] = ld32(&Ks[r0 * LDS + c]);
    qa[kk][1] = ld32(&Ks[(r0 + 8) * LDS + c]);
    qa[kk][2] = ld32(&Ks[r0 * LDS + c + 8]);
    qa[kk][3] = ld32(&Ks[(r0 + 8) * LDS + c + 8]);
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  const int n_tiles = (limit + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile (or the staged Q) is no longer read
    for (int idx = tid; idx < BN * (D / 8); idx += NT) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
      if (k0 + r < T) {
        const size_t off = base + (size_t)(k0 + r) * rs + c;
        kval = *reinterpret_cast<const uint4*>(k + off);
        if (MODE != STATS) vval = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LDS + c]) = kval;
      if (MODE != STATS) {
        const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
        for (int j = 0; j < 8; ++j) Vt[(c + j) * LDV + r] = vp[j];
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int n = j * 8 + g, c = kk * 16 + t4 * 2;
        uint32_t bb[2] = {ld32(&Ks[n * LDS + c]), ld32(&Ks[n * LDS + c + 8])};
        mma_bf16_16816(s[j], qa[kk], bb);
      }
    }

    if (MODE == NOSM) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= s_scale;
    } else {
      float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
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
        alpha[r] = softmax_exp(m_i[r] - mx[r], ex2);  // 0 on the first tile
        m_i[r] = mx[r];
        l_i[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = softmax_exp(s[j][e] - m_i[e >> 1], ex2);
          s[j][e] = p;
          l_i[e >> 1] += p;
        }
      if (MODE != STATS) {
#pragma unroll
        for (int j = 0; j < ND; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
      }
    }

    if (MODE != STATS) {
      // O += P V: P from the S accumulators (cast to bf16), V^T from smem
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const int n = j * 8 + g, c = kk * 16 + t4 * 2;
          uint32_t bb[2] = {ld32(&Vt[n * LDV + c]), ld32(&Vt[n * LDV + c + 8])};
          mma_bf16_16816(acc[j], pa, bb);
        }
      }
    }
  }

  const int row = q0 + r0;
  float l[2] = {1.f, 1.f};
  if (MODE != NOSM) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = l_i[r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      l[r] = fmaxf(x, 1e-30f);
    }
    if (lse_row != nullptr && t4 == 0) {
      if (row < T) lse_row[row] = m_i[0] + log2f(l[0]);
      if (row + 8 < T) lse_row[row + 8] = m_i[1] + log2f(l[1]);
    }
  }
  if (MODE == STATS) return;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = j * 8 + t4 * 2;
    if (row < T)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)row * rs + col) =
          pack_bf16(acc[j][0] / l[0], acc[j][1] / l[0]);
    if (row + 8 < T)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)(row + 8) * rs + col) =
          pack_bf16(acc[j][2] / l[1], acc[j][3] / l[1]);
  }
}

// Grid (ceil(T / 64), H / HPB, B); HPB groups of 128 threads, head
// blockIdx.y * HPB + group. lse is [B, H, T] f32 or null.
template <int D, int MODE, int HPB>
__global__ void __launch_bounds__(NT * HPB)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int T, int H,
              Layout lay, float scale, int use_exp2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int grp = threadIdx.x / NT, tid = threadIdx.x % NT;
  const int h = blockIdx.y * HPB + grp, b = blockIdx.z;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw) + grp * FwdSmem<D>::ELEMS;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const int kv = MODE == NOSM ? T : kv_lens[b];
  float* lse_row = lse == nullptr ? nullptr : lse + ((size_t)b * H + h) * T;
  fwd_group_bf16<D, MODE>(q, k, v, o, lse_row, base, lay.row_stride, T, kv,
                          blockIdx.x * BM, scale, use_exp2 != 0, Ks, tid);
}

// ------------------------------------------------------------ f32 (SIMT)

constexpr int F32_ROWS = 64;  // query rows (threads) per group
constexpr int F32_KEYS = 32;  // keys per shared-memory tile

template <int D, int MODE, int HPB>
__global__ void __launch_bounds__(F32_ROWS * HPB)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ kv_lens,
             float* __restrict__ o, float* __restrict__ lse, int T, int H, Layout lay,
             float scale, int use_exp2) {
  extern __shared__ float fsm[];
  const int grp = threadIdx.x / F32_ROWS, tid = threadIdx.x % F32_ROWS;
  const int h = blockIdx.y * HPB + grp, b = blockIdx.z;
  float* Ks = fsm + (size_t)grp * 2 * F32_KEYS * D;
  float* Vs = Ks + F32_KEYS * D;
  const int row = blockIdx.x * F32_ROWS + tid;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const int rs = lay.row_stride;
  const bool ex2 = MODE == STATS ? true : use_exp2 != 0;

  int limit;
  float s_scale;
  if (MODE == NOSM) {
    limit = T;
    s_scale = scale;
  } else {
    key_limit(kv_lens[b], T, scale, limit, s_scale);
  }

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row < T ? q[base + (size_t)row * rs + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < limit; k0 += F32_KEYS) {
    __syncthreads();
    for (int idx = tid; idx < F32_KEYS * D; idx += F32_ROWS) {
      const int r = idx / D, c = idx % D;
      const bool ok = k0 + r < T;
      Ks[idx] = ok ? k[base + (size_t)(k0 + r) * rs + c] : 0.f;
      if (MODE != STATS) Vs[idx] = ok ? v[base + (size_t)(k0 + r) * rs + c] : 0.f;
    }
    __syncthreads();
    const int n = min(F32_KEYS, limit - k0);
    for (int j = 0; j < n; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], Ks[j * D + d], dot);
      if (MODE == NOSM) {
        const float p = dot * s_scale;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[j * D + d], acc[d]);
        continue;
      }
      const float sv = dot * s_scale;
      const float mn = fmaxf(m, sv);
      const float corr = softmax_exp(m - mn, ex2);
      const float p = softmax_exp(sv - mn, ex2);
      l = l * corr + p;
      if (MODE != STATS) {
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[j * D + d], acc[d] * corr);
      }
      m = mn;
    }
  }
  if (row < T) {
    const float denom = MODE == NOSM ? 1.f : fmaxf(l, 1e-30f);
    if (MODE != STATS) {
#pragma unroll
      for (int d = 0; d < D; ++d) o[base + (size_t)row * rs + d] = acc[d] / denom;
    }
    if (MODE != NOSM && lse != nullptr)
      lse[((size_t)b * H + h) * T + row] = m + log2f(denom);
  }
}

// ------------------------------------------------------------------ host

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// One launch of the forward; q/k/v/o are bf16 (is_bf16) or f32.
template <int D, int MODE, int HPB>
inline int launch_fwd(const void* q, const void* k, const void* v, const void* kv_lens,
                      void* o, float* lse, int B, int T, int H, Layout lay, float scale,
                      int use_exp2, int is_bf16, cudaStream_t st) {
  cudaError_t err;
  if (is_bf16) {
    auto kern = attn_fwd_bf16<D, MODE, HPB>;
    const size_t smem = (size_t)HPB * FwdSmem<D>::BYTES;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return (int)err;
    dim3 grid((T + BM - 1) / BM, H / HPB, B);
    kern<<<grid, NT * HPB, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_lens),
        static_cast<__nv_bfloat16*>(o), lse, T, H, lay, scale, use_exp2);
  } else {
    auto kern = attn_fwd_f32<D, MODE, HPB>;
    const size_t smem = (size_t)HPB * 2 * F32_KEYS * D * sizeof(float);
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return (int)err;
    dim3 grid((T + F32_ROWS - 1) / F32_ROWS, H / HPB, B);
    kern<<<grid, F32_ROWS * HPB, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(kv_lens),
        static_cast<float*>(o), lse, T, H, lay, scale, use_exp2);
  }
  return (int)cudaGetLastError();
}

// Calls fn(std::integral_constant<int, D>) for a supported head width.
template <int... Ds, typename Fn>
inline int with_head_dim(int D, Fn fn) {
  int rc = (int)cudaErrorInvalidValue;
  (void)((D == Ds ? (rc = fn(std::integral_constant<int, Ds>{}), true) : false) || ...);
  return rc;
}

}  // namespace attn
}  // namespace oron
