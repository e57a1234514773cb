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
// The caller passes the score scale of the true head width (1/sqrt(D) before
// any zero padding of D) and whether the softmax is exp2 of s*scale*log2(e)
// or exp of s*scale (the TPU kernel's use_exp2=False): the value is the same,
// and the bf16 body computes both as exp2.
//
// Modes: SOFTMAX writes the output (and lse2 = m + log2(max(l, 1e-30)) when
// given a pointer); STATS writes only lse2 (the f32 classic backward's
// recomputed statistics; the bf16 backward sweeps them inside its own pass A,
// flash_bwd.cuh); NOSM is the bench's split, (q.k in f32) / T cast to the
// input type, times V, no mask, no max, no sum.
//
// Design (bf16). A block is two warpgroups; each owns 64 of the block's 128
// query rows of one head, so every K/V tile in shared memory feeds 128 rows
// (one warpgroup a block on 64 rows, or a head pair's two warpgroups each
// with its own tiles, the packed kernel's former design, measured 1.7x
// slower on this body).
// Both products are wgmma (wgmma.cuh): S = Q K^T is m64n64k16 with Q and K
// from shared memory, K-major; O += P V takes P from registers (the S
// accumulator, exponentiated and rounded to bf16 in place) and V as an
// MN-major operand through the transpose bit, so no transposed copy of V is
// ever written. Tiles of 64 keys arrive through a ring of cp.async copies:
// two K stages and three V stages, since tile j's V is read one iteration
// after its K. One barrier a tile; past it the copy of tile j + 1 is issued
// before tile j's products, so it lands while they run. Within a warpgroup the
// products are pipelined as in FlashAttention-3: iteration j issues S_j and
// then O += P_{j-1} V_{j-1}, waits for S_j alone (wgmma.wait_group 1) and runs
// tile j's softmax (ex2.approx) while the PV product is still on the tensor
// cores; O is rescaled once that product is done. Tiles past kv_len are not
// loaded at all; only the last one masks keys.
//
// cp.async and not TMA: no tensor maps to build on the host per call (the
// lanes layout would need one per head width and stride), no mbarriers, and a
// copy that lands zeros past T or past D (src-size 0) is one instruction.
// With one block's two warpgroups issuing their own copies between products
// a producer warp would have little to hide; it is the next step for speed.
//
// Widths: columns from dh (a multiple of 8) to DP (the next multiple of 16,
// the wgmma depth) land as zeros and are never stored. DP runs to 256: S is
// one m64n64 accumulator (32 registers a thread) and O one m64nDP (DP / 2),
// 128 at DP = 256; beyond 128 columns the PV product is two wgmma of N <= 128.
// Shared memory is 2 * (128 + 5 * 64) * DP bytes: 229,376 at DP = 256 (the
// limit is 232,448). Up to DP = 64 two blocks share an SM (128 registers a
// thread), so the synthesis shape's 224 blocks fit in one wave of 264.
// Wider heads take the wide body below (attn_fwd_wide): D cut into chunks for
// S and into parts of 128 output columns, one part a block.
//
// The TPU kernels hold a whole key row in VMEM and run a two-pass softmax; a
// thread block cannot hold that, so keys stream with the online softmax
// (running max m, running sum l, rescaled accumulator). The TPU packed kernel
// packs a head pair into one [2T, 2D] block-diagonal product with zero halves
// to fill its 128-lane matrix unit; here one head's K/V tile is shared by 128
// query rows instead, and the packed launch covers both heads of every pair.
//
// f32 inputs take a SIMT body in true f32 at every width, one query row a
// thread and 64 output columns a block (the reference path of the checks;
// not tuned).
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace oron {
namespace attn {

enum Mode { SOFTMAX = 0, STATS = 1, NOSM = 2 };

constexpr float LOG2E = 1.4426950408889634f;

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

// ------------------------------------------- helpers shared with the backward

constexpr int BLOCK_ROWS = 128;     // rows a block owns: two warpgroups x 64
constexpr int BLOCK_THREADS = 256;
constexpr int KV_TILE = 64;         // keys (or queries) of one streamed tile

// exp2 on the special-function unit (ex2.approx, relative error ~2^-22, far
// below the bf16 rounding of p); exp2f's range handling costs ~9% here
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + R) x columns [0, DP) of one head into a core-matrix
// tile (wgmma.cuh), asynchronously; rows at or past T and columns at or past
// dh land as zeros. Eight consecutive threads copy the eight rows of one
// core matrix; a warp reads 8 rows x 64 bytes.
template <int R, int DP>
__device__ __forceinline__ void load_core_tile(__nv_bfloat16* dst,
                                               const __nv_bfloat16* __restrict__ src,
                                               size_t base, int row0, int T, int dh, int rs,
                                               int tid) {
  constexpr int CB = DP / 8;
  for (int idx = tid; idx < R * CB; idx += BLOCK_THREADS) {
    const int r = (idx & 7) | ((idx / (8 * CB)) << 3);
    const int c = ((idx >> 3) % CB) * 8;
    const bool ok = row0 + r < T && c < dh;
    const __nv_bfloat16* from = ok ? src + base + (size_t)(row0 + r) * rs + c : src;
    wg::cp_async16(dst + wg::core_offset<R>(r, c), from, ok ? 16 : 0);
  }
}

// K-major operand: the tile's rows along M or N (from row0, a multiple of
// 8), its columns along K; k-step kk
template <int R>
__device__ __forceinline__ uint64_t desc_k(const __nv_bfloat16* tile, int row0, int kk) {
  constexpr uint32_t COL = wg::Core<R>::COL_GROUP;
  return wg::desc(wg::smem_addr(tile) + (row0 >> 3) * wg::Core<R>::ROW_GROUP + kk * 2 * COL,
                  COL, wg::Core<R>::ROW_GROUP);
}

// MN-major operand (transpose bit): the tile's rows along K, its columns
// along N; k-step kk takes rows 16kk .. 16kk + 15
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const __nv_bfloat16* tile, int kk) {
  return wg::desc(wg::smem_addr(tile) + kk * 2 * wg::Core<R>::ROW_GROUP,
                  wg::Core<R>::ROW_GROUP, wg::Core<R>::COL_GROUP);
}

// k-step kk of an accumulator as a bf16 A fragment (columns 16kk .. 16kk+15)
__device__ __forceinline__ void acc_to_a(const float* x, int kk, uint32_t* a) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// D[64 x DP] += A[64 x 16] B[16 x DP], A from registers, B the rows 16kk ..
// 16kk + 15 of an MN-major tile of R rows; DP > 128 as two products
template <int R, int DP>
__device__ __forceinline__ void wgmma_rs_wide(float* d, const uint32_t* a,
                                              const __nv_bfloat16* tile, int kk) {
  if constexpr (DP <= 128) {
    wg::wgmma_rs_t<DP>(d, a, desc_mn<R>(tile, kk));
  } else {
    wg::wgmma_rs_t<128>(d, a, desc_mn<R>(tile, kk));
    wg::wgmma_rs_t<DP - 128>(d + 64, a, desc_mn<R>(tile + 16 * R * 8, kk));
  }
}

// this thread's rows (row, row + 8) of an m64nDP accumulator, columns < dh,
// each row divided by its own denominator
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst, size_t base,
                                           int row, int T, int dh, int rs, const float* acc,
                                           int t4, float den0 = 1.f, float den1 = 1.f) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col >= dh) continue;
    if (row < T)
      *reinterpret_cast<uint32_t*>(dst + base + (size_t)row * rs + col) =
          pack_bf16(acc[4 * j] / den0, acc[4 * j + 1] / den0);
    if (row + 8 < T)
      *reinterpret_cast<uint32_t*>(dst + base + (size_t)(row + 8) * rs + col) =
          pack_bf16(acc[4 * j + 2] / den1, acc[4 * j + 3] / den1);
  }
}

// S_j, this thread's fragment of an m64n64 score tile (rows r0 and r0 + 8,
// keys j * 64 + 8i + 2 * t4 + e), in place to its softmax weights (or, NOSM,
// to S_j / T); updates the running max m and sum l of the two rows and gives
// the factor a that rescales O. Only the last tile masks keys.
template <int MODE>
__device__ __forceinline__ void tile_softmax(float* s, int j, int limit, float s_scale, int t4,
                                             float* m_i, float* l_i, float* a) {
  if (MODE == NOSM) {
#pragma unroll
    for (int i = 0; i < KV_TILE / 2; ++i) s[i] *= s_scale;
    return;
  }
  const int k0 = j * KV_TILE;
  const bool ragged = k0 + KV_TILE > limit;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < KV_TILE / 2; ++i) {
    const bool keep = !ragged || k0 + (i >> 2) * 8 + t4 * 2 + (i & 1) < limit;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], keep ? s[i] : -INFINITY);
  }
  float nm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // the tile holds a kept key, so the max is finite; the scale is >= 0
    const float m_new = fmaxf(m_i[r], mx[r] * s_scale);
    a[r] = exp2_approx(m_i[r] - m_new);  // 0 on the first tile
    m_i[r] = m_new;
    nm[r] = -m_new;
    l_i[r] *= a[r];
  }
#pragma unroll
  for (int i = 0; i < KV_TILE / 2; ++i) {
    const int r = (i >> 1) & 1;
    float e = exp2_approx(fmaf(s[i], s_scale, nm[r]));
    // -inf * 0 would be NaN where the scale is 0 (kv_len <= 0 rows)
    if (ragged && k0 + (i >> 2) * 8 + t4 * 2 + (i & 1) >= limit) e = 0.f;
    s[i] = e;
    l_i[r] += e;
  }
}

// ------------------------------------------------------- bf16 (wgmma)

template <int DP>
struct FwdSmem {  // Q: two tiles [64][DP]; K_STAGES x K, V_STAGES x V [64][DP]
  static constexpr int KV = KV_TILE * DP;
  // tile j's K is read in iteration j, its V in j + 1, tile j + 1 lands
  static constexpr int K_STAGES = 2, V_STAGES = 3;
  static constexpr size_t BYTES = (size_t)(BLOCK_ROWS * DP + (K_STAGES + V_STAGES) * KV) * 2;
  static constexpr int MIN_BLOCKS = DP > 64 ? 1 : 2;  // blocks an SM: registers
};

// Grid (ceil(T / 128), H, B); lse is [B, H, T] f32 or null.
// scale_log2 is the score scale in base-2 units (1/T for NOSM).
template <int DP, int MODE>
__global__ void __launch_bounds__(BLOCK_THREADS, FwdSmem<DP>::MIN_BLOCKS)
attn_fwd_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int T, int dh,
               Layout lay, float scale_log2) {
  static_assert(MODE == SOFTMAX || MODE == NOSM, "bf16 STATS is not built");
  using S = FwdSmem<DP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // warpgroup w's at w * 64 * DP
  __nv_bfloat16* ring = Qs + BLOCK_ROWS * DP;  // K stages, then V stages

  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BLOCK_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, rs = lay.row_stride;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  int limit;
  float s_scale;
  if (MODE == NOSM) {
    limit = T;
    s_scale = scale_log2;  // 1 / T
  } else {
    key_limit(kv_lens[b], T, scale_log2, limit, s_scale);
  }
  const int r0 = 64 * wgi + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const int n_tiles = (limit + KV_TILE - 1) / KV_TILE;

  auto issue = [&](int j) {  // tile j's K and V, one cp.async group
    load_core_tile<KV_TILE, DP>(ring + (j % S::K_STAGES) * S::KV, k, base, j * KV_TILE, T, dh,
                                rs, tid);
    load_core_tile<KV_TILE, DP>(ring + (S::K_STAGES + j % S::V_STAGES) * S::KV, v, base,
                                j * KV_TILE, T, dh, rs, tid);
    wg::cp_commit();
  };
#pragma unroll
  for (int w = 0; w < 2; ++w)
    load_core_tile<64, DP>(Qs + w * 64 * DP, q, base, q0 + 64 * w, T, dh, rs, tid);
  issue(0);  // in Q's group

  float oacc[DP / 2], s[KV_TILE / 2];
  uint32_t p[KV_TILE / 4];  // P of the previous tile as bf16 A fragments, 4 k-steps
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};

  // Ring step j: tile j (and Q) landed for every thread, which is also past
  // its reads of tile j - 1's K and j - 2's V; then tile j + 1's copy starts,
  // into those stages.
  auto next_tile = [&](int j) {
    wg::cp_wait<0>();
    wg::fence_async_proxy();
    __syncthreads();
    if (j + 1 < n_tiles) issue(j + 1);
  };
  auto scores = [&](int j) {  // S_j = Q K_j^T, issued
    const __nv_bfloat16* Kt = ring + (j % S::K_STAGES) * S::KV;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wg::wgmma_ss<KV_TILE>(s, desc_k<64>(Qs + wgi * 64 * DP, 0, kk), desc_k<KV_TILE>(Kt, 0, kk),
                            kk > 0);
    wg::commit();
  };
  auto pv = [&](int j) {  // O += P_j V_j, issued
    const __nv_bfloat16* Vt = ring + (S::K_STAGES + j % S::V_STAGES) * S::KV;
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk) wgmma_rs_wide<KV_TILE, DP>(oacc, p + 4 * kk, Vt, kk);
    wg::commit();
  };
  float alpha[2] = {1.f, 1.f};
  next_tile(0);  // tile 0: S and its weights; O is still 0
  wg::fence();
  scores(0);
  wg::wait<0>();
  wg::fence_regs<KV_TILE / 2>(s);
  tile_softmax<MODE>(s, 0, limit, s_scale, t4, m_i, l_i, alpha);
#pragma unroll
  for (int kk = 0; kk < KV_TILE / 16; ++kk) acc_to_a(s, kk, p + 4 * kk);
  // no branch around a wgmma below: ptxas would serialise them all
  for (int j = 1; j < n_tiles; ++j) {
    next_tile(j);
    wg::fence();
    scores(j);
    pv(j - 1);
    wg::wait<1>();  // S_j alone: O += P_{j-1} V_{j-1} runs on under the softmax
    wg::fence_regs<KV_TILE / 2>(s);
    tile_softmax<MODE>(s, j, limit, s_scale, t4, m_i, l_i, alpha);
    wg::wait<0>();
    wg::fence_regs<DP / 2>(oacc);
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk) acc_to_a(s, kk, p + 4 * kk);
    if (MODE != NOSM) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    }
  }
  wg::fence();
  pv(n_tiles - 1);
  wg::wait<0>();
  wg::fence_regs<DP / 2>(oacc);

  float den[2] = {1.f, 1.f};
  if (MODE != NOSM) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = l_i[r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      den[r] = fmaxf(x, 1e-30f);
    }
    if (lse != nullptr && t4 == 0) {
      float* lse_row = lse + ((size_t)b * H + h) * T;
      if (q0 + r0 < T) lse_row[q0 + r0] = m_i[0] + log2f(den[0]);
      if (q0 + r0 + 8 < T) lse_row[q0 + r0 + 8] = m_i[1] + log2f(den[1]);
    }
  }
  store_rows<DP>(o, base, q0 + r0, T, dh, rs, oacc, t4, den[0], den[1]);
}

// ------------------------------------------------------------ f32 (SIMT)
//
// f32 at every head width (the reference path of the checks, not tuned):
// one query row a thread and one part of F32_PART output columns a block;
// q.k is summed in column order over chunks of F32_CHUNK columns staged in
// shared memory, so shared memory and registers do not grow with D.

constexpr int F32_ROWS = 64;   // query rows (threads) per block
constexpr int F32_KEYS = 32;   // keys per shared-memory tile
constexpr int F32_CHUNK = 32;  // columns of Q and K a chunk stages
constexpr int F32_PART = 64;   // output columns a block owns

__host__ __device__ inline int f32_parts(int dh) { return (dh + F32_PART - 1) / F32_PART; }

// Grid (ceil(T / 64) * parts, H, B); STATS runs one part (no output).
template <int MODE>
__global__ void __launch_bounds__(F32_ROWS)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ kv_lens,
             float* __restrict__ o, float* __restrict__ lse, int T, int dh, Layout lay,
             float scale, int use_exp2) {
  __shared__ float Ks[F32_KEYS][F32_CHUNK];
  __shared__ float Qs[F32_ROWS][F32_CHUNK + 1];
  __shared__ float Vs[F32_KEYS][F32_PART];
  const int tid = threadIdx.x;
  const int parts = MODE == STATS ? 1 : f32_parts(dh);
  const int part = blockIdx.x % parts, col0 = part * F32_PART;
  const int q0 = blockIdx.x / parts * F32_ROWS, row = q0 + tid;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y, rs = lay.row_stride;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const bool ex2 = MODE == STATS ? true : use_exp2 != 0;
  int limit;
  float s_scale;
  if (MODE == NOSM) {
    limit = T;
    s_scale = scale;
  } else {
    key_limit(kv_lens[b], T, scale, limit, s_scale);
  }

  float acc[F32_PART];
#pragma unroll
  for (int d = 0; d < F32_PART; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < limit; k0 += F32_KEYS) {
    float dot[F32_KEYS];
#pragma unroll
    for (int j = 0; j < F32_KEYS; ++j) dot[j] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += F32_CHUNK) {
      __syncthreads();
      for (int idx = tid; idx < F32_KEYS * F32_CHUNK; idx += F32_ROWS) {
        const int r = idx / F32_CHUNK, c = idx % F32_CHUNK;
        const bool ok = k0 + r < T && c0 + c < dh;
        Ks[r][c] = ok ? k[base + (size_t)(k0 + r) * rs + c0 + c] : 0.f;
      }
      for (int idx = tid; idx < F32_ROWS * F32_CHUNK; idx += F32_ROWS) {
        const int r = idx / F32_CHUNK, c = idx % F32_CHUNK;
        const bool ok = q0 + r < T && c0 + c < dh;
        Qs[r][c] = ok ? q[base + (size_t)(q0 + r) * rs + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < F32_CHUNK; ++c) {
        const float qv = Qs[tid][c];
#pragma unroll
        for (int j = 0; j < F32_KEYS; ++j) dot[j] = fmaf(qv, Ks[j][c], dot[j]);
      }
    }
    if (MODE != STATS) {
      __syncthreads();
      for (int idx = tid; idx < F32_KEYS * F32_PART; idx += F32_ROWS) {
        const int r = idx / F32_PART, c = idx % F32_PART;
        const bool ok = k0 + r < T && col0 + c < dh;
        Vs[r][c] = ok ? v[base + (size_t)(k0 + r) * rs + col0 + c] : 0.f;
      }
      __syncthreads();
    }
    const int n = min(F32_KEYS, limit - k0);
#pragma unroll
    for (int j = 0; j < F32_KEYS; ++j) {
      if (j >= n) break;
      if (MODE == NOSM) {
        const float p = dot[j] * s_scale;
#pragma unroll
        for (int d = 0; d < F32_PART; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d]);
        continue;
      }
      const float sv = dot[j] * s_scale;
      const float mn = fmaxf(m, sv);
      const float corr = ex2 ? exp2f(m - mn) : expf(m - mn);
      const float p = ex2 ? exp2f(sv - mn) : expf(sv - mn);
      l = l * corr + p;
      if (MODE != STATS) {
#pragma unroll
        for (int d = 0; d < F32_PART; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d] * corr);
      }
      m = mn;
    }
  }
  if (row < T) {
    const float denom = MODE == NOSM ? 1.f : fmaxf(l, 1e-30f);
    if (MODE != STATS) {
#pragma unroll
      for (int d = 0; d < F32_PART; ++d)
        if (col0 + d < dh) o[base + (size_t)row * rs + col0 + d] = acc[d] / denom;
    }
    if (MODE != NOSM && lse != nullptr && part == 0)
      lse[((size_t)b * H + h) * T + row] = m + log2f(denom);
  }
}

// ------------------------------------------ head widths above 256 (wide)
//
// Above 256 columns neither Q [128][DP] in shared memory nor an m64nDP
// accumulator fits, so the wide bodies cut D twice: the products over D
// (S = Q K^T here; dP = dO V^T in the backward) run over column chunks of
// WIDE_CHUNK staged one at a time, and a block owns one part of WIDE_PART
// output columns (of O here; of dQ, or of dK and dV, in the backward), the
// grid's x dimension holding (row tile, part) with the part fastest. Every
// part recomputes S over the full width, which costs ceil(D / 128) times the
// score products; shared memory and registers do not grow with D, so one
// instance serves every width (bf16 widths to 256 keep attn_fwd_wgmma).
// Columns past dh land as zeros (cp.async's source size) and are never
// stored. Each step of the ring is one unit: a chunk of the score product,
// or the part of V for the PV product; copies run two units ahead.

constexpr int WIDE_CHUNK = 64;   // columns of Q and K a ring unit stages
constexpr int WIDE_PART = 128;   // output columns a block owns
constexpr int WIDE_SLOTS = 3;    // ring slots: a unit in use, two in flight

__host__ __device__ inline int wide_parts(int dh) { return (dh + WIDE_PART - 1) / WIDE_PART; }

// issue(u) copies unit u into slot u % WIDE_SLOTS and commits one cp.async
// group; past the last unit an empty group keeps the count.
template <typename Issue>
__device__ __forceinline__ void wide_issue(int u, int n_units, Issue&& issue) {
  if (u < n_units) {
    issue(u);
  } else {
    wg::cp_commit();
  }
}

// The ring's first copies, units 0 .. WIDE_SLOTS - 2.
template <typename Issue>
__device__ __forceinline__ void wide_start(int n_units, Issue&& issue) {
#pragma unroll
  for (int u = 0; u < WIDE_SLOTS - 1; ++u) wide_issue(u, n_units, issue);
}

// Unit u has landed for every thread, which is also past its reads (and its
// products' reads) of unit u - 1; then unit u + WIDE_SLOTS - 1's copy starts,
// into that unit's slot.
template <typename Issue>
__device__ __forceinline__ void wide_step(int u, int n_units, Issue&& issue) {
  wg::cp_wait<WIDE_SLOTS - 2>();
  wg::fence_async_proxy();
  __syncthreads();
  wide_issue(u + WIDE_SLOTS - 1, n_units, issue);
}

struct FwdWide {  // a slot: Q [128][CHUNK] and K [64][CHUNK], or V [64][PART]
  static constexpr int SLOT = (BLOCK_ROWS + KV_TILE) * WIDE_CHUNK;
  static constexpr size_t BYTES = (size_t)WIDE_SLOTS * SLOT * 2;
};
static_assert(KV_TILE * WIDE_PART <= FwdWide::SLOT, "a V part fits a slot");

// Grid (ceil(T / 128) * wide_parts(dh), H, B); as attn_fwd_wgmma otherwise.
template <int MODE>
__global__ void __launch_bounds__(BLOCK_THREADS)
attn_fwd_wide(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int T, int dh,
              Layout lay, float scale_log2) {
  static_assert(MODE == SOFTMAX || MODE == NOSM, "bf16 STATS is not built");
  constexpr int CH = WIDE_CHUNK, NP = WIDE_PART;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int parts = wide_parts(dh), part = blockIdx.x % parts, col0 = part * NP;
  const int q0 = blockIdx.x / parts * BLOCK_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, rs = lay.row_stride;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  int limit;
  float s_scale;
  if (MODE == NOSM) {
    limit = T;
    s_scale = scale_log2;  // 1 / T
  } else {
    key_limit(kv_lens[b], T, scale_log2, limit, s_scale);
  }
  const int r0 = 64 * wgi + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const int n_tiles = (limit + KV_TILE - 1) / KV_TILE;
  const int nch = (dh + CH - 1) / CH, per_tile = nch + 1, n_units = n_tiles * per_tile;

  auto issue = [&](int u) {  // tile j's chunk c of Q and K, or (c = nch) its V part
    __nv_bfloat16* slot = ring + (u % WIDE_SLOTS) * FwdWide::SLOT;
    const int j = u / per_tile, c = u % per_tile;
    if (c < nch) {
      load_core_tile<BLOCK_ROWS, CH>(slot, q, base + c * CH, q0, T, dh - c * CH, rs, tid);
      load_core_tile<KV_TILE, CH>(slot + BLOCK_ROWS * CH, k, base + c * CH, j * KV_TILE, T,
                                  dh - c * CH, rs, tid);
    } else {
      load_core_tile<KV_TILE, NP>(slot, v, base + col0, j * KV_TILE, T, dh - col0, rs, tid);
    }
    wg::cp_commit();
  };

  float oacc[NP / 2], s[KV_TILE / 2];
  uint32_t p[KV_TILE / 4];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KV_TILE / 2; ++i) s[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};

  wide_start(n_units, issue);
  int u = 0;
  for (int j = 0; j < n_tiles; ++j) {
    for (int c = 0; c < nch; ++c, ++u) {  // S_j = Q K_j^T, chunk by chunk
      wide_step(u, n_units, issue);
      const __nv_bfloat16* Qc = ring + (u % WIDE_SLOTS) * FwdWide::SLOT;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        wg::wgmma_ss<KV_TILE>(s, desc_k<BLOCK_ROWS>(Qc, 64 * wgi, kk),
                              desc_k<KV_TILE>(Qc + BLOCK_ROWS * CH, 0, kk), c > 0 || kk > 0);
      wg::commit();
      wg::wait<0>();
    }
    wg::fence_regs<KV_TILE / 2>(s);
    tile_softmax<MODE>(s, j, limit, s_scale, t4, m_i, l_i, alpha);
    if (MODE != NOSM) {
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk) acc_to_a(s, kk, p + 4 * kk);
    wide_step(u, n_units, issue);  // O += P_j V_j, the block's columns
    const __nv_bfloat16* Vt = ring + (u % WIDE_SLOTS) * FwdWide::SLOT;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk)
      wg::wgmma_rs_t<NP>(oacc, p + 4 * kk, desc_mn<KV_TILE>(Vt, kk));
    wg::commit();
    wg::wait<0>();
    wg::fence_regs<NP / 2>(oacc);
    ++u;
  }

  float den[2] = {1.f, 1.f};
  if (MODE != NOSM) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = l_i[r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      den[r] = fmaxf(x, 1e-30f);
    }
    if (lse != nullptr && part == 0 && t4 == 0) {
      float* lse_row = lse + ((size_t)b * H + h) * T;
      if (q0 + r0 < T) lse_row[q0 + r0] = m_i[0] + log2f(den[0]);
      if (q0 + r0 + 8 < T) lse_row[q0 + r0 + 8] = m_i[1] + log2f(den[1]);
    }
  }
  store_rows<NP>(o, base + col0, q0 + r0, T, dh - col0, rs, oacc, t4, den[0], den[1]);
}

// ------------------------------------------------------------------ host

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// One launch of the bf16 forward at padded width D (SOFTMAX or NOSM). scale
// is the score scale of the true head width (1/T for NOSM); the body takes
// s * scale * log2(e) through exp2 whether the caller asked for exp2 or exp,
// the same softmax.
template <int D, int MODE>
inline int launch_fwd(const void* q, const void* k, const void* v, const void* kv_lens,
                      void* o, float* lse, int B, int T, int H, int dh, Layout lay,
                      float scale, cudaStream_t st) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  auto kern = attn_fwd_wgmma<D, MODE>;
  const size_t smem = FwdSmem<D>::BYTES;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BLOCK_ROWS - 1) / BLOCK_ROWS, H, B);
  kern<<<grid, BLOCK_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(o), lse, T, dh, lay, MODE == NOSM ? scale : LOG2E * scale);
  return (int)cudaGetLastError();
}

// One launch of the f32 forward at any head width dh (a multiple of 8);
// use_exp2 picks exp2 of s * scale * log2(e) or exp of s * scale. STATS
// (use_exp2 set) writes lse2 alone and runs one part.
template <int MODE>
inline int launch_fwd_f32(const float* q, const float* k, const float* v, const void* kv_lens,
                          float* o, float* lse, int B, int T, int H, int dh, Layout lay,
                          float scale, int use_exp2, cudaStream_t st) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (dh < 8 || dh % 8) return (int)cudaErrorInvalidValue;
  const float scale_exp2 = MODE == NOSM ? scale : LOG2E * scale;
  const int parts = MODE == STATS ? 1 : f32_parts(dh);
  dim3 grid((T + F32_ROWS - 1) / F32_ROWS * parts, H, B);
  attn_fwd_f32<MODE><<<grid, F32_ROWS, 0, st>>>(q, k, v, static_cast<const int*>(kv_lens), o,
                                                lse, T, dh, lay,
                                                use_exp2 ? scale_exp2 : scale, use_exp2);
  return (int)cudaGetLastError();
}

// Blocks of the bf16 SOFTMAX forward an SM holds at padded width DP
template <int DP>
inline int fwd_blocks_per_sm() {
  auto kern = attn_fwd_wgmma<DP, SOFTMAX>;
  cudaError_t err = allow_smem(kern, FwdSmem<DP>::BYTES);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, BLOCK_THREADS,
                                                      FwdSmem<DP>::BYTES);
  return err == cudaSuccess ? n : -(int)err;
}

// the widest head of the template instances; wider ones take the wide body
constexpr int FWD_MAX_DH = 256;

// Calls fn(std::integral_constant<int, DP>) with DP the head width dh
// rounded up to a multiple of 16 (the wgmma depth); dh must be a multiple of
// 8 (16-byte rows, which the wrappers pad to) from 8 to MAX_DP (128, or 256
// for the forwards). Columns from dh to DP are zeros in shared memory and are
// never stored.
template <int MAX_DP = 128, typename Fn>
inline int with_padded_dim(int dh, Fn fn) {
  if (dh < 8 || dh > MAX_DP || dh % 8) return (int)cudaErrorInvalidValue;
  switch ((dh + 15) / 16) {
    case 1: return fn(std::integral_constant<int, 16>{});
    case 2: return fn(std::integral_constant<int, 32>{});
    case 3: return fn(std::integral_constant<int, 48>{});
    case 4: return fn(std::integral_constant<int, 64>{});
    case 5: return fn(std::integral_constant<int, 80>{});
    case 6: return fn(std::integral_constant<int, 96>{});
    case 7: return fn(std::integral_constant<int, 112>{});
    case 8: return fn(std::integral_constant<int, 128>{});
    default: break;
  }
  if constexpr (MAX_DP > 128) {
    switch ((dh + 15) / 16) {
      case 9: return fn(std::integral_constant<int, 144>{});
      case 10: return fn(std::integral_constant<int, 160>{});
      case 11: return fn(std::integral_constant<int, 176>{});
      case 12: return fn(std::integral_constant<int, 192>{});
      case 13: return fn(std::integral_constant<int, 208>{});
      case 14: return fn(std::integral_constant<int, 224>{});
      case 15: return fn(std::integral_constant<int, 240>{});
      default: return fn(std::integral_constant<int, 256>{});
    }
  }
  return (int)cudaErrorInvalidValue;
}

// One launch of the bf16 wide forward (dh above 256, a multiple of 8);
// arguments as launch_fwd's.
template <int MODE>
inline int launch_fwd_wide(const void* q, const void* k, const void* v, const void* kv_lens,
                           void* o, float* lse, int B, int T, int H, int dh, Layout lay,
                           float scale, cudaStream_t st) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (dh % 8) return (int)cudaErrorInvalidValue;
  auto kern = attn_fwd_wide<MODE>;
  cudaError_t err = allow_smem(kern, FwdWide::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BLOCK_ROWS - 1) / BLOCK_ROWS * wide_parts(dh), H, B);
  kern<<<grid, BLOCK_THREADS, FwdWide::BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(o), lse, T, dh, lay, MODE == NOSM ? scale : LOG2E * scale);
  return (int)cudaGetLastError();
}

// One forward launch at any head width dh (a multiple of 8): f32 takes its
// SIMT body; bf16 the template instance of the padded width up to
// FWD_MAX_DH, the wide body above it. q/k/v/o are bf16 (is_bf16) or f32.
template <int MODE>
inline int launch_fwd_any(const void* q, const void* k, const void* v, const void* kv_lens,
                          void* o, float* lse, int B, int T, int H, int dh, Layout lay,
                          float scale, int use_exp2, int is_bf16, cudaStream_t st) {
  if (!is_bf16)
    return launch_fwd_f32<MODE>(static_cast<const float*>(q), static_cast<const float*>(k),
                                static_cast<const float*>(v), kv_lens, static_cast<float*>(o),
                                lse, B, T, H, dh, lay, scale, use_exp2, st);
  if (dh > FWD_MAX_DH)
    return launch_fwd_wide<MODE>(q, k, v, kv_lens, o, lse, B, T, H, dh, lay, scale, st);
  return with_padded_dim<FWD_MAX_DH>(dh, [&](auto d) {
    return launch_fwd<decltype(d)::value, MODE>(q, k, v, kv_lens, o, lse, B, T, H, dh, lay,
                                                scale, st);
  });
}

}  // namespace attn
}  // namespace oron
