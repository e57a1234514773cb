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
// backward (CLASSIC) gives it what the TPU's -1e30 mask gives, equal weights
// over all T keys (p = 1/T, lse2 = log2 T) and the gradients that follow.
//
// Design (bf16). The TPU kernels run one program per (batch row, head or lane
// tile) that walks the query blocks in order and carries dK/dV for the whole
// sequence in VMEM. Thread blocks run in no order and hold far less, so the
// work is cut twice, S and dP recomputed in each cut, and nothing is summed
// across blocks: no atomics, and two calls give the same bits. Two launches:
//   A. bwd_dq_wgmma, one block per (128 queries, head, batch row): delta for
//      its rows (written to [B, H, T] for pass B); for the classic kernel a
//      sweep of S alone over the keys below kv_len that writes lse2 (the
//      forward's statistics, which the TPU kernel recomputes too); then S, dP,
//      dS and dQ += dS K over the key tiles below kv_len.
//   B. bwd_dkdv_wgmma, one block per (128 keys, head, batch row), after A on
//      the same stream: over all query tiles, S^T, dP^T, P^T, dS^T, then
//      dV += P^T dO and dK += dS^T Q. Key tiles at or past kv_len write zeros.
// Tensor work: the five products the math needs plus S and dP again, and the
// classic sweep's S: 7 and 8 products' worth for the lanes and classic kernels.
//
// A block is two warpgroups, each owning 64 of the block's 128 rows. Every
// product is wgmma m64nNk16 (wgmma.cuh). Its B operand, and the A operand of
// the first two products, come from shared memory in the canonical layout
// without swizzle; the tiles that are read the other way round (K in dQ += dS
// K, Q and dO in pass B's updates) are the same bytes read MN-major through
// the transpose bit, so no transposed copy exists. P^T and dS (dS^T) are the
// A operand of the next product straight from the S and dP accumulators,
// rounded to bf16 in registers (as FlashAttention-3 does). The resident rows
// (Q and dO in A, K and V in B) are copied once; the streamed tiles (K and V
// in A; Q, dO, lse2 and delta in B) arrive through a two-stage ring of
// cp.async copies, so the next tile's copy overlaps this tile's products.
// cp.async and not TMA: it needs no tensor maps (built per call on the host
// through the driver API) and no mbarriers, and a copy that lands zeros past
// T or past D (src-size 0) is one instruction; a producer warp with TMA is
// what a later PR would add. The swizzle-free layout takes every head width
// that is a multiple of 8 with one code path: columns from D up to the next
// multiple of 16 (the wgmma depth) are copied as zeros and never stored.
// Widths: to 128 for both kernels; the classic one goes on to 256 with a wide
// variant of the same code (BwdTile): pass A on 32-key tiles, pass B with
// dK and dV cut into two column halves, one block each; above 256 with the
// chunked bodies bwd_dq_wide and bwd_dkdv_wide (any width). The lanes kernel
// stops at 128, the widest head the lanes rule (models/layers.py) admits.
//
// Bound: 10*T*kv*D flops per head (five products) over ~16*T*D bytes, far
// above 295 flops per byte on the H100, so the tensor cores.
//
// f32 inputs take SIMT kernels in true f32 at every width (the reference
// path of the checks): a delta launch, for the classic kernel the forward in
// STATS mode, one query row (dq) or key row (dkdv) per thread and 64 output
// columns a block.
#pragma once

#include "flash_fwd.cuh"

namespace oron {
namespace attn {

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

// ------------------------------------------------------- bf16 (wgmma)

constexpr int BWD_ROWS = BLOCK_ROWS;     // rows a block owns: two warpgroups x 64
constexpr int BWD_THREADS = BLOCK_THREADS;

// Pass B's queries a stage, and the blocks an SM holds. Up to DP = 64 two
// blocks share an SM (128 registers a thread), which hides one block's
// softmax behind the other's products: pass B then takes 32 queries a stage
// (its dK, dV, S^T and dP^T accumulators must fit), except at DP = 16 and 32.
// Above DP = 128 (the wide variant, classic kernel only) two limits bind:
//   pass A's Q and dO [128][DP] and two stages of K and V [64][DP] would ask
//   for 2 * (2*128 + 4*64) * DP bytes, 262,144 at DP = 256 of the 232,448 a
//   block may have, so its key tiles shrink to KT = 32 keys (197,632 bytes);
//   pass B's dK and dV accumulators, m64nDP f32 each, would need DP
//   registers a thread (256 at DP = 256, of 255), so each block owns one of
//   SPLIT = 2 column halves of dK and dV: the grid's key dimension doubles,
//   each half recomputes S^T and dP^T over the full width (six products'
//   worth of pass B instead of four) and keeps two m64n(DP/2) accumulators.
template <int DP>
struct BwdTile {
  static constexpr int BQ = DP > 32 ? 32 : 64;
  static constexpr int MIN_BLOCKS = DP > 64 ? 1 : 2;
  static constexpr int KT = DP > 128 ? 32 : KV_TILE;  // pass A's keys a tile
  static constexpr int SPLIT = DP > 128 ? 2 : 1;       // pass B's column halves
};

// n values of a [B, H, T] f32 row from t0 into smem; past T, zeros
__device__ __forceinline__ void load_stat_row(float* dst, const float* __restrict__ src,
                                              int t0, int n, int T, int tid) {
  if (tid < n) {
    const bool ok = t0 + tid < T;
    wg::cp_async4(dst + tid, ok ? src + t0 + tid : src, ok ? 4 : 0);
  }
}

// delta = sum_d dO[row, d] * O[row, d] in f32 over the dh columns, two
// threads a row (half 0 takes the even 8-column pieces, half 1 the odd ones,
// the pair adjacent lanes); 0 for a row at or past T
__device__ __forceinline__ float row_delta(const __nv_bfloat16* __restrict__ dout,
                                           const __nv_bfloat16* __restrict__ o, size_t base,
                                           int row, int T, int dh, int rs, int half) {
  float x = 0.f;
  if (row < T) {
    const size_t off = base + (size_t)row * rs;
    for (int c = half * 8; c < dh; c += 16) {
      const uint4 a = *reinterpret_cast<const uint4*>(dout + off + c);
      const uint4 bb = *reinterpret_cast<const uint4*>(o + off + c);
      const __nv_bfloat16* pa = reinterpret_cast<const __nv_bfloat16*>(&a);
      const __nv_bfloat16* pb = reinterpret_cast<const __nv_bfloat16*>(&bb);
#pragma unroll
      for (int j = 0; j < 8; ++j) x += __bfloat162float(pa[j]) * __bfloat162float(pb[j]);
    }
  }
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

// The two-stage ring: issue(i) copies tile i into stage i & 1 and commits
// one cp.async group; body(i) runs once tile i has landed, while tile i + 1
// is on its way. One barrier a tile: past it, every thread has finished
// body(i - 1), so stage (i + 1) & 1 may be refilled. Groups committed before
// (the resident rows) have landed by body(0).
template <typename Issue, typename Body>
__device__ __forceinline__ void ring2(int n, Issue&& issue, Body&& body) {
  if (n > 0) issue(0);
  for (int i = 0; i < n; ++i) {
    wg::cp_wait<0>();
    wg::fence_async_proxy();
    __syncthreads();
    if (i + 1 < n) issue(i + 1);
    body(i);
  }
  __syncthreads();  // the stages are free for another ring
}

template <int DP>
struct BwdSmemA {  // pass A: Q, dO [128][DP]; two stages of K, V [KT][DP]; delta, lse
  static constexpr int KV = BwdTile<DP>::KT * DP;
  static constexpr size_t BYTES =
      (size_t)(2 * BWD_ROWS * DP + 4 * KV) * 2 + 2 * BWD_ROWS * sizeof(float);
};

template <int DP>
struct BwdSmemB {  // pass B: K, V [128][DP]; two stages of Q, dO [BQ][DP], lse, delta
  static constexpr int BQ = BwdTile<DP>::BQ;
  static constexpr int QD = BQ * DP;
  static constexpr size_t BYTES = (size_t)(2 * BWD_ROWS * DP + 4 * QD) * 2 + 4 * BQ * sizeof(float);
};

// Pass A. CLASSIC: recompute lse2 (written to lse) and give a kv_len <= 0
// row equal weights; otherwise lse holds the forward's lse2.
template <int DP, bool CLASSIC>
__global__ void __launch_bounds__(BWD_THREADS, BwdTile<DP>::MIN_BLOCKS)
bwd_dq_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
             const __nv_bfloat16* __restrict__ dout, float* __restrict__ lse,
             float* __restrict__ delta, const int* __restrict__ kv_lens,
             __nv_bfloat16* __restrict__ dq, int T, int dh, Layout lay, float sm_scale,
             float scale_log2) {
  using S = BwdSmemA<DP>;
  constexpr int KT = BwdTile<DP>::KT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BWD_ROWS * DP;
  __nv_bfloat16* ring = dOs + BWD_ROWS * DP;  // stage s: K at 2s, V at 2s + 1
  float* delta_s = reinterpret_cast<float*>(ring + 4 * S::KV);
  float* lse_s = delta_s + BWD_ROWS;

  const int q0 = blockIdx.x * BWD_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, rs = lay.row_stride;
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const size_t stat = ((size_t)b * H + h) * T;
  int limit;
  float s_scale;
  bwd_limit(kv_lens[b], T, scale_log2, CLASSIC, limit, s_scale);
  const int r0 = wgi * 64 + warp * 16 + g;  // this thread's rows r0 and r0 + 8

  load_core_tile<BWD_ROWS, DP>(Qs, q, base, q0, T, dh, rs, tid);
  load_core_tile<BWD_ROWS, DP>(dOs, dout, base, q0, T, dh, rs, tid);
  wg::cp_commit();

  {  // delta for the block's rows, two threads a row
    const int r = tid >> 1, row = q0 + r;
    const float x = row_delta(dout, o, base, row, T, dh, rs, tid & 1);
    if ((tid & 1) == 0) {
      delta_s[r] = x;
      if (row < T) delta[stat + row] = x;
      if (!CLASSIC) lse_s[r] = row < T ? lse[stat + row] : 0.f;
    }
  }

  const int n_tiles = (limit + KT - 1) / KT;
  float s[KT / 2], dp[KT / 2];
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = dp[i] = 0.f;
  auto stage = [&](int kt) { return ring + (kt & 1) * 2 * S::KV; };

  if (CLASSIC) {
    // lse2 = m + log2(max(l, 1e-30)) from S alone, as the forward's STATS
    // mode, over 128 keys a step: a stage's K and V slots take two K tiles,
    // S and dP's accumulators their two score tiles. The max is taken over
    // the raw scores (the scale is >= 0), each key costs one FFMA and one ex2.
    float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
    ring2(
        (limit + 2 * KT - 1) / (2 * KT),
        [&](int it) {
          load_core_tile<KT, DP>(stage(it), k, base, 2 * it * KT, T, dh, rs, tid);
          load_core_tile<KT, DP>(stage(it) + S::KV, k, base, (2 * it + 1) * KT, T, dh, rs, tid);
          wg::cp_commit();
        },
        [&](int it) {
          const __nv_bfloat16* K0 = stage(it);
          wg::fence();
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk)
            wg::wgmma_ss<KT>(s, desc_k<BWD_ROWS>(Qs, wgi * 64, kk), desc_k<KT>(K0, 0, kk),
                             kk > 0);
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk)
            wg::wgmma_ss<KT>(dp, desc_k<BWD_ROWS>(Qs, wgi * 64, kk),
                             desc_k<KT>(K0 + S::KV, 0, kk), kk > 0);
          wg::commit();
          wg::wait<0>();
          wg::fence_regs<KT / 2>(s);
          wg::fence_regs<KT / 2>(dp);
          const int k0 = 2 * it * KT;
          const bool ragged = k0 + 2 * KT > limit;
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int i = 0; i < KT / 2; ++i) {
            if (ragged) {
              const int col = k0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
              if (col >= limit) s[i] = -INFINITY;
              if (col + KT >= limit) dp[i] = -INFINITY;
            }
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], fmaxf(s[i], dp[i]));
          }
          float nm[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_i[r], mx[r] * s_scale);  // key k0 counts: finite
            l_i[r] *= exp2_approx(m_i[r] - m_new);                 // 0 on the first step
            m_i[r] = m_new;
            nm[r] = -m_new;
          }
#pragma unroll
          for (int i = 0; i < KT / 2; ++i) {
            const int r = (i >> 1) & 1;
            float e0 = exp2_approx(fmaf(s[i], s_scale, nm[r]));
            float e1 = exp2_approx(fmaf(dp[i], s_scale, nm[r]));
            if (ragged) {  // -inf * 0 would be NaN where the scale is 0 (empty rows)
              const int col = k0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
              e0 = col < limit ? e0 : 0.f;
              e1 = col + KT < limit ? e1 : 0.f;
            }
            l_i[r] += e0 + e1;
          }
        });
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float lse2 = m_i[r] + log2f(fmaxf(l, 1e-30f));
      const int rr = r0 + 8 * r;
      if (t4 == 0) {
        lse_s[rr] = lse2;
        if (q0 + rr < T) lse[stat + q0 + rr] = lse2;
      }
    }
  }
  __syncthreads();
  // p / sqrt(D) = exp2(s * scale - (lse2 - log2(sm_scale))): dS takes one FMUL less
  const float shift = log2f(sm_scale);
  const float nlse[2] = {shift - lse_s[r0], shift - lse_s[r0 + 8]};
  const float delta_r[2] = {delta_s[r0], delta_s[r0 + 8]};

  float dqa[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;
  ring2(
      n_tiles,
      [&](int kt) {
        load_core_tile<KT, DP>(stage(kt), k, base, kt * KT, T, dh, rs, tid);
        load_core_tile<KT, DP>(stage(kt) + S::KV, v, base, kt * KT, T, dh, rs, tid);
        wg::cp_commit();
      },
      [&](int kt) {
        const __nv_bfloat16* Ks = stage(kt);
        const __nv_bfloat16* Vs = Ks + S::KV;
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)  // S = Q K^T
          wg::wgmma_ss<KT>(s, desc_k<BWD_ROWS>(Qs, wgi * 64, kk), desc_k<KT>(Ks, 0, kk),
                           kk > 0);
        wg::commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)  // dP = dO V^T
          wg::wgmma_ss<KT>(dp, desc_k<BWD_ROWS>(dOs, wgi * 64, kk), desc_k<KT>(Vs, 0, kk),
                           kk > 0);
        wg::commit();
        wg::wait<1>();  // P while dP is still on the tensor cores
        wg::fence_regs<KT / 2>(s);
        const int k0 = kt * KT;
        const bool ragged = k0 + KT > limit;  // only the last tile masks keys
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) {
          s[i] = exp2_approx(fmaf(s[i], s_scale, nlse[(i >> 1) & 1]));
          if (ragged && k0 + (i >> 2) * 8 + t4 * 2 + (i & 1) >= limit) s[i] = 0.f;
        }
        wg::wait<0>();
        wg::fence_regs<KT / 2>(dp);
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) dp[i] = s[i] * (dp[i] - delta_r[(i >> 1) & 1]);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {  // dQ += dS K; above 128 columns, two products
          uint32_t a[4];
          acc_to_a(dp, kk, a);
          wgmma_rs_wide<KT, DP>(dqa, a, Ks, kk);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_regs<DP / 2>(dqa);
      });
  wg::cp_wait<0>();
  store_rows<DP>(dq, base, q0 + r0, T, dh, rs, dqa, t4);
}

// Pass B; lse and delta are pass A's (or the forward's) [B, H, T] rows.
template <int DP, bool CLASSIC>
__global__ void __launch_bounds__(BWD_THREADS, BwdTile<DP>::MIN_BLOCKS)
bwd_dkdv_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int T, int dh, Layout lay, float sm_scale,
               float scale_log2) {
  using S = BwdSmemB<DP>;
  constexpr int BQ = S::BQ;
  constexpr int SPLIT = BwdTile<DP>::SPLIT, NC = DP / SPLIT;  // dK, dV columns a block owns
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BWD_ROWS * DP;
  __nv_bfloat16* ring = Vs + BWD_ROWS * DP;  // stage s: Q at 2s, dO at 2s + 1
  float* stats = reinterpret_cast<float*>(ring + 4 * S::QD);  // stage s: lse, delta

  const int k0 = blockIdx.x / SPLIT * BWD_ROWS, col0 = blockIdx.x % SPLIT * NC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, rs = lay.row_stride;
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const size_t stat = ((size_t)b * H + h) * T;
  int limit;
  float s_scale;
  bwd_limit(kv_lens[b], T, scale_log2, CLASSIC, limit, s_scale);
  const int r0 = wgi * 64 + warp * 16 + g;  // this thread's keys k0 + r0 and + 8

  float dka[NC / 2], dva[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dka[i] = dva[i] = 0.f;

  // key tiles at or past the limit stream nothing and store zeros; no
  // branch around the products, which would make ptxas serialise them
  const int n_q = k0 < limit ? (T + BQ - 1) / BQ : 0;
  {
    if (n_q > 0) {
      load_core_tile<BWD_ROWS, DP>(Ks, k, base, k0, T, dh, rs, tid);
      load_core_tile<BWD_ROWS, DP>(Vs, v, base, k0, T, dh, rs, tid);
      wg::cp_commit();
    }
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
    auto stage = [&](int qt) { return ring + (qt & 1) * 2 * S::QD; };
    auto stage_stats = [&](int qt) { return stats + (qt & 1) * 2 * BQ; };
    ring2(
        n_q,
        [&](int qt) {
          load_core_tile<BQ, DP>(stage(qt), q, base, qt * BQ, T, dh, rs, tid);
          load_core_tile<BQ, DP>(stage(qt) + S::QD, dout, base, qt * BQ, T, dh, rs, tid);
          load_stat_row(stage_stats(qt), lse + stat, qt * BQ, BQ, T, tid);
          load_stat_row(stage_stats(qt) + BQ, delta + stat, qt * BQ, BQ, T, tid);
          wg::cp_commit();
        },
        [&](int qt) {
          const __nv_bfloat16* Qs = stage(qt);
          const __nv_bfloat16* dOs = Qs + S::QD;
          const float* lse_s = stage_stats(qt);
          const float* delta_s = lse_s + BQ;
          wg::fence();
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk)  // S^T = K Q^T   [key][query]
            wg::wgmma_ss<BQ>(st, desc_k<BWD_ROWS>(Ks, wgi * 64, kk), desc_k<BQ>(Qs, 0, kk),
                             kk > 0);
          wg::commit();
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk)  // dP^T = V dO^T
            wg::wgmma_ss<BQ>(dpt, desc_k<BWD_ROWS>(Vs, wgi * 64, kk), desc_k<BQ>(dOs, 0, kk),
                             kk > 0);
          wg::commit();
          wg::wait<1>();  // P^T while dP^T is still on the tensor cores
          wg::fence_regs<BQ / 2>(st);
          // queries past T: zero rows of Q and dO and zero delta make their
          // p times dO and ds exactly 0
          float nl[BQ / 8][2], nd[BQ / 8][2];  // per query column: -lse2, -delta / sqrt(D)
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              nl[j][e] = -lse_s[j * 8 + t4 * 2 + e];
              nd[j][e] = -delta_s[j * 8 + t4 * 2 + e] * sm_scale;
            }
          const bool keep[2] = {k0 + r0 < limit, k0 + r0 + 8 < limit};
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) {
            const float p = exp2_approx(fmaf(st[i], s_scale, nl[i >> 2][i & 1]));
            st[i] = keep[(i >> 1) & 1] ? p : 0.f;
          }
          wg::fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {  // dV += P^T dO, columns col0 .. + NC
            uint32_t a[4];
            acc_to_a(st, kk, a);
            wg::wgmma_rs_t<NC>(dva, a, desc_mn<BQ>(dOs + col0 * BQ, kk));
          }
          wg::commit();
          wg::wait<1>();  // dS^T while dV is on the tensor cores
          wg::fence_regs<BQ / 2>(dpt);
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i)
            dpt[i] = st[i] * fmaf(dpt[i], sm_scale, nd[i >> 2][i & 1]);
          wg::fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {  // dK += dS^T Q, columns col0 .. + NC
            uint32_t a[4];
            acc_to_a(dpt, kk, a);
            wg::wgmma_rs_t<NC>(dka, a, desc_mn<BQ>(Qs + col0 * BQ, kk));
          }
          wg::commit();
          wg::wait<0>();
          wg::fence_regs<NC / 2>(dva);
          wg::fence_regs<NC / 2>(dka);
        });
    wg::cp_wait<0>();
  }
  store_rows<NC>(dk, base + col0, k0 + r0, T, dh - col0, rs, dka, t4);
  store_rows<NC>(dv, base + col0, k0 + r0, T, dh - col0, rs, dva, t4);
}

// ------------------------------- head widths above 256 (wide, classic only)
//
// As the wide forward (flash_fwd.cuh): the products over D (S and dP, and
// the statistics' S) run over column chunks of WIDE_CHUNK, and a block owns
// one part of WIDE_PART columns of dQ (pass A) or of dK and dV (pass B),
// recomputing S and dP for its part. Shared memory and registers do not grow
// with D, so one instance serves every width. Pass B takes 32 queries a tile,
// as the wide variant above: its dK and dV parts keep 128 accumulators.

// a slot: Q, dO [128][CHUNK] and K, V [64][CHUNK], or K [64][PART]
struct BwdWideA {
  static constexpr int SLOT = 2 * (BWD_ROWS + KV_TILE) * WIDE_CHUNK;
  static constexpr size_t BYTES =
      (size_t)WIDE_SLOTS * SLOT * 2 + 2 * BWD_ROWS * sizeof(float);
};
static_assert(KV_TILE * WIDE_PART <= BwdWideA::SLOT, "a K part fits a slot");

// a slot: K, V [128][CHUNK] and Q, dO [BQ][CHUNK], or Q, dO [BQ][PART] and
// their lse2 and delta
struct BwdWideB {
  static constexpr int BQ = 32;
  static constexpr int SLOT = 2 * (BWD_ROWS + BQ) * WIDE_CHUNK;
  static constexpr size_t BYTES = (size_t)WIDE_SLOTS * SLOT * 2;
};
static_assert(2 * BwdWideB::BQ * WIDE_PART + 4 * BwdWideB::BQ <= BwdWideB::SLOT,
              "a Q and dO part and their statistics fit a slot");

// Pass A, classic: delta, lse2 recomputed over the keys below kv_len (a
// sweep of S alone), then dQ for the block's part. Grid (ceil(T / 128) *
// wide_parts(dh), H, B); part 0 writes delta and lse2.
__global__ void __launch_bounds__(BWD_THREADS)
bwd_dq_wide(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
            const __nv_bfloat16* __restrict__ dout, float* __restrict__ lse,
            float* __restrict__ delta, const int* __restrict__ kv_lens,
            __nv_bfloat16* __restrict__ dq, int T, int dh, Layout lay, float sm_scale,
            float scale_log2) {
  using S = BwdWideA;
  constexpr int CH = WIDE_CHUNK, NP = WIDE_PART, KT = KV_TILE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* delta_s = reinterpret_cast<float*>(ring + WIDE_SLOTS * S::SLOT);
  float* lse_s = delta_s + BWD_ROWS;

  const int parts = wide_parts(dh), part = blockIdx.x % parts, col0 = part * NP;
  const int q0 = blockIdx.x / parts * BWD_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, rs = lay.row_stride;
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const size_t stat = ((size_t)b * H + h) * T;
  int limit;
  float s_scale;
  bwd_limit(kv_lens[b], T, scale_log2, 1, limit, s_scale);
  const int r0 = wgi * 64 + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const int nch = (dh + CH - 1) / CH, n_tiles = (limit + KT - 1) / KT;

  {  // delta for the block's rows, two threads a row
    const int r = tid >> 1, row = q0 + r;
    const float x = row_delta(dout, o, base, row, T, dh, rs, tid & 1);
    if ((tid & 1) == 0) {
      delta_s[r] = x;
      if (part == 0 && row < T) delta[stat + row] = x;
    }
  }

  float s[KT / 2], dp[KT / 2];
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = dp[i] = 0.f;

  {  // lse2 = m + log2(max(l, 1e-30)) from S alone, chunk by chunk
    const int n_units = n_tiles * nch;
    auto issue = [&](int u) {
      __nv_bfloat16* slot = ring + (u % WIDE_SLOTS) * S::SLOT;
      const int j = u / nch, c = u % nch;
      load_core_tile<BWD_ROWS, CH>(slot, q, base + c * CH, q0, T, dh - c * CH, rs, tid);
      load_core_tile<KT, CH>(slot + BWD_ROWS * CH, k, base + c * CH, j * KT, T, dh - c * CH,
                             rs, tid);
      wg::cp_commit();
    };
    float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f}, alpha[2];
    wide_start(n_units, issue);
    int u = 0;
    for (int j = 0; j < n_tiles; ++j) {
      for (int c = 0; c < nch; ++c, ++u) {
        wide_step(u, n_units, issue);
        const __nv_bfloat16* Qc = ring + (u % WIDE_SLOTS) * S::SLOT;
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < CH / 16; ++kk)
          wg::wgmma_ss<KT>(s, desc_k<BWD_ROWS>(Qc, wgi * 64, kk),
                           desc_k<KT>(Qc + BWD_ROWS * CH, 0, kk), c > 0 || kk > 0);
        wg::commit();
        wg::wait<0>();
      }
      wg::fence_regs<KT / 2>(s);
      tile_softmax<SOFTMAX>(s, j, limit, s_scale, t4, m_i, l_i, alpha);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float lse2 = m_i[r] + log2f(fmaxf(l, 1e-30f));
      const int rr = r0 + 8 * r;
      if (t4 == 0) {
        lse_s[rr] = lse2;
        if (part == 0 && q0 + rr < T) lse[stat + q0 + rr] = lse2;
      }
    }
  }
  __syncthreads();  // lse_s and delta_s written; the ring is free
  // p / sqrt(D) = exp2(s * scale - (lse2 - log2(sm_scale))), as pass A above
  const float shift = log2f(sm_scale);
  const float nlse[2] = {shift - lse_s[r0], shift - lse_s[r0 + 8]};
  const float delta_r[2] = {delta_s[r0], delta_s[r0 + 8]};

  float dqa[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) dqa[i] = 0.f;
  const int per_tile = nch + 1, n_units = n_tiles * per_tile;
  auto issue = [&](int u) {  // key tile j's chunk c of Q, dO, K, V, or (c = nch) its K part
    __nv_bfloat16* slot = ring + (u % WIDE_SLOTS) * S::SLOT;
    const int j = u / per_tile, c = u % per_tile;
    if (c < nch) {
      load_core_tile<BWD_ROWS, CH>(slot, q, base + c * CH, q0, T, dh - c * CH, rs, tid);
      load_core_tile<BWD_ROWS, CH>(slot + BWD_ROWS * CH, dout, base + c * CH, q0, T,
                                   dh - c * CH, rs, tid);
      load_core_tile<KT, CH>(slot + 2 * BWD_ROWS * CH, k, base + c * CH, j * KT, T,
                             dh - c * CH, rs, tid);
      load_core_tile<KT, CH>(slot + (2 * BWD_ROWS + KT) * CH, v, base + c * CH, j * KT, T,
                             dh - c * CH, rs, tid);
    } else {
      load_core_tile<KT, NP>(slot, k, base + col0, j * KT, T, dh - col0, rs, tid);
    }
    wg::cp_commit();
  };
  wide_start(n_units, issue);
  int u = 0;
  for (int kt = 0; kt < n_tiles; ++kt) {
    for (int c = 0; c < nch; ++c, ++u) {  // S = Q K^T and dP = dO V^T, chunk by chunk
      wide_step(u, n_units, issue);
      const __nv_bfloat16* Qc = ring + (u % WIDE_SLOTS) * S::SLOT;
      const __nv_bfloat16* dOc = Qc + BWD_ROWS * CH;
      const __nv_bfloat16* Kc = dOc + BWD_ROWS * CH;
      const __nv_bfloat16* Vc = Kc + KT * CH;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        wg::wgmma_ss<KT>(s, desc_k<BWD_ROWS>(Qc, wgi * 64, kk), desc_k<KT>(Kc, 0, kk),
                         c > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        wg::wgmma_ss<KT>(dp, desc_k<BWD_ROWS>(dOc, wgi * 64, kk), desc_k<KT>(Vc, 0, kk),
                         c > 0 || kk > 0);
      wg::commit();
      wg::wait<0>();
    }
    wg::fence_regs<KT / 2>(s);
    wg::fence_regs<KT / 2>(dp);
    const int k0 = kt * KT;
    const bool ragged = k0 + KT > limit;  // only the last tile masks keys
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      s[i] = exp2_approx(fmaf(s[i], s_scale, nlse[(i >> 1) & 1]));
      if (ragged && k0 + (i >> 2) * 8 + t4 * 2 + (i & 1) >= limit) s[i] = 0.f;
      dp[i] = s[i] * (dp[i] - delta_r[(i >> 1) & 1]);
    }
    wide_step(u, n_units, issue);  // dQ += dS K, the block's columns
    const __nv_bfloat16* Kp = ring + (u % WIDE_SLOTS) * S::SLOT;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(dp, kk, a);
      wg::wgmma_rs_t<NP>(dqa, a, desc_mn<KT>(Kp, kk));
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs<NP / 2>(dqa);
    ++u;
  }
  store_rows<NP>(dq, base + col0, q0 + r0, T, dh - col0, rs, dqa, t4);
}

// Pass B; lse and delta are pass A's [B, H, T] rows. Grid (ceil(T / 128) *
// wide_parts(dh), H, B).
__global__ void __launch_bounds__(BWD_THREADS)
bwd_dkdv_wide(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int T, int dh, Layout lay, float sm_scale,
              float scale_log2) {
  using S = BwdWideB;
  constexpr int CH = WIDE_CHUNK, NP = WIDE_PART, BQ = S::BQ;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int parts = wide_parts(dh), part = blockIdx.x % parts, col0 = part * NP;
  const int k0 = blockIdx.x / parts * BWD_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, rs = lay.row_stride;
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const size_t stat = ((size_t)b * H + h) * T;
  int limit;
  float s_scale;
  bwd_limit(kv_lens[b], T, scale_log2, 1, limit, s_scale);
  const int r0 = wgi * 64 + warp * 16 + g;  // this thread's keys k0 + r0 and + 8
  const int nch = (dh + CH - 1) / CH;

  float dka[NP / 2], dva[NP / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;

  // key tiles at or past the limit stream nothing and store zeros
  const int n_q = k0 < limit ? (T + BQ - 1) / BQ : 0;
  const int per_tile = nch + 1, n_units = n_q * per_tile;
  auto issue = [&](int u) {  // query tile qt's chunk c of K, V, Q, dO, or its Q and dO part
    __nv_bfloat16* slot = ring + (u % WIDE_SLOTS) * S::SLOT;
    const int qt = u / per_tile, c = u % per_tile;
    if (c < nch) {
      load_core_tile<BWD_ROWS, CH>(slot, k, base + c * CH, k0, T, dh - c * CH, rs, tid);
      load_core_tile<BWD_ROWS, CH>(slot + BWD_ROWS * CH, v, base + c * CH, k0, T, dh - c * CH,
                                   rs, tid);
      load_core_tile<BQ, CH>(slot + 2 * BWD_ROWS * CH, q, base + c * CH, qt * BQ, T,
                             dh - c * CH, rs, tid);
      load_core_tile<BQ, CH>(slot + (2 * BWD_ROWS + BQ) * CH, dout, base + c * CH, qt * BQ, T,
                             dh - c * CH, rs, tid);
    } else {
      load_core_tile<BQ, NP>(slot, q, base + col0, qt * BQ, T, dh - col0, rs, tid);
      load_core_tile<BQ, NP>(slot + BQ * NP, dout, base + col0, qt * BQ, T, dh - col0, rs, tid);
      float* stats = reinterpret_cast<float*>(slot + 2 * BQ * NP);
      load_stat_row(stats, lse + stat, qt * BQ, BQ, T, tid);
      load_stat_row(stats + BQ, delta + stat, qt * BQ, BQ, T, tid);
    }
    wg::cp_commit();
  };
  wide_start(n_units, issue);
  int u = 0;
  for (int qt = 0; qt < n_q; ++qt) {
    for (int c = 0; c < nch; ++c, ++u) {  // S^T = K Q^T and dP^T = V dO^T, chunk by chunk
      wide_step(u, n_units, issue);
      const __nv_bfloat16* Kc = ring + (u % WIDE_SLOTS) * S::SLOT;
      const __nv_bfloat16* Vc = Kc + BWD_ROWS * CH;
      const __nv_bfloat16* Qc = Vc + BWD_ROWS * CH;
      const __nv_bfloat16* dOc = Qc + BQ * CH;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        wg::wgmma_ss<BQ>(st, desc_k<BWD_ROWS>(Kc, wgi * 64, kk), desc_k<BQ>(Qc, 0, kk),
                         c > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        wg::wgmma_ss<BQ>(dpt, desc_k<BWD_ROWS>(Vc, wgi * 64, kk), desc_k<BQ>(dOc, 0, kk),
                         c > 0 || kk > 0);
      wg::commit();
      wg::wait<0>();
    }
    wg::fence_regs<BQ / 2>(st);
    wg::fence_regs<BQ / 2>(dpt);
    wide_step(u, n_units, issue);  // the part of Q and dO, and the statistics
    const __nv_bfloat16* Qp = ring + (u % WIDE_SLOTS) * S::SLOT;
    const __nv_bfloat16* dOp = Qp + BQ * NP;
    const float* lse_s = reinterpret_cast<const float*>(Qp + 2 * BQ * NP);
    const float* delta_s = lse_s + BQ;
    // queries past T: zero rows of Q and dO and zero delta make their p
    // times dO and ds exactly 0
    float nl[BQ / 8][2], nd[BQ / 8][2];  // per query column: -lse2, -delta / sqrt(D)
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        nl[j][e] = -lse_s[j * 8 + t4 * 2 + e];
        nd[j][e] = -delta_s[j * 8 + t4 * 2 + e] * sm_scale;
      }
    const bool keep[2] = {k0 + r0 < limit, k0 + r0 + 8 < limit};
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const float p = exp2_approx(fmaf(st[i], s_scale, nl[i >> 2][i & 1]));
      st[i] = keep[(i >> 1) & 1] ? p : 0.f;
      dpt[i] = st[i] * fmaf(dpt[i], sm_scale, nd[i >> 2][i & 1]);
    }
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {  // dV += P^T dO, the block's columns
      uint32_t a[4];
      acc_to_a(st, kk, a);
      wg::wgmma_rs_t<NP>(dva, a, desc_mn<BQ>(dOp, kk));
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {  // dK += dS^T Q, the block's columns
      uint32_t a[4];
      acc_to_a(dpt, kk, a);
      wg::wgmma_rs_t<NP>(dka, a, desc_mn<BQ>(Qp, kk));
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs<NP / 2>(dva);
    wg::fence_regs<NP / 2>(dka);
    ++u;
  }
  wg::cp_wait<0>();
  store_rows<NP>(dk, base + col0, k0 + r0, T, dh - col0, rs, dka, t4);
  store_rows<NP>(dv, base + col0, k0 + r0, T, dh - col0, rs, dva, t4);
}

// ------------------------------------------------------------ f32 (SIMT)

// delta[(b*H + h)*T + t] = sum_d dO[row] * O[row]; one warp each
__global__ void __launch_bounds__(256)
attn_delta_f32(const float* __restrict__ o, const float* __restrict__ dout,
               float* __restrict__ delta, int B, int Tn, int H, int dh, Layout lay) {
  const int lane = threadIdx.x & 31;
  const size_t idx = (size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (idx >= (size_t)B * H * Tn) return;
  const int t = (int)(idx % Tn);
  const size_t bh = idx / Tn;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const size_t off = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride +
                     (size_t)t * lay.row_stride;
  float x = 0.f;
  for (int d = lane; d < dh; d += 32) x += dout[off + d] * o[off + d];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  if (lane == 0) delta[idx] = x;
}

constexpr int F32_TILE = 16;  // rows of the streamed tile

// f32 at every width (the reference path of the checks, not tuned): one
// query row (dq) or key row (dkdv) a thread, with q.k and dO.v summed in
// column order over chunks of F32_CHUNK columns staged in shared memory, and
// one part of F32_PART output columns a block. Grid (ceil(T / 64) *
// f32_parts(dh), H, B). uniform_empty: the classic kernel's kv_len <= 0 rule.
__global__ void __launch_bounds__(F32_ROWS)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ kv_lens, float* __restrict__ dq, int T, int dh, Layout lay,
           float sm_scale, float scale_log2, int uniform_empty) {
  __shared__ float Qs[F32_ROWS][F32_CHUNK + 1], dOs[F32_ROWS][F32_CHUNK + 1];
  __shared__ float Ks[F32_TILE][F32_CHUNK], Vs[F32_TILE][F32_CHUNK];
  __shared__ float Kp[F32_TILE][F32_PART];
  const int parts = f32_parts(dh), part = blockIdx.x % parts, col0 = part * F32_PART;
  const int q0 = blockIdx.x / parts * F32_ROWS, tid = threadIdx.x, row = q0 + tid;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y, rs = lay.row_stride;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const size_t stat = ((size_t)b * H + h) * T;
  int limit;
  float s_scale;
  bwd_limit(kv_lens[b], T, scale_log2, uniform_empty, limit, s_scale);
  const float lse_r = row < T ? lse[stat + row] : INFINITY;
  const float delta_r = row < T ? delta[stat + row] : 0.f;

  float dq_acc[F32_PART];
#pragma unroll
  for (int d = 0; d < F32_PART; ++d) dq_acc[d] = 0.f;
  for (int k0 = 0; k0 < limit; k0 += F32_TILE) {
    float sdot[F32_TILE], dp[F32_TILE];
#pragma unroll
    for (int j = 0; j < F32_TILE; ++j) sdot[j] = dp[j] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += F32_CHUNK) {
      __syncthreads();
      for (int idx = tid; idx < F32_TILE * F32_CHUNK; idx += F32_ROWS) {
        const int r = idx / F32_CHUNK, c = idx % F32_CHUNK;
        const bool ok = k0 + r < T && c0 + c < dh;
        Ks[r][c] = ok ? k[base + (size_t)(k0 + r) * rs + c0 + c] : 0.f;
        Vs[r][c] = ok ? v[base + (size_t)(k0 + r) * rs + c0 + c] : 0.f;
      }
      for (int idx = tid; idx < F32_ROWS * F32_CHUNK; idx += F32_ROWS) {
        const int r = idx / F32_CHUNK, c = idx % F32_CHUNK;
        const bool ok = q0 + r < T && c0 + c < dh;
        Qs[r][c] = ok ? q[base + (size_t)(q0 + r) * rs + c0 + c] : 0.f;
        dOs[r][c] = ok ? dout[base + (size_t)(q0 + r) * rs + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < F32_CHUNK; ++c) {
        const float qv = Qs[tid][c], dv = dOs[tid][c];
#pragma unroll
        for (int j = 0; j < F32_TILE; ++j) {
          sdot[j] = fmaf(qv, Ks[j][c], sdot[j]);
          dp[j] = fmaf(dv, Vs[j][c], dp[j]);
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < F32_TILE * F32_PART; idx += F32_ROWS) {
      const int r = idx / F32_PART, c = idx % F32_PART;
      const bool ok = k0 + r < T && col0 + c < dh;
      Kp[r][c] = ok ? k[base + (size_t)(k0 + r) * rs + col0 + c] : 0.f;
    }
    __syncthreads();
    const int n = min(F32_TILE, limit - k0);
#pragma unroll
    for (int j = 0; j < F32_TILE; ++j) {
      if (j >= n) break;
      const float p = exp2f(sdot[j] * s_scale - lse_r);
      const float ds = p * (dp[j] - delta_r) * sm_scale;
#pragma unroll
      for (int d = 0; d < F32_PART; ++d) dq_acc[d] = fmaf(ds, Kp[j][d], dq_acc[d]);
    }
  }
  if (row < T) {
#pragma unroll
    for (int d = 0; d < F32_PART; ++d)
      if (col0 + d < dh) dq[base + (size_t)row * rs + col0 + d] = dq_acc[d];
  }
}

__global__ void __launch_bounds__(F32_ROWS)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int* __restrict__ kv_lens, float* __restrict__ dk, float* __restrict__ dv,
             int T, int dh, Layout lay, float sm_scale, float scale_log2, int uniform_empty) {
  __shared__ float Ks[F32_ROWS][F32_CHUNK + 1], Vs[F32_ROWS][F32_CHUNK + 1];
  __shared__ float Qs[F32_TILE][F32_CHUNK], dOs[F32_TILE][F32_CHUNK];
  __shared__ float Qp[F32_TILE][F32_PART], dOp[F32_TILE][F32_PART];
  __shared__ float lse_s[F32_TILE], delta_s[F32_TILE];
  const int parts = f32_parts(dh), part = blockIdx.x % parts, col0 = part * F32_PART;
  const int k0 = blockIdx.x / parts * F32_ROWS, tid = threadIdx.x, key = k0 + tid;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y, rs = lay.row_stride;
  const size_t base = (size_t)b * lay.batch_stride + (size_t)h * lay.head_stride;
  const size_t stat = ((size_t)b * H + h) * T;
  int limit;
  float s_scale;
  bwd_limit(kv_lens[b], T, scale_log2, uniform_empty, limit, s_scale);

  float dk_acc[F32_PART], dv_acc[F32_PART];
#pragma unroll
  for (int d = 0; d < F32_PART; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  for (int q0 = 0; k0 < limit && q0 < T; q0 += F32_TILE) {
    float sdot[F32_TILE], dp[F32_TILE];
#pragma unroll
    for (int i = 0; i < F32_TILE; ++i) sdot[i] = dp[i] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += F32_CHUNK) {
      __syncthreads();
      for (int idx = tid; idx < F32_ROWS * F32_CHUNK; idx += F32_ROWS) {
        const int r = idx / F32_CHUNK, c = idx % F32_CHUNK;
        const bool ok = k0 + r < T && c0 + c < dh;
        Ks[r][c] = ok ? k[base + (size_t)(k0 + r) * rs + c0 + c] : 0.f;
        Vs[r][c] = ok ? v[base + (size_t)(k0 + r) * rs + c0 + c] : 0.f;
      }
      for (int idx = tid; idx < F32_TILE * F32_CHUNK; idx += F32_ROWS) {
        const int r = idx / F32_CHUNK, c = idx % F32_CHUNK;
        const bool ok = q0 + r < T && c0 + c < dh;
        Qs[r][c] = ok ? q[base + (size_t)(q0 + r) * rs + c0 + c] : 0.f;
        dOs[r][c] = ok ? dout[base + (size_t)(q0 + r) * rs + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < F32_CHUNK; ++c) {
        const float kv = Ks[tid][c], vv = Vs[tid][c];
#pragma unroll
        for (int i = 0; i < F32_TILE; ++i) {
          sdot[i] = fmaf(Qs[i][c], kv, sdot[i]);
          dp[i] = fmaf(dOs[i][c], vv, dp[i]);
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < F32_TILE * F32_PART; idx += F32_ROWS) {
      const int r = idx / F32_PART, c = idx % F32_PART;
      const bool ok = q0 + r < T && col0 + c < dh;
      Qp[r][c] = ok ? q[base + (size_t)(q0 + r) * rs + col0 + c] : 0.f;
      dOp[r][c] = ok ? dout[base + (size_t)(q0 + r) * rs + col0 + c] : 0.f;
    }
    if (tid < F32_TILE) {
      const bool ok = q0 + tid < T;
      lse_s[tid] = ok ? lse[stat + q0 + tid] : INFINITY;
      delta_s[tid] = ok ? delta[stat + q0 + tid] : 0.f;
    }
    __syncthreads();
    if (key < limit) {
      const int n = min(F32_TILE, T - q0);
#pragma unroll
      for (int i = 0; i < F32_TILE; ++i) {
        if (i >= n) break;
        const float p = exp2f(sdot[i] * s_scale - lse_s[i]);
        const float ds = p * (dp[i] - delta_s[i]) * sm_scale;
#pragma unroll
        for (int d = 0; d < F32_PART; ++d) {
          dk_acc[d] = fmaf(ds, Qp[i][d], dk_acc[d]);
          dv_acc[d] = fmaf(p, dOp[i][d], dv_acc[d]);
        }
      }
    }
  }
  if (key < T) {
#pragma unroll
    for (int d = 0; d < F32_PART; ++d) {
      if (col0 + d >= dh) break;
      dk[base + (size_t)key * rs + col0 + d] = dk_acc[d];
      dv[base + (size_t)key * rs + col0 + d] = dv_acc[d];
    }
  }
}

// ------------------------------------------------------------------ host

// Passes: bit 0 runs pass A (delta, the classic lse2, dQ), bit 1 pass B
// (dK, dV); the entry points run both, in that order. Pass B alone reads
// the delta and lse2 an earlier pass A left in the scratch. The lanes
// kernel's lse holds the forward's lse2; the classic kernel's is scratch.
// One bf16 backward at padded width DP (to 256).
template <int DP, bool CLASSIC>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, void* lse, const void* kv_lens, void* delta, void* dq,
               void* dk, void* dv, int B, int Tn, int H, int dh, Layout lay, float sm_scale,
               int passes, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const float scale_log2 = LOG2E * sm_scale;
  float* lse_f = static_cast<float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  const int* lens = static_cast<const int*>(kv_lens);
  cudaError_t err;
  const dim3 grid((Tn + BWD_ROWS - 1) / BWD_ROWS, H, B);
  if (passes & 1) {
    auto kern = bwd_dq_wgmma<DP, CLASSIC>;
    if ((err = allow_smem(kern, BwdSmemA<DP>::BYTES)) != cudaSuccess) return (int)err;
    kern<<<grid, BWD_THREADS, BwdSmemA<DP>::BYTES, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(out), static_cast<const bf*>(dout), lse_f, delta_f, lens,
        static_cast<bf*>(dq), Tn, dh, lay, sm_scale, scale_log2);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    auto kern = bwd_dkdv_wgmma<DP, CLASSIC>;
    if ((err = allow_smem(kern, BwdSmemB<DP>::BYTES)) != cudaSuccess) return (int)err;
    const dim3 grid_b(grid.x * BwdTile<DP>::SPLIT, H, B);
    kern<<<grid_b, BWD_THREADS, BwdSmemB<DP>::BYTES, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(dout), lse_f, delta_f, lens, static_cast<bf*>(dk),
        static_cast<bf*>(dv), Tn, dh, lay, sm_scale, scale_log2);
  }
  return (int)cudaGetLastError();
}

// The classic bf16 backward above 256 (dh a multiple of 8); arguments as
// launch_bwd's.
inline int launch_bwd_wide(const void* q, const void* k, const void* v, const void* out,
                           const void* dout, void* lse, const void* kv_lens, void* delta,
                           void* dq, void* dk, void* dv, int B, int Tn, int H, int dh,
                           Layout lay, float sm_scale, int passes, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (Tn <= 0 || B <= 0 || H <= 0) return 0;
  if (dh % 8) return (int)cudaErrorInvalidValue;
  const float scale_log2 = LOG2E * sm_scale;
  float* lse_f = static_cast<float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  const int* lens = static_cast<const int*>(kv_lens);
  cudaError_t err;
  const dim3 grid((Tn + BWD_ROWS - 1) / BWD_ROWS * wide_parts(dh), H, B);
  if (passes & 1) {
    if ((err = allow_smem(bwd_dq_wide, BwdWideA::BYTES)) != cudaSuccess) return (int)err;
    bwd_dq_wide<<<grid, BWD_THREADS, BwdWideA::BYTES, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(out), static_cast<const bf*>(dout), lse_f, delta_f, lens,
        static_cast<bf*>(dq), Tn, dh, lay, sm_scale, scale_log2);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    if ((err = allow_smem(bwd_dkdv_wide, BwdWideB::BYTES)) != cudaSuccess) return (int)err;
    bwd_dkdv_wide<<<grid, BWD_THREADS, BwdWideB::BYTES, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(dout), lse_f, delta_f, lens, static_cast<bf*>(dk),
        static_cast<bf*>(dv), Tn, dh, lay, sm_scale, scale_log2);
  }
  return (int)cudaGetLastError();
}

// The f32 backward at any head width dh (a multiple of 8); classic: the
// classic kernel (lse2 recomputed by the forward in STATS mode, the kv_len
// <= 0 rule of the header), else the lanes one (lse holds the forward's).
inline int launch_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                          const void* dout, void* lse, const void* kv_lens, void* delta,
                          void* dq, void* dk, void* dv, int B, int Tn, int H, int dh,
                          Layout lay, float sm_scale, int classic, int passes,
                          cudaStream_t st) {
  if (Tn <= 0 || B <= 0 || H <= 0) return 0;
  if (dh < 8 || dh % 8) return (int)cudaErrorInvalidValue;
  const float scale_log2 = LOG2E * sm_scale;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  float* lse_f = static_cast<float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  const int* lens = static_cast<const int*>(kv_lens);
  cudaError_t err;
  const dim3 grid((Tn + F32_ROWS - 1) / F32_ROWS * f32_parts(dh), H, B);
  if (passes & 1) {
    if (classic) {
      const int rc = launch_fwd_f32<STATS>(qf, kf, nullptr, kv_lens, nullptr, lse_f, B, Tn, H,
                                           dh, lay, sm_scale, 1, st);
      if (rc != 0) return rc;
    }
    const size_t n_warps = (size_t)B * Tn * H;
    attn_delta_f32<<<(unsigned)((n_warps + 7) / 8), 256, 0, st>>>(
        static_cast<const float*>(out), dof, delta_f, B, Tn, H, dh, lay);
    bwd_dq_f32<<<grid, F32_ROWS, 0, st>>>(qf, kf, vf, dof, lse_f, delta_f, lens,
                                          static_cast<float*>(dq), Tn, dh, lay, sm_scale,
                                          scale_log2, classic);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    bwd_dkdv_f32<<<grid, F32_ROWS, 0, st>>>(qf, kf, vf, dof, lse_f, delta_f, lens,
                                            static_cast<float*>(dk), static_cast<float*>(dv), Tn,
                                            dh, lay, sm_scale, scale_log2, classic);
  }
  return (int)cudaGetLastError();
}

}  // namespace attn
}  // namespace oron
