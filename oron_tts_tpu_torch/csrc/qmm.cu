// w8a16 matrix product for Hopper (sm_90a): out = (x @ dequant(Wq)) * scale (+ bias).
//
// Replaces the TPU kernel oron_tts_tpu/ops/quantized_matmul.py:55 (_qmm_kernel),
// the six int8 projections of every DiT block under mode="int8". It computes
// what that kernel computes, in its order: int8 -> x's type (exact, |q| <= 127),
// the product with f32 accumulation, times scale[n] in f32, one cast to x's
// type. With a bias (QDense's), the epilogue then adds it in x's type and
// rounds again: bf16(bf16(acc * scale) + bias), the JAX QDense's order
// (layers.py:437-442, the kernel, then y + bias.astype(y.dtype)), bit for bit
// the kernel followed by a separate bf16 add.
//
// Layout. x is [M, K] row-major, out [M, N]. The weight is stored [N, K] int8
// with K contiguous (nn.Linear's layout). The JAX package stores [K, N]; the
// weight loader transposes once at load.
//
// Bound on the H100: 2*M*K*N operations over M*K*2 + N*K + M*N*2 bytes. At the
// serving shapes (M = 1,664 for one request's two CFG rows of 832 frames,
// 13,312 for a merged solve of eight; K and N 1,024 or 4,096) that is 480 to
// 2,900 operations a byte, far above the card's 295: the tensor cores bound
// every one of them, and the design is about feeding them.
//
// Design (bf16). A block computes a tile of BM x rows (64, 128, 192 or 256,
// chosen by shape in ops/quantized_matmul.py qmm_plan) by 128 weight rows, as its
// transpose: out^T = W x^T, so the converted weight is wgmma's A operand, in
// registers, and x its B operand, from shared memory ("swap A/B"). Three
// warpgroups: a producer whose one thread keeps a ring of STAGES (5 to 8)
// k tiles of 64 in flight with TMA (x bf16 with 128-byte swizzle, the weight
// as int8 with 64-byte swizzle: half the bytes of bf16), each stage guarded
// by a full and an empty mbarrier; and two consumer warpgroups of 64 weight
// rows each. A consumer waits for stage i, converts its own int8 rows of it
// into bf16 A fragments in registers (s8_to_f32 below, exact; no shared-memory
// round trip, so no generic-to-async proxy fence), issues the four wgmma
// m64nBMk16 of tile i, then waits for tile i - 1's products only
// (wgmma.wait_group 1) and frees that stage: the conversion of tile i runs
// under the products of tile i - 1. No block-wide barrier in the loop.
// The epilogue scales, rounds, adds the bias and, where N is a multiple of 8,
// stages the tile in shared memory so that every global store is 16
// contiguous bytes (else element stores).
//   The grid. The ring fills most of an SM's shared memory, so one block runs
// on an SM at a time and qmm_plan picks BM for the fewest waves of blocks
// times their length. Each block runs the whole of K and writes its tile
// once: no atomics, so two calls give the same bits.
// With 384 threads ptxas gives a thread at most 168 registers; at BM = 256
// (128 accumulators and two fragment sets) it serialises the wgmma (C7512),
// and that tile still measured fastest where qmm_plan takes it.
//   Against this design on the card (PERF.md §6): the same math on
// cp.async rings filled by every thread, with the weight converted into a
// bf16 shared-memory B operand (with and without swizzle) or into register
// fragments; the producer warpgroup with TMA was the fastest of them.
//
// f32: a SIMT kernel in true f32 (64 x 64 tile, 4 x 4 outputs per thread),
// the reference path of the checks.
#include <cuda.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using oron::wg::smem_addr;

// byte i of `biased` (= word ^ 0x80808080, so u = q + 128) -> float(q), exactly:
// 0x4B0000uu is the float 2^23 + u, and 2^23 + 128 is subtracted from it
template <int I>
__device__ __forceinline__ float s8_to_f32(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + I)) - 8388736.f;
}

// two floats that are small integers -> bf16x2 (lo in the low half), exactly:
// their low 16 bits are 0, so the bf16 is the f32's high half
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// bf16(acc * scale), then bf16(that + bias) when there is a bias
__device__ __forceinline__ __nv_bfloat16 finish(float acc, float s,
                                                const __nv_bfloat16* __restrict__ bias,
                                                int col) {
  __nv_bfloat16 y = __float2bfloat16_rn(acc * s);
  if (bias != nullptr) y = __float2bfloat16_rn(__bfloat162float(y) + __bfloat162float(bias[col]));
  return y;
}

constexpr int BK = 64;         // k a tile
constexpr int BN = 128;        // weight rows (output columns) a block: two warpgroups x 64
constexpr int THREADS = 384;   // warpgroups 0 and 1 consume, 2 produces
constexpr int OLD = BN + 8;    // staged output row, bf16: 272 bytes, no bank conflicts

template <int BM>
struct QmmTile {
  static constexpr int STAGES = BM == 256 ? 5 : BM == 192 ? 6 : 8;
  static constexpr int X_BYTES = BM * BK * 2;  // x rows, 128-byte swizzle
  static constexpr int W_BYTES = BN * BK;      // weight rows, int8, 64-byte swizzle
  static constexpr int STAGE = X_BYTES + W_BYTES;
  // the ring, its barriers, and slack to align the ring to 1,024 bytes:
  // 205,904 bytes at BM = 256, 197,728 at 192, 197,760 at 128, 132,224 at 64;
  // the staged output fits the ring
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(BM * OLD * 2 <= STAGES * STAGE, "the staged output must fit the ring");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// spins on try_wait; a phase that never completes traps (a launch error)
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (long long tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1ll << 26)) __trap();
  }
}
// the box of `map` at (c0 along a row, c1 across rows) into dst; completes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// a barrier of the 256 consumer threads only
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Grid (ceil(N / 128), ceil(M / BM)). xmap: x [M, K] bf16, box 64 x BM;
// wmap: the weight [N, K] int8, box 64 x 128.
template <int BM>
__global__ void __launch_bounds__(THREADS, 1)
qmm_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
          const float* __restrict__ scale, const __nv_bfloat16* __restrict__ bias,
          __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using Tl = QmmTile<BM>;
  constexpr int S = Tl::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * Tl::STAGE);
  uint64_t* empty = full + S;
  auto x_tile = [&](int s) { return ring + s * Tl::STAGE; };
  auto w_tile = [&](int s) { return ring + s * Tl::STAGE + Tl::X_BYTES; };

  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  // the k tiles; an odd count runs one more tile, of zeros (loaded from past K)
  const int nk = (K + BK - 1) / BK, nk2 = (nk + 1) & ~1;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      for (int i = 0; i < nk2; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(empty + s, (i / S - 1) & 1);
        mbar_expect(full + s, Tl::STAGE);
        const int k0 = (i < nk ? i : nk) * BK;
        tma_load(x_tile(s), &xmap, full + s, k0, m0);
        tma_load(w_tile(s), &wmap, full + s, k0, n0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int g = lane >> 2, t4 = lane & 3;
  const int wr = wgi * 64 + warp * 16 + g;  // this thread's weight rows wr and wr + 8
  const uint32_t sel = (t4 & 1) ? 0x7632u : 0x5410u;
  // stage s's A fragments (wgmma.cuh) for rows wr, wr + 8: k = 2t, 2t + 1 and
  // 2t + 8, 2t + 9 of each 16; eight rows read eight distinct 16-byte bank groups
  auto convert = [&](int s, uint32_t* a) {
    const unsigned char* wd = w_tile(s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + 8 * h;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // 64-byte swizzle: 16-byte chunk kk of row r lies at kk ^ ((r >> 1) & 3)
        const uint4 v = *reinterpret_cast<const uint4*>(wd + r * BK + ((kk ^ (r >> 1)) & 3) * 16);
        const uint32_t lo = t4 < 2 ? v.x : v.y;  // k = 2t, 2t + 1: word t / 2
        const uint32_t hi = t4 < 2 ? v.z : v.w;  // k = 2t + 8, 2t + 9: word 2 + t / 2
        const uint32_t u = __byte_perm(lo, hi, sel) ^ 0x80808080u;
        a[4 * kk + h] = pack_exact(s8_to_f32<0>(u), s8_to_f32<1>(u));
        a[4 * kk + 2 + h] = pack_exact(s8_to_f32<2>(u), s8_to_f32<3>(u));
      }
    }
  };

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  uint32_t a0[16], a1[16];  // the fragments of two tiles in flight, by name
  auto step = [&](int i, uint32_t* a) {
    const int s = i % S;
    mbar_wait(full + s, (i / S) & 1);
    convert(s, a);  // under the products of tile i - 1
    const uint32_t xt = smem_addr(x_tile(s));
    oron::wg::fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // 128-byte swizzle: SBO 1,024, a k step 32 bytes
      oron::wg::wgmma_rs<BM>(acc, a + 4 * kk,
                             oron::wg::desc(xt + kk * 32, 16, 1024) | (1ull << 62));
    oron::wg::commit();
    oron::wg::wait<1>();  // tile i - 1's products: its stage and fragments are free
    if (i > 0 && (tid & 127) == 0) mbar_arrive(empty + (i + S - 1) % S);
  };
  // no branch around a wgmma: ptxas would serialise them all
  for (int i = 0; i < nk2; i += 2) {
    step(i, a0);
    step(i + 1, a1);
  }
  oron::wg::wait<0>();
  oron::wg::fence_regs<BM / 2>(acc);

  // acc[4j + 2h + e] is out[m0 + 8j + 2t + e][n0 + wr + 8h]
  if ((N & 7) == 0) {
    // stage the finished tile in the ring (every load has landed, and been
    // read once both warpgroups pass the barrier), then 16-byte stores
    __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring);
    consumers_sync();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = wr + 8 * h, col = n0 + n;
      const float sc = col < N ? scale[col] : 0.f;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          tile[(j * 8 + t4 * 2 + e) * OLD + n] =
              col < N ? finish(acc[4 * j + 2 * h + e], sc, bias, col) : __float2bfloat16_rn(0.f);
    }
    consumers_sync();
    for (int idx = tid; idx < BM * BN / 8; idx += 256) {
      const int m = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
      const int row = m0 + m, col = n0 + c;
      if (row < M && col < N)
        *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
            *reinterpret_cast<const uint4*>(tile + m * OLD + c);
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = n0 + wr + 8 * h;
    if (col >= N) continue;
    const float sc = scale[col];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + j * 8 + t4 * 2 + e;
        if (row >= M) continue;
        out[(size_t)row * N + col] = finish(acc[4 * j + 2 * h + e], sc, bias, col);
      }
  }
}

constexpr int FM = 64, FN = 64, FK = 16;
constexpr int FLD = FM + 4;

__global__ void __launch_bounds__(256)
qmm_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
        const float* __restrict__ scale, const float* __restrict__ bias,
        float* __restrict__ out, int M, int K, int N) {
  __shared__ float Xs[FK][FLD];  // k-major: the inner loop reads along m and n
  __shared__ float Ws[FK][FLD];

  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int srow = tid >> 2, sc = (tid & 3) * 4;  // staging: one row, four k a thread

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {
    const int gk = k0 + sc;
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + srow < M && gk < K)
      xv = *reinterpret_cast<const float4*>(x + (size_t)(m0 + srow) * K + gk);
    uint32_t wv = 0;
    if (n0 + srow < N && gk < K)
      wv = *reinterpret_cast<const uint32_t*>(w + (size_t)(n0 + srow) * K + gk);
    const uint32_t u = wv ^ 0x80808080u;
    Xs[sc + 0][srow] = xv.x;
    Xs[sc + 1][srow] = xv.y;
    Xs[sc + 2][srow] = xv.z;
    Xs[sc + 3][srow] = xv.w;
    Ws[sc + 0][srow] = s8_to_f32<0>(u);
    Ws[sc + 1][srow] = s8_to_f32<1>(u);
    Ws[sc + 2][srow] = s8_to_f32<2>(u);
    Ws[sc + 3][srow] = s8_to_f32<3>(u);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    if (col >= N) continue;
    const float s = scale[col];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row >= M) continue;
      const float y = __fmul_rn(acc[i][j], s);  // rounded before the bias, as the plain version
      out[(size_t)row * N + col] = bias != nullptr ? y + bias[col] : y;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 2D tensor map over `rows` rows of `inner` elements, `pitch` bytes apart;
// boxes land zero-filled past either edge. The driver's encoder is found once
// through the runtime, so the library links no driver library.
int tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int inner, int rows,
               size_t pitch, int box_inner, int box_rows, CUtensorMapSwizzle swizzle) {
  static const EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<EncodeTiled>(fn);
  }();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BM>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      qmm_wgmma<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)QmmTile<BM>::SMEM);
  return err;
}

template <int BM>
int launch_wgmma(const void* x, const void* w, const void* scale, const void* bias, void* out,
                 int M, int K, int N, cudaStream_t st) {
  CUtensorMap xmap, wmap;
  int rc = tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (size_t)K * 2, BK, BM,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, (size_t)K, BK, BN,
                    CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc != 0) return rc;
  cudaError_t err = allow_smem<BM>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_wgmma<BM><<<grid, THREADS, QmmTile<BM>::SMEM, st>>>(
      xmap, wmap, static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// bias: null or [N] in x's type. bf16: bm (x rows a block: 64, 128, 192, 256)
// is qmm_plan's. f32 ignores bm.
extern "C" int qmm_w8a16(const void* x, const void* w, const void* scale, const void* bias,
                         void* out, int M, int K, int N, int bm, int is_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (bm == 64) return launch_wgmma<64>(x, w, scale, bias, out, M, K, N, st);
    if (bm == 128) return launch_wgmma<128>(x, w, scale, bias, out, M, K, N, st);
    if (bm == 192) return launch_wgmma<192>(x, w, scale, bias, out, M, K, N, st);
    if (bm == 256) return launch_wgmma<256>(x, w, scale, bias, out, M, K, N, st);
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
  qmm_f32<<<grid, 256, 0, st>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

// Blocks of the bf16 kernel an SM holds at bm (the occupancy API)
template <int BM>
int blocks_per_sm() {
  int n = 0;
  cudaError_t err = allow_smem<BM>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, qmm_wgmma<BM>, THREADS,
                                                        QmmTile<BM>::SMEM);
  return err == cudaSuccess ? n : -(int)err;
}

extern "C" int qmm_blocks_per_sm(int bm) {
  switch (bm) {
    case 64: return blocks_per_sm<64>();
    case 128: return blocks_per_sm<128>();
    case 192: return blocks_per_sm<192>();
    case 256: return blocks_per_sm<256>();
    default: return -(int)cudaErrorInvalidValue;
  }
}
