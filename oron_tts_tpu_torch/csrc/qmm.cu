// w8a16 matrix product for Hopper (sm_90a): out = (x @ dequant(Wq)) * scale.
//
// Replaces the TPU kernel oron_tts_tpu/ops/quantized_matmul.py:55 (_qmm_kernel),
// the six int8 projections of every DiT block under mode="int8". It computes
// what that kernel computes, in its order: int8 -> x's type (exact, |q| <= 127),
// the product with f32 accumulation, times scale[n] in f32, one cast to x's
// type. The bias is added by the module afterwards.
//
// Layout. x is [M, K] row-major, out [M, N]. The weight is stored [N, K] int8
// with K contiguous -- nn.Linear's layout, and what an mma.sync B fragment
// wants (two consecutive k of one output column in a 32-bit register). The JAX
// package stores [K, N]; the weight loader transposes once at load.
//
// Bound on the H100: 2*M*K*N operations over M*K*2 + N*K + M*N*2 bytes. At the
// serving shapes (M = 1,664 and up, K and N 1,024 or 4,096) that is hundreds of
// operations per byte, so the tensor cores. The weight never exists in device
// memory in x's type: a block reads an int8 tile (half the bytes of bf16),
// converts it once while staging it into shared memory, and every warp's B
// fragments are then plain 32-bit shared-memory loads. The TPU kernel's pad of
// M to 8, its 512-blocks and its VMEM limit are the TPU's and are not carried
// over; ragged M and N are masked here, and K must be a multiple of 16 (one
// 16-byte load of int8).
//
// bf16: 128 x 128 output tile per block of 8 warps (32 x 64 each), K in steps
// of 64, mma.sync m16n8k16 with f32 accumulators; the next tile's global loads
// are started into registers before the current tile's products. f32: a SIMT
// kernel in true f32 (64 x 64 tile, 4 x 4 outputs per thread).
#include "common.cuh"

namespace {

// byte i of `biased` (= word ^ 0x80808080, so u = q + 128) -> float(q), exactly:
// 0x4B0000uu is the float 2^23 + u, and 2^23 + 128 is subtracted from it
template <int I>
__device__ __forceinline__ float s8_to_f32(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + I)) - 8388736.f;
}

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LD = BK + 8;  // 144-byte shared rows: fragment loads hit 32 distinct banks

__global__ void __launch_bounds__(256, 2)
qmm_bf16(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
         const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
         int M, int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 Xs[BM * LD];
  __shared__ __align__(16) __nv_bfloat16 Ws[BN * LD];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // staging: x tile 128 x 64 bf16 = 1024 16-byte vectors (4 a thread), w tile
  // 128 x 64 int8 = 512 vectors (2 a thread); outside M, N or K they are zero
  uint4 xr[4], wr[2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256, gm = m0 + (idx >> 3), gk = k0 + (idx & 7) * 8;
      xr[i] = (gm < M && gk < K)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * 256, gn = n0 + (idx >> 2), gk = k0 + (idx & 3) * 16;
      wr[i] = (gn < N && gk < K)
                  ? *reinterpret_cast<const uint4*>(w + (size_t)gn * K + gk)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256;
      *reinterpret_cast<uint4*>(&Xs[(idx >> 3) * LD + (idx & 7) * 8]) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * 256;
      const uint32_t words[4] = {wr[i].x, wr[i].y, wr[i].z, wr[i].w};
      uint32_t o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t u = words[j] ^ 0x80808080u;
        o[2 * j] = oron::pack_bf16(s8_to_f32<0>(u), s8_to_f32<1>(u));
        o[2 * j + 1] = oron::pack_bf16(s8_to_f32<2>(u), s8_to_f32<3>(u));
      }
      uint4* dst = reinterpret_cast<uint4*>(&Ws[(idx >> 2) * LD + (idx & 3) * 16]);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tile();
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int c = ks * 16 + t4 * 2;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm + mt * 16 + g;
        a[mt][0] = oron::ld32(&Xs[r * LD + c]);
        a[mt][1] = oron::ld32(&Xs[(r + 8) * LD + c]);
        a[mt][2] = oron::ld32(&Xs[r * LD + c + 8]);
        a[mt][3] = oron::ld32(&Xs[(r + 8) * LD + c + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* wrow = &Ws[(wn + nt * 8 + g) * LD + c];
        const uint32_t bb[2] = {oron::ld32(wrow), oron::ld32(wrow + 8)};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) oron::mma_bf16_16816(acc[mt][nt], a[mt], bb);
      }
    }
    __syncthreads();
  }

  const bool paired = (N & 1) == 0;  // a 32-bit store needs an even row stride
  auto store2 = [&](int row, int col, float v0, float v1) {
    if (row >= M || col >= N) return;
    __nv_bfloat16* p = out + (size_t)row * N + col;
    if (paired) {
      *reinterpret_cast<uint32_t*>(p) = oron::pack_bf16(v0, v1);
    } else {
      p[0] = __float2bfloat16_rn(v0);
      if (col + 1 < N) p[1] = __float2bfloat16_rn(v1);
    }
  };
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + wn + nt * 8 + t4 * 2;
    const float s0 = col < N ? scale[col] : 0.f;
    const float s1 = col + 1 < N ? scale[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = m0 + wm + mt * 16 + g;
      store2(row, col, acc[mt][nt][0] * s0, acc[mt][nt][1] * s1);
      store2(row + 8, col, acc[mt][nt][2] * s0, acc[mt][nt][3] * s1);
    }
  }
}

constexpr int FM = 64, FN = 64, FK = 16;
constexpr int FLD = FM + 4;

__global__ void __launch_bounds__(256)
qmm_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
        const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N) {
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
      if (row < M) out[(size_t)row * N + col] = acc[i][j] * s;
    }
  }
}

}  // namespace

extern "C" int qmm_w8a16(const void* x, const void* w, const void* scale, void* out,
                         int M, int K, int N, int is_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    qmm_bf16<<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M, K, N);
  } else {
    dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    qmm_f32<<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  }
  return (int)cudaGetLastError();
}
