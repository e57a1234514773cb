// SAME-padded grouped 1-D convolution + bias + Mish for Hopper (sm_90a).
//
// Replaces the TPU kernel oron_tts_tpu/ops/grouped_conv.py:34 (_conv_kernel),
// the two k=31, groups=16 convs of ConvPositionEmbedding. x and y are
// [B, T, C]; the weight keeps the JAX layout [K, C/groups, C] (output
// channel o belongs to group o / (C/groups)); SAME padding puts K/2 zeros
// on the left and K-1-K/2 on the right. y = mish(conv(x) + bias), summed
// and activated in f32, one bf16 rounding at the output.
//
// The TPU kernel expands the weights into block-diagonal 128x128 lane
// tiles to feed its matrix unit; that trick is for the TPU's lanes and is
// not carried over.
//
// Bound on the H100: 2*T*C*(C/groups)*K flops over ~4*T*C bytes, some 500
// flops per byte in bf16 at Base, so the tensor cores.
//
// Design (bf16, group widths N = 16, 32, 64 and 128, the widths the JAX rule
// sends to its kernel from 16 up, layers.py:220-225). Per group the conv is
// an implicit GEMM: M = rows, N = the group width (every one a wgmma N), and
// a contraction over K taps x N input channels. A block owns BM = 256 rows
// of one group of one batch row up to N = 64, and 128 rows at N = 128, where
// two m64n128 accumulators a warpgroup would not fit its registers: two
// warpgroups of 128 or 64 rows, each product wgmma m64nNk16 with both
// operands in shared memory in the canonical layout without swizzle
// (wgmma.cuh).
//   - The input window, rows t0 - K/2 .. t0 + BM + K' - 2 - K/2 (zeros
//     outside [0, T)), is staged once, channel-chunk major: [N/8][W][8] bf16.
//     Consecutive rows are then consecutive 16-byte lines, so the window
//     shifted by tap k is itself a K-major operand whose start moves by
//     16*k bytes (LBO W*16 bytes, SBO 128): no per-tap copy.
//   - The taps' weights w[k, :, group] stream through a ring of four slots,
//     128/N taps a slot (16 KB at N = 64), copied by cp.async from the JAX
//     layout in 16-byte pieces straight into the MN-major core matrices the
//     transpose bit reads: no host-side re-layout, as the weights change at
//     every training step. Copies run two slots ahead of the products; the
//     window lands with the first slot, so products start after it. Taps
//     past K (K' = K rounded up to whole slots) land as zero weights.
//   - Epilogue: bias and Mish in f32 on the accumulators (Mish with one
//     fast exponential and one fast division, common.cuh mish_bf16_out, as
//     the output is rounded to bf16), bf16 staged in shared memory (the
//     ring's bytes), then 16-byte coalesced stores.
// Measured on the H100 (PERF.md): 256-row blocks beat 128-row ones at every
// shape the DiT gives the conv; a deeper ring (more slots ahead, or more
// taps a slot) was no faster; the weights' copies and the epilogue, not the
// tensor work, hold the kernel at a quarter of its bound.
// Group widths 1, 2, 4 and 8 (dim 128 or less with 16 groups), too narrow for
// a useful wgmma tile, take the SIMT kernel in bf16: bf16 loads and stores,
// f32 sums, bias and Mish fused, 8 output channels (one group, or 8 / width
// whole groups) and 64 rows per block. f32 inputs take the same SIMT kernel
// in true f32 at any width that is a multiple of 8 or divides 8.
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wg = oron::wg;

constexpr int CONV_THREADS = 256;  // two warpgroups
constexpr int CONV_SLOTS = 4;      // weight ring slots
constexpr int CONV_AHEAD = 2;      // slots whose copies run ahead of the products

template <int N>
struct ConvRing {
  static constexpr int TAPS = N >= 128 ? 1 : 128 / N;  // taps a slot
  static constexpr int TAP = N * N;                    // one tap's weights, [N in][N out]
  static constexpr int SLOT = TAPS * TAP;              // bf16 elements
  static constexpr int LDY = N + 8;                    // the staged output's row stride
};

// window rows a block stages for K taps: BM + K' - 1
template <int N>
__host__ __device__ inline int conv_window(int bm, int K) {
  constexpr int TAPS = ConvRing<N>::TAPS;
  return bm + (K + TAPS - 1) / TAPS * TAPS - 1;
}

template <int N>
inline size_t conv_smem(int bm, int K) {
  return ((size_t)CONV_SLOTS * ConvRing<N>::SLOT + (size_t)conv_window<N>(bm, K) * N) *
         sizeof(bf16);
}

// Grid (ceil(T / BM), groups, B); BM = 128 * MT.
template <int N, int MT>
__global__ void __launch_bounds__(CONV_THREADS, 2)
gconv_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
            const float* __restrict__ bias, bf16* __restrict__ y, int T, int C, int K) {
  using R = ConvRing<N>;
  constexpr int BM = 128 * MT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // CONV_SLOTS x [TAPS][N/8 x N/8 cores]
  bf16* Xs = ring + CONV_SLOTS * R::SLOT;          // [N/8][W][8]
  const int n_slots = (K + R::TAPS - 1) / R::TAPS;
  const int W = conv_window<N>(BM, K);

  const int t0 = blockIdx.x * BM, c0 = blockIdx.y * N, b = blockIdx.z;  // c0: the group's
  const int pad_l = K / 2;                                               // first channel
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  for (int idx = tid; idx < W * (N / 8); idx += CONV_THREADS) {
    const int cb = idx % (N / 8), r = idx / (N / 8);
    const int t = t0 - pad_l + r;
    const bool ok = t >= 0 && t < T;
    wg::cp_async16(Xs + ((size_t)cb * W + r) * 8,
                   ok ? x + ((size_t)b * T + t) * C + c0 + cb * 8 : x, ok ? 16 : 0);
  }
  // slot s's taps: w[k, i, c0 + o] -> core (i, o) of tap k's MN-major tile
  auto issue = [&](int s) {
    bf16* dst = ring + (s % CONV_SLOTS) * R::SLOT;
    for (int idx = tid; idx < R::TAPS * N * (N / 8); idx += CONV_THREADS) {
      const int ob = idx % (N / 8), ki = idx / (N / 8);
      const int kt = ki / N, i = ki % N, k = s * R::TAPS + kt;
      const bool ok = k < K;
      wg::cp_async16(dst + kt * R::TAP + wg::core_offset<N>(i, ob * 8),
                     ok ? w + ((size_t)k * N + i) * C + c0 + ob * 8 : w, ok ? 16 : 0);
    }
    wg::cp_commit();  // an empty group past the last slot keeps the count
  };
#pragma unroll
  for (int s = 0; s < CONV_AHEAD; ++s) issue(s);  // the window lands with slot 0

  float acc[MT][N / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;
  const uint32_t xs = wg::smem_addr(Xs) + (wgi * 64 * MT) * 16;  // this warpgroup's rows
  // no branch around a wgmma: ptxas would serialise them all
  for (int s = 0; s < n_slots; ++s) {
    // slot s landed; every warpgroup is past the products of slot
    // s + AHEAD - SLOTS (the wait below), whose stage takes slot s + AHEAD
    wg::cp_wait<CONV_AHEAD - 1>();
    wg::fence_async_proxy();
    __syncthreads();
    if (s + CONV_AHEAD < n_slots) {
      issue(s + CONV_AHEAD);
    } else {
      wg::cp_commit();
    }
    const uint32_t wt = wg::smem_addr(ring + (s % CONV_SLOTS) * R::SLOT);
    wg::fence();
#pragma unroll
    for (int kt = 0; kt < R::TAPS; ++kt) {
      const int k = s * R::TAPS + kt;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint64_t db = wg::desc(wt + (kt * R::TAP + kk * 16 * 8) * 2, 128, N * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wg::wgmma_ss_tb<N>(acc[mt],
                             wg::desc(xs + ((2 * kk) * W + mt * 64 + k) * 16, W * 16, 128), db);
      }
    }
    wg::commit();
    wg::wait<CONV_SLOTS - CONV_AHEAD - 1>();
  }
  wg::wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) wg::fence_regs<N / 2>(acc[mt]);
  wg::cp_wait<0>();
  __syncthreads();  // every product is done: the ring's bytes take the output

  bf16* Ys = ring;  // [BM][LDY]
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    const float b0 = bias[c0 + col], b1 = bias[c0 + col + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = wgi * 64 * MT + mt * 64 + warp * 16 + g;
      *reinterpret_cast<uint32_t*>(&Ys[r * R::LDY + col]) = oron::pack_bf16(
          oron::mish_bf16_out(acc[mt][4 * j] + b0),
          oron::mish_bf16_out(acc[mt][4 * j + 1] + b1));
      *reinterpret_cast<uint32_t*>(&Ys[(r + 8) * R::LDY + col]) = oron::pack_bf16(
          oron::mish_bf16_out(acc[mt][4 * j + 2] + b0),
          oron::mish_bf16_out(acc[mt][4 * j + 3] + b1));
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BM * (N / 8); idx += CONV_THREADS) {
    const int r = idx / (N / 8), cb = idx % (N / 8);
    if (t0 + r < T)
      *reinterpret_cast<uint4*>(y + ((size_t)b * T + t0 + r) * C + c0 + cb * 8) =
          *reinterpret_cast<const uint4*>(&Ys[r * R::LDY + cb * 8]);
  }
}

template <int N, int MT>
cudaError_t launch_gconv_wgmma(const void* x, const void* w, const void* bias, void* y,
                               int B, int T, int C, int K, cudaStream_t st) {
  const size_t smem = conv_smem<N>(128 * MT, K);
  cudaError_t err = cudaFuncSetAttribute(
      gconv_wgmma<N, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + 128 * MT - 1) / (128 * MT), C / N, B);
  gconv_wgmma<N, MT><<<grid, CONV_THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(y), T, C, K);
  return cudaGetLastError();
}

template <int N, int MT>
int gconv_blocks(int K) {
  const size_t smem = conv_smem<N>(128 * MT, K);
  cudaError_t err = cudaFuncSetAttribute(
      gconv_wgmma<N, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gconv_wgmma<N, MT>, CONV_THREADS,
                                                      smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Calls fn(std::integral_constant<int, N>{}, std::integral_constant<int, MT>{})
// for group width N in {16, 32, 64, 128}: 256 rows a block (MT = 2) up to
// N = 64, 128 at N = 128.
template <typename Fn>
int with_conv_tile(int cin_g, Fn fn) {
  using std::integral_constant;
  switch (cin_g) {
    case 16: return fn(integral_constant<int, 16>{}, integral_constant<int, 2>{});
    case 32: return fn(integral_constant<int, 32>{}, integral_constant<int, 2>{});
    case 64: return fn(integral_constant<int, 64>{}, integral_constant<int, 2>{});
    case 128: return fn(integral_constant<int, 128>{}, integral_constant<int, 1>{});
    default: return -(int)cudaErrorInvalidValue;
  }
}

constexpr int F_OUTS = 8;    // output channels per block (SIMT path)
constexpr int F_ROWS = 64;   // rows per block; 256 threads, 2 rows each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Input channels a SIMT block stages: its group's, or, for a group width
// below 8, the 8 / width whole groups its 8 outputs belong to.
inline __host__ __device__ int simt_inputs(int cin_g) { return cin_g < F_OUTS ? F_OUTS : cin_g; }

// f32 arithmetic on f32 or bf16 storage; group widths that are multiples of
// 8 or divide 8 (1, 2, 4)
template <typename T>
__global__ void __launch_bounds__(256)
gconv_simt(const T* __restrict__ x, const T* __restrict__ w,
           const float* __restrict__ bias, T* __restrict__ y, int Tn, int C,
           int cin_g, int K) {
  extern __shared__ float fsm[];
  const int xc = simt_inputs(cin_g);
  float* Ws = fsm;                                   // [K][cin_g][OUTS]
  const int ldx = xc + 1;                            // padded: no bank conflicts
  float* Xs = Ws + (size_t)K * cin_g * F_OUTS;       // [ROWS+K-1][ldx]

  const int t0 = blockIdx.x * F_ROWS;
  const int oc0 = blockIdx.y * F_OUTS;
  const int b = blockIdx.z;
  const int ic0 = oc0 - oc0 % xc;  // the staged inputs (C/groups in = out)
  const int pad_l = K / 2;

  for (int idx = threadIdx.x; idx < K * cin_g * F_OUTS; idx += blockDim.x) {
    const int o = idx % F_OUTS, ki = idx / F_OUTS;
    Ws[idx] = to_f32(w[(size_t)ki * C + oc0 + o]);
  }
  const int win = F_ROWS + K - 1;
  for (int idx = threadIdx.x; idx < win * xc; idx += blockDim.x) {
    const int r = idx / xc, c = idx % xc;
    const int t = t0 - pad_l + r;
    Xs[r * ldx + c] = (t >= 0 && t < Tn) ? to_f32(x[((size_t)b * Tn + t) * C + ic0 + c]) : 0.f;
  }
  __syncthreads();

  const int o = threadIdx.x % F_OUTS, r = threadIdx.x / F_OUTS;  // r in [0, 32)
  const int xo = (oc0 + o) / cin_g * cin_g - ic0;                 // this output's group
  float acc0 = 0.f, acc1 = 0.f;
  for (int kk = 0; kk < K; ++kk) {
    const float* x0 = &Xs[(r + kk) * ldx + xo];
    const float* x1 = &Xs[(r + 32 + kk) * ldx + xo];
    const float* wk = &Ws[(size_t)kk * cin_g * F_OUTS + o];
    for (int i = 0; i < cin_g; ++i) {
      const float wv = wk[i * F_OUTS];
      acc0 = fmaf(x0[i], wv, acc0);
      acc1 = fmaf(x1[i], wv, acc1);
    }
  }
  const int oc = oc0 + o;
  const float bo = bias[oc];
  if (t0 + r < Tn) y[((size_t)b * Tn + t0 + r) * C + oc] = from_f32<T>(oron::mish(acc0 + bo));
  if (t0 + r + 32 < Tn)
    y[((size_t)b * Tn + t0 + r + 32) * C + oc] = from_f32<T>(oron::mish(acc1 + bo));
}

template <typename T>
cudaError_t launch_gconv_simt(const void* x, const void* w, const void* bias, void* y,
                              int B, int Tn, int C, int cin_g, int K, cudaStream_t st) {
  if (C % F_OUTS || (cin_g % F_OUTS && F_OUTS % cin_g)) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)K * cin_g * F_OUTS +
                       (size_t)(F_ROWS + K - 1) * (simt_inputs(cin_g) + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gconv_simt<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tn + F_ROWS - 1) / F_ROWS, C / F_OUTS, B);
  gconv_simt<T><<<grid, 256, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                         static_cast<const float*>(bias), static_cast<T*>(y),
                                         Tn, C, cin_g, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" int grouped_conv1d_mish(const void* x, const void* w, const void* bias,
                                   void* y, int B, int T, int C, int groups,
                                   int K, int is_bf16, void* stream) {
  const int cin_g = C / groups;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)launch_gconv_simt<float>(x, w, bias, y, B, T, C, cin_g, K, st);
  if (cin_g <= 8) return (int)launch_gconv_simt<bf16>(x, w, bias, y, B, T, C, cin_g, K, st);
  return with_conv_tile(cin_g, [&](auto n, auto mt) {
    return (int)launch_gconv_wgmma<decltype(n)::value, decltype(mt)::value>(x, w, bias, y, B, T,
                                                                            C, K, st);
  });
}

// Blocks of the bf16 wgmma kernel one SM holds at group width cin_g and K
// taps; a negative value is a CUDA error.
extern "C" int grouped_conv_blocks_per_sm(int cin_g, int K) {
  return with_conv_tile(cin_g, [&](auto n, auto mt) {
    return gconv_blocks<decltype(n)::value, decltype(mt)::value>(K);
  });
}
