// SAME-padded grouped 1-D convolution + bias + Mish for Hopper (sm_90a).
//
// Replaces the TPU kernel oron_tts_tpu/ops/grouped_conv.py:34 (_conv_kernel),
// the two k=31, groups=16 convs of ConvPositionEmbedding. x and y are
// [B, T, C]; the weight keeps the JAX layout [K, C/groups, C] (output
// channel o belongs to group o / (C/groups)); SAME padding puts K/2 zeros
// on the left and K-1-K/2 on the right. y = mish(conv(x) + bias), summed
// and activated in f32.
//
// The TPU kernel expands the weights into block-diagonal 128x128 lane
// tiles to feed its matrix unit; that trick is for the TPU's lanes and is
// not carried over. Here a block owns one slice of output channels of one
// group and one tile of rows, stages the slice's weights (transposed to
// [K][out][in]) and the [rows + K - 1, in] input window in shared memory
// once, and runs the K shifted products from there.
//
// Bound on the H100: ~2*T*C*(C/groups)*K flops over ~4*T*C bytes, some 500
// flops per byte in bf16, so the tensor cores. A whole group's weights are
// 31*64*64 bf16 = 254 KB, more than the 227 KB a block may hold, so a bf16
// block takes 32 of the group's 64 output channels (127 KB of weights) and
// 128 rows, and runs mma.sync m16n8k16 with f32 accumulators (4 warps,
// 32 rows x 32 channels each). f32 inputs take a SIMT kernel in true f32,
// 8 output channels and 64 rows per block.
#include "common.cuh"

namespace {

constexpr int BF_CIN = 64;          // input channels per group (bf16 path)
constexpr int BF_OUTS = 32;         // output channels per block
constexpr int BF_ROWS = 128;        // rows per block: 4 warps x 32
constexpr int BF_LD = BF_CIN + 8;   // padded smem row stride (bf16)

__global__ void __launch_bounds__(128)
gconv_bf16(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ w,
           const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
           int T, int C, int out_g, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [K][OUTS][LD]
  __nv_bfloat16* Xs = Ws + (size_t)K * BF_OUTS * BF_LD;             // [ROWS+K-1][LD]

  const int t0 = blockIdx.x * BF_ROWS;
  const int oc0 = blockIdx.y * BF_OUTS;
  const int b = blockIdx.z;
  const int ic0 = (oc0 / out_g) * BF_CIN;
  const int pad_l = K / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // weights: w[k][i][oc0 + o] -> Ws[k][o][i], 8 outputs per 16-byte load
  for (int idx = tid; idx < K * BF_CIN * (BF_OUTS / 8); idx += blockDim.x) {
    const int o8 = (idx % (BF_OUTS / 8)) * 8;
    const int ki = idx / (BF_OUTS / 8);
    const int kk = ki / BF_CIN, i = ki % BF_CIN;
    const uint4 val = *reinterpret_cast<const uint4*>(w + (size_t)ki * C + oc0 + o8);
    const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) Ws[((size_t)kk * BF_OUTS + o8 + j) * BF_LD + i] = vp[j];
  }
  // input window: rows t0 - pad_l .. t0 + ROWS + K - 2 - pad_l, zero outside [0, T)
  const int win = BF_ROWS + K - 1;
  for (int idx = tid; idx < win * (BF_CIN / 8); idx += blockDim.x) {
    const int r = idx / (BF_CIN / 8), c = (idx % (BF_CIN / 8)) * 8;
    const int t = t0 - pad_l + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t >= 0 && t < T)
      val = *reinterpret_cast<const uint4*>(x + ((size_t)b * T + t) * C + ic0 + c);
    *reinterpret_cast<uint4*>(&Xs[r * BF_LD + c]) = val;
  }
  __syncthreads();

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int kk = 0; kk < K; ++kk) {
#pragma unroll
    for (int ks = 0; ks < BF_CIN / 16; ++ks) {
      const int c = ks * 16 + t4 * 2;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int xr = warp * 32 + mt * 16 + g + kk;
        a[mt][0] = oron::ld32(&Xs[xr * BF_LD + c]);
        a[mt][1] = oron::ld32(&Xs[(xr + 8) * BF_LD + c]);
        a[mt][2] = oron::ld32(&Xs[xr * BF_LD + c + 8]);
        a[mt][3] = oron::ld32(&Xs[(xr + 8) * BF_LD + c + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* wr = &Ws[((size_t)kk * BF_OUTS + nt * 8 + g) * BF_LD + c];
        uint32_t bb[2] = {oron::ld32(wr), oron::ld32(wr + 8)};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) oron::mma_bf16_16816(acc[mt][nt], a[mt], bb);
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int oc = oc0 + nt * 8 + t4 * 2;
    const float b0 = bias[oc], b1 = bias[oc + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = t0 + warp * 32 + mt * 16 + g;
      if (row < T)
        *reinterpret_cast<uint32_t*>(y + ((size_t)b * T + row) * C + oc) =
            oron::pack_bf16(oron::mish(acc[mt][nt][0] + b0),
                            oron::mish(acc[mt][nt][1] + b1));
      if (row + 8 < T)
        *reinterpret_cast<uint32_t*>(y + ((size_t)b * T + row + 8) * C + oc) =
            oron::pack_bf16(oron::mish(acc[mt][nt][2] + b0),
                            oron::mish(acc[mt][nt][3] + b1));
    }
  }
}

constexpr int F_OUTS = 8;    // output channels per block (f32 path)
constexpr int F_ROWS = 64;   // rows per block; 256 threads, 2 rows each

__global__ void __launch_bounds__(256)
gconv_f32(const float* __restrict__ x, const float* __restrict__ w,
          const float* __restrict__ bias, float* __restrict__ y, int T, int C,
          int cin_g, int out_g, int K) {
  extern __shared__ float fsm[];
  float* Ws = fsm;                                   // [K][cin_g][OUTS]
  const int ldx = cin_g + 1;                         // padded: no bank conflicts
  float* Xs = Ws + (size_t)K * cin_g * F_OUTS;       // [ROWS+K-1][ldx]

  const int t0 = blockIdx.x * F_ROWS;
  const int oc0 = blockIdx.y * F_OUTS;
  const int b = blockIdx.z;
  const int ic0 = (oc0 / out_g) * cin_g;
  const int pad_l = K / 2;

  for (int idx = threadIdx.x; idx < K * cin_g * F_OUTS; idx += blockDim.x) {
    const int o = idx % F_OUTS, ki = idx / F_OUTS;
    Ws[idx] = w[(size_t)ki * C + oc0 + o];
  }
  const int win = F_ROWS + K - 1;
  for (int idx = threadIdx.x; idx < win * cin_g; idx += blockDim.x) {
    const int r = idx / cin_g, c = idx % cin_g;
    const int t = t0 - pad_l + r;
    Xs[r * ldx + c] = (t >= 0 && t < T) ? x[((size_t)b * T + t) * C + ic0 + c] : 0.f;
  }
  __syncthreads();

  const int o = threadIdx.x % F_OUTS, r = threadIdx.x / F_OUTS;  // r in [0, 32)
  float acc0 = 0.f, acc1 = 0.f;
  for (int kk = 0; kk < K; ++kk) {
    const float* x0 = &Xs[(r + kk) * ldx];
    const float* x1 = &Xs[(r + 32 + kk) * ldx];
    const float* wk = &Ws[(size_t)kk * cin_g * F_OUTS + o];
    for (int i = 0; i < cin_g; ++i) {
      const float wv = wk[i * F_OUTS];
      acc0 = fmaf(x0[i], wv, acc0);
      acc1 = fmaf(x1[i], wv, acc1);
    }
  }
  const int oc = oc0 + o;
  const float bo = bias[oc];
  if (t0 + r < T) y[((size_t)b * T + t0 + r) * C + oc] = oron::mish(acc0 + bo);
  if (t0 + r + 32 < T) y[((size_t)b * T + t0 + r + 32) * C + oc] = oron::mish(acc1 + bo);
}

}  // namespace

extern "C" int grouped_conv1d_mish(const void* x, const void* w, const void* bias,
                                   void* y, int B, int T, int C, int groups,
                                   int K, int is_bf16, void* stream) {
  const int cin_g = C / groups, out_g = C / groups;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    if (cin_g != BF_CIN || out_g % BF_OUTS) return (int)cudaErrorInvalidValue;
    const size_t smem =
        ((size_t)K * BF_OUTS + BF_ROWS + K - 1) * BF_LD * sizeof(__nv_bfloat16);
    err = cudaFuncSetAttribute(gconv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + BF_ROWS - 1) / BF_ROWS, C / BF_OUTS, B);
    gconv_bf16<<<grid, 128, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), T, C, out_g, K);
  } else {
    if (out_g % F_OUTS) return (int)cudaErrorInvalidValue;
    const size_t smem =
        ((size_t)K * cin_g * F_OUTS + (size_t)(F_ROWS + K - 1) * (cin_g + 1)) * sizeof(float);
    err = cudaFuncSetAttribute(gconv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + F_ROWS - 1) / F_ROWS, C / F_OUTS, B);
    gconv_f32<<<grid, 256, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), T, C, cin_g, out_g, K);
  }
  return (int)cudaGetLastError();
}
