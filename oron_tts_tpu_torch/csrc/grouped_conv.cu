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
// flops per byte in bf16 at Base, so the tensor cores. A bf16 block takes 32
// output channels and 128 rows, and runs mma.sync m16n8k16 with f32
// accumulators (4 warps, 32 rows x 32 channels each). The group width CIN
// (input channels per group, equal to the output channels per group) is a
// template parameter, 16, 32, 64 or 128, as the JAX package's rule sends any
// width dividing 128 to its kernel (layers.py:220-225): a narrower group
// stages fewer input channels and runs fewer mma k-steps; a width of 16 puts
// two groups in the block's 32 outputs, each reading its own 16 inputs. The
// taps' weights are staged in chunks that fit shared memory: all 31 taps up
// to width 64 (127 KB at 64), 18 at a time at 128. Group widths 1, 2, 4 and
// 8 (dim 128 or less with 16 groups), too narrow for a useful mma tile, take
// the SIMT kernel in bf16: bf16 loads and stores, f32 sums, bias and Mish
// fused, 8 output channels (one group, or 8 / width whole groups) and 64 rows
// per block. f32 inputs take the same SIMT kernel in true f32 at any width
// that is a multiple of 8 or divides 8.
#include "common.cuh"

namespace {

constexpr int BF_OUTS = 32;           // output channels per block
constexpr int BF_ROWS = 128;          // rows per block: 4 warps x 32
constexpr int W_STAGE_BYTES = 160 * 1024;  // weight chunk budget in smem

template <int CIN>
struct GConv {
  static constexpr int GPB = CIN >= BF_OUTS ? 1 : BF_OUTS / CIN;  // groups per block
  static constexpr int XC = GPB * CIN;  // input channels staged
  static constexpr int LDX = XC + 8;    // padded smem row strides (bf16)
  static constexpr int LDW = CIN + 8;
  static constexpr int TAP_ELEMS = BF_OUTS * LDW;
  static constexpr int TAPS = W_STAGE_BYTES / (TAP_ELEMS * 2);  // taps per chunk
};

template <int CIN>
__global__ void __launch_bounds__(128)
gconv_bf16(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ w,
           const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
           int T, int C, int K) {
  using G = GConv<CIN>;
  constexpr int LDX = G::LDX, LDW = G::LDW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int taps = K < G::TAPS ? K : G::TAPS;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [taps][OUTS][LDW]
  __nv_bfloat16* Xs = Ws + (size_t)taps * G::TAP_ELEMS;             // [ROWS+K-1][LDX]

  const int t0 = blockIdx.x * BF_ROWS;
  const int oc0 = blockIdx.y * BF_OUTS;
  const int b = blockIdx.z;
  const int ic0 = oc0 - oc0 % CIN;  // the first group's inputs (C/groups in = out)
  const int pad_l = K / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // input window: rows t0 - pad_l .. t0 + ROWS + K - 2 - pad_l, zero outside [0, T)
  const int win = BF_ROWS + K - 1;
  for (int idx = tid; idx < win * (G::XC / 8); idx += blockDim.x) {
    const int r = idx / (G::XC / 8), c = (idx % (G::XC / 8)) * 8;
    const int t = t0 - pad_l + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t >= 0 && t < T)
      val = *reinterpret_cast<const uint4*>(x + ((size_t)b * T + t) * C + ic0 + c);
    *reinterpret_cast<uint4*>(&Xs[r * LDX + c]) = val;
  }

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int kc = 0; kc < K; kc += taps) {
    const int n_taps = K - kc < taps ? K - kc : taps;
    __syncthreads();  // the previous chunk is no longer read
    // weights: w[k][i][oc0 + o] -> Ws[k - kc][o][i], 8 outputs per 16-byte load
    for (int idx = tid; idx < n_taps * CIN * (BF_OUTS / 8); idx += blockDim.x) {
      const int o8 = (idx % (BF_OUTS / 8)) * 8;
      const int ki = idx / (BF_OUTS / 8);
      const int kk = ki / CIN, i = ki % CIN;
      const uint4 val =
          *reinterpret_cast<const uint4*>(w + ((size_t)(kc + kk) * CIN + i) * C + oc0 + o8);
      const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Ws[((size_t)kk * BF_OUTS + o8 + j) * LDW + i] = vp[j];
    }
    __syncthreads();

    for (int kk = 0; kk < n_taps; ++kk) {
#pragma unroll
      for (int ks = 0; ks < CIN / 16; ++ks) {
        uint32_t a[G::GPB][2][4];
#pragma unroll
        for (int gi = 0; gi < G::GPB; ++gi) {
          const int c = gi * CIN + ks * 16 + t4 * 2;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int xr = warp * 32 + mt * 16 + g + kc + kk;
            a[gi][mt][0] = oron::ld32(&Xs[xr * LDX + c]);
            a[gi][mt][1] = oron::ld32(&Xs[(xr + 8) * LDX + c]);
            a[gi][mt][2] = oron::ld32(&Xs[xr * LDX + c + 8]);
            a[gi][mt][3] = oron::ld32(&Xs[(xr + 8) * LDX + c + 8]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          constexpr int OUT_G = CIN;
          const int gi = G::GPB == 1 ? 0 : (nt * 8) / OUT_G;
          const __nv_bfloat16* wr =
              &Ws[((size_t)kk * BF_OUTS + nt * 8 + g) * LDW + ks * 16 + t4 * 2];
          uint32_t bb[2] = {oron::ld32(wr), oron::ld32(wr + 8)};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) oron::mma_bf16_16816(acc[mt][nt], a[gi][mt], bb);
        }
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

template <int CIN>
cudaError_t launch_gconv_bf16(const void* x, const void* w, const void* bias, void* y,
                              int B, int T, int C, int K, cudaStream_t st) {
  using G = GConv<CIN>;
  const int taps = K < G::TAPS ? K : G::TAPS;
  const size_t smem = ((size_t)taps * G::TAP_ELEMS + (size_t)(BF_ROWS + K - 1) * G::LDX) *
                      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      gconv_bf16<CIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BF_ROWS - 1) / BF_ROWS, C / BF_OUTS, B);
  gconv_bf16<CIN><<<grid, 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), T, C, K);
  return cudaGetLastError();
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
  cudaError_t err;
  if (!is_bf16) {
    err = launch_gconv_simt<float>(x, w, bias, y, B, T, C, cin_g, K, st);
  } else if (cin_g <= 8) {
    err = launch_gconv_simt<__nv_bfloat16>(x, w, bias, y, B, T, C, cin_g, K, st);
  } else {
    if (C % BF_OUTS) return (int)cudaErrorInvalidValue;
    switch (cin_g) {
      case 16: err = launch_gconv_bf16<16>(x, w, bias, y, B, T, C, K, st); break;
      case 32: err = launch_gconv_bf16<32>(x, w, bias, y, B, T, C, K, st); break;
      case 64: err = launch_gconv_bf16<64>(x, w, bias, y, B, T, C, K, st); break;
      case 128: err = launch_gconv_bf16<128>(x, w, bias, y, B, T, C, K, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)err;
}
