// AdaLN-Zero's elementwise work around a DiT block's two sublayers, forward and
// backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package writes AdaLN as plain jnp
// (oron_tts_tpu/models/layers.py AdaLayerNorm, DiTBlock) and XLA fuses it. The
// port's eager form launched ~30 bf16 kernels a block for it; these are 3 row
// passes forward and 3 backward, each backward followed by one small sum.
//
// The three passes, on x, y [B, T, dim] and modulation rows [1 or B, dim]
// (LN is a LayerNorm without scale or bias, eps 1e-6):
//   kModulate             h = LN(x) * (1 + scale) + shift
//   kGateResidualModulate x1 = x + gate * y;  h = LN(x1) * (1 + scale) + shift
//   kGateResidual         x1 = x + gate * y
// Everything is computed in f32 from the stored inputs and rounded once at the
// store; the LayerNorm reads x1 as stored (rounded), as the eager form and the
// backward do. The forward keeps each row's mean and rstd (f32 [2, rows]) in
// place of the normalised row, and the backward recomputes x_hat from them.
// The backward of kGateResidualModulate adds the gradient reaching x1 from the
// residual stream in the same pass: dx = dx1 + LN'(dh * (1 + scale)),
// dy = gate * dx. Modulation rows are read by stride (0: one row for every
// batch row), so no broadcast copy is made.
//
// Bound on the H100: bytes. A row is read once and written once per tensor,
// against a few f32 operations an element, so the design is about memory: one
// warp a row, 16-byte loads and stores, neighbouring lanes on neighbouring
// addresses, the row held in registers between the statistics (warp-shuffle
// sums in f32, two passes over the registers) and the output; a CTA takes rows
// of one batch row only, so it loads that row's modulation once.
//
// The modulation gradients (d scale, d shift, d gate: sums over a batch row's
// T rows) are deterministic: each CTA of the backward sums its tile's rows per
// column in registers, adds its warps together through shared memory in warp
// order, and writes one f32 partial row per quantity; adaln_sum then adds a
// batch row's tiles in tile order (every tile, for a single modulation row).
// No float atomics, so a training step stays a function of its seeds.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kEps = 1e-6f;

enum Op : int { kModulate = 0, kGateResidualModulate = 1, kGateResidual = 2 };

// 16 bytes of storage as f32 values: 4 f32 or 8 bf16.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float (&f)[N]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static float2 pair(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  }
  __device__ static void unpack(const uint4& r, float (&f)[N]) {
    const float2 a = pair(r.x), b = pair(r.y), c = pair(r.z), d = pair(r.w);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
    f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(oron::pack_bf16(f[0], f[1]), oron::pack_bf16(f[2], f[3]),
                      oron::pack_bf16(f[4], f[5]), oron::pack_bf16(f[6], f[7]));
  }
};

template <typename T>
__device__ __forceinline__ uint4 ld(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ void st(T* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// Every lane ends with the same bits: partners add the same two numbers.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* x;     // kModulate: x; kGateResidualModulate: x forward, x1 backward
  const void* y;     // the sublayer's output
  const void* dh;    // backward: the gradient of h
  const void* dres;  // backward: the gradient of x1
  void* out;         // forward: h
  void* x1;          // forward: x + gate * y
  void* dx;
  void* dy;
  float* stats;      // [2, rows]: mean, rstd
  float* partials;   // backward: [tiles, Q, dim] f32
  const void* gate;
  const void* scale;
  const void* shift;
  long long gate_stride, scale_stride, shift_stride;  // elements between modulation rows
  long long rows;
  int seq, dim, tiles_per_b, tile_rows;
};

// The quantities a backward sums over rows, in partial order: scale, shift, gate.
template <int OP>
constexpr int kSums = OP == kModulate ? 2 : OP == kGateResidualModulate ? 3 : 1;

// This lane's vectors of a row: v = lane + 32 k for k < NV, those below nvec.
template <typename T, int NV, int OP>
__global__ void __launch_bounds__(kThreads) adaln_fwd_kernel(const Args a) {
  using P = Pack<T>;
  constexpr int N = P::N;
  constexpr bool kGate = OP != kModulate;
  constexpr bool kNorm = OP != kGateResidual;
  const int nvec = a.dim / N;
  const int b = blockIdx.x / a.tiles_per_b;
  const int t0 = (blockIdx.x % a.tiles_per_b) * a.tile_rows;
  const int t1 = min(a.seq, t0 + a.tile_rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* x = static_cast<const T*>(a.x);
  const T* y = static_cast<const T*>(a.y);
  const T* gate = static_cast<const T*>(a.gate) + b * a.gate_stride;
  const T* scale = static_cast<const T*>(a.scale) + b * a.scale_stride;
  const T* shift = static_cast<const T*>(a.shift) + b * a.shift_stride;

  uint4 g_raw[NV], s_raw[NV], sh_raw[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = lane + 32 * k;
    if (v < nvec) {
      if (kGate) g_raw[k] = ld(gate + v * N);
      if (kNorm) {
        s_raw[k] = ld(scale + v * N);
        sh_raw[k] = ld(shift + v * N);
      }
    }
  }

  for (int t = t0 + warp; t < t1; t += kWarps) {
    const long long row = (long long)b * a.seq + t;
    const size_t base = (size_t)row * a.dim;
    float v[NV][N];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (lane + 32 * k) * N;
      if (lane + 32 * k < nvec) {
        P::unpack(ld(x + base + c), v[k]);
        if (kGate) {
          float yv[N], gv[N];
          P::unpack(ld(y + base + c), yv);
          P::unpack(g_raw[k], gv);
#pragma unroll
          for (int j = 0; j < N; ++j) v[k][j] += gv[j] * yv[j];
          const uint4 r = P::pack(v[k]);
          st(static_cast<T*>(a.x1) + base + c, r);
          P::unpack(r, v[k]);  // the LayerNorm reads x1 as stored
        }
#pragma unroll
        for (int j = 0; j < N; ++j) sum += v[k][j];
      }
    }
    if (!kNorm) continue;
    const float mean = warp_sum(sum) / a.dim;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane + 32 * k < nvec) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float d = v[k][j] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / a.dim + kEps);
    if (lane == 0) {
      a.stats[row] = mean;
      a.stats[a.rows + row] = rstd;
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (lane + 32 * k) * N;
      if (lane + 32 * k < nvec) {
        float sv[N], shv[N], o[N];
        P::unpack(s_raw[k], sv);
        P::unpack(sh_raw[k], shv);
#pragma unroll
        for (int j = 0; j < N; ++j) o[j] = (v[k][j] - mean) * rstd * (1.f + sv[j]) + shv[j];
        st(static_cast<T*>(a.out) + base + c, P::pack(o));
      }
    }
  }
}

template <typename T, int NV, int OP>
__global__ void __launch_bounds__(kThreads) adaln_bwd_kernel(const Args a) {
  using P = Pack<T>;
  constexpr int N = P::N;
  constexpr int Q = kSums<OP>;
  constexpr bool kGate = OP != kModulate;
  constexpr bool kNorm = OP != kGateResidual;
  constexpr int QG = kNorm ? 2 : 0;  // where d gate sits among the sums
  extern __shared__ __align__(16) float tile_sum[];  // [dim]
  const int nvec = a.dim / N;
  const int b = blockIdx.x / a.tiles_per_b;
  const int t0 = (blockIdx.x % a.tiles_per_b) * a.tile_rows;
  const int t1 = min(a.seq, t0 + a.tile_rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* x = static_cast<const T*>(a.x);
  const T* y = static_cast<const T*>(a.y);
  const T* dh = static_cast<const T*>(a.dh);
  const T* dres = static_cast<const T*>(a.dres);
  const T* gate = static_cast<const T*>(a.gate) + b * a.gate_stride;
  const T* scale = static_cast<const T*>(a.scale) + b * a.scale_stride;

  uint4 g_raw[NV], s_raw[NV];
  float part[Q][NV][N];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = lane + 32 * k;
    if (v < nvec) {
      if (kGate) g_raw[k] = ld(gate + v * N);
      if (kNorm) s_raw[k] = ld(scale + v * N);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int j = 0; j < N; ++j) part[q][k][j] = 0.f;
  }

  for (int t = t0 + warp; t < t1; t += kWarps) {
    const long long row = (long long)b * a.seq + t;
    const size_t base = (size_t)row * a.dim;
    if constexpr (!kNorm) {  // dy = gate * dres; d gate += dres * y (dx is dres itself)
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = (lane + 32 * k) * N;
        if (lane + 32 * k < nvec) {
          float rv[N], yv[N], gv[N], o[N];
          P::unpack(ld(dres + base + c), rv);
          P::unpack(ld(y + base + c), yv);
          P::unpack(g_raw[k], gv);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            o[j] = gv[j] * rv[j];
            part[QG][k][j] += rv[j] * yv[j];
          }
          st(static_cast<T*>(a.dy) + base + c, P::pack(o));
        }
      }
    } else {
      const float mean = a.stats[row], rstd = a.stats[a.rows + row];
      // every load of the row at once: one round trip to memory a row, not two
      uint4 x_raw[NV], dh_raw[NV], r_raw[NV], y_raw[NV];
      float sg = 0.f, sgx = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = (lane + 32 * k) * N;
        if (lane + 32 * k < nvec) {
          x_raw[k] = ld(x + base + c);
          dh_raw[k] = ld(dh + base + c);
          if constexpr (OP == kGateResidualModulate) {
            r_raw[k] = ld(dres + base + c);
            y_raw[k] = ld(y + base + c);
          }
          float xv[N], hv[N], sv[N];
          P::unpack(x_raw[k], xv);
          P::unpack(dh_raw[k], hv);
          P::unpack(s_raw[k], sv);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float g = hv[j] * (1.f + sv[j]);
            sg += g;
            sgx += g * ((xv[j] - mean) * rstd);
          }
        }
      }
      sg = warp_sum(sg) / a.dim;
      sgx = warp_sum(sgx) / a.dim;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = (lane + 32 * k) * N;
        if (lane + 32 * k < nvec) {
          float xv[N], hv[N], sv[N], d[N];
          P::unpack(x_raw[k], xv);
          P::unpack(dh_raw[k], hv);
          P::unpack(s_raw[k], sv);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float xh = (xv[j] - mean) * rstd;
            d[j] = rstd * (hv[j] * (1.f + sv[j]) - sg - xh * sgx);
            part[0][k][j] += hv[j] * xh;
            part[1][k][j] += hv[j];
          }
          if constexpr (OP == kModulate) {
            st(static_cast<T*>(a.dx) + base + c, P::pack(d));
          } else {
            float rv[N], yv[N], gv[N], o[N];
            P::unpack(r_raw[k], rv);
            P::unpack(y_raw[k], yv);
            P::unpack(g_raw[k], gv);
#pragma unroll
            for (int j = 0; j < N; ++j) {
              d[j] += rv[j];  // the residual stream's gradient joins x1's
              o[j] = gv[j] * d[j];
              part[QG][k][j] += d[j] * yv[j];
            }
            st(static_cast<T*>(a.dx) + base + c, P::pack(d));
            st(static_cast<T*>(a.dy) + base + c, P::pack(o));
          }
        }
      }
    }
  }

  // The tile's sums: warp 0's, then warp 1's added, and so on, then one row out,
  // each lane's columns as 16-byte vectors (two-way bank conflicts at most).
  float* out = a.partials + (size_t)blockIdx.x * Q * a.dim;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          if (lane + 32 * k < nvec) {
            float4* sum4 = reinterpret_cast<float4*>(tile_sum + (lane + 32 * k) * N);
#pragma unroll
            for (int j = 0; j < N / 4; ++j) {
              float4 v = make_float4(part[q][k][4 * j], part[q][k][4 * j + 1],
                                     part[q][k][4 * j + 2], part[q][k][4 * j + 3]);
              if (w > 0) {
                const float4 o = sum4[j];
                v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
              }
              sum4[j] = v;
            }
          }
        }
      }
      __syncthreads();
    }
    for (int c = threadIdx.x * 4; c < a.dim; c += kThreads * 4)
      *reinterpret_cast<float4*>(out + (size_t)q * a.dim + c) =
          *reinterpret_cast<const float4*>(tile_sum + c);
    __syncthreads();
  }
}

// out[q, m, c] = sum over the tiles of modulation row m (every tile when there is
// one row) of partials[tile, q, c], in tile order, rounded once to T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
adaln_sum_kernel(const float* __restrict__ partials, T* __restrict__ out, int q_count,
                 int dim, int tiles, int tiles_per_row, int mods_rows) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int m = blockIdx.y, q = blockIdx.z;
  if (c >= dim) return;
  const int j0 = mods_rows == 1 ? 0 : m * tiles_per_row;
  const int j1 = mods_rows == 1 ? tiles : j0 + tiles_per_row;
  float s = 0.f;
  for (int j = j0; j < j1; ++j) s += partials[((size_t)j * q_count + q) * dim + c];
  if constexpr (sizeof(T) == 2)
    out[((size_t)q * mods_rows + m) * dim + c] = __float2bfloat16_rn(s);
  else
    out[((size_t)q * mods_rows + m) * dim + c] = s;
}

template <typename T, int NV>
int launch_at(int op, bool backward, const Args& a, unsigned grid, cudaStream_t st) {
  const size_t smem = backward ? (size_t)a.dim * sizeof(float) : 0;
#define ORON_ADALN(OP)                                           \
  if (backward)                                                  \
    adaln_bwd_kernel<T, NV, OP><<<grid, kThreads, smem, st>>>(a); \
  else                                                           \
    adaln_fwd_kernel<T, NV, OP><<<grid, kThreads, 0, st>>>(a)
  switch (op) {
    case kModulate: ORON_ADALN(kModulate); break;
    case kGateResidualModulate: ORON_ADALN(kGateResidualModulate); break;
    case kGateResidual: ORON_ADALN(kGateResidual); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ORON_ADALN
  return (int)cudaGetLastError();
}

// NV, the vectors a lane holds of a row: the least power of two with 32 NV N >= dim.
template <typename T>
int launch(int op, bool backward, const Args& a, cudaStream_t st) {
  const int per_lane = (a.dim / Pack<T>::N + 31) / 32;
  const unsigned grid = (unsigned)(a.rows / a.seq) * (unsigned)a.tiles_per_b;
  if (per_lane <= 1) return launch_at<T, 1>(op, backward, a, grid, st);
  if (per_lane <= 2) return launch_at<T, 2>(op, backward, a, grid, st);
  if (per_lane <= 4) return launch_at<T, 4>(op, backward, a, grid, st);
  if (per_lane <= 8) return launch_at<T, 8>(op, backward, a, grid, st);
  if (per_lane <= 16) return launch_at<T, 16>(op, backward, a, grid, st);
  return (int)cudaErrorInvalidValue;
}

int run(int op, bool backward, Args a, int batch, int is_bf16, cudaStream_t st) {
  if (batch == 0 || a.seq == 0) return 0;
  if (a.dim % 8 != 0 || a.tile_rows <= 0) return (int)cudaErrorInvalidValue;
  a.rows = (long long)batch * a.seq;
  a.tiles_per_b = (a.seq + a.tile_rows - 1) / a.tile_rows;
  return is_bf16 ? launch<__nv_bfloat16>(op, backward, a, st) : launch<float>(op, backward, a, st);
}

}  // namespace

// x, y, out, x1: [batch, seq, dim] contiguous, 16-byte aligned, dim a multiple of
// 8 (at most 16 * 32 * 8 for bf16, 16 * 32 * 4 for f32). gate, scale, shift: a
// modulation row's dim values contiguous, rows *_stride elements apart (0: one
// row for every batch row). stats: f32 [2, batch * seq]. A CTA takes tile_rows
// rows of one batch row. Pointers an op does not use may be null.
extern "C" int adaln_fwd(int op, const void* x, const void* y, void* out, void* x1,
                         void* stats, const void* gate, long long gate_stride,
                         const void* scale, long long scale_stride, const void* shift,
                         long long shift_stride, int batch, int seq, int dim, int tile_rows,
                         int is_bf16, void* stream) {
  Args a{};
  a.x = x; a.y = y; a.out = out; a.x1 = x1; a.stats = static_cast<float*>(stats);
  a.gate = gate; a.scale = scale; a.shift = shift;
  a.gate_stride = gate_stride; a.scale_stride = scale_stride; a.shift_stride = shift_stride;
  a.seq = seq; a.dim = dim; a.tile_rows = tile_rows;
  return run(op, false, a, batch, is_bf16, reinterpret_cast<cudaStream_t>(stream));
}

// The backward of op, then the fixed-order sum: x (x1 for kGateResidualModulate),
// y, dh (the gradient of h), dres (the gradient of x1), stats as the forward wrote
// them; dx, dy out; partials f32 [batch * ceil(seq / tile_rows), Q, dim] scratch;
// dmods [Q, mods_rows, dim] out in the storage type, Q the op's sums in the order
// scale, shift, gate (those it has).
extern "C" int adaln_bwd(int op, const void* x, const void* y, const void* dh,
                         const void* dres, const void* stats, const void* gate,
                         long long gate_stride, const void* scale, long long scale_stride,
                         void* dx, void* dy, void* partials, void* dmods, int mods_rows,
                         int batch, int seq, int dim, int tile_rows, int is_bf16,
                         void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Args a{};
  a.x = x; a.y = y; a.dh = dh; a.dres = dres; a.dx = dx; a.dy = dy;
  a.stats = const_cast<float*>(static_cast<const float*>(stats));
  a.partials = static_cast<float*>(partials);
  a.gate = gate; a.scale = scale;
  a.gate_stride = gate_stride; a.scale_stride = scale_stride;
  a.seq = seq; a.dim = dim; a.tile_rows = tile_rows;
  int err = run(op, true, a, batch, is_bf16, st);
  if (err != 0 || batch == 0 || seq == 0) return err;
  const int q_count = op == kModulate ? 2 : op == kGateResidualModulate ? 3 : 1;
  const int tiles_per_row = (seq + tile_rows - 1) / tile_rows;
  const dim3 grid((dim + kThreads - 1) / kThreads, mods_rows, q_count);
  const float* p = static_cast<const float*>(partials);
  if (is_bf16)
    adaln_sum_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        p, static_cast<__nv_bfloat16*>(dmods), q_count, dim, batch * tiles_per_row,
        tiles_per_row, mods_rows);
  else
    adaln_sum_kernel<float><<<grid, kThreads, 0, st>>>(
        p, static_cast<float*>(dmods), q_count, dim, batch * tiles_per_row, tiles_per_row,
        mods_rows);
  return (int)cudaGetLastError();
}
