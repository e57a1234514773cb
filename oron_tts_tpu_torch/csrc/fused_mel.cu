// Fused log-mel spectrogram for Hopper (sm_90a): frame -> window -> real
// FFT -> magnitude -> sparse mel filterbank -> log, in one pass over a batch.
//
// Replaces the TPU kernel oron_tts_tpu/ops/pallas_mel.py:26 (_mel_kernel).
// audio [B, L] f32 -> out [B, n_mels, 1 + L / hop] f32, with reflect padding
// of n_fft/2 on both sides (numpy's "reflect": the edge sample is not
// repeated, and a pad longer than the signal reflects again, period
// 2(L - 1); L = 1 repeats its sample), the padded Hann window, |rFFT| over
// n_fft/2 + 1 bins, the HTK filterbank and log(max(mel, log_clip)). No frame
// or spectrum goes through device memory.
//
// Bound on the H100: a real FFT (~2.5*n_fft*log2(n_fft) flops a frame) and
// ~1,000 filterbank taps make 0.03 GFLOP for 10 s at 24 kHz, ~0.4 us at the
// f32 CUDA-core rate, about the time the audio and output take to move. A
// launch alone takes a few us, so the kernel's time is one block's critical
// path: every step of it is short and stays in shared memory.
//
// Design. A block owns FR = 8 consecutive frames of one row, a warp a frame;
// the grid is frame blocks x B, so one launch covers the batch. The block
// stages its span of (FR - 1)*hop + n_fft samples once, reflected by the
// map above (frames overlap n_fft/hop times), with the window, the twiddles
// and the sparse filterbank. Each warp windows its frame into
// z[n] = x[2n] + i*x[2n+1] and runs the M = n_fft/2 point complex FFT as
// Stockham passes of radix 8 (then 4 or 2) in registers; each pass reads all
// of its butterflies' inputs before it writes, so one buffer of M complex
// values a warp serves every pass. The buffer is swizzled (index bits 0-4
// XOR a function of the row of 32) so that the passes read and write it with
// no bank conflict at n_fft 256 to 2048 (the first pass reads the span two
// words apart, even and odd samples). Twiddles come from a table built in
// float64 on the host and stored as f32, laid out [pass][r][k] so a warp
// reads consecutive words. The even/odd split gives X[k] and X[M - k] from
// Z[k] and Z[M - k] together; the magnitudes go back into the warp's
// buffer. Each mel band is summed over its run of non-zero bins only, in
// ascending bin order: bit for bit the dense sum in that order, since every
// skipped term adds +0. The logs are staged per mel row and stored as runs
// of FR frames. Every copy into shared memory is a cp.async, all issued at
// once; the first pass waits only for the span and the window.
//
// Everything is true f32 on the CUDA cores: no TF32, no bf16 (a bf16 DFT
// moves near-floor bins of the log-mel by ~0.27). n_fft is 256, 512, 1024
// or 2048 (template instances); the host checks it and the twiddle table's
// length before launch.
#include "common.cuh"
#include "wgmma.cuh"  // cp.async

namespace {

namespace wg = oron::wg;

constexpr int FR = 8;  // frames a block, one a warp
constexpr int THREADS = 32 * FR;
constexpr size_t MAX_SMEM = 232448;

// Radix of the M-point FFT's pass at sub-transform size ns: 8 while 8 fit.
__host__ __device__ constexpr int radix_at(int m, int ns) { return m / ns >= 8 ? 8 : m / ns; }

// Twiddles before the pass at ns: (R - 1) * ns for each earlier pass with ns > 1.
__host__ __device__ constexpr int twiddle_offset(int m, int ns) {
  int n = 0;
  for (int s = 1; s < ns; s *= radix_at(m, s))
    if (s > 1) n += (radix_at(m, s) - 1) * s;
  return n;
}

// The whole table: every pass's, then the split's W_N^k for k = 0..M/2.
__host__ __device__ constexpr int twiddle_count(int m) { return twiddle_offset(m, m) + m / 2 + 1; }

// Bank-conflict-free position of complex index i in a warp's buffer.
__device__ __forceinline__ int swz(int i) {
  const int row = i >> 5;
  return i ^ ((row & 7) | ((row << 2) & 24));
}

__device__ __forceinline__ void bfly(float& ar, float& ai, float& br, float& bi) {
  const float tr = ar - br, ti = ai - bi;
  ar += br;
  ai += bi;
  br = tr;
  bi = ti;
}

// In-place DFT of R points, natural order in and out.
template <int R>
__device__ __forceinline__ void dft(float* re, float* im);

template <>
__device__ __forceinline__ void dft<2>(float* re, float* im) {
  bfly(re[0], im[0], re[1], im[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float* re, float* im) {
  bfly(re[0], im[0], re[2], im[2]);
  bfly(re[1], im[1], re[3], im[3]);
  const float t = re[3];  // (x1 - x3) * -i
  re[3] = im[3];
  im[3] = -t;
  bfly(re[0], im[0], re[1], im[1]);  // X0, X2
  bfly(re[2], im[2], re[3], im[3]);  // X1, X3
  float s = re[1];
  re[1] = re[2];
  re[2] = s;
  s = im[1];
  im[1] = im[2];
  im[2] = s;
}

template <>
__device__ __forceinline__ void dft<8>(float* re, float* im) {
  // decimation in frequency: halves summed give the even outputs, halves
  // differenced and turned by W8^r the odd ones
  constexpr float c = 0.70710678118654752f;
  float e_re[4], e_im[4], o_re[4], o_im[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    e_re[r] = re[r] + re[r + 4];
    e_im[r] = im[r] + im[r + 4];
    o_re[r] = re[r] - re[r + 4];
    o_im[r] = im[r] - im[r + 4];
  }
  float a = o_re[1], b = o_im[1];  // * (c, -c)
  o_re[1] = c * (a + b);
  o_im[1] = c * (b - a);
  a = o_re[2];  // * -i
  o_re[2] = o_im[2];
  o_im[2] = -a;
  a = o_re[3], b = o_im[3];  // * (-c, -c)
  o_re[3] = c * (b - a);
  o_im[3] = -c * (a + b);
  dft<4>(e_re, e_im);
  dft<4>(o_re, o_im);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    re[2 * k] = e_re[k];
    im[2 * k] = e_im[k];
    re[2 * k + 1] = o_re[k];
    im[2 * k + 1] = o_im[k];
  }
}

// One Stockham pass at sub-transform size NS: butterfly j reads points
// j + r*M/R, turns them by W_{NS*R}^{r*(j % NS)}, and writes its DFT to
// (j / NS)*NS*R + j % NS + r*NS. The first pass reads the windowed frame.
template <int M, int NS, bool FIRST>
__device__ __forceinline__ void fft_pass(float* zr, float* zi, const float* x,
                                         const float* win, const float* twc,
                                         const float* tws, int lane) {
  constexpr int R = radix_at(M, NS);
  constexpr int NB = M / R;
  constexpr int BPT = (NB + 31) / 32;
  float re[BPT][R], im[BPT][R];
#pragma unroll
  for (int t = 0; t < BPT; ++t) {
    const int j = lane + 32 * t;
    if (NB % 32 != 0 && j >= NB) continue;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = j + r * NB;
      if constexpr (FIRST) {
        re[t][r] = x[2 * n] * win[2 * n];
        im[t][r] = x[2 * n + 1] * win[2 * n + 1];
      } else {
        re[t][r] = zr[swz(n)];
        im[t][r] = zi[swz(n)];
      }
    }
    if constexpr (NS > 1) {
      const int k = j % NS;
#pragma unroll
      for (int r = 1; r < R; ++r) {  // * (cos, -sin)
        const float c = twc[(r - 1) * NS + k], s = tws[(r - 1) * NS + k];
        const float a = re[t][r], b = im[t][r];
        re[t][r] = fmaf(a, c, b * s);
        im[t][r] = fmaf(b, c, -a * s);
      }
    }
    dft<R>(re[t], im[t]);
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < BPT; ++t) {
    const int j = lane + 32 * t;
    if (NB % 32 != 0 && j >= NB) continue;
    const int base = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      zr[swz(base + r * NS)] = re[t][r];
      zi[swz(base + r * NS)] = im[t][r];
    }
  }
  __syncwarp();
}

template <int M, int NS>
__device__ __forceinline__ void fft_rest(float* zr, float* zi, const float* twc,
                                         const float* tws, int lane) {
  if constexpr (NS < M) {
    constexpr int off = twiddle_offset(M, NS);
    fft_pass<M, NS, false>(zr, zi, nullptr, nullptr, twc + off, tws + off, lane);
    fft_rest<M, NS * radix_at(M, NS)>(zr, zi, twc, tws, lane);
  }
}

__device__ __forceinline__ int reflect(int p, int L) {
  if (L == 1) return 0;
  const int period = 2 * (L - 1);
  p %= period;
  if (p < 0) p += period;
  return p < L ? p : period - p;
}

template <int M>
__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ audio, int L, int n_frames, int hop,
               const float* __restrict__ window,   // [2M]
               const float* __restrict__ twiddle,  // [2][twiddle_count(M)]: cos, sin
               const int* __restrict__ bands,      // [3][n_mels]: first bin, count, offset
               const float* __restrict__ weights,  // [n_taps]
               int n_taps, int n_mels, float log_clip, float* __restrict__ out) {
  constexpr int N = 2 * M;
  constexpr int NT = twiddle_count(M);
  const int span = (FR - 1) * hop + N;
  extern __shared__ __align__(16) float sm[];
  float* buf = sm;                     // [FR][2M]: re, im; then the magnitudes
  float* xs = buf + FR * N;            // [span] reflected samples
  float* win = xs + span;              // [N]
  float* twc = win + N;                // [NT] cos
  float* tws = twc + NT;               // [NT] sin
  float* wts = tws + NT;               // [n_taps]
  int* bnd = reinterpret_cast<int*>(wts + n_taps);  // [3][n_mels]
  float* outs = reinterpret_cast<float*>(bnd + 3 * n_mels);  // [n_mels][FR + 1]

  const int fblocks = (n_frames + FR - 1) / FR;
  const int b = blockIdx.x / fblocks;
  const int f0 = (blockIdx.x % fblocks) * FR;
  const float* row = audio + (size_t)b * L;
  const int s0 = f0 * hop - N / 2;
  // every copy in flight at once: the span and the window (group 0), which
  // the first pass reads, then the tables (group 1)
  const bool inside = s0 >= 0 && s0 + span <= L;
  for (int i = threadIdx.x; i < span; i += THREADS) {
    const int p = s0 + i;
    wg::cp_async4(xs + i, row + (inside ? p : reflect(p, L)), 4);
  }
  for (int i = threadIdx.x; i < N; i += THREADS) wg::cp_async4(win + i, window + i, 4);
  wg::cp_commit();
  for (int i = threadIdx.x; i < 2 * NT; i += THREADS) wg::cp_async4(twc + i, twiddle + i, 4);
  for (int i = threadIdx.x; i < n_taps; i += THREADS) wg::cp_async4(wts + i, weights + i, 4);
  for (int i = threadIdx.x; i < 3 * n_mels; i += THREADS) wg::cp_async4(bnd + i, bands + i, 4);
  wg::cp_commit();
  wg::cp_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* zr = buf + warp * N;
  float* zi = zr + M;
  fft_pass<M, 1, true>(zr, zi, xs + warp * hop, win, nullptr, nullptr, lane);
  wg::cp_wait<0>();
  __syncthreads();
  fft_rest<M, radix_at(M, 1)>(zr, zi, twc, tws, lane);

  // split: E = (Z[k] + conj Z[M-k]) / 2, O = (Z[k] - conj Z[M-k]) / 2i,
  // X[k] = E + W^k O and X[M-k] = conj(E - W^k O), W = exp(-2 pi i / N)
  constexpr int KH = M / 2 + 1;
  constexpr int KT = (KH + 31) / 32;
  const float* spc = twc + twiddle_offset(M, M);
  const float* sps = tws + twiddle_offset(M, M);
  float lo[KT], hi[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int k = lane + 32 * t;
    if (k >= KH) continue;
    const int kc = (M - k) & (M - 1);
    const float ar = zr[swz(k)], ai = zi[swz(k)], cr = zr[swz(kc)], ci = zi[swz(kc)];
    const float er = 0.5f * (ar + cr), ei = 0.5f * (ai - ci);
    const float od_r = 0.5f * (ai + ci), od_i = 0.5f * (cr - ar);
    const float c = spc[k], s = sps[k];
    const float wr = fmaf(od_r, c, od_i * s), wi = fmaf(od_i, c, -od_r * s);
    lo[t] = sqrtf((er + wr) * (er + wr) + (ei + wi) * (ei + wi));
    hi[t] = sqrtf((er - wr) * (er - wr) + (ei - wi) * (ei - wi));
  }
  __syncwarp();
  float* mag = zr;  // [M + 1], over the re and im halves
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int k = lane + 32 * t;
    if (k >= KH) continue;
    mag[k] = lo[t];
    if (k < M / 2) mag[M - k] = hi[t];
  }
  __syncwarp();

  for (int m = lane; m < n_mels; m += 32) {
    const int first = bnd[m], count = bnd[n_mels + m], off = bnd[2 * n_mels + m];
    float acc = 0.f;
    for (int i = 0; i < count; ++i) acc = fmaf(mag[first + i], wts[off + i], acc);
    outs[m * (FR + 1) + warp] = logf(fmaxf(acc, log_clip));
  }
  __syncthreads();

  float* orow = out + (size_t)b * n_mels * n_frames;
  for (int i = threadIdx.x; i < n_mels * FR; i += THREADS) {
    const int m = i / FR, f = i % FR;
    if (f0 + f < n_frames) orow[(size_t)m * n_frames + f0 + f] = outs[m * (FR + 1) + f];
  }
}

template <int N>
int launch(const float* audio, int B, int L, const float* window, const float* twiddle,
           int n_twiddle, const int* bands, const float* weights, int n_taps, float* out,
           int n_frames, int hop, int n_mels, float log_clip, cudaStream_t stream) {
  constexpr int M = N / 2;
  if (n_twiddle != twiddle_count(M)) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)FR * N + (size_t)(FR - 1) * hop + N + N + 2 * twiddle_count(M) +
                       n_taps + 3 * (size_t)n_mels + (size_t)n_mels * (FR + 1)) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((n_frames + FR - 1) / FR) * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  log_mel_kernel<M><<<(unsigned)blocks, THREADS, smem, stream>>>(
      audio, L, n_frames, hop, window, twiddle, bands, weights, n_taps, n_mels, log_clip, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int log_mel_fused(const void* audio, int B, int L, const void* window,
                             const void* twiddle, int n_twiddle, const void* bands,
                             const void* weights, int n_taps, void* out, int n_frames,
                             int n_fft, int hop, int n_mels, float log_clip, void* stream) {
  if (B < 1 || L < 1 || hop < 1) return (int)cudaErrorInvalidValue;
  auto a = static_cast<const float*>(audio);
  auto w = static_cast<const float*>(window);
  auto tw = static_cast<const float*>(twiddle);
  auto bd = static_cast<const int*>(bands);
  auto wt = static_cast<const float*>(weights);
  auto o = static_cast<float*>(out);
  auto s = reinterpret_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 256:
      return launch<256>(a, B, L, w, tw, n_twiddle, bd, wt, n_taps, o, n_frames, hop, n_mels,
                          log_clip, s);
    case 512:
      return launch<512>(a, B, L, w, tw, n_twiddle, bd, wt, n_taps, o, n_frames, hop, n_mels,
                          log_clip, s);
    case 1024:
      return launch<1024>(a, B, L, w, tw, n_twiddle, bd, wt, n_taps, o, n_frames, hop, n_mels,
                           log_clip, s);
    case 2048:
      return launch<2048>(a, B, L, w, tw, n_twiddle, bd, wt, n_taps, o, n_frames, hop, n_mels,
                           log_clip, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
