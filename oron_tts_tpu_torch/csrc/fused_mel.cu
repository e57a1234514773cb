// Fused log-mel spectrogram for Hopper (sm_90a): frame -> window -> real
// DFT -> magnitude -> mel filterbank -> log, in one pass.
//
// Replaces the TPU kernel oron_tts_tpu/ops/pallas_mel.py:26 (_mel_kernel).
// audio [L] f32 -> out [n_mels, 1 + L / hop] f32, with reflect padding of
// n_fft/2 on both sides (numpy's "reflect": the edge sample is not
// repeated), the padded Hann window, |rDFT| over n_fft/2 + 1 bins, the HTK
// filterbank [n_bins, n_mels] and log(max(mel, log_clip)).
//
// Everything is true f32 on the CUDA cores: no TF32, no bf16 (a bf16 DFT
// moves near-floor bins of the log-mel by ~0.27). A block owns 8 frames:
// it gathers their windowed samples into shared memory (sample-major, so
// one 16-byte load feeds four frames), runs the DFT with cos/sin taken
// from a one-period twiddle table (index k*n mod n_fft), keeps the 8 x 513
// magnitudes in shared memory and applies the filterbank and the log from
// there. No frame or spectrum goes through device memory.
//
// Bound on the H100: the function needs a real FFT (~2.5*n_fft*log2(n_fft)
// flops per frame) plus ~1000 filterbank taps, 0.03 GFLOP for 10 s at
// 24 kHz, or ~0.4 us at the f32 CUDA-core rate, about the time the audio
// and output take to move. This kernel runs the direct DFT instead,
// 4*n_fft*n_bins flops per frame (~70x an FFT's), which keeps it simple and
// exact in f32; an in-shared-memory radix FFT is the change to make when
// the mel matters for speed.
#include "common.cuh"

namespace {

constexpr int FR = 8;  // frames per block

__global__ void __launch_bounds__(256)
log_mel_kernel(const float* __restrict__ audio, int L,
               const float* __restrict__ window,
               const float* __restrict__ twiddle,  // [2][n_fft]: cos, sin
               const float* __restrict__ fb,       // [n_bins][n_mels]
               float* __restrict__ out, int n_frames, int n_fft, int hop,
               int n_mels, float log_clip) {
  extern __shared__ __align__(16) float sm[];
  const int n_bins = n_fft / 2 + 1;
  float* xs = sm;                          // [n_fft][FR] windowed samples
  float* tc = xs + (size_t)n_fft * FR;     // [n_fft] cos
  float* ts = tc + n_fft;                  // [n_fft] sin
  float* mag = ts + n_fft;                 // [FR][n_bins]

  const int f0 = blockIdx.x * FR;
  const int pad = n_fft / 2;
  for (int idx = threadIdx.x; idx < n_fft * FR; idx += blockDim.x) {
    const int n = idx / FR, f = idx % FR;
    float val = 0.f;
    if (f0 + f < n_frames) {
      int p = (f0 + f) * hop + n - pad;
      if (p < 0) p = -p;
      if (p >= L) p = 2 * (L - 1) - p;
      val = audio[p] * window[n];
    }
    xs[idx] = val;
  }
  for (int n = threadIdx.x; n < n_fft; n += blockDim.x) {
    tc[n] = twiddle[n];
    ts[n] = twiddle[n_fft + n];
  }
  __syncthreads();

  const int mask = n_fft - 1;  // n_fft is a power of two (checked by the host)
  for (int kb = threadIdx.x; kb < n_bins; kb += blockDim.x) {
    float re[FR], im[FR];
#pragma unroll
    for (int f = 0; f < FR; ++f) re[f] = im[f] = 0.f;
    int m = 0;
    for (int n = 0; n < n_fft; ++n) {
      const float c = tc[m], s = ts[m];
      const float4 xa = *reinterpret_cast<const float4*>(&xs[n * FR]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[n * FR + 4]);
      const float xv[FR] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int f = 0; f < FR; ++f) {
        re[f] = fmaf(xv[f], c, re[f]);
        im[f] = fmaf(xv[f], s, im[f]);
      }
      m = (m + kb) & mask;
    }
#pragma unroll
    for (int f = 0; f < FR; ++f) mag[f * n_bins + kb] = sqrtf(re[f] * re[f] + im[f] * im[f]);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < n_mels * FR; idx += blockDim.x) {
    const int f = idx / n_mels, mm = idx % n_mels;
    if (f0 + f >= n_frames) continue;
    const float* mg = &mag[f * n_bins];
    float acc = 0.f;
    for (int kb = 0; kb < n_bins; ++kb) acc = fmaf(mg[kb], fb[kb * n_mels + mm], acc);
    out[(size_t)mm * n_frames + f0 + f] = logf(fmaxf(acc, log_clip));
  }
}

}  // namespace

extern "C" int log_mel_fused(const void* audio, int L, const void* window,
                             const void* twiddle, const void* fb, void* out,
                             int n_frames, int n_fft, int hop, int n_mels,
                             float log_clip, void* stream) {
  if (n_fft & (n_fft - 1)) return (int)cudaErrorInvalidValue;
  const int n_bins = n_fft / 2 + 1;
  const size_t smem = ((size_t)n_fft * FR + 2 * n_fft + (size_t)FR * n_bins) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_frames + FR - 1) / FR);
  log_mel_kernel<<<grid, 256, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), L, static_cast<const float*>(window),
      static_cast<const float*>(twiddle), static_cast<const float*>(fb),
      static_cast<float*>(out), n_frames, n_fft, hop, n_mels, log_clip);
  return (int)cudaGetLastError();
}
