// audiokit: native host-side audio frontend for the OronTTS dataloaders.
//
// Implements the framework's exact mel contract (reference
// src/utils/audio.py:50-58 — reflect-pad center, periodic Hann, onesided
// magnitude (power=1), HTK mel filterbank norm=None, log clamp 1e-5) in
// C++ so feature extraction in dataloader workers runs at compiled speed
// and fully releases the Python GIL (ctypes releases it around calls).
//
// Built at first use by oron_tts_tpu_torch/native/__init__.py with g++ into
// build/audiokit/ (the dataset falls back to the PyTorch log-mel on the host
// when no compiler is found).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ── iterative radix-2 complex FFT (in-place, n must be a power of two) ──

struct FFTPlan {
  int n = 0;
  std::vector<double> cos_tw, sin_tw;  // twiddles per stage, flattened
  std::vector<int> rev;

  explicit FFTPlan(int n_) : n(n_) {
    rev.resize(n);
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    for (int i = 0; i < n; ++i) {
      int r = 0;
      for (int b = 0; b < log2n; ++b)
        if (i & (1 << b)) r |= 1 << (log2n - 1 - b);
      rev[i] = r;
    }
    cos_tw.resize(n / 2);
    sin_tw.resize(n / 2);
    for (int k = 0; k < n / 2; ++k) {
      cos_tw[k] = std::cos(-2.0 * kPi * k / n);
      sin_tw[k] = std::sin(-2.0 * kPi * k / n);
    }
  }

  void run(double* re, double* im) const {
    for (int i = 0; i < n; ++i) {
      int j = rev[i];
      if (j > i) {
        std::swap(re[i], re[j]);
        std::swap(im[i], im[j]);
      }
    }
    for (int len = 2; len <= n; len <<= 1) {
      int half = len >> 1;
      int step = n / len;
      for (int start = 0; start < n; start += len) {
        for (int k = 0; k < half; ++k) {
          double wr = cos_tw[k * step], wi = sin_tw[k * step];
          int a = start + k, b = a + half;
          double xr = re[b] * wr - im[b] * wi;
          double xi = re[b] * wi + im[b] * wr;
          re[b] = re[a] - xr;
          im[b] = im[a] - xi;
          re[a] += xr;
          im[a] += xi;
        }
      }
    }
  }
};

// HTK mel filterbank matching torchaudio melscale_fbanks(norm=None, htk).
std::vector<float> mel_filterbank(int sr, int n_fft, int n_mels) {
  int n_freqs = n_fft / 2 + 1;
  auto hz2mel = [](double f) { return 2595.0 * std::log10(1.0 + f / 700.0); };
  auto mel2hz = [](double m) { return 700.0 * (std::pow(10.0, m / 2595.0) - 1.0); };

  std::vector<double> all_freqs(n_freqs);
  // torchaudio uses linspace(0, sr // 2, n_freqs)
  double fmax_grid = static_cast<double>(sr / 2);
  for (int i = 0; i < n_freqs; ++i)
    all_freqs[i] = fmax_grid * i / (n_freqs - 1);

  std::vector<double> f_pts(n_mels + 2);
  double m_lo = hz2mel(0.0), m_hi = hz2mel(sr / 2.0);
  for (int i = 0; i < n_mels + 2; ++i)
    f_pts[i] = mel2hz(m_lo + (m_hi - m_lo) * i / (n_mels + 1));

  std::vector<float> fb(static_cast<size_t>(n_freqs) * n_mels, 0.0f);
  for (int m = 0; m < n_mels; ++m) {
    double left = f_pts[m], center = f_pts[m + 1], right = f_pts[m + 2];
    for (int f = 0; f < n_freqs; ++f) {
      double up = (all_freqs[f] - left) / (center - left);
      double down = (right - all_freqs[f]) / (right - center);
      double w = std::min(up, down);
      if (w > 0.0) fb[static_cast<size_t>(f) * n_mels + m] = static_cast<float>(w);
    }
  }
  return fb;
}

}  // namespace

extern "C" {

// Number of mel frames produced for an audio of length n (center=True).
int64_t audiokit_mel_frames(int64_t n, int hop) { return 1 + n / hop; }

// Log-mel spectrogram. out must hold n_mels * (1 + n/hop) floats,
// written row-major as [n_mels][T].
// Returns 0 on success.
int audiokit_log_mel(const float* audio, int64_t n, int sr, int n_fft,
                     int hop, int win_length, int n_mels, float* out) {
  if (n <= 0 || n_fft <= 0 || (n_fft & (n_fft - 1)) != 0) return 1;
  int pad = n_fft / 2;
  if (n < pad + 1) return 2;  // reflect pad needs n > pad
  int64_t t_frames = 1 + n / hop;
  int n_freqs = n_fft / 2 + 1;

  // periodic hann, centered in the n_fft window
  std::vector<double> window(n_fft, 0.0);
  int offset = (n_fft - win_length) / 2;
  for (int i = 0; i < win_length; ++i)
    window[offset + i] = 0.5 - 0.5 * std::cos(2.0 * kPi * i / win_length);

  static thread_local FFTPlan* plan = nullptr;
  static thread_local int plan_n = 0;
  if (plan == nullptr || plan_n != n_fft) {
    delete plan;
    plan = new FFTPlan(n_fft);
    plan_n = n_fft;
  }
  std::vector<float> fb = mel_filterbank(sr, n_fft, n_mels);

  auto sample_at = [&](int64_t idx) -> double {
    // reflect padding: index into [-pad, n + pad)
    int64_t j = idx - pad;
    if (j < 0) j = -j;
    if (j >= n) j = 2 * (n - 1) - j;
    return audio[j];
  };

  std::vector<double> re(n_fft), im(n_fft);
  std::vector<double> mel_col(n_mels);
  for (int64_t t = 0; t < t_frames; ++t) {
    int64_t start = t * hop;
    for (int i = 0; i < n_fft; ++i) {
      re[i] = sample_at(start + i) * window[i];
      im[i] = 0.0;
    }
    plan->run(re.data(), im.data());
    std::fill(mel_col.begin(), mel_col.end(), 0.0);
    for (int f = 0; f < n_freqs; ++f) {
      double mag = std::sqrt(re[f] * re[f] + im[f] * im[f]);
      const float* row = &fb[static_cast<size_t>(f) * n_mels];
      for (int m = 0; m < n_mels; ++m) mel_col[m] += mag * row[m];
    }
    for (int m = 0; m < n_mels; ++m) {
      double v = mel_col[m] < 1e-5 ? 1e-5 : mel_col[m];
      out[static_cast<int64_t>(m) * t_frames + t] =
          static_cast<float>(std::log(v));
    }
  }
  return 0;
}

// Peak normalization with silence guard (reference audio.py:73-77).
void audiokit_normalize_peak(float* audio, int64_t n) {
  float peak = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    float a = std::fabs(audio[i]);
    if (a > peak) peak = a;
  }
  if (peak < 1e-8f) return;
  float inv = 1.0f / (peak + 1e-7f);
  for (int64_t i = 0; i < n; ++i) {
    float v = audio[i] * inv;
    audio[i] = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
  }
}

}  // extern "C"
