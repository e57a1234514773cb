"""Generate a synthetic speech-like corpus for vocoder training and evaluation.

    python -m oron_tts_tpu_torch.cli.make_synthetic_speech --out data/synth_speech -n 1500
    python -m oron_tts_tpu_torch.cli.make_synthetic_speech --family ood -n 40 --seed 123 \\
        --out data/synth_ood

Counterpart of the JAX package's ``scripts/make_synthetic_speech.py``: the
same numpy draws in the same order, so a seed, family and
``--augment-prob`` give the same WAV bytes and ``metadata.json`` (its
``audio_path`` aside). The ``train`` family is glottal-style harmonic
sources with drifting f0 under time-varying formant filters, fricative noise
and pauses, plus a share of sweeps and coloured noise for spectral coverage;
``ood`` is a structurally different generator (a glottal pulse train through
IIR resonators, plosives, breath, a reverb tail) for out-of-distribution
scores. Pure numpy and scipy; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from oron_tts_tpu_torch.data.wav import write_wav

SR = 24000
N_FFT, HOP = 1024, 256


def _formant_envelope(rng: np.random.Generator, n_frames: int) -> np.ndarray:
    """[n_frames, n_bins] smooth time-varying vocal-tract-ish filter."""
    freqs = np.fft.rfftfreq(N_FFT, 1 / SR)
    n_formants = rng.integers(3, 6)
    centers = np.sort(rng.uniform(300, 4500, n_formants))
    bws = rng.uniform(80, 300, n_formants)
    amps = rng.uniform(0.4, 1.0, n_formants)
    # slow random drift of each formant center over the clip
    drift = np.cumsum(rng.normal(0, 8.0, (n_frames, n_formants)), axis=0)
    env = np.zeros((n_frames, len(freqs)))
    for j in range(n_formants):
        c = centers[j] + drift[:, j]
        env += amps[j] * np.exp(
            -0.5 * ((freqs[None, :] - c[:, None]) / bws[j]) ** 2
        )
    # spectral tilt like glottal sources
    tilt = (1.0 + freqs / 500.0) ** -rng.uniform(0.3, 0.9)
    return (env + 0.03) * tilt[None, :]


def _stft_filter(x: np.ndarray, env: np.ndarray) -> np.ndarray:
    """Overlap-add filtering with the per-frame magnitude envelope."""
    window = np.hanning(N_FFT + 1)[:-1]
    n_frames = env.shape[0]
    need = (n_frames - 1) * HOP + N_FFT
    x = np.pad(x, (0, max(0, need - len(x))))[:need]
    idx = np.arange(n_frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
    spec = np.fft.rfft(x[idx] * window, axis=-1) * env
    frames = np.fft.irfft(spec, n=N_FFT, axis=-1) * window
    out = np.zeros(need)
    norm = np.zeros(need)
    np.add.at(out, idx.ravel(), frames.ravel())
    np.add.at(norm, idx.ravel(), np.tile(window**2, n_frames))
    return out / np.maximum(norm, 1e-8)


def speech_clip(rng: np.random.Generator, seconds: float) -> np.ndarray:
    n = int(SR * seconds)
    t = np.arange(n) / SR
    # f0 contour: random walk in log space, speaker range
    f0_base = rng.uniform(85, 320)
    walk = np.cumsum(rng.normal(0, 0.004, n))
    walk -= np.linspace(0, walk[-1], n)  # zero net drift
    f0 = f0_base * np.exp(walk + 0.05 * np.sin(2 * np.pi * rng.uniform(3, 6) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    rolloff = rng.uniform(0.6, 1.4)
    voiced = np.zeros(n)
    for h in range(1, int(8000 / f0_base)):
        voiced += np.sin(h * phase + rng.uniform(0, 2 * np.pi)) / h**rolloff
    # unvoiced source: white noise; mix per-segment
    noise = rng.standard_normal(n)
    # voicing pattern: syllable-rate segments, some unvoiced, some silent
    seg_len = int(SR * rng.uniform(0.08, 0.25))
    mix = np.zeros(n)
    amp = np.zeros(n)
    pos = 0
    while pos < n:
        ln = min(seg_len + rng.integers(-seg_len // 3, seg_len // 3 + 1),
                 n - pos)
        kind = rng.random()
        if kind < 0.55:      # voiced
            mix[pos:pos + ln] = rng.uniform(0.85, 1.0)
            amp[pos:pos + ln] = rng.uniform(0.5, 1.0)
        elif kind < 0.8:     # unvoiced (fricative-ish)
            mix[pos:pos + ln] = rng.uniform(0.0, 0.15)
            amp[pos:pos + ln] = rng.uniform(0.15, 0.5)
        else:                # pause
            amp[pos:pos + ln] = 0.0
        pos += ln
    # smooth the gates (10 ms)
    k = int(0.01 * SR)
    kernel = np.hanning(2 * k + 1)
    kernel /= kernel.sum()
    mix = np.convolve(mix, kernel, mode="same")
    amp = np.convolve(amp, kernel, mode="same")
    source = mix * voiced + (1 - mix) * noise * 0.5
    source *= amp

    n_frames = 1 + max(0, (n - N_FFT)) // HOP
    env = _formant_envelope(rng, n_frames)
    out = _stft_filter(source, env)[:n]
    peak = np.abs(out).max()
    return (out / peak * rng.uniform(0.5, 0.95)).astype(np.float32) \
        if peak > 0 else out.astype(np.float32)


def ood_speech_clip(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Out-of-distribution speech-like clip (``--family ood``).

    Deliberately a DIFFERENT synthesis mechanism from :func:`speech_clip`
    so the two corpora have different joint magnitude/phase statistics —
    vocoder metrics on this family are evidence of generalization beyond
    the training distribution, not memorization of it:
    - time-domain glottal pulse train with jitter/shimmer (speech_clip
      stacks harmonic sines with random phases),
    - cascade of 2nd-order IIR resonators (speech_clip filters STFT
      magnitudes frame-wise; IIR has causal phase),
    - plosive bursts + aspiration, breathy voicing, f0 declination with
      accent peaks (speech_clip uses a zero-drift random walk),
    - a short exponential reverb tail.
    """
    n = int(SR * seconds)
    # f0: declining baseline + accent peaks (different dynamics family)
    f0_base = rng.uniform(90, 280)
    decl = np.linspace(1.15, 0.85, n)
    accents = np.zeros(n)
    for _ in range(int(seconds * rng.uniform(1.0, 3.0))):
        c = rng.integers(0, n)
        w = int(SR * rng.uniform(0.05, 0.2))
        lo, hi = max(0, c - w), min(n, c + w)
        accents[lo:hi] += rng.uniform(0.05, 0.25) * np.hanning(hi - lo)
    f0 = f0_base * decl * (1 + accents)

    # glottal pulse train with jitter (period perturbation) and shimmer
    # (amplitude perturbation); pulses are asymmetric (LF-ish shape)
    source = np.zeros(n)
    pos = 0
    while pos < n - 8:
        period = SR / f0[pos] * (1 + rng.normal(0, 0.02))  # jitter
        p_len = max(8, int(period))
        open_len = max(4, int(p_len * rng.uniform(0.4, 0.7)))
        pulse = np.zeros(p_len)
        ph = np.linspace(0, np.pi, open_len)
        pulse[:open_len] = np.sin(ph) ** 2 * np.linspace(1, 0.2, open_len)
        amp = 1 + rng.normal(0, 0.08)  # shimmer
        end = min(pos + p_len, n)
        source[pos:end] += amp * pulse[: end - pos]
        pos += p_len
    # differentiate -> glottal flow derivative (spectral tilt)
    source = np.diff(source, prepend=0.0)

    # voicing/energy gating at syllable rate, with plosives + fricatives
    seg_len = int(SR * rng.uniform(0.06, 0.22))
    x = np.zeros(n)
    pos = 0
    while pos < n:
        ln = min(seg_len + int(rng.integers(-seg_len // 3, seg_len // 3 + 1)),
                 n - pos)
        kind = rng.random()
        seg = slice(pos, pos + ln)
        if kind < 0.5:       # breathy voiced: pulses + aspiration noise
            breath = rng.uniform(0.05, 0.25)
            x[seg] = source[seg] + breath * rng.standard_normal(ln)
            x[seg] *= rng.uniform(0.5, 1.0)
        elif kind < 0.68:    # fricative: shaped noise only
            x[seg] = rng.standard_normal(ln) * rng.uniform(0.1, 0.4)
        elif kind < 0.8 and ln > int(0.03 * SR):  # plosive: gap + burst
            burst_at = pos + ln // 2
            blen = int(SR * rng.uniform(0.005, 0.02))
            x[burst_at: burst_at + blen] = (
                rng.standard_normal(min(blen, n - burst_at))
                * np.exp(-np.arange(min(blen, n - burst_at)) / (0.004 * SR))
                * rng.uniform(0.5, 1.2)
            )
        # else: silence
        pos += ln

    # cascade IIR resonators (vocal tract); different center statistics too
    from scipy.signal import lfilter

    n_res = int(rng.integers(3, 6))
    centers = np.sort(rng.uniform(250, 5200, n_res))
    y = x
    for c in centers:
        bw = rng.uniform(60, 250)
        r = np.exp(-np.pi * bw / SR)
        theta = 2 * np.pi * c / SR
        b0 = (1 - r) * np.sqrt(1 - 2 * r * np.cos(2 * theta) + r * r)
        y = 0.55 * y + lfilter([b0], [1, -2 * r * np.cos(theta), r * r], y)

    # short exponential reverb tail (none in the training family)
    tail = int(SR * rng.uniform(0.02, 0.08))
    ir = rng.standard_normal(tail) * np.exp(-np.arange(tail) / (tail / 4))
    ir[0] = 1.0
    y = np.convolve(y, ir * rng.uniform(0.05, 0.2), mode="full")[:n] + y

    peak = np.abs(y).max()
    return (y / peak * rng.uniform(0.5, 0.95)).astype(np.float32) \
        if peak > 0 else y.astype(np.float32)


def augment_clip(rng: np.random.Generator, x: np.ndarray) -> np.ndarray:
    """Recording-condition augmentations over a training-family clip.

    Widens the vocoder-training distribution toward what real recordings
    add on top of clean speech — the bundled default was trained on the
    clean train family only and its OOD gap (EVAL.json) is partly these
    conditions. Each effect is applied independently with probability
    1/2; the chain stays structurally distinct from the ood family's
    generator (no glottal-pulse source, no IIR resonator cascade, no
    dense exponential reverb tail — reflections here are a few discrete
    taps):

      - additive colored noise at SNR 12-40 dB
      - spectral tilt EQ (±~3 dB/octave)
      - 1-3 discrete early reflections at 8-60 ms, gain 0.08-0.35
      - lowpass bandlimiting to 4-10 kHz
      - level diversity (peak 0.2-0.95) with occasional soft clipping
    """
    n = len(x)
    if rng.random() < 0.5:  # colored noise at a draw of SNR
        spec = np.fft.rfft(rng.standard_normal(n))
        freqs = np.maximum(np.fft.rfftfreq(n, 1 / SR), 1.0)
        noise = np.fft.irfft(spec * freqs ** rng.uniform(-1.0, 0.2), n=n)
        snr_db = rng.uniform(12.0, 40.0)
        sig_rms = np.sqrt(np.mean(x**2)) + 1e-8
        noise_rms = np.sqrt(np.mean(noise**2)) + 1e-8
        x = x + noise * (sig_rms / noise_rms) * 10 ** (-snr_db / 20)
    if rng.random() < 0.5:  # spectral tilt
        spec = np.fft.rfft(x)
        freqs = np.maximum(np.fft.rfftfreq(n, 1 / SR), 30.0)
        tilt_db_oct = rng.uniform(-3.0, 3.0)
        x = np.fft.irfft(
            spec * (freqs / 1000.0) ** (tilt_db_oct / 6.02), n=n
        )
    if rng.random() < 0.5:  # a few discrete early reflections
        y = x.copy()
        for _ in range(int(rng.integers(1, 4))):
            delay = int(SR * rng.uniform(0.008, 0.06))
            gain = rng.uniform(0.08, 0.35) * rng.choice([-1.0, 1.0])
            y[delay:] += gain * x[: n - delay]
        x = y
    if rng.random() < 0.5:  # bandlimited recording chain
        cutoff = rng.uniform(4000.0, 10000.0)
        spec = np.fft.rfft(x)
        freqs = np.fft.rfftfreq(n, 1 / SR)
        spec *= 1.0 / (1.0 + (freqs / cutoff) ** 8)
        x = np.fft.irfft(spec, n=n)
    peak = np.abs(x).max() + 1e-8
    target = rng.uniform(0.2, 0.95)
    x = x / peak * target
    if rng.random() < 0.15:  # mild soft clipping (hot input gain)
        drive = rng.uniform(1.2, 2.5)
        x = np.tanh(x * drive) / np.tanh(drive) * target
    return x.astype(np.float32)


def coverage_clip(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Sweeps / colored noise / tone stacks: mel-space coverage fillers."""
    n = int(SR * seconds)
    t = np.arange(n) / SR
    kind = rng.integers(0, 3)
    if kind == 0:  # exponential chirp
        f0, f1 = sorted(rng.uniform(60, 8000, 2))
        ph = 2 * np.pi * f0 * (np.exp(t / seconds * np.log(f1 / f0)) - 1) \
            * seconds / np.log(f1 / f0)
        x = np.sin(ph)
    elif kind == 1:  # colored noise
        spec = np.fft.rfft(rng.standard_normal(n))
        freqs = np.maximum(np.fft.rfftfreq(n, 1 / SR), 1.0)
        x = np.fft.irfft(spec * freqs ** rng.uniform(-1.0, 0.3), n=n)
    else:  # tone stack with AM
        x = np.zeros(n)
        for _ in range(rng.integers(2, 6)):
            f = rng.uniform(80, 6000)
            x += rng.uniform(0.2, 1.0) * np.sin(
                2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
        x *= 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1, 8) * t))
    x = x / np.abs(x).max() * rng.uniform(0.4, 0.95)
    return x.astype(np.float32)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description="Synthetic speech-like corpus (numpy)")
    ap.add_argument("--out", type=str, default="data/synth_speech")
    ap.add_argument("-n", "--num-clips", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--coverage-fraction", type=float, default=0.15)
    ap.add_argument("--family", type=str, default="train", choices=["train", "ood"],
                    help="'train' = the vocoder-training distribution; 'ood' = a "
                         "structurally different generator for out-of-distribution "
                         "evaluation (no coverage fillers)")
    ap.add_argument("--augment-prob", type=float, default=0.0,
                    help="Probability of passing a train-family clip through the "
                         "recording-condition augmentation chain (noise/EQ/reflections/"
                         "bandlimit/level; see augment_clip). Ignored for --family ood.")
    args = ap.parse_args(argv)

    out = Path(args.out)
    (out / "wavs").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    meta = []
    total = 0.0
    for i in range(args.num_clips):
        seconds = float(rng.uniform(2.0, 5.0))
        if args.family == "ood":
            clip = ood_speech_clip(rng, seconds)
        elif rng.random() < args.coverage_fraction:
            clip = coverage_clip(rng, seconds)
        else:
            clip = speech_clip(rng, seconds)
        if args.family != "ood" and rng.random() < args.augment_prob:
            clip = augment_clip(rng, clip)
        path = out / "wavs" / f"clip_{i:05d}.wav"
        write_wav(path, clip, SR)
        meta.append({"audio_path": str(path), "text": "", "lang": "mn",
                     "speaker_id": int(i % 64)})
        total += seconds
        if (i + 1) % 200 == 0:
            print(f"{i + 1}/{args.num_clips} ({total/60:.1f} min)", flush=True)
    (out / "metadata.json").write_text(json.dumps(meta))
    print(f"wrote {args.num_clips} clips, {total/3600:.2f} h -> {out}")
    return meta


if __name__ == "__main__":
    main()
