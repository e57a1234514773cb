"""Seeded speech-like audio and PCM16 WAV bytes, for the benchmark's inputs.

``speech_clip`` is the synthetic speech of the port's
``cli/make_synthetic_speech.py`` (glottal-style harmonics with a drifting
f0, syllable-rate voiced, unvoiced and silent segments, a time-varying
formant filter), copied so that the yardstick does not move with the
program.
"""

from __future__ import annotations

import struct

import numpy as np

SR = 24000
N_FFT, HOP = 1024, 256


def _formant_envelope(rng: np.random.Generator, n_frames: int) -> np.ndarray:
    freqs = np.fft.rfftfreq(N_FFT, 1 / SR)
    n_formants = rng.integers(3, 6)
    centers = np.sort(rng.uniform(300, 4500, n_formants))
    bws = rng.uniform(80, 300, n_formants)
    amps = rng.uniform(0.4, 1.0, n_formants)
    drift = np.cumsum(rng.normal(0, 8.0, (n_frames, n_formants)), axis=0)
    env = np.zeros((n_frames, len(freqs)))
    for j in range(n_formants):
        c = centers[j] + drift[:, j]
        env += amps[j] * np.exp(-0.5 * ((freqs[None, :] - c[:, None]) / bws[j]) ** 2)
    tilt = (1.0 + freqs / 500.0) ** -rng.uniform(0.3, 0.9)
    return (env + 0.03) * tilt[None, :]


def _stft_filter(x: np.ndarray, env: np.ndarray) -> np.ndarray:
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
    np.add.at(norm, idx.ravel(), np.tile(window ** 2, n_frames))
    return out / np.maximum(norm, 1e-8)


def speech_clip(rng: np.random.Generator, seconds: float) -> np.ndarray:
    n = int(SR * seconds)
    t = np.arange(n) / SR
    f0_base = rng.uniform(85, 320)
    walk = np.cumsum(rng.normal(0, 0.004, n))
    walk -= np.linspace(0, walk[-1], n)
    f0 = f0_base * np.exp(walk + 0.05 * np.sin(2 * np.pi * rng.uniform(3, 6) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    rolloff = rng.uniform(0.6, 1.4)
    voiced = np.zeros(n)
    for h in range(1, int(8000 / f0_base)):
        voiced += np.sin(h * phase + rng.uniform(0, 2 * np.pi)) / h ** rolloff
    noise = rng.standard_normal(n)
    seg_len = int(SR * rng.uniform(0.08, 0.25))
    mix = np.zeros(n)
    amp = np.zeros(n)
    pos = 0
    while pos < n:
        ln = min(seg_len + rng.integers(-seg_len // 3, seg_len // 3 + 1), n - pos)
        kind = rng.random()
        if kind < 0.55:
            mix[pos:pos + ln] = rng.uniform(0.85, 1.0)
            amp[pos:pos + ln] = rng.uniform(0.5, 1.0)
        elif kind < 0.8:
            mix[pos:pos + ln] = rng.uniform(0.0, 0.15)
            amp[pos:pos + ln] = rng.uniform(0.15, 0.5)
        else:
            amp[pos:pos + ln] = 0.0
        pos += ln
    k = int(0.01 * SR)
    kernel = np.hanning(2 * k + 1)
    kernel /= kernel.sum()
    mix = np.convolve(mix, kernel, mode="same")
    amp = np.convolve(amp, kernel, mode="same")
    source = (mix * voiced + (1 - mix) * noise * 0.5) * amp
    n_frames = 1 + max(0, (n - N_FFT)) // HOP
    out = _stft_filter(source, _formant_envelope(rng, n_frames))[:n]
    peak = np.abs(out).max()
    return ((out / peak * rng.uniform(0.5, 0.95)) if peak > 0 else out).astype(np.float32)


def pcm16_wav(samples: np.ndarray, sr: int = SR) -> bytes:
    """Mono float samples in [-1, 1] → RIFF/WAVE PCM16 bytes."""
    data = np.round(np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, sr, sr * 2, 2, 16)
    return (struct.pack("<4sI4s", b"RIFF", 36 + len(data), b"WAVE")
            + struct.pack("<4sI", b"fmt ", 16) + fmt + struct.pack("<4sI", b"data", len(data))
            + data)


def wav_pcm16(data: bytes) -> tuple[np.ndarray, int]:
    """RIFF/WAVE PCM16 mono bytes → (int16 samples, sample rate); ValueError otherwise."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE body")
    pos, fmt, pcm = 12, None, None
    while pos + 8 <= len(data):
        cid, size = struct.unpack("<4sI", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None or fmt[0] != 1 or fmt[1] != 1 or fmt[5] != 16:
        raise ValueError(f"not a mono PCM16 WAV: {fmt}")
    return np.frombuffer(pcm, dtype="<i2").copy(), fmt[2]
