"""Speech denoising for dataset preparation (numpy on the host).

Counterpart of the JAX package's ``data/denoiser.py``, which has no JAX in
it: a fixed 48 kHz model-rate contract (resample in → enhance → resample
back) with two backends:

- ``spectral``: built-in spectral gating (noise-floor estimate per band from
  the quietest frames, soft Wiener-style mask, overlap-add resynthesis) —
  no external weights, numpy-only.
- ``df``: lazy DeepFilterNet import if the optional dependency is installed.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from oron_tts_tpu_torch.data import wav as wavio

_logger = logging.getLogger(__name__)

_MODEL_RATE = 48000


def spectral_gate(
    audio: np.ndarray,
    sample_rate: int,
    n_fft: int = 2048,
    hop: int = 512,
    quiet_fraction: float = 0.15,
    threshold_sigma: float = 1.5,
    reduction_db: float = 18.0,
    mask_smooth: int = 3,
) -> np.ndarray:
    """Spectral-gating noise reduction (stationary-noise assumption).

    The noise profile comes from the *quietest frames by total energy*
    (the noisereduce recipe) — a per-band quantile over all frames would
    misclassify any stationary signal component (sustained vowels, tones)
    as noise and gate it out.
    """
    if len(audio) < 2 * n_fft:
        return audio
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    n_frames = 1 + (len(audio) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = audio[idx] * window
    spec = np.fft.rfft(frames, axis=-1)  # [T, F]
    mag = np.abs(spec)

    energy = mag.sum(axis=-1)
    n_quiet = max(2, int(n_frames * quiet_fraction))
    quiet = mag[np.argsort(energy)[:n_quiet]]
    noise_mean = quiet.mean(axis=0, keepdims=True)
    noise_std = quiet.std(axis=0, keepdims=True)
    threshold = noise_mean + threshold_sigma * noise_std

    gain_floor = 10.0 ** (-reduction_db / 20.0)
    mask = np.clip(
        (mag - threshold) / np.maximum(threshold, 1e-10), 0.0, 1.0
    )
    if mask_smooth > 1:
        kernel = np.ones(mask_smooth) / mask_smooth
        mask = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode="same"), 0, mask
        )
    gain = gain_floor + (1.0 - gain_floor) * mask

    out_spec = spec * gain
    out_frames = np.fft.irfft(out_spec, n=n_fft, axis=-1) * window
    out = np.zeros(len(audio), dtype=np.float64)
    norm = np.zeros(len(audio), dtype=np.float64)
    flat_idx = idx.reshape(-1)
    np.add.at(out, flat_idx, out_frames.reshape(-1))
    np.add.at(norm, flat_idx, np.tile(window * window, n_frames))
    # edges/tail with near-zero window coverage can't be reconstructed —
    # keep the input there instead of amplifying numerical garbage
    good = norm > 0.1
    out[good] = out[good] / norm[good]
    out[~good] = audio[~good]
    return out.astype(np.float32)


class AudioDenoiser:
    """48 kHz-contract denoiser with optional DeepFilterNet backend."""

    def __init__(self, target_sample_rate: int = 24000, backend: str = "auto"):
        self.target_sample_rate = target_sample_rate
        self._df = None
        self.backend = backend
        if backend in ("auto", "df"):
            try:
                from df import enhance, init_df  # type: ignore

                model, state, _ = init_df()
                self._df = (enhance, model, state)
                self.backend = "df"
                _logger.info("AudioDenoiser: using DeepFilterNet backend")
            except Exception:
                if backend == "df":
                    raise
                self.backend = "spectral"
        if self.backend != "df":
            self.backend = "spectral"
            _logger.info("AudioDenoiser: using spectral-gating backend")

    def denoise(self, audio: np.ndarray, sample_rate: int | None = None) -> np.ndarray:
        """Enhance at the fixed 48 kHz model rate, resample back."""
        sr = sample_rate or self.target_sample_rate
        work = wavio.resample(np.asarray(audio, np.float32), sr, _MODEL_RATE)
        if self.backend == "df" and self._df is not None:
            enhance, model, state = self._df
            import torch

            enhanced = enhance(
                model, state, torch.from_numpy(work[None, :])
            ).squeeze(0).numpy()
        else:
            enhanced = spectral_gate(work, _MODEL_RATE)
        return wavio.resample(enhanced, _MODEL_RATE, self.target_sample_rate)

    def denoise_file(self, in_path: str | Path, out_path: str | Path) -> None:
        audio, sr = wavio.read_wav(in_path)
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        out = self.denoise(audio, sr)
        wavio.write_wav(out_path, out, self.target_sample_rate)

    def denoise_batch(
        self, paths: list[tuple[str | Path, str | Path]]
    ) -> tuple[int, int]:
        """Per-file error tolerance; returns (ok, failed)."""
        ok = failed = 0
        for src, dst in paths:
            try:
                self.denoise_file(src, dst)
                ok += 1
            except Exception as exc:
                _logger.warning("Denoise failed for %s: %s", src, exc)
                failed += 1
        return ok, failed
