"""Plain log-mel of a waveform (numpy, float64 inside): the Vocos feature contract.

Reflect-pad by n_fft/2, a periodic Hann window of n_fft, one-sided DFT
magnitude, an HTK mel filterbank from 0 Hz to Nyquist without norm, and
``log(max(mel, 1e-5))``: ``[n_mels, 1 + L // hop]``.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.vocos import hann


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Triangular HTK filters ``[n_fft // 2 + 1, n_mels]``."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    freqs = np.linspace(0, sr // 2, n_fft // 2 + 1)
    pts = 700.0 * (10.0 ** (np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2)
                            / 2595.0) - 1.0)
    slopes = pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / np.diff(pts)[:-1]
    up = slopes[:, 2:] / np.diff(pts)[1:]
    return np.maximum(0.0, np.minimum(down, up))


def tf32_np(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest), in float32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def log_mel(audio: np.ndarray, sr: int = 24000, n_fft: int = 1024, hop: int = 256,
            n_mels: int = 100, tf32: bool = False) -> np.ndarray:
    """``tf32`` takes the filterbank's product in TF32 (the control's lower precision)."""
    x = np.asarray(audio, np.float64)
    padded = np.pad(x, n_fft // 2, mode="reflect")
    n_frames = 1 + len(x) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    mag = np.abs(np.fft.rfft(padded[idx] * hann(n_fft), axis=-1))
    fb = mel_filterbank(sr, n_fft, n_mels)
    mel = (tf32_np(mag) @ tf32_np(fb)).astype(np.float64) if tf32 else mag @ fb
    return np.log(np.maximum(mel, 1e-5)).T.astype(np.float32)
