"""Log-mel spectrogram with the Vocos feature contract (plain PyTorch).

Same contract as the JAX package's ``ops/mel.py``: reflect-pad by n_fft/2
(numpy's reflect, at any length), periodic Hann window zero-padded to
n_fft, onesided DFT magnitude (power 1), HTK mel filterbank without norm
(torchaudio's defaults), and ``log(max(mel, 1e-5))``. The window and
filterbank are built on the host in numpy, once per configuration, and
copied to each device once. ``frame_signal`` and ``log_mel_numpy`` are the
JAX module's framing and host-side log-mel (``oron_tts_tpu/ops/mel.py:98,141``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 100
    f_min: float = 0.0
    f_max: float | None = None  # defaults to sample_rate / 2
    log_clip: float = 1e-5

    @property
    def fmax(self) -> float:
        return self.sample_rate / 2 if self.f_max is None else self.f_max

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window; the periodic form matches ``torch.hann_window``."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1))
    return w[:win_length].astype(np.float32)


def padded_hann_window(n_fft: int, win_length: int) -> np.ndarray:
    """Hann window zero-padded and centred to n_fft (torch.stft's convention)."""
    w = np.zeros(n_fft, dtype=np.float32)
    offset = (n_fft - win_length) // 2
    w[offset: offset + win_length] = hann_window(win_length)
    return w


def _hz_to_mel_htk(f: np.ndarray | float) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """Triangular HTK mel filterbank [n_freqs, n_mels] (torchaudio-compatible)."""
    all_freqs = np.linspace(0, cfg.sample_rate // 2, cfg.n_freqs)
    mel_pts = np.linspace(
        _hz_to_mel_htk(cfg.f_min), _hz_to_mel_htk(cfg.fmax), cfg.n_mels + 2
    )
    f_pts = _mel_to_hz_htk(mel_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_constants(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    """(window [n_fft], filterbank [n_freqs, n_mels]) as host arrays."""
    return padded_hann_window(cfg.n_fft, cfg.win_length), mel_filterbank(cfg)


def reflect_index(L: int, pad: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Source sample of each of the L + 2·pad positions of ``np.pad(x, pad, "reflect")``.

    numpy's reflect does not repeat the edge sample and reflects again where
    the pad is longer than the signal: period 2(L - 1); L = 1 repeats its
    one sample. ``F.pad(mode="reflect")`` refuses pads of L or more.
    """
    if L < 1:
        raise ValueError("a waveform needs at least one sample")
    p = torch.arange(-pad, L + pad, device=device)
    if L == 1:
        return torch.zeros_like(p)
    period = 2 * (L - 1)
    p = p.remainder(period)
    return torch.where(p < L, p, period - p)


_device_consts: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _mel_tensors(cfg: MelConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(window, filterbank) on ``device``, copied once, so a call makes no
    host-to-device copy (and can be captured in a CUDA graph)."""
    key = (cfg, str(device))
    if key not in _device_consts:
        _device_consts[key] = tuple(torch.from_numpy(a).to(device) for a in mel_constants(cfg))
    return _device_consts[key]


def log_mel_spectrogram(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[..., L] f32 waveform → [..., n_mels, 1 + L // hop] log-mel, in f32."""
    x = audio.float()
    window, fb = _mel_tensors(cfg, x.device)
    lead, L = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, L)[:, reflect_index(L, cfg.n_fft // 2, x.device)]
    frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)  # [N, frames, n_fft]
    mag = torch.fft.rfft(frames * window, dim=-1).abs()  # [N, frames, n_freqs]
    mel = torch.matmul(mag, fb)  # [N, frames, n_mels]
    out = torch.log(torch.clamp(mel, min=cfg.log_clip)).transpose(-1, -2)
    return out.reshape(*lead, cfg.n_mels, out.shape[-1])


@functools.lru_cache(maxsize=16)
def hann_tensor(n_fft: int, device: str) -> torch.Tensor:
    """``hann_window(n_fft)`` on ``device``, copied once."""
    return torch.from_numpy(hann_window(n_fft)).to(device)


def frame_signal(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centre-pad (numpy's reflect) and slice: [..., L] → [..., 1 + L // hop, n_fft]."""
    idx = reflect_index(audio.shape[-1], n_fft // 2, audio.device)
    return audio[..., idx].unfold(-1, n_fft, hop)


def stft_magnitude_eps(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[..., L] → ``sqrt(re² + im² + 1e-9)`` [..., 1 + L // hop, n_fft // 2 + 1] (Hann,
    centred): the magnitude the vocoder losses and the MRD take, safe to
    differentiate at a zero bin."""
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop) * hann_tensor(n_fft, str(x.device)), dim=-1)
    return torch.sqrt(spec.real * spec.real + spec.imag * spec.imag + 1e-9)


def log_mel_numpy(audio: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """Host-side (numpy) log-mel [..., n_mels, 1 + L // hop], as the JAX package computes it."""
    window, fb = mel_constants(cfg)
    audio = np.asarray(audio, dtype=np.float32)
    pad = cfg.n_fft // 2
    padded = np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(pad, pad)], mode="reflect")
    n_frames = 1 + audio.shape[-1] // cfg.hop_length
    idx = np.arange(n_frames)[:, None] * cfg.hop_length + np.arange(cfg.n_fft)[None, :]
    mag = np.abs(np.fft.rfft(padded[..., idx] * window, axis=-1)).swapaxes(-1, -2)
    mel = np.einsum("...ft,fm->...mt", mag, fb)
    return np.log(np.clip(mel, cfg.log_clip, None)).astype(np.float32)
