"""Griffin-Lim mel → waveform (no learned weights).

Counterpart of the JAX package's ``ops/griffin_lim.py``: the log-mel is
inverted to a magnitude through the filterbank's pseudo-inverse, then the
phase is recovered by alternating projections. The STFT frames the signal as
``ops/mel.py`` does (numpy's reflect pad by n_fft/2, the padded Hann window)
and runs ``torch.fft.rfft``; the inverse is ``ops/stft.py``'s ``istft_real``.
Plain PyTorch on any device: the JAX op is not a Pallas kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from oron_tts_tpu_torch.ops.mel import MelConfig, mel_filterbank, padded_hann_window, reflect_index
from oron_tts_tpu_torch.ops.stft import istft_real


@functools.lru_cache(maxsize=4)
def _pinv_fb(cfg: MelConfig) -> np.ndarray:
    # fb is [n_freqs, n_mels] and mel = fbᵀ·mag, so mag ≈ pinv(fb)ᵀ·mel
    return np.linalg.pinv(mel_filterbank(cfg)).astype(np.float32)  # [n_mels, n_freqs]


def mel_to_linear(log_mel: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[..., n_mels, T] log-mel → [..., n_freqs, T] magnitude estimate."""
    pinv = torch.from_numpy(_pinv_fb(cfg)).to(log_mel.device)
    mag = torch.einsum("mf,...mt->...ft", pinv, torch.exp(log_mel.float()))
    return torch.clamp(mag, min=0.0)


def _stft_re_im(audio: torch.Tensor, cfg: MelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., L] → (re, im) [..., n_freqs, 1 + L // hop] (center=True)."""
    window = torch.from_numpy(padded_hann_window(cfg.n_fft, cfg.win_length)).to(audio.device)
    x = audio[..., reflect_index(audio.shape[-1], cfg.n_fft // 2, audio.device)]
    spec = torch.fft.rfft(x.unfold(-1, cfg.n_fft, cfg.hop_length) * window, dim=-1)
    return spec.real.transpose(-1, -2), spec.imag.transpose(-1, -2)


def griffin_lim(
    log_mel: torch.Tensor,
    cfg: MelConfig,
    n_iter: int = 32,
    seed: int = 0,
    init_phase: torch.Tensor | None = None,
) -> torch.Tensor:
    """[..., n_mels, T] log-mel → waveform [..., T·hop].

    The initial phase is uniform in [−π, π) from a CPU ``torch.Generator``
    seeded ``seed`` (the same draw on every device), or ``init_phase``
    [..., n_freqs, T] where given (a test passes the JAX draw).
    """
    mag = mel_to_linear(log_mel, cfg)  # [..., F, T]
    t_frames = mag.shape[-1]
    length = (t_frames - 1) * cfg.hop_length
    if init_phase is None:
        gen = torch.Generator().manual_seed(seed)
        init_phase = torch.rand(mag.shape, generator=gen) * (2 * math.pi) - math.pi
    phase = init_phase.to(device=mag.device, dtype=mag.dtype)
    re, im = mag * torch.cos(phase), mag * torch.sin(phase)
    for _ in range(n_iter):
        # the iteration renders (T−1)·hop samples, so each re-STFT gives T frames
        wav = istft_real(re, im, cfg.n_fft, cfg.hop_length, cfg.win_length, length=length)
        new_re, new_im = _stft_re_im(wav, cfg)
        new_re, new_im = new_re[..., :t_frames], new_im[..., :t_frames]
        norm = torch.clamp(torch.sqrt(new_re ** 2 + new_im ** 2), min=1e-8)
        re, im = mag * new_re / norm, mag * new_im / norm
    # the final render keeps the framework's T·hop contract
    return istft_real(re, im, cfg.n_fft, cfg.hop_length, cfg.win_length,
                      length=t_frames * cfg.hop_length)
