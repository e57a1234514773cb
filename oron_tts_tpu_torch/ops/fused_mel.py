"""Fused log-mel: the CUDA kernel and its plain version.

``log_mel_fused(audio, cfg)`` maps a 1-D f32 waveform ``[L]`` to the
log-mel ``[n_mels, 1 + L // hop]`` in one kernel pass (framing, window,
true-f32 real DFT, magnitude, filterbank, log), as the JAX package's
``log_mel_pallas`` does.

- CUDA tensors launch ``csrc/fused_mel.cu``, or raise.
- CPU tensors take :func:`log_mel_plain` (``ops/mel.py``).

The kernel replaces ``oron_tts_tpu/ops/pallas_mel.py:26`` (``_mel_kernel``);
see the source note in the ``.cu`` file.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from oron_tts_tpu_torch.ops.mel import MelConfig, log_mel_spectrogram, mel_constants


def log_mel_plain(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    return log_mel_spectrogram(audio, cfg)


@functools.lru_cache(maxsize=8)
def _twiddle(n_fft: int) -> np.ndarray:
    """[2, n_fft]: cos and sin of 2πm/n_fft, computed in float64."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)


_device_consts: dict[tuple, tuple[torch.Tensor, ...]] = {}


def _consts(cfg: MelConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    key = (cfg, str(device))
    if key not in _device_consts:
        window, fb = mel_constants(cfg)
        _device_consts[key] = tuple(
            torch.from_numpy(a).to(device).contiguous()
            for a in (window, _twiddle(cfg.n_fft), fb)
        )
    return _device_consts[key]


def log_mel_fused(audio: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[L] waveform → [n_mels, 1 + L // hop] log-mel; the kernel on CUDA."""
    if audio.device.type == "cpu":
        return log_mel_plain(audio, cfg)
    if audio.device.type != "cuda":
        raise ValueError(f"log_mel_fused: unsupported device {audio.device}")
    from oron_tts_tpu_torch.ops import _build

    if audio.ndim != 1:
        raise ValueError(f"log_mel_fused takes a 1-D waveform, got {tuple(audio.shape)}")
    n_fft = cfg.n_fft
    if n_fft & (n_fft - 1):
        raise ValueError(f"log_mel_fused needs a power-of-two n_fft, got {n_fft}")
    L = audio.shape[0]
    if L <= n_fft // 2:
        raise ValueError(f"reflect padding needs more than {n_fft // 2} samples, got {L}")
    x = audio.to(torch.float32).contiguous()
    window, twiddle, fb = _consts(cfg, audio.device)
    n_frames = 1 + L // cfg.hop_length
    out = torch.empty((cfg.n_mels, n_frames), dtype=torch.float32, device=audio.device)
    lib = _build.load("fused_mel")
    err = lib.log_mel_fused(
        x.data_ptr(), L, window.data_ptr(), twiddle.data_ptr(), fb.data_ptr(),
        out.data_ptr(), n_frames, n_fft, cfg.hop_length, cfg.n_mels,
        float(cfg.log_clip), _build.stream_ptr(audio.device),
    )
    _build.check(err, "log_mel_fused")
    log_mel_fused.launches += 1
    return out


log_mel_fused.launches = 0
