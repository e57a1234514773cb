"""Fused log-mel: the CUDA kernel and its plain version.

``log_mel_fused(audio, cfg)`` maps f32 waveforms ``[..., L]`` to log-mels
``[..., n_mels, 1 + L // hop]`` in one kernel launch over the whole batch
(framing, window, true-f32 real FFT, magnitude, filterbank, log), as the
JAX package's ``log_mel_pallas`` does for one waveform.

- CUDA tensors launch ``csrc/fused_mel.cu``, or raise.
- CPU tensors take :func:`log_mel_plain` (``ops/mel.py``).

The kernel replaces ``oron_tts_tpu/ops/pallas_mel.py:26`` (``_mel_kernel``);
see the source note in the ``.cu`` file. Its host-side tables are built
here: the FFT's twiddles and the filterbank as runs of non-zero bins.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from oron_tts_tpu_torch.ops.mel import MelConfig, log_mel_spectrogram, mel_constants

KERNEL_N_FFT = (256, 512, 1024, 2048)  # the kernel's template instances


def log_mel_plain(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    return log_mel_spectrogram(audio, cfg)


def fft_passes(m: int) -> list[tuple[int, int]]:
    """(radix, sub-transform size) of each Stockham pass of the m-point FFT:
    radix 8 while 8 fit, then 4 or 2 (``radix_at`` in the kernel)."""
    passes, ns = [], 1
    while ns < m:
        r = 8 if m // ns >= 8 else m // ns
        passes.append((r, ns))
        ns *= r
    return passes


@functools.lru_cache(maxsize=8)
def _twiddles(n_fft: int) -> np.ndarray:
    """[2, T]: cos and sin, computed in float64, of each pass's angles
    2π·r·k/(ns·R) for r = 1..R-1, k < ns (passes with ns > 1, laid out
    [pass][r][k]), then the even/odd split's 2π·k/n_fft for k = 0..n_fft/4."""
    m = n_fft // 2
    angles = [2.0 * np.pi * np.outer(np.arange(1, r), np.arange(ns)).ravel() / (ns * r)
              for r, ns in fft_passes(m) if ns > 1]
    angles.append(2.0 * np.pi * np.arange(m // 2 + 1) / n_fft)
    ang = np.concatenate(angles)
    return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def sparse_filterbank(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank as each band's run of bins from its first non-zero
    weight to its last: (bands int32 [3, n_mels]: first bin, count, offset
    into weights; weights f32 [sum of counts]). A band with no non-zero
    weight has count 0."""
    _, fb = mel_constants(cfg)
    nz = fb != 0
    any_nz = nz.any(axis=0)
    first = np.where(any_nz, nz.argmax(axis=0), 0)
    last = np.where(any_nz, fb.shape[0] - 1 - nz[::-1].argmax(axis=0), -1)
    count = last - first + 1
    offset = np.concatenate([[0], np.cumsum(count)[:-1]])
    weights = np.concatenate([fb[f: f + c, m] for m, (f, c) in enumerate(zip(first, count))])
    bands = np.stack([first, count, offset]).astype(np.int32)
    return bands, weights.astype(np.float32)


_device_consts: dict[tuple, tuple[torch.Tensor, ...]] = {}


def _consts(cfg: MelConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    key = (cfg, str(device))
    if key not in _device_consts:
        window, _ = mel_constants(cfg)
        bands, weights = sparse_filterbank(cfg)
        _device_consts[key] = tuple(
            torch.from_numpy(a).to(device).contiguous()
            for a in (window, _twiddles(cfg.n_fft), bands, weights)
        )
    return _device_consts[key]


def log_mel_fused(audio: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[..., L] waveforms → [..., n_mels, 1 + L // hop] log-mels; the kernel on CUDA."""
    if audio.device.type == "cpu":
        return log_mel_plain(audio, cfg)
    if audio.device.type != "cuda":
        raise ValueError(f"log_mel_fused: unsupported device {audio.device}")
    from oron_tts_tpu_torch.ops import _build

    if audio.ndim == 0 or audio.shape[-1] < 1:
        raise ValueError(f"log_mel_fused takes waveforms [..., L >= 1], got {tuple(audio.shape)}")
    n_fft = cfg.n_fft
    if n_fft not in KERNEL_N_FFT:
        raise ValueError(f"log_mel_fused takes n_fft in {KERNEL_N_FFT}, got {n_fft}")
    lead, L = audio.shape[:-1], audio.shape[-1]
    x = audio.to(torch.float32).reshape(-1, L).contiguous()
    n_frames = 1 + L // cfg.hop_length
    out = torch.empty((x.shape[0], cfg.n_mels, n_frames), dtype=torch.float32, device=audio.device)
    if x.shape[0] > 0:
        window, twiddle, bands, weights = _consts(cfg, audio.device)
        lib = _build.load("fused_mel")
        err = lib.log_mel_fused(
            x.data_ptr(), x.shape[0], L, window.data_ptr(), twiddle.data_ptr(), twiddle.shape[1],
            bands.data_ptr(), weights.data_ptr(), weights.numel(), out.data_ptr(), n_frames,
            n_fft, cfg.hop_length, cfg.n_mels, float(cfg.log_clip), _build.stream_ptr(audio.device),
        )
        _build.check(err, "log_mel_fused")
        log_mel_fused.launches += 1
    return out.reshape(*lead, cfg.n_mels, n_frames)


log_mel_fused.launches = 0
