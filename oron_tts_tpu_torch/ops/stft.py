"""Inverse STFT (overlap-add) for the Vocos vocoder head.

Same semantics as the JAX package's ``ops/stft.py:istft_real``:
``torch.istft(center=True, onesided=True)`` conventions, optional
``normalized`` scaling, ``padding="same"`` (T frames → T·hop samples), and
a per-row window-square envelope over each row's own ``lens`` frames.
The inverse real DFT is ``torch.fft.irfft``: the JAX package used real
basis matmuls only because its backend has no complex numbers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from oron_tts_tpu_torch.ops.mel import padded_hann_window


@functools.lru_cache(maxsize=16)
def _window_envelope(n_fft: int, hop_length: int, win_length: int, n_frames: int) -> np.ndarray:
    """Overlap-added squared window over all n_frames (float64 sum)."""
    w2 = padded_hann_window(n_fft, win_length).astype(np.float64) ** 2
    env = np.zeros(n_fft + hop_length * (n_frames - 1))
    for t in range(n_frames):
        env[t * hop_length: t * hop_length + n_fft] += w2
    return env.astype(np.float32)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., T, n_fft] → [..., n_fft + hop·(T−1)]."""
    n_frames, n_fft = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    out_len = n_fft + hop * (n_frames - 1)
    if n_fft % hop:
        flat = frames.reshape(-1, n_frames, n_fft)
        out = torch.zeros(flat.shape[0], out_len, dtype=frames.dtype, device=frames.device)
        for t in range(n_frames):
            out[:, t * hop: t * hop + n_fft] += flat[:, t]
        return out.reshape(*lead, out_len)
    r = n_fft // hop
    chunks = frames.reshape(*lead, n_frames, r, hop)
    acc = torch.zeros(*lead, n_frames + r - 1, hop, dtype=frames.dtype, device=frames.device)
    for j in range(r):
        acc[..., j: j + n_frames, :] += chunks[..., j, :]
    return acc.reshape(*lead, (n_frames + r - 1) * hop)


def istft_real(
    re: torch.Tensor,
    im: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int | None = None,
    normalized: bool = False,
    center: bool = True,
    length: int | None = None,
    eps: float = 1e-11,
    padding: str = "center",
    lens: torch.Tensor | None = None,
) -> torch.Tensor:
    """Overlap-add inverse STFT from ``re, im [..., n_freqs, n_frames]``."""
    win_length = win_length or n_fft
    window = torch.from_numpy(padded_hann_window(n_fft, win_length)).to(re.device)
    spec = torch.complex(re.float(), im.float()).transpose(-1, -2)  # [..., T, F]
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    if normalized:
        frames = frames * float(np.sqrt(n_fft))
    frames = frames * window
    n_frames = frames.shape[-2]
    out_len = n_fft + hop_length * (n_frames - 1)

    wav = overlap_add(frames, hop_length)
    if lens is None:
        wsq = torch.from_numpy(
            _window_envelope(n_fft, hop_length, win_length, n_frames)
        ).to(re.device)
    else:
        valid = (
            torch.arange(n_frames, device=re.device) < lens.to(re.device)[..., None]
        ).to(frames.dtype)
        wsq = overlap_add(valid[..., None] * (window * window), hop_length)
    wav = wav / torch.clamp(wsq, min=eps)

    if padding == "same":
        pad = (n_fft - hop_length) // 2
    elif center:
        pad = n_fft // 2
    else:
        pad = 0
    if length is None:
        return wav[..., pad: out_len - pad]
    wav = wav[..., pad: min(pad + length, out_len)]
    deficit = length - wav.shape[-1]
    if deficit > 0:
        wav = torch.nn.functional.pad(wav, (0, deficit))
    return wav
