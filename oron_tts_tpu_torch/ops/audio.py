"""AudioProcessor: WAV loading on the host, log-mel on the device.

Counterpart of the JAX package's ``ops/audio.py``. ``mel_spectrogram`` on
the card runs the fused log-mel kernel, one launch for a batch of
waveforms; on the CPU it runs the plain version. The card is the default
device, as for ``F5TTS``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from oron_tts_tpu_torch.data import wav as wavio
from oron_tts_tpu_torch.ops.fused_mel import log_mel_fused
from oron_tts_tpu_torch.ops.mel import MelConfig
from oron_tts_tpu_torch.utils.device import resolve_device


class AudioProcessor:
    def __init__(
        self,
        sample_rate: int = 24000,
        n_fft: int = 1024,
        hop_length: int = 256,
        win_length: int = 1024,
        n_mels: int = 100,
        device: str | torch.device | None = None,
    ) -> None:
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mels = n_mels
        self.device = resolve_device(device)
        self.mel_config = MelConfig(
            sample_rate=sample_rate, n_fft=n_fft, hop_length=hop_length,
            win_length=win_length, n_mels=n_mels,
        )

    def load_audio(self, path: str | Path) -> tuple[np.ndarray, int]:
        """Load, downmix to mono, resample to the configured rate."""
        samples, sr = wavio.read_wav(path)
        if samples.ndim > 1:
            samples = samples.mean(axis=1)
        if sr != self.sample_rate:
            samples = wavio.resample(samples, sr, self.sample_rate)
        return samples.astype(np.float32), self.sample_rate

    def save_audio(self, path: str | Path, audio: np.ndarray) -> None:
        wavio.write_wav(path, np.asarray(audio), self.sample_rate)

    def normalize_audio(self, audio: np.ndarray) -> np.ndarray:
        return wavio.normalize_peak(np.asarray(audio))

    def trim_silence(self, audio: np.ndarray, top_db: float = 20.0, frame_length: int = 2048,
                     hop_length: int = 512) -> np.ndarray:
        return wavio.trim_silence(np.asarray(audio), top_db=top_db,
                                  frame_length=frame_length, hop_length=hop_length)

    def get_audio_duration(self, audio: np.ndarray) -> float:
        return len(audio) / self.sample_rate

    def mel_spectrogram(self, audio: np.ndarray | torch.Tensor) -> torch.Tensor:
        """Log-mel [n_mels, T] (or [..., n_mels, T] for batched input), on
        this processor's device; a [1, L] input collapses to [n_mels, T], as
        in the JAX package."""
        x = torch.as_tensor(np.asarray(audio) if not torch.is_tensor(audio) else audio)
        x = x.to(device=self.device, dtype=torch.float32)
        if x.ndim == 2 and x.shape[0] == 1:
            x = x[0]
        return log_mel_fused(x, self.mel_config)
