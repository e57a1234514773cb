"""Vocoder discriminators: multi-period (MPD) and multi-resolution (MRD), in PyTorch.

Counterpart of the JAX package's ``models/discriminators.py``, for the
optional GAN stage of vocoder training (``cli/train_vocoder.py --gan``).
Parameters keep the flax layout and names (``mpd_2.conv0.weight`` is flax's
``mpd_2/conv0/kernel`` [kh, kw, in, out]), so ``utils/weights.py`` carries a
tree across unchanged and the convs permute the kernel where they run.

The convs run in NCHW: the flax module's NHWC ``[B, H, W, 1]`` input is
``[B, 1, H, W]`` here, features are ``[B, C, H, W]`` (the flax ones permuted),
and the logits flatten in the same (h, w) order. The MRD's ``"SAME"`` convs
pad as lax does, which is asymmetric where the stride is 2 and the width
even (``same_pad``); the stride-2 convs rule out ``nn.Conv2d(padding="same")``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from oron_tts_tpu_torch.ops.mel import stft_magnitude_eps

PERIODS = (2, 3, 5, 7, 11)
RESOLUTIONS = ((512, 128), (1024, 256), (2048, 512))


class Conv2d(nn.Module):
    """A 2-D conv holding flax's kernel layout [kh, kw, in, out]."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int]) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(*kernel, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
        return F.conv2d(x, self.weight.permute(3, 2, 0, 1), self.bias, stride, padding)


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """lax's ``"SAME"`` padding of one axis: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


class PeriodDiscriminator(nn.Module):
    """Reshapes the waveform into [T/p, p] frames and applies 2-D convs."""

    def __init__(self, period: int, channels: tuple[int, ...] = (32, 128, 512, 1024)) -> None:
        super().__init__()
        self.period, self.n_convs = period, len(channels)
        for i, (cin, ch) in enumerate(zip((1,) + channels[:-1], channels)):
            self.add_module(f"conv{i}", Conv2d(cin, ch, (5, 1)))
        self.conv_post1 = Conv2d(channels[-1], 1024, (5, 1))
        self.conv_post2 = Conv2d(1024, 1, (3, 1))

    def forward(self, wav: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """wav [B, T] → (logits [B, N], feature maps [B, C, H, p])."""
        B, T = wav.shape
        pad = (-T) % self.period
        # reflect needs pad <= T - 1; a segment shorter than the period can need more
        mode = "reflect" if pad < T else "constant"
        x = F.pad(wav[:, None], (0, pad), mode=mode)[:, 0] if pad else wav
        x = x.reshape(B, 1, -1, self.period)
        features = []
        for i in range(self.n_convs):
            x = _leaky(getattr(self, f"conv{i}")(x, stride=(3, 1), padding=(2, 0)))
            features.append(x)
        x = _leaky(self.conv_post1(x, padding=(2, 0)))
        features.append(x)
        x = self.conv_post2(x, padding=(1, 0))
        return x.reshape(B, -1), features


RESOLUTION_SPECS = (((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
                    ((3, 9), (1, 2)), ((3, 3), (1, 1)))


class ResolutionDiscriminator(nn.Module):
    """2-D convs over the magnitude spectrogram at one STFT resolution."""

    def __init__(self, n_fft: int, hop: int, channels: int = 32) -> None:
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        for i, (k, _) in enumerate(RESOLUTION_SPECS):
            self.add_module(f"conv{i}", Conv2d(1 if i == 0 else channels, channels, k))
        self.conv_post = Conv2d(channels, 1, (3, 3))

    @staticmethod
    def _same(conv: Conv2d, x: torch.Tensor, k, s) -> torch.Tensor:
        (hl, hh), (wl, wh) = same_pad(x.shape[2], k[0], s[0]), same_pad(x.shape[3], k[1], s[1])
        return conv(F.pad(x, (wl, wh, hl, hh)), stride=s)

    def forward(self, wav: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """wav [B, L] → (logits [B, N], feature maps [B, C, T', F'])."""
        B = wav.shape[0]
        x = stft_magnitude_eps(wav, self.n_fft, self.hop)[:, None]
        features = []
        for i, (k, s) in enumerate(RESOLUTION_SPECS):
            x = _leaky(self._same(getattr(self, f"conv{i}"), x, k, s))
            features.append(x)
        x = self._same(self.conv_post, x, (3, 3), (1, 1))
        return x.reshape(B, -1), features


class VocoderDiscriminator(nn.Module):
    """MPD over periods (2, 3, 5, 7, 11) and MRD over three STFT resolutions."""

    def __init__(self, periods: tuple[int, ...] = PERIODS,
                 resolutions: tuple[tuple[int, int], ...] = RESOLUTIONS) -> None:
        super().__init__()
        self.names = [f"mpd_{p}" for p in periods] + [f"mrd_{n}" for n, _ in resolutions]
        for p in periods:
            self.add_module(f"mpd_{p}", PeriodDiscriminator(p))
        for n_fft, hop in resolutions:
            self.add_module(f"mrd_{n_fft}", ResolutionDiscriminator(n_fft, hop))

    def forward(self, wav: torch.Tensor) -> tuple[list[torch.Tensor], list[list[torch.Tensor]]]:
        logits, features = [], []
        for name in self.names:
            lg, fm = getattr(self, name)(wav)
            logits.append(lg)
            features.append(fm)
        return logits, features
