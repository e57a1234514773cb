"""Vocos-style ISTFT vocoder (mel → waveform) in PyTorch.

Counterpart of the JAX package's ``models/vocos.py``, both head modes:

- ``"real_imag"``: a Linear head predicts interleaved real/imag STFT
  coefficients, normalized ISTFT;
- ``"mag_phase"``: the official Vocos head (the bundled checkpoint):
  log-magnitude ‖ phase, magnitude clipped at 1e2, non-normalized ISTFT
  with ``padding="same"``.

With ``lens`` the output is bucket-invariant: activations are re-zeroed
beyond each row's length after the embed conv and after every block,
pad-frame STFT coefficients are zeroed, and the ISTFT envelope covers each
row's own frames.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from oron_tts_tpu_torch.models.layers import ConvWeights, DepthwiseConv1d
from oron_tts_tpu_torch.ops.stft import istft_real
from oron_tts_tpu_torch.utils.torch_compat import _conv1d, _layernorm, _linear, _np

LOG_MAG_CLIP = 4.605170185988091  # log(1e2), the official Vocos clip


class VocosConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int, layer_scale: bool = False) -> None:
        super().__init__()
        self.dwconv = DepthwiseConv1d(dim, kernel_size=7)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6)) if layer_scale else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pwconv2(F.gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        if self.gamma is not None:
            h = h * self.gamma
        return x + h


class VocosDecoder(nn.Module):
    """mel [B, n_mels, T] → waveform [B, T·hop_length]."""

    def __init__(
        self,
        n_mels: int = 100,
        dim: int = 512,
        n_layers: int = 8,
        intermediate_dim: int = 1536,
        n_fft: int = 1024,
        hop_length: int = 256,
        head_mode: str = "real_imag",
        layer_scale: bool = False,
    ) -> None:
        super().__init__()
        if head_mode not in ("real_imag", "mag_phase"):
            raise ValueError(f"unknown head_mode {head_mode!r}")
        self.n_layers, self.n_fft, self.hop_length = n_layers, n_fft, hop_length
        self.head_mode = head_mode
        self.embed = ConvWeights(7, n_mels, dim)
        self.norm_pre = nn.LayerNorm(dim, eps=1e-6)
        for i in range(n_layers):
            self.add_module(f"block{i}", VocosConvNeXtBlock(dim, intermediate_dim, layer_scale))
        self.norm_post = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, (n_fft // 2 + 1) * 2)

    def _embed_conv(self, x: torch.Tensor) -> torch.Tensor:
        """SAME k=7 conv over [B, T, n_mels] as shifted matmuls."""
        k = self.embed.weight.shape[0]
        t = x.shape[1]
        xp = F.pad(x, (0, 0, k // 2, k - 1 - k // 2))
        out = None
        for i in range(k):
            term = torch.matmul(xp[:, i: i + t], self.embed.weight[i])
            out = term if out is None else out + term
        return out + self.embed.bias

    def forward(self, mel: torch.Tensor, lens: torch.Tensor | None = None) -> torch.Tensor:
        x = mel.transpose(-1, -2).to(self.head.weight.dtype)  # [B, T, n_mels]
        valid = None
        if lens is not None:
            valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                     < lens.to(x.device)[:, None])[..., None]

        def remask(y: torch.Tensor) -> torch.Tensor:
            return y if valid is None else y.masked_fill(~valid, 0.0)

        x = remask(self.norm_pre(self._embed_conv(x)))
        for i in range(self.n_layers):
            x = remask(getattr(self, f"block{i}")(x))
        out = remask(self.head(self.norm_post(x)).float())  # [B, T, 2F]

        n_bins = self.n_fft // 2 + 1
        if self.head_mode == "mag_phase":
            mag = torch.exp(torch.clamp(out[..., :n_bins], max=LOG_MAG_CLIP))
            phase = out[..., n_bins:]
            re = (mag * torch.cos(phase)).transpose(-1, -2)  # [B, F, T]
            im = (mag * torch.sin(phase)).transpose(-1, -2)
            if valid is not None:
                fv = valid[..., 0][:, None, :]  # exp(0)·cos(0) = 1 on pad frames
                re = re.masked_fill(~fv, 0.0)
                im = im.masked_fill(~fv, 0.0)
            return istft_real(re, im, self.n_fft, self.hop_length, normalized=False,
                              padding="same", lens=lens)
        ri = out.reshape(*out.shape[:-1], n_bins, 2)
        return istft_real(ri[..., 0].transpose(-1, -2), ri[..., 1].transpose(-1, -2),
                          self.n_fft, self.hop_length, normalized=True, lens=lens,
                          length=out.shape[1] * self.hop_length)


def convert_vocos_state_dict(state_dict: dict, n_layers: int = 8) -> dict:
    """Official Vocos torch state dict → the flax tree ``VocosDecoder`` loads.

    Keys ``backbone.embed``, ``backbone.norm``, ``backbone.convnext.{i}.*``
    (with the layer-scale ``gamma`` where the checkpoint has one),
    ``backbone.final_layer_norm`` and ``head.out``; load the tree with
    ``utils.weights.from_flax_params`` into ``head_mode="mag_phase"``.
    Counterpart of the JAX package's ``convert_vocos_state_dict``.
    """
    params = {
        "embed": _conv1d(state_dict, "backbone.embed"),
        "norm_pre": _layernorm(state_dict, "backbone.norm"),
        "norm_post": _layernorm(state_dict, "backbone.final_layer_norm"),
        "head": _linear(state_dict, "head.out"),
    }
    for i in range(n_layers):
        b = f"backbone.convnext.{i}"
        block = {
            "dwconv": _conv1d(state_dict, f"{b}.dwconv"),
            "norm": _layernorm(state_dict, f"{b}.norm"),
            "pwconv1": _linear(state_dict, f"{b}.pwconv1"),
            "pwconv2": _linear(state_dict, f"{b}.pwconv2"),
        }
        if f"{b}.gamma" in state_dict:
            block["gamma"] = _np(state_dict[f"{b}.gamma"])
        params[f"block{i}"] = block
    return params
