"""Plain float32 Vocos (mel → waveform) with its inverse STFT, and the PCM16 encoding.

The Vocos architecture (arXiv:2306.00814): a k=7 embedding conv, ConvNeXt
blocks (depthwise k=7 conv, LayerNorm, 1×1 expansion with GELU, 1×1
projection, residual), a final LayerNorm and a linear head giving
log-magnitude ‖ phase of each STFT frame (magnitude clipped at 1e2), then an
inverse real FFT, a periodic Hann window, overlap-add divided by the
squared-window envelope, and the "same" padding ((n_fft − hop)/2 cut each
side). The weights are read from the bundled ``.npz`` with numpy, with the
``config.json`` beside it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from portbench.reference.layers import conv1d_same, gelu_erf, layer_norm

LOG_MAG_CLIP = float(np.log(1e2))
VOCODER_NPZ = Path("oron_tts_tpu") / "assets" / "vocoder" / "vocos_default.npz"


def load_vocos(root: Path, device="cpu") -> dict:
    """The bundled Vocos as ``{"p": {path: tensor}, "n_layers": n}``."""
    path = root / VOCODER_NPZ
    cfg = json.loads((path.parent / "config.json").read_text())
    if cfg.get("head_mode") != "mag_phase" or cfg.get("layer_scale", False):
        raise ValueError(f"the reference Vocos is the mag/phase head without layer scale: {cfg}")
    p = {}
    with np.load(path) as data:
        for key in data.files:
            if not key.startswith("params/"):
                continue
            arr = data[key]
            if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bf16 stored raw
                arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
            p[key[len("params/"):]] = torch.from_numpy(np.asarray(arr, np.float32)).to(device)
    return {"p": p, "n_layers": int(cfg["n_layers"])}


def hann(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n + 1) / n))[:n]


@torch.no_grad()
def vocode(voc: dict, mel: torch.Tensor, n_fft: int = 1024, hop: int = 256,
           rnd=None) -> torch.Tensor:
    """mel [T, n_mels] → waveform [T·hop] (float32); ``rnd`` rounds both operands of
    every product (the control's lower precision)."""
    p = voc["p"]

    def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return a @ w if rnd is None else rnd(a) @ rnd(w)

    x = conv1d_same(mel[None].float(), p["embed/kernel"], p["embed/bias"], groups=1, rnd=rnd)
    x = layer_norm(x, p["norm_pre/scale"], p["norm_pre/bias"])
    for i in range(voc["n_layers"]):
        b = f"block{i}/"
        h = conv1d_same(x, p[b + "dwconv/kernel"], p[b + "dwconv/bias"], groups=x.shape[-1],
                        rnd=rnd)
        h = layer_norm(h, p[b + "norm/scale"], p[b + "norm/bias"])
        h = gelu_erf(mm(h, p[b + "pwconv1/kernel"]) + p[b + "pwconv1/bias"])
        x = x + (mm(h, p[b + "pwconv2/kernel"]) + p[b + "pwconv2/bias"])
    x = layer_norm(x, p["norm_post/scale"], p["norm_post/bias"])
    out = (mm(x, p["head/kernel"]) + p["head/bias"])[0]  # [T, 2F]
    n_bins = n_fft // 2 + 1
    mag = torch.exp(torch.clamp(out[:, :n_bins], max=LOG_MAG_CLIP))
    spec = torch.polar(mag.double(), out[:, n_bins:].double())  # [T, F]
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    win = torch.from_numpy(hann(n_fft)).to(frames.device)
    frames = frames * win
    T = frames.shape[0]
    total = n_fft + hop * (T - 1)

    def overlap_add(f: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.fold(f.t()[None], (1, total), (1, n_fft),
                                        stride=(1, hop))[0, 0, 0]

    wav = overlap_add(frames)
    env = overlap_add((win * win)[None].expand(T, n_fft))
    wav = wav / torch.clamp(env, min=1e-11)
    pad = (n_fft - hop) // 2
    return wav[pad: pad + T * hop].float()


def pcm16(wav: np.ndarray) -> np.ndarray:
    """Float samples → the int16 values a PCM16 WAV carries."""
    return np.round(np.clip(np.asarray(wav, np.float64), -1.0, 1.0) * 32767.0).astype(np.int16)
