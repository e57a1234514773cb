"""Configuration loading with the reference's flat-YAML schema.

Drop-in compatible with configs/{local,runpod,colab}.yaml of the reference:
flat audio/training keys + a nested ``model:`` section. Defaults are
centralized here instead of scattered across call sites. A key the schema
does not have is ignored: ``model.scan_blocks`` among them, the JAX
package's ``lax.scan`` switch, which the port's unrolled blocks do not need.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


# The names ``model.backbone`` takes (``models/f5tts.py`` ``BACKBONES`` has their
# classes) and their own defaults; a ``text_dim`` of None is the mel width, "dim" the
# model width.
BACKBONE_DEFAULTS: dict[str, dict[str, int | str | None]] = {
    "DiT": {"text_dim": 512, "conv_layers": 4},  # F5-TTS
    "UNetT": {"text_dim": None, "conv_layers": 0},  # E2 TTS: characters at the mel width
    "MMDiT": {"text_dim": "dim", "conv_layers": 0},  # F5-TTS's SD3 block: a text stream
}


def load_config(path: str | Path) -> dict[str, Any]:
    path = Path(path)
    text = path.read_text()
    if path.suffix == ".json":
        return json.loads(text)
    import yaml

    return yaml.safe_load(text)


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 65
    dim: int = 1024
    depth: int = 22
    heads: int = 16
    ff_mult: int = 4
    text_dim: int = 512
    conv_layers: int = 4
    p_dropout: float = 0.1
    audio_drop_prob: float = 0.3
    cond_drop_prob: float = 0.2
    frac_lengths_mask: tuple[float, float] = (0.7, 1.0)
    # a key of BACKBONE_DEFAULTS
    backbone: str = "DiT"
    # UNetT and MMDiT: zero the text padding (the MMDiT's after its positions); UNetT
    # only: the number of heads RoPE rotates (None: every head)
    text_mask_padding: bool = True
    pe_attn_head: int | None = None

    @property
    def dim_head(self) -> int:
        return self.dim // self.heads


@dataclass(frozen=True)
class AudioConfig:
    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 100


@dataclass(frozen=True)
class F5Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    gradient_checkpointing: bool = False
    raw: dict[str, Any] = field(default_factory=dict, hash=False, compare=False)

    @classmethod
    def from_dict(cls, cfg: dict[str, Any]) -> "F5Config":
        m = cfg.get("model", {}) or {}
        frac = m.get("frac_lengths_mask", [0.7, 1.0])
        backbone = m.get("backbone", ModelConfig.backbone)
        if backbone not in BACKBONE_DEFAULTS:
            raise ValueError(f"model.backbone must be one of {tuple(BACKBONE_DEFAULTS)}, "
                             f"got {backbone!r}")
        defaults = BACKBONE_DEFAULTS[backbone]
        dim = m.get("dim", 1024)
        text_dim = {None: cfg.get("n_mels", 100), "dim": dim}.get(
            defaults["text_dim"], defaults["text_dim"])
        model = ModelConfig(
            vocab_size=m.get("vocab_size", 65),
            dim=dim,
            depth=m.get("depth", 22),
            heads=m.get("heads", 16),
            ff_mult=m.get("ff_mult", 4),
            text_dim=m.get("text_dim", text_dim),
            conv_layers=m.get("conv_layers", defaults["conv_layers"]),
            p_dropout=m.get("p_dropout", 0.1),
            audio_drop_prob=m.get("audio_drop_prob", 0.3),
            cond_drop_prob=m.get("cond_drop_prob", 0.2),
            frac_lengths_mask=(float(frac[0]), float(frac[1])),
            backbone=backbone,
            text_mask_padding=m.get("text_mask_padding", True),
            pe_attn_head=m.get("pe_attn_head"),
        )
        audio = AudioConfig(
            sample_rate=cfg.get("sample_rate", 24000),
            n_fft=cfg.get("n_fft", 1024),
            hop_length=cfg.get("hop_length", 256),
            win_length=cfg.get("win_length", 1024),
            n_mels=cfg.get("n_mels", 100),
        )
        return cls(
            model=model,
            audio=audio,
            gradient_checkpointing=cfg.get("gradient_checkpointing", False),
            raw=dict(cfg),
        )

    @classmethod
    def from_file(cls, path: str | Path) -> "F5Config":
        return cls.from_dict(load_config(path))
