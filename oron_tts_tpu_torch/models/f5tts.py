"""F5TTS facade: text → waveform, ref-free or voice-cloned (PyTorch).

Counterpart of the JAX package's ``models/f5tts.py`` synthesis path:
validate, split long text at punctuation or word boundaries, estimate the
duration (explicit → ref-ratio → chars·13/speed, at least 50 frames),
stretch the token ids to the mel length, pad to a bucket of
``pad_to_multiple`` frames, run the CFG Euler sampler, and vocode with the
bundled Vocos checkpoint. Chunks of a long text are solved one after the
other, chunk i with seed ``seed + i``.

Runs on the card unless ``device="cpu"`` is given; without CUDA and
without that request it raises.
"""

from __future__ import annotations

import json
import logging
import os
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from oron_tts_tpu_torch.config import F5Config
from oron_tts_tpu_torch.models.cfm import CFM
from oron_tts_tpu_torch.models.dit import DiT
from oron_tts_tpu_torch.models.vocos import VocosDecoder
from oron_tts_tpu_torch.ops.audio import AudioProcessor
from oron_tts_tpu_torch.text import TextCleaner, validate_language
from oron_tts_tpu_torch.text.align import stretch_text_to_len
from oron_tts_tpu_torch.utils.device import default_dtype, resolve_device
from oron_tts_tpu_torch.utils.weights import from_flax_params, load_npz_tree

_logger = logging.getLogger(__name__)

_KZ_ONLY_CHARS = frozenset("әғқңұһі")
DEFAULT_MAX_CHARS_PER_CHUNK = 120
DEFAULT_PAUSE_S = 0.25
_MAJOR_BREAKS = ".!?…"
_MINOR_BREAKS = ",;:"
# the vocoder weights are shared with the JAX package as a file, read by path
BUNDLED_VOCODER = (
    Path(__file__).resolve().parents[2] / "oron_tts_tpu" / "assets" / "vocoder"
    / "vocos_default.npz"
)


def _normalize_ws(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _find_split_index(text: str, max_chars: int) -> int:
    upper = min(max_chars, len(text))
    lower = max(1, int(max_chars * 0.55))
    for breaks in (_MAJOR_BREAKS, _MINOR_BREAKS, " "):
        for idx in range(upper, lower, -1):
            if text[idx - 1] in breaks:
                return idx
    return upper


def split_text_for_synthesis(text: str, max_chars: int) -> list[str]:
    """Split long text into chunks near punctuation or word boundaries."""
    normalized = _normalize_ws(text)
    if not normalized:
        return []
    if max_chars < 1:
        return [normalized]
    chunks: list[str] = []
    remaining = normalized
    while len(remaining) > max_chars:
        cut = _find_split_index(remaining, max_chars)
        piece = remaining[:cut].strip()
        if piece:
            chunks.append(piece)
        remaining = remaining[cut:].strip()
    if remaining:
        chunks.append(remaining)
    return chunks


def concat_with_pause(waveforms: list[np.ndarray], sample_rate: int, pause_s: float) -> np.ndarray:
    if not waveforms:
        return np.empty(0, dtype=np.float32)
    pause_len = int(sample_rate * pause_s)
    if len(waveforms) == 1 or pause_len <= 0:
        return np.concatenate(waveforms)
    pause = np.zeros(pause_len, dtype=waveforms[0].dtype)
    parts: list[np.ndarray] = []
    for i, w in enumerate(waveforms):
        if i:
            parts.append(pause)
        parts.append(w)
    return np.concatenate(parts)


class F5TTS:
    """DiT backbone + CFM sampler + audio front end + Vocos vocoder."""

    def __init__(
        self,
        config: F5Config,
        device: str | torch.device | None = None,
        dtype: torch.dtype | None = None,
        pad_to_multiple: int = 64,
    ) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        m, a = config.model, config.audio
        self.n_mels, self.sample_rate, self.hop_length = a.n_mels, a.sample_rate, a.hop_length
        self.pad_to_multiple = pad_to_multiple
        self.text_cleaner = TextCleaner()
        self.audio_processor = AudioProcessor(
            sample_rate=a.sample_rate, n_fft=a.n_fft, hop_length=a.hop_length,
            win_length=a.win_length, n_mels=a.n_mels, device=self.device,
        )
        self.backbone = DiT(
            dim=m.dim, depth=m.depth, heads=m.heads, dim_head=m.dim_head,
            ff_mult=m.ff_mult, mel_dim=a.n_mels, vocab_size=m.vocab_size,
            text_dim=m.text_dim, conv_layers=m.conv_layers,
        ).to(device=self.device, dtype=self.dtype).eval()
        self.cfm = CFM(self.backbone, n_mels=a.n_mels)
        self.params_loaded = False
        self.vocoder: VocosDecoder | None = None

    # ── parameters ───────────────────────────────────────────────────────

    def load_params(self, flax_params: dict[str, Any]) -> None:
        """Load a DiT parameter tree in the JAX package's flax layout."""
        self.backbone.load_state_dict(from_flax_params(flax_params), strict=True)
        self.params_loaded = True

    def load_checkpoint(self, path: str | Path) -> None:
        """Load a DiT ``.npz`` checkpoint written by the JAX package."""
        trees = load_npz_tree(path)
        self.load_params(trees.get("ema") or trees.get("params") or trees)

    def _bucket(self, n: int) -> int:
        """Round a frame count up to the bucket multiple."""
        return -(-n // self.pad_to_multiple) * self.pad_to_multiple

    # ── vocoder ──────────────────────────────────────────────────────────

    def load_vocoder(self, checkpoint_path: str | Path | None = None) -> None:
        """Load a Vocos ``.npz`` checkpoint and its ``config.json`` sidecar.

        Resolution: explicit path → ``ORON_VOCOS_CKPT`` → the bundled file.
        """
        path = Path(checkpoint_path or os.environ.get("ORON_VOCOS_CKPT") or BUNDLED_VOCODER)
        if path.suffix != ".npz" or not path.exists():
            raise FileNotFoundError(f"no Vocos .npz checkpoint at {path}")
        trees = load_npz_tree(path)
        params = trees.get("ema") or trees.get("params") or trees
        cfg_path = path.parent / "config.json"
        voc_cfg = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
        module = VocosDecoder(
            n_mels=self.n_mels,
            dim=voc_cfg.get("dim", 512),
            n_layers=voc_cfg.get("n_layers", 8),
            intermediate_dim=voc_cfg.get("intermediate_dim", 1536),
            n_fft=self.config.audio.n_fft,
            hop_length=self.hop_length,
            head_mode=voc_cfg.get("head_mode", "real_imag"),
            layer_scale=bool(voc_cfg.get("layer_scale", False)),
        )
        module.load_state_dict(from_flax_params(params), strict=True)
        # the vocoder runs in f32 on every device, as in the JAX package
        self.vocoder = module.to(self.device).eval()

    @torch.no_grad()
    def _decode_mel(self, mel: torch.Tensor) -> np.ndarray:
        """[1, n_mels, T] log-mel → waveform [T·hop], decoded at the bucket length."""
        if self.vocoder is None:
            self.load_vocoder()
        T = mel.shape[-1]
        mel = torch.nn.functional.pad(mel.float(), (0, self._bucket(T) - T))
        wav = self.vocoder(mel, torch.tensor([T], device=self.device))
        return wav[0, : T * self.hop_length].cpu().numpy()

    # ── inference ────────────────────────────────────────────────────────

    @staticmethod
    def _warn_lang_contamination(text: str, lang: str) -> None:
        if validate_language(lang) == "mn":
            bad = {c for c in text.lower() if c in _KZ_ONLY_CHARS}
            if bad:
                _logger.warning(
                    "Mongolian input contains Kazakh-only characters %s; the model "
                    "was conditioned with [LANG_MN] and may produce "
                    "out-of-distribution audio.", sorted(bad),
                )

    def synthesize(
        self,
        text: str,
        lang: str = "mn",
        ref_audio_path: str | Path | None = None,
        ref_text: str | None = None,
        n_steps: int = 32,
        cfg_strength: float = 2.0,
        sway_sampling_coef: float | None = -1.0,
        speed: float = 1.0,
        target_duration_s: float | None = None,
        max_chars_per_chunk: int | None = DEFAULT_MAX_CHARS_PER_CHUNK,
        pause_s: float = DEFAULT_PAUSE_S,
        seed: int | None = None,
    ) -> np.ndarray:
        """Synthesize speech; returns a float32 waveform [T_samples]."""
        lang, chunks, chunk_durs = self._prepare_synthesis(
            text, lang, ref_text, n_steps, cfg_strength, speed,
            target_duration_s, max_chars_per_chunk, pause_s,
        )
        if len(chunks) == 1:
            return self._synthesize_segment(
                chunks[0], lang, ref_audio_path, ref_text, n_steps, cfg_strength,
                sway_sampling_coef, speed, target_duration_s, seed,
            )
        waveforms = self._synthesize_chunks(
            chunks, lang, ref_audio_path, ref_text, n_steps, cfg_strength,
            sway_sampling_coef, speed, chunk_durs, seed,
        )
        return concat_with_pause(waveforms, self.sample_rate, pause_s)

    def synthesize_mel(
        self,
        text: str,
        lang: str = "mn",
        ref_audio_path: str | Path | None = None,
        ref_text: str | None = None,
        n_steps: int = 32,
        cfg_strength: float = 2.0,
        sway_sampling_coef: float | None = -1.0,
        speed: float = 1.0,
        target_duration_s: float | None = None,
        seed: int | None = None,
    ) -> np.ndarray:
        """Generated log-mel [n_mels, T] for a single-segment text (no vocoder)."""
        lang, chunks, _ = self._prepare_synthesis(
            text, lang, ref_text, n_steps, cfg_strength, speed,
            target_duration_s, max_chars_per_chunk=None, pause_s=0.0,
        )
        return self._synthesize_segment(
            chunks[0], lang, ref_audio_path, ref_text, n_steps, cfg_strength,
            sway_sampling_coef, speed, target_duration_s, seed, return_mel=True,
        )

    def _prepare_synthesis(
        self, text, lang, ref_text, n_steps, cfg_strength, speed,
        target_duration_s, max_chars_per_chunk, pause_s,
    ) -> tuple[str, list[str], list[float | None]]:
        """Validate, split into chunks, and share an explicit duration out."""
        lang = validate_language(lang)
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        if cfg_strength < 0:
            raise ValueError(f"cfg_strength must be >= 0, got {cfg_strength}")
        if speed <= 0:
            raise ValueError(f"speed must be > 0, got {speed}")
        if target_duration_s is not None and target_duration_s <= 0:
            raise ValueError(f"target_duration_s must be > 0, got {target_duration_s}")
        if max_chars_per_chunk is not None and max_chars_per_chunk < 0:
            raise ValueError(f"max_chars_per_chunk must be >= 0, got {max_chars_per_chunk}")
        if pause_s < 0:
            raise ValueError(f"pause_s must be >= 0, got {pause_s}")
        if not self.params_loaded:
            raise RuntimeError("load DiT parameters first (load_params or load_checkpoint)")

        self._warn_lang_contamination(text, lang)
        if ref_text:
            self._warn_lang_contamination(ref_text, lang)
        max_chars = max_chars_per_chunk or 0
        chunks = split_text_for_synthesis(text, max_chars) if max_chars > 0 else [text.strip()]
        chunks = [c for c in chunks if c]
        if not chunks:
            raise ValueError("text must not be empty")
        weights = [max(1, len(c.replace(" ", ""))) for c in chunks]
        total = sum(weights)
        chunk_durs: list[float | None] = [
            None if target_duration_s is None
            else target_duration_s * w / total if len(chunks) > 1 else target_duration_s
            for w in weights
        ]
        return lang, chunks, chunk_durs

    def _load_ref(self, ref_audio_path, ref_text, lang):
        """Reference audio → (mel [n_mels, T_ref] on the device, T_ref, ref ids)."""
        if ref_audio_path is None:
            return None, 0, []
        if not ref_text:
            _logger.warning(
                "ref_audio_path was provided without ref_text; duration will fall "
                "back to the ref-free estimate and the reference region will use "
                "filler text."
            )
        wav, _ = self.audio_processor.load_audio(ref_audio_path)
        wav = self.audio_processor.normalize_audio(wav)
        ref_mel = self.audio_processor.mel_spectrogram(wav)
        ref_ids = self.text_cleaner.text_to_sequence(ref_text, lang=lang) if ref_text is not None else []
        return ref_mel, ref_mel.shape[-1], ref_ids

    def _target_len(self, text, target_ids, target_duration_s, ref_len, ref_ids, speed) -> int:
        """Duration cascade: explicit → ref-ratio → chars·13/speed, min 50."""
        if target_duration_s is not None:
            return max(1, int(target_duration_s * self.sample_rate / self.hop_length))
        if ref_len > 0 and ref_ids:
            return max(50, int(ref_len * len(target_ids) / len(ref_ids) / speed))
        chars = max(1, len(text.replace(" ", "")))
        return max(50, int(chars * 13 / speed))

    @torch.no_grad()
    def _synthesize_segment(
        self, text, lang, ref_audio_path, ref_text, n_steps, cfg_strength, sway,
        speed, target_duration_s, seed, return_mel: bool = False,
    ) -> np.ndarray:
        target_ids = self.text_cleaner.text_to_sequence(text, lang=lang)
        ref_mel, ref_len, ref_ids = self._load_ref(ref_audio_path, ref_text, lang)
        target_len = self._target_len(text, target_ids, target_duration_s, ref_len, ref_ids, speed)
        t_total = ref_len + target_len
        bucket = self._bucket(t_total)
        if ref_len > 0:
            full_ids = (stretch_text_to_len(ref_ids, ref_len)
                        + stretch_text_to_len(target_ids, target_len))
        else:
            full_ids = stretch_text_to_len(target_ids, t_total)
        full_ids = full_ids + [-1] * (bucket - t_total)
        text_ids = torch.tensor([full_ids], dtype=torch.int64, device=self.device)

        cond = torch.zeros((1, bucket, self.n_mels), dtype=torch.float32, device=self.device)
        if ref_mel is not None:
            cond[0, :ref_len] = ref_mel.T.float()
        mel = self.cfm.sample(
            cond, text_ids, torch.tensor([t_total]), torch.tensor([ref_len]),
            steps=n_steps, cfg_strength=cfg_strength, sway_sampling_coef=sway,
            seed=0 if seed is None else seed,
        )
        gen = mel[:, ref_len:t_total, :].transpose(1, 2)  # [1, M, T]
        if return_mel:
            return gen[0].float().cpu().numpy()
        return self._decode_mel(gen).astype(np.float32)

    def _synthesize_chunks(
        self, chunks, lang, ref_audio_path, ref_text, n_steps, cfg_strength, sway,
        speed, chunk_durs, seed,
    ) -> list[np.ndarray]:
        """Solve a long text's chunks one after the other (seed + i for chunk i)."""
        base = 0 if seed is None else seed
        return [
            self._synthesize_segment(
                c, lang, ref_audio_path, ref_text, n_steps, cfg_strength, sway,
                speed, dur, base + i,
            )
            for i, (c, dur) in enumerate(zip(chunks, chunk_durs))
        ]
