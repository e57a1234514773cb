"""TTS dataset, bucketed collation and batch sampling (numpy on the host).

Counterpart of the JAX package's ``data/dataset.py`` for local data:
samples carry a log-mel ``[n_mels, T]`` and token ids stretched to ``T``;
the collator pads the time axis up to a multiple of ``pad_to_multiple`` and
optionally the batch axis; ``DynamicBatchSampler`` packs a frame budget
(sort by length, greedy fill, epoch-seeded shuffle, nothing dropped) and
``FixedBatchSampler`` cuts shuffled fixed-size batches. The mel comes from
this package's ``ops/mel.py`` on the host, in f32.

Not ported yet: ``from_hf_dataset`` (needs the ``datasets`` library and the
network), ``GlobalBatchSchedule`` (multi-host) and the native audiokit
feature extractor.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from oron_tts_tpu_torch.data import wav as wavio
from oron_tts_tpu_torch.ops.mel import MelConfig, log_mel_spectrogram
from oron_tts_tpu_torch.text import TextCleaner
from oron_tts_tpu_torch.text.align import stretch_text_to_len

_logger = logging.getLogger(__name__)


class TTSDataset:
    """Storage modes: file paths or in-memory float arrays."""

    def __init__(
        self,
        audio_paths: list[Path] | list[str] | None = None,
        texts: list[str] | None = None,
        langs: list[str] | None = None,
        sample_rate: int = 24000,
        n_mels: int = 100,
        min_duration_s: float = 1.0,
        max_duration_s: float = 30.0,
        audio_arrays: list[np.ndarray] | None = None,
        attr_tokens_list: list[list[str]] | None = None,
        cache_bytes: int = 2 << 30,
    ) -> None:
        if audio_paths is not None:
            self.audio_paths: list[Path] | None = [Path(p) for p in audio_paths]
            self.audio_arrays = None
            self._len = len(audio_paths)
        elif audio_arrays is not None:
            self.audio_paths = None
            self.audio_arrays = audio_arrays
            self._len = len(audio_arrays)
        else:
            raise ValueError("Must provide audio_paths or audio_arrays")
        if texts is None:
            raise ValueError("texts must be provided")
        if self._len != len(texts):
            raise ValueError("Audio and text lengths must match")
        if attr_tokens_list is not None and self._len != len(attr_tokens_list):
            raise ValueError("attr_tokens_list length must match audio/text length")

        self.texts = texts
        self.langs = langs or ["mn"] * self._len
        self.attr_tokens_list = attr_tokens_list or [[] for _ in range(self._len)]
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.min_duration_s = min_duration_s
        self.max_duration_s = max_duration_s
        self.min_audio_len = int(min_duration_s * sample_rate)
        self.mel_config = MelConfig(sample_rate=sample_rate, n_mels=n_mels)
        self.text_cleaner = TextCleaner()
        self.durations: list[float] = []
        # item cache, bounded in bytes: decode + mel is deterministic per
        # index, so epochs past the first read from memory
        self._cache_bytes_budget = max(0, int(cache_bytes))
        self._cache_bytes = 0
        self._cache_full_logged = False
        self._cache: dict[int, dict[str, Any]] = {}
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return self._len

    def _mel(self, audio: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return log_mel_spectrogram(torch.from_numpy(audio), self.mel_config).numpy()

    def _load_audio(self, idx: int) -> np.ndarray:
        if self.audio_arrays is not None:
            return np.asarray(self.audio_arrays[idx], dtype=np.float32)
        samples, sr = wavio.read_wav(self.audio_paths[idx])
        if samples.ndim > 1:
            samples = samples.mean(axis=1)
        if sr != self.sample_rate:
            samples = wavio.resample(samples, sr, self.sample_rate)
        return samples.astype(np.float32)

    @staticmethod
    def _item_nbytes(item: dict[str, Any]) -> int:
        return sum(v.nbytes if isinstance(v, np.ndarray) else len(str(v))
                   for v in item.values())

    def cache_stats(self) -> dict[str, int]:
        with self._cache_lock:
            return {"bytes": self._cache_bytes, "items": len(self._cache),
                    "budget_bytes": self._cache_bytes_budget}

    def __getitem__(self, idx: int) -> dict[str, Any]:
        with self._cache_lock:
            cached = self._cache.get(idx)
        if cached is not None:
            return cached
        item = self._build_item(idx)
        size = self._item_nbytes(item)
        with self._cache_lock:
            if self._cache_bytes + size <= self._cache_bytes_budget:
                if idx not in self._cache:
                    self._cache[idx] = item
                    self._cache_bytes += size
            elif not self._cache_full_logged:
                self._cache_full_logged = True
                _logger.info(
                    "Dataset item cache full: %.0f MB across %d items (budget %.0f MB); "
                    "remaining items re-decode each epoch",
                    self._cache_bytes / 1e6, len(self._cache), self._cache_bytes_budget / 1e6)
        return item

    def _build_item(self, idx: int) -> dict[str, Any]:
        text, lang = self.texts[idx], self.langs[idx]
        audio = wavio.normalize_peak(self._load_audio(idx))
        if not np.isfinite(audio).all():
            raise ValueError(f"Invalid audio values at sample {idx}")
        if len(audio) < self.min_audio_len:
            raise ValueError(
                f"Audio too short at sample {idx}: "
                f"{len(audio) / self.sample_rate:.2f}s < {self.min_duration_s:.2f}s")
        if len(audio) > self.max_duration_s * self.sample_rate:
            raise ValueError(
                f"Audio too long at sample {idx}: "
                f"{len(audio) / self.sample_rate:.2f}s > {self.max_duration_s:.2f}s")
        mel = self._mel(audio)  # [n_mels, T]
        T = mel.shape[-1]
        raw_ids = self.text_cleaner.text_to_sequence(
            text, lang=lang, attr_tokens=self.attr_tokens_list[idx])
        text_ids = np.asarray(stretch_text_to_len(raw_ids, T), dtype=np.int32)
        return {"mel": mel, "text_ids": text_ids, "mask": np.ones(T, dtype=bool),
                "lang": lang, "text": text}


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


class TTSCollator:
    """Pads a batch to bucketed ``[B_pad, n_mels, T_bucket]`` numpy arrays.

    Text ids pad with −1 (the filler after the +1 shift); batch-axis padding
    rows carry ``mel_length`` 0 and add nothing to the masked loss.
    """

    def __init__(self, pad_to_multiple: int = 64, pad_batch_to: int | None = None,
                 pad_batch_to_multiple: int = 1, n_mels: int = 100):
        self.pad_to_multiple = pad_to_multiple
        self.pad_batch_to = pad_batch_to
        self.pad_batch_to_multiple = max(1, pad_batch_to_multiple)
        self.n_mels = n_mels

    def __call__(self, batch: list[dict[str, Any]]) -> dict[str, np.ndarray]:
        if not batch:
            raise ValueError("cannot collate an empty batch")
        n = len(batch)
        n_pad = self.pad_batch_to or round_up(n, self.pad_batch_to_multiple)
        if n_pad < n:
            raise ValueError("pad_batch_to smaller than batch")
        t_bucket = round_up(max(b["mel"].shape[-1] for b in batch), self.pad_to_multiple)
        n_mels = batch[0]["mel"].shape[0]
        mels = np.zeros((n_pad, n_mels, t_bucket), dtype=np.float32)
        text_ids = np.full((n_pad, t_bucket), -1, dtype=np.int32)
        masks = np.zeros((n_pad, t_bucket), dtype=bool)
        mel_lengths = np.zeros(n_pad, dtype=np.int32)
        for i, item in enumerate(batch):
            T = item["mel"].shape[-1]
            mels[i, :, :T] = item["mel"]
            text_ids[i, :T] = item["text_ids"]
            masks[i, :T] = item["mask"]
            mel_lengths[i] = T
        return {"mel": mels, "text_ids": text_ids, "mask": masks, "mel_lengths": mel_lengths}


class DynamicBatchSampler:
    """Frame-budget batching: sort by length, greedy pack, epoch-seeded shuffle."""

    def __init__(self, durations: list[float], frames_threshold: int, max_samples: int = 0,
                 sample_rate: int = 24000, hop_length: int = 256,
                 drop_last: bool = False) -> None:
        self.frames_threshold = frames_threshold
        self.epoch = 0
        frame_lens = [d * sample_rate / hop_length for d in durations]
        order = sorted(range(len(frame_lens)), key=lambda i: frame_lens[i])
        batches: list[list[int]] = []
        batch: list[int] = []
        acc = 0.0
        for idx in order:
            flen = frame_lens[idx]
            fits = (acc + flen <= frames_threshold) and (
                max_samples == 0 or len(batch) < max_samples)
            if fits:
                batch.append(idx)
                acc += flen
            else:
                if batch:
                    batches.append(batch)
                batch, acc = [idx], flen
        if batch and not drop_last:
            batches.append(batch)
        self.batches = batches

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.epoch)
        for i in rng.permutation(len(self.batches)):
            yield self.batches[int(i)]

    def __len__(self) -> int:
        return len(self.batches)


class FixedBatchSampler:
    """Shuffled fixed-size batches (epoch-seeded), optional drop_last."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        self.n, self.batch_size = n, batch_size
        self.shuffle, self.drop_last, self.seed = shuffle, drop_last, seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(idx)
        stop = (self.n // self.batch_size) * self.batch_size if self.drop_last else self.n
        for i in range(0, stop, self.batch_size):
            yield [int(j) for j in idx[i: i + self.batch_size]]

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)
