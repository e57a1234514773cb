"""TTS dataset, bucketed collation and batch sampling (numpy on the host).

Counterpart of the JAX package's ``data/dataset.py`` for local data:
samples carry a log-mel ``[n_mels, T]`` and token ids stretched to ``T``;
the collator pads the time axis up to a multiple of ``pad_to_multiple`` and
optionally the batch axis; ``DynamicBatchSampler`` packs a frame budget
(sort by length, greedy fill, epoch-seeded shuffle, nothing dropped) and
``FixedBatchSampler`` cuts shuffled fixed-size batches. Audio comes from
files, in-memory arrays or raw encoded bytes (``from_hf_dataset`` keeps a
HuggingFace dataset's bytes and maps its gender and age columns to the
``[FEMALE]``/``[YOUNG]``/… attribute tokens). The mel is computed on the
host in f32 by the native audiokit library (``native/``), or by this
package's ``ops/mel.py`` where the library cannot be built; which one ran
is logged once.

``GlobalBatchSchedule`` plans the batches of a mesh run: every rank builds
the same global plan, takes its rows of each global batch and pads to the
globally agreed shape. The JAX package's "host" drives several chips and a
torch rank drives one, so here ``num_hosts`` is the mesh's data size,
``host_id`` the rank's data coordinate and ``rows_multiple_per_host`` 1;
the model peers of a data rank load the same rows.
"""

from __future__ import annotations

import logging
import subprocess
import threading
from collections.abc import Mapping
from pathlib import Path
from typing import Any, Final

import numpy as np
import torch

from oron_tts_tpu_torch.data import wav as wavio
from oron_tts_tpu_torch.ops.mel import MelConfig, log_mel_spectrogram
from oron_tts_tpu_torch.text import TextCleaner
from oron_tts_tpu_torch.text.align import stretch_text_to_len
from oron_tts_tpu_torch.utils import trace

_logger = logging.getLogger(__name__)

GENDER_ATTR_TOKENS: Final[dict[str, str]] = {
    "female": "[FEMALE]", "f": "[FEMALE]", "woman": "[FEMALE]",
    "women": "[FEMALE]", "girl": "[FEMALE]",
    "male": "[MALE]", "m": "[MALE]", "man": "[MALE]",
    "men": "[MALE]", "boy": "[MALE]",
}

AGE_ATTR_TOKENS: Final[dict[str, str]] = {
    "child": "[YOUNG]", "teen": "[YOUNG]", "teens": "[YOUNG]",
    "twenties": "[YOUNG]", "20s": "[YOUNG]", "young": "[YOUNG]",
    "adult": "[MIDDLE]", "thirties": "[MIDDLE]", "forties": "[MIDDLE]",
    "fourties": "[MIDDLE]", "fifties": "[MIDDLE]", "30s": "[MIDDLE]",
    "40s": "[MIDDLE]", "50s": "[MIDDLE]", "middle": "[MIDDLE]",
    "sixties": "[ELDERLY]", "seventies": "[ELDERLY]", "eighties": "[ELDERLY]",
    "nineties": "[ELDERLY]", "60s": "[ELDERLY]", "70s": "[ELDERLY]",
    "80s": "[ELDERLY]", "90s": "[ELDERLY]", "elderly": "[ELDERLY]",
    "senior": "[ELDERLY]",
}

_NULLISH: Final[frozenset[str]] = frozenset({"none", "null", "nan", "other", "unknown"})


def _lookup_attr(value: Any, mapping: Mapping[str, str]) -> str | None:
    if value is None:
        return None
    norm = str(value).strip().lower().replace("-", "_").replace(" ", "_")
    if not norm or norm in _NULLISH:
        return None
    return mapping.get(norm)


def attr_tokens_from_metadata(
    item: Mapping[str, Any],
    gender_column: str | None = None,
    age_column: str | None = None,
) -> list[str]:
    """A record's gender and age columns as attribute tokens (unknown values give none)."""
    tokens: list[str] = []
    for column, mapping in ((gender_column, GENDER_ATTR_TOKENS), (age_column, AGE_ATTR_TOKENS)):
        if column and column in item:
            tok = _lookup_attr(item[column], mapping)
            if tok:
                tokens.append(tok)
    return tokens


def frames_for_duration(duration_s: float, sample_rate: int = 24000,
                        hop_length: int = 256) -> int:
    """Estimated mel frames of a clip (a centred STFT: T = n // hop + 1)."""
    return int(duration_s * sample_rate / hop_length) + 1


class TTSDataset:
    """Storage modes: file paths, in-memory float arrays, or raw encoded bytes."""

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
        audio_bytes_list: list[bytes] | None = None,
        attr_tokens_list: list[list[str]] | None = None,
        cache_bytes: int = 2 << 30,
    ) -> None:
        self.audio_paths: list[Path] | None = None
        self.audio_arrays: list[np.ndarray] | None = None
        self.audio_bytes_list: list[bytes] | None = None
        if audio_paths is not None:
            self.audio_paths = [Path(p) for p in audio_paths]
            self._len = len(audio_paths)
        elif audio_bytes_list is not None:
            self.audio_bytes_list = audio_bytes_list
            self._len = len(audio_bytes_list)
        elif audio_arrays is not None:
            self.audio_arrays = audio_arrays
            self._len = len(audio_arrays)
        else:
            raise ValueError("Must provide audio_paths, audio_arrays, or audio_bytes_list")
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
        # the host log-mel this dataset used: "native audiokit" or "torch (ops/mel.py)"
        self.mel_extractor: str | None = None
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
        """Host log-mel ``[n_mels, T]``: native audiokit, else the PyTorch plain version."""
        from oron_tts_tpu_torch import native

        cfg = self.mel_config
        out = native.log_mel(audio, cfg.sample_rate, cfg.n_fft, cfg.hop_length,
                             cfg.win_length, cfg.n_mels)
        self._note_extractor("torch (ops/mel.py)" if out is None else "native audiokit")
        if out is not None:
            return out
        with torch.no_grad():
            return log_mel_spectrogram(torch.from_numpy(audio), cfg).numpy()

    def _note_extractor(self, name: str) -> None:
        if self.mel_extractor != name:  # logged once a dataset, and on a change
            self.mel_extractor = name
            _logger.info("TTSDataset log-mel extractor: %s", name)

    def _load_audio(self, idx: int) -> np.ndarray:
        if self.audio_bytes_list is not None:
            return wavio.decode_audio_bytes(self.audio_bytes_list[idx], self.sample_rate)
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

    @classmethod
    def from_hf_dataset(
        cls,
        hf_dataset: Any,
        audio_column: str = "audio",
        text_column: str | None = None,
        lang_column: str | None = None,
        gender_column: str | None = None,
        age_column: str | None = None,
        sample_rate: int = 24000,
        n_mels: int = 100,
        default_lang: str = "mn",
        min_duration_s: float = 1.0,
        max_duration_s: float = 30.0,
        cache_bytes: int = 2 << 30,
    ) -> "TTSDataset":
        """Ingest a HuggingFace dataset, keeping its raw audio bytes; 1–30 s clips only.

        Needs the ``datasets`` library, imported here and nowhere else.
        """
        from datasets import Audio

        hf_dataset = hf_dataset.cast_column(audio_column, Audio(decode=False))
        if text_column is None:
            text_column = next((c for c in ("sentence_norm", "text", "sentence", "transcript",
                                            "transcription") if c in hf_dataset.column_names),
                               None)
            if text_column is None:
                raise ValueError(f"No text column found. Available: {hf_dataset.column_names}")
        _logger.info("Using text column: %s", text_column)

        audio_bytes_list: list[bytes] = []
        texts: list[str] = []
        langs: list[str] = []
        attrs: list[list[str]] = []
        durations: list[float] = []
        skipped = {"short": 0, "long": 0, "empty": 0, "no_audio": 0}
        for item in hf_dataset:
            info = item[audio_column]
            raw = info.get("bytes") if isinstance(info, dict) else None
            if not raw:
                path = info.get("path") if isinstance(info, dict) else None
                if path and Path(path).exists():
                    raw = Path(path).read_bytes()
            if not raw:
                skipped["no_audio"] += 1
                continue
            try:
                dur, _ = wavio.wav_info_bytes(raw)
            except ValueError:
                # another container: decode (ffmpeg) to measure, skip on failure
                try:
                    dur = len(wavio.decode_audio_bytes(raw, sample_rate)) / sample_rate
                except (ValueError, OSError, subprocess.SubprocessError):
                    skipped["no_audio"] += 1
                    continue
            text_val = item[text_column]
            if not text_val or not str(text_val).strip():
                skipped["empty"] += 1
                continue
            if dur < min_duration_s:
                skipped["short"] += 1
                continue
            if dur > max_duration_s:
                skipped["long"] += 1
                continue
            audio_bytes_list.append(raw)
            texts.append(text_val)
            durations.append(dur)
            langs.append(item[lang_column] if lang_column and lang_column in item
                         else default_lang)
            attrs.append(attr_tokens_from_metadata(
                item, gender_column=gender_column, age_column=age_column))

        total_skipped = sum(skipped.values())
        if total_skipped:
            _logger.warning(
                "Filtered %d samples (short=%d, long=%d, empty_text=%d, no_audio=%d). Kept %d.",
                total_skipped, skipped["short"], skipped["long"], skipped["empty"],
                skipped["no_audio"], len(audio_bytes_list))
        if not audio_bytes_list:
            raise RuntimeError(
                "No valid samples after filtering. Check "
                f"min_duration_s={min_duration_s}, max_duration_s={max_duration_s}.")
        ds = cls(audio_bytes_list=audio_bytes_list, texts=texts, langs=langs,
                 sample_rate=sample_rate, n_mels=n_mels, min_duration_s=min_duration_s,
                 max_duration_s=max_duration_s, attr_tokens_list=attrs,
                 cache_bytes=cache_bytes)
        ds.durations = durations
        return ds


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


class TTSCollator:
    """Pads a batch to bucketed ``[B_pad, n_mels, T_bucket]`` numpy arrays.

    Text ids pad with −1 (the filler after the +1 shift); batch-axis padding
    rows carry ``mel_length`` 0 and add nothing to the masked loss.

    ``pad_t_to`` / ``pad_rows_to`` (per call, from
    :class:`GlobalBatchSchedule` through the loader) replace the locally
    derived bucket with the globally agreed one, which every rank of a mesh
    must share. An item longer than ``pad_t_to`` is cropped (frame estimates
    can be off by one); with a scheduled shape, an all-failed batch is pure
    padding (``n_mels`` rows of it).
    """

    def __init__(self, pad_to_multiple: int = 64, pad_batch_to: int | None = None,
                 pad_batch_to_multiple: int = 1, n_mels: int = 100):
        self.pad_to_multiple = pad_to_multiple
        self.pad_batch_to = pad_batch_to
        self.pad_batch_to_multiple = max(1, pad_batch_to_multiple)
        self.n_mels = n_mels

    def __call__(self, batch: list[dict[str, Any]], pad_t_to: int | None = None,
                 pad_rows_to: int | None = None) -> dict[str, np.ndarray]:
        n = len(batch)
        n_pad = pad_rows_to or self.pad_batch_to or round_up(n, self.pad_batch_to_multiple)
        if n_pad < n:
            raise ValueError("pad_batch_to smaller than batch")
        if pad_t_to is not None:
            t_bucket = pad_t_to
        elif batch:
            t_bucket = round_up(max(b["mel"].shape[-1] for b in batch), self.pad_to_multiple)
        else:
            raise ValueError("cannot collate an empty batch without pad_t_to")
        n_mels = batch[0]["mel"].shape[0] if batch else self.n_mels
        mels = np.zeros((n_pad, n_mels, t_bucket), dtype=np.float32)
        text_ids = np.full((n_pad, t_bucket), -1, dtype=np.int32)
        masks = np.zeros((n_pad, t_bucket), dtype=bool)
        mel_lengths = np.zeros(n_pad, dtype=np.int32)
        for i, item in enumerate(batch):
            T = min(item["mel"].shape[-1], t_bucket)
            mels[i, :, :T] = item["mel"][:, :T]
            text_ids[i, :T] = item["text_ids"][:T]
            masks[i, :T] = item["mask"][:T]
            mel_lengths[i] = T
        if trace.enabled():
            trace.count("collate.frames_kept", int(mel_lengths.sum()))
            trace.count("collate.frames_collated", n_pad * t_bucket)
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


class GlobalBatchSchedule:
    """One batch plan for every rank of a mesh, each taking its rows.

    The JAX package's schedule, bit for bit. Every rank builds the identical
    plan (same frame estimates, same epoch seed), takes its interleaved
    row slice of each global batch and the globally agreed pad targets.
    Iterating yields ``(local_indices, {"pad_t_to": t_bucket, "pad_rows_to":
    rows_per_host})``, which the loader forwards to the collator. Each global
    batch is padded to a multiple of ``num_hosts · rows_multiple_per_host``
    by wrap-around duplication (DistributedSampler's ``drop_last=False``), so
    every rank holds the same number of real rows. The frame-budget packing
    mirrors :class:`DynamicBatchSampler` (sort by length, greedy fill,
    epoch-seeded shuffle, nothing dropped); ``batch_size`` switches to
    fixed-size batches over an epoch-seeded permutation.

    In a torch mesh ``num_hosts`` is the data size and ``host_id`` the
    rank's data coordinate (module docstring).
    """

    def __init__(
        self,
        frames: list[int],
        num_hosts: int,
        host_id: int,
        frames_threshold: int = 0,
        batch_size: int = 0,
        max_samples: int = 0,
        pad_to_multiple: int = 64,
        rows_multiple_per_host: int = 1,
        shuffle: bool = True,
        seed: int = 0,
    ) -> None:
        if not (0 <= host_id < num_hosts):
            raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
        if bool(frames_threshold) == bool(batch_size):
            raise ValueError("pass exactly one of frames_threshold/batch_size")
        self.frames = [int(f) for f in frames]
        self.num_hosts, self.host_id = num_hosts, host_id
        self.frames_threshold, self.batch_size = frames_threshold, batch_size
        self.max_samples = max_samples
        self.pad_to_multiple = pad_to_multiple
        self.rows_multiple = max(1, rows_multiple_per_host)
        self.shuffle, self.seed = shuffle, seed
        self.epoch = 0
        # the plan is a function of (seed, epoch): built once per epoch
        self._plan_cache: tuple[int, list[list[int]]] | None = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _global_batches(self) -> list[list[int]]:
        if self._plan_cache is None or self._plan_cache[0] != self.epoch:
            self._plan_cache = (self.epoch, self._build_global_batches())
        return self._plan_cache[1]

    def _build_global_batches(self) -> list[list[int]]:
        n = len(self.frames)
        if self.frames_threshold:
            order = sorted(range(n), key=lambda i: self.frames[i])
            batches: list[list[int]] = []
            batch: list[int] = []
            acc = 0
            for idx in order:
                f = self.frames[idx]
                fits = (acc + f <= self.frames_threshold) and (
                    self.max_samples == 0 or len(batch) < self.max_samples)
                if fits:
                    batch.append(idx)
                    acc += f
                else:
                    if batch:
                        batches.append(batch)
                    batch, acc = [idx], f
            if batch:
                batches.append(batch)
            if self.shuffle:
                rng = np.random.default_rng(self.seed + self.epoch)
                batches = [batches[int(i)] for i in rng.permutation(len(batches))]
            return batches
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(idx)
        return [[int(j) for j in idx[i: i + self.batch_size]]
                for i in range(0, n, self.batch_size)]

    def _entries(self) -> list[tuple[list[int], dict[str, int]]]:
        out = []
        row_quantum = self.num_hosts * self.rows_multiple
        for batch in self._global_batches():
            rows_global = round_up(len(batch), row_quantum)
            padded = list(batch)
            while len(padded) < rows_global:
                padded.extend(batch[: rows_global - len(padded)])
            local = padded[self.host_id:: self.num_hosts]
            t_bucket = round_up(max(self.frames[i] for i in batch), self.pad_to_multiple)
            out.append((local, {"pad_t_to": t_bucket,
                                "pad_rows_to": rows_global // self.num_hosts}))
        return out

    def __iter__(self):
        return iter(self._entries())

    def __len__(self) -> int:
        if self.frames_threshold:
            return len(self._global_batches())
        return -(-len(self.frames) // self.batch_size)


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
