"""HuggingFace dataset wrappers.

Counterpart of the JAX package's ``data/hf.py``. ``datasets`` is imported
inside the methods that need it, never when this module is imported; loading
from the hub needs the network.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

_logger = logging.getLogger(__name__)


class HFDatasetWrapper:
    def __init__(
        self,
        dataset_name: str,
        dataset_config: str | None = None,
        cache_dir: str | None = None,
        sample_rate: int = 24000,
    ) -> None:
        self.dataset_name = dataset_name
        self.dataset_config = dataset_config
        self.cache_dir = cache_dir
        self.sample_rate = sample_rate

    def load(self, split: str = "train", streaming: bool = False) -> Any:
        from datasets import load_dataset

        kwargs: dict[str, Any] = {"split": split, "streaming": streaming}
        if self.dataset_config:
            kwargs["name"] = self.dataset_config
        if self.cache_dir:
            kwargs["cache_dir"] = self.cache_dir
        _logger.info("Loading HF dataset %s (%s)", self.dataset_name, kwargs)
        return load_dataset(self.dataset_name, **kwargs)

    def upload_processed(self, dataset: Any, repo_id: str,
                         token: str | None = None, private: bool = False) -> None:
        dataset.push_to_hub(repo_id, token=token, private=private)

    @staticmethod
    def create_from_files(
        wav_paths: list[str | Path], texts: list[str],
        speaker_ids: list[str] | None = None,
    ) -> Any:
        from datasets import Audio, Dataset

        data: dict[str, Any] = {
            "audio": [str(p) for p in wav_paths],
            "text": texts,
        }
        if speaker_ids is not None:
            data["speaker_id"] = speaker_ids
        ds = Dataset.from_dict(data)
        return ds.cast_column("audio", Audio())


class CommonVoiceWrapper(HFDatasetWrapper):
    """Mongolian Common Voice 24 mirror."""

    def __init__(self, cache_dir: str | None = None, sample_rate: int = 24000):
        super().__init__(
            "btsee/common-voices-24-mn", cache_dir=cache_dir, sample_rate=sample_rate
        )


class MBSpeechWrapper(HFDatasetWrapper):
    """MBSpeech Mongolian Bible speech corpus (text col: sentence_norm)."""

    text_column = "sentence_norm"

    def __init__(self, cache_dir: str | None = None, sample_rate: int = 24000):
        super().__init__(
            "btsee/mbspeech_mn", cache_dir=cache_dir, sample_rate=sample_rate
        )
