"""Text normalization pipeline for Mongolian + Kazakh TTS.

Pipeline (parity with the reference's src/utils/text_cleaner.py:120-130):
NFC unicode → punctuation mapping → abbreviation expansion → number
normalization → drop disallowed chars → collapse whitespace → dedupe repeated
punctuation → lowercase.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Final

from oron_tts_tpu_torch.text.numbers import NumberNormalizer
from oron_tts_tpu_torch.text.tokenizer import CyrillicTokenizer, validate_language

#: Typographic punctuation folded to the ASCII forms in the vocabulary.
PUNCTUATION_MAP: Final[dict[str, str]] = {
    "…": "...",
    "–": "-",
    "—": "-",
    "«": '"',
    "»": '"',
    "“": '"',
    "”": '"',
    "‘": "'",
    "„": '"',
}

ALLOWED_CHARS: Final[frozenset[str]] = frozenset(
    "абвгдеёжзийклмноөпрстуүфхцчшщъыьэюя"
    "АБВГДЕЁЖЗИЙКЛМНОӨПРСТУҮФХЦЧШЩЪЫЬЭЮЯ"
    "әғқңұһіӘҒҚҢҰҺІ"
    " .,!?-:;\"'()"
)

# Multi-character abbreviations matched at word boundaries (case-insensitive).
MN_ABBREVIATIONS: Final[dict[str, str]] = {
    "г.": "оны",
    "км": "километр",
    "см": "сантиметр",
    "кг": "килограмм",
    "мл": "миллилитр",
    "т.": "товч",
    "тов.": "товч",
    "ж.": "жил",
    "сар.": "сар",
    "өд.": "өдөр",
    "мин.": "минут",
    "сек.": "секунд",
    "цаг.": "цаг",
}

KZ_ABBREVIATIONS: Final[dict[str, str]] = {
    "ж.": "жыл",
    "км": "километр",
    "см": "сантиметр",
    "кг": "килограмм",
    "мл": "миллилитр",
    "мин.": "минут",
    "сек.": "секунд",
    "сағ.": "сағат",
}

# Single-letter units, expanded only directly after a digit: "5 м" → "5 метр".
UNIT_ABBREVIATIONS: Final[dict[str, str]] = {
    "м": "метр",
    "г": "грамм",
    "л": "литр",
}


class TextCleaner:
    """clean() normalizes raw text; text_to_sequence() also tokenizes it."""

    def __init__(self) -> None:
        self._normalizers = {
            "mn": NumberNormalizer(lang="mn"),
            "kz": NumberNormalizer(lang="kz"),
        }
        self._tokenizer = CyrillicTokenizer()
        self._ws_re = re.compile(r"\s+")
        self._repeat_punct_re = re.compile(r"([.!?,]){2,}")

    def normalize_unicode(self, text: str) -> str:
        return unicodedata.normalize("NFC", text)

    def replace_punctuation(self, text: str) -> str:
        for src, dst in PUNCTUATION_MAP.items():
            text = text.replace(src, dst)
        return text

    def remove_invalid_chars(self, text: str) -> str:
        return "".join(c for c in text if c in ALLOWED_CHARS)

    def normalize_whitespace(self, text: str) -> str:
        return self._ws_re.sub(" ", text).strip()

    def normalize_punctuation(self, text: str) -> str:
        return self._repeat_punct_re.sub(r"\1", text)

    def expand_abbreviations(self, text: str, lang: str = "mn") -> str:
        lang = validate_language(lang)
        table = KZ_ABBREVIATIONS if lang == "kz" else MN_ABBREVIATIONS
        for abbr, full in table.items():
            text = re.sub(
                rf"(?<!\w){re.escape(abbr)}(?!\w)", full, text, flags=re.IGNORECASE
            )
        for abbr, full in UNIT_ABBREVIATIONS.items():
            text = re.sub(
                rf"(\d)\s*{re.escape(abbr)}(?!\w)",
                rf"\1 {full}",
                text,
                flags=re.IGNORECASE,
            )
        return text

    def clean(self, text: str, lang: str = "mn") -> str:
        lang = validate_language(lang)
        text = self.normalize_unicode(text)
        text = self.replace_punctuation(text)
        text = self.expand_abbreviations(text, lang=lang)
        text = self._normalizers[lang].normalize_text(text)
        text = self.remove_invalid_chars(text)
        text = self.normalize_whitespace(text)
        text = self.normalize_punctuation(text)
        return text.lower()

    def text_to_sequence(
        self,
        text: str,
        lang: str = "mn",
        attr_tokens: list[str] | None = None,
    ) -> list[int]:
        cleaned = self.clean(text, lang=lang)
        return self._tokenizer.encode(cleaned, lang=lang, attr_tokens=attr_tokens)

    @property
    def vocab_size(self) -> int:
        return self._tokenizer.vocab_size
